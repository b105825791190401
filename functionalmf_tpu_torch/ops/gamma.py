"""Fixed-round Marsaglia-Tsang gamma sampler.

Counterpart of functionalmf_tpu/ops/gamma.py:21-60. A rejection sampler
that loops until every lane accepts runs as long as its slowest lane;
this one runs a fixed number of Marsaglia-Tsang (2000) rounds with
acceptance masks. A round accepts with probability at least 0.95, so a
lane misses all ``rounds=6`` proposals with probability below 2e-8; such
a lane takes the distribution's mean, a bias far below Monte Carlo noise.
It is the gamma draw of the Polya-Gamma augmentation (ops/polyagamma.py).

``log_gamma`` and ``dirichlet`` serve the PGDS sampler (models/pgds.py),
whose Dirichlet concentrations go down to about 1e-6. There a linear draw
underflows (``torch._standard_gamma(1e-6)`` is the smallest normal
float32), and a Dirichlet whose components all underflow is 0/0. As in
``jax.random.dirichlet``, the draw is kept in log space and normalised
with a softmax.
"""
from __future__ import annotations

import torch

__all__ = ["gamma_mt", "draw_gamma_mt_noise", "log_gamma", "dirichlet"]


def draw_gamma_mt_noise(gen, shape, rounds: int = 6, device=None,
                        dtype=torch.float32):
    """(x, u, u_boost): each round's normals and uniforms, (rounds,) +
    shape each, then the boost's uniforms, of ``shape``; drawn from
    ``gen`` in this order."""
    shape = tuple(shape)
    x = torch.randn((rounds,) + shape, generator=gen, dtype=dtype,
                    device=device)
    u = torch.rand((rounds,) + shape, generator=gen, dtype=dtype,
                   device=device).clamp_(min=1e-12)
    ub = torch.rand(shape, generator=gen, dtype=dtype,
                    device=device).clamp_(min=1e-12)
    return x, u, ub


def gamma_mt(gen, a, shape=None, rounds: int = 6, dtype=torch.float32,
             noise=None):
    """Draws ~ Gamma(a, 1) with fixed-round Marsaglia-Tsang rejection.

    ``a`` broadcasts to ``shape`` (default: its own). Supports a > 0,
    a < 1 through the boost g(a) = g(a + 1) U^(1/a); a <= 0 gives 0.
    ``noise`` injects ``draw_gamma_mt_noise``'s triple.
    """
    a = torch.as_tensor(a, dtype=dtype)
    shape = tuple(a.shape if shape is None else shape)
    a = a.expand(shape)
    if noise is None:
        noise = draw_gamma_mt_noise(gen, shape, rounds, a.device, dtype)
    xs, us, ub = noise

    small = a < 1.0
    a_eff = torch.where(small, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)

    out = torch.full(shape, torch.nan, dtype=dtype, device=a.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=a.device)
    for r in range(rounds):
        x, u = xs[r], us[r]
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.where(v > 0, v, 1.0)))
        out = torch.where(ok & ~accepted, d * v, out)
        accepted = accepted | ok
    # lanes that never accepted take the mean of Gamma(a_eff, 1)
    out = torch.where(accepted, out, a_eff)

    boost = torch.exp(torch.log(ub) / a.clamp(min=1e-12))
    out = torch.where(small, out * boost, out)
    return torch.where(a > 0, out, 0.0)


def log_gamma(gen, a):
    """log of a Gamma(a, 1) draw, elementwise, for a > 0: log g(a) for
    a >= 1, log g(a + 1) + log(U) / a below (the boost in log space, which
    does not underflow at small a). PyTorch's gamma sampler, then one
    uniform a lane, both from ``gen``."""
    small = a < 1.0
    g = torch._standard_gamma(torch.where(small, a + 1.0, a), generator=gen)
    u = torch.rand(a.shape, generator=gen, dtype=a.dtype, device=a.device)
    u = u.clamp_(min=torch.finfo(a.dtype).tiny)
    return torch.log(g) + torch.where(small, torch.log(u) / a, 0.0)


def dirichlet(gen, alpha):
    """Dirichlet draws over the last axis of ``alpha`` (> 0): the softmax
    of independent log-gamma draws (``jax.random.dirichlet``)."""
    return torch.softmax(log_gamma(gen, alpha), dim=-1)
