"""Chinese-restaurant-table and multinomial-allocation draws.

Counterpart of functionalmf_tpu/ops/crt.py, the augmentation steps of the
PGDS sampler (models/pgds.py). CRT(n, r) is the number of tables after n
customers at concentration r: sum_{i=1..n} Bernoulli(r / (r + i - 1)).

The CRT is split in two so that a caller whose r is known before its n
(the PGDS backward pass) can do the n-independent work for every step at
once: ``crt_prepare`` takes r and the uniforms of the exact part and
returns the cumulative count of the exact terms and the tail's constants;
``crt_finish`` takes n and returns the draw.
"""
from __future__ import annotations

import torch

__all__ = ["chinese_restaurant_table", "draw_crt_noise", "crt_prepare",
           "crt_finish", "multinomial_split", "split_fractions",
           "binomial_chain"]

_N_EXACT = 128  # exact Bernoulli terms; the tail is approximated


def draw_crt_noise(gen, shape, n_exact: int = _N_EXACT, device=None):
    """(u, z): the exact part's uniforms, ``shape + (n_exact,)``, then the
    tail's standard normals, ``shape``; drawn from ``gen`` in this order."""
    shape = tuple(shape)
    u = torch.rand(shape + (n_exact,), generator=gen, device=device)
    z = torch.randn(shape, generator=gen, device=device)
    return u, z


def crt_prepare(r, u):
    """The part of CRT(n, r) that does not depend on n: ``csum[..., c]``,
    the number of exact terms i <= c with u_i < r / (r + i - 1), for c = 0
    .. n_exact; the tail's r (kept above 1e-20), r^2, digamma and trigamma
    at r + n_exact, and whether its terms are all small (Poisson tail)."""
    n_exact = u.shape[-1]
    i = torch.arange(1, n_exact + 1, dtype=r.dtype, device=r.device)
    p = r[..., None] / (r[..., None] + i - 1.0)
    hits = (u < p).to(r.dtype)
    csum = torch.cat([torch.zeros_like(hits[..., :1]), hits.cumsum(-1)], -1)
    rs = r.clamp(min=1e-20)
    return (csum, rs, rs * rs, torch.special.digamma(rs + n_exact),
            torch.special.polygamma(1, rs + n_exact),
            rs < 0.1 * (rs + n_exact))


def crt_finish(gen, n, prep, z, pois=None):
    """CRT(n, r) from ``crt_prepare``'s tuple: the exact terms i <= n, and
    for n > n_exact the rest of the sum, whose mean and variance are exact
    (digamma, trigamma), drawn as Poisson(mean) when every tail term is
    small and as a rounded normal otherwise, clipped to [0, n - n_exact].
    ``pois`` injects the Poisson draw (else drawn from ``gen``). n = 0
    gives 0; n >= 1 gives a value in [1, n]."""
    csum, rs, rs2, dg0, pg0, small_p = prep
    n_exact = csum.shape[-1] - 1
    exact = csum.gather(-1, n.clamp(0, n_exact).long()[..., None])[..., 0]
    has_tail = n > n_exact
    nt = torch.where(has_tail, n, n_exact + 1.0)
    x = rs + nt
    mu = rs * (torch.special.digamma(x) - dg0)
    var = (mu - rs2 * (pg0 - torch.special.polygamma(1, x))).clamp(min=1e-12)
    if pois is None:
        pois = torch.poisson(mu.clamp(min=0.0), generator=gen)
    norm = torch.round(torch.addcmul(mu, var.sqrt(), z))
    tail = torch.where(small_p, pois, norm).clamp(min=0.0)
    tail = torch.minimum(tail, (nt - n_exact).clamp(min=0.0))
    out = exact + torch.where(has_tail, tail, 0.0)
    return torch.where(n >= 1.0, torch.minimum(out.clamp(min=1.0), n), 0.0)


def chinese_restaurant_table(gen, n, r, n_exact: int = _N_EXACT,
                             noise=None):
    """CRT(n, r) elementwise for broadcastable float tensors n, r.
    ``noise`` injects (u, z, pois): ``draw_crt_noise``'s pair and the
    tail's Poisson draw."""
    n, r = torch.broadcast_tensors(torch.as_tensor(n, dtype=torch.float32),
                                   torch.as_tensor(r, dtype=torch.float32))
    if noise is None:
        u, z = draw_crt_noise(gen, n.shape, n_exact, n.device)
        pois = None
    else:
        u, z, pois = noise
    return crt_finish(gen, n, crt_prepare(r, u), z, pois)


def split_fractions(p):
    """p_k / p_{k:} over the last axis, in [0, 1], moved to the front
    (K, ...) and contiguous: the binomial chain's success probabilities of
    a multinomial with probabilities ``p``."""
    tail = p.flip(-1).cumsum(-1).flip(-1)
    frac = (p / tail.clamp(min=1e-30)).clamp(0.0, 1.0)
    return frac.movedim(-1, 0).contiguous()


def binomial_chain(gen, n, frac):
    """(..., K) counts summing to n: cell k gets Binomial(remaining,
    frac[k]), the last cell the remainder. ``frac`` is (K, ...)."""
    rem = n
    cells = []
    for k in range(frac.shape[0] - 1):
        draw = torch.minimum(torch.binomial(rem, frac[k], generator=gen),
                             rem)
        rem = rem - draw
        cells.append(draw)
    cells.append(rem)
    return torch.stack(cells, -1)


def multinomial_split(gen, n, p):
    """Split counts n (...,) into K cells with probabilities p (..., K):
    a K-step binomial chain, exact for any n. Returns (..., K) float
    counts summing to n."""
    p = torch.as_tensor(p, dtype=torch.float32)
    n = torch.as_tensor(n, dtype=torch.float32,
                        device=p.device).expand(p.shape[:-1]).contiguous()
    return binomial_chain(gen, n, split_fractions(p))
