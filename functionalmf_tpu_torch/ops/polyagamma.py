"""Polya-Gamma sampler in plain PyTorch.

Counterpart of functionalmf_tpu/ops/polyagamma.py:38-132. Truncated
sum-of-gammas representation with an exact tail-mean correction: PG(b, c)
is an infinite convolution (Polson, Scott & Windle 2013, eq. 3)

    omega = (1 / (2 pi^2)) sum_{k>=1} g_k / ((k - 1/2)^2 + c^2 / (4 pi^2)),
    g_k ~ Gamma(b, 1) independent.

The first ``num_terms`` terms are drawn and the expected value of the
discarded tail is added, in closed form from E[PG(b, c)] = b / (2c)
tanh(c / 2). So the mean is exact for every (b, c) and the variance is
short by the tail's, which decays like sum_{k>K} k^-4. The shapes do not
depend on the data and the gamma draw is one batched call.
"""
from __future__ import annotations

import math

import torch

from functionalmf_tpu_torch.ops.gamma import gamma_mt

__all__ = ["polya_gamma", "pg_mean", "pg_var"]

_TWO_PI_SQ = 2.0 * math.pi ** 2


def _tanh_half_over(c):
    """tanh(c/2) / c with the c -> 0 limit (1/2); a series on |c/2| <
    0.05, where the direct ratio loses accuracy in float32."""
    x = 0.5 * c
    x2 = x * x
    small = x.abs() < 0.05
    safe = torch.where(small, 1.0, x)
    ratio = torch.where(small, 1.0 - x2 / 3.0 + 2.0 * x2 * x2 / 15.0,
                        torch.tanh(safe) / safe)
    return 0.5 * ratio


def pg_mean(b, c):
    """E[PG(b, c)] = b / (2 c) tanh(c / 2), with the c -> 0 limit b/4."""
    return 0.5 * b * _tanh_half_over(torch.as_tensor(c))


def pg_var(b, c):
    """Var[PG(b, c)] = b / (4 c^3) (sinh(c) - c) sech^2(c / 2).

    sinh(c) - c cancels for small |c|: in float32 the direct form loses
    every significant bit below |c| ~ 0.01 and can come out negative,
    which would put sqrt(<0) = NaN into the normal branch of
    ``polya_gamma``. So the series (sinh c - c) / c^3 = (1/6)(1 + c^2/20
    + c^4/840 + ...) serves |c| < 0.5 (truncation error below 3e-7
    relative there), and the result is clamped at 0.
    """
    c = torch.as_tensor(c)
    c2 = c * c
    small = c.abs() < 0.5
    safe = torch.where(small, 1.0, c)
    series = (1.0 + c2 / 20.0 + c2 * c2 / 840.0) / 24.0
    direct = (torch.sinh(safe) - safe) / (4.0 * safe ** 3)
    v = torch.where(small, series, direct) / torch.cosh(c / 2.0) ** 2
    return torch.clamp(b * v, min=0.0)


def polya_gamma(gen, b, c, num_terms: int = 16, use_mt: bool = True,
                normal_approx_above: float = 50.0, g=None, z=None,
                gamma_noise=None):
    """Draw omega ~ PG(b, c), elementwise over broadcast(b, c).

    b: any nonnegative real (b = 0 gives exactly 0, used for missing
    cells); c: any real. Cells with b >= ``normal_approx_above`` take the
    moment-matched normal instead (PG(b, c) is a sum of b PG(1, c)
    variables; ``math.inf`` forces the gamma sum everywhere). ``use_mt``
    picks the fixed-round Marsaglia-Tsang gamma sampler (ops/gamma.py)
    over ``torch._standard_gamma``.

    From ``gen`` the gammas are drawn first, then the normals. ``g``
    ((num_terms,) + shape, Gamma(b_safe, 1) draws, b_safe = b where 0 < b
    < normal_approx_above, else 1) and ``z`` (shape) inject them;
    ``gamma_noise`` injects the Marsaglia-Tsang sampler's own draws
    (``ops/gamma.py:draw_gamma_mt_noise`` at (num_terms,) + shape).
    """
    b = torch.as_tensor(b, dtype=torch.float32)
    c = torch.as_tensor(c, dtype=torch.float32, device=b.device)
    b, c = torch.broadcast_tensors(b, c)
    shape = tuple(b.shape)

    pos = b > 0
    big = b >= normal_approx_above
    b_safe = torch.where(pos & ~big, b, 1.0)  # no gamma work for big b

    ks = (torch.arange(num_terms, dtype=b.dtype, device=b.device)
          + 0.5) ** 2
    denom = ks.reshape((num_terms,) + (1,) * len(shape)) \
        + (c / (2.0 * math.pi)) ** 2

    if g is None:
        if use_mt:
            g = gamma_mt(gen, b_safe, shape=(num_terms,) + shape,
                         noise=gamma_noise)
        else:
            g = torch._standard_gamma(
                b_safe.expand((num_terms,) + shape).contiguous(),
                generator=gen)
    # the terms summed along a contiguous last axis: an element's sum is
    # then the same whatever the batch's shape (a mesh rank's chains)
    trunc = (g / denom).movedim(0, -1).contiguous().sum(-1) / _TWO_PI_SQ

    mean_full = pg_mean(b, c)
    mean_trunc = (b_safe * (1.0 / denom).movedim(0, -1).contiguous().sum(-1)
                  / _TWO_PI_SQ)
    tail = torch.clamp(mean_full - mean_trunc, min=0.0)
    gamma_draw = trunc + tail

    if z is None:
        z = torch.randn(shape, generator=gen, dtype=b.dtype, device=b.device)
    normal_draw = torch.clamp(mean_full + z * torch.sqrt(pg_var(b, c)),
                              min=1e-12)
    return torch.where(pos, torch.where(big, normal_draw, gamma_draw), 0.0)
