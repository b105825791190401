"""Scalar shrinkage slice sampler (Neal 2003, §4.1 fig. 5) on an interval.

Counterpart of functionalmf_tpu/samplers/slice1d.py:27-67, batched over
the shape of ``x0`` (the model passes one value per chain). The JAX loop
stops at the first accepted point; here the loop always runs
``max_shrink`` iterations, and acceptance collapses the bracket onto the
accepted point, so a sweep needs no host sync to decide when to stop. The
draws are the same: one exponential for the slice height and one uniform
per iteration.
"""
from __future__ import annotations

import torch

__all__ = ["shrink_slice_1d"]


def shrink_slice_1d(x0, logdensity, lo, hi, gen=None, max_shrink: int = 16,
                    noise=None):
    """One shrinkage-slice update of ``x`` on ``[lo, hi]``.

    Args:
      x0: current point(s), inside [lo, hi] with finite logdensity.
      logdensity: ``x -> log target`` elementwise over x0's shape.
      lo, hi: the initial bracket (the whole truncated support).
      noise: optional (e, u) injecting Exp(1) of x0's shape and
        (max_shrink,) + x0.shape uniforms.

    Returns ``(x_new, accepted)``; where accepted is False the cap was
    hit and ``x_new == x0``.
    """
    if noise is None:
        e = torch.empty_like(x0).exponential_(generator=gen)
        u = torch.rand((max_shrink,) + tuple(x0.shape), generator=gen,
                       dtype=x0.dtype, device=x0.device)
    else:
        e, u = noise
    y = logdensity(x0) - e
    L = lo if isinstance(lo, torch.Tensor) else torch.full_like(x0, lo)
    R = hi if isinstance(hi, torch.Tensor) else torch.full_like(x0, hi)
    ok = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    xp = x0
    for i in range(u.shape[0]):
        xp = L + (R - L) * u[i]
        ok = logdensity(xp) >= y
        # a rejected point shrinks the bracket toward x0; an accepted one
        # collapses it onto itself, so later iterations return the same
        # point and stay accepted (the JAX loop stops there instead)
        left = xp < x0
        L = torch.where(ok | left, xp, L)
        R = torch.where(ok | ~left, xp, R)
    return torch.where(ok, xp, x0), ok
