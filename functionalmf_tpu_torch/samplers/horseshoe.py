"""Horseshoe / horseshoe+ shrinkage ladders and their Gibbs updates.

Counterpart of functionalmf_tpu/samplers/horseshoe.py:29-117, batched
over whatever leading shape the inputs carry (the model passes a chain
axis). Every function takes a generator; ``noise=`` injects the draws so
a test can feed the JAX package's own.
"""
from __future__ import annotations

import torch

from functionalmf_tpu_torch.samplers.conjugate import standard_gamma

__all__ = ["sample_horseshoe", "sample_horseshoe_plus",
           "resample_tau2_ladder", "resample_lam2", "lam2_shape"]


def _exponential(gen, size, device, dtype=torch.float32):
    return torch.empty(size, dtype=dtype, device=device).exponential_(
        generator=gen)


def sample_horseshoe_plus(gen, size=(), device=None, noise=None):
    """(d, c, b, a): a ~ IG(1/2, 1), b ~ IG(1/2, a), c ~ IG(1/2, b),
    d ~ IG(1/2, c). ``noise`` = four Gamma(1/2, 1) draws of ``size``."""
    if noise is None:
        noise = [standard_gamma(gen, 0.5, size, device=device)
                 for _ in range(4)]
    g1, g2, g3, g4 = noise
    a = 1.0 / g1
    b = 1.0 / (g2 * a)
    c = 1.0 / (g3 * b)
    d = 1.0 / (g4 * c)
    return d, c, b, a


def sample_horseshoe(gen, size=(), device=None, noise=None):
    """(lam2, a): a ~ IG(1/2, 1), lam2 ~ IG(1/2, a)."""
    if noise is None:
        noise = [standard_gamma(gen, 0.5, size, device=device)
                 for _ in range(2)]
    g1, g2 = noise
    a = 1.0 / g1
    return 1.0 / (g2 * a), a


def resample_tau2_ladder(gen, deltas_sq, lam2, tau2, tau2_c, tau2_b, tau2_a,
                         nembeds: int, stability: float = 1e-6, noise=None):
    """Horseshoe+ local-shrinkage update over (..., ncols, nD) ladders.

    ``lam2`` broadcasts against ``deltas_sq`` (pass it as (..., 1, 1)).
    ``noise`` = (gamma, expo): Gamma((nembeds+1)/2, 1) of the ladder's
    shape and Exp(1) of shape (3,) + ladder shape.
    Returns (tau2, tau2_c, tau2_b, tau2_a).
    """
    lo, hi = stability, 1.0 / stability
    rate = deltas_sq / (2.0 * lam2) + 1.0 / torch.clamp(tau2_c, lo, hi)
    shape = (nembeds + 1) / 2.0
    if noise is None:
        gamma = standard_gamma(gen, shape, rate.shape, device=rate.device)
        expo = _exponential(gen, (3,) + tuple(tau2.shape), rate.device)
    else:
        gamma, expo = noise
    tau2 = 1.0 / (gamma * (1.0 / torch.clamp(rate, lo, hi)))
    # IG(1, r) = r / Exp(1); an exact-zero Exp draw is guarded (tiny)
    e = torch.clamp(expo, min=torch.finfo(tau2.dtype).tiny)
    tau2_c = torch.clamp(1.0 / tau2 + 1.0 / tau2_b, lo, hi) / e[0]
    tau2_b = torch.clamp(1.0 / tau2_c + 1.0 / tau2_a, lo, hi) / e[1]
    tau2_a = torch.clamp(1.0 / tau2_b + 1.0, lo, hi) / e[2]
    return tau2, tau2_c, tau2_b, tau2_a


def lam2_shape(nD: int, ncols: int, nembeds: int) -> float:
    """Shape of the conjugate lam2 | V update, (nD*ncols*nembeds + 1)/2
    (functionalmf_tpu/samplers/horseshoe.py:111)."""
    return (nD * ncols * nembeds + 1) / 2.0


def resample_lam2(gen, deltas_sq_over_tau2, lam2_a, nD: int, ncols: int,
                  nembeds: int, lam2_min: float = 1e-5, noise=None):
    """Global shrinkage update, batched over the shape of ``lam2_a``.

    ``noise`` = (gamma, expo): Gamma(lam2_shape, 1) and Exp(1), each of
    lam2_a's shape. Returns (lam2, lam2_a).
    """
    rate = 1.0 / lam2_a + deltas_sq_over_tau2 / 2.0
    if noise is None:
        gamma = standard_gamma(gen, lam2_shape(nD, ncols, nembeds),
                               rate.shape, device=rate.device)
        expo = _exponential(gen, rate.shape, rate.device)
    else:
        gamma, expo = noise
    lam2 = torch.clamp(1.0 / (gamma * (1.0 / rate)), min=lam2_min)
    e = torch.clamp(expo, min=torch.finfo(lam2.dtype).tiny)
    lam2_a = (1.0 / lam2 + 1.0) / e
    return lam2, lam2_a
