"""Conjugate inverse-gamma precision prior.

Counterpart of functionalmf_tpu/samplers/conjugate.py:17-58. Gamma draws
take an explicit generator (``torch._standard_gamma``; the
``torch.distributions`` samplers take none). ``gamma=`` injects the
standard Gamma(shape, 1) draw.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ConjugateInverseGammaPrior", "resample_precision",
           "standard_gamma"]


def standard_gamma(gen, shape, size=(), device=None):
    """Gamma(shape, 1) draws: of ``size`` for a float ``shape``, of
    ``shape``'s own size for a tensor."""
    if isinstance(shape, torch.Tensor):
        alpha = shape.contiguous()
    else:
        alpha = torch.full(tuple(size), float(shape), dtype=torch.float32,
                           device=device)
    return torch._standard_gamma(alpha, generator=gen)


def resample_precision(gen, means, obs, shape: float = 0.1,
                       rate: float = 0.1, mask=None, gamma=None):
    """precision ~ Gamma(shape + n/2, rate = rate + sqerr/2), NaNs in
    ``obs`` masked out unless ``mask`` (1 = observed) is given."""
    if mask is None:
        mask = (~torch.isnan(obs)).to(means.dtype)
        obs = torch.where(torch.isnan(obs), 0.0, obs)
    diff = (means - obs) * mask
    a_post = shape + mask.sum() / 2.0
    b_post = rate + (diff * diff).sum() / 2.0
    if gamma is None:
        gamma = standard_gamma(gen, a_post, device=means.device)
    return gamma / b_post


@dataclasses.dataclass(frozen=True)
class ConjugateInverseGammaPrior:
    N: int = 1
    shape: float = 0.1
    rate: float = 0.1

    def resample(self, gen, data, mask=None, gamma=None):
        means, obs = data
        prec = resample_precision(gen, means, obs, self.shape, self.rate,
                                  mask=mask, gamma=gamma)
        return prec if self.N == 1 else prec.expand(self.N).clone()

    def draw_from_prior(self, gen, size=(), device=None, gamma=None):
        if gamma is None:
            gamma = standard_gamma(gen, self.shape, size, device=device)
        return gamma / self.rate
