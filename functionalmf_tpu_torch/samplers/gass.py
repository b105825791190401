"""Generalized Analytic Slice Sampling (GASS), grid method, batched.

Counterpart of the ``grid`` method of functionalmf_tpu/samplers/gass.py
(51-190): slice sampling on the ellipse through the current point and a
Gaussian proposal, restricted to ``A x >= c``. The joint interval of the
concave constraint arcs (classified at the arc midpoint) carries a fixed
grid of ``ngrid`` angles; every grid point is checked for feasibility
directly; one point is picked uniformly among the feasible points above
the slice by Gumbel-argmax, and the chain stays put when there is none.

Here the update runs over a leading batch axis B at once: (chains x
rows) for the W update, (chains x columns x blocks) for the V update.
The current point's log-likelihood is evaluated in the same call as the
grid's (one extra candidate), so each update is one likelihood launch.
"""
from __future__ import annotations

import math

import torch

__all__ = ["gass", "draw_gass_noise"]


def draw_gass_noise(gen, batch: int, ngrid: int, device,
                    dtype=torch.float32):
    """(log_u, gumbel): the slice height's log-uniform (B,) and the
    Gumbel scores (B, ngrid) of one batched GASS update."""
    log_u = torch.log(torch.rand(batch, generator=gen, dtype=dtype,
                                 device=device))
    tiny = torch.finfo(dtype).tiny
    u = torch.rand((batch, ngrid), generator=gen, dtype=dtype,
                   device=device).clamp_(min=tiny)
    return log_u, -torch.log(-torch.log(u))


def gass(x, loglik, A, c, *, v, log_u, gumbel, mu=None, dim_mask=None,
         eps: float = 1e-6):
    """One batched GASS update. Returns (x_new, ll_new).

    Args:
      x: (B, D) current points, each satisfying A x >= c.
      loglik: (B, G', D) -> (B, G') batched log-likelihood.
      A: dense (B, J, D) constraint matrices, or a callable mapping
        (B, G', D) points to their (B, G', J) constraint values.
      c: (B, J) constraint offsets.
      v: (B, D) proposal draws ~ N(0, Sigma).
      log_u: (B,) log of the slice's uniform; gumbel: (B, ngrid) scores.
      mu: optional (B, D) ellipse centres.
      dim_mask: optional (B, D) 0/1; masked dims stay at 0 (the lower-
        triangular W rows).
    """
    if callable(A):
        Af = A
    else:
        def Af(Y):
            return torch.einsum("bjd,bgd->bgj", A, Y)
    if mu is None:
        mu = torch.zeros_like(x)
    if dim_mask is not None:
        v = v * dim_mask
    ngrid = gumbel.shape[-1]

    x0 = x - mu
    a, b, cm = Af(torch.stack([x0, v, mu], dim=1)).unbind(1)   # (B, J) each
    cc = c - cm

    # arcs of a cos(t) + b sin(t) >= cc
    sq = a * a + b * b - cc * cc
    concerning = (sq >= 0) & (a != -cc)
    s = torch.sqrt(torch.clamp(sq, min=0.0))
    denom = a + cc
    denom_safe = torch.where(denom.abs() < 1e-30,
                             torch.where(denom < 0, -1e-30, 1e-30), denom)
    t1 = 2.0 * torch.atan((b + s) / denom_safe)
    t2 = 2.0 * torch.atan((b - s) / denom_safe)
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    tmid = 0.5 * (tmin + tmax)
    f_mid = a * torch.cos(tmid) + b * torch.sin(tmid) - cc
    interval = concerning & (f_mid >= 0)

    pi = math.pi
    has_interval = interval.any(-1)
    lo = torch.where(interval, tmin, -pi).amax(-1) + eps
    hi = torch.where(interval, tmax, pi).amin(-1) - eps
    theta_lo = torch.where(has_interval, lo, -pi)
    theta_hi = torch.where(has_interval, hi, pi)

    # equal to np.linspace(0, 1, ngrid, dtype=float32), made on the device
    lin = (torch.arange(ngrid, dtype=torch.float64, device=x.device)
           / max(ngrid - 1, 1)).to(x.dtype)
    grid = theta_lo[:, None] + (theta_hi - theta_lo)[:, None] * lin[None]
    pts = (x0[:, None] * torch.cos(grid)[..., None]
           + v[:, None] * torch.sin(grid)[..., None] + mu[:, None])
    if dim_mask is not None:
        pts = pts * dim_mask[:, None]

    feas = (Af(pts) >= c[:, None]).all(-1)
    valid = feas & (theta_hi >= theta_lo)[:, None]

    ll_all = loglik(torch.cat([pts, x[:, None]], dim=1))
    ll, cur_ll = ll_all[:, :ngrid], ll_all[:, ngrid]
    h = cur_ll + log_u
    ok = valid & (ll >= h[:, None]) & torch.isfinite(ll)
    scores = torch.where(ok, gumbel, -torch.inf)
    idx = scores.argmax(-1)
    any_ok = ok.any(-1)
    rows = torch.arange(x.shape[0], device=x.device)
    x_new = torch.where(any_ok[:, None], pts[rows, idx], x)
    ll_new = torch.where(any_ok, ll[rows, idx], cur_ll)
    return x_new, ll_new
