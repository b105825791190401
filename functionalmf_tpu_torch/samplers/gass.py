"""Generalized Analytic Slice Sampling (GASS): the grid method and the
shrink method, batched, and the JAX package's one-point call form.

Counterpart of functionalmf_tpu/samplers/gass.py: slice sampling on the
ellipse through the current point and a Gaussian proposal, restricted to
``A x >= c``. The joint interval of the concave constraint arcs
(classified at the arc midpoint) bounds the angle.

* ``gass_grid`` (the ``grid`` method, gass.py:51-190): the interval
  carries a fixed grid of ``ngrid`` angles; every grid point is checked
  for feasibility directly; one point is picked uniformly among the
  feasible points above the slice by Gumbel-argmax, and the chain stays
  put when there is none. Without ``cur_ll`` the current point's
  log-likelihood is evaluated in the same call as the grid's (one extra
  candidate), so an update is one likelihood launch.
* ``gass_shrink`` (the ``shrink`` method, gass.py:193-237): Neal's bracket
  shrinkage on the same arc, one candidate an item and iteration.

Both run over a leading batch axis B at once, with their noise passed in:
(chains x rows) for the W update, (chains x columns x blocks) for the V
update. ``gass`` is the JAX package's public call form (gass.py:51): one
point (D,), a ``torch.Generator`` in the key's place, the noise drawn
from it, ``method="grid"`` or ``"shrink"``; it runs the batched bodies
with B = 1.
"""
from __future__ import annotations

import math

import torch

from functionalmf_tpu_torch.utils import telemetry

__all__ = ["gass", "gass_grid", "draw_gass_noise", "gass_shrink",
           "draw_gass_shrink_noise"]


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


def _arc(x, A, c, v, mu, dim_mask, eps):
    """The constraint operator and the feasible arc of each item's
    ellipse: (Af, x0, v, mu, theta_lo, theta_hi, has_interval)."""
    if callable(A):
        Af = A
    else:
        def Af(Y):
            return torch.einsum("bjd,bgd->bgj", A, Y)
    if mu is None:
        mu = torch.zeros_like(x)
    if dim_mask is not None:
        v = v * dim_mask

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
    return Af, x0, v, mu, theta_lo, theta_hi, has_interval


def gass_grid(x, loglik, A, c, *, v, log_u, gumbel, mu=None, dim_mask=None,
              eps: float = 1e-6, cur_ll=None):
    """One batched GASS update by the grid method. Returns (x_new,
    ll_new).

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
      cur_ll: optional (B,) log-likelihood of x, for the slice height;
        without it x is evaluated with the grid.
    """
    ngrid = gumbel.shape[-1]
    Af, x0, v, mu, theta_lo, theta_hi, _ = _arc(x, A, c, v, mu, dim_mask, eps)

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

    if cur_ll is None:
        ll_all = loglik(torch.cat([pts, x[:, None]], dim=1))
        ll, cur_ll = ll_all[:, :ngrid], ll_all[:, ngrid]
    else:
        ll = loglik(pts)
    h = cur_ll + log_u
    ok = valid & (ll >= h[:, None]) & torch.isfinite(ll)
    scores = torch.where(ok, gumbel, -torch.inf)
    idx = scores.argmax(-1)
    any_ok = ok.any(-1)
    rows = torch.arange(x.shape[0], device=x.device)
    x_new = torch.where(any_ok[:, None], pts[rows, idx], x)
    ll_new = torch.where(any_ok, ll[rows, idx], cur_ll)
    return x_new, ll_new


def draw_gass_shrink_noise(gen, batch: int, max_shrink: int, device,
                           dtype=torch.float32):
    """(log_u, phi, u): the slice height's log-uniform (B,), the wrap
    angle phi ~ U(0, 2 pi) (B,) and the bracket uniforms (B, max_shrink)
    of one batched shrink update, drawn from ``gen`` in this order."""
    log_u = torch.log(torch.rand(batch, generator=gen, dtype=dtype,
                                 device=device))
    phi = torch.rand(batch, generator=gen, dtype=dtype,
                     device=device) * (2.0 * math.pi)
    u = torch.rand((batch, max_shrink), generator=gen, dtype=dtype,
                   device=device)
    return log_u, phi, u


def gass_shrink(x, loglik, A, c, *, v, log_u, phi, u, mu=None,
                dim_mask=None, eps: float = 1e-6, cur_ll=None):
    """One batched GASS update by bracket shrinkage (Neal 2003) on the
    feasible arc. Returns (x_new, ll_new); arguments as :func:`gass_grid`,
    with ``phi`` (B,) and ``u`` (B, max_shrink) in place of the Gumbel
    scores.

    With interval constraints the bracket is the arc, widened to hold
    theta = 0 (the current point). Without any, the arc is the whole
    circle, where a fixed [-pi, pi] window is not reversible: the bracket
    is the randomised wrap [phi - 2 pi, phi]. Each iteration proposes
    theta = lo + u (hi - lo) for every item that is not done, evaluates
    one candidate an item (``loglik`` gets (B, 1, D)), accepts a feasible
    point above the slice, and otherwise shrinks the bracket towards 0.
    An item that is done ignores every later iteration exactly: its
    point, log-likelihood and bracket are frozen.

    The loop ends when every item is done or after ``max_shrink``
    iterations. That is one host sync an iteration (``bool(done.all())``),
    chosen over a fixed ``max_shrink`` launches of the likelihood: the
    brackets halve, so the slowest item of a batch is done long before
    30.
    """
    Af, x0, v, mu, theta_lo, theta_hi, has_interval = _arc(
        x, A, c, v, mu, dim_mask, eps)
    if cur_ll is None:
        cur_ll = loglik(x[:, None])[:, 0]
    h = cur_ll + log_u
    two_pi = 2.0 * math.pi
    lo = torch.where(has_interval, theta_lo.clamp(max=0.0), phi - two_pi)
    hi = torch.where(has_interval, theta_hi.clamp(min=0.0), phi)
    xc, llc = x, cur_ll
    done = torch.zeros_like(has_interval)
    for it in range(u.shape[1]):
        th = lo + u[:, it] * (hi - lo)
        xp = (x0 * torch.cos(th)[:, None] + v * torch.sin(th)[:, None] + mu)
        if dim_mask is not None:
            xp = xp * dim_mask
        llp = loglik(xp[:, None])[:, 0]
        # feasibility is part of the slice: infeasible == ll -inf
        feas = (Af(xp[:, None])[:, 0] >= c).all(-1)
        acc = ~done & feas & (llp >= h) & torch.isfinite(llp)
        rej = ~done & ~acc
        lo = torch.where(rej & (th < 0), th, lo)
        hi = torch.where(rej & (th >= 0), th, hi)
        xc = torch.where(acc[:, None], xp, xc)
        llc = torch.where(acc, llp, llc)
        done = done | acc
        telemetry.count("sync:gass_shrink")
        if bool(done.all()):
            break
    return xc, llc


def _on_device(x, device, dtype=torch.float32):
    return torch.as_tensor(x, dtype=dtype, device=device)


def _point(x, gen, device):
    """x as a float32 tensor on its own device (a tensor) or on
    ``device``, "cuda" by default (an array), and that device; raises
    where ``gen`` is on another."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(
        device or "cuda")
    x = _on_device(x, dev)
    if gen.device != x.device:
        raise ValueError(f"the generator is on {gen.device}, x on "
                         f"{x.device}")
    return x, x.device


def gass(gen, x, sample_v, loglik, A, c, *, mu=None, cur_ll=None,
         ngrid: int = 100, dim_mask=None, eps: float = 1e-6, v=None,
         method: str = "grid", max_shrink: int = 30, device=None):
    """One GASS update of one point, in the JAX package's call form
    (functionalmf_tpu/samplers/gass.py:51). Returns (x_new, ll_new).

    Args:
      gen: a ``torch.Generator`` on x's device (JAX's key): the proposal
        (through ``sample_v``), then the slice height and the pick
        (:func:`draw_gass_noise`) or the wrap angle and the bracket
        uniforms (:func:`draw_gass_shrink_noise`) are drawn from it.
      x: (D,) current point, satisfying A x >= c, computed in float32.
        A tensor keeps its device; an array goes to ``device`` ("cuda" by
        default; there is no fallback).
      sample_v: fn(gen) -> (D,) draw v ~ N(0, Sigma); unused with ``v``.
      loglik: fn((G, D)) -> (G,) batched log-likelihood.
      A, c: (J, D) and (J,) constraints A x >= c, or ``A`` a callable
        y (D,) -> A y (J,) (lifted over the candidates with
        ``torch.func.vmap``).
      mu: optional (D,) centre of the ellipse.
      cur_ll: optional log-likelihood of x for the slice height.
      ngrid: grid points (the grid method).
      dim_mask: optional (D,) 0/1; masked dims of every candidate are 0
        (the lower-triangular W rows).
      v: optional (D,) proposal draw in place of ``sample_v(gen)``.
      method: "grid" or "shrink" (Neal's bracket shrinkage on the arc).
      max_shrink: iteration bound of the shrink method.
    """
    if method not in ("grid", "shrink"):
        raise ValueError(f"unknown gass method {method!r}")
    x, dev = _point(x, gen, device)
    D = x.shape[-1]

    def one(t):                             # (...) -> (1, ...), B = 1
        return None if t is None else _on_device(t, dev)[None]

    def ll1(P):                             # (1, G', D) -> (1, G')
        return loglik(P[0])[None]

    def A_op(Y):                            # (1, G', D) -> (1, G', J)
        return torch.func.vmap(A)(Y.reshape(-1, D)).reshape(
            Y.shape[:-1] + (-1,))

    v = one(v if v is not None else sample_v(gen))
    Af = A_op if callable(A) else one(A)
    kw = dict(v=v, mu=one(mu), dim_mask=one(dim_mask), eps=eps,
              cur_ll=None if cur_ll is None else one(cur_ll).reshape(1))
    if method == "shrink":
        log_u, phi, u = draw_gass_shrink_noise(gen, 1, max_shrink, dev)
        x_new, ll_new = gass_shrink(x[None], ll1, Af, one(c), log_u=log_u,
                                    phi=phi, u=u, **kw)
    else:
        log_u, gumbel = draw_gass_noise(gen, 1, ngrid, dev)
        x_new, ll_new = gass_grid(x[None], ll1, Af, one(c), log_u=log_u,
                                  gumbel=gumbel, **kw)
    return x_new[0], ll_new[0]
