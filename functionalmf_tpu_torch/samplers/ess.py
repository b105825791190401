"""Elliptical slice sampling (Murray, Adams & MacKay 2010), batched, and
the JAX package's one-point call form.

Counterpart of functionalmf_tpu/samplers/ess.py (reference
functionalmf/elliptical_slice.py:52-124). ``elliptical_slice_batched``
runs one update over a leading batch axis (the model's chains) at once:
the bracket-shrinking loop has a fixed bound ``max_iters`` and a mask of
the items that are done, whose point, log-likelihood and bracket are
frozen; ``loglik`` maps the whole batch (B, ...) to (B,).
``elliptical_slice`` is the JAX package's public call form (ess.py:18):
one point, ``loglik`` a scalar of it, a ``torch.Generator`` in the key's
place; it runs the batched body with B = 1.
"""
from __future__ import annotations

import math

import torch

from functionalmf_tpu_torch.samplers.gass import _on_device, _point
from functionalmf_tpu_torch.utils import telemetry

__all__ = ["elliptical_slice", "elliptical_slice_batched", "draw_ess_noise"]


def draw_ess_noise(gen, batch: int, max_iters: int, device,
                   dtype=torch.float32, angle_range: float = 0.0):
    """(log_u, u_phi, u): the slice height's log-uniform (B,), the first
    angle's uniform (B,) and the bracket uniforms (max_iters, B) of one
    batched update, drawn from ``gen`` in this order. With ``angle_range``
    > 0, u_phi is (2, B): the bracket's place, then the first angle's."""
    kw = dict(generator=gen, dtype=dtype, device=device)
    log_u = torch.log(torch.rand(batch, **kw))
    u_phi = torch.rand(((2,) if angle_range > 0 else ()) + (batch,), **kw)
    return log_u, u_phi, torch.rand((max_iters, batch), **kw)


def elliptical_slice_batched(x, prior_sample, loglik, gen=None, cur_ll=None,
                             mu=None, max_iters: int = 100, noise=None,
                             angle_range: float = 0.0):
    """One batched ESS update. Returns (x_new, ll_new).

    Args:
      x: (B, ...) current points.
      prior_sample: (B, ...) draws nu ~ N(0, Sigma), x's shape.
      loglik: (B, ...) -> (B,) batched log-likelihood.
      cur_ll: optional (B,) log-likelihood of x.
      mu: optional mean offset; the ellipse is traced around mu.
      noise: optional (log_u, u_phi, u) as :func:`draw_ess_noise` gives
        them; else they are drawn from ``gen``.
      angle_range: 0, the whole ellipse; > 0, a bracket of that width
        placed at random around 0 (ess.py:44-50).

    The first angle is phi = 2 pi u_phi with the bracket [phi - 2 pi,
    phi]; with ``angle_range`` the bracket is [-r u_phi[0], -r u_phi[0] +
    r] and phi uniform on it (u_phi[1]). A rejected angle shrinks the
    bracket towards 0 and the next is uniform on it. An item whose
    ``max_iters`` proposals are all rejected keeps its point. The loop
    ends when every item is done: one host sync an iteration, as in the
    shrink method of GASS.
    """
    B = x.shape[0]
    nu = prior_sample
    if mu is None:
        mu = torch.zeros_like(x)
    if cur_ll is None:
        cur_ll = loglik(x)
    if noise is None:
        noise = draw_ess_noise(gen, B, max_iters, x.device, x.dtype,
                               angle_range)
    log_u, u_phi, u = noise
    h = log_u + cur_ll

    two_pi = 2.0 * math.pi
    if angle_range > 0:
        phi_min = -angle_range * u_phi[0]
        phi_max = phi_min + angle_range
        phi = u_phi[1] * (phi_max - phi_min) + phi_min
    else:
        phi = u_phi * two_pi
        phi_min, phi_max = phi - two_pi, phi
    x0 = x - mu
    lead = (B,) + (1,) * (x.dim() - 1)

    xc, llc = x, cur_ll
    done = torch.zeros(B, dtype=torch.bool, device=x.device)
    for it in range(min(max_iters, u.shape[0])):
        xp = (x0 * torch.cos(phi).reshape(lead)
              + nu * torch.sin(phi).reshape(lead) + mu)
        llp = loglik(xp)
        acc = ~done & (llp >= h)
        rej = ~done & ~acc
        # shrink the bracket towards 0 (elliptical_slice.py:111-122)
        phi_max = torch.where(rej & (phi > 0), phi, phi_max)
        phi_min = torch.where(rej & (phi < 0), phi, phi_min)
        xc = torch.where(acc.reshape(lead), xp, xc)
        llc = torch.where(acc, llp, llc)
        done = done | acc
        phi = torch.where(done, phi, u[it] * (phi_max - phi_min) + phi_min)
        telemetry.count("sync:ess")
        if bool(done.all()):
            break
    return xc, llc


def elliptical_slice(gen, x, prior_sample, loglik, cur_ll=None, mu=None,
                     angle_range: float = 0.0, max_iters: int = 100,
                     device=None):
    """One ESS update of one point, in the JAX package's call form
    (functionalmf_tpu/samplers/ess.py:18). Returns (x_new, ll_new).

    Args:
      gen: a ``torch.Generator`` on x's device (JAX's key); the slice
        height, the bracket and the angles are drawn from it
        (:func:`draw_ess_noise`).
      x: the current point, any shape, computed in float32. A tensor
        keeps its device; an array goes to ``device`` ("cuda" by default;
        there is no fallback).
      prior_sample: a draw nu ~ N(0, Sigma) of x's shape.
      loglik: fn(point) -> scalar log-likelihood.
      cur_ll: optional log-likelihood of x.
      mu: optional mean offset; the ellipse is traced around mu.
      angle_range: 0, the whole ellipse; > 0, a bracket of that width
        placed at random.
      max_iters: the bound on proposals; past it x is kept.
    """
    x, dev = _point(x, gen, device)

    def one(t):                             # (...) -> (1, ...), B = 1
        return None if t is None else _on_device(t, dev)[None]

    def ll1(P):                             # (1, ...) -> (1,)
        return loglik(P[0]).reshape(1)

    x_new, ll_new = elliptical_slice_batched(
        x[None], one(prior_sample), ll1, gen,
        cur_ll=None if cur_ll is None else one(cur_ll).reshape(1),
        mu=one(mu), max_iters=max_iters, angle_range=angle_range)
    return x_new[0], ll_new[0]
