"""Elliptical slice sampling (Murray, Adams & MacKay 2010), batched.

Counterpart of functionalmf_tpu/samplers/ess.py (reference
functionalmf/elliptical_slice.py:52-124). One update runs over a leading
batch axis (the model's chains) at once: the bracket-shrinking loop has a
fixed bound ``max_iters`` and a mask of the items that are done, whose
point, log-likelihood and bracket are frozen. ``loglik`` maps the whole
batch (B, ...) to (B,).
"""
from __future__ import annotations

import math

import torch

__all__ = ["elliptical_slice", "draw_ess_noise"]


def draw_ess_noise(gen, batch: int, max_iters: int, device,
                   dtype=torch.float32):
    """(log_u, u_phi, u): the slice height's log-uniform (B,), the first
    angle's uniform (B,) and the bracket uniforms (max_iters, B) of one
    batched update, drawn from ``gen`` in this order."""
    kw = dict(generator=gen, dtype=dtype, device=device)
    log_u = torch.log(torch.rand(batch, **kw))
    u_phi = torch.rand(batch, **kw)
    return log_u, u_phi, torch.rand((max_iters, batch), **kw)


def elliptical_slice(x, prior_sample, loglik, gen=None, cur_ll=None, mu=None,
                     max_iters: int = 100, noise=None):
    """One batched ESS update. Returns (x_new, ll_new).

    Args:
      x: (B, ...) current points.
      prior_sample: (B, ...) draws nu ~ N(0, Sigma), x's shape.
      loglik: (B, ...) -> (B,) batched log-likelihood.
      cur_ll: optional (B,) log-likelihood of x.
      mu: optional mean offset; the ellipse is traced around mu.
      noise: optional (log_u, u_phi, u) as :func:`draw_ess_noise` gives
        them; else they are drawn from ``gen``.

    The first angle is phi = 2 pi u_phi with the bracket [phi - 2 pi,
    phi]; a rejected angle shrinks the bracket towards 0 and the next is
    uniform on it. An item whose ``max_iters`` proposals are all rejected
    keeps its point. The loop ends when every item is done: one host sync
    an iteration, as in the shrink method of GASS.
    """
    B = x.shape[0]
    nu = prior_sample
    if mu is None:
        mu = torch.zeros_like(x)
    if cur_ll is None:
        cur_ll = loglik(x)
    if noise is None:
        noise = draw_ess_noise(gen, B, max_iters, x.device, x.dtype)
    log_u, u_phi, u = noise
    h = log_u + cur_ll

    two_pi = 2.0 * math.pi
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
        if bool(done.all()):
            break
    return xc, llc
