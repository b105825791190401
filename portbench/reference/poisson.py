"""Plain reference of the fused kernels' Poisson candidate log-likelihoods.

The kernels' contract (``ops/fused_ll.py``): a cell contributes
``y log(max(tau, 1e-8)) - max(tau, 1e-8)`` where y is present and 0 where
it is NaN (the terms of y alone, which cancel in the GASS slice test, are
left out), with tau the candidate's inner product with the opposite
factor; with EP the cell's ``log N(tau; mu, sig)`` is subtracted wherever
mu is present. Computed here with plain torch operations in the dtype the
caller names; nothing of the program is imported.
"""
import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def cell_terms(y, tau):
    rate = torch.clamp(tau, min=1e-8)
    nan = torch.isnan(y)
    y0 = torch.where(nan, torch.zeros_like(y), y)
    return torch.where(nan, torch.zeros_like(tau), y0 * torch.log(rate) - rate)


def cell_scale(y, tau, mag):
    """What bounds a cell's rounding: the magnitudes of its two terms and
    the change that tau's own rounding (at most eps x ``mag``, the sum of
    the magnitudes of its k products) makes, |y / rate - 1| x mag."""
    rate = torch.clamp(tau.abs(), min=1e-8)
    nan = torch.isnan(y)
    y0 = torch.where(nan, torch.zeros_like(y), y).abs()
    s = y0 * torch.log(rate).abs() + rate + (y0 / rate + 1.0) * mag
    return torch.where(nan, torch.zeros_like(s), s)


def ep_terms(tau, mu, sig):
    lp = (-0.5 * ((tau - mu) / sig) ** 2 - torch.log(sig)
          - _HALF_LOG_2PI)
    return torch.where(torch.isnan(mu), torch.zeros_like(lp), lp)


def ep_scale(tau, mu, sig, mag):
    z = (tau - mu) / sig
    s = 0.5 * z ** 2 + torch.log(sig).abs() + _HALF_LOG_2PI \
        + (z / sig).abs() * mag
    return torch.where(torch.isnan(mu), torch.zeros_like(s), s)


def _cells(y, tau, mag, ep):
    """(terms, scale) of every cell."""
    t, s = cell_terms(y, tau), cell_scale(y, tau, mag)
    if ep is not None:
        t = t - ep_terms(tau, *ep)
        s = s + ep_scale(tau, *ep, mag)
    return t, s


def _inputs(lowp, *xs):
    """The product's inputs in float64, or (the control) rounded by
    ``lowp`` in float32."""
    if lowp is None:
        return tuple(x.to(torch.float64) for x in xs)
    return tuple(lowp(x.float()) for x in xs)


def row_ll(cands, bt, y, ep=None, lowp=None):
    """W update items: cands (S, G, k), bt (S, C, k) the item's chain's
    opposite factor, y (S, C) the item's row; ep None or (mu, sig) each
    (S, C). Returns (ll (S, G), scale (S, G)): the sum of the cells' terms
    and the sum of what bounds their rounding (:func:`cell_scale`), in
    float64; with ``lowp`` (the control) the products' inputs rounded by
    it and everything in float32."""
    f64 = torch.float64
    mag = torch.einsum("sgk,sck->sgc", cands.to(f64).abs(), bt.to(f64).abs())
    cands, bt = _inputs(lowp, cands, bt)
    dt = cands.dtype
    tau = torch.einsum("sgk,sck->sgc", cands, bt)
    ep = None if ep is None else tuple(e.to(dt)[:, None, :] for e in ep)
    t, s = _cells(y.to(dt)[:, None, :], tau, mag.to(dt), ep)
    return t.sum(-1).to(f64), s.to(f64).sum(-1)


def col_ll(cands, w, yb, ep=None, lowp=None):
    """V update pairs: cands (S, G, Tb, k), w (S, n, k) the pair's chain's
    W, yb (S, Tb, n) the pair's cells, NaN outside [0, T); ep None or (mu,
    sig) each (S, Tb, n), NaN outside. Returns (ll (S, G), scale (S, G))
    as :func:`row_ll`."""
    f64 = torch.float64
    mag = torch.einsum("sgtk,snk->sgtn", cands.to(f64).abs(), w.to(f64).abs())
    cands, w = _inputs(lowp, cands, w)
    dt = cands.dtype
    tau = torch.einsum("sgtk,snk->sgtn", cands, w)
    ep = None if ep is None else tuple(e.to(dt)[:, None] for e in ep)
    t, s = _cells(yb.to(dt)[:, None], tau, mag.to(dt), ep)
    return t.sum((-2, -1)).to(f64), s.to(f64).sum((-2, -1))


def full_ll(y, tau, mag):
    """The full-tensor likelihood of the scale moves: y (n, m, T), tau and
    mag (S, n, m, T). Returns (ll (S,), scale (S,))."""
    return (cell_terms(y, tau).sum((1, 2, 3)),
            cell_scale(y, tau, mag).sum((1, 2, 3)))
