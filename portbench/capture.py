"""What a run keeps of the window's captured sweeps, for the check.

At a few sweeps of the window, drawn from the seed, the benchmark keeps:

* the state of a few chains (drawn from the seed) at the sweep's start
  and end (the recorder's traced callback) and as the scale moves get it;
* every GASS step (``gass_grid``, where ``models/constrained.py`` looks
  it up): what it was handed and where it went, for a sample of its items
  drawn anew at each step from the seed and every item of the chains
  kept; the family's likelihood wrappers add the candidates and the
  program's answers of the same items to the step;
* every slice move of the scale moves (``shrink_slice_1d``): its start,
  bracket and noise, each point its density was evaluated at with the
  program's density, and where it went; and the two Gibbs re-draws of the
  collapsed scales made inside the moves.

Nothing is kept outside those sweeps, and nothing here changes a value
the program computes or draws.
"""
from __future__ import annotations

import weakref

import torch

STATE_KEYS = ("W", "V", "sigma2", "lam2", "lam2_a", "Tau2")


def keep_state(rec, state, kind, sweep):
    """Keep the captured chains' state of ``sweep``: its start ("before"),
    its end ("after") or as the scale moves get it ("scales_in")."""
    ch = rec.capture_at[sweep]
    rec.captures.append(dict(kind=kind, sweep=sweep, **{
        k: state[k][ch].clone() for k in STATE_KEYS if k in state}))


def install(model, rec):
    """Wrap the program's GASS step, slice sampler and scale moves for
    ``rec``; returns the function that undoes it."""
    from functionalmf_tpu_torch.models import constrained
    gass0, slice0 = constrained.gass_grid, constrained.shrink_slice_1d
    scales0 = model._interweave_scales
    sigma0, lam0 = model._update_sigma2, model._resample_lam2

    def gass(x, loglik, A, c, **kw):
        if not rec.capturing():
            return gass0(x, loglik, A, c, **kw)
        idx = rec.sample_items(x.shape[0])
        rec.pending = dict(idx=idx)
        try:
            x_new, ll_new = gass0(x, loglik, A, c, **kw)
        finally:
            got, rec.pending = rec.pending, None
        got.pop("idx")

        def pick(t):
            return None if t is None else t[idx]
        rec.captures.append(dict(
            kind="gass", sweep=rec.sweep, B=x.shape[0],
            G=kw["gumbel"].shape[-1], idx=idx, x=x[idx], v=pick(kw["v"]),
            mu=pick(kw.get("mu")), mask=pick(kw.get("dim_mask")),
            log_u=kw["log_u"][idx], gumbel=kw["gumbel"][idx],
            x_new=x_new[idx], ll=got or None))
        return x_new, ll_new

    def slice_(x0, logdensity, lo, hi, gen=None, max_shrink=16, noise=None):
        if not (rec.capturing() and rec.in_scales):
            return slice0(x0, logdensity, lo, hi, gen=gen,
                          max_shrink=max_shrink, noise=noise)
        xs, lds = [], []

        def logdens(x):
            out = logdensity(x)
            xs.append(x)
            lds.append(out)
            return out

        x_new, ok = slice0(x0, logdens, lo, hi, gen=gen,
                           max_shrink=max_shrink, noise=noise)

        def full(b):
            return b if isinstance(b, torch.Tensor) else torch.full_like(
                x0, b)
        rec.captures.append(dict(
            kind="slice", sweep=rec.sweep, x0=full(x0), lo=full(lo),
            hi=full(hi), e=None if noise is None else noise[0],
            u=None if noise is None else noise[1], xs=torch.stack(xs),
            lds=torch.stack(lds), x_new=x_new))
        return x_new, ok

    def scales(state, y, gen):
        if not rec.capturing():
            return scales0(state, y, gen)
        keep_state(rec, state, "scales_in", rec.sweep)
        rec.in_scales = True
        try:
            return scales0(state, y, gen)
        finally:
            rec.in_scales = False

    def sigma(state, gen):
        out = sigma0(state, gen)
        if rec.in_scales:
            rec.captures.append(dict(kind="sigma2_redraw", sweep=rec.sweep,
                                     sigma2=out["sigma2"]))
        return out

    def lam(gen, s, lam2_a):
        lam2, a = lam0(gen, s, lam2_a)
        if rec.in_scales:
            rec.captures.append(dict(kind="lam2_redraw", sweep=rec.sweep,
                                     arg=s, lam2=lam2, lam2_a=a))
        return lam2, a

    constrained.gass_grid, constrained.shrink_slice_1d = gass, slice_
    model._interweave_scales = scales
    model._update_sigma2, model._resample_lam2 = sigma, lam
    ref = weakref.ref(model)

    def restore():
        constrained.gass_grid, constrained.shrink_slice_1d = gass0, slice0
        m = ref()
        if m is not None:
            for name in ("_interweave_scales", "_update_sigma2",
                         "_resample_lam2"):
                m.__dict__.pop(name, None)
    return restore
