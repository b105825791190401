"""The numbers that decide ``correct``, from what the window's captured
sweeps kept (``capture.py``) and the plain reference (``reference/``).

Over every captured sweep:

* ``ll_gap``: each kept likelihood answer (a sample of every GASS step's
  items, drawn anew at each step, and every item of the kept chains)
  against the reference's, as a share of what bounds its rounding;
* ``wrong_steps``: a count, limit 0. The GASS steps must be the ones the
  configuration's schedule runs, in its order, each over every item (W:
  chains x rows; each V round: chains x columns x its blocks); then, for
  each kept chain, the sweep is followed from its start: every step's
  input is the state the previous step left (W, V and the opposite
  factor, bit for bit), every GASS move is one the reference could have
  made from its own likelihoods and constraint values
  (``reference/gass_step.py``), and every slice step of the scale moves
  is one the reference could have taken (``reference/scale_moves.py``);
* ``ellipse_gap``: how far the kept chains' candidates lie off the
  ellipse through x with the step's v and mu, and off an evenly spaced
  grid of angles;
* ``scale_gap``: the scale moves' log densities (the full-tensor
  likelihood with its priors) against the reference's;
* ``state_gap``: the scale moves' brackets, the lam2 re-draw's argument
  and the state the moves leave, against the reference's (relative);
* ``constraint_violation``: the largest amount by which any draw of the
  window breaks a constraint of the configuration.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import checks, gass_step, scale_moves

F64 = torch.float64
# the model's defaults, which both configurations keep: the clamp of the
# prior's scales and sigma2's inverse-Gamma prior
STABILITY = 1e-6
SIGMA2_PRIOR = (0.1, 0.1)


def tril_mask(n, k):
    """W's active coordinates: row i holds embeddings 0..i."""
    return (np.arange(k)[None] <= np.arange(n)[:, None]).astype(np.float32)


def schedule_phases(T, size, schedule):
    """The V update's rounds as (block starts, block size): red-black, the
    even then the odd blocks of ``size`` and a ragged tail block; seq,
    each block in turn."""
    if schedule == "redblack":
        nb, rem = divmod(T, size)
        out = [([b * size for b in range(first, nb, 2)], size)
               for first in (0, 1) if first < nb]
        return out + ([([nb * size], rem)] if rem else [])
    return [([s0], min(size, T - s0)) for s0 in range(0, T, size)]


def expected_sites(nchains, n, m, T, k, size, schedule):
    """The GASS steps a sweep makes, in order: the W rows, then each V
    round, with their item counts B and dimensions D."""
    out = [dict(key=("w",), B=nchains * n, D=k)]
    for starts, sz in schedule_phases(T, size, schedule):
        out.append(dict(key=("v", tuple(starts), sz), starts=starts,
                        size=sz, B=nchains * m * len(starts), D=sz * k))
    return out


def scale_const(cell, dev, *, T, tf_order, sample_lam2):
    """What the scale moves' reference needs of the configuration."""
    f = dict(dtype=F64, device=dev)
    return dict(wmask=torch.as_tensor(cell.wmask, **f),
                delta=torch.as_tensor(scale_moves.tf_penalty(T, tf_order),
                                      **f),
                stability=STABILITY, sigma2_a=SIGMA2_PRIOR[0],
                sigma2_b=SIGMA2_PRIOR[1], sample_sigma2=True,
                sample_lam2=sample_lam2,
                factor_rebalance=cell.factor_rebalance,
                A=torch.as_tensor(cell.A, **f), c=torch.as_tensor(cell.c, **f))


def _by_sweep(captures):
    out = {}
    for c in captures:
        out.setdefault(c["sweep"], []).append(c)
    return out


def _chain_items(g, chain, nchains):
    """Positions in the step's sample of each item of ``chain``, in item
    order (one each), or None where any is missing."""
    per = g["B"] // nchains
    idx = g["idx"].cpu()
    want = torch.arange(chain * per, (chain + 1) * per)
    pos = torch.searchsorted(idx, want)
    pos = torch.clamp(pos, max=len(idx) - 1)
    if not bool((idx[pos] == want).all()):
        return None
    return pos.to(g["idx"].device)


class Numbers:
    def __init__(self, limits):
        self.limits = limits
        self.v = dict(ll_gap=0.0, wrong_steps=0, ellipse_gap=0.0,
                      scale_gap=0.0, state_gap=0.0)
        self.compared = dict.fromkeys(self.v, 0)
        self.failed = dict.fromkeys(self.v, 0)

    def most(self, key, values):
        if values.numel() == 0:
            return
        values = torch.where(torch.isfinite(values), values,
                             torch.full_like(values, float("inf")))
        self.v[key] = max(self.v[key], float(values.max()))
        self.compared[key] += values.numel()
        self.failed[key] += int((values > self.limits[key]).sum())

    def wrong(self, count, compared=1):
        self.v["wrong_steps"] += int(count)
        self.compared["wrong_steps"] += int(compared)
        self.failed["wrong_steps"] += int(count)


def judge(cell, rec, results, lowp=None):
    """The numbers of a run, each dict(value, limit, compared, failed).
    With ``lowp`` (a rounding of float32 tensors: the control) the
    reference computed from inputs so rounded stands in the program's
    place for the likelihood answers, the candidates and the scale moves'
    densities and state."""
    lim = dict(cell.limits)
    lim.setdefault("wrong_steps", 0)
    num = Numbers(lim)
    sweeps = _by_sweep(rec.captures)
    expected = cell.expected_sites()
    for s in sorted(rec.captured):
        recs = sweeps.get(s, [])
        steps = [g for g in recs if g["kind"] == "gass"]
        in_order = _judge_sites(cell, steps, expected, num)
        _judge_answers(cell, steps, num, lowp)
        if in_order:
            _judge_chains(cell, rec, s, recs, steps, expected, num, lowp)
    if not rec.captured:
        num.wrong(1)
    out = {k: dict(value=v, limit=lim[k], compared=num.compared[k],
                   failed=num.failed[k]) for k, v in num.v.items()}
    viol = checks.constraint_violation(results["W"], results["V"], cell.A,
                                       cell.c, rec.device)
    out["constraint_violation"] = dict(
        value=viol, limit=lim["constraint_atol"],
        compared=int(results["W"].shape[0]),
        failed=int(viol > lim["constraint_atol"]))
    return out


def _judge_sites(cell, steps, expected, num):
    """The sweep's GASS steps against the schedule's: each site in order,
    with its item count and dimension."""
    got = [cell.site_of(g) for g in steps]
    want = [e["key"] for e in expected]
    bad = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    for g, e in zip(steps, expected):
        if g["B"] != e["B"] or g["x"].shape[-1] != e["D"]:
            bad += 1
    num.wrong(bad, max(len(want), 1))
    return bad == 0


def _judge_answers(cell, steps, num, lowp):
    for g in steps:
        if g["ll"] is None:
            continue
        ll, scale = cell.ll_reference(g, None)
        prog = g["ll"]["out"] if lowp is None else cell.ll_reference(
            g, lowp)[0]
        num.most("ll_gap", checks.item_gaps(prog, ll, scale))
        g["ll_ref"] = (ll, scale)


def _judge_chains(cell, rec, s, recs, steps, expected, num, lowp):
    """Follow each kept chain through sweep ``s``."""
    kinds = {}
    for r in recs:
        kinds.setdefault(r["kind"], []).append(r)
    state = {k: (kinds.get(k) or [None])[0]
             for k in ("before", "after", "scales_in")}
    if any(v is None for v in state.values()):
        num.wrong(1)
        return
    chains = rec.captured[s].tolist()
    wmask = torch.as_tensor(cell.wmask, device=rec.device)
    A_t = torch.as_tensor(cell.A, dtype=F64, device=rec.device)
    c_t = torch.as_tensor(cell.c, dtype=F64, device=rec.device)
    for q, c in enumerate(chains):
        W = state["before"]["W"][q]                     # float32, (n, k)
        V = state["before"]["V"][q].clone()             # (m, T, k)
        for g, e in zip(steps, expected):
            pos = _chain_items(g, c, cell.nchains)
            if pos is None or g["ll"] is None or "ll_ref" not in g:
                num.wrong(1)
                continue
            x, x_new = g["x"][pos], g["x_new"][pos]
            cands = g["ll"]["cands"][pos].reshape(len(pos), g["G"] + 1, -1)
            num.wrong(int((cands[:, -1] != x).any(-1).sum()), len(pos))
            if e["key"][0] == "w":
                num.wrong(int((x != W).any(-1).sum()), len(pos))
                num.wrong(cell.opp_mismatch(g, pos, c, W=W, V=V), 1)
                margin = gass_step.margins_w(cands[:, :-1], V, A_t, c_t)
            else:
                starts, size = e["starts"], e["size"]
                nblk = len(starts)
                cur = torch.stack([V[j, starts[b]:starts[b] + size]
                                   .reshape(-1) for j in range(V.shape[0])
                                   for b in range(nblk)])
                num.wrong(int((x != cur).any(-1).sum()), len(pos))
                num.wrong(cell.opp_mismatch(g, pos, c, W=W * wmask, V=V),
                          1)
                margin = gass_step.margins_v(cands[:, :-1], W * wmask, V,
                                             starts, size, A_t, c_t)
            mu = None if g["mu"] is None else g["mu"][pos]
            mask = None if g["mask"] is None else g["mask"][pos]
            pts = cands[:, :-1]
            if lowp is not None:
                pts = gass_step.lowp_candidates(x, g["v"][pos], mu, mask, pts,
                                                lowp)
            gap, span, _ = gass_step.ellipse_gaps(x, g["v"][pos], mu, mask,
                                                  pts)
            num.most("ellipse_gap", gap)
            ll = g["ll_ref"][0][pos]
            bad = gass_step.unexplained_moves(
                ll, gass_step.tie_widths(g["ll"]["out"][pos], ll), margin,
                torch.ones_like(margin),
                span, g["log_u"][pos], g["gumbel"][pos], x, cands, x_new)
            num.wrong(int(bad.sum()), len(pos))
            if e["key"][0] == "w":
                W = x_new.reshape(W.shape)
            else:
                blocks = x_new.reshape(V.shape[0], len(starts), size, -1)
                for b, t0 in enumerate(starts):
                    V[:, t0:t0 + size] = blocks[:, b]
        ent = state["scales_in"]
        num.wrong(int((ent["W"][q] != W).any().item())
                  + int((ent["V"][q] != V).any().item()), 2)
    _judge_scales(cell, kinds, state, chains, num, lowp)


def _judge_scales(cell, kinds, state, chains, num, lowp):
    calls = kinds.get("slice", [])
    if any(cl["e"] is None for cl in calls):
        num.wrong(1)
        return
    ch = torch.as_tensor(chains, device=state["before"]["W"].device)
    calls = [dict(x0=cl["x0"][ch], lo=cl["lo"][ch], hi=cl["hi"][ch],
                  e=cl["e"][ch], u=cl["u"][:, ch], xs=cl["xs"][:, ch],
                  lds=cl["lds"][:, ch], x_new=cl["x_new"][ch])
             for cl in calls]
    red = {}
    for r in kinds.get("sigma2_redraw", [])[:1]:
        red["sigma2"] = r["sigma2"][ch].to(F64)
    for r in kinds.get("lam2_redraw", [])[:1]:
        red.update(lam2_arg=r["arg"][ch].to(F64), lam2=r["lam2"][ch].to(F64),
                   lam2_a=r["lam2_a"][ch].to(F64))
    ent = {k: v.to(F64) for k, v in state["scales_in"].items()
           if isinstance(v, torch.Tensor)}
    after = {k: v.to(F64) for k, v in state["after"].items()
             if isinstance(v, torch.Tensor)}
    const = cell.scale_const(ch.device)
    judge = scale_moves.Judge()
    try:
        if lowp is None:
            scale_moves.replay(ent, calls, red, after, const,
                               cell.full_ll(ch, None), judge)
        else:
            # the control: the reference from rounded inputs in float32,
            # its densities and state in the program's place
            low = {k: lowp(v.float()) for k, v in ent.items()}
            rec_low = scale_moves.Judge(record=True)
            exit_low = scale_moves.replay(
                low, calls, {k: v.float() for k, v in red.items()}, None,
                {k: (v.float() if torch.is_tensor(v) else v)
                 for k, v in const.items()}, cell.full_ll(ch, lowp), rec_low)
            for cl, ld in zip(calls, rec_low.densities):
                cl["lds"] = ld
            scale_moves.replay(ent, calls, red,
                               {k: v.to(F64) for k, v in exit_low.items()},
                               const, cell.full_ll(ch, None), judge)
    except ValueError:          # a move or re-draw of the schedule missing
        num.wrong(1)
        return
    num.most("scale_gap", torch.tensor([judge.scale_gap]))
    num.most("state_gap", torch.tensor([judge.state_gap]))
    num.wrong(judge.wrong, max(judge.compared, 1))
