"""The constrained Poisson BTF family: bench.py's red-black recipe on
GDELT-shaped counts, every GASS candidate through the fused kernels.

The benchmark makes the counts, the warm start and (where the traffic asks
for it) the EP centres from the seed with its frozen generator, and hands
them to ``ConstrainedNonconjugateBayesianTensorFiltering``. It wraps the
two fused functions where the model looks them up
(``models/constrained.py``), keeps a sample of their answers at a few
sweeps of the window, and in a traced run records each launch's arguments.
The check recomputes the kept answers with ``reference/poisson.py`` from
the captured candidates and the benchmark's own data.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import capture, judge
from portbench.inputs import recipe_data
from portbench.reference import checks, poisson as ref
from portbench.work import model as work

REF_BLOCK = 64         # items a reference call


def prepare_device(dev):
    """Build (or find built) and load the fused kernels."""
    if dev.type != "cuda":
        return "none (CPU: plain versions)"
    from functionalmf_tpu_torch.ops import _build
    path = _build.build()
    _build.load_library()
    return path.name


def build(config, traffic, seed, dev):
    return PoissonCell(config, traffic, seed, dev)


class PoissonCell:
    def __init__(self, config, traffic, seed, dev):
        import functionalmf_tpu_torch as fmf
        from functionalmf_tpu_torch.examples.poisson_tensor_filtering import (
            rowcol_loglikelihood)
        n, m, T, k = (config[key] for key in
                      ("nrows", "ncols", "ndepth", "nembeds"))
        self.shape = (n, m, T, k)
        d = recipe_data.make_data(np.random.default_rng(seed), n, m, T, k,
                                  config["holdout"])
        self.Y = d["Y"]
        ep = traffic.get("ep")
        self.ep = None
        if ep is not None:
            self.ep = recipe_data.ep_at_rate(d["rate"], ep["sigma_offset"])
        self.A = np.eye(T)
        self.c = np.zeros(T)
        Constraints = np.concatenate([self.A, self.c[:, None]], axis=1)
        self.nchains, self.nthin = int(traffic["nchains"]), int(traffic["nthin"])
        self.ngrid = int(config["model"]["gass_ngrid"])
        self.limits = config["limits"]
        self.schedule = traffic["v_schedule"]
        self.block_size = int(config["model"]["v_block_size"])
        self.tf_order = int(config["model"]["tf_order"])
        self.factor_rebalance = bool(config["model"]["factor_rebalance"])
        self.wmask = judge.tril_mask(n, k)
        self.model = fmf.ConstrainedNonconjugateBayesianTensorFiltering(
            n, m, T, rowcol_loglikelihood, Constraints, ep_approx=self.ep,
            device=dev, nembeds=k, seed=seed, nchains=self.nchains,
            v_schedule=traffic["v_schedule"], W_init=d["W0"], V_init=d["V0"],
            loglikelihood_cellfn=fmf.POISSON, **config["model"])
        self.data = self.Y
        present = int((~np.isnan(self.Y)).sum())
        cells = present if self.ep is None else self.Y.size
        self.flops_per_sweep = work.gass_sweep_flops(
            self.nchains, self.ngrid,
            cells * work.poisson_cell_flops(k, self.ep is not None))

    # -- the program's phases, for spans and the profiler's labels -------
    def phases(self):
        return [(self.model, "_update_W_gass", "w_update"),
                (self.model, "_update_V_gass", "v_update"),
                (self.model, "_interweave_scales", "scale_moves")]

    def free_model(self):
        self.model = None

    # -- the wrappers --------------------------------------------------
    def install(self, rec):
        from functionalmf_tpu_torch.models import constrained
        row0 = constrained.fused_row_ll_batched
        col0 = constrained.fused_col_block_ll_batched

        def row(cands, bt, y, row_chain, row_idx, cell_fn, extras=()):
            out = row0(cands, bt, y, row_chain, row_idx, cell_fn, extras)
            if rec.launches is not None:
                rec.launches.append((rec.sweep, "fused_row_ll", dict(
                    G=cands.shape[1], k=cands.shape[2], row_idx=row_idx,
                    row_chain=row_chain, ep=bool(extras))))
            p = rec.pending
            if p is not None and "out" not in p:
                i = p["idx"]
                p.update(site=("w",), cands=cands[i], out=out[i], bt=bt,
                         chain=row_chain, row=row_idx)
            return out

        def col(cands, w, y, pair_chain, pair_col, pair_t0, cell_fn,
                extras=()):
            out = col0(cands, w, y, pair_chain, pair_col, pair_t0, cell_fn,
                       extras)
            if rec.launches is not None:
                rec.launches.append((rec.sweep, "fused_col_block_ll", dict(
                    G=cands.shape[1], Tb=cands.shape[2], k=cands.shape[3],
                    pair_chain=pair_chain, pair_col=pair_col,
                    pair_t0=pair_t0, ep=bool(extras))))
            p = rec.pending
            if p is not None and "out" not in p:
                i = p["idx"]
                p.update(site="v", cands=cands[i], out=out[i], w=w,
                         chain=pair_chain, col=pair_col, t0=pair_t0)
            return out

        constrained.fused_row_ll_batched = row
        constrained.fused_col_block_ll_batched = col
        undo = capture.install(self.model, rec)

        def restore():
            undo()
            constrained.fused_row_ll_batched = row0
            constrained.fused_col_block_ll_batched = col0
        return restore

    def launch_bound_us(self, kernel, a):
        host = {key: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                for key, v in a.items()}
        n, m, T, _ = self.shape
        if kernel == "fused_row_ll":
            return work.row_launch_work(
                host["G"], host["k"], host["row_idx"], host["row_chain"],
                self.Y.reshape(n, m * T), host["ep"])["bound_us"]
        return work.col_launch_work(
            host["G"], host["Tb"], host["k"], host["pair_chain"],
            host["pair_col"], host["pair_t0"], self.Y, host["ep"])["bound_us"]

    # -- the check ---------------------------------------------------------
    def expected_sites(self):
        n, m, T, k = self.shape
        return judge.expected_sites(self.nchains, n, m, T, k,
                                    self.block_size, self.schedule)

    def site_of(self, g):
        ll = g["ll"]
        if ll is None:
            return None
        if ll["site"] == "v":
            return ("v", tuple(sorted(set(ll["t0"].tolist()))),
                    ll["cands"].shape[2])
        return ll["site"]

    def _y(self, dev):
        return torch.as_tensor(self.Y, dtype=torch.float64, device=dev)

    def _ep(self, dev):
        return None if self.ep is None else tuple(
            torch.as_tensor(e, dtype=torch.float64, device=dev)
            for e in self.ep)

    def ll_reference(self, g, lowp):
        """The reference's answers to a kept step's items: (ll (S, G + 1),
        scale), in blocks of items; with ``lowp`` the control's."""
        n, m, T, _ = self.shape
        ll, idx = g["ll"], g["idx"]
        dev = idx.device
        Y, ep = self._y(dev), self._ep(dev)
        outs = []
        for s in range(0, idx.numel(), REF_BLOCK):
            sl = slice(s, s + REF_BLOCK)
            i = idx[sl]
            ch = ll["chain"][i].long()
            cands = ll["cands"][sl]
            if ll["site"] == ("w",):
                rows = ll["row"][i].long()
                y = Y.reshape(n, m * T)[rows]
                e = None if ep is None else tuple(
                    x.reshape(n, m * T)[rows] for x in ep)
                outs.append(ref.row_ll(cands, ll["bt"][ch], y, e, lowp))
                continue
            Tb = cands.shape[2]
            tt = ll["t0"][i].long()[:, None] + torch.arange(Tb, device=dev)
            inside = (tt >= 0) & (tt < T)
            cols = ll["col"][i].long()[:, None]

            def block(x):                           # (S, Tb, n)
                xb = x.permute(1, 2, 0)[cols, tt.clamp(0, T - 1)]
                return torch.where(inside[..., None], xb,
                                   torch.full_like(xb, float("nan")))

            e = None if ep is None else tuple(block(x) for x in ep)
            outs.append(ref.col_ll(cands, ll["w"][ch], block(Y), e, lowp))
        return tuple(torch.cat(t) for t in zip(*outs))

    def opp_mismatch(self, g, pos, chain, W, V):
        """Whether a kept chain's items of a step saw another state than
        the one the sweep had left them: their chain, row or (column,
        block) and opposite factor."""
        n, m, T, k = self.shape
        ll, i = g["ll"], g["idx"][pos]
        bad = bool((ll["chain"][i] != chain).any())
        if ll["site"] == ("w",):
            bad |= bool((ll["row"][i].long() != torch.arange(
                n, device=i.device)).any())
            bad |= not torch.equal(ll["bt"][chain], V.reshape(m * T, k))
        else:
            nblk = len(i) // m
            bad |= bool((ll["col"][i].long() != torch.arange(
                m, device=i.device).repeat_interleave(nblk)).any())
            bad |= not torch.equal(ll["w"][chain], W)
        return int(bad)

    def full_ll(self, chains, lowp):
        """The scale moves' full-tensor likelihood of the kept chains:
        f(tau, mag, s) -> (ll (S,), scale (S,)) at s tau."""
        Y = self._y(chains.device)
        if lowp is not None:
            Y = Y.float()

        def f(tau, mag, s):
            s4 = s[:, None, None, None]
            return ref.full_ll(Y, s4 * tau, s4 * mag)
        return f

    def scale_const(self, dev):
        n, m, T, k = self.shape
        return judge.scale_const(self, dev, T=T, tf_order=self.tf_order,
                                 sample_lam2=True)

    def check(self, rec, results, control=None):
        """The numbers compared, each with its limit; with ``control`` (a
        name in ``checks.LOWP``) the control's."""
        return judge.judge(self, rec, results,
                           None if control is None else checks.LOWP[control])
