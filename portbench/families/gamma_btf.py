"""The dose-response family: constrained BTF whose likelihood is the
empirical-Bayes Gamma mixture, lifted by ``torch.func.vmap`` (no fused
kernel).

The benchmark simulates the plates from the seed with its frozen simulator,
builds the Gamma grid, a warm start made of the data and the EP centres,
and hands them to the app's ``fit.init_model`` (constraints in [0, 1],
softened monotone curves, lam2 fixed, the seq schedule). It wraps the
model's two lifted calls (``_w_loglik_blackbox``, ``_v_loglik_blackbox``)
on the instance: their answers are kept at a few sweeps of the window, and
in the traced run each call is a synchronised span. The check recomputes
the kept answers with ``reference/gamma_mixture.py``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from portbench import capture, judge
from portbench.inputs import dose_data
from portbench.reference import checks, gamma_mixture as ref
from portbench.work import model as work

REF_BLOCK = 8          # items a reference call


def prepare_device(dev):
    return "none (no fused kernel on this path)"


def build(config, traffic, seed, dev):
    return GammaCell(config, traffic, seed, dev)


def dose_constraints(T, slack):
    """[0, 1] and tau_t - tau_{t+1} >= -slack, as (A (J, T), c (J,))."""
    A = [np.eye(T), -np.eye(T)]
    c = [np.zeros(T), -np.ones(T)]
    mono = np.zeros((T - 1, T))
    mono[np.arange(T - 1), np.arange(T - 1)] = 1
    mono[np.arange(T - 1), np.arange(1, T)] = -1
    return np.concatenate(A + [mono]), np.concatenate(c + [
        np.full(T - 1, -slack)])


class GammaCell:
    def __init__(self, config, traffic, seed, dev):
        from functionalmf_tpu_torch.apps.doseresponse import fit
        from functionalmf_tpu_torch.apps.doseresponse.empirical_bayes import (
            GammaGridLikelihood)
        if traffic.get("v_schedule", "seq") != "seq":
            raise ValueError("the dose-response app runs the seq schedule")
        k = int(config["nembeds"])
        obs, _ = dose_data.simulate(
            k=k, n=config["cell_lines"], m=config["drugs"],
            t=config["doses"], r=config["replicates"], p=config["features"],
            n_missing=config["n_missing"], p_missing=config["p_missing"],
            seed=seed)
        Y, grid, probs, variance = dose_data.gamma_grid(obs, config["nbins"])
        self.Y, self.grid = Y, (grid, probs, variance)
        W0, V0 = dose_data.warm_start(Y, k)
        self.ep = dose_data.ep_from_fit(Y, W0, V0, config["ep_multiplier"])
        self.nchains, self.nthin = int(traffic["nchains"]), int(traffic["nthin"])
        self.limits = config["limits"]
        self.k, self.tf_order = k, int(config["tf_order"])
        self.block_size = int(config["v_block_size"])
        self.factor_rebalance = True
        self.wmask = judge.tril_mask(Y.shape[0], k)
        self.A, self.c = dose_constraints(Y.shape[2], 1e-2)
        lik = GammaGridLikelihood(grid, probs, variance, device=dev)
        args = argparse.Namespace(
            nembeds=k, tf_order=config["tf_order"], lam2=config["lam2"],
            seed=seed, nchains=self.nchains, sample_features=False,
            device=dev)
        self.model, _ = fit.init_model(Y, lik, args,
                                       warm=(W0, V0, None, self.ep))
        self.data = {"Y": Y}
        n, m, T, R = Y.shape
        ngrid = self.model.gass_ngrid
        present = (~np.isnan(Y)).sum(-1)                   # (n, m, T)
        cell = sum(int((present == r).sum())
                   * work.gamma_mixture_cell_flops(k, r, len(grid), True)
                   for r in np.unique(present))
        self.flops_per_sweep = work.gass_sweep_flops(self.nchains, ngrid,
                                                     cell)

    def phases(self):
        return [(self.model, "_update_W_gass", "w_update"),
                (self.model, "_update_V_gass", "v_update"),
                (self.model, "_interweave_scales", "scale_moves")]

    def free_model(self):
        self.model = None

    def launch_bound_us(self, kernel, a):
        raise ValueError("no fused kernel on the dose-response path")

    def install(self, rec):
        model = self.model
        w0, v0 = model._w_loglik_blackbox, model._v_loglik_blackbox

        def w_bb(pdata, V, dmask):
            inner = w0(pdata, V, dmask)

            def loglik(cands):
                with rec.span("blackbox_ll"):
                    out = inner(cands)
                p = rec.pending
                if p is not None and "out" not in p:
                    i = p["idx"]
                    p.update(site=("w",), cands=cands[i], out=out[i], V=V)
                return out
            return loglik

        def v_bb(pdata, W, X, ph):
            inner = v0(pdata, W, X, ph)

            def loglik(cands):
                with rec.span("blackbox_ll"):
                    out = inner(cands)
                p = rec.pending
                if p is not None and "out" not in p:
                    i = p["idx"]
                    p.update(site=("v", tuple(ph.starts), ph.size),
                             cands=cands[i], out=out[i], W=W, X=X)
                return out
            return loglik

        model._w_loglik_blackbox = w_bb
        model._v_loglik_blackbox = v_bb
        undo = capture.install(model, rec)

        def restore():
            undo()
            if self.model is not None:      # not yet freed for the check
                del self.model._w_loglik_blackbox
                del self.model._v_loglik_blackbox
        return restore

    # -- the check ---------------------------------------------------------
    def expected_sites(self):
        n, m, T, R = self.Y.shape
        return judge.expected_sites(self.nchains, n, m, T, self.k,
                                    self.block_size, "seq")

    def site_of(self, g):
        return None if g["ll"] is None else g["ll"]["site"]

    def _mix(self, dev, lowp):
        return ref.Mixture(*self.grid, device=dev, dtype=torch.float64
                           if lowp is None else torch.float32)

    def ll_reference(self, g, lowp):
        """The reference's answers to a kept step's items: (ll (S, G + 1),
        scale), in blocks of items; with ``lowp`` the control's."""
        n, m, T, R = self.Y.shape
        ll, idx = g["ll"], g["idx"]
        dev = idx.device
        mix = self._mix(dev, lowp)
        Y = torch.as_tensor(self.Y, dtype=torch.float64, device=dev)
        mu, sig = (torch.as_tensor(e, dtype=torch.float64, device=dev)
                   for e in self.ep)
        k, G1 = self.k, ll["cands"].shape[1]
        per = g["B"] // self.nchains
        outs = []
        if ll["site"] == ("w",):
            for s in range(0, idx.numel(), REF_BLOCK):
                sl = slice(s, s + REF_BLOCK)
                i = idx[sl]
                rows = i % n
                mask = (torch.arange(k, device=dev)[None, :]
                        <= rows[:, None]).to(ll["cands"].dtype)
                outs.append(ref.w_items_ll(
                    mix, ll["cands"][sl] * mask[:, None], ll["V"][i // n],
                    Y[rows], (mu[rows], sig[rows]), lowp))
            return tuple(torch.cat(t) for t in zip(*outs))
        starts, size = list(ll["site"][1]), ll["site"][2]
        nblk = len(starts)
        chain, local = idx // per, idx % per
        col, blk = local // nblk, local % nblk
        out_ll = torch.empty((idx.numel(), G1), dtype=torch.float64,
                             device=dev)
        out_sc = torch.empty_like(out_ll)
        for b, s0 in enumerate(starts):
            sel = torch.nonzero(blk == b).flatten()
            for s in range(0, sel.numel(), REF_BLOCK):
                j = sel[s:s + REF_BLOCK]
                cols, ch = col[j], chain[j]
                y = Y[:, cols].permute(1, 0, 2, 3)
                ep = tuple(e[:, cols].permute(1, 0, 2) for e in (mu, sig))
                a, c = ref.v_items_ll(
                    mix, ll["cands"][j].reshape(len(j), G1, size, k),
                    ll["X"][ch, cols], s0, ll["W"][ch], y, ep, lowp)
                out_ll[j], out_sc[j] = a.to(torch.float64), c
        return out_ll, out_sc

    def opp_mismatch(self, g, pos, chain, W, V):
        """Whether a kept chain's items of a step saw another state than
        the one the sweep had left them: the opposite factor and, in the V
        rounds, the curves."""
        ll = g["ll"]
        if ll["site"] == ("w",):
            return int(not torch.equal(ll["V"][chain], V))
        return int(not (torch.equal(ll["W"][chain], W)
                        and torch.equal(ll["X"][chain], V)))

    def full_ll(self, chains, lowp):
        """The scale moves' full-tensor likelihood of the kept chains:
        f(tau, mag, s) -> (ll (S,), scale (S,)) at s tau."""
        dev = chains.device
        mix = self._mix(dev, lowp)
        Y = torch.as_tensor(self.Y, dtype=mix.dtype, device=dev)

        def f(tau, mag, s):
            s4 = s[:, None, None, None]
            return ref.full_ll(mix, Y, s4 * tau, s4 * mag)
        return f

    def scale_const(self, dev):
        return judge.scale_const(self, dev, T=self.Y.shape[2],
                                 tf_order=self.tf_order, sample_lam2=False)

    def check(self, rec, results, control=None):
        """The numbers compared, each with its limit; with ``control`` (a
        name in ``checks.LOWP``) the control's."""
        return judge.judge(self, rec, results,
                           None if control is None else checks.LOWP[control])
