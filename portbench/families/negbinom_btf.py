"""The negative-binomial BTF family: the NB-BTF arm of the GDELT politics
benchmark (politics/benchmark.py:139-158), conjugate updates through the
Polya-Gamma augmentation, no GASS and no fused kernel.

The benchmark makes the counts from the seed with its frozen generator
(``inputs/recipe_data.py``, as the Poisson family) and hands them to
``NegativeBinomialBayesianTensorFiltering`` as the app builds it; every
chain starts from the model's own seeded initial state (the app gives the
NB arm no warm start). At a few sweeps of the window it keeps, through
wrappers where the model looks the steps up:

* the R moves (``_update_R`` on the model): R, W and V before them, their
  noise (drawn with the model's own ``draw_R_noise`` and passed in, so the
  generator is used in the same order), each move's sum of the likelihood
  ratio (``_window_sum`` in ``models/negbinom.py``) and R after them, for
  the kept chains;
* the Polya-Gamma draw (``polya_gamma`` in ``models/binomial.py``): its
  arguments, its noise and its answer at 256 cells drawn from the seed and
  at every cell of the kept chains;
* the prior's re-draws (``_update_sigma2``: only that they ran);
* the W draw (``sample_mvn_from_precision`` in ``models/gaussian.py``) and
  the V draw (``sample_mvn_block_banded_retiled`` there): the precision,
  the mean part, the normals and the answer of the kept chains.

The check (``check``): the sweep's steps in the order R, PG, prior, W, V,
each step's input the state the step before left, bit for bit where the
program's value is exact (``wrong_steps``); every R move's sum of the
likelihood ratio against ``reference/negbinom.py``'s, over the sum of its
terms' magnitudes (``r_gap``), and its decision, from that sum, and the R
it leaves (``r_wrong_moves``; the program's R before each move is found by
running its own moves again on the kept chains with the later moves'
uniforms set to infinity, so that they reject, and the last run must give
the R the window's run left, bit for bit); omega (``pg_gap``), the W rows'
precision and draw (``w_gap``) and the V columns' bands and draw
(``v_gap``) against the reference's.
The model has no constraints, so ``constraint_violation`` does not apply.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import judge
from portbench.inputs import recipe_data
from portbench.reference import checks, negbinom as ref
from portbench.reference.scale_moves import tf_penalty
from portbench.work import negbinom as work

# the model's defaults, which the configuration keeps (factor.py:542, 547
# and ops/polyagamma.py's switch to the moment-matched normal)
ACCEPT_CLIP = (-10.0, 1.0)
R_MIN = 1.0
PG_NORMAL_ABOVE = 50.0
STEPS = ("r_moves", "pg", "prior", "w", "v")
PG_BLOCK = 32768       # cells a reference call
V_BLOCK = 8            # columns a reference call


def prepare_device(dev):
    return "none (no fused kernel on this path)"


def build(config, traffic, seed, dev):
    return NegBinomCell(config, traffic, seed, dev)


class Numbers(judge.Numbers):
    """``judge.Numbers`` over this family's keys, with a count for each
    of the two exact ones."""

    KEYS = ("wrong_steps", "r_wrong_moves", "r_gap", "pg_gap", "w_gap",
            "v_gap")

    def __init__(self, limits):
        self.limits = limits
        self.v = dict.fromkeys(self.KEYS, 0.0)
        self.v["wrong_steps"] = self.v["r_wrong_moves"] = 0
        self.compared = dict.fromkeys(self.KEYS, 0)
        self.failed = dict.fromkeys(self.KEYS, 0)

    def most(self, key, values):
        super().most(key, values.to(torch.float64))

    def count(self, key, wrong, compared=1):
        self.v[key] += int(wrong)
        self.compared[key] += int(compared)
        self.failed[key] += int(wrong)

    def out(self):
        return {k: dict(value=self.v[k], limit=self.limits[k],
                        compared=self.compared[k], failed=self.failed[k])
                for k in self.KEYS}


class NegBinomCell:
    def __init__(self, config, traffic, seed, dev):
        import functionalmf_tpu_torch as fmf
        n, m, T, k = (config[key] for key in
                      ("nrows", "ncols", "ndepth", "nembeds"))
        self.shape = (n, m, T, k)
        d = recipe_data.make_data(np.random.default_rng(seed), n, m, T, k,
                                  config["holdout"])
        self.Y = d["Y"]
        self.nchains, self.nthin = int(traffic["nchains"]), int(traffic["nthin"])
        self.limits = config["limits"]
        self.kw = dict(config["model"], nembeds=k)
        self.kw["rdims"] = tuple(self.kw["rdims"])
        self.dev = dev
        self.model = fmf.NegativeBinomialBayesianTensorFiltering(
            n, m, T, device=dev, seed=seed, nchains=self.nchains, **self.kw)
        self.data = self.Y
        present = int((~np.isnan(self.Y)).sum())
        self.flops_per_sweep = work.sweep_flops(
            self.nchains, n, m, T, k, present,
            nmetropolis=self.kw["nmetropolis"],
            num_terms=self.kw["pg_num_terms"],
            tf_order=self.kw["tf_order"])

    # -- the program's phases, for spans and the profiler's labels -------
    def phases(self):
        return [(self.model, "_update_R", "r_moves"),
                (self.model, "_pg_update", "pg_draw"),
                (self.model, "_gaussian_update_W", "w_update"),
                (self.model, "_gaussian_update_V", "v_update")]

    def free_model(self):
        self.model = None

    def launch_bound_us(self, kernel, a):
        raise ValueError("no fused kernel on the negative-binomial path")

    # -- the wrappers --------------------------------------------------
    def install(self, rec):
        from functionalmf_tpu_torch.models import binomial, gaussian, negbinom
        model = self.model
        ws0 = negbinom._window_sum
        pg0 = binomial.polya_gamma
        w0 = gaussian.sample_mvn_from_precision
        v0 = gaussian.sample_mvn_block_banded_retiled
        r0, s0 = model._update_R, model._update_sigma2

        def keep(kind, **kw):
            rec.captures.append(dict(kind=kind, sweep=rec.sweep, **kw))

        def chains():
            return rec.capture_at[rec.sweep]

        sums = []            # the moves' likelihood-ratio sums, kept

        def window_sum(x, dims):
            out = ws0(x, dims)
            if sums:
                sums[-1].append(out[chains()].clone())
            return out

        def update_R(state, pdata, gen, noise=None):
            if not rec.capturing():
                return r0(state, pdata, gen, noise=noise)
            if noise is None:
                noise = model.draw_R_noise(gen)
            sums.append([])
            try:
                out = r0(state, pdata, gen, noise=noise)
            finally:
                al = sums.pop()
            ch = chains()
            keep("r_moves", W=state["W"][ch].clone(),
                 V=state["V"][ch].clone(), R=state["R"][ch].clone(),
                 z=noise[0][:, ch].clone(), u=noise[1][:, ch].clone(),
                 R_out=out["R"][ch].clone(), al=[
                     a.reshape(state["R"][ch].shape) for a in al])
            return out

        def polya_gamma(gen, b, c, num_terms=16, **kw):
            out = pg0(gen, b, c, num_terms=num_terms, **kw)
            if rec.capturing():
                idx = rec.sample_items(out.numel())
                noise = kw.get("gamma_noise")

                def flat(t):
                    return None if t is None else t.reshape(-1)[idx]

                def cells(t, lead):
                    return t.reshape(t.shape[:lead] + (-1,))[..., idx]
                keep("pg", idx=idx, chains=chains(), shape=tuple(out.shape),
                     num_terms=num_terms, kw={key: v for key, v in kw.items()
                                              if not torch.is_tensor(v)
                                              and key != "gamma_noise"},
                     g_given=kw.get("g") is not None,
                     b=flat(b.expand(out.shape)), c=flat(c.expand(out.shape)),
                     z=flat(kw.get("z")), omega=flat(out),
                     noise=None if noise is None else (
                         cells(noise[0], 2), cells(noise[1], 2),
                         cells(noise[2], 1)))
            return out

        def mvn(gen, Q, **kw):
            out = w0(gen, Q, **kw)
            if rec.capturing():
                ch = chains()
                z = kw.get("z")
                keep("w", Q=Q[ch].clone(), mu_part=kw["mu_part"][ch].clone(),
                     z=None if z is None else z[ch].clone(),
                     out=out[ch].clone())
            return out

        def banded(gen, bands, **kw):
            out = v0(gen, bands, **kw)
            if rec.capturing():
                ch = chains()
                x = out[0] if kw.get("return_repairs") else out
                z, zt = kw.get("z"), kw.get("z_tiled")
                keep("v", bands=bands[ch].clone(),
                     mu_part=kw["mu_part"][ch].clone(),
                     z=None if z is None else z[ch].clone(),
                     z_tiled=None if zt is None else zt[ch].clone(),
                     out=x[ch].clone())
            return out

        def update_sigma2(state, gen):
            if rec.capturing():
                keep("prior")
            return s0(state, gen)

        negbinom._window_sum = window_sum
        binomial.polya_gamma = polya_gamma
        gaussian.sample_mvn_from_precision = mvn
        gaussian.sample_mvn_block_banded_retiled = banded
        model._update_R, model._update_sigma2 = update_R, update_sigma2

        def restore():
            negbinom._window_sum = ws0
            binomial.polya_gamma = pg0
            gaussian.sample_mvn_from_precision = w0
            gaussian.sample_mvn_block_banded_retiled = v0
            if self.model is not None:      # not yet freed for the check
                for name in ("_update_R", "_update_sigma2"):
                    self.model.__dict__.pop(name, None)
        return restore

    # -- the check ---------------------------------------------------------
    def _r_model(self, nch):
        """A model of ``nch`` chains with the configuration's settings, to
        run the program's R moves again on the kept chains."""
        import functionalmf_tpu_torch as fmf
        n, m, T, _ = self.shape
        model = fmf.NegativeBinomialBayesianTensorFiltering(
            n, m, T, device=self.dev, seed=0, nchains=nch, **self.kw)
        return model, model.prepare_data(self.Y)

    def _r_path(self, r, rmodel):
        """The program's R before each move and after the last: (M + 1,
        chains) + R's shape, each the R of a run of its moves whose later
        uniforms are infinite (they reject). The run of no move gives
        exp(log R), which may differ from R in its last bit."""
        model, pdata = rmodel
        state = dict(W=r["W"], V=r["V"], R=r["R"])
        path = []
        for i in range(r["z"].shape[0] + 1):
            u = r["u"].clone()
            u[i:] = math.inf
            path.append(model._update_R(state, pdata, None,
                                        noise=(r["z"], u))["R"])
        return torch.stack(path)

    def check(self, rec, results, control=None):
        """The numbers compared, each with its limit; with ``control`` (a
        name in ``checks.LOWP``) the control's: the reference computed
        from the step's inputs so rounded, in float32, in the program's
        place."""
        lowp = None if control is None else checks.LOWP[control]
        lim = dict(self.limits)
        lim.setdefault("wrong_steps", 0)
        lim.setdefault("r_wrong_moves", 0)
        num = Numbers(lim)
        by_sweep = {}
        for c in rec.captures:
            by_sweep.setdefault(c["sweep"], []).append(c)
        rmodel = None
        for s in sorted(rec.captured):
            recs = by_sweep.get(s, [])
            steps = [c for c in recs if c["kind"] in STEPS]
            state = {c["kind"]: c for c in recs
                     if c["kind"] in ("before", "after")}
            if ([c["kind"] for c in steps] != list(STEPS)
                    or len(state) != 2):
                num.count("wrong_steps", 1)
                continue
            if rmodel is None:
                rmodel = self._r_model(len(rec.captured[s]))
            self._judge_sweep(dict(zip(STEPS, steps)), state, rmodel, num,
                              lowp)
        if not rec.captured:
            num.count("wrong_steps", 1)
        return num.out()

    def _judge_sweep(self, st, state, rmodel, num, lowp):
        n, m, T, k = self.shape
        dev = st["r_moves"]["R"].device
        f64 = dict(dtype=torch.float64, device=dev)
        before, after = state["before"], state["after"]
        Y = torch.as_tensor(self.Y, **f64)
        Y4 = Y[..., None]
        obs = ~torch.isnan(Y)
        Y32 = torch.where(obs, Y, 0.0).float()
        wmask = torch.as_tensor(judge.tril_mask(n, k), **f64)

        # the R moves: from the sweep's start state
        r = st["r_moves"]
        M = r["z"].shape[0]
        bad = not (torch.equal(r["W"], before["W"])
                   and torch.equal(r["V"], before["V"]))
        path = self._r_path(r, rmodel)
        bad |= not torch.equal(path[-1], r["R_out"]) or len(r["al"]) != M
        num.count("wrong_steps", bad)
        rkw = dict(rpropstdev=self.kw["rpropstdev"], rstdev=self.kw["rstdev"],
                   clip=ACCEPT_CLIP, r_min=R_MIN)
        for j in range(path.shape[1] if len(r["al"]) == M else 0):
            l1p = ref.log1m_sigmoid(r["W"][j], r["V"][j])
            args = (Y4, path[:, j], r["z"][:, j], r["u"][:, j])
            al = torch.stack([a[j] for a in r["al"]])
            want = ref.r_moves(*args, l1p, al_prog=al, **rkw)
            if lowp is None:
                moved = path[1:, j] != path[:-1, j]
                wrong = ((moved != want["accept"]) & ~want["tie"]) \
                    | ~want["ok"]
            else:
                # the control's decisions from its own sums, against the
                # reference's from the reference's
                want = ref.r_moves(*args, l1p, **rkw)
                al = ref.r_moves(*args, ref.log1m_sigmoid(
                    r["W"][j], r["V"][j], lowp), lowp=lowp, **rkw)
                wrong = (al["accept"] != want["accept"]) & ~want["tie"]
                al = al["al"]
            num.count("r_wrong_moves", int(wrong.sum()), wrong.numel())
            num.most("r_gap", (al.to(torch.float64) - want["al"]).abs()
                     / want["mag"].clamp_min(1e-300))

        # the Polya-Gamma draw: b from the R the moves left, psi = W V^T
        pg = st["pg"]
        omega_ch = self._judge_pg(pg, r, Y32, obs, num, lowp)

        # the W rows and the V columns of the kept chains
        w, v = st["w"], st["v"]
        Delta = torch.as_tensor(tf_penalty(T, self.kw["tf_order"]), **f64)
        for j, omega in enumerate(omega_ch):
            _, kappa = ref.nb_counts(Y4, r["R_out"][j])
            z = w["z"]
            if z is None:
                num.count("wrong_steps", 1)
                continue
            Wr, Q, Qmag, scale = ref.w_draw(
                omega, kappa, before["V"][j], after["sigma2"][j], wmask,
                z[j])
            num.most("w_gap", ref.rel_gap(w["Q"][j], Q, Qmag, (-2, -1)))
            Wp = w["out"][j] * wmask.float()
            if lowp is None:
                num.count("wrong_steps",
                          not torch.equal(after["W"][j], Wp))
            else:
                Wp, Qp, _, _ = ref.w_draw(
                    omega, kappa, before["V"][j], after["sigma2"][j],
                    wmask, z[j], lowp)
                num.most("w_gap", ref.rel_gap(Qp, Q, Qmag, (-2, -1)))
            num.most("w_gap", ref.rel_gap(Wp, Wr, scale, (-1,)))
            self._judge_v(v, j, omega, kappa, after, Delta, num, lowp)

    def _judge_pg(self, pg, r, Y32, obs, num, lowp):
        """pg_gap over the kept cells; the kept chains' b and psi against
        the state the moves left. Returns the kept chains' omega (each
        (n, m, T), the program's)."""
        n, m, T, _ = self.shape
        per = n * m * T
        idx = pg["idx"]
        nterms = int(self.kw["pg_num_terms"])
        usable = (pg["noise"] is not None and not pg["g_given"]
                  and pg["kw"].get("use_mt", True)
                  and pg["num_terms"] == nterms
                  and pg["noise"][0].shape[1] == nterms
                  and pg["kw"].get("normal_approx_above",
                                   PG_NORMAL_ABOVE) == PG_NORMAL_ABOVE
                  and pg["z"] is not None)
        if not usable:
            num.most("pg_gap", torch.tensor([math.inf]))
        else:
            x, u, ub = pg["noise"]
            for s in range(0, idx.numel(), PG_BLOCK):
                sl = slice(s, s + PG_BLOCK)
                args = (pg["b"][sl], pg["c"][sl], x[..., sl], u[..., sl],
                        ub[..., sl], pg["z"][sl])
                om, scale, amb = ref.pg_draw(*args, num_terms=nterms,
                                             normal_above=PG_NORMAL_ABOVE)
                got = pg["omega"][sl] if lowp is None else ref.pg_draw(
                    *args, num_terms=nterms, normal_above=PG_NORMAL_ABOVE,
                    lowp=lowp)[0]
                gap = (got.to(torch.float64) - om).abs() / scale.clamp_min(
                    1e-300)
                num.most("pg_gap", gap[~amb])
        # every cell of the kept chains, in order, with their b and psi
        out = []
        for j, chain in enumerate(pg["chains"]):
            want = chain * per + torch.arange(per, device=idx.device)
            pos = torch.searchsorted(idx, want).clamp(max=idx.numel() - 1)
            if not torch.equal(idx[pos], want):
                num.count("wrong_steps", 1)
                continue
            b = pg["b"][pos].reshape(n, m, T)
            c = pg["c"][pos].reshape(n, m, T).double()
            want_b = torch.where(obs, Y32 + r["R_out"][j].reshape(()),
                                 torch.zeros_like(Y32))
            W, V = r["W"][j].double(), r["V"][j].double()
            mu = torch.einsum("ik,jtk->ijt", W, V)
            mag = torch.einsum("ik,jtk->ijt", W.abs(), V.abs())
            bad = not torch.equal(b, want_b)
            bad |= bool(((c - mu).abs() > 8.0 * ref.EPS32 * mag).any())
            num.count("wrong_steps", bad)
            out.append(pg["omega"][pos].reshape(n, m, T))
        return out

    def _judge_v(self, v, j, omega, kappa, after, Delta, num, lowp):
        n, m, T, k = self.shape
        if v["z"] is not None:
            z = v["z"][j]
        elif v["z_tiled"] is not None:
            # the retiled layout (ops/banded.py): super-block rows of B
            # time steps of k, padded at the end
            z = v["z_tiled"][j].reshape(m, -1, k)[:, :T]
        else:
            num.count("wrong_steps", 1)
            return
        if lowp is None:
            num.count("wrong_steps", not torch.equal(after["V"][j],
                                                     v["out"][j]))
        for s in range(0, m, V_BLOCK):
            cols = slice(s, s + V_BLOCK)
            args = (omega[:, cols], kappa[:, cols], after["W"][j],
                    after["lam2"][j], after["Tau2"][j][cols], Delta,
                    z[cols], judge.STABILITY)
            Vr, Q, Qmag, scale = ref.v_draw(*args)
            if lowp is None:
                Qp = ref.bands_dense(v["bands"][j][cols].double())
                Vp = v["out"][j][cols]
            else:
                Vp, Qp, _, _ = ref.v_draw(*args, lowp=lowp)
            num.most("v_gap", ref.rel_gap(Qp, Q, Qmag, (-2, -1)))
            num.most("v_gap", ref.rel_gap(Vp, Vr, scale, (-2, -1)))
