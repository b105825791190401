"""Base Bayesian Tensor Filtering model: a dict of tensors and the Gibbs
driver.

Counterpart of functionalmf_tpu/models/base.py. The state is a dict of
tensors on the model's device, each with a leading chain axis, and one
sweep updates every chain at once (the JAX package vmaps a per-chain
sweep). Randomness comes from one generator re-seeded at every sweep from
(seed, absolute sweep index) (``_runtime.SweepRNG``), so the draws of a
run do not depend on how it is cut into chunks.

Kept from the JAX package: the constructor kwargs (``X_init`` starts a
variable, ``X_true`` fixes it), the prior updates of sigma2, Tau2 and
lam2, the non-finite guard, ``run_gibbs(data, nburn, nthin, nsamples,
verbose)`` and its results dict (scalars as (S, 1), chains concatenated
chain-major, ``nan_fallbacks``, ``pivot_repairs`` and, with several
chains, ``rhat``). The families add their own state (``nu2``, ``R``)
after this constructor, each from its own init generator
(``_next_init_gen``) taken in a fixed order. Not ported: host callbacks, traced
callbacks, checkpoint/resume, profiling, ``data_dtype``, the device mesh
and DIC.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from functionalmf_tpu_torch._runtime import (SweepRNG, require_full_f32,
                                             resolve_device)
from functionalmf_tpu_torch.ops.mvn import cholesky_psd
from functionalmf_tpu_torch.ops.penalty import bayes_grid_penalty
from functionalmf_tpu_torch.samplers.conjugate import (
    ConjugateInverseGammaPrior, standard_gamma)
from functionalmf_tpu_torch.samplers.horseshoe import (
    resample_lam2, resample_tau2_ladder, sample_horseshoe,
    sample_horseshoe_plus)

__all__ = ["BayesianTensorFiltering", "tril_mask", "packed_w_len"]

_LATER = "not ported yet (ROADMAP.md, Queue 1)"


def tril_mask(nrows: int, nembeds: int):
    """mask[i, a] = 1 iff embedding a is active for row i (a <= i)."""
    i = np.arange(nrows)[:, None]
    a = np.arange(nembeds)[None, :]
    return (a <= i).astype(np.float32)


def packed_w_len(nrows: int, nembeds: int) -> int:
    if nrows >= nembeds:
        return ((nembeds * nembeds - nembeds) // 2 + nembeds
                + (nrows - nembeds) * nembeds)
    return (nrows * nrows - nrows) // 2 + nrows


class BayesianTensorFiltering:
    """Abstract base; subclasses implement ``prepare_data``,
    ``_make_sweep`` and ``logprob``."""

    _collect_keys = ("W", "V", "sigma2", "lam2", "Tau2")

    # draws collected on the device between copies to the host
    max_sweeps_per_call = 1024

    def __init__(self, nrows, ncols, ndepth, *, device="cuda",
                 nembeds=5, tf_order=2,
                 sigma2_init=None, sigma2_true=None,
                 sigma2_a=0.1, sigma2_b=0.1,
                 lam2_init=None, lam2_true=None,
                 Tau2_init=None, Tau2_true=None,
                 W_init=None, V_init=None,
                 W_true=None, V_true=None,
                 stability=1e-6,
                 force_psd=True,
                 force_psd_eps=1e-6,
                 force_psd_attempts=4,
                 dtype=torch.float32,
                 data_dtype=None,
                 seed=0,
                 nchains=1,
                 mesh=None,
                 nthreads=None,  # accepted for API parity
                 **kwargs):
        if dtype != torch.float32:
            raise ValueError("the port computes in float32 only")
        if data_dtype is not None:
            raise NotImplementedError(f"data_dtype is {_LATER}")
        if mesh is not None:
            raise NotImplementedError(f"mesh sharding is {_LATER}")
        self.device = resolve_device(device)
        require_full_f32()
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.ndepth = int(ndepth)
        self.nembeds = int(nembeds)
        self.tf_order = int(tf_order)
        self.stability = float(stability)
        self.dtype = torch.float32
        self.nchains = int(nchains)
        self.linalg_opts = dict(force_psd=force_psd,
                                force_psd_eps=force_psd_eps,
                                force_psd_attempts=force_psd_attempts)

        self.Delta_np = bayes_grid_penalty(ndepth, tf_order)
        self.Delta = self._t(self.Delta_np)                    # (nD, T)
        self.nD = self.Delta_np.shape[0]

        self.sigma2_a = sigma2_a
        self.sigma2_b = sigma2_b
        self.sigma2_model = ConjugateInverseGammaPrior(1, sigma2_a, sigma2_b)

        self.seed = int(seed)
        self._rng = SweepRNG(seed, self.device)
        self._init_counter = 0
        self._wmask_np = tril_mask(self.nrows, self.nembeds)
        self._wmask = self._t(self._wmask_np)
        self._w_len = packed_w_len(self.nrows, self.nembeds)

        state = {}
        gen = self._next_init_gen()
        n, m, k = self.nrows, self.ncols, self.nembeds

        # init draws, in a fixed order; the sigma2, lam2 and Tau2 draws are
        # taken even where a kwarg starts or fixes the variable
        s2_draw = self._init_sigma2_val(gen)
        lam2, lam2_a = self._init_lam2_val(gen)
        t2, t2c, t2b, t2a = self._init_tau2_val(gen)

        self.sample_sigma2 = sigma2_true is None
        given = sigma2_true if sigma2_true is not None else sigma2_init
        state["sigma2"] = (self._chain_full((), given) if given is not None
                           else s2_draw)

        self.sample_lam2 = lam2_true is None
        given = lam2_true if lam2_true is not None else lam2_init
        state["lam2"] = (self._chain_full((), given) if given is not None
                         else lam2)
        state["lam2_a"] = lam2_a

        self.sample_Tau2 = Tau2_true is None
        given = Tau2_true if Tau2_true is not None else Tau2_init
        state["Tau2"] = (self._chain_broadcast(given, (m, self.nD))
                         if given is not None else t2)
        state["Tau2_c"], state["Tau2_b"], state["Tau2_a"] = t2c, t2b, t2a

        self.sample_W = W_true is None
        given = W_true if W_true is not None else W_init
        state["W"] = (self._chain_broadcast(given, (n, k)) if given is not None
                      else self._init_W_val(gen, state["sigma2"]))

        self.sample_V = V_true is None
        given = V_true if V_true is not None else V_init
        state["V"] = (self._chain_broadcast(given, (m, self.ndepth, k))
                      if given is not None
                      else self._init_V_val(gen, state["lam2"],
                                            state["Tau2"]))

        state["nan_fallbacks"] = self._chain_full((), 0.0)
        state["pivot_repairs"] = self._chain_full((), 0.0)
        self._state = state

    # ------------------------------------------------------------------
    # tensors and init draws
    # ------------------------------------------------------------------
    def _t(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    def _next_init_gen(self):
        self._init_counter += 1
        return self._rng.at(SweepRNG.INIT, self._init_counter)

    def _chain_full(self, shape, value):
        return torch.full((self.nchains,) + shape, float(value),
                          dtype=self.dtype, device=self.device)

    def _chain_broadcast(self, value, shape):
        v = self._t(value)
        if tuple(v.shape) == (self.nchains,) + shape:
            return v
        if tuple(v.shape) != shape:
            raise ValueError(f"expected {shape} or {(self.nchains,) + shape},"
                             f" got {tuple(v.shape)}")
        return v.expand((self.nchains,) + shape).clone()

    def _init_sigma2_val(self, gen):
        return 1.0 / self.sigma2_model.draw_from_prior(
            gen, (self.nchains,), device=self.device)

    def _init_lam2_val(self, gen):
        lam2, lam2_a = sample_horseshoe(gen, (self.nchains,),
                                        device=self.device)
        return torch.clamp(lam2, 0, 4), lam2_a

    def _init_tau2_val(self, gen):
        d, c, b, a = sample_horseshoe_plus(
            gen, (self.nchains, self.ncols, self.nD), device=self.device)
        return torch.clamp(d, 0, 9), c, b, a

    def _init_W_val(self, gen, sigma2):
        W = torch.randn((self.nchains, self.nrows, self.nembeds),
                        generator=gen, device=self.device)
        W = W * torch.sqrt(sigma2)[:, None, None]
        return W * self._wmask if self.nrows > 1 else W

    def _init_V_val(self, gen, lam2, Tau2):
        x = self._sample_v_prior(gen, lam2, Tau2)        # (nch, m, k*T)
        V = x.reshape(self.nchains, self.ncols, self.nembeds,
                      self.ndepth).transpose(-1, -2)
        return torch.clamp(V, -10, 10).contiguous()

    # ------------------------------------------------------------------
    # state access
    # ------------------------------------------------------------------
    @property
    def state(self):
        return self._state

    def _get_var(self, name):
        v = self._state[name]
        if self.nchains == 1:
            v = v[0]
        return v.cpu().numpy()

    def _set_var(self, name, value):
        shape = tuple(self._state[name].shape[1:])
        self._state[name] = self._chain_broadcast(value, shape)

    W = property(lambda s: s._get_var("W"), lambda s, v: s._set_var("W", v))
    V = property(lambda s: s._get_var("V"), lambda s, v: s._set_var("V", v))
    Tau2 = property(lambda s: s._get_var("Tau2"),
                    lambda s, v: s._set_var("Tau2", v))
    lam2 = property(lambda s: s._get_var("lam2"),
                    lambda s, v: s._set_var("lam2", v))
    sigma2 = property(lambda s: s._get_var("sigma2"),
                      lambda s, v: s._set_var("sigma2", v))

    def load_state(self, np_state):
        """Replace the state with a dict of arrays keyed and shaped as this
        model's state (e.g. the JAX model's state through
        ``interop.state_from_numpy``)."""
        from functionalmf_tpu_torch.interop import state_from_numpy
        new = state_from_numpy(np_state, self.device)
        missing = set(self._state) - set(new)
        if missing:
            raise KeyError(f"state lacks {sorted(missing)}")
        for key, val in new.items():
            if key in self._state and val.shape != self._state[key].shape:
                raise ValueError(f"state[{key!r}] has shape "
                                 f"{tuple(val.shape)}, expected "
                                 f"{tuple(self._state[key].shape)}")
        self._state = {key: new[key] for key in self._state}

    # ------------------------------------------------------------------
    # prior blocks
    # ------------------------------------------------------------------
    def _v_prior_weights(self, lam2, Tau2):
        """1/(lam2 * Tau2_j), clipped: (nch, m, nD)."""
        lo, hi = self.stability, 1.0 / self.stability
        return torch.clamp(1.0 / torch.clamp(lam2[:, None, None] * Tau2,
                                             lo, hi), lo, hi)

    def _v_prior_dtld(self, lam2, Tau2):
        """D^T Lam_j D per chain and column: (nch, m, T, T)."""
        w = self._v_prior_weights(lam2, Tau2)
        return (self.Delta.T * w[..., None, :]) @ self.Delta

    def _sample_v_prior(self, gen, lam2, Tau2):
        """(nch, m, k*T) ~ N(0, kron(I_k, DtLD)^-1), one (T, T) Cholesky per
        column with k right-hand sides, Jacobi-equilibrated; embed-major."""
        nch, m, T, k = self.nchains, self.ncols, self.ndepth, self.nembeds
        DtLD = self._v_prior_dtld(lam2, Tau2)
        d = torch.diagonal(DtLD, dim1=-2, dim2=-1)
        dinv = torch.rsqrt(torch.where(d > 0, d, torch.ones_like(d)))
        Qe = DtLD * dinv[..., :, None] * dinv[..., None, :]
        L = cholesky_psd(Qe, eps=self.linalg_opts["force_psd_eps"],
                         attempts=self.linalg_opts["force_psd_attempts"]
                         if self.linalg_opts["force_psd"] else 0)
        z = torch.randn((nch, m, T, k), generator=gen, device=self.device)
        x = torch.linalg.solve_triangular(L.mT, z, upper=True)
        x = x * dinv[..., None]
        return x.transpose(-1, -2).reshape(nch, m, k * T)

    def _deltas(self, V):
        """Delta V_j per chain and column: (nch, m, nD, k)."""
        return torch.einsum("dt,cjtk->cjdk", self.Delta, V)

    def _update_sigma2(self, state, gen):
        W = state["W"] * self._wmask
        sq = (W * W).sum((-2, -1))
        g = standard_gamma(gen, self.sigma2_a + self._w_len / 2.0,
                           (self.nchains,), device=self.device)
        prec = g / (self.sigma2_b + sq / 2.0)
        return dict(state, sigma2=1.0 / prec)

    def _update_tau2(self, state, gen):
        deltas = self._deltas(state["V"])
        deltas_sq = (deltas * deltas).sum(-1)
        t2, c, b, a = resample_tau2_ladder(
            gen, deltas_sq, state["lam2"][:, None, None], state["Tau2"],
            state["Tau2_c"], state["Tau2_b"], state["Tau2_a"],
            self.nembeds, self.stability)
        return dict(state, Tau2=t2, Tau2_c=c, Tau2_b=b, Tau2_a=a)

    def _update_lam2(self, state, gen):
        deltas = self._deltas(state["V"])
        tau2 = torch.clamp(state["Tau2"], self.stability,
                           1 / self.stability)[..., None]
        s = (deltas * deltas / tau2).sum((1, 2, 3))
        lam2, lam2_a = resample_lam2(gen, s, state["lam2_a"], self.nD,
                                     self.ncols, self.nembeds)
        return dict(state, lam2=lam2, lam2_a=lam2_a)

    @staticmethod
    def _nan_guard(old_state, new_state, names=("W", "V")):
        """Keep the previous draw of a chain whose update came back
        non-finite, and count the event in nan_fallbacks (per chain)."""
        state = dict(new_state)
        fallbacks = state["nan_fallbacks"]
        for key in names:
            new = new_state[key]
            ok = torch.isfinite(new).reshape(new.shape[0], -1).all(-1)
            okb = ok.reshape((-1,) + (1,) * (new.dim() - 1))
            state[key] = torch.where(okb, new, old_state[key])
            fallbacks = fallbacks + (~ok).to(fallbacks.dtype)
        state["nan_fallbacks"] = fallbacks
        return state

    def _prior_sweep(self, state, data, gen, update_W, update_V):
        """Prior updates, then W, then V (factor.py:112-128 order)."""
        if self.sample_sigma2:
            state = self._update_sigma2(state, gen)
        if self.sample_Tau2:
            state = self._update_tau2(state, gen)
        if self.sample_lam2:
            state = self._update_lam2(state, gen)
        if self.sample_W:
            state = self._nan_guard(state, update_W(state, data, gen),
                                    names=("W",))
        if self.sample_V:
            state = self._nan_guard(state, update_V(state, data, gen),
                                    names=("V",))
        return state

    # ------------------------------------------------------------------
    # abstract pieces
    # ------------------------------------------------------------------
    def prepare_data(self, data):
        raise NotImplementedError

    def _make_sweep(self):
        """Return sweep(state, pdata, gen) -> state over all chains."""
        raise NotImplementedError

    def logprob(self, data, **params):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Gibbs driver
    # ------------------------------------------------------------------
    def run_gibbs(self, data, nburn=1000, nthin=1, nsamples=1000,
                  verbose=True, print_freq=100, **kwargs):
        """Blocked Gibbs: ``nburn`` sweeps, then ``nsamples`` draws, one
        after every ``nthin`` sweeps.

        Sweep s of a run draws from the generator seeded by (seed, s), so
        the draws are the same however the run is cut: collected draws
        stay on the device and go to the host every
        ``max_sweeps_per_call`` sweeps. Unlike the JAX driver, burn-in is
        not rounded up to whole chunks. Returns numpy arrays with a
        leading sample axis; with nchains > 1 the chains are concatenated
        chain-major.
        """
        unsupported = sorted(set(kwargs) & {
            "callback", "traced_callback", "collect_data_keys",
            "checkpoint_path", "resume", "profile_dir", "key"})
        if unsupported:
            raise NotImplementedError(f"run_gibbs({', '.join(unsupported)})"
                                      f" is {_LATER}")
        if kwargs:
            raise TypeError(f"unexpected run_gibbs kwargs {sorted(kwargs)}")
        nburn, nthin, nsamples = int(nburn), int(nthin), int(nsamples)
        if nthin < 1 or nsamples < 1 or nburn < 0:
            raise ValueError("need nburn >= 0, nthin >= 1, nsamples >= 1")
        pdata = self.prepare_data(data)
        sweep = self._make_sweep()
        state = self._state
        M = max(1, int(self.max_sweeps_per_call))

        step = 0
        since_copy = 0
        pending, chunks = [], []

        def flush():
            nonlocal since_copy
            if pending:
                chunks.append({key: torch.stack([p[key] for p in pending],
                                                0).cpu().numpy()
                               for key in self._collect_keys})
                pending.clear()
            since_copy = 0

        def one_sweep(st):
            nonlocal step, since_copy
            st = sweep(st, pdata, self._rng.at(SweepRNG.SWEEP, step))
            step += 1
            since_copy += 1
            if verbose and step % print_freq == 0:
                print("\tStep {}".format(step))
            return st

        for _ in range(nburn):
            state = one_sweep(state)
        for _ in range(nsamples):
            for _ in range(nthin):
                state = one_sweep(state)
                if since_copy >= M:
                    flush()
            pending.append({key: state[key].clone()
                            for key in self._collect_keys})
        flush()
        self._state = state
        outs = {key: np.concatenate([c[key] for c in chunks])
                for key in self._collect_keys}
        results = self._format_results(outs, nsamples)
        self._report_run_health(results, verbose)
        return results

    def _format_results(self, outs, nsamples):
        """(nsamples, nchains, ...) -> chain-major (nchains*nsamples, ...);
        scalars as (S, 1)."""
        results = {}
        for key, v in outs.items():
            v = np.swapaxes(v, 0, 1).reshape(
                (self.nchains * nsamples,) + v.shape[2:])
            if v.ndim == 1:
                v = v[:, None]
            results[key] = v
        return results

    def _report_run_health(self, results, verbose):
        fb = self._state["nan_fallbacks"].cpu().numpy()
        pr = self._state["pivot_repairs"].cpu().numpy()
        results["nan_fallbacks"] = fb.reshape(self.nchains)
        results["pivot_repairs"] = pr.reshape(self.nchains)
        if float(fb.sum()) > 0 and verbose is not False:
            print(f"\tWARNING: {int(fb.sum())} numerical-failsafe event(s) "
                  f"across {self.nchains} chain(s) (nan_fallbacks="
                  f"{fb.reshape(-1).tolist()}, pivot_repairs="
                  f"{pr.reshape(-1).tolist()}); affected draws kept previous "
                  "values — inspect convergence diagnostics.",
                  file=sys.stderr)
        if self.nchains > 1:
            results["rhat"] = rhat = self._compute_rhat(results)
            if verbose is not False and rhat.get("max", 1.0) > 1.1:
                worst = max((v, k) for k, v in rhat.items() if k != "max")
                print(f"\tWARNING: split-R-hat {worst[0]:.3f} on "
                      f"'{worst[1]}' exceeds 1.1 — the chains have not "
                      "converged to a common distribution; increase nburn "
                      "or inspect per-chain traces.", file=sys.stderr)

    def _compute_rhat(self, results, max_params: int = 4096):
        """Max split-R-hat per collected variable across chains, plus the
        overall 'max' (functionalmf_tpu/models/base.py:887-910)."""
        from functionalmf_tpu_torch.utils.diagnostics import split_rhat
        rng = np.random.default_rng(0)
        out = {}
        for key in self._collect_keys:
            if key not in results:
                continue
            v = np.asarray(results[key])
            if v.shape[0] % self.nchains:
                continue
            v = v.reshape(self.nchains, v.shape[0] // self.nchains, -1)
            if v.shape[1] < 4:
                continue
            cols = v.shape[-1]
            idx = (range(cols) if cols <= max_params
                   else rng.choice(cols, size=max_params, replace=False))
            out[key] = float(max(split_rhat(v[:, :, j]) for j in idx))
        if out:
            out["max"] = float(max(out.values()))
        return out
