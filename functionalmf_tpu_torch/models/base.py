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
(``_next_init_gen``) taken in a fixed order. ``run_gibbs`` also takes
the JAX driver's options: the per-sweep hooks (``callback`` on the host,
``traced_callback`` on the device, with ``collect_data_keys``),
``checkpoint_path`` / ``resume``, ``profile_dir`` and ``key``; the
constructor takes ``data_dtype``; ``select_hyperparams_DIC`` is the DIC
grid search. Not ported: the device mesh.
"""
from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from functionalmf_tpu_torch._runtime import (SweepRNG, require_full_f32,
                                             resolve_device, tree_leaves,
                                             tree_map)
from functionalmf_tpu_torch.ops.mvn import cholesky_psd
from functionalmf_tpu_torch.ops.penalty import bayes_grid_penalty
from functionalmf_tpu_torch.samplers.conjugate import (
    ConjugateInverseGammaPrior, standard_gamma)
from functionalmf_tpu_torch.samplers.horseshoe import (
    resample_lam2, resample_tau2_ladder, sample_horseshoe,
    sample_horseshoe_plus)

__all__ = ["BayesianTensorFiltering", "tril_mask", "packed_w_len"]

_LATER = "not ported yet (ROADMAP.md, Queue 1)"
# sweeps at most under the profiler of ``run_gibbs(profile_dir=)``: every
# launch adds an event to its buffer
_PROFILE_MAX_SWEEPS = 16


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
        if data_dtype not in (None, torch.float32, torch.float16,
                              torch.bfloat16):
            raise ValueError("data_dtype must be None or a torch floating "
                             f"dtype of 16 or 32 bits, got {data_dtype!r}")
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
        # storage dtype of the prepared data (torch.float16 halves what the
        # likelihood passes read; counts up to 2048 stay exact); arithmetic
        # is float32
        self.data_dtype = data_dtype
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

    # re-initialisation after a warm start is assigned (the Poisson
    # example's setup_sampler), each from the next init generator
    def _init_sigma2(self):
        self._state["sigma2"] = self._init_sigma2_val(self._next_init_gen())

    def _init_lam2(self):
        lam2, lam2_a = self._init_lam2_val(self._next_init_gen())
        self._state["lam2"], self._state["lam2_a"] = lam2, lam2_a

    def _init_Tau2(self):
        t2, c, b, a = self._init_tau2_val(self._next_init_gen())
        self._state["Tau2"], self._state["Tau2_c"] = t2, c
        self._state["Tau2_b"], self._state["Tau2_a"] = b, a

    def _init_W(self):
        self._state["W"] = self._init_W_val(self._next_init_gen(),
                                            self._state["sigma2"])

    def _init_V(self):
        self._state["V"] = self._init_V_val(
            self._next_init_gen(), self._state["lam2"], self._state["Tau2"])

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
    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------
    def _save_checkpoint(self, path, state, offset, collected, chunks,
                         pdata=None):
        """Write each collected chunk to its own write-once file, then the
        chain head (state, sweeps done, draws collected) atomically
        (functionalmf_tpu/models/base.py:424-454). With ``pdata`` (runs
        with a traced hook, which mutates the prepared data the
        likelihood reads) its leaves are saved too. No generator state is
        saved: a sweep's generator is a function of (seed, sweep)."""
        for ci, chunk in enumerate(chunks):
            cpath = f"{path}.chunk{ci}.npz"
            if not os.path.exists(cpath):
                tmp = cpath + ".tmp.npz"
                np.savez(tmp, **chunk)
                os.replace(tmp, cpath)
        payload = {"__offset": offset, "__collected": collected,
                   "__nchunks_out": len(chunks)}
        for key, v in state.items():
            payload["state__" + key] = v.cpu().numpy()
        if pdata is not None:
            leaves = tree_leaves(pdata)
            payload["__npdata_leaves"] = len(leaves)
            for i, leaf in enumerate(leaves):
                # float32 holds every storage dtype exactly (numpy has no
                # bfloat16); the leaf's own dtype is restored on load
                payload[f"pdata__{i}"] = leaf.float().cpu().numpy()
        tmp = path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)

    def _load_checkpoint(self, path, pdata_template=None):
        """(state, offset, collected, chunks, pdata); pdata is None unless
        the checkpoint holds data leaves and ``pdata_template`` (freshly
        prepared data, for the structure) is given."""
        with np.load(path) as z:
            offset = int(z["__offset"])
            collected = int(z["__collected"])
            nchunks = int(z["__nchunks_out"])
            state = {key[len("state__"):]: torch.as_tensor(
                z[key], device=self.device)
                for key in z.files if key.startswith("state__")}
            pdata = None
            if pdata_template is not None and "__npdata_leaves" in z.files:
                n = int(z["__npdata_leaves"])
                have = len(tree_leaves(pdata_template))
                if have != n:
                    raise ValueError(
                        f"checkpoint pdata has {n} leaves but "
                        f"prepare_data(data) yields {have}; the data passed "
                        "to the resumed run must have the same structure")
                leaves = iter([z[f"pdata__{i}"] for i in range(n)])
                pdata = tree_map(lambda t: torch.as_tensor(
                    next(leaves), device=t.device).to(t.dtype),
                    pdata_template)
        chunks = []
        for ci in range(nchunks):
            with np.load(f"{path}.chunk{ci}.npz") as cz:
                chunks.append({key: cz[key] for key in cz.files})
        return state, offset, collected, chunks, pdata

    def mark_data_dirty(self):
        """Tell ``run_gibbs``, from a host ``callback``, that the ``data``
        object changed: it is prepared again before the next sweep."""
        self._data_dirty = True

    def run_gibbs(self, data, nburn=1000, nthin=1, nsamples=1000,
                  verbose=True, print_freq=100, callback=None, key=None,
                  traced_callback=None, collect_data_keys=(),
                  checkpoint_path=None, resume=False, profile_dir=None,
                  **kwargs):
        """Blocked Gibbs: ``nburn`` sweeps, then ``nsamples`` draws, one
        after every ``nthin`` sweeps.

        Sweep s of a run draws from the generator seeded by (seed, s), so
        the draws are the same however the run is cut: collected draws
        stay on the device and go to the host every
        ``max_sweeps_per_call`` sweeps. Unlike the JAX driver, burn-in is
        not rounded up to whole chunks. Returns numpy arrays with a
        leading sample axis; with nchains > 1 the chains are concatenated
        chain-major.

        Options (functionalmf_tpu/models/base.py:675-855):

        * ``callback(model, data, step, **kwargs)``: host code after every
          sweep. It reads and sets the model's variables through its
          properties (``model.W``, ``model.Row_constraints = ...``); after
          ``model.mark_data_dirty()`` the data is prepared again.
        * ``traced_callback(state, pdata, gen, step) -> (state, pdata)``:
          the device-side hook. It gets the chain-batched state dict, the
          prepared data and a generator seeded by (seed, sweep) at a site
          of its own, and must not wait for the device (no ``.item()``,
          no ``.cpu()``). There is no compiled loop here, so the two
          flavours differ only in this contract. Passing both raises.
        * ``collect_data_keys``: entries of the prepared data (a dict) to
          record at every collected draw; returned without a chain axis.
          A name the prepared data does not hold is looked up in the
          state (``"Row_constraints"``, which a hook rewrites) and comes
          back chain-major like the model's variables.
          Unlike the JAX driver's host mode, both flavours collect at the
          same sweeps: after sweep nburn + nthin, nburn + 2 nthin, ...
        * ``checkpoint_path`` / ``resume``: the chain head and every
          collected chunk are written whenever the draws go to the host
          (and at the end); with ``resume=True`` a run of the same request
          continues from the file and returns the draws of the
          uninterrupted run, bit for bit on one device type. Not with a
          host ``callback``, whose data lives outside ``run_gibbs``.
        * ``profile_dir``: the first 16 sweeps (at most one chunk) run
          under ``torch.profiler`` and the trace goes
          to ``<profile_dir>/trace.json``. The profiler slows every later
          launch of the process on the host: do not time a run after it.
        * ``key``: an integer in place of the model's seed for this run's
          sweeps and hook.
        """
        if callback is not None and traced_callback is not None:
            raise ValueError("pass either callback (host) or traced_callback "
                             "(device), not both")
        if kwargs and callback is None:
            raise TypeError(f"unexpected run_gibbs kwargs {sorted(kwargs)}")
        if checkpoint_path and callback is not None:
            raise ValueError("checkpoint_path is not supported with a host "
                             "callback: its data lives outside run_gibbs")
        nburn, nthin, nsamples = int(nburn), int(nthin), int(nsamples)
        if nthin < 1 or nsamples < 1 or nburn < 0:
            raise ValueError("need nburn >= 0, nthin >= 1, nsamples >= 1")
        collect_data_keys = tuple(collect_data_keys)
        rng = self._rng if key is None else SweepRNG(key, self.device)
        pdata = self.prepare_data(data)
        sweep = self._make_sweep()
        state = self._state
        M = max(1, int(self.max_sweeps_per_call))
        total = nburn + nthin * nsamples
        has_tc = traced_callback is not None

        step = collected = 0
        pending, chunks = [], []
        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            state, step, collected, chunks, pd_ck = self._load_checkpoint(
                checkpoint_path, pdata_template=pdata if has_tc else None)
            if pd_ck is not None:
                pdata = pd_ck
            if verbose:
                print("\tResumed at step {} ({} samples)".format(
                    step, collected))

        def snapshot():
            out = {k: state[k].clone() for k in self._collect_keys}
            for k in collect_data_keys:
                if isinstance(pdata, dict) and k in pdata:
                    out["data:" + k] = pdata[k].clone()
                else:
                    out[k] = state[k].clone()
            return out

        def flush():
            if pending:
                chunks.append({k: torch.stack([p[k] for p in pending],
                                              0).float().cpu().numpy()
                               for k in pending[0]})
                pending.clear()
            if checkpoint_path:
                self._save_checkpoint(checkpoint_path, state, step,
                                      collected, chunks,
                                      pdata=pdata if has_tc else None)

        self._data_dirty = False
        while step < total:
            stop = min(total, step + M)
            with contextlib.ExitStack() as stack:
                if profile_dir:
                    stop = min(stop, step + _PROFILE_MAX_SWEEPS)
                    stack.enter_context(self._profiled(profile_dir))
                    profile_dir = None
                while step < stop:
                    state = sweep(state, pdata, rng.at(SweepRNG.SWEEP, step))
                    if has_tc:
                        state, pdata = traced_callback(
                            state, pdata, rng.at(SweepRNG.HOOK, step), step)
                    elif callback is not None:
                        self._state = state
                        callback(self, data, step, **kwargs)
                        state = self._state
                        if self._data_dirty:
                            pdata = self.prepare_data(data)
                            self._data_dirty = False
                    step += 1
                    if verbose and step % print_freq == 0:
                        print("\tStep {}".format(step))
                    if step > nburn and (step - nburn) % nthin == 0:
                        pending.append(snapshot())
                        collected += 1
            flush()
        self._state = state
        outs = {k: np.concatenate([c[k] for c in chunks])[:nsamples]
                for k in chunks[0]}
        # collected data entries have no chain axis
        data_outs = {k[len("data:"):]: outs.pop(k)
                     for k in list(outs) if k.startswith("data:")}
        results = self._format_results(outs, nsamples)
        results.update(data_outs)
        self._report_run_health(results, verbose)
        return results

    @contextlib.contextmanager
    def _profiled(self, profile_dir):
        """torch.profiler around the block; the trace goes to
        ``<profile_dir>/trace.json``."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

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

    # ------------------------------------------------------------------
    # DIC hyperparameter selection (genlasso.py:69-136)
    # ------------------------------------------------------------------
    def _default_hyperparam_options(self, hyperparams, lam2=None,
                                    min_lam2=1e-6, max_lam2=1e3, num_lam2=10,
                                    **kwargs):
        if lam2 is None:
            hyperparams["lam2"] = np.exp(np.linspace(
                np.log(min_lam2), np.log(max_lam2), num_lam2))[::-1]
        else:
            hyperparams["lam2"] = lam2

    def _set_hyperparameters(self, hyperparams):
        self._state["lam2"] = self._chain_full((), hyperparams["lam2"])

    def select_hyperparams_DIC(self, data, verbose=True, **kwargs):
        """DIC grid search (functionalmf_tpu/models/base.py:941-977): one
        run_gibbs per grid point, scored 2 mean(D) - D(mean) with
        D = -2 logprob; the model keeps the winning hyperparameters.
        Returns ``{"scores", "options", "best", "fit"}``."""
        hyperparam_options = {}
        run_kwarg_names = ("nburn", "nthin", "nsamples", "print_freq",
                           "callback")
        run_kwargs = {k: kwargs.pop(k) for k in run_kwarg_names
                      if k in kwargs}
        self._default_hyperparam_options(hyperparam_options, **kwargs)

        param_names = list(hyperparam_options.keys())
        param_options = [hyperparam_options[n] for n in param_names]
        all_indices = list(np.ndindex(*[len(p) for p in param_options]))
        dic_scores = np.zeros(len(all_indices))
        best_results, best_score, best_idx = None, None, None

        for score_idx, indices in enumerate(all_indices):
            cur = {param_names[p]: param_options[p][i]
                   for p, i in enumerate(indices)}
            if verbose:
                print(" ".join(f"{k}={v}" for k, v in cur.items()))
            self._set_hyperparameters(cur)
            results = self.run_gibbs(data, verbose=False, **run_kwargs)
            # posterior draws only (the results also carry the run's
            # health counters, which have no sample axis)
            draws = {k: results[k] for k in self._collect_keys
                     if k in results}
            nsamples = next(iter(draws.values())).shape[0]
            mean_results = {k: v.mean(axis=0) for k, v in draws.items()}
            D_mean = -2 * self.logprob(data, **mean_results)
            mean_D = -2 * np.mean([
                self.logprob(data, **{k: v[i] for k, v in draws.items()})
                for i in range(nsamples)])
            dic_scores[score_idx] = 2 * mean_D - D_mean
            if best_score is None or dic_scores[score_idx] < best_score:
                best_results, best_score, best_idx = (
                    results, dic_scores[score_idx], score_idx)

        best = {param_names[p]: param_options[p][i]
                for p, i in enumerate(all_indices[best_idx])}
        self._set_hyperparameters(best)
        return {"scores": dic_scores, "options": hyperparam_options,
                "best": best, "fit": best_results}
