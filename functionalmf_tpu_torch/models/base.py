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
grid search.

Under a device mesh (``mesh=``, ``parallel/mesh.py``) each rank holds its
slices of the state (``state_partition_specs``: chains over dp, W rows
and V / Tau2 columns over mp, an axis dropped where it does not divide);
``state``, ``W`` and the other properties gather the global values, and
``load_state`` and the setters take global values and keep this rank's
slice. Every draw is taken at its global shape, in the order of the
unsharded run, and each rank keeps its part (``_Part.take``), so a
sharded run computes what the unsharded run computes. A sum over rows
or columns all-gathers every rank's per-row (per-column) partial sums
and adds them as the unsharded run does (``_Part.rows_sum``,
``cols_sum``), so that a sharded run can have its bits. The
collectives of the prior sweep: the sum of W^2 over rows (sigma2) and of
the V prior terms over columns (lam2), each an all-gather over mp; the
non-finite guard's per-chain verdict, all-reduce MIN over mp.
``run_gibbs`` all-gathers the collected draws once a chunk and returns,
on every rank, the dict of the unsharded run; its options work under a
mesh (its docstring). Under a mesh every rank calls the model's methods
together (they gather).
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
from functionalmf_tpu_torch.parallel.mesh import (
    DP_AXIS, MP_AXIS, feasible_spec, gather_state, shard_state)
from functionalmf_tpu_torch.samplers.conjugate import (
    ConjugateInverseGammaPrior, standard_gamma)
from functionalmf_tpu_torch.samplers.horseshoe import (
    _exponential, lam2_shape, resample_lam2, resample_tau2_ladder,
    sample_horseshoe, sample_horseshoe_plus)
from functionalmf_tpu_torch.utils import telemetry

__all__ = ["BayesianTensorFiltering", "tril_mask", "packed_w_len"]

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


def _fixed_sum(x, dims):
    """x summed over ``dims`` (kept, of size 1) in an order fixed by their
    sizes alone: halves added pairwise, each step an elementwise add. A
    reduction kernel on the card orders its sums by the number of outputs
    too, and a rank of a mesh holds a part of the outputs."""
    keep = [d for d in range(x.dim()) if d not in dims]
    y = x.permute(keep + list(dims)).reshape(
        [x.shape[d] for d in keep] + [-1])
    while y.shape[-1] > 1:
        h = y.shape[-1] // 2
        z = y[..., :h] + y[..., h:2 * h]
        y = torch.cat([z, y[..., 2 * h:]], -1) if y.shape[-1] % 2 else z
    return y.reshape([1 if d in dims else n for d, n in enumerate(x.shape)])


def _window_sum(x, dims):
    """x summed over ``dims`` (kept, of size 1) in an order fixed by their
    sizes alone, in a launch an axis (and a copy where the axis is not the
    last) where ``_fixed_sum`` takes about two a halving: the axes in turn,
    the last first, each output's values summed in index order by one
    thread (``avg_pool2d`` over the whole axis, divisor 1), whatever the
    number of outputs. For a sum called often (the scale moves' full-tensor
    log-likelihood over rows and time, 34 calls a sweep; NegBinom's R
    moves, 30).

    The order is how PyTorch's CUDA ``avg_pool2d`` kernel sums a window
    (checked with torch 2.11, CUDA 12.8), not a documented contract: a
    torch build that sums a window otherwise changes it, and the sum probe
    of ``chip_smoke.py`` (phase (c)) is what would show that."""
    for d in sorted(dims, reverse=True):
        if x.shape[d] == 1:         # a sum of one value: no launch
            continue
        y = x.movedim(d, -1)
        n = y.shape[-1]
        s = torch.nn.functional.avg_pool2d(y.reshape(1, -1, 1, n), (1, n),
                                           divisor_override=1)
        x = s.reshape(y.shape[:-1] + (1,)).movedim(-1, d)
    return x


class _Part:
    """This rank's part of a model's chains, rows and columns under a
    mesh: each a slice of the global axis, and whether the axis is split
    (a mesh axis that does not divide it leaves it whole on every rank).
    ``take`` cuts this rank's part out of a draw taken at the global
    shape; the reductions and gathers run over mp only where the axis is
    split. Without a mesh every slice is the whole axis and every method
    returns its input."""

    def __init__(self, mesh, nchains, nrows, ncols):
        self.mesh = mesh

        def part(n, axis):
            if (mesh is None or mesh.size(axis) == 1
                    or feasible_spec(mesh, (axis,), (n,)) == (None,)):
                return slice(0, n), False
            b = n // mesh.size(axis)
            i = mesh.index(axis)
            return slice(i * b, (i + 1) * b), True

        self.nrows, self.ncols = nrows, ncols
        self.c, self.split_c = part(nchains, DP_AXIS)
        self.r, self.split_r = part(nrows, MP_AXIS)
        self.m, self.split_m = part(ncols, MP_AXIS)
        self.nc = self.c.stop - self.c.start
        self.nr = self.r.stop - self.r.start
        self.nm = self.m.stop - self.m.start
        self._axes = {"c": (self.c, self.split_c), "r": (self.r, self.split_r),
                      "m": (self.m, self.split_m)}

    def take(self, x, dims):
        """This rank's part of ``x``, a draw at the global shape: ``dims``
        names x's leading axes, 'c' chains, 'r' rows, 'm' columns, '.' an
        axis kept whole."""
        idx, cut = [], False
        for ch in dims:
            sl, split = self._axes[ch] if ch != "." else (None, False)
            idx.append(sl if split else slice(None))
            cut = cut or split
        return x[tuple(idx)] if cut else x

    def data_slab(self, pdata, axis):
        """This rank's slab of a prepared data pytree along ``axis`` (0:
        rows, for the W update; 1: columns, for the V update), or None
        where the pytree stays whole. It is cut only where the axis is
        split over mp and every leaf has that axis at the length of the
        model's rows (columns): then a user's ``row`` / ``col`` index is a
        position in the slab, as inside the JAX package's ``shard_map``
        regions. Otherwise every rank reads the whole pytree at global
        indices, as in the JAX package's regions without ``shard_map``.
        The length check keeps a leaf that is not indexed by row (column)
        whole, where the JAX package cuts any leaf the mesh divides
        (functionalmf_tpu/models/constrained.py:360-365)."""
        sl, split, n = ((self.r, self.split_r, self.nrows) if axis == 0
                        else (self.m, self.split_m, self.ncols))
        leaves = tree_leaves(pdata)
        if not (split and leaves and all(
                x.dim() > axis and x.shape[axis] == n for x in leaves)):
            return None
        idx = (slice(None),) * axis + (sl,)
        return tree_map(lambda x: x[idx].contiguous(), pdata)

    def _reduce(self, x, split, op):
        return self.mesh.all_reduce(x, MP_AXIS, op) if split else x

    def _sum(self, x, dims, split):
        """x summed over ``dims``, which hold axis 1 (rows or columns), in
        two stages that run alike with and without a mesh: over the other
        dims (``_fixed_sum``), then, once the partial sums of every rank
        are all-gathered over mp where the axis is split, over axis 1. A
        rank's partial sums are those of the unsharded run at the same
        positions, so the sum has the unsharded run's bits (an all-reduce
        of partial sums rounds otherwise, and a GASS, slice or ESS update
        can turn that rounding into a difference of 1e-4 or a flipped pick
        a few updates later)."""
        dims = tuple(d % x.dim() for d in dims)
        rest = tuple(d for d in dims if d != 1)
        part = _fixed_sum(x, rest) if rest else x
        if split:
            part = self.mesh.all_gather(part, MP_AXIS, 1)
        return part.sum(dims)

    def rows_sum(self, x, dims):
        """x summed over ``dims`` and over every row (x's axis 1)."""
        return self._sum(x, dims, self.split_r)

    def cols_sum(self, x, dims):
        """x summed over ``dims`` and over every column (x's axis 1)."""
        return self._sum(x, dims, self.split_m)

    def cols_min(self, x):
        return self._reduce(x, self.split_m, "min")

    def cols_max(self, x):
        return self._reduce(x, self.split_m, "max")

    def all_rows(self, x, dim=1):
        """x with every row, gathered over mp where rows are split."""
        return self.mesh.all_gather(x, MP_AXIS, dim) if self.split_r else x

    def all_cols(self, x, dim=1):
        return self.mesh.all_gather(x, MP_AXIS, dim) if self.split_m else x


class BayesianTensorFiltering:
    """Abstract base; subclasses implement ``prepare_data``,
    ``_make_sweep`` and ``logprob``."""

    _collect_keys = ("W", "V", "sigma2", "lam2", "Tau2")

    # draws collected on the device between copies to the host
    max_sweeps_per_call = 1024
    # keep a run record of every run_gibbs call (utils/telemetry.py):
    # model.last_run and telemetry.recent(); False makes every span and
    # counter a no-op
    trace_runs = True

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
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the model's device {self.device} is not this "
                             f"rank's mesh device {mesh.device}")
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
        self._delta_taps = self._band_taps(self.Delta_np)

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
        self._part = _Part(mesh, self.nchains, self.nrows, self.ncols)
        # the global shape and feasible spec of every state entry
        self._gshape, self._specs = {}, {}
        self._state = {}
        for key, v in state.items():
            self._put(key, v)

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
        self._put("sigma2", self._init_sigma2_val(self._next_init_gen()))

    def _init_lam2(self):
        lam2, lam2_a = self._init_lam2_val(self._next_init_gen())
        self._put("lam2", lam2)
        self._put("lam2_a", lam2_a)

    def _init_Tau2(self):
        t2, c, b, a = self._init_tau2_val(self._next_init_gen())
        for key, v in zip(("Tau2", "Tau2_c", "Tau2_b", "Tau2_a"),
                          (t2, c, b, a)):
            self._put(key, v)

    def _init_W(self):
        self._put("W", self._init_W_val(self._next_init_gen(),
                                        self._global("sigma2")))

    def _init_V(self):
        self._put("V", self._init_V_val(
            self._next_init_gen(), self._global("lam2"),
            self._global("Tau2")))

    # ------------------------------------------------------------------
    # mesh sharding: explicit per-model partition specs (no heuristics)
    # ------------------------------------------------------------------
    def state_partition_specs(self):
        """Explicit {state key: spec}, a tuple of mesh axis names or None
        a leading dimension (functionalmf_tpu/models/base.py:516-541).
        Axis 0 is always chains (dp); W shards rows and V / Tau2 shard
        columns over mp. Subclasses extend this dict for every state key
        they add (enforced in _shard_specs)."""
        dp, mp = DP_AXIS, MP_AXIS
        return {
            "sigma2": (dp,), "lam2": (dp,), "lam2_a": (dp,),
            "nan_fallbacks": (dp,), "pivot_repairs": (dp,),
            "Tau2": (dp, mp), "Tau2_a": (dp, mp),
            "Tau2_b": (dp, mp), "Tau2_c": (dp, mp),
            "W": (dp, mp),   # rows over mp
            "V": (dp, mp),   # columns over mp
        }

    def _shard_specs(self):
        specs = self.state_partition_specs()
        missing = set(self._state) - set(specs)
        assert not missing, (
            f"state keys {sorted(missing)} have no partition spec; extend "
            f"{type(self).__name__}.state_partition_specs")
        return specs

    def _put(self, key, value):
        """Set state entry ``key`` from its global value: this rank keeps
        its slice."""
        self._gshape[key] = tuple(value.shape)
        if self.mesh is None:
            self._state[key] = value
            return
        spec = self.state_partition_specs()[key]
        self._specs[key] = feasible_spec(self.mesh, spec, tuple(value.shape))
        self._state[key] = shard_state({key: value}, self.mesh,
                                       {key: spec})[key]
        self._shard_specs()

    def _gather(self, local, specs):
        return (local if self.mesh is None
                else gather_state(local, self.mesh, specs))

    def _global(self, key):
        return self._gather({key: self._state[key]}, self._specs)[key]

    def _shard(self, gstate):
        """This rank's slices of a global state dict (the dict itself
        without a mesh)."""
        if self.mesh is None:
            return gstate
        return shard_state(gstate, self.mesh, self.state_partition_specs())

    # ------------------------------------------------------------------
    # state access
    # ------------------------------------------------------------------
    @property
    def state(self):
        """The global state dict (under a mesh, gathered on every rank)."""
        return self._gather(self._state, self._specs)

    def _get_var(self, name):
        v = self._global(name)
        if self.nchains == 1:
            v = v[0]
        return v.cpu().numpy()

    def _set_var(self, name, value):
        self._put(name, self._chain_broadcast(value, self._gshape[name][1:]))

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
            if key in self._state and tuple(val.shape) != self._gshape[key]:
                raise ValueError(f"state[{key!r}] has shape "
                                 f"{tuple(val.shape)}, expected "
                                 f"{self._gshape[key]}")
        for key in list(self._state):
            self._put(key, new[key])

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

    def _sample_v_prior(self, gen, lam2, Tau2, dims=None):
        """(nch, m, k*T) ~ N(0, kron(I_k, DtLD)^-1), one (T, T) Cholesky per
        column with k right-hand sides, Jacobi-equilibrated; embed-major.
        The normals are drawn for every chain and column; with ``dims``
        ('c' or 'cm', as in ``_Part.take``) lam2 and Tau2 are this rank's
        chains (and columns) and so is the draw."""
        nch, m = Tau2.shape[:2]
        T, k = self.ndepth, self.nembeds
        DtLD = self._v_prior_dtld(lam2, Tau2)
        d = torch.diagonal(DtLD, dim1=-2, dim2=-1)
        dinv = torch.rsqrt(torch.where(d > 0, d, torch.ones_like(d)))
        Qe = DtLD * dinv[..., :, None] * dinv[..., None, :]
        L = cholesky_psd(Qe, eps=self.linalg_opts["force_psd_eps"],
                         attempts=self.linalg_opts["force_psd_attempts"]
                         if self.linalg_opts["force_psd"] else 0)
        z = torch.randn((self.nchains, self.ncols, T, k), generator=gen,
                        device=self.device)
        if dims:
            z = self._part.take(z, dims)
        x = torch.linalg.solve_triangular(L.mT, z, upper=True)
        x = x * dinv[..., None]
        return x.transpose(-1, -2).reshape(nch, m, k * T)

    def _band_taps(self, D):
        """Delta's rows as w taps: (index (w, nD), weight (w, nD)), row d
        being sum_o weight[o, d] e_{index[o, d]}, w the widest row's span."""
        nz = np.abs(D) > 0
        T = D.shape[1]
        first = nz.argmax(1)
        last = T - 1 - nz[:, ::-1].argmax(1)
        w = int((last - first).max()) + 1
        idx = np.minimum(first, T - w)[None, :] + np.arange(w)[:, None]
        weight = D[np.arange(D.shape[0])[None, :], idx]
        return (torch.as_tensor(idx, dtype=torch.long, device=self.device),
                self._t(weight))

    def _deltas(self, V):
        """Delta V_j per chain and column: (nch, m, nD, k), contiguous: the
        banded Delta's few taps of V, weighted and added elementwise. So
        every value has the same bits however many chains and columns a
        call holds (a matrix product over them is ordered by their
        number, on the card), and a chain's block is contiguous."""
        idx, weight = self._delta_taps
        d = weight[0][:, None] * V[:, :, idx[0]]
        for o in range(1, idx.shape[0]):
            d = d + weight[o][:, None] * V[:, :, idx[o]]
        return d

    @property
    def _wmask_rows(self):
        """The lower-triangular mask of this rank's rows of W."""
        return self._wmask[self._part.r]

    def _update_sigma2(self, state, gen):
        W = state["W"] * self._wmask_rows
        sq = self._part.rows_sum(W * W, (-2, -1))
        g = self._part.take(standard_gamma(
            gen, self.sigma2_a + self._w_len / 2.0, (self.nchains,),
            device=self.device), "c")
        prec = g / (self.sigma2_b + sq / 2.0)
        return dict(state, sigma2=1.0 / prec)

    def _update_tau2(self, state, gen):
        deltas = self._deltas(state["V"])
        deltas_sq = (deltas * deltas).sum(-1)
        # resample_tau2_ladder's draws, at the global ladder shape
        shape = (self.nchains, self.ncols, self.nD)
        gamma = standard_gamma(gen, (self.nembeds + 1) / 2.0, shape,
                               device=self.device)
        expo = _exponential(gen, (3,) + shape, self.device)
        t2, c, b, a = resample_tau2_ladder(
            gen, deltas_sq, state["lam2"][:, None, None], state["Tau2"],
            state["Tau2_c"], state["Tau2_b"], state["Tau2_a"],
            self.nembeds, self.stability,
            noise=(self._part.take(gamma, "cm"),
                   self._part.take(expo, ".cm")))
        return dict(state, Tau2=t2, Tau2_c=c, Tau2_b=b, Tau2_a=a)

    def _resample_lam2(self, gen, s, lam2_a):
        """resample_lam2 with its draws taken at the global chain shape."""
        shape = (self.nchains,)
        gamma = standard_gamma(gen, lam2_shape(self.nD, self.ncols,
                                               self.nembeds),
                               shape, device=self.device)
        expo = _exponential(gen, shape, self.device)
        return resample_lam2(gen, s, lam2_a, self.nD, self.ncols,
                             self.nembeds,
                             noise=(self._part.take(gamma, "c"),
                                    self._part.take(expo, "c")))

    def _update_lam2(self, state, gen):
        deltas = self._deltas(state["V"])
        tau2 = torch.clamp(state["Tau2"], self.stability,
                           1 / self.stability)[..., None]
        s = self._part.cols_sum(deltas * deltas / tau2, (1, 2, 3))
        lam2, lam2_a = self._resample_lam2(gen, s, state["lam2_a"])
        return dict(state, lam2=lam2, lam2_a=lam2_a)

    def _nan_guard(self, old_state, new_state, names=("W", "V")):
        """Keep the previous draw of a chain whose update came back
        non-finite, and count the event in nan_fallbacks (per chain).
        Where W's rows or V's columns are split over mp, a chain's verdict
        is the MIN over the mp line, so every rank keeps or drops the
        chain together."""
        state = dict(new_state)
        fallbacks = state["nan_fallbacks"]
        p = self._part
        for key in names:
            new = new_state[key]
            ok = torch.isfinite(new).reshape(new.shape[0], -1).all(-1)
            if {"W": p.split_r, "V": p.split_m}.get(key, False):
                ok = p.mesh.all_reduce(ok.to(torch.int32), MP_AXIS,
                                       "min").bool()
            okb = ok.reshape((-1,) + (1,) * (new.dim() - 1))
            state[key] = torch.where(okb, new, old_state[key])
            fallbacks = fallbacks + (~ok).to(fallbacks.dtype)
        state["nan_fallbacks"] = fallbacks
        return state

    def _prior_sweep(self, state, data, gen, update_W, update_V):
        """Prior updates, then W, then V (factor.py:112-128 order); each
        a phase of the run record."""
        with telemetry.phase("prior"):
            if self.sample_sigma2:
                state = self._update_sigma2(state, gen)
            if self.sample_Tau2:
                state = self._update_tau2(state, gen)
            if self.sample_lam2:
                state = self._update_lam2(state, gen)
        if self.sample_W:
            with telemetry.phase("w_update"):
                state = self._nan_guard(state, update_W(state, data, gen),
                                        names=("W",))
        if self.sample_V:
            with telemetry.phase("v_update"):
                state = self._nan_guard(state, update_V(state, data, gen),
                                        names=("V",))
        return state

    # ------------------------------------------------------------------
    # abstract pieces
    # ------------------------------------------------------------------
    def prepare_data(self, data):
        raise NotImplementedError

    def _check_start(self):
        """Called by ``run_gibbs`` before it prepares the data: a model
        that can refuse its start state raises here."""

    def _whole_data(self, pdata):
        """The whole prepared pytree, as a hook, ``collect_data_keys`` and
        a checkpoint see it. A model that keeps slabs of it under a mesh
        overrides this and ``_cut_data``."""
        return pdata

    def _cut_data(self, whole):
        """The prepared data a sweep reads, from the whole pytree that a
        hook returned or a checkpoint held."""
        return whole

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
        chain-major. Where the model's ``trace_runs`` is true the call's
        run record (``utils/telemetry.py``: host- and stream-clock spans,
        host syncs by site) is kept as ``model.last_run``.

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
        * ``profile_dir``: the call's head, its first 16 sweeps (at most
          one chunk) and their flush run under ``torch.profiler`` (the
          whole call where no sweep follows), with every span of the run
          record labelled ``fmf:<span>``, and the trace goes to
          ``<profile_dir>/trace.json``. The profiler slows every later
          launch of the process on the host: do not time a run after it.
        * ``key``: an integer in place of the model's seed for this run's
          sweeps and hook.

        Under a mesh every rank calls this with the same arguments, and
        each option means what it means without one
        (functionalmf_tpu/models/base.py:586-690, 751-814):

        * ``traced_callback`` sees the global chain-batched state (each
          entry all-gathered over dp and mp: one all-gather an entry and
          split axis, every sweep) and the whole prepared data; every rank
          calls it with the same generator, and keeps its part of the
          state it returns and its slabs of the data (cut again only
          where the hook returned another data object).
        * a host ``callback`` runs on every rank: the model's properties
          gather, its setters keep this rank's slice, and
          ``mark_data_dirty`` prepares the data again, slabs included.
        * ``collect_data_keys`` returns the global entry.
        * a checkpoint holds the global state, draws and data: every rank
          gathers, rank 0 writes, and every rank waits at a barrier. On
          resume every rank reads the file and keeps its slices, so a
          checkpoint resumes with or without a mesh, of any shape.
        * ``profile_dir``: rank 0 writes ``trace.json``, rank r > 0
          ``trace.rank<r>.json``.
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
        with telemetry.record(self) as run, \
                contextlib.ExitStack() as profiled:
            if profile_dir:
                profiled.enter_context(self._profiled(profile_dir, run))
            self._check_start()
            pdata = self.prepare_data(data)
            sweep = self._make_sweep()
            state = self._state
            M = max(1, int(self.max_sweeps_per_call))
            total = nburn + nthin * nsamples
            has_tc = traced_callback is not None

            step = collected = 0
            pending, chunks = [], []
            if checkpoint_path and resume and os.path.exists(checkpoint_path):
                gstate, step, collected, chunks, pd_ck = \
                    self._load_checkpoint(
                        checkpoint_path,
                        pdata_template=self._whole_data(pdata) if has_tc
                        else None)
                state = self._shard(gstate)
                if pd_ck is not None:
                    pdata = self._cut_data(pd_ck)
                if verbose:
                    print("\tResumed at step {} ({} samples)".format(
                        step, collected))

            def snapshot():
                out = {k: state[k].clone() for k in self._collect_keys}
                whole = self._whole_data(pdata)
                for k in collect_data_keys:
                    if isinstance(whole, dict) and k in whole:
                        out["data:" + k] = whole[k].clone()
                    else:
                        out[k] = state[k].clone()
                return out

            def flush():
                if pending:
                    stacked = {k: torch.stack([p[k] for p in pending], 0)
                               for k in pending[0]}
                    # the draws of every rank, once a chunk (sample axis
                    # first)
                    stacked = self._gather(stacked, {
                        k: (None,) + self._specs.get(k, ()) for k in stacked})
                    chunks.append({k: v.float().cpu().numpy()
                                   for k, v in stacked.items()})
                    run.d2h(sum(v.nbytes for v in chunks[-1].values()))
                    pending.clear()
                if checkpoint_path:
                    gstate = self._gather(state, self._specs)
                    if self.mesh is None or self.mesh.rank == 0:
                        self._save_checkpoint(
                            checkpoint_path, gstate, step, collected, chunks,
                            pdata=self._whole_data(pdata) if has_tc else None)
                    if self.mesh is not None:
                        self.mesh.barrier()

            self._data_dirty = False
            while step < total:
                stop = min(total, step + M)
                if profile_dir:
                    stop = min(stop, step + _PROFILE_MAX_SWEEPS)
                while step < stop:
                    with run.sweep():
                        state = sweep(state, pdata,
                                      rng.at(SweepRNG.SWEEP, step))
                        with run.phase("hook"):
                            if has_tc:
                                state, pdata = self._run_hook(
                                    traced_callback, state, pdata,
                                    rng.at(SweepRNG.HOOK, step), step)
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
                if step >= total:
                    run.begin_tail()
                with run.host("flush"):
                    flush()
                if profile_dir:
                    # the profile holds the head, the first chunk and its
                    # flush, and the whole call where nothing follows
                    if step < total:
                        profiled.close()
                    profile_dir = None
            with run.host("report"):
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

    def _run_hook(self, traced_callback, state, pdata, gen, step):
        """The device-side hook on the global state and the whole data;
        this rank keeps its part of what it returns."""
        whole = self._whole_data(pdata)
        gstate, new = traced_callback(self._gather(state, self._specs),
                                      whole, gen, step)
        return self._shard(gstate), (pdata if new is whole
                                     else self._cut_data(new))

    @contextlib.contextmanager
    def _profiled(self, profile_dir, run):
        """torch.profiler around the block, with the spans of ``run``
        labelled ``fmf:<span>`` inside it; the trace goes to
        ``<profile_dir>/trace.json`` (``trace.rank<r>.json`` from rank
        r > 0 of a mesh)."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            run.set_labels(True)
            try:
                yield
            finally:
                run.set_labels(False)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        rank = 0 if self.mesh is None else self.mesh.rank
        name = "trace.json" if rank == 0 else f"trace.rank{rank}.json"
        prof.export_chrome_trace(os.path.join(profile_dir, name))
        if self.mesh is not None:
            # every rank's trace is written when any rank goes on
            self.mesh.barrier()

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
        fb = self._global("nan_fallbacks").cpu().numpy()
        pr = self._global("pivot_repairs").cpu().numpy()
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
        self._put("lam2", self._chain_full((), hyperparams["lam2"]))

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
