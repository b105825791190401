"""Constrained black-box-likelihood BTF.

Counterpart of functionalmf_tpu/models/constrained.py: linear constraints
``A tau >= c`` on every curve and optional ``Row_constraints`` on every
row of W, GASS with the grid or the shrink method (``gass_method``), the
W update over rows, the blocked V update and the exact scale moves
(``interweave``, ``factor_rebalance``). The V update runs any of the
JAX package's schedules:

* ``v_schedule="redblack"``: the two-colour schedule, every same-colour
  block of every column in one GASS round (2 rounds, 3 with a ragged
  tail);
* ``v_schedule="seq"``: the time blocks one after another
  (``_update_V_gass``, ceil(T / v_block_size) rounds);
* ``v_block_size=None`` (or ``>= T``, any schedule but red-black): the
  joint update of the whole curve, one round.

A round is one batched GASS update over every (chain, column, block) of
its blocks, given the rest. With ``ep_approx=(Mu_ep, Sigma_ep)`` the
proposals are EP-centred (constrained.py:431-446, 633-681, 853-906): the
W rows draw from the GLS Gaussian, the V blocks from the coupled
(size*k) block precision ``kron(DtLD_blk, I_k) + diag_t(G)`` in t-major
packing, and the likelihood divides the EP factor out again.

With a cellfn, every GASS candidate log-likelihood goes through the fused
functions of ``ops/fused_ll.py``, with the EP extras when EP is on: on the
card, the W update is one launch of the row kernel over all (chain, row)
pairs, and each V round is one launch of the column-block kernel over all
of its (chain, column, block) pairs. That is the computation of the JAX
package's inline einsum (constrained.py:955-970), which is
``fused_col_block_ll`` for one pair. ``fuse_cells`` is accepted for
signature parity and changes nothing. With ``gass_method="shrink"`` an
update is one launch for the current points and one an iteration of the
bracket shrinkage, each with one candidate an item.

The black-box likelihood contract (a model without a cellfn). The user
writes the JAX package's function for ONE item,

    loglikelihood(data, WV, W, V, row=None, col=None) -> 0-d tensor

with ``data`` the prepared pytree (a dict, tuple or list of tensors, or one
tensor, on the model's device) and ``row`` / ``col`` indexing ``data``. The
model lifts it over candidates, items and chains with ``torch.func.vmap``
(``jax.vmap`` in the JAX package), so ``row``, ``col`` and ``t0`` arrive
as 0-d index tensors and the function must be made of operations with a
batching rule (indexing by a tensor, elementwise maths, reductions,
matmul); where one has none, vmap's error surfaces: there is no Python
loop over items behind it. The W update calls it with ``row=i`` and the
row's candidate (WV (m, T), W (k,)); the V update with ``col=j`` and whole
candidate curves (WV (n, T), V (T, k)), or, where given, the narrower
``loglikelihood_block(data, WV_blk, W, V_blk, row=None, col=j,
tslice=(s0, e0))`` (s0, e0 Python ints; seq and joint schedules) or
``loglikelihood_cells(data, WV_blk, W, V_blk, col=j, t0=, size=)`` (t0 a
0-d tensor, size a Python int; needed by red-black); the scale moves and
``logprob`` with neither (WV (n, m, T), the rescaled W and V). With EP the
model subtracts the EP log-density itself. Items are evaluated in chunks
sized from the shapes alone: a chunk holds at most 2^26 (data element,
candidate) pairs, so an intermediate of the user's function takes 256 MiB
times what it makes for each pair (the 20 components of the dose-response
mixture: about 5 GiB at most).
This path is plain PyTorch on the card, as the JAX path is plain XLA: it
is taken only when no cellfn is given, never because a kernel failed to
build or launch.

``data_dtype`` stores the prepared data in that dtype. A black-box
likelihood gets the stored leaves and upcasts what it reads
(``Y[row].float()``). With a cellfn the kernels read float32 ``y``: one
float32 copy is made of each prepared tensor, when the first sweep reads
it, and kept beside the stored one; nothing is converted at a launch.

Under a device mesh (``mesh=``, models/base.py) the chains run over dp
and W's rows and V's columns over mp; each rank keeps its row slab and
its column slab of the EP centres (``_init_ep``) and, where
``_Part.data_slab`` cuts it, of the data (``prepare_data``: always with a
cellfn, whose fused kernels run at the rank's local shapes). A black-box
likelihood gets the row (column) slab with ``row`` (``col``) its
position in the slab, as in the JAX package's ``shard_map`` regions, or,
where the pytree has a leaf that is not indexed by row (column), the
whole pytree with global indices, as in its regions without
``shard_map`` (constrained.py:518-541, 806-834); ``_data_split`` says
which, for each update. Every draw is taken at its global shape and
sliced. The collectives, site by site (each only where its axis is
split):

* W update: all-gather V over mp (its columns) for the constraint
  matrix and the candidates' cells; the rows are local.
* V update, every schedule: all-gather W over mp (its rows) for the EP
  terms, the constraint operator and the candidates' cells; the
  columns are local.
* scale moves: all-gather W over mp once; the V prior sums and, with a
  cellfn, every full-tensor log-likelihood of the slice targets are
  summed over mp (an all-gather of per-column partial sums each), the
  brackets over the curve constraints all-reduce MIN / MAX, so that
  every rank of a line takes the same branch. The row constraints'
  brackets come from the gathered W, whole on every rank. Without a
  cellfn, V and tau are all-gathered over mp once, every rank evaluates
  the user's full-tensor function on the whole data, and each value is
  broadcast from the line's first rank.
* the prior sweep's (models/base.py): sigma2, lam2 and the non-finite
  guard.

The loops that end on a host read, the shrink method's (samplers/
gass.py) and the jitter ladder's (``cholesky_psd``), hold no collective,
so ranks may run them a different number of times.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from functionalmf_tpu_torch._runtime import tree_leaves, tree_map
from functionalmf_tpu_torch.models.base import (BayesianTensorFiltering,
                                                _fixed_sum, _window_sum)
from functionalmf_tpu_torch.ops.fused_ll import (
    KERNEL_CELLS, as_cellfn, ep_log_density, fused_col_block_ll_batched,
    fused_row_ll_batched)
from functionalmf_tpu_torch.ops.mvn import (
    _cho_solve, _solve_lt, cholesky_psd, sample_mvn_from_precision)
from functionalmf_tpu_torch.parallel.mesh import DP_AXIS, MP_AXIS
from functionalmf_tpu_torch.samplers.gass import (
    draw_gass_noise, draw_gass_shrink_noise, gass_grid, gass_shrink)
from functionalmf_tpu_torch.samplers.slice1d import shrink_slice_1d
from functionalmf_tpu_torch.utils import telemetry

__all__ = ["ConstrainedNonconjugateBayesianTensorFiltering",
           "collapsed_scale_dims", "ep_block_precision"]

_LOG_LAM2_MIN = float(np.log(1e-5))
_MAX_SHRINK = 30    # the shrink method's iteration bound (gass.py:53)
# (data element, candidate) pairs at most of one lifted black-box likelihood
# call (256 MiB of float32 for each float the user's function makes a
# pair): the items of an update are evaluated in chunks of that size
_CHUNK_ELEMS = 1 << 26


def collapsed_scale_dims(w_len, ncols, ndepth, nembeds):
    """(dW_free, dV_free) of the collapsed scale-split moves, as the
    reference has them (functionalmf_tpu/models/constrained.py:1082-1083).
    dV_free counts ncols*ndepth*nembeds, while the conjugate lam2 update
    uses nD*ncols*nembeds (samplers/horseshoe.lam2_shape): a known fault
    of the reference, ported as it is (ROADMAP.md, Queue 3 item 1)."""
    return float(w_len), float(ncols * ndepth * nembeds)


def ep_block_precision(DtLD_blk, G_blk):
    """The coupled (size*k) precision of an EP-centred V block,
    kron(DtLD_blk, I_k) + diag_t(G), t-major: Q[(t, a), (s, c)] =
    DtLD_blk[t, s] 1{a = c} + G[t, a, c] 1{t = s} (constrained.py:
    659-668, 889-896). DtLD_blk: (..., size, size); G_blk: (..., size, k,
    k). Returns (..., size*k, size*k)."""
    size, k = G_blk.shape[-3], G_blk.shape[-1]
    dev = G_blk.device
    Q = (torch.einsum("...ts,ac->...tasc", DtLD_blk,
                      torch.eye(k, device=dev))
         + torch.einsum("...tac,ts->...tasc", G_blk,
                        torch.eye(size, device=dev)))
    return Q.reshape(Q.shape[:-4] + (size * k, size * k))


@dataclasses.dataclass
class _Phase:
    """Host-built constants of one round of the blocked V update: its
    blocks, all of one size, update together given the rest."""
    starts: list
    size: int
    tidx: torch.Tensor       # (nblk, size) time indices of the blocks
    t_mask: torch.Tensor     # (T,) 0 inside the phase's blocks
    CA_blk: torch.Tensor     # (nblk, Jb, size) constraint rows in-block
    CA_out: torch.Tensor     # (nblk, Jb, T) the same rows out of block
    CC_pad: torch.Tensor     # (nblk, Jb) offsets; padded rows 0 >= -1
    pair_chain: torch.Tensor  # (P,) int32, P = nchains * ncols * nblk
    pair_col: torch.Tensor    # (this rank's chains and columns, local
    pair_t0: torch.Tensor     # indices, under a mesh)


class _Slabs:
    """The prepared data under a mesh: what the W update reads (this
    rank's row slab, or the whole pytree) and the index of this rank's
    first row in it; the same for the V update and the columns; and the
    whole pytree."""

    def __init__(self, rows, cols, whole, row0, col0):
        self.rows, self.cols, self.whole = rows, cols, whole
        self.row0, self.col0 = row0, col0


class ConstrainedNonconjugateBayesianTensorFiltering(BayesianTensorFiltering):
    """Constrained nonconjugate BTF (reference factor.py:894-1017). It
    runs on the card (``device="cuda"``, the default) unless the caller
    passes ``device="cpu"``; without a card the default raises. With a
    ``loglikelihood_cellfn`` every candidate goes through the fused
    kernels; without one the black-box contract of the module docstring
    applies."""

    def __init__(self, nrows, ncols, ndepth, loglikelihood, Constraints,
                 ep_approx=None,
                 nthreads=None,
                 gass_ngrid=100,
                 gass_w_repeats=1,
                 gass_v_repeats=1,
                 gass_method="grid",
                 Row_constraints=None,
                 multiprocessing=None,
                 sharedprefix=None,
                 worker_init=None,
                 v_block_size=8,
                 v_schedule="seq",
                 loglikelihood_cells=None,
                 loglikelihood_block=None,
                 loglikelihood_cellfn=None,
                 fuse_cells=False,
                 interweave=True,
                 factor_rebalance=True,
                 **kwargs):
        has_cellfn = loglikelihood_cellfn is not None
        if has_cellfn and (loglikelihood_cells is not None
                           or loglikelihood_block is not None):
            raise ValueError(
                "with a loglikelihood_cellfn every candidate goes through "
                "the fused kernels; loglikelihood_cells/_block belong to a "
                "model without a cellfn")
        if fuse_cells and not has_cellfn:
            raise ValueError("fuse_cells=True requires loglikelihood_cellfn")
        if gass_method not in ("grid", "shrink"):
            raise ValueError(f"unknown gass_method {gass_method!r}")
        if v_schedule not in ("seq", "redblack"):
            raise ValueError(f"unknown v_schedule {v_schedule!r}")
        if (v_schedule == "redblack" and not has_cellfn
                and loglikelihood_cells is None):
            raise ValueError(
                "the redblack schedule updates non-adjacent blocks "
                "simultaneously, which is only an exact Gibbs kernel "
                "for likelihoods that factorize over the depth axis — "
                "pass loglikelihood_cells")
        # read by state_partition_specs while the base class places state
        self._has_row_constraints = Row_constraints is not None
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.loglikelihood = loglikelihood
        self.loglikelihood_cells = loglikelihood_cells
        self.loglikelihood_block = loglikelihood_block
        self.loglikelihood_cellfn = (as_cellfn(loglikelihood_cellfn)
                                     if has_cellfn else None)
        if (has_cellfn and self.device.type == "cuda"
                and self.loglikelihood_cellfn.name not in KERNEL_CELLS):
            raise ValueError(
                f"cell function {self.loglikelihood_cellfn.name!r} has no "
                "CUDA kernel specialisation; on a CUDA device pass a CellFn "
                f"named one of {sorted(KERNEL_CELLS)} (e.g. "
                "functionalmf_tpu_torch.ops.fused_ll.POISSON)")
        self.fuse_cells = bool(fuse_cells)   # parity only: always fused
        self.interweave = bool(interweave)
        self.factor_rebalance = bool(factor_rebalance)
        self.gass_ngrid = int(gass_ngrid)
        self.gass_w_repeats = max(1, int(gass_w_repeats))
        self.gass_v_repeats = max(1, int(gass_v_repeats))
        self.gass_method = gass_method
        self.v_schedule = v_schedule
        self.v_block_size = None if v_block_size is None else int(v_block_size)
        self._y32 = []      # (prepared tensor, its float32 copy) pairs

        Constraints = np.asarray(Constraints, dtype=np.float32)
        if v_schedule == "redblack":
            self._check_redblack(Constraints)

        self._CA_np = Constraints[:, :-1]                      # (J, T)
        self._CC_np = Constraints[:, -1]                       # (J,)
        self.Constraints_A = self._t(self._CA_np)
        self.Constraints_C = self._t(self._CC_np)
        self.nconstraints = int(Constraints.shape[0])
        self._c_rows = self.Constraints_C.repeat(self.ncols)   # (m*J,)

        # Row_constraints live in the state dict, with a chain axis: a hook
        # rewrites them every sweep (the dose-response U step) and
        # interop carries them like every other entry
        if self._has_row_constraints:
            RC = np.asarray(Row_constraints, dtype=np.float32)
            if RC.ndim not in (2, 3) or RC.shape[-1] != self.nembeds + 1:
                raise ValueError(
                    "Row_constraints must be (nR, nembeds + 1) rows [A | c], "
                    f"got shape {RC.shape}")
            self._put("Row_constraints",
                      self._chain_broadcast(RC, RC.shape[-2:]))

        nch, n = self._part.nc, self._part.nr
        self._row_chain = torch.arange(
            nch, dtype=torch.int32, device=self.device).repeat_interleave(n)
        self._row_idx = torch.arange(
            n, dtype=torch.int32, device=self.device).repeat(nch)
        T = self.ndepth
        bs = self.v_block_size or T
        if v_schedule == "redblack":
            nb_full, rem = divmod(T, bs)
            self._phases = [self._build_phase([b * bs for b in blocks], bs)
                            for blocks in (range(0, nb_full, 2),
                                           range(1, nb_full, 2)) if blocks]
            if rem:   # ragged tail block, one extra single-block round
                self._phases.append(self._build_phase([nb_full * bs], rem))
        else:         # sequential blocks; one block of T is the joint update
            self._phases = [self._build_phase([s0], min(bs, T - s0))
                            for s0 in range(0, T, bs)]
        self._init_ep(ep_approx)

    # ------------------------------------------------------------------
    def _check_redblack(self, Constraints):
        """The red-black schedule is exact Gibbs only when same-colour
        blocks are conditionally independent (constrained.py:247-272)."""
        bs = self.v_block_size
        if bs is None or bs >= self.ndepth:
            raise ValueError("redblack needs a finite v_block_size < T")
        supp = np.abs(self.Delta_np) > 0
        extents = [np.nonzero(r)[0] for r in supp if r.any()]
        delta_ext = max(int(e.max() - e.min()) for e in extents)
        if delta_ext > bs:
            raise ValueError(
                f"prior bandwidth {delta_ext} > v_block_size {bs}: "
                "non-adjacent blocks would couple through the prior")
        csupp = np.abs(Constraints[:, :-1]) > 0
        cext = [np.nonzero(r)[0] for r in csupp if r.any()]
        cons_w = max((int(e.max() - e.min()) + 1 for e in cext), default=0)
        if cons_w > bs + 1:
            raise ValueError(
                f"a constraint row spans {cons_w} time points > "
                f"v_block_size + 1 = {bs + 1}: it could couple two "
                "same-color blocks")

    def _init_ep(self, ep_approx):
        """EP centring (constrained.py:294-315): float32 host copies, the
        overconfidence warning, and the device tensors the updates read:
        ``_ep`` = (mu, sig) as the kernels' extras, (n, m, T) each (empty
        without EP), and the masked precisions Sinv2 and Mu0 * Sinv2.
        The W update reads this rank's rows of them (``_ep_r``,
        ``_ep_prec_r``), the V update its columns (``_ep_m``,
        ``_ep_prec_m``): the same tensors without a mesh, contiguous
        slabs made once with one."""
        self._ep = self._ep_r = self._ep_m = ()
        self._ep_prec_r = self._ep_prec_m = ()
        if ep_approx is None:
            self.Mu_ep = self.Sigma_ep = None
            return
        shape = (self.nrows, self.ncols, self.ndepth)
        self.Mu_ep = np.asarray(ep_approx[0], np.float32)
        self.Sigma_ep = np.asarray(ep_approx[1], np.float32)
        if self.Mu_ep.shape != shape or self.Sigma_ep.shape != shape:
            raise ValueError(f"ep_approx must be two {shape} arrays, got "
                             f"{self.Mu_ep.shape} and {self.Sigma_ep.shape}")
        # An overconfident EP traps the chain: the subtracted EP logpdf
        # grows quadratically with distance from Mu_ep, so once an
        # excursion leaves the EP bulk, every candidate nearer the centre
        # falls below the slice.
        mu_np = np.asarray(ep_approx[0], np.float64)
        sig_np = np.asarray(ep_approx[1], np.float64)
        spread = np.nanstd(mu_np)
        if np.nanmedian(sig_np) < 0.5 * spread:
            warnings.warn(
                "Sigma_ep is small relative to the spread of Mu_ep "
                f"(median {np.nanmedian(sig_np):.3g} vs std {spread:.3g}); "
                "overconfident EP approximations can trap the GASS chain "
                "— consider ep_from_mf(mode='multiplier', multiplier>=3).")
        mu, sig = self._t(self.Mu_ep), self._t(self.Sigma_ep)
        self._ep = (mu, sig)
        nan = torch.isnan(mu)
        sinv2 = torch.where(nan, 0.0, 1.0 / (sig * sig))
        prec = (sinv2, torch.where(nan, 0.0, mu) * sinv2)
        p = self._part
        rows = (lambda e: e[p.r].contiguous()) if p.split_r else (lambda e: e)
        cols = ((lambda e: e[:, p.m].contiguous()) if p.split_m
                else (lambda e: e))
        self._ep_r, self._ep_m = tuple(map(rows, self._ep)), \
            tuple(map(cols, self._ep))
        self._ep_prec_r = tuple(map(rows, prec))
        self._ep_prec_m = tuple(map(cols, prec))

    # ------------------------------------------------------------------
    def _build_phase(self, starts, size):
        T, m, nch = self.ndepth, self._part.nm, self._part.nc
        nblk = len(starts)
        t_mask = np.ones(T, np.float32)
        for s in starts:
            t_mask[s:s + size] = 0.0
        rels = [np.nonzero(np.abs(self._CA_np[:, s:s + size]).sum(1) > 0)[0]
                for s in starts]
        Jb = max(1, max(len(r) for r in rels))
        CA_blk = np.zeros((nblk, Jb, size), np.float32)
        CA_out = np.zeros((nblk, Jb, T), np.float32)
        CC_pad = np.full((nblk, Jb), -1.0, np.float32)
        for b, (s, rel) in enumerate(zip(starts, rels)):
            if len(rel) == 0:
                continue
            CA_blk[b, :len(rel)] = self._CA_np[rel][:, s:s + size]
            co = self._CA_np[rel].copy()
            co[:, s:s + size] = 0.0
            CA_out[b, :len(rel)] = co
            CC_pad[b, :len(rel)] = self._CC_np[rel]
        tidx = np.asarray(starts)[:, None] + np.arange(size)[None]
        cc, jj, bb = np.meshgrid(np.arange(nch), np.arange(m),
                                 np.arange(nblk), indexing="ij")
        i32 = dict(dtype=torch.int32, device=self.device)
        return _Phase(
            starts=list(starts), size=size,
            tidx=torch.as_tensor(tidx, dtype=torch.long, device=self.device),
            t_mask=self._t(t_mask), CA_blk=self._t(CA_blk),
            CA_out=self._t(CA_out), CC_pad=self._t(CC_pad),
            pair_chain=torch.as_tensor(cc.reshape(-1), **i32),
            pair_col=torch.as_tensor(jj.reshape(-1), **i32),
            pair_t0=torch.as_tensor(np.asarray(starts)[bb.reshape(-1)], **i32))

    @property
    def Row_constraints(self):
        if not self._has_row_constraints:
            return None
        return self._get_var("Row_constraints")

    @Row_constraints.setter
    def Row_constraints(self, value):
        if not self._has_row_constraints:
            raise ValueError("Row_constraints must be given to the "
                             "constructor to be updatable")
        self._set_var("Row_constraints", value)

    def state_partition_specs(self):
        specs = super().state_partition_specs()
        if self._has_row_constraints:
            # a small (nR, k+1) matrix read whole by every row update
            specs["Row_constraints"] = (DP_AXIS,)
        return specs

    def prepare_data(self, data):
        """The data on the model's device, stored in ``data_dtype``
        (float32 unless given). With a cellfn: one (n, m, T) or
        (n, m, T, 1) tensor. Without: any pytree of arrays (a dict,
        tuple or list, or one array), as the user's likelihood reads it.
        Under a mesh, a ``_Slabs`` of it (``_cut_data``)."""
        return self._cut_data(self._prepare_whole(data))

    def _cut_data(self, whole):
        """Under a mesh, the ``_Slabs`` of the whole prepared pytree: the
        row slab and the column slab where ``_Part.data_slab`` cuts them,
        else the whole pytree at global indices; ``_data_split`` records
        which ("slab" or "whole") for the W and the V update."""
        p = self._part
        rows = None if self.mesh is None else p.data_slab(whole, 0)
        cols = None if self.mesh is None else p.data_slab(whole, 1)
        self._data_split = {"W": "whole" if rows is None else "slab",
                            "V": "whole" if cols is None else "slab"}
        if self.mesh is None:
            return whole
        return _Slabs(whole if rows is None else rows,
                      whole if cols is None else cols, whole,
                      p.r.start if rows is None else 0,
                      p.m.start if cols is None else 0)

    def _whole_data(self, pdata):
        return pdata.whole if isinstance(pdata, _Slabs) else pdata

    @staticmethod
    def _rows_cols(y):
        """(rows, columns) of the prepared data: both ``y`` itself without
        a mesh."""
        return (y.rows, y.cols) if isinstance(y, _Slabs) else (y, y)

    @staticmethod
    def _first(y):
        """(row0, col0): the index of this rank's first row in what the W
        update reads, and of its first column in what the V update reads."""
        return (y.row0, y.col0) if isinstance(y, _Slabs) else (0, 0)

    def _prepare_whole(self, data):
        dt = self.data_dtype or self.dtype

        def leaf(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            return torch.as_tensor(np.asarray(x, dtype=np.float32),
                                   device=self.device).to(dt)

        if self.loglikelihood_cellfn is None:
            return tree_map(leaf, data)
        y = leaf(data)
        if y.dim() == 4 and y.shape[-1] == 1:
            y = y[..., 0]
        want = (self.nrows, self.ncols, self.ndepth)
        if tuple(y.shape) != want:
            raise ValueError(f"data must be one {want} (or {want + (1,)}) "
                             f"tensor, got shape {tuple(y.shape)}")
        return y

    def _f32(self, y):
        """The float32 tensor the fused functions read: ``y`` itself, or
        the one copy made of a prepared tensor stored in another dtype."""
        if y.dtype == torch.float32:
            return y
        for src, copy in self._y32:
            if src is y:
                return copy
        # a row and a column slab under a mesh: two copies at most
        self._y32 = self._y32[-1:] + [(y, y.float())]
        return self._y32[-1][1]

    def _chunk(self, items, per_item):
        """Items a lifted likelihood call: a pure function of the shapes."""
        return max(1, min(items, _CHUNK_ELEMS
                          // max(1, per_item * self._part.nc)))

    def _data_work(self, pdata):
        """Data elements of one (row, column, time) cell: the largest data
        leaf's elements a cell (the replicates)."""
        cells = self.nrows * self.ncols * self.ndepth
        most = max(leaf.numel()
                   for leaf in tree_leaves(self._whole_data(pdata)))
        return max(1, most // cells)

    # ------------------------------------------------------------------
    # W update: batched GASS over (chain, row)
    # ------------------------------------------------------------------
    def _update_W_gass(self, state, y, gen):
        """GASS over this rank's (chain, row) pairs; V whole (all-gathered
        over mp where its columns are split)."""
        p = self._part
        nch, n, m, T, k = p.nc, p.nr, self.ncols, self.ndepth, self.nembeds
        B = nch * n
        V = p.all_cols(state["V"])
        # constraints from the opposite embedding, shared by the rows of a
        # chain up to the row's dim mask: A[(col, j), a] = sum_t CA[j, t]
        # V[col, t, a]; the Row_constraints rows [A | c] follow them
        A_base = torch.einsum("jt,cmta->cmja", self.Constraints_A, V).reshape(
            nch, m * self.nconstraints, k)
        c = self._c_rows.expand(B, -1)
        if self._has_row_constraints:
            RC = state["Row_constraints"]                  # (nch, nR, k+1)
            A_base = torch.cat([A_base, RC[:, :, :k]], dim=1)
            c = torch.cat([c, RC[:, :, k].repeat_interleave(n, dim=0)], dim=1)
        dmask = self._wmask_rows.expand(nch, n, k).reshape(B, k)

        L, mu_all = self._w_proposal(V, state["sigma2"])
        # the proposal's normals at the global (chain, row) shape
        z = p.take(torch.randn((self.nchains, self.nrows, k), generator=gen,
                               device=self.device), "cr")
        v_all = sample_mvn_from_precision(gen, L, chol_factor=True, z=z)
        v_all = v_all.reshape(B, k) * dmask

        def Af(Y):                           # (B, G, k) -> (B, G, m*J + nR)
            G = Y.shape[1]
            Yc = (Y * dmask[:, None]).reshape(nch, n * G, k)
            return torch.einsum("cgk,cjk->cgj", Yc, A_base).reshape(B, G, -1)

        if self.loglikelihood_cellfn is None:
            loglik = self._w_loglik_blackbox(y, V, dmask)
        else:
            bt = V.reshape(nch, m * T, k)
            y2 = self._f32(self._rows_cols(y)[0]).reshape(n, m * T)
            extras = tuple(e.reshape(n, m * T) for e in self._ep_r)
            cellfn = self.loglikelihood_cellfn

            def loglik(cands):               # (B, G, k) -> (B, G)
                w = (cands * dmask[:, None]).contiguous()
                return fused_row_ll_batched(w, bt, y2, self._row_chain,
                                            self._row_idx, cellfn, extras)

        x_new = self._gass_update(
            gen, state["W"].reshape(B, k), loglik, Af, c,
            (self.nchains, self.nrows), "cr", v=v_all, dim_mask=dmask,
            mu=None if mu_all is None else mu_all.reshape(B, k))
        return dict(state, W=x_new.reshape(nch, n, k) * self._wmask_rows)

    def _w_loglik_blackbox(self, pdata, V, dmask):
        """The W update's candidate log-likelihoods through the user's
        function (constrained.py:498-507): ``user_ll(data, tau_g, w_g, V,
        row=i)`` less the EP log-density of row i, lifted over candidates,
        this rank's rows (in chunks) and chains; ``data`` and ``i`` the
        row slab and a position in it, or the whole data and a global
        index (``_cut_data``). V: (nch, m, T, k), every column."""
        nch, n, m, T, k = (self._part.nc, self._part.nr, self.ncols,
                           self.ndepth, self.nembeds)
        user_ll, ep = self.loglikelihood, self._ep_r
        data, r0 = self._rows_cols(pdata)[0], self._first(pdata)[0]
        rows = torch.arange(r0, r0 + n, device=self.device)
        work = m * T * self._data_work(pdata)
        vmap = torch.func.vmap

        def per_row(i, cands_i, V_c, *ep_i):       # cands_i (G, k)
            tau = torch.einsum("gk,mtk->gmt", cands_i, V_c)

            def one(tau_g, w_g):
                ll = user_ll(data, tau_g, w_g, V_c, row=i, col=None)
                if ep_i:
                    ll = ll - ep_log_density(tau_g, *ep_i).sum()
                return ll

            return vmap(one)(tau, cands_i)

        def loglik(cands):                          # (B, G, k) -> (B, G)
            with telemetry.span("blackbox_ll"):
                G = cands.shape[1]
                w = (cands * dmask[:, None]).reshape(nch, n, G, k)
                over_rows = vmap(per_row,
                                 in_dims=(0, 0, None) + (0,) * len(ep),
                                 chunk_size=self._chunk(n, G * work))
                return vmap(lambda w_c, V_c: over_rows(rows, w_c, V_c, *ep))(
                    w, V).reshape(nch * n, G)

        return loglik

    def _gass_update(self, gen, x, loglik, A, c, lead, dims, **kw):
        """One batched GASS update of x (B, D) by the model's method; its
        noise comes from ``gen`` after the proposal draws, drawn for the
        global items ``lead`` (their leading axes, named by ``dims`` as
        in ``_Part.take``) and cut to this rank's B."""
        Bg = int(np.prod(lead))

        def local(t):                 # (Bg, ...) -> (B, ...)
            t = t.reshape(tuple(lead) + t.shape[1:])
            return self._part.take(t, dims).reshape((-1,) + t.shape[
                len(lead):])

        if self.gass_method == "shrink":
            log_u, phi, u = map(local, draw_gass_shrink_noise(
                gen, Bg, _MAX_SHRINK, self.device))
            return gass_shrink(x, loglik, A, c, log_u=log_u, phi=phi, u=u,
                               **kw)[0]
        log_u, gumbel = map(local, draw_gass_noise(gen, Bg, self.gass_ngrid,
                                                   self.device))
        return gass_grid(x, loglik, A, c, log_u=log_u, gumbel=gumbel,
                         **kw)[0]

    def _w_proposal(self, V, sigma2):
        """The W rows' proposal Gaussian (constrained.py:428-450): the
        Cholesky factor L of its precision Q and its mean, (nch, n, k)
        (None without EP, where Q = I / sigma2). With EP, the GLS
        Gaussian: Q = sum_x Sinv2[i, x] V[x] V[x]^T on the row's active
        dims + I / sigma2, mean Q^-1 sum_x (Mu0 Sinv2)[i, x] V[x]."""
        nch, n, k = self._part.nc, self._part.nr, self.nembeds
        eye = torch.eye(k, device=self.device)
        prior = eye / sigma2[:, None, None, None]            # (nch, 1, k, k)
        if not self._ep:
            # sample_mvn_from_precision(**linalg_opts) in the JAX package:
            # the jitter ladder only under force_psd
            opts = self.linalg_opts
            return cholesky_psd(prior.expand(nch, n, k, k),
                                eps=opts["force_psd_eps"],
                                attempts=opts["force_psd_attempts"]
                                if opts["force_psd"] else 0), None
        mask = self._wmask_rows
        # products summed over x in a fixed order (_fixed_sum): a row's
        # terms then have the same bits whatever the number of chains and
        # rows a rank holds, as under a mesh (a contraction of every row at
        # once is ordered by the batch's shape)
        Vf = V.reshape(nch, 1, -1, k)
        sinv2, mu_sinv2 = self._ep_prec_r
        SV = Vf * sinv2.reshape(1, n, -1, 1)                 # (nch,n,x,k)
        Q = (_fixed_sum(SV[..., :, None] * Vf[..., None, :], (2,))[:, :, 0]
             * mask[:, :, None] * mask[:, None, :] + prior)
        mu_part = _fixed_sum(Vf * mu_sinv2.reshape(1, n, -1, 1),
                             (2,))[:, :, 0] * mask
        L = self._chol(Q)
        return L, _cho_solve(L, mu_part)

    def _chol(self, Q):
        """cholesky_psd with the model's jitter ladder, whatever
        force_psd says, as the JAX package's EP proposal and V blocks
        (constrained.py:443, 673, 689, 901, 911)."""
        return cholesky_psd(Q, eps=self.linalg_opts["force_psd_eps"],
                            attempts=self.linalg_opts["force_psd_attempts"])

    # ------------------------------------------------------------------
    # V update: blocked GASS over (chain, column, block), one round per
    # phase (red-black colours, sequential blocks, or the joint block)
    # ------------------------------------------------------------------
    def _blocks_loglik(self, W, y, ph, cands):
        """Candidate log-likelihoods of every pair of phase ``ph``.
        W: (nch, n, k) masked; cands: (P, G, size, k). Returns (P, G)."""
        return fused_col_block_ll_batched(
            cands.contiguous(), W, self._f32(y), ph.pair_chain, ph.pair_col,
            ph.pair_t0, self.loglikelihood_cellfn, self._ep_m)

    def _v_loglik_blackbox(self, pdata, W, X, ph):
        """A V round's candidate log-likelihoods through the user's
        functions, lifted over candidates, blocks, columns (in chunks) and
        chains; (B, G, size*k) -> (B, G), B = (chain, column, block).

        * ``loglikelihood_cells``: the block's cells alone, ``t0`` a 0-d
          tensor (constrained.py:955-970);
        * else ``loglikelihood_block``: the block's cells alone, static
          ``tslice`` (constrained.py:753-766);
        * else whole curves rebuilt around the block, ``user_ll(data,
          tau_g, W, V_g, col=j)`` (constrained.py:767-791).

        Each less the EP log-density over the cells it covers. The items
        are this rank's columns; ``data`` and ``col`` the column slab and a
        position in it, or the whole data and a global index
        (``_cut_data``). W: (nch, n, k), every row; X: this rank's V."""
        nch, n, m, T, k = (self._part.nc, self.nrows, self._part.nm,
                           self.ndepth, self.nembeds)
        nblk, size = len(ph.starts), ph.size
        user_ll, user_blk, user_cells = (
            self.loglikelihood, self.loglikelihood_block,
            self.loglikelihood_cells)
        ep = tuple(e.permute(1, 0, 2) for e in self._ep_m)   # (m, n, T)
        data, c0 = self._rows_cols(pdata)[1], self._first(pdata)[1]
        cols = torch.arange(c0, c0 + m, device=self.device)
        # a copy from a host list: on the card it waits for the stream
        telemetry.count("sync:block_starts")
        t0s = torch.as_tensor(ph.starts, device=self.device)
        vmap = torch.func.vmap
        if user_cells is None and nblk != 1:
            raise ValueError("a round of several blocks needs "
                             "loglikelihood_cells")
        s0 = ph.starts[0]
        e0 = s0 + size

        def ep_term(tau_g, ep_j, tid=None):
            if not ep_j:
                return 0.0
            mu, sig = ep_j if tid is None else (e[:, tid] for e in ep_j)
            return ep_log_density(tau_g, mu, sig).sum()

        def per_block(t0, tid, cands_b, j, W_c, *ep_j):   # cands_b (G,size,k)
            tau = torch.einsum("gtk,nk->gnt", cands_b, W_c)

            def one(tau_g, Vb_g):
                return user_cells(data, tau_g, W_c, Vb_g, col=j, t0=t0,
                                  size=size) - ep_term(tau_g, ep_j, tid)

            return vmap(one)(tau, cands_b)

        def per_col(j, cands_j, x_j, W_c, *ep_j):   # cands_j (nblk,G,size,k)
            if user_cells is not None:
                nep = (None,) * len(ep_j)
                return vmap(per_block, in_dims=(0, 0, 0, None, None) + nep)(
                    t0s, ph.tidx, cands_j, j, W_c, *ep_j)
            cands_b = cands_j[0]
            if user_blk is not None:
                tau = torch.einsum("gtk,nk->gnt", cands_b, W_c)
                ep_b = tuple(e[:, s0:e0] for e in ep_j)

                def one(tau_g, Vb_g):
                    return user_blk(data, tau_g, W_c, Vb_g, row=None, col=j,
                                    tslice=(s0, e0)) - ep_term(tau_g, ep_b)

                return vmap(one)(tau, cands_b)[None]
            G = cands_b.shape[0]
            Vg = torch.cat([x_j[:s0].expand(G, -1, -1), cands_b,
                            x_j[e0:].expand(G, -1, -1)], dim=1)
            tau = torch.einsum("gtk,nk->gnt", Vg, W_c)

            def one(tau_g, V_g):
                return user_ll(data, tau_g, W_c, V_g, row=None,
                               col=j) - ep_term(tau_g, ep_j)

            return vmap(one)(tau, Vg)[None]

        whole = user_cells is None and user_blk is None
        work = n * (T if whole else nblk * size) * self._data_work(pdata)

        def loglik(cands):                          # (B, G, D) -> (B, G)
            with telemetry.span("blackbox_ll"):
                G = cands.shape[1]
                c6 = cands.reshape(nch, m, nblk, G, size, k)
                over_cols = vmap(per_col,
                                 in_dims=(0, 0, 0, None) + (0,) * len(ep),
                                 chunk_size=self._chunk(m, G * work))
                return vmap(lambda c_c, X_c, W_c: over_cols(
                    cols, c_c, X_c, W_c, *ep))(c6, X, W).reshape(-1, G)

        return loglik

    def _v_ep_terms(self, W):
        """The EP Gram and moment of every (column, t) of this rank given
        the whole W (constrained.py:633-640): G (nch, m, T, k, k) and
        mu_part (nch, m, T, k); (None, None) without EP."""
        if not self._ep:
            return None, None
        sinv2, mu_sinv2 = self._ep_prec_m
        # products summed over the rows in a fixed order, as the W
        # proposal's (_w_proposal)
        Wb = W[:, None, None]                               # (nch,1,1,n,k)
        SW = Wb * sinv2.permute(1, 2, 0)[None, ..., None]   # (nch,m,T,n,k)
        G = _fixed_sum(SW[..., :, None] * Wb[..., None, :], (3,))[:, :, :, 0]
        mu_part = _fixed_sum(Wb * mu_sinv2.permute(1, 2, 0)[None, ..., None],
                             (3,))[:, :, :, 0]
        return G, mu_part

    def _block_gaussian(self, DtLD, G, mu_part, X_out, tidx, z):
        """The conditional Gaussian of each block given the coordinates
        outside it (X_out, zero inside the blocks): its mean and a draw of
        its zero-mean part from the standard normal z, both (nch, m, nblk,
        size*k) in t-major packing. Without EP the precision is
        kron(I_k, DtLD_blk): one (size, size) factor with k right-hand
        sides. With EP it is the coupled ep_block_precision."""
        DtLD_blk = DtLD[:, :, tidx[:, :, None], tidx[:, None, :]]
        DtLD_rows = DtLD[:, :, tidx, :]                  # (nch,m,nblk,sz,T)
        rhs_tk = -torch.einsum("cmbts,cmsk->cmbtk", DtLD_rows, X_out)
        lead = rhs_tk.shape[:3]
        if G is not None:
            Qbb = ep_block_precision(DtLD_blk, G[:, :, tidx])
            rhs = (rhs_tk + mu_part[:, :, tidx]).reshape(lead + (-1,))
            d = torch.diagonal(Qbb, dim1=-2, dim2=-1)
            dinv = torch.rsqrt(torch.where(d > 0, d, torch.ones_like(d)))
            L = self._chol(Qbb * dinv[..., :, None] * dinv[..., None, :])
            mu_b = _cho_solve(L, rhs * dinv) * dinv
            v_b = _solve_lt(L, z.reshape(lead + (-1,))) * dinv
            return mu_b, v_b
        d = torch.diagonal(DtLD_blk, dim1=-2, dim2=-1)
        dinv = torch.rsqrt(torch.where(d > 0, d, torch.ones_like(d)))
        Qe = DtLD_blk * dinv[..., :, None] * dinv[..., None, :]
        L = self._chol(Qe)
        Lt = L.mT
        yv = torch.linalg.solve_triangular(L, rhs_tk * dinv[..., None],
                                           upper=False)
        mu_b = torch.linalg.solve_triangular(Lt, yv, upper=True) \
            * dinv[..., None]
        v_b = torch.linalg.solve_triangular(Lt, z, upper=True) \
            * dinv[..., None]
        return mu_b.reshape(lead + (-1,)), v_b.reshape(lead + (-1,))

    def _phase_update(self, X, W, DtLD, G, mu_part, y, ph, gen):
        """One round over this rank's (chain, column, block) items; W
        whole, X, DtLD, G and mu_part this rank's columns, y the prepared
        data."""
        nch, m, k = self._part.nc, self._part.nm, self.nembeds
        nblk, size = len(ph.starts), ph.size
        D = size * k
        B = nch * m * nblk
        X_out = X * ph.t_mask[:, None]
        tidx = ph.tidx

        # the blocks' normals at the global (chain, column) shape
        z = self._part.take(torch.randn(
            (self.nchains, self.ncols, nblk, size, k), generator=gen,
            device=self.device), "cm")
        mu_b, v_b = self._block_gaussian(DtLD, G, mu_part, X_out, tidx, z)
        mu_b, v_b = mu_b.reshape(B, D), v_b.reshape(B, D)

        # constraints restricted to each block; frozen coordinates fold
        # into the offsets
        tau_out = torch.einsum("cmtk,cnk->cmnt", X_out, W)
        frozen = torch.einsum("cmnt,bjt->cmbnj", tau_out, ph.CA_out)
        c_all = (ph.CC_pad[:, None, :] - frozen).reshape(B, -1)

        def A_op(Yb):                        # (B, G, D) -> (B, G, n*Jb)
            G = Yb.shape[1]
            Y6 = Yb.reshape(nch, m, nblk, G, size, k)
            M = torch.einsum("bjt,cmbgtk->cmbgjk", ph.CA_blk, Y6)
            return torch.einsum("cnk,cmbgjk->cmbgnj", W, M).reshape(B, G, -1)

        if self.loglikelihood_cellfn is None:
            loglik = self._v_loglik_blackbox(y, W, X, ph)
        else:
            y_cols = self._rows_cols(y)[1]

            def loglik(cands):               # (B, G, D) -> (B, G)
                G = cands.shape[1]
                return self._blocks_loglik(W, y_cols, ph,
                                           cands.reshape(B, G, size, k))

        Xb_cur = X[:, :, tidx, :].reshape(B, D)
        Xb_new = self._gass_update(gen, Xb_cur, loglik, A_op, c_all,
                                   (self.nchains, self.ncols, nblk), "cm",
                                   v=v_b, mu=mu_b)
        X = X.clone()
        X[:, :, tidx, :] = Xb_new.reshape(nch, m, nblk, size, k)
        return X

    def _update_V_gass(self, state, y, gen):
        """Every round over this rank's columns; W whole (all-gathered
        over mp where its rows are split)."""
        W = (self._part.all_rows(state["W"]) * self._wmask).contiguous()
        DtLD = self._v_prior_dtld(state["lam2"], state["Tau2"])
        G, mu_part = self._v_ep_terms(W)
        X = state["V"]
        for ph in self._phases:
            X = self._phase_update(X, W, DtLD, G, mu_part, y, ph, gen)
        return dict(state, V=X)

    # ------------------------------------------------------------------
    # exact scale moves (ASIS re-draws of lam2 / sigma2, collapsed
    # global and per-factor W <-> V rebalance)
    # ------------------------------------------------------------------
    def _scale_bounds(self, vals, cs, over_cols=False):
        """Feasible interval (s_lo, s_hi) of a global rescale tau -> s tau
        over the last axis: s*v >= c for every constraint value v. With
        ``over_cols`` the values are this rank's columns' and the extremes
        are all-reduced (MAX, MIN) over mp."""
        ratio = cs / torch.where(vals == 0, 1.0, vals)
        s_lo = torch.where(vals > 0, ratio, -torch.inf).amax(-1)
        s_hi = torch.where(vals < 0, ratio, torch.inf).amin(-1)
        if over_cols:
            s_lo, s_hi = self._part.cols_max(s_lo), self._part.cols_min(s_hi)
        s_lo = torch.clamp(s_lo, min=1e-6) * (1.0 + 1e-6)
        s_hi = torch.clamp(s_hi, max=1e6) * (1.0 - 1e-6)
        return s_lo, s_hi

    def _rc_values(self, W, RC):
        """The row constraints' values A_r w_i and offsets, (nch, n*nR)."""
        k = self.nembeds
        rv = torch.einsum("cnk,cjk->cnj", W, RC[:, :, :k])
        cs = RC[:, None, :, k].expand_as(rv)
        return rv.reshape(W.shape[0], -1), cs.reshape(W.shape[0], -1)

    @staticmethod
    def _bracket_from_scale(s_lo, s_hi):
        """The bracket of x in [-6, 6] when W scales by e^{-x}, from the
        feasible interval of the scale (constrained.py:1118-1121; it is
        reopened to hold x = 0, as in the reference)."""
        lo = torch.clamp(-torch.log(s_hi), min=-6.0).clamp(max=0.0)
        hi = torch.clamp(-torch.log(s_lo), max=6.0).clamp(min=0.0)
        return lo, hi

    def _rc_global_bracket(self, W, RC):
        """Bracket of the collapsed global move (W, V) -> (W e^{-x},
        V e^{x}) under the row constraints (constrained.py:1111-1121)."""
        return self._bracket_from_scale(
            *self._scale_bounds(*self._rc_values(W, RC)))

    def _rc_factor_bracket(self, W, RC, kk):
        """Bracket of factor kk's rebalance: the constraint values are
        affine in s = e^{-x}, rest + s part_kk >= c
        (constrained.py:1192-1210)."""
        nch, k = W.shape[0], self.nembeds
        rvf = torch.einsum("cnk,cjk->cnj", W, RC[:, :, :k])
        pk = W[:, :, kk, None] * RC[:, None, :, kk]
        num = RC[:, None, :, k].expand_as(pk) - (rvf - pk)
        ratio = (num / torch.where(pk == 0, 1.0, pk)).reshape(nch, -1)
        pk = pk.reshape(nch, -1)
        s_lo = torch.where(pk > 0, ratio, -torch.inf).amax(-1)
        s_hi = torch.where(pk < 0, ratio, torch.inf).amin(-1)
        s_lo = torch.clamp(s_lo, min=1e-6) * (1.0 + 1e-6)
        s_hi = torch.clamp(s_hi, max=1e6) * (1.0 - 1e-6)
        return self._bracket_from_scale(s_lo, s_hi)

    def _sigma2_bracket(self, x0, Av, cs_curve, W, RC):
        """Bracket of the ASIS sigma2 move, x = log sigma2, W scales by
        s = exp((x - x0) / 2): the curve constraints' values ``Av`` (None
        where they form a cone) and the row constraints' both scale with s
        (constrained.py:1303-1324). Av holds this rank's columns; the row
        constraints' values, from the whole W, are the same on every rank
        of an mp line, so the extremes of both reduce over mp at once."""
        if Av is None and RC is None:
            return x0 - 12.0, x0 + 12.0
        vals, cs = [], []
        if Av is not None:
            vals.append(Av)
            cs.append(cs_curve)
        if RC is not None:
            rv, rc = self._rc_values(W, RC)
            vals.append(rv)
            cs.append(rc)
        s_lo, s_hi = self._scale_bounds(torch.cat(vals, -1),
                                        torch.cat(cs, -1),
                                        over_cols=Av is not None)
        lo = torch.maximum(x0 + 2.0 * torch.log(s_lo), x0 - 12.0)
        hi = torch.minimum(x0 + 2.0 * torch.log(s_hi), x0 + 12.0)
        return torch.minimum(lo, x0), torch.maximum(hi, x0)

    def _slice_1d(self, x0, logdensity, lo, hi, gen):
        """shrink_slice_1d of this rank's chains, its draws taken for every
        chain (an Exp(1) a chain, then 16 uniforms a chain)."""
        e = torch.empty(self.nchains, device=self.device).exponential_(
            generator=gen)
        u = torch.rand((16, self.nchains), generator=gen, device=self.device)
        return shrink_slice_1d(x0, logdensity, lo, hi, max_shrink=16,
                               noise=(self._part.take(e, "c"),
                                      self._part.take(u, ".c")))

    def _interweave_scales(self, state, y, gen):
        """functionalmf_tpu/models/constrained.py:1020-1338, every chain
        at once (per-chain scalars are (nchains,) tensors). Under a mesh
        W is gathered whole once; tau, V and the data are this rank's
        columns, and the column sums reduce over mp. The user's
        full-tensor function (no cellfn) gets V and tau gathered whole
        (``V_w``, ``tau_w``) and the whole data, and its value is
        broadcast over mp, so that every rank of a line takes the slice
        moves' branches alike."""
        p = self._part
        nch, k = p.nc, self.nembeds
        dev = self.device
        W_all = p.all_rows(state["W"])            # every row, unmasked
        W = W_all * self._wmask
        V = state["V"]
        tau = torch.einsum("cnk,cmtk->cnmt", W, V)
        zeros = torch.zeros(nch, device=dev)
        c4 = (slice(None), None, None, None)
        RC = state["Row_constraints"] if self._has_row_constraints else None

        if self.sample_W and self.sample_V:
            inv_tau2 = 1.0 / torch.clamp(state["Tau2"], self.stability,
                                         1.0 / self.stability)
            deltas = self._deltas(V)                      # (nch, m, nD, k)
            dq = deltas * deltas * inv_tau2[..., None]
            Qbar = torch.clamp(p.cols_sum(dq, (1, 2, 3)), min=1e-20)
            W2 = (W * W).sum((1, 2))
            dW_free, dV_free = collapsed_scale_dims(
                self._w_len, self.ncols, self.ndepth, k)
            a_s, b_s = self.sigma2_a, self.sigma2_b
            inv_la = 1.0 / torch.clamp(state["lam2_a"], min=1e-20)
            inv_s2 = 1.0 / torch.clamp(state["sigma2"], min=1e-20)
            inv_l2 = 1.0 / torch.clamp(state["lam2"], min=1e-20)

            def w_term(x, W2_rest, w2):
                if self.sample_sigma2:
                    return -(a_s + dW_free / 2.0) * torch.log(
                        b_s + (W2_rest + torch.exp(-2.0 * x) * w2) / 2.0)
                return -0.5 * torch.exp(-2.0 * x) * w2 * inv_s2

            def v_term(x, Q_rest, q):
                if self.sample_lam2:
                    return -(0.5 + dV_free / 2.0) * torch.log(
                        inv_la + (Q_rest + torch.exp(2.0 * x) * q) / 2.0)
                return -0.5 * torch.exp(2.0 * x) * q * inv_l2

            def logdens_c(x):
                return ((dV_free - dW_free) * x + w_term(x, 0.0, W2)
                        + v_term(x, 0.0, Qbar))

            lo_c, hi_c = -6.0, 6.0
            if RC is not None:       # W scales by e^{-x}
                lo_c, hi_c = self._rc_global_bracket(W, RC)
            x_c, _ = self._slice_1d(zeros, logdens_c, lo_c, hi_c, gen)
            c_w, c_v = torch.exp(-x_c), torch.exp(x_c)
            W = W * c_w[c4[:3]]
            V = V * c_v[c4]
            W_all = W_all * c_w[c4[:3]]
            Qbar_cur = torch.exp(2.0 * x_c) * Qbar

            if self.factor_rebalance and k > 1:
                w2k = (W * W).sum(1)                              # (nch, k)
                qk = torch.clamp(p.cols_sum(dq, (1, 2))
                                 * torch.exp(2.0 * x_c)[:, None], min=1e-20)
                dwk = self._wmask_np.sum(axis=0)
                dvk = float(self.ncols * self.ndepth)
                eye_k = torch.eye(k, device=dev)
                for kk in range(k):
                    W2_rest = w2k.sum(-1) - w2k[:, kk]
                    Q_rest = qk.sum(-1) - qk[:, kk]
                    w2_kk, q_kk = w2k[:, kk], qk[:, kk]
                    jac = float(dvk - float(dwk[kk]))

                    def logdens_f(x, W2_rest=W2_rest, Q_rest=Q_rest,
                                  w2_kk=w2_kk, q_kk=q_kk, jac=jac):
                        return (jac * x + w_term(x, W2_rest, w2_kk)
                                + v_term(x, Q_rest, q_kk))

                    lo_f, hi_f = -6.0, 6.0
                    if RC is not None:
                        lo_f, hi_f = self._rc_factor_bracket(W, RC, kk)
                    x_f, _ = self._slice_1d(zeros, logdens_f, lo_f, hi_f,
                                            gen)
                    f_w, f_v = torch.exp(-x_f), torch.exp(x_f)
                    onehot = eye_k[kk]
                    fw_k = 1.0 + (f_w[:, None] - 1.0) * onehot    # (nch, k)
                    fv_k = 1.0 + (f_v[:, None] - 1.0) * onehot
                    W = W * fw_k[:, None, :]
                    V = V * fv_k[:, None, None, :]
                    w2k = w2k * fw_k * fw_k
                    qk = qk * fv_k * fv_k
                    W_all = W_all * fw_k[:, None, :]
                Qbar_cur = qk.sum(-1)
            state = dict(state, W=p.take(W_all, ".r"), V=V)

            # redraw the collapsed scales at the new split
            if self.sample_sigma2:
                state = self._update_sigma2(state, gen)
            if self.sample_lam2:
                lam2_new, lam2_a_new = self._resample_lam2(
                    gen, Qbar_cur, state["lam2_a"])
                state = dict(state, lam2=lam2_new, lam2_a=lam2_a_new)

        # all offsets 0: the feasible set is a cone, invariant under s > 0
        cone = bool((self._CC_np == 0.0).all())
        if cone:
            Av = cs_curve = None
        else:
            Av = torch.einsum("jt,cnmt->cnmj", self.Constraints_A,
                              tau).reshape(nch, -1)
            cs_curve = self.Constraints_C.repeat(
                self.nrows * p.nm).expand(nch, -1)
        # the full-tensor likelihood of the slice targets: the cellfn
        # (terms of y alone are constant in the rescale), else the user's
        # function on the rescaled tau, W and V (constrained.py:1256-1266)
        cellfn, user_ll = self.loglikelihood_cellfn, self.loglikelihood
        V_w, tau_w = V, tau
        if cellfn is not None:
            y32 = self._f32(self._rows_cols(y)[1])

            def full_ll(tau_s, W_s, V_s):
                # a column's sum in a fixed order (34 calls a sweep:
                # _window_sum, three launches), then the columns' over mp:
                # a reduction of every column at once can be ordered by the
                # number of columns and chains a rank holds
                ll = _window_sum(cellfn(y32[None], tau_s), (1, 3))
                return p.cols_sum(ll[:, 0, :, 0], (1,))
        else:
            whole = self._whole_data(y)
            if p.split_m:
                V_w, tau_w = p.all_cols(V), p.all_cols(tau, dim=2)

            def full_ll(tau_s, W_s, V_s):
                ll = torch.func.vmap(
                    lambda t, w, v: user_ll(whole, t, w, v, row=None,
                                            col=None))(tau_s, W_s, V_s)
                return ll if self.mesh is None else self.mesh.broadcast(
                    ll, MP_AXIS)

        if self.sample_lam2 and self.sample_V:
            x0 = torch.log(torch.clamp(state["lam2"], min=1e-20))
            if cone:
                lo_s, hi_s = x0 - 12.0, x0 + 12.0
            else:
                s_lo, s_hi = self._scale_bounds(Av, cs_curve, over_cols=True)
                lo_s = torch.maximum(x0 + 2.0 * torch.log(s_lo), x0 - 12.0)
                hi_s = torch.minimum(x0 + 2.0 * torch.log(s_hi), x0 + 12.0)
            lo = torch.minimum(torch.clamp(lo_s, min=_LOG_LAM2_MIN), x0)
            hi = torch.maximum(hi_s, x0)
            inv_a = 1.0 / torch.clamp(state["lam2_a"], min=1e-20)

            def logdens(x):
                s = torch.exp(0.5 * (x - x0))
                return (-0.5 * x - torch.exp(-x) * inv_a
                        + full_ll(s[c4] * tau_w, W, s[c4] * V_w))

            x_new, _ = self._slice_1d(x0, logdens, lo, hi, gen)
            s = torch.exp(0.5 * (x_new - x0))
            V = V * s[c4]
            tau = tau * s[c4]
            V_w, tau_w = V_w * s[c4], tau_w * s[c4]
            if Av is not None:
                Av = Av * s[:, None]
            state = dict(state, lam2=torch.exp(x_new), V=V)

        if self.sample_sigma2 and self.sample_W:
            x0 = torch.log(torch.clamp(state["sigma2"], min=1e-20))
            lo, hi = self._sigma2_bracket(x0, Av, cs_curve, W, RC)
            a, b = self.sigma2_a, self.sigma2_b

            def logdens(x):
                s = torch.exp(0.5 * (x - x0))
                return (-a * x - b * torch.exp(-x)
                        + full_ll(s[c4] * tau_w, s[c4[:3]] * W, V_w))

            x_new, _ = self._slice_1d(x0, logdens, lo, hi, gen)
            s = torch.exp(0.5 * (x_new - x0))
            state = dict(state, sigma2=torch.exp(x_new),
                         W=state["W"] * s[c4[:3]])
        return state

    # ------------------------------------------------------------------
    def _make_sweep(self):
        rW, rV = self.gass_w_repeats, self.gass_v_repeats

        def update_W(state, y, gen):
            for _ in range(rW):
                state = self._update_W_gass(state, y, gen)
            return state

        def update_V(state, y, gen):
            for _ in range(rV):
                state = self._update_V_gass(state, y, gen)
            return state

        def sweep(state, y, gen):
            state = self._prior_sweep(state, y, gen, update_W, update_V)
            if self.interweave:
                with telemetry.phase("scale_moves"):
                    state = self._interweave_scales(state, y, gen)
            return state
        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        W = torch.as_tensor(np.asarray(params.get("W", self.W), np.float32),
                            device=self.device)
        V = torch.as_tensor(np.asarray(params.get("V", self.V), np.float32),
                            device=self.device)
        tau = torch.einsum("nk,mtk->nmt", W, V)
        return float(self.loglikelihood(self._prepare_whole(data), tau, W,
                                        V, row=None, col=None))

    def check_constraints(self, atol=1e-5):
        """Every curve constraint A tau >= c and, where given, every row
        constraint A_r w_i >= c_r holds, across all chains."""
        return self._worst_constraint_slack() >= -atol

    def _worst_constraint_slack(self):
        """min over chains, cells and constraints of A tau - c (and of
        A_r w_i - c_r, each chain against its own Row_constraints)."""
        st = self.state
        W = st["W"].cpu().numpy()
        V = st["V"].cpu().numpy()
        tau = np.einsum("cnk,cmtk->cnmt", W, V)
        vals = np.einsum("jt,cnmt->cnmj", self._CA_np, tau)
        worst = float((vals - self._CC_np).min())
        if self._has_row_constraints:
            RC = st["Row_constraints"].cpu().numpy()
            k = self.nembeds
            rvals = (np.einsum("cnk,cjk->cnj", W, RC[:, :, :k])
                     - RC[:, None, :, k])
            worst = min(worst, float(rvals.min()))
        return worst

    def _check_start(self):
        """``run_gibbs`` refuses to sample from an infeasible start: GASS
        is a valid kernel only from a feasible point."""
        worst = self._worst_constraint_slack()
        if worst < -1e-5:
            raise ValueError(
                "Initial state violates the constraints (worst margin "
                f"A@tau - c = {worst:.3e}). GASS requires a feasible "
                "starting point. Pass feasible W_init/V_init, e.g. a "
                "nonnegative warm start.")
