"""Fused GASS candidate log-likelihoods: CUDA kernels and their plain
PyTorch versions.

Counterpart of functionalmf_tpu/ops/fused_ll.py. The two Pallas TPU
kernels there become the two CUDA kernels of ``csrc/fused_ll.cu``:

* ``fused_row_ll_batched`` (kernel ``fmf_row_ll``) replaces
  ``fused_row_ll`` / ``_row_kernel``. It serves the W update, one launch
  over every (chain, row) pair.
* ``fused_col_block_ll_batched`` (kernel ``fmf_col_block_ll``) replaces
  ``fused_col_block_ll`` / ``_col_kernel``. It serves the blocked V
  updates, one launch over every (chain, column, block) pair of a colour
  (red-black) or of one time block (sequential and joint); the kernel
  reads each pair's data slice and W itself.

Both take the JAX kernels' EP ``extras=(mu, sig)``: per-cell arrays laid
out like ``y``. With them each cell contributes
``cell(y, tau) - 1{mu not NaN} log N(tau; mu, sig)``, the model's
``cellfn_ep`` (functionalmf_tpu/models/constrained.py:466-468); the
EP term counts wherever ``mu`` is not NaN, also where ``y`` is NaN. The
EP launches are counted apart (``fused_row_ll_ep``,
``fused_col_block_ll_ep``).

``fused_row_ll`` and ``fused_col_block_ll`` keep the JAX signatures (one
batch item) on top of the batched functions.

The cell log-likelihood is a :class:`CellFn`. Its ``torch_fn`` is the
elementwise ``(y, tau) -> ll`` that returns 0 where ``y`` is NaN and omits
terms of ``y`` alone (they cancel in the GASS slice test). A CUDA kernel
cannot call a Python function, so each cell the kernels support has a
device functor of the same ``name`` in ``csrc/fused_ll.cu``, chosen when
the kernel is compiled.

Routing: a CPU tensor goes through the plain version (einsum, ``torch_fn``,
sum). A CUDA tensor launches the kernel, or raises; there is no fallback
on the card. Every kernel launch adds one to ``launch_counts``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch

__all__ = ["CellFn", "POISSON", "KERNEL_CELLS", "launch_counts",
           "reset_launch_counts", "fused_row_ll", "fused_col_block_ll",
           "fused_row_ll_batched", "fused_col_block_ll_batched",
           "row_ll_plain", "col_block_ll_plain", "ep_log_density"]


@dataclasses.dataclass(frozen=True)
class CellFn:
    """An elementwise cell log-likelihood: ``torch_fn(y, tau) -> ll``.

    ``name`` selects the CUDA kernels' compiled specialisation; a cell
    without one (``name=None``) runs only on the CPU path.
    """
    name: Optional[str]
    torch_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    def __call__(self, y, tau):
        return self.torch_fn(y, tau)


def _poisson(y, tau):
    rate = torch.clamp(tau, min=1e-8)
    nan = torch.isnan(y)
    y0 = torch.where(nan, 0.0, y)
    return torch.where(nan, 0.0, y0 * torch.log(rate) - rate)


POISSON = CellFn(name="poisson", torch_fn=_poisson)

# CellFn name -> the integer id of its functor in csrc/fused_ll.cu
KERNEL_CELLS = {"poisson": 0}

_MAX_K = 32
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

# The kernels' launch constants (csrc/fused_ll.cu): warps a block (256
# threads), candidates a pass (4 a lane), blocks a cluster at most.
_WARPS, _PASS, _MAX_CLUSTER = 8, 128, 8
_CELLS_A_BLOCK = 512        # cells a block of a split item
_SMEM_MAX = 232_448         # the H100's shared memory a block (227 KB)
_SMEM_SOFT = 96 * 1024      # chunks shrink until two blocks fit an SM
# the largest chunk: cells (row kernel), time slots (column kernel)
_CHUNK_MAX = {"row": 1024, "col": 16}

launch_counts = {"fused_row_ll": 0, "fused_col_block_ll": 0,
                 "fused_row_ll_ep": 0, "fused_col_block_ll_ep": 0}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def as_cellfn(cell_fn) -> CellFn:
    return cell_fn if isinstance(cell_fn, CellFn) else CellFn(None, cell_fn)


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def ep_log_density(tau, mu, sig):
    """log N(tau; mu, sig) per cell, 0 where mu is NaN (the EP factor
    divided out of the likelihood, constrained.py:68-73)."""
    lp = -0.5 * ((tau - mu) / sig) ** 2 - torch.log(sig) - _HALF_LOG_2PI
    return torch.where(torch.isnan(mu), 0.0, lp)


def row_ll_plain(cands, bt, y, row_chain, row_idx, cell_fn, extras=()):
    """ll[r, g] = sum_c cell(y[row_idx[r], c],
                             cands[r, g] . bt[row_chain[r], c]),
    less the EP log-density of ``extras=(mu, sig)`` (each like y)."""
    tau = torch.einsum("rgk,rck->rgc", cands, bt[row_chain.long()])
    ri = row_idx.long()
    ll = as_cellfn(cell_fn)(y[ri][:, None, :], tau)
    if extras:
        mu, sig = extras
        ll = ll - ep_log_density(tau, mu[ri][:, None, :], sig[ri][:, None, :])
    return ll.sum(-1)


def col_block_ll_plain(cands, w, y, pair_chain, pair_col, pair_t0, cell_fn,
                       extras=()):
    """ll[p, g] = sum_{t,i} cell(y[i, j_p, t0_p + t],
                                 cands[p, g, t] . w[c_p, i]),
    less the EP log-density of ``extras=(mu, sig)`` (each like y); cells
    with t0_p + t outside [0, T) contribute 0."""
    T = y.shape[2]
    Tb = cands.shape[2]
    tt = pair_t0.long()[:, None] + torch.arange(Tb, device=y.device)[None]
    inside = (tt >= 0) & (tt < T)
    cols, tcl = pair_col.long()[:, None], tt.clamp(0, T - 1)

    def block(x):                                              # (P, Tb, n)
        xb = x.permute(1, 2, 0)[cols, tcl]
        return torch.where(inside[..., None], xb, torch.nan)[:, None]

    tau = torch.einsum("pgtk,pnk->pgtn", cands, w[pair_chain.long()])
    ll = as_cellfn(cell_fn)(block(y), tau)
    if extras:
        mu, sig = extras
        ll = ll - ep_log_density(tau, block(mu), block(sig))
    return ll.sum((-2, -1))


# ----------------------------------------------------------------------
# launch plan
# ----------------------------------------------------------------------
def _r4(x):
    return (x + 3) // 4 * 4


def _smem_bytes(kind, chunk, G, k, n, ep):
    """Dynamic shared memory of one block (Layout in csrc/fused_ll.cu),
    in 16-byte regions: the chunk's cell constants (float4), the warps'
    and the block's partial sums, W (column kernel) and two stages of the
    chunk's bytes."""
    narr = 3 if ep else 1
    if kind == "row":
        cells, fixed = 4 * chunk, 0
        stage = _r4(chunk * k) + narr * _r4(chunk)
    else:
        cells, fixed = 4 * chunk * n, _r4(n * k)
        stage = min(G, _PASS) * _r4(chunk * k) + narr * n * _r4(chunk)
    return 4 * (cells + _WARPS * _PASS + _PASS + fixed + 2 * stage)


def _block_ranges(units, cluster):
    """Units [lo, hi) of each block rank (block_range in csrc/fused_ll.cu):
    groups of 4 units (of 1 where a block would get fewer than 4) split
    evenly, so that a block's rows start on 16 bytes wherever the item's
    do."""
    g = 4 if units >= 4 * cluster else 1
    groups = -(-units // g)
    return tuple((min(units, g * (r * groups // cluster)),
                  min(units, g * ((r + 1) * groups // cluster)))
                 for r in range(cluster))


def _cluster_size(cells):
    """Blocks an item of ``cells`` cells is split over, from the item's
    size alone. An item of fewer than 1024 cells stays in one block: there
    the cluster's barriers and reduction cost more than the split saves. A
    larger item takes a block for every 512 cells, up to 8 blocks (the
    portable cluster); every item of 4096 cells or more, the W rows' and
    the joint blocks' at the paths' shapes, takes 8.

    The number of items in the launch plays no part: the cluster and the
    chunk set the order in which an item's cells are summed, and an item
    must have the same bits whichever launch it is in (a rank of a mesh
    launches a part of the unsharded run's items)."""
    if cells < 1024:
        return 1
    return min(_MAX_CLUSTER, -(-cells // _CELLS_A_BLOCK))


def _split_plan(kind, cluster, units, G, k, n, ep):
    """An item's split over ``cluster`` blocks (at most one a unit): block
    rank r takes units ``blocks[r]`` and walks them in chunks of ``chunk``
    through two shared-memory stages, in candidate passes of 128
    (``passes``: (first candidate, count)); ``smem`` is the dynamic shared
    memory a block.

    The chunk is the block's whole range up to 1024 cells (row kernel) or
    16 time slots (column kernel), a multiple of 4 where the range is
    longer: on an H100 a chunk costs a round trip to memory and three block
    barriers, and fewer, larger chunks measured faster at every path
    shape."""
    cluster = min(cluster, units)
    blocks = _block_ranges(units, cluster)
    per_block = max(hi - lo for lo, hi in blocks)
    most = _CHUNK_MAX[kind]
    chunk = per_block if per_block <= most else \
        _r4(-(-per_block // -(-per_block // most)))
    while chunk > 4 and _smem_bytes(kind, chunk, G, k, n, ep) > _SMEM_SOFT:
        chunk = _r4(chunk // 2)
    smem = _smem_bytes(kind, chunk, G, k, n, ep)
    if smem > _SMEM_MAX:
        raise ValueError(
            f"{kind} kernel: {smem} bytes of shared memory a block at the "
            f"smallest chunk exceed the card's {_SMEM_MAX} (n={n}, k={k})")
    return dict(cluster=cluster, chunk=chunk, smem=smem, blocks=blocks,
                passes=tuple((g0, min(_PASS, G - g0))
                             for g0 in range(0, G, _PASS)))


@functools.lru_cache(maxsize=256)
def _item_plan(kind, units, G, k, n=0, ep=False):
    """How the kernels sum one item, a pure function of the item's shape:
    kind "row", an item of ``units`` = C cells; "col", an item of
    ``units`` = Tb time slots of ``n`` cells each (:func:`_split_plan`,
    the cluster from :func:`_cluster_size`)."""
    return _split_plan(kind, _cluster_size(units * max(n, 1)), units, G, k,
                       n, ep)


def _launch_plan(kind, items, units, G, k, n=0, ep=False):
    """The kernels' launch plan: every item's split (:func:`_item_plan`)
    and ``grid``, the blocks of a launch of ``items`` items, the one
    number the item count sets."""
    plan = dict(_item_plan(kind, units, G, k, n, ep))
    plan["grid"] = items * plan["cluster"]
    return plan


# ----------------------------------------------------------------------
# kernel routing
# ----------------------------------------------------------------------
def _on_card(tensors, names):
    """False for CPU tensors, True for CUDA tensors; ValueError for mixed
    devices or any other device type."""
    dev = tensors[0].device
    for t, nm in zip(tensors, names):
        if t.device != dev:
            raise ValueError(f"{nm} is on {t.device}, expected {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no fused_ll path for device {dev}")
    return True


def _check_extras(extras, y):
    """() or (mu, sig), each shaped like y, as {} or {"mu": .., "sig": ..}."""
    if not extras:
        return {}
    if len(extras) != 2:
        raise ValueError("extras must be () or (mu, sig)")
    ex = dict(zip(("mu", "sig"), extras))
    for nm, t in ex.items():
        if t.shape != y.shape:
            raise ValueError(f"extras {nm} has shape {tuple(t.shape)}, "
                             f"expected y's {tuple(y.shape)}")
    return ex


def _ep_ptrs(ex):
    """The kernels' mu and sig pointers; NULL (None) without EP."""
    return (ex["mu"].data_ptr(), ex["sig"].data_ptr()) if ex else (None, None)


def _check_kernel_args(float_args, int_args, cell_fn):
    cell = as_cellfn(cell_fn)
    if cell.name not in KERNEL_CELLS:
        raise ValueError(
            f"cell function {cell.name!r} has no CUDA kernel specialisation "
            f"(compiled cells: {sorted(KERNEL_CELLS)})")
    for nm, t in float_args.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{nm} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    for nm, t in int_args.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{nm} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{nm} must be contiguous")
    return KERNEL_CELLS[cell.name]


def _raise_on(lib, code, what):
    if code != 0:
        msg = lib.fmf_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")


def fused_row_ll_batched(cands, bt, y, row_chain, row_idx, cell_fn,
                         extras=()):
    """Candidate log-likelihoods of R rows in one launch.

    cands: (R, G, k) candidates; bt: (nchains, C, k) per-chain cell
    vectors (the W update passes V.reshape(nchains, m*T, k)); y: (n, C)
    with NaN = missing; row_chain, row_idx: (R,) int32; extras: () or the
    EP (mu, sig), each (n, C). Returns (R, G) float32 with ll[r, g] =
    sum_c cell(y[row_idx[r], c], cands[r, g] . bt[row_chain[r], c]), less
    the EP log-density with extras.
    """
    names = ("cands", "bt", "y", "row_chain", "row_idx")
    if cands.dim() != 3 or bt.dim() != 3 or y.dim() != 2:
        raise ValueError("expected cands (R,G,k), bt (nchains,C,k), y (n,C)")
    R, G, k = cands.shape
    nch, C, kb = bt.shape
    if kb != k or y.shape[1] != C or row_chain.shape != (R,) \
            or row_idx.shape != (R,):
        raise ValueError(
            f"shape mismatch: cands {tuple(cands.shape)}, bt "
            f"{tuple(bt.shape)}, y {tuple(y.shape)}, row_chain "
            f"{tuple(row_chain.shape)}, row_idx {tuple(row_idx.shape)}")
    ex = _check_extras(extras, y)
    if not _on_card((cands, bt, y, row_chain, row_idx, *ex.values()),
                    names + tuple(ex)):
        return row_ll_plain(cands, bt, y, row_chain, row_idx, cell_fn,
                            tuple(ex.values()))
    cell = _check_kernel_args(
        dict(cands=cands, bt=bt, y=y, **ex),
        dict(row_chain=row_chain, row_idx=row_idx), cell_fn)
    if k > _MAX_K:
        raise ValueError(f"k={k} > {_MAX_K}, the kernel's limit")
    from functionalmf_tpu_torch.ops._build import load_library
    lib = load_library()
    mu_p, sig_p = _ep_ptrs(ex)
    name = "fused_row_ll_ep" if ex else "fused_row_ll"
    plan = _launch_plan("row", R, C, G, k, ep=bool(ex))
    out = torch.empty((R, G), dtype=torch.float32, device=cands.device)
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        code = lib.fmf_row_ll(cell, cands.data_ptr(), bt.data_ptr(),
                              y.data_ptr(), mu_p, sig_p,
                              row_chain.data_ptr(), row_idx.data_ptr(),
                              out.data_ptr(), R, G, k, C, nch, y.shape[0],
                              stream, plan["cluster"], plan["chunk"],
                              plan["smem"])
    _raise_on(lib, code, name)
    launch_counts[name] += 1
    return out


def fused_col_block_ll_batched(cands, w, y, pair_chain, pair_col, pair_t0,
                               cell_fn, extras=()):
    """Candidate log-likelihoods of P (chain, column, time block) pairs in
    one launch.

    cands: (P, G, Tb, k) block candidates; w: (nchains, n, k); y: (n, m, T)
    with NaN = missing; pair_chain, pair_col, pair_t0: (P,) int32; extras:
    () or the EP (mu, sig), each (n, m, T). Returns (P, G) float32 with
    ll[p, g] = sum_{t,i} cell(y[i, j_p, t0_p + t], cands[p, g, t] .
    w[c_p, i]), less the EP log-density with extras; time points outside
    [0, T) contribute 0.
    """
    names = ("cands", "w", "y", "pair_chain", "pair_col", "pair_t0")
    if cands.dim() != 4 or w.dim() != 3 or y.dim() != 3:
        raise ValueError(
            "expected cands (P,G,Tb,k), w (nchains,n,k), y (n,m,T)")
    P, G, Tb, k = cands.shape
    nch, n, kw = w.shape
    if kw != k or y.shape[0] != n or any(
            t.shape != (P,) for t in (pair_chain, pair_col, pair_t0)):
        raise ValueError(
            f"shape mismatch: cands {tuple(cands.shape)}, w "
            f"{tuple(w.shape)}, y {tuple(y.shape)}, pair indices "
            f"{[tuple(t.shape) for t in (pair_chain, pair_col, pair_t0)]}")
    ex = _check_extras(extras, y)
    if not _on_card((cands, w, y, pair_chain, pair_col, pair_t0,
                     *ex.values()), names + tuple(ex)):
        return col_block_ll_plain(cands, w, y, pair_chain, pair_col, pair_t0,
                                  cell_fn, tuple(ex.values()))
    cell = _check_kernel_args(
        dict(cands=cands, w=w, y=y, **ex),
        dict(pair_chain=pair_chain, pair_col=pair_col, pair_t0=pair_t0),
        cell_fn)
    if k > _MAX_K:
        raise ValueError(f"k={k} > {_MAX_K}, the kernel's limit")
    from functionalmf_tpu_torch.ops._build import load_library
    lib = load_library()
    _, m, T = y.shape
    mu_p, sig_p = _ep_ptrs(ex)
    name = "fused_col_block_ll_ep" if ex else "fused_col_block_ll"
    plan = _launch_plan("col", P, Tb, G, k, n, bool(ex))
    out = torch.empty((P, G), dtype=torch.float32, device=cands.device)
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        code = lib.fmf_col_block_ll(
            cell, cands.data_ptr(), w.data_ptr(), y.data_ptr(), mu_p, sig_p,
            pair_chain.data_ptr(), pair_col.data_ptr(), pair_t0.data_ptr(),
            out.data_ptr(), P, G, Tb, k, n, m, T, nch, stream,
            plan["cluster"], plan["chunk"], plan["smem"])
    _raise_on(lib, code, name)
    launch_counts[name] += 1
    return out


# ----------------------------------------------------------------------
# the JAX package's signatures
# ----------------------------------------------------------------------
def _zeros_idx(n, device):
    return torch.zeros(n, dtype=torch.int32, device=device)


def fused_row_ll(cands, B, y, cell_fn, extras=()):
    """ll[g] = sum_c cell_fn(y[c], (cands @ B)[g, c]), less the EP
    log-density of extras=(mu, sig).

    cands: (G, k); B: (k, C); y, mu, sig: (C,) with NaN = missing.
    Returns (G,).
    """
    idx = _zeros_idx(1, cands.device)
    return fused_row_ll_batched(
        cands[None].contiguous(), B.T[None].contiguous(),
        y[None].contiguous(), idx, idx, cell_fn,
        tuple(e[None].contiguous() for e in extras))[0]


def fused_col_block_ll(cands3, Wn, y, cell_fn, extras=()):
    """ll[g] = sum_{t,i} cell_fn(y[t, i], sum_k cands3[g, t, k] Wn[i, k]),
    less the EP log-density of extras=(mu, sig).

    cands3: (G, Tb, k); Wn: (n, k); y, mu, sig: (Tb, n) with NaN =
    missing. Returns (G,).
    """
    idx = _zeros_idx(1, cands3.device)

    def col3(x):                                             # (n, 1, Tb)
        return x.T[:, None, :].contiguous()

    return fused_col_block_ll_batched(
        cands3[None].contiguous(), Wn[None].contiguous(), col3(y), idx, idx,
        idx, cell_fn, tuple(col3(e) for e in extras))[0]
