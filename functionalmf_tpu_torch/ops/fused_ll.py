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

_GT = 16               # candidates per block tile (kGT in the .cu file)
_MAX_K = 32
# the H100's opt-in shared memory per block (227 KB) less the column
# kernel's static reduction buffer
_MAX_TILE_BYTES = 227 * 1024 - 256
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

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
    out = torch.empty((R, G), dtype=torch.float32, device=cands.device)
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        code = lib.fmf_row_ll(cell, cands.data_ptr(), bt.data_ptr(),
                              y.data_ptr(), mu_p, sig_p,
                              row_chain.data_ptr(), row_idx.data_ptr(),
                              out.data_ptr(), R, G, k, C, nch, y.shape[0],
                              stream)
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
    if _GT * Tb * k * 4 > _MAX_TILE_BYTES:
        raise ValueError(f"block of Tb*k={Tb * k} values exceeds the "
                         "kernel's shared-memory tile")
    from functionalmf_tpu_torch.ops._build import load_library
    lib = load_library()
    _, m, T = y.shape
    mu_p, sig_p = _ep_ptrs(ex)
    name = "fused_col_block_ll_ep" if ex else "fused_col_block_ll"
    out = torch.empty((P, G), dtype=torch.float32, device=cands.device)
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        code = lib.fmf_col_block_ll(
            cell, cands.data_ptr(), w.data_ptr(), y.data_ptr(), mu_p, sig_p,
            pair_chain.data_ptr(), pair_col.data_ptr(), pair_t0.data_ptr(),
            out.data_ptr(), P, G, Tb, k, n, m, T, nch, stream)
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
