"""Block-banded Cholesky factorisation, solves and Gaussian draws.

Counterpart of functionalmf_tpu/ops/banded.py. In time-major ordering
x[(t, a)] = V[t, a] the V update's posterior precision

    Q = Q_lik + kron(I_k, Delta^T Lam Delta)

is block-banded: the diagonal blocks are G_t + DtLD[t, t] I_k (G_t the
k x k likelihood Gram at depth t) and the d-th sub-diagonal blocks are
DtLD[t, t-d] I_k, with half-bandwidth p = tf_order + 1.

Layout: ``bands[..., t, d, :, :]`` = block (t, t-d), d = 0..p; entries
with d > t are zero. Every function broadcasts over leading batch axes.

The JAX package's ``lax.scan`` over the block rows is a Python loop here,
each step a handful of batched ``torch.linalg`` calls over all leading
axes (chains and columns), and the same code runs on the CPU and on the
card. Nothing inside a loop reads a value back to the host: the pivot
guard's rung index and the repair counts stay tensors. Matrix products
need full float32 (``_runtime.require_full_f32`` turns TF32 off): at the
horseshoe's dynamic range a reduced-precision Schur complement flips
near-singular pivots indefinite.

Not ported: ``chain_reduced_pred`` and ``_mm_f32`` (the port batches
chains as a leading axis and sets the matmul precision once).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from functionalmf_tpu_torch.utils import telemetry

__all__ = [
    "build_v_bands",
    "block_banded_matvec",
    "slice_bands",
    "block_to_dense",
    "bands_to_dense",
    "equilibrate_bands",
    "retile_bands",
    "block_banded_cholesky",
    "block_banded_solve_lower",
    "block_banded_solve_upper",
    "block_banded_solve",
    "sample_mvn_block_banded",
    "sample_mvn_block_banded_retiled",
]


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _tsolve_right(Lcc, S):
    """X such that X Lcc^T = S (Lcc lower-triangular)."""
    return torch.linalg.solve_triangular(Lcc.mT, S, upper=True, left=False)


def build_v_bands(DtLD, G, p: int):
    """Assemble the V-update precision bands.

    DtLD: (..., T, T) trend-filtering Gram (half-bandwidth p); G:
    (..., T, k, k) per-depth likelihood Gram, or None for the prior-only
    precision. Returns bands (..., T, p+1, k, k).
    """
    k = G.shape[-1] if G is not None else 1
    eye = _eye(k, DtLD)
    cols = []
    for d in range(p + 1):
        diag = torch.diagonal(DtLD, offset=-d, dim1=-2, dim2=-1)
        diag = F.pad(diag, (d, 0))     # entry t is block (t, t-d)
        cols.append(diag[..., :, None, None] * eye)
    bands = torch.stack(cols, dim=-3)
    if G is not None:
        bands[..., :, 0, :, :] += G
    return bands


def block_banded_matvec(bands, x):
    """y = Q x for block-banded symmetric Q; x (..., T, k) -> (..., T, k)."""
    T, p = bands.shape[-4], bands.shape[-3] - 1
    y = torch.einsum("...tij,...tj->...ti", bands[..., :, 0, :, :], x)
    for d in range(1, min(p, T - 1) + 1):
        blk = bands[..., d:, d, :, :]          # blocks (t, t-d) for t >= d
        lo = torch.einsum("...tij,...tj->...ti", blk, x[..., : T - d, :])
        hi = torch.einsum("...tji,...tj->...ti", blk, x[..., d:, :])
        y = y + F.pad(lo, (0, 0, d, 0)) + F.pad(hi, (0, 0, 0, d))
    return y


def slice_bands(bands, start: int, size: int):
    """The principal block-banded submatrix of time block [start,
    start+size): entries that refer to rows before ``start`` are zeroed
    (the cross term is the caller's)."""
    p1 = bands.shape[-3]
    sub = bands[..., start:start + size, :, :, :].clone()
    t = torch.arange(size, device=bands.device)
    for d in range(1, p1):
        sub[..., :, d, :, :] *= (t >= d).to(bands.dtype)[:, None, None]
    return sub


def block_to_dense(bands, start: int, size: int):
    """Dense (..., size*k, size*k) principal submatrix of time block
    [start, start+size)."""
    *batch, T, p1, k, _ = bands.shape
    p = p1 - 1
    Q = bands.new_zeros(tuple(batch) + (size, k, size, k))
    for tl in range(size):
        t = start + tl
        for d in range(min(p, tl) + 1):
            blk = bands[..., t, d, :, :]
            Q[..., tl, :, tl - d, :] = blk
            if d > 0:
                Q[..., tl - d, :, tl, :] = blk.mT
    return Q.reshape(tuple(batch) + (size * k, size * k))


def bands_to_dense(bands):
    """Dense (..., T*k, T*k) reconstruction (for tests)."""
    return block_to_dense(bands, 0, bands.shape[-4])


def equilibrate_bands(bands):
    """Block-Jacobi equilibration Q' = D Q D, D = diag(Q)^(-1/2).

    Returns (bands', s) with s (..., T, k); undo a draw with x = s * x'.
    Keeps the horseshoe's wide diagonal range factorisable in float32.
    """
    p1 = bands.shape[-3]
    diag = torch.diagonal(bands[..., :, 0, :, :], dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.where(diag > 0, diag, torch.ones_like(diag)))
    t = torch.arange(s.shape[-2], device=bands.device)
    scaled = []
    for d in range(p1):
        s_shift = torch.roll(s, d, dims=-2)      # s_{t-d}
        if d > 0:
            s_shift = s_shift * (t >= d).to(s.dtype)[:, None]
        scaled.append(bands[..., :, d, :, :] * s[..., :, :, None]
                      * s_shift[..., :, None, :])
    return torch.stack(scaled, dim=-3), s


def retile_bands(bands, B: int):
    """Re-tile a block-banded system into super-blocks of B time steps.

    Returns (bands2, T2): a block-tridiagonal system (half-bandwidth 1)
    with (B*k, B*k) dense blocks, zero-padded to T2 = ceil(T / B)
    super-rows (the padding gets identity diagonals). The factor and solve
    loops then take T2 steps instead of T. Requires B >= p.
    """
    *batch, T, p1, k, _ = bands.shape
    p = p1 - 1
    assert B >= p, (B, p)
    T2 = -(-T // B)
    Tp = T2 * B
    bpad = F.pad(bands, (0, 0, 0, 0, 0, 0, 0, Tp - T))
    if Tp > T:
        # identity diagonal blocks on the padded tail keep the factor finite
        bpad[..., T:, 0, :, :] += _eye(k, bands)
    br = bpad.reshape(tuple(batch) + (T2, B, p1, k, k))
    D = bands.new_zeros(tuple(batch) + (T2, B, k, B, k))
    E = bands.new_zeros(tuple(batch) + (T2, B, k, B, k))
    for d in range(p + 1):
        for i in range(B):
            j = i - d
            blk = br[..., :, i, d, :, :]
            if j >= 0:
                D[..., :, i, :, j, :] = blk
                if d > 0:
                    D[..., :, j, :, i, :] = blk.mT
            else:
                # couples into the previous super-block at local column B + j
                E[..., 1:, i, :, B + j, :] = blk[..., 1:, :, :]
    Bk = B * k
    D = D.reshape(tuple(batch) + (T2, Bk, Bk))
    E = E.reshape(tuple(batch) + (T2, Bk, Bk))
    return torch.stack([D, E], dim=-3), T2


# ----------------------------------------------------------------------
# factorisation
# ----------------------------------------------------------------------
def _chol_pivot_guarded(S, rungs=(1e-2,)):
    """Cholesky of a diagonal block with per-batch-element pivot repair.

    The block is factored at every rung at once: as it is, with each
    relative jitter of ``rungs`` (times the mean absolute diagonal), and
    with a Gershgorin shift (S + g I, g above the largest absolute row
    sum, is diagonally dominant and so always factors). Each batch
    element takes the first rung whose factor succeeded: ``cholesky_ex``
    reports a failed factorisation in ``info`` and leaves a partial factor
    that may be finite, so a rung counts only with ``info == 0`` and a
    finite factor. An element with no good rung (non-finite input) gets a
    NaN factor. No host sync: the rung index stays on the device.

    Returns (L, repaired, gershgorin): ``repaired`` flags the elements
    that needed any jitter rung, ``gershgorin`` those that fell through
    to the dominance shift, a materially perturbed conditional. Callers
    surface the counts so that a repair is never silent.
    """
    eye = _eye(S.shape[-1], S)
    S = 0.5 * (S + S.mT)
    scale = torch.diagonal(S, dim1=-2, dim2=-1).abs().mean(-1)
    scale = scale.clamp_min(1e-30)[..., None, None]
    g = S.abs().sum(-1).amax(-1)[..., None, None]
    shifts = [torch.zeros_like(scale)]
    shifts += [r * scale for r in rungs]
    shifts += [1.001 * g + 1e-6 * scale]
    Ls, info = torch.linalg.cholesky_ex(
        torch.stack([S + d * eye for d in shifts]), check_errors=False)
    ok = (info == 0) & torch.isfinite(Ls).all(-1).all(-1)     # (R, *batch)
    idx = ok.to(torch.int32).argmax(0)            # first good rung
    L = torch.gather(Ls, 0, idx[None, ..., None, None].expand(
        (1,) + Ls.shape[1:]))[0]
    good = torch.gather(ok, 0, idx[None])[0]
    L = torch.where(good[..., None, None], L, torch.nan)
    repaired = (idx > 0).to(S.dtype)
    gershgorin = (idx == len(shifts) - 1).to(S.dtype)
    return L, repaired, gershgorin


def _block_banded_cholesky_once(bands, jitter=0.0):
    *batch, T, p1, k, _ = bands.shape
    p = p1 - 1
    eyek = _eye(k, bands)
    # jitter: a float, or a tensor that broadcasts against the (..., T, k,
    # k) diagonal blocks (relative jitter)
    if not (isinstance(jitter, (int, float)) and jitter == 0):
        bands = bands.clone()
        bands[..., :, 0, :, :] += jitter * eyek

    # window[r] = factor row t-1-r, blocks d = 0..p; rows before the first
    # hold identity diagonals, so the triangular solves pass zeros through
    virtual = bands.new_zeros(tuple(batch) + (p1, k, k))
    virtual[..., 0, :, :] = eyek
    window = [virtual] * p
    rows, repaired, gersh = [], 0.0, 0.0
    for t in range(T):
        B_t = bands[..., t, :, :, :]
        row = [None] * p1
        # off-diagonal blocks, leftmost column first (d = p..1)
        for d in range(p, 0, -1):
            S = B_t[..., d, :, :]
            # less L[t, kcol] L[c, kcol]^T for kcol < c = t-d
            for dd in range(p, d, -1):
                S = S - row[dd] @ window[d - 1][..., dd - d, :, :].mT
            row[d] = _tsolve_right(window[d - 1][..., 0, :, :], S)
        S = B_t[..., 0, :, :]
        for d in range(1, p1):
            S = S - row[d] @ row[d].mT
        row[0], rep, ger = _chol_pivot_guarded(S)
        row_stack = torch.stack(row, dim=-3)
        if p > 0:
            window = [row_stack] + window[:p - 1]
        rows.append(row_stack)
        repaired = repaired + rep
        gersh = gersh + ger
    return torch.stack(rows, dim=-4), repaired, gersh


def block_banded_cholesky(bands, jitter=0.0, psd_attempts: int = 3,
                          psd_eps: float = 1e-4,
                          return_repairs: bool = False):
    """Lower block-banded Cholesky factor L, in the bands' layout.

    A loop over the block rows; every diagonal pivot goes through
    ``_chol_pivot_guarded``, which repairs an indefinite block where it
    stands and yields a finite factor for finite input. So the
    ``psd_attempts`` ladder (growing jitter on the whole diagonal, taken
    by the batch elements whose factor is not finite) is a backstop for
    non-finite input only; it costs one host sync a call, none with
    ``psd_attempts=0``. With ``return_repairs`` the result is (L,
    repaired, gershgorin), the counts of repaired pivots per batch
    element (of the first factorisation).
    """
    L, repaired, gersh = _block_banded_cholesky_once(bands, jitter)
    if psd_attempts > 0:
        eyek = _eye(bands.shape[-1], bands)
        # jitter relative to the diagonal's scale: (*batch, 1, 1, 1)
        dscale = torch.diagonal(bands[..., :, 0, :, :], dim1=-2,
                                dim2=-1).abs().mean((-2, -1),
                                                    keepdim=True)[..., None]
        for a in range(psd_attempts):
            telemetry.count("sync:banded_chol")
            if bool(torch.isfinite(L).all()):
                break
            bad = ~torch.isfinite(L).all(-1).all(-1).all(-1).all(
                -1)[..., None, None, None, None]
            bands_j = bands.clone()
            bands_j[..., :, 0, :, :] += (psd_eps * 100.0 ** a) * dscale * eyek
            Lr, _, _ = _block_banded_cholesky_once(bands_j, jitter)
            L = torch.where(bad, Lr, L)
    if return_repairs:
        return L, repaired, gersh
    return L


# ----------------------------------------------------------------------
# solves
# ----------------------------------------------------------------------
def block_banded_solve_lower(L, b):
    """Solve L z = b with L block-banded lower; b (..., T, k)."""
    T, p1 = L.shape[-4], L.shape[-3]
    z = []
    for t in range(T):
        s = b[..., t, :, None]
        for d in range(1, min(p1 - 1, t) + 1):
            s = s - L[..., t, d, :, :] @ z[t - d]
        z.append(torch.linalg.solve_triangular(L[..., t, 0, :, :], s,
                                               upper=False))
    return torch.cat(z, dim=-1).mT


def block_banded_solve_upper(L, b):
    """Solve L^T x = b; b (..., T, k). Runs backwards:
    x_t = L[t, t]^-T (b_t - sum_d L[t+d, d]^T x_{t+d})."""
    T, p1 = L.shape[-4], L.shape[-3]
    x = [None] * T
    for t in range(T - 1, -1, -1):
        s = b[..., t, :, None]
        for d in range(1, min(p1 - 1, T - 1 - t) + 1):
            s = s - L[..., t + d, d, :, :].mT @ x[t + d]
        x[t] = torch.linalg.solve_triangular(L[..., t, 0, :, :].mT, s,
                                             upper=True)
    return torch.cat(x, dim=-1).mT


def block_banded_solve(L, b):
    """Solve (L L^T) x = b."""
    return block_banded_solve_upper(L, block_banded_solve_lower(L, b))


# ----------------------------------------------------------------------
# Gaussian draws
# ----------------------------------------------------------------------
def sample_mvn_block_banded(gen, bands=None, mu_part=None, L=None,
                            jitter=0.0, equilibrate: bool = False,
                            psd_attempts: int = 3,
                            return_repairs: bool = False, z=None):
    """theta ~ N(Q^-1 mu_part, Q^-1) for block-banded Q (or its factor L):
    x = L^-T (z + L^-1 mu_part), as the dense ``sample_mvn_from_precision``.

    Returns (..., T, k), or (x, repaired, gershgorin) with
    ``return_repairs`` (needs bands, not L). ``z`` (..., T, k) injects the
    standard-normal draw; otherwise it comes from ``gen``.
    """
    if equilibrate and L is None:
        bands, s = equilibrate_bands(bands)
        mp = None if mu_part is None else mu_part * s
        out = sample_mvn_block_banded(gen, bands, mu_part=mp, jitter=jitter,
                                      psd_attempts=psd_attempts,
                                      return_repairs=return_repairs, z=z)
        if return_repairs:
            return out[0] * s, out[1], out[2]
        return out * s
    repaired = gersh = None
    if L is None:
        L, repaired, gersh = block_banded_cholesky(
            bands, jitter=jitter, psd_attempts=psd_attempts,
            return_repairs=True)
    if z is None:
        z = torch.randn(L.shape[:-3] + L.shape[-1:], generator=gen,
                        dtype=L.dtype, device=L.device)
    if mu_part is not None:
        z = z + block_banded_solve_lower(L, mu_part)
    x = block_banded_solve_upper(L, z)
    if return_repairs:
        assert repaired is not None, "return_repairs requires bands, not L"
        return x, repaired, gersh
    return x


def retiled_noise_shape(T: int, p1: int, k: int, B: int = 32):
    """The shape (T2, B' k) of the standard normals that
    ``sample_mvn_block_banded_retiled`` draws a batch element, for T time
    steps of k, p1 - 1 off-diagonal bands and super-blocks of B."""
    B = min(max(B, p1 - 1), max(T, 1))
    return (-(-T // B), B * k)


def sample_mvn_block_banded_retiled(gen, bands, mu_part=None, B: int = 32,
                                    equilibrate: bool = True,
                                    base_jitter: float = 1e-4,
                                    return_repairs: bool = False, z=None,
                                    z_tiled=None):
    """theta ~ N((Q + eps I)^-1 mu_part, (Q + eps I)^-1) through
    super-block retiling.

    bands: (..., T, p+1, k, k); returns (..., T, k). The retiled system
    is the same matrix. With ``equilibrate`` a ``base_jitter`` * I is
    added to the equilibrated (unit-diagonal) system up front, so the
    draw comes from a slightly regularised conditional, as in the JAX
    package; without it the jitter is scaled by the mean absolute
    diagonal.

    No retries: indefinite pivots are repaired inside the factor loop
    (``_chol_pivot_guarded``) and counted; ``return_repairs`` gives
    (x, repaired, gershgorin) per batch element. ``z`` (..., T, k)
    injects the standard-normal draw; ``z_tiled`` (...,) +
    ``retiled_noise_shape(...)`` injects it in the retiled layout, as it
    is drawn here.
    """
    *batch, T, p1, k, _ = bands.shape
    if equilibrate:
        bands, s = equilibrate_bands(bands)
        mp = None if mu_part is None else mu_part * s
        out = sample_mvn_block_banded_retiled(
            gen, bands, mu_part=mp, B=B, equilibrate=False,
            base_jitter=base_jitter, return_repairs=return_repairs, z=z,
            z_tiled=z_tiled)
        if return_repairs:
            return out[0] * s, out[1], out[2]
        return out * s
    diag = torch.diagonal(bands[..., :, 0, :, :], dim1=-2, dim2=-1).abs()
    dscale = diag.mean().clamp_min(1e-30)
    B = min(max(B, p1 - 1), max(T, 1))
    bands2, T2 = retile_bands(bands, B)
    pad = T2 * B - T

    def tile(v):
        return F.pad(v, (0, 0, 0, pad)).reshape(tuple(batch) + (T2, B * k))

    if z_tiled is not None:
        z = z_tiled
    elif z is None:
        z = torch.randn(tuple(batch) + (T2, B * k), generator=gen,
                        dtype=bands.dtype, device=bands.device)
    else:
        z = tile(z)
    out = sample_mvn_block_banded(
        gen, bands2, mu_part=None if mu_part is None else tile(mu_part),
        jitter=base_jitter * dscale, psd_attempts=0, return_repairs=True,
        z=z)
    x = out[0].reshape(tuple(batch) + (T2 * B, k))[..., :T, :]
    if return_repairs:
        return x, out[1], out[2]
    return x
