"""Nonnegative tensor factorization warm-start.

Counterpart of functionalmf_tpu/utils/nmf.py (reference functionalmf/
utils.py:276-420), host numpy, re-implemented here because importing the
JAX package imports jax: masked-ALS with a lower-triangular W and the
optional monotone (PAV) projection. Every least-squares subproblem is
k-dimensional, so its Gram matrix and moment vector are assembled for all
subproblems at once with einsums and each is solved by the Gram-form
Lawson-Hanson NNLS in numpy (the JAX package's fallback when its native
host library is absent).
"""
from __future__ import annotations

import numpy as np

__all__ = ["tensor_nmf"]

_FLOOR = 1e-3  # strict-positivity floor applied to every solve (keeps the
# warm start strictly feasible for positivity-constrained models)
_MAX_STEPS = 30  # ALS steps at most
_TOL = 1e-4      # stop when the fit error drops by at most this fraction


def _nnls_gram_one(G, f, tol_scale=1e-11):
    """Gram-form Lawson-Hanson NNLS: argmin_{x>=0} 1/2 x'Gx - f'x (numpy)."""
    n = G.shape[0]
    x = np.zeros(n)
    passive = np.zeros(n, dtype=bool)
    gmax = max(np.abs(np.diag(G)).max(), 1.0)
    tol = tol_scale * gmax * n
    for _ in range(3 * n + 30):
        w = f - G @ x
        w[passive] = -np.inf
        j = int(np.argmax(w))
        if not np.isfinite(w[j]) or w[j] <= tol:
            return x
        passive[j] = True
        for _ in range(3 * n + 30):
            idx = np.nonzero(passive)[0]
            try:
                z = np.linalg.solve(G[np.ix_(idx, idx)], f[idx])
            except np.linalg.LinAlgError:
                z, *_ = np.linalg.lstsq(G[np.ix_(idx, idx)], f[idx],
                                        rcond=None)
            if (z > 0).all():
                x[:] = 0.0
                x[idx] = z
                break
            neg = z <= 0
            alpha = np.min(x[idx[neg]] / np.maximum(x[idx[neg]] - z[neg],
                                                    1e-300))
            x[idx] += alpha * (z - x[idx])
            drop = x[idx] <= tol
            x[idx[drop]] = 0.0
            passive[idx[drop]] = False
            if not passive.any():
                break
    return x


def _nnls_gram_batch(G, F):
    """(nb, k, k), (nb, k) -> (nb, k) nonnegative solutions."""
    return np.stack([_nnls_gram_one(G[i], F[i]) for i in range(len(F))])


def _solve_block(G, F, ndims=None):
    """Batched masked-dimension NNLS with the positivity floor.

    ndims: optional (nb,) active dimension counts (lower-triangular W).
    Inactive coordinates are excluded by giving them a unit diagonal and a
    negative moment (their KKT multiplier keeps them at exactly 0), so one
    batched call covers every row.
    """
    G = np.ascontiguousarray(G, dtype=np.float64)
    F = np.ascontiguousarray(F, dtype=np.float64)
    nb, k = F.shape
    active = np.ones((nb, k), dtype=bool)
    if ndims is not None:
        active = np.arange(k)[None, :] < np.asarray(ndims)[:, None]
        inact = ~active
        eye = np.eye(k, dtype=np.float64)
        G = np.where((inact[:, :, None] | inact[:, None, :]),
                     eye[None], G)
        F = np.where(inact, -1.0, F)
    X = _nnls_gram_batch(G, F)
    return np.where(active, np.clip(X, _FLOOR, np.inf), 0.0)


def tensor_nmf(Y, nembeds, monotone=False, rng=None):
    """Masked-ALS nonnegative factorization of Y (n, m, T[, r]) from a
    gamma(1, 1) draw of W then V, 30 steps at most, stopping when the
    relative drop of the fit error is at most 1e-4 (the JAX package's
    defaults): returns (W, V), W (n, k) lower-triangular, V (m, T, k),
    both >= 1e-3 where active. functionalmf_tpu/utils/nmf.py:tensor_nmf
    without its ``max_entry`` cap and ``row_features`` coupling (not ported
    yet) and without the knobs no caller sets (given W/V, fit_W/fit_V,
    max_steps, tol, verbose)."""
    from functionalmf_tpu_torch.utils.pav import factor_pav

    rng = np.random.default_rng() if rng is None else rng
    Y = np.asarray(Y, dtype=float)
    if Y.ndim == 3:
        Y = Y[..., None]
    n, m, T, _ = Y.shape
    k = int(nembeds)

    W = rng.gamma(1, 1, size=(n, k))
    if n > 1:
        W[np.triu_indices(k, k=1)] = 0
    V = rng.gamma(1, 1, size=(m, T, k))

    # observed-replicate counts and replicate-summed data, fixed all run
    obs = ~np.isnan(Y)
    cnt = obs.sum(axis=-1).astype(float)          # (n, m, T)
    Ys = np.where(obs, Y, 0.0).sum(axis=-1)       # (n, m, T)
    ndims = np.minimum(k, np.arange(n) + 1) if n > 1 else np.full(n, k)

    rmse = np.inf
    for _ in range(_MAX_STEPS):
        prev_rmse = rmse

        # row subproblems: min over w>=0 of sum_jt cnt * (y - <V_jt, w>)^2
        G = np.einsum("ijt,jta,jtb->iab", cnt, V, V)      # (n, k, k)
        F = np.einsum("ijt,jta->ia", Ys, V)               # (n, k)
        W = _solve_block(G, F, ndims=ndims)

        # (column, depth) subproblems share W; masks differ per cell
        G = np.einsum("ijt,ia,ib->jtab", cnt, W, W)       # (m, T, k, k)
        F = np.einsum("ijt,ia->jta", Ys, W)               # (m, T, k)
        V = _solve_block(G.reshape(-1, k, k),
                         F.reshape(-1, k)).reshape(m, T, k)
        if monotone:
            for j in range(m):
                factor_pav(W, V[j], in_place=True)

        # reference's convergence metric: sqrt of the total (not mean)
        # squared error over observed cells, relative-delta stop
        rmse = np.sqrt(np.nansum(
            (Y - np.einsum("ia,jta->ijt", W, V)[..., None]) ** 2))
        delta = (prev_rmse - rmse) / rmse if rmse > 0 else 0.0
        if delta <= _TOL:
            break
    return W, V
