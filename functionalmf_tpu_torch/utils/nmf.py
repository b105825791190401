"""Nonnegative tensor factorization warm-start.

Counterpart of functionalmf_tpu/utils/nmf.py (reference functionalmf/
utils.py:276-420), host numpy, re-implemented here because importing the
JAX package imports jax: masked-ALS with a lower-triangular W, the
optional monotone (PAV) projection, an optional ``max_entry`` cap on the
reconstruction and optional binary row features coupled through a
nonnegative loading matrix R (then (W, V, R) comes back). Every
least-squares subproblem is k-dimensional, so its Gram matrix and moment
vector are assembled for all subproblems at once with einsums and each is
solved by the Gram-form Lawson-Hanson NNLS of the native host library
(``utils/native.py:nnls_gram_batch``), as in the JAX package;
``_nnls_gram_one`` is its plain numpy version.
"""
from __future__ import annotations

import numpy as np

from functionalmf_tpu_torch.utils.native import nnls_gram_batch

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
    return nnls_gram_batch(G, F)


def _capped_resolve(G, f, x0, cap_design, max_entry):
    """Re-solve one Gram-form LS under 0 <= cap_design @ x <= max_entry and
    x >= floor (the reference's SLSQP ``max_entry`` projection,
    utils.py:300-312, on the Gram objective)."""
    from scipy.optimize import LinearConstraint, minimize

    n = len(x0)
    lc = LinearConstraint(cap_design, 0.0, max_entry)
    res = minimize(
        lambda x: 0.5 * x @ G @ x - f @ x,
        jac=lambda x: G @ x - f,
        x0=np.clip(x0, 1e-6, None),
        bounds=[(1e-6, None)] * n,
        constraints=[lc],
        method="SLSQP",
        options={"ftol": 1e-10, "maxiter": 500},
    )
    return res.x


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


def tensor_nmf(Y, nembeds, max_steps=_MAX_STEPS, monotone=False,
               tol=_TOL, verbose=False, max_entry=None,
               W=None, V=None, fit_W=True, fit_V=True,
               row_features=None, rng=None):
    """Masked-ALS nonnegative factorization of Y (n, m, T[, r]) from a
    gamma(1, 1) draw of W then V (then R) unless ``W`` / ``V`` are given,
    ``max_steps`` steps at most, stopping when the relative drop of the
    fit error is at most ``tol``: returns (W, V), W (n, k)
    lower-triangular, V (m, T, k), both >= 1e-3 where active; with
    ``row_features`` (n, p) (NaN = missing) returns (W, V, R), R (p, k)
    the features' nonnegative loadings, coupled into the row updates.
    ``fit_W`` / ``fit_V`` False keep that factor as given (or drawn).
    ``max_entry`` caps every entry of the reconstruction (and of W R^T): a
    row, cell or feature over the cap is solved again under the cap by
    SLSQP. ``verbose`` prints the fit error a step. The signature and
    defaults of functionalmf_tpu/utils/nmf.py:tensor_nmf."""
    from functionalmf_tpu_torch.utils.pav import factor_pav

    rng = np.random.default_rng() if rng is None else rng
    Y = np.asarray(Y, dtype=float)
    if Y.ndim == 3:
        Y = Y[..., None]
    n, m, T, _ = Y.shape
    k = int(nembeds)

    if W is None:
        W = rng.gamma(1, 1, size=(n, k))
        if n > 1:
            W[np.triu_indices(k, k=1)] = 0
    else:
        W = np.array(W, dtype=float)
    if V is None:
        V = rng.gamma(1, 1, size=(m, T, k))
    else:
        V = np.array(V, dtype=float)
    R = None
    if row_features is not None:
        row_features = np.asarray(row_features, dtype=float)
        R = rng.gamma(1, 1, size=(row_features.shape[1], k))
        rf_obs = ~np.isnan(row_features)
        rf_cnt = rf_obs.astype(float)
        rf_z = np.where(rf_obs, row_features, 0.0)

    # observed-replicate counts and replicate-summed data, fixed all run
    obs = ~np.isnan(Y)
    cnt = obs.sum(axis=-1).astype(float)          # (n, m, T)
    Ys = np.where(obs, Y, 0.0).sum(axis=-1)       # (n, m, T)
    ndims = np.minimum(k, np.arange(n) + 1) if n > 1 else np.full(n, k)

    rmse = np.inf
    for step in range(max_steps):
        if verbose:
            print(f"tensor_nmf step {step}")
        prev_rmse = rmse

        if fit_W:
            # row subproblems: min over w>=0 of sum_jt cnt * (y - <V_jt, w>)^2
            G = np.einsum("ijt,jta,jtb->iab", cnt, V, V)      # (n, k, k)
            F = np.einsum("ijt,jta->ia", Ys, V)               # (n, k)
            if R is not None:
                G += np.einsum("ip,pa,pb->iab", rf_cnt, R, R)
                F += np.einsum("ip,pa->ia", rf_z, R)
            W = _solve_block(G, F, ndims=ndims)
            if max_entry is not None:
                recon_max = np.einsum("ia,jta->ijt", W, V).max(axis=(1, 2))
                for i in np.nonzero(recon_max > max_entry)[0]:
                    d = ndims[i]
                    W[i, :d] = _capped_resolve(
                        G[i, :d, :d], F[i, :d], W[i, :d],
                        V[..., :d].reshape(-1, d), max_entry)

        if fit_V:
            # (column, depth) subproblems share W; masks differ per cell
            G = np.einsum("ijt,ia,ib->jtab", cnt, W, W)       # (m, T, k, k)
            F = np.einsum("ijt,ia->jta", Ys, W)               # (m, T, k)
            V = _solve_block(G.reshape(-1, k, k),
                             F.reshape(-1, k)).reshape(m, T, k)
            if max_entry is not None:
                # the reference sums the reconstruction over the rows here
                # (it takes the maximum in the row step): kept, so that
                # both packages solve the same cells again (ROADMAP.md,
                # Queue 3)
                recon_max = np.einsum("ia,jta->jt", W, V)
                for j, t in zip(*np.nonzero(recon_max > max_entry)):
                    V[j, t] = _capped_resolve(G[j, t], F[j, t], V[j, t], W,
                                              max_entry)
            if monotone:
                for j in range(m):
                    factor_pav(W, V[j], in_place=True)

        if R is not None:
            # feature subproblems: columns of row_features against W rows
            Gf = np.einsum("ip,ia,ib->pab", rf_cnt, W, W)
            Ff = np.einsum("ip,ia->pa", rf_z, W)
            R = np.where(rf_obs.any(axis=0)[:, None], _solve_block(Gf, Ff), R)
            if max_entry is not None:
                recon_max = (W @ R.T).max(axis=0)
                for p in np.nonzero(recon_max > max_entry)[0]:
                    R[p] = _capped_resolve(Gf[p], Ff[p], R[p], W, max_entry)

        # reference's convergence metric: sqrt of the total (not mean)
        # squared error over observed cells, relative-delta stop
        rmse = np.sqrt(np.nansum(
            (Y - np.einsum("ia,jta->ijt", W, V)[..., None]) ** 2))
        delta = (prev_rmse - rmse) / rmse if rmse > 0 else 0.0
        if verbose:
            print(f"  rmse {rmse:.5f} delta {delta:.2e}")
        if delta <= tol:
            break
    return (W, V) if R is None else (W, V, R)
