"""Binary (logistic) matrix factorization with a cross-validated ridge.

Counterpart of functionalmf_tpu/utils/binary_mf.py (reference
functionalmf/utils.py:494-508, 550-629), host numpy: alternate
L2-regularised logistic fits of W given V and of V given W on a 0/1
matrix with missing entries, the ridge strength chosen by K-fold CV over
the observed cells. Each half-step fits all rows (or columns) at once by
batched IRLS: the masked per-row Newton systems are k x k, so gradients
and Hessians assemble with einsums and one batched solve. ``lam`` follows
sklearn's C convention, as the reference does (penalty ||w||^2 / (2 lam):
a larger lam regularises less).
"""
from __future__ import annotations

import numpy as np

from functionalmf_tpu_torch.utils.metrics import cross_entropy, ilogit

__all__ = ["binary_mf", "logistic_regression_loss", "logistic_regression_grad"]


def _logits(X, beta):
    """X beta, plus a trailing intercept coordinate of beta if it has
    one."""
    has_icpt = len(beta) > X.shape[1]
    return X @ beta[: X.shape[1]] + (beta[-1] if has_icpt else 0.0), has_icpt


def logistic_regression_loss(X, y, lam, beta):
    """Mean logistic NLL + lam * ||beta||^2; an optional trailing intercept
    coordinate is unpenalised (reference utils.py:494-498)."""
    z, _ = _logits(X, beta)
    p = np.clip(ilogit(z), 1e-6, 1 - 1e-6)
    nll = -(y * np.log(p) + (1 - y) * np.log1p(-p)).mean()
    return nll + lam * (beta[: X.shape[1]] ** 2).sum()


def logistic_regression_grad(X, y, lam, beta):
    """Gradient of logistic_regression_loss (reference utils.py:500-508:
    the coefficient block uses sum-scale residuals, the intercept the
    mean)."""
    z, has_icpt = _logits(X, beta)
    r = np.clip(ilogit(z), 1e-6, 1 - 1e-6) - y
    g = np.empty_like(beta)
    g[: X.shape[1]] = X.T @ r + lam * beta[: X.shape[1]]
    if has_icpt:
        g[-1] = r.mean()
    return g


def _irls_half_step(F, Y, mask, lam, n_newton=25, clip=30.0):
    """Ridge-logistic fits of every column c of Y on the design F over the
    rows where mask[:, c]: ncols k-dimensional problems in one batched
    Newton iteration. Returns (ncols, k). Penalty ||coef||^2 / (2 lam)."""
    k = F.shape[1]
    Yz = np.where(mask, Y, 0.0)
    C = np.zeros((Y.shape[1], k))
    eye = np.eye(k)
    for _ in range(n_newton):
        p = ilogit(np.clip(F @ C.T, -clip, clip))       # (nr, nc)
        r = np.where(mask, p - Yz, 0.0)
        g = r.T @ F + C / lam                           # (nc, k)
        w = np.where(mask, p * (1 - p), 0.0)            # (nr, nc)
        H = np.einsum("rc,ra,rb->cab", w, F, F) + eye[None] / lam
        step = np.linalg.solve(H, g[..., None])[..., 0]
        C -= step
        if np.abs(step).max() < 1e-8:
            break
    return C


def binary_mf(Y, nembeds=None, lam=None, lams=30, cv=5, max_steps=30,
              tol=1e-4, verbose=False, rng=None):
    """Logistic MF of a 0/1 matrix with NaN missingness; returns (W, V).

    With ``lam=None`` the ridge strength is chosen from ``lams`` (a count
    for a log grid over [1e-2, 1], or an array) by ``cv``-fold CV on the
    observed cells, scored by held-out log-likelihood (higher is better,
    reference utils.py:589-607)."""
    rng = np.random.default_rng() if rng is None else rng
    Y = np.asarray(Y, dtype=float)
    obs = ~np.isnan(Y)

    if lam is None:
        if isinstance(lams, int):
            lams = np.exp(np.linspace(np.log(1e-2), np.log(1.0), lams))
        cells = np.argwhere(obs)
        perm = rng.permutation(len(cells))
        scores = np.zeros((len(lams), cv))
        for fold in range(cv):
            test = cells[perm[fold::cv]]
            Y_train = Y.copy()
            Y_train[test[:, 0], test[:, 1]] = np.nan
            for li, cur in enumerate(lams):
                W, V = binary_mf(Y_train, nembeds, lam=cur, rng=rng,
                                 max_steps=max_steps, tol=tol)
                P = ilogit(W @ V.T)
                scores[li, fold] = cross_entropy(
                    Y[test[:, 0], test[:, 1]],
                    np.clip(P[test[:, 0], test[:, 1]], 1e-6, 1 - 1e-6))
            if verbose:
                print(f"binary_mf CV fold {fold + 1}/{cv} done")
        best = float(lams[int(np.argmax(scores.mean(axis=1)))])
        if verbose:
            print(f"binary_mf best lam: {best:.6f}")
        return binary_mf(Y, nembeds, lam=best, rng=rng,
                         max_steps=max_steps, tol=tol, verbose=verbose)

    n, m = Y.shape
    W = rng.normal(0, 1 / np.sqrt(nembeds), size=(n, nembeds))
    V = rng.normal(0, 1 / np.sqrt(nembeds), size=(m, nembeds))
    Yz = np.where(obs, Y, 0.5)
    prev = -np.inf
    for step in range(max_steps):
        # all rows given V, then all columns given W
        W = _irls_half_step(V, Yz.T, obs.T, lam)
        V = _irls_half_step(W, Yz, obs, lam)
        ll = cross_entropy(np.where(obs, Y, np.nan),
                           np.clip(ilogit(W @ V.T), 1e-6, 1 - 1e-6))
        if verbose:
            print(f"binary_mf step {step}: loglik {ll:.5f}")
        if ll - prev < tol and step > 0:
            break
        prev = ll
    return W, V
