"""Expectation-propagation (forward-KL Gaussian) approximation helpers.

Counterpart of functionalmf_tpu/utils/ep.py (reference functionalmf/
utils.py:126-190, 423-438), host numpy, re-implemented here because
importing the JAX package imports jax. Used to centre the GASS proposal
of the constrained model (``ep_approx``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["grid_ep_approx", "ep_from_mf"]


def grid_ep_approx(likelihood, ngrid=100, x_min=0, x_max=1, tol=1e-4,
                   min_space=1e-3, max_refinements=1000):
    """Gaussian moment match of a 1-D likelihood on [x_min, x_max].

    Capability parity with reference utils.py:126-190 (adaptive grid →
    (mu, sigma) of the normalized likelihood), redesigned as zoom
    quadrature: evaluate on a uniform grid, find the sub-interval holding
    the (1 - tol) central mass, re-grid onto it, and repeat until the
    window stops shrinking. Each round re-evaluates the whole uniform grid
    (vectorized) instead of inserting/deleting single points, and the final
    moments use trapezoid weights, which removes the equal-bin-width bias
    of point-mass moments around peaked likelihoods.

    `min_space` bounds the smallest window (guards against zooming to a
    degenerate interval); `max_refinements` bounds the rounds.
    """
    lo, hi = float(x_min), float(x_max)
    for _ in range(min(int(max_refinements), 64)):
        grid = np.linspace(lo, hi, ngrid)
        dens = np.asarray(likelihood(grid), dtype=float)
        total = dens.sum()
        if not np.isfinite(total) or total <= 0:
            break
        cdf = np.cumsum(dens) / total
        ilo = int(np.searchsorted(cdf, tol / 2))
        ihi = int(np.searchsorted(cdf, 1 - tol / 2))
        new_lo = grid[max(ilo - 1, 0)]
        new_hi = grid[min(ihi + 1, ngrid - 1)]
        if new_hi - new_lo < min_space:
            mid = 0.5 * (new_lo + new_hi)
            new_lo, new_hi = mid - min_space / 2, mid + min_space / 2
        # converged when the window no longer shrinks appreciably
        if (new_hi - new_lo) > 0.95 * (hi - lo):
            lo, hi = new_lo, new_hi
            break
        lo, hi = new_lo, new_hi

    grid = np.linspace(lo, hi, ngrid)
    dens = np.asarray(likelihood(grid), dtype=float)
    # trapezoid weights on the uniform grid (half-weight endpoints)
    w = np.ones(ngrid)
    w[0] = w[-1] = 0.5
    p = dens * w
    Z = p.sum()
    if not np.isfinite(Z) or Z <= 0:
        return 0.5 * (lo + hi), (hi - lo) / np.sqrt(12.0)
    p = p / Z
    mu = float((p * grid).sum())
    sigma = float(np.sqrt((p * (grid - mu) ** 2).sum()))
    return mu, sigma


def ep_from_mf(Y, W, V, mode="max", multiplier=2, verbose=True):
    """Variance-overestimating EP from a matrix-factorization fit
    (utils.py:423-438). Returns (Mu, Sigma) tensors shaped like Y[..., 0]."""
    Y = np.asarray(Y, dtype=float)
    if Y.ndim == 3:
        Y = Y[..., None]
    M = (W[:, None, None] * V[None]).sum(axis=-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        sqerr = np.nanmean((Y - M) ** 2, axis=-1)
        if mode == "max":
            overestimate = np.sqrt(np.nanmax(sqerr))
        elif mode == "multiplier":
            overestimate = np.sqrt(np.nanmean(sqerr)) * multiplier
        else:
            raise ValueError(f"unknown mode {mode!r}")
    if verbose:
        print("Estimated stdev: {}".format(overestimate))
    return M[..., 0], np.ones(Y.shape[:-1]) * overestimate
