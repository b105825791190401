"""Small metric helpers, numpy only.

Counterpart of functionalmf_tpu/utils/metrics.py (reference
functionalmf/utils.py:101-124, 440-456, 510-511): its own copy, because
importing the JAX package imports jax.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ilogit", "mse", "mae", "moving_average", "cross_entropy",
           "random_holdouts", "coverage_at"]


def ilogit(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x)))


def mse(x, y):
    """Mean squared error, NaNs masked."""
    return np.nanmean((np.asarray(x) - np.asarray(y)) ** 2)


def mae(x, y):
    """Mean absolute error, NaNs masked."""
    return np.nanmean(np.abs(np.asarray(x) - np.asarray(y)))


def moving_average(a, n=3):
    ret = np.cumsum(a, dtype=float)
    ret[n:] = ret[n:] - ret[:-n]
    return ret[n - 1:] / n


def cross_entropy(Y, Mu, axis=None):
    return np.nansum(Y * np.log(Mu) + (1 - Y) * np.log(1 - Mu), axis=axis)


def coverage_at(truth, samples, interval):
    """Coverage of the posterior credible interval, in percent."""
    lower = np.percentile(samples, (100 - interval) / 2, axis=0)
    upper = np.percentile(samples, (100 - interval) / 2 + interval, axis=0)
    return np.mean((truth >= lower) & (truth <= upper)) * 100


def random_holdouts(Y, nholdout, rng=None, verbose=True):
    """(row, col) curves to hold out, such that no row and no column is
    left empty."""
    rng = np.random.default_rng() if rng is None else rng
    if verbose:
        print("Holding out {} random curves".format(nholdout))
    options = [idx for idx in np.ndindex(Y.shape[:-2])
               if not np.all(np.isnan(Y[idx]))]

    def pick():
        sel = np.array([options[i] for i in
                        rng.choice(len(options), replace=False,
                                   size=nholdout)])
        Yc = Y.copy()
        Yc[sel[:, 0], sel[:, 1]] = np.nan
        bad = (np.any(np.all(np.isnan(Yc), axis=(1, 2, 3)))
               | np.any(np.all(np.isnan(Yc), axis=(0, 2, 3))))
        return sel, bad

    selected, invalid = pick()
    while invalid:
        selected, invalid = pick()
    return selected
