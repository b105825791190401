"""Frozen copy of the GDELT-shaped count generator of bench.py:138-150.

A rank-k positive truth (W lower-triangular, V over columns and weeks),
Poisson counts, a share of the (row, column) curves held out as NaN, then
a warm start W0, V0 near the truth's scale, all from one generator in this
order. Kept here so that a change to the program cannot change what the
benchmark feeds it.
"""
import numpy as np


def make_data(rng, nrows, ncols, ndepth, nembeds, holdout=0.1):
    """Returns dict(Y, W0, V0, rate): Y (n, m, T) float with NaN at the
    held-out curves, the warm start and the true rate W V^T."""
    k = nembeds
    W = np.abs(rng.normal(1, 0.3, size=(nrows, k)))
    W[np.triu_indices(k, k=1)] = 0
    V = np.abs(rng.normal(1, 0.3, size=(ncols, ndepth, k)))
    rate = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(rate).astype(float)
    hold = rng.random((nrows, ncols)) < holdout
    Y[hold] = np.nan
    W0 = np.abs(rng.normal(1, 0.2, size=(nrows, k)))
    W0[np.triu_indices(k, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(ncols, ndepth, k)))
    return dict(Y=Y, W0=W0, V0=V0, rate=rate)


def ep_at_rate(rate, offset):
    """EP centres at the true rate, sigma sqrt(rate) + offset (wide enough
    not to hold the chain)."""
    return rate, np.sqrt(rate) + offset
