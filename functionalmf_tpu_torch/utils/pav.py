"""Pool-adjacent-violators (PAV) monotone projections.

Counterpart of functionalmf_tpu/utils/pav.py (reference functionalmf/
utils.py:218-252, 458-492), host numpy, re-implemented here because
importing the JAX package imports jax. ``pav`` runs in the native host
library (``utils/native.py``), as the JAX package's does when its library
is built; ``_pav_numpy`` is its plain version. ``tensor_nmf(monotone=True)``
calls ``factor_pav``.
"""
from __future__ import annotations

import numpy as np

from functionalmf_tpu_torch.utils import native

__all__ = ["pav", "factor_pav"]


def _pav_numpy(y):
    """Monotone-increasing PAV smoothing (utils.py:458-492 semantics),
    stack-based and linear-time."""
    y = np.asarray(y, dtype=float)
    if y.ndim != 1:
        raise ValueError(f"pav takes a 1-d array, got shape {y.shape}")
    n = len(y)
    vals = np.empty(n)
    wts = np.empty(n)
    idx = np.empty(n, dtype=int)
    top = 0
    for i in range(n):
        vals[top] = y[i]
        wts[top] = 1.0
        idx[top] = i
        top += 1
        while top > 1 and vals[top - 2] > vals[top - 1]:
            w = wts[top - 2] + wts[top - 1]
            vals[top - 2] = (wts[top - 2] * vals[top - 2]
                             + wts[top - 1] * vals[top - 1]) / w
            wts[top - 2] = w
            top -= 1
    out = np.empty(n)
    start = 0
    for b in range(top):
        end = idx[b + 1] if b + 1 < top else n
        out[start:end] = vals[b]
        start = end
    return out


def pav(y):
    """Monotone-increasing smoothing of y (utils.py:458-492), in the
    native host library."""
    return native.pav(y)


def factor_pav(W, V, in_place=False):
    """Pool rows of V until every row of W @ V^T is monotone decreasing
    (utils.py:218-252). V is (ncols, nembeds) here — the per-curve slice
    V[j] of the 3-tensor, matching the reference call sites
    (utils.py:381, doseresponse/fit.py:366-374)."""
    if not in_place:
        V = np.copy(V)
    M = W.dot(V.T)
    violators = (M[:, :-1] - M[:, 1:]) < 0
    q = np.arange(V.shape[0])
    while np.any(violators):
        j = 0
        while j < V.shape[0] - 1:
            M_j = W.dot(V[j:j + 2].T)
            if np.any((M_j[:, 0] - M_j[:, 1]) < 0):
                pool0 = q == q[j]
                pool1 = q == q[j + 1]
                w0 = pool0.sum()
                w1 = pool1.sum()
                V[pool0 | pool1] = (w0 * V[j] + w1 * V[j + 1]) / (w0 + w1)
                q[pool1] = q[j]
                j += w1
            else:
                j += 1
        M = W.dot(V.T)
        violators = (M[:, :-1] - M[:, 1:]) < 0
    return V
