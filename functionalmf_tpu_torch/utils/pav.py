"""Pool-adjacent-violators (PAV) monotone projection of factor curves.

Counterpart of functionalmf_tpu/utils/pav.py (reference functionalmf/
utils.py:218-252, 458-492), host numpy, re-implemented here because
importing the JAX package imports jax. ``tensor_nmf(monotone=True)``
calls ``factor_pav``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["factor_pav"]


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
