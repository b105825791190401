"""Trend-filtering penalty matrices, numpy only.

Counterpart of functionalmf_tpu/ops/penalty.py:33-138. Re-implemented
rather than imported: importing any module of ``functionalmf_tpu`` runs
its ``__init__``, which imports jax, and this package never does.
"""
from __future__ import annotations

import numpy as np

__all__ = ["first_difference_matrix", "get_delta", "bayes_delta",
           "hypercube_edges", "matrix_from_edges", "grid_penalty_matrix",
           "bayes_grid_penalty", "num_penalty_rows", "penalty_half_bandwidth"]


def first_difference_matrix(n: int) -> np.ndarray:
    """(n-1, n) rows [-1, 1] on adjacent entries."""
    if n < 2:
        raise ValueError("need at least 2 grid points")
    D = np.zeros((n - 1, n))
    idx = np.arange(n - 1)
    D[idx, idx] = -1.0
    D[idx, idx + 1] = 1.0
    return D


def get_delta(D: np.ndarray, k: int) -> np.ndarray:
    """k-th order trend-filtering matrix: D, D^T D, D D^T D, ..."""
    if k < 0:
        raise ValueError("k must be at least 0th order.")
    result = D
    for i in range(k):
        result = D.T @ result if i % 2 == 0 else D @ result
    return result


def bayes_delta(D: np.ndarray, K: int, anchor: int = 0) -> np.ndarray:
    """An anchor row e_anchor stacked on the 0..K order operators."""
    rows = [np.zeros((1, D.shape[1]))]
    rows[0][0, anchor] = 1.0
    for k in range(K + 1):
        rows.append(get_delta(D, k))
    return np.concatenate(rows, axis=0)


def hypercube_edges(dims) -> list:
    edges = []
    nodes = np.arange(int(np.prod(dims))).reshape(dims)
    for i, d in enumerate(dims):
        for j in range(d - 1):
            a = np.take(nodes, [j], axis=i).flatten()
            b = np.take(nodes, [j + 1], axis=i).flatten()
            edges.extend(zip(a.tolist(), b.tolist()))
    return edges


def matrix_from_edges(edges) -> np.ndarray:
    """Dense oriented incidence matrix; an edge may carry a weight."""
    max_col = max(max(e[0], e[1]) for e in edges)
    D = np.zeros((len(edges), max_col + 1))
    for i, edge in enumerate(edges):
        s, t = edge[0], edge[1]
        w = 1.0 if len(edge) == 2 else edge[2]
        D[i, min(s, t)] = w
        D[i, max(s, t)] = -w
    return D


def grid_penalty_matrix(dims, k: int) -> np.ndarray:
    """Graph trend-filtering penalty over a hypercube grid
    (utils.py:51-54)."""
    return get_delta(matrix_from_edges(hypercube_edges(dims)), k)


def bayes_grid_penalty(dims, k: int, anchor: int = 0) -> np.ndarray:
    """Anchored penalty over a 1-D chain or a hypercube grid."""
    if not hasattr(dims, "__len__"):
        dims = [dims]
    if len(dims) == 1:
        D = first_difference_matrix(dims[0])
    else:
        D = matrix_from_edges(hypercube_edges(dims))
    return bayes_delta(D, k, anchor=anchor)


def num_penalty_rows(ndepth: int, tf_order: int) -> int:
    """Rows (nD) of bayes_grid_penalty(ndepth, tf_order)."""
    n = 1
    for k in range(tf_order + 1):
        n += ndepth if k % 2 == 1 else ndepth - 1
    return n


def penalty_half_bandwidth(tf_order: int) -> int:
    """Half-bandwidth of Delta^T diag(w) Delta for the 1-D chain penalty:
    the widest row of ``bayes_grid_penalty(T, k)`` has support
    tf_order + 2."""
    return tf_order + 1
