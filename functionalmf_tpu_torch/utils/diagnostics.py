"""Split-R-hat, numpy only.

Counterpart of functionalmf_tpu/utils/diagnostics.py:109-120,
re-implemented because importing the JAX package imports jax.
"""
from __future__ import annotations

import numpy as np

__all__ = ["split_rhat"]


def split_rhat(chains):
    """Split-R-hat for (nchains, nsamples) scalar draws."""
    x = np.asarray(chains, dtype=float)
    half = x.shape[1] // 2
    splits = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    n2 = splits.shape[1]
    B = n2 * splits.mean(axis=1).var(ddof=1)
    W = splits.var(axis=1, ddof=1).mean()
    var_hat = (n2 - 1) / n2 * W + B / n2
    return float(np.sqrt(var_hat / max(W, 1e-300)))
