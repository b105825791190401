"""MCMC diagnostics, numpy only: effective sample size and split-R-hat.

Counterpart of functionalmf_tpu/utils/diagnostics.py, re-implemented
because importing the JAX package imports jax. Standard definitions:
Geyer's initial monotone positive sequence for ESS, Gelman et al.'s
split-R-hat.
"""
from __future__ import annotations

import numpy as np

__all__ = ["effective_sample_size", "split_rhat", "min_ess_per_param",
           "pooled_min_ess"]


def _autocov(x):
    n = len(x)
    x = x - x.mean()
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    return np.fft.irfft(f * np.conj(f), m)[:n].real / n


def effective_sample_size(draws):
    """ESS of a 1-D chain via Geyer's initial monotone positive sequence."""
    x = np.asarray(draws, dtype=float)
    n = len(x)
    if n < 4 or np.allclose(x.var(), 0):
        return float(n)
    acov = _autocov(x)
    rho = acov / acov[0]
    # pair sums Gamma_k = rho_{2k} + rho_{2k+1}
    gam = rho[:-1:2][: n // 2] + rho[1::2][: n // 2]
    pos = gam > 0
    if not pos[0]:
        return float(n)
    stop = np.argmin(pos) if not pos.all() else len(gam)
    gam = np.minimum.accumulate(gam[:stop])
    tau = -1.0 + 2.0 * gam.sum()
    return float(min(n, max(1.0, n / max(tau, 1e-12))))


def _min_ess(samples_dict, keys, max_params, rng, detail, nchains):
    """The smallest ESS over (a sample of ``max_params``) scalar
    parameters of ``keys``; with several chains (chain-major along the
    sample axis) a parameter's ESS is the sum over its chains."""
    rng = np.random.default_rng(0) if rng is None else rng
    ess_min, argk, argj = np.inf, None, None
    for k in keys:
        if k not in samples_dict:
            continue
        v = np.asarray(samples_dict[k])
        if v.shape[0] % nchains:
            raise ValueError(f"{k}: {v.shape[0]} draws do not split into "
                             f"{nchains} chains")
        flat = v.reshape(nchains, v.shape[0] // nchains, -1)
        cols = flat.shape[-1]
        idx = (np.arange(cols) if cols <= max_params
               else rng.choice(cols, size=max_params, replace=False))
        for j in idx:
            e = sum(effective_sample_size(flat[c, :, j])
                    for c in range(nchains))
            if e < ess_min:
                ess_min, argk, argj = e, k, int(j)
    if detail:
        return float(ess_min), argk, argj
    return float(ess_min)


def min_ess_per_param(samples_dict, keys=("W", "V", "lam2", "sigma2"),
                      max_params: int = 512, rng=None, detail: bool = False):
    """Minimum ESS across (a subsample of) scalar parameters. With
    ``detail=True`` returns (min_ess, key, flat_index) of the slowest
    parameter."""
    return _min_ess(samples_dict, keys, max_params, rng, detail, 1)


def pooled_min_ess(samples_dict, nchains: int,
                   keys=("W", "V", "lam2", "sigma2"),
                   max_params: int = 128, rng=None, detail: bool = False):
    """Min-across-params of the chain-pooled ESS of a multi-chain run:
    ``run_gibbs`` concatenates chains chain-major along the sample axis,
    and the pooled ESS of a parameter is the sum of its per-chain ESS."""
    return _min_ess(samples_dict, keys, max_params, rng, detail, nchains)


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
