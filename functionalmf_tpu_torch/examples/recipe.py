"""The production recipe of bench.py as an example with known truth.

bench.py's generator (bench.py:138-150: a rank-k positive truth, Poisson
counts, 10% of the curves held out, then a warm start W0, V0 near the
truth's scale, all from one generator; bench.py draws it at seed 42 and
19x19x228, k=5) and its red-black model (tf_order=2, positivity on every
curve, GASS grid of 100, blocks of 8, interweave and factor_rebalance on,
the Poisson cell function in the fused kernels on the card).
``make_data``, ``init_model``, ``scored_draws`` and ``score`` are the
steps ``examples/anchors.py`` runs;
the gated metrics are the Poisson example's RMSE against the true rate
and 90% coverage of it, and the posterior means of log lam2 and log
sigma2, which the scale moves set.
"""
import numpy as np

from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering, POISSON)
from functionalmf_tpu_torch.examples.poisson_tensor_filtering import (
    rowcol_loglikelihood, score as rate_score)

SHAPE = (19, 19, 228, 5)     # bench.py's nrows, ncols, ndepth, nembeds
SWEEPS = (300, 1, 300)       # nburn, nthin, nsamples


def make_data(rng, shape=SHAPE):
    """bench.py:138-150 at ``shape``: ((Y with NaN at the held-out curves,
    the warm start W0, V0), the true rate)."""
    nrows, ncols, ndepth, k = shape
    W = np.abs(rng.normal(1, 0.3, size=(nrows, k)))
    W[np.triu_indices(k, k=1)] = 0
    V = np.abs(rng.normal(1, 0.3, size=(ncols, ndepth, k)))
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(Mu).astype(float)
    hold = rng.random((nrows, ncols)) < 0.1
    Y[hold] = np.nan
    W0 = np.abs(rng.normal(1, 0.2, size=(nrows, k)))
    W0[np.triu_indices(k, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(ncols, ndepth, k)))
    return (Y, W0, V0), Mu


def init_model(W0, V0, seed=0, nchains=1, device="cuda", **kwargs):
    """bench.py's red-black recipe (``_make_model`` with
    ``v_schedule="redblack"`` and the cell function) from W0, V0."""
    nrows, k = W0.shape
    ncols, ndepth, _ = V0.shape
    Constraints = np.concatenate([np.eye(ndepth), np.zeros((ndepth, 1))],
                                 axis=1)
    return ConstrainedNonconjugateBayesianTensorFiltering(
        nrows, ncols, ndepth, rowcol_loglikelihood, Constraints,
        device=device, nembeds=k, tf_order=2, sigma2_init=0.5,
        lam2_init=0.1, W_init=W0, V_init=V0, gass_ngrid=100, seed=seed,
        nchains=nchains, v_schedule="redblack", v_block_size=8,
        loglikelihood_cellfn=POISSON, **kwargs)


def scored_draws(results):
    """The draws the metrics read: the rate W V^T (draws, n, m, T), log
    lam2 and log sigma2 (draws,)."""
    return (np.einsum("znk,zmtk->znmt", results["W"], results["V"]),
            np.log(results["lam2"][:, 0]), np.log(results["sigma2"][:, 0]))


def score(truth, rate, log_lam2, log_sigma2):
    """One chain's gated metrics."""
    return dict(rate_score(truth, rate), log_lam2=float(log_lam2.mean()),
                log_sigma2=float(log_sigma2.mean()))
