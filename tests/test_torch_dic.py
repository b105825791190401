"""The port's DIC grid search (``select_hyperparams_DIC``,
functionalmf_tpu_torch/models/base.py) against the JAX package's:
tests/test_dic.py's checks for the port, and the scores of both packages
on the same draws (rtol=1e-4)."""
import numpy as np
import pytest

from functionalmf_tpu import GaussianBayesianTensorFiltering as JaxGaussian
from functionalmf_tpu_torch import GaussianBayesianTensorFiltering

from tests.test_torch_constrained import torch_one_thread  # noqa: F401


def _gauss_problem(rng):
    nrows, ncols, ndepth, k = 5, 4, 6, 2
    W = rng.normal(size=(nrows, k))
    W[np.triu_indices(k, 1)] = 0
    V = rng.normal(size=(ncols, ndepth, k))
    Y = rng.normal(np.einsum("nk,mtk->nmt", W, V), 0.5)
    return (nrows, ncols, ndepth, k), Y


def test_select_hyperparams_dic(rng):
    """tests/test_dic.py:test_select_hyperparams_dic for the port."""
    (nrows, ncols, ndepth, k), Y = _gauss_problem(rng)
    model = GaussianBayesianTensorFiltering(
        nrows, ncols, ndepth, device="cpu", nembeds=k, nu2_init=1.0, seed=0)
    out = model.select_hyperparams_DIC(Y, verbose=False, lam2=[0.01, 1.0],
                                       nburn=30, nthin=1, nsamples=30)
    assert set(out.keys()) == {"scores", "options", "best", "fit"}
    assert len(out["scores"]) == 2 and np.isfinite(out["scores"]).all()
    assert out["best"]["lam2"] in (0.01, 1.0)
    assert out["best"]["lam2"] == [0.01, 1.0][int(np.argmin(out["scores"]))]
    assert out["fit"]["W"].shape == (30, nrows, k)
    # the model adopts the winning hyperparameter
    assert float(model.lam2) == pytest.approx(out["best"]["lam2"])
    # the default grid: 10 values from 1e3 down to 1e-6
    opts = {}
    model._default_hyperparam_options(opts)
    np.testing.assert_allclose(opts["lam2"][[0, -1]], [1e3, 1e-6])
    assert len(opts["lam2"]) == 10


def test_dic_scores_match_jax_on_the_same_draws(rng, monkeypatch):
    """Both packages score the same draws (the port's run_gibbs is
    replaced by one that returns the JAX run's draws): the DIC scores
    agree to rtol=1e-4 and both pick the same grid point."""
    (nrows, ncols, ndepth, k), Y = _gauss_problem(rng)
    jm = JaxGaussian(nrows, ncols, ndepth, nembeds=k, nu2_init=1.0, seed=0)
    runs = []
    real = jm.run_gibbs
    jm.run_gibbs = lambda *a, **kw: runs.append(real(*a, **kw)) or runs[-1]
    want = jm.select_hyperparams_DIC(Y, verbose=False, lam2=[0.01, 1.0],
                                     nburn=20, nthin=1, nsamples=20)
    tm = GaussianBayesianTensorFiltering(
        nrows, ncols, ndepth, device="cpu", nembeds=k, nu2_init=1.0, seed=0)
    replay = iter(runs)
    tm.run_gibbs = lambda *a, **kw: {
        key: np.asarray(v) for key, v in next(replay).items()}
    got = tm.select_hyperparams_DIC(Y, verbose=False, lam2=[0.01, 1.0],
                                    nburn=20, nthin=1, nsamples=20)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4)
    assert got["best"] == want["best"]


@pytest.mark.parametrize("lam2_gen", [1e-3, 10.0])
def test_dic_selects_true_smoothness_regime(lam2_gen):
    """tests/test_dic.py:test_dic_selects_true_smoothness_regime for the
    port at one seed and shorter chains (100 + 60 sweeps): W, nu2 and Tau2
    fixed, the truth drawn from the model's own prior at a known lam2; the
    wrong arm scores many times worse there."""
    from functionalmf_tpu_torch.ops.penalty import bayes_grid_penalty
    grid = [1e-3, 10.0]
    rng = np.random.default_rng(0)
    nrows, ncols, ndepth, k = 6, 5, 30, 1
    D = np.asarray(bayes_grid_penalty(ndepth, 2))
    cov = np.linalg.inv(D.T @ D / lam2_gen)
    L = np.linalg.cholesky(cov + 1e-12 * np.eye(ndepth))
    W = np.abs(rng.normal(1.0, 0.2, size=(nrows, k)))
    V = (L @ rng.normal(size=(ndepth, ncols))).T[..., None]
    Y = rng.normal(np.einsum("nk,mtk->nmt", W, V), 0.25)
    model = GaussianBayesianTensorFiltering(
        nrows, ncols, ndepth, device="cpu", nembeds=k, nu2_true=0.0625,
        W_true=W, lam2_true=1.0, Tau2_true=np.ones((ncols, D.shape[0])),
        seed=0)
    out = model.select_hyperparams_DIC(Y, verbose=False, lam2=grid,
                                       nburn=100, nthin=2, nsamples=60)
    assert out["best"]["lam2"] == lam2_gen, out["scores"]
