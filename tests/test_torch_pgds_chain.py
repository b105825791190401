"""The port's PGDS chains (fit_pgds, models/pgds.py) on the CPU:
tests/test_pgds.py's schema, recovery and binary checks, the collection
protocol, and the posterior-mean rates of the port against the JAX
package's at a toy shape."""
import numpy as np
import pytest

from functionalmf_tpu.pgds import fit_pgds as jax_fit_pgds
from functionalmf_tpu_torch.models.pgds import pgds_gibbs
from functionalmf_tpu_torch.pgds import fit_pgds

from tests.test_torch_constrained import torch_one_thread  # noqa: F401

# the spread of the posterior-mean rates of two JAX seeds (0 and 1) on the
# recovery problem below, RMS over cells relative to the true rates' RMS
# (three JAX seeds: 0.080-0.107 a pair; three port seeds: 0.109-0.131)
JAX_SEED_SPREAD = 0.1058


@pytest.mark.parametrize("stationary", [False, True])
def test_pgds_schema_and_finiteness(stationary):
    """fit_pgds returns the reference wrapper's shapes and finite draws."""
    rng = np.random.default_rng(0)
    Y = rng.poisson(3.0, (5, 4, 12)).astype(float)
    Y[0, 0] = np.nan
    Mu, (W, V, U) = fit_pgds(Y, 2, nburn=30, nthin=1, nsamples=20, seed=0,
                             stationary=stationary, device="cpu")
    assert Mu.shape == (20, 5, 4, 12)
    assert W.shape == (20, 5, 2) and V.shape == (20, 4, 2)
    assert U.shape == (20, 12, 2)
    assert np.isfinite(Mu).all() and (Mu >= 0).all()
    # Dirichlet factor columns sum to one
    assert np.allclose(W.sum(1), 1.0, atol=1e-4)
    assert np.allclose(V.sum(1), 1.0, atol=1e-4)


def test_time_mode_moves_the_time_axis():
    rng = np.random.default_rng(1)
    Y = rng.poisson(2.0, (5, 9, 4)).astype(float)
    Mu, (W, V, U) = fit_pgds(Y, 2, time_mode=1, nburn=5, nthin=1,
                             nsamples=3, seed=0, device="cpu")
    assert Mu.shape == (3, 5, 9, 4)
    assert W.shape == (3, 5, 2) and V.shape == (3, 4, 2)
    assert U.shape == (3, 9, 2)
    np.testing.assert_allclose(Mu, np.einsum("sik,sjk,stk->sitj", W, V, U),
                               rtol=1e-6)


def test_collection_chunks_draw_what_an_uncut_run_draws():
    rng = np.random.default_rng(2)
    Y = rng.poisson(3.0, (4, 3, 10)).astype(float)
    Y[1, 2] = np.nan
    kw = dict(nburn=7, nthin=2, nsamples=5, seed=3, device="cpu")
    whole = pgds_gibbs(Y, 2, chunk_sweeps=500, **kw)
    cut = pgds_gibbs(Y, 2, chunk_sweeps=3, **kw)
    for name in ("A", "B", "Theta", "delta"):
        np.testing.assert_array_equal(cut[name], whole[name])
    assert whole["delta"].shape == (5, 10)


def test_fit_pgds_runs_on_the_card_unless_asked():
    """The card is the default: without one it raises, nothing falls back
    to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_pgds(np.ones((3, 3, 4)), 2, nburn=1, nsamples=1)


def test_pgds_binary_mode():
    rng = np.random.default_rng(5)
    P = rng.uniform(0.05, 0.9, (6, 5, 10))
    Y = (rng.random(P.shape) < P).astype(float)
    Mu, _ = fit_pgds(Y, 2, binary=True, nburn=50, nthin=1, nsamples=30,
                     seed=1, device="cpu")
    assert np.isfinite(Mu).all() and (Mu >= 0).all()
    # the rates track the data: cells observed as 1 get the larger rates
    m = Mu.mean(0)
    assert m[Y > 0].mean() > m[Y == 0].mean()


def _recovery_problem():
    """tests/test_pgds.py:test_pgds_recovers_rates's data."""
    rng = np.random.default_rng(3)
    N, M, T, K = 8, 7, 20, 2
    A = rng.dirichlet(np.ones(N) * 2, size=K).T
    B = rng.dirichlet(np.ones(M) * 2, size=K).T
    U = np.abs(np.cumsum(rng.normal(0, 1, (T, K)), axis=0)) + 5
    Mu = np.einsum("ik,jk,tk->ijt", A, B, U) * 8
    return rng.poisson(Mu).astype(float), Mu


@pytest.fixture(scope="module")
def recovery_fit():
    Y, Mu = _recovery_problem()
    Mud, _ = fit_pgds(Y, 3, nburn=400, nthin=1, nsamples=200, seed=0,
                      device="cpu")
    return Y, Mu, Mud.mean(0)


def _rel(a, b, Mu):
    return np.sqrt(np.mean((a - b) ** 2)) / np.sqrt((Mu ** 2).mean())


def test_pgds_recovers_rates(recovery_fit):
    """The posterior mean tracks the true rate on model-generated data."""
    _, Mu, mean = recovery_fit
    assert _rel(mean, Mu, Mu) < 0.25


def test_pgds_posterior_mean_agrees_with_jax(recovery_fit):
    """Port and JAX chains (seed 0 each, 400 + 200 sweeps) reach the same
    posterior-mean rates within twice the spread between two JAX seeds."""
    Y, Mu, mean = recovery_fit
    jmean = jax_fit_pgds(Y, 3, nburn=400, nthin=1, nsamples=200,
                         seed=0)[0].mean(0)
    rel = _rel(mean, jmean, Mu)
    assert rel < 2 * JAX_SEED_SPREAD, rel
