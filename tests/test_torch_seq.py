"""The port's sequential and joint V schedules.

The sequential schedule updates one time block after another, the joint
update (``v_block_size=None``) the whole curve at once; both are the JAX
package's ``_update_V_gass`` (constrained.py:547-833). The port runs each
block round as one batched GASS update over every (chain, column), so the
round structure is checked directly. Sequential and red-black chains
target the same posterior: with and without EP centring their posterior
means of Mu agree within rel < 0.12, the criterion of
tests/test_constrained.py:305-348 and 397-441, every draw feasible."""
import warnings

import numpy as np
import pytest

from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering as TorchModel, POISSON)

from tests.test_torch_constrained import (  # noqa: F401 (fixture)
    _problem, torch_loglik, torch_one_thread)


@pytest.mark.parametrize("bs, sizes", [(3, [3, 3, 3, 2]), (4, [4, 4, 3]),
                                       (None, [11]), (11, [11]), (40, [11])])
def test_seq_rounds_cover_the_curve_in_order(bs, sizes):
    n, m, T, k = 4, 3, 11, 2
    _, C, W0, V0, _ = _problem(1, n, m, T, k)
    tm = TorchModel(n, m, T, torch_loglik, C, device="cpu", nembeds=k,
                    tf_order=2, W_init=W0, V_init=V0, v_block_size=bs,
                    v_schedule="seq", nchains=2,
                    loglikelihood_cellfn=POISSON)
    assert [ph.size for ph in tm._phases] == sizes
    assert [ph.starts for ph in tm._phases] == [
        [s] for s in np.cumsum([0] + sizes[:-1]).tolist()]
    for ph in tm._phases:
        # one round is one launch over every (chain, column) pair
        assert len(ph.pair_chain) == tm.nchains * m


def test_redblack_checks_apply_to_redblack_only():
    """A block narrower than the prior's bandwidth is fine for seq, as in
    the JAX package (constrained.py:247-272)."""
    n, m, T, k = 4, 3, 9, 2
    _, C, W0, V0, _ = _problem(1, n, m, T, k)
    base = dict(nembeds=k, W_init=W0, V_init=V0, tf_order=2, v_block_size=1,
                loglikelihood_cellfn=POISSON, device="cpu")
    TorchModel(n, m, T, torch_loglik, C, v_schedule="seq", **base)
    with pytest.raises(ValueError, match="prior bandwidth"):
        TorchModel(n, m, T, torch_loglik, C, v_schedule="redblack", **base)


def test_joint_update_runs_feasible_with_ep():
    n, m, T, k = 5, 4, 9, 2
    Y, C, W0, V0, Mu = _problem(2, n, m, T, k)
    ep = (Mu, np.full(Mu.shape, 4.0))
    tm = TorchModel(n, m, T, torch_loglik, C, device="cpu", nembeds=k,
                    tf_order=2, sigma2_init=0.5, lam2_init=0.1, W_init=W0,
                    V_init=V0, gass_ngrid=16, v_block_size=None,
                    v_schedule="seq", ep_approx=ep, nchains=2, seed=3,
                    loglikelihood_cellfn=POISSON)
    res = tm.run_gibbs(Y, nburn=10, nthin=1, nsamples=10, verbose=False)
    mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
    assert np.isfinite(mu).all() and mu.min() >= -1e-5
    assert tm.check_constraints()
    assert res["nan_fallbacks"].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("ep", [False, True])
def test_seq_matches_redblack_in_distribution(ep):
    n, m, T, k = 6, 5, 11, 2
    rng = np.random.default_rng(17 if ep else 5)
    W = rng.gamma(1, 1, (n, k))
    W[np.triu_indices(k, 1)] = 0
    V = np.abs(rng.normal(1, .3, (m, T, k)))
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(Mu).astype(float)
    Y[0, 0] = np.nan
    C = np.concatenate([np.eye(T), np.zeros((T, 1))], axis=1)
    W0 = np.abs(rng.normal(1, .2, (n, k)))
    W0[np.triu_indices(k, 1)] = 0
    V0 = np.abs(rng.normal(1, .2, (m, T, k)))
    kw = {}
    if ep:
        kw["ep_approx"] = (Mu + rng.normal(0, 0.1, Mu.shape),
                           np.full(Mu.shape, 8.0))
    means = {}
    for sched in ("seq", "redblack"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mod = TorchModel(n, m, T, torch_loglik, C, device="cpu",
                             nembeds=k, tf_order=0, sigma2_init=0.5,
                             lam2_init=0.1, W_init=W0, V_init=V0,
                             gass_ngrid=40, v_block_size=3, v_schedule=sched,
                             seed=7, loglikelihood_cellfn=POISSON, **kw)
        res = mod.run_gibbs(Y, nburn=400, nthin=1, nsamples=400,
                            verbose=False)
        mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        assert mu.min() >= -1e-5
        means[sched] = mu.mean(0)
    rel = (np.abs(means["seq"] - means["redblack"]).mean()
           / np.sqrt((Mu ** 2).mean()))
    assert rel < 0.12, rel
