"""tests/test_interweave.py's checks of the scale moves (interweave=True,
factor_rebalance=True) on the port's constrained model, ``device="cpu"``:
fixed scales stay fixed, the move set is exact on a known target, and the
moves multiply the ESS of the scales they target (ESS from the port's own
``utils/diagnostics.py``). The chains with data use the Poisson cellfn,
whose draws the black-box path of the JAX tests reproduces bit for bit on
the CPU (tests/test_torch_constrained.py)."""
import numpy as np
import pytest
import torch

from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering as Model, POISSON)
from functionalmf_tpu_torch.utils.diagnostics import effective_sample_size

from tests.test_torch_constrained import torch_one_thread  # noqa: F401

NE = 2
N_, M_, T_ = 6, 5, 11


def poisson_loglik(Y, WV, W, V, row=None, col=None):
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    if Y.dim() > WV.dim():
        WV = WV[..., None]
    rate = torch.clamp(WV, min=1e-8)
    nan = torch.isnan(Y)
    Y0 = torch.where(nan, 0.0, Y)
    ll = Y0 * torch.log(rate) - rate - torch.lgamma(Y0 + 1.0)
    return torch.where(nan, 0.0, ll).sum()


def _toy(seed=5):
    """tests/test_interweave.py:_toy."""
    rng = np.random.default_rng(seed)
    W = rng.gamma(1, 1, (N_, NE))
    W[np.triu_indices(NE, 1)] = 0
    V = np.abs(rng.normal(1, .3, (M_, T_, NE)))
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(Mu).astype(float)
    Y[0, 0] = np.nan
    C = np.concatenate([np.eye(T_), np.zeros((T_, 1))], axis=1)
    W0 = np.abs(rng.normal(1, .2, (N_, NE)))
    W0[np.triu_indices(NE, 1)] = 0
    V0 = np.abs(rng.normal(1, .2, (M_, T_, NE)))
    return W, V, Mu, Y, C, W0, V0


def _model(C, W0, V0, **kw):
    return Model(N_, M_, T_, poisson_loglik, C, device="cpu", nembeds=NE,
                 tf_order=0, W_init=W0, V_init=V0, v_block_size=3,
                 loglikelihood_cellfn=POISSON, **kw)


def test_interweave_respects_fixed_scales():
    """lam2_true / sigma2_true stay exactly fixed (no AA move)."""
    W, V, Mu, Y, C, W0, V0 = _toy(seed=13)
    mod = _model(C, W0, V0, sigma2_true=0.5, lam2_true=0.1, gass_ngrid=32,
                 seed=29, interweave=True)
    r = mod.run_gibbs(Y, nburn=30, nthin=1, nsamples=20, verbose=False)
    assert np.all(r["lam2"] == np.float32(0.1))
    assert np.all(r["sigma2"] == np.float32(0.5))
    mu = np.einsum("znk,zmtk->znmt", r["W"], r["V"])
    assert mu.min() >= -1e-5 and mod.check_constraints()
    assert not np.array_equal(r["V"][0], r["V"][-1])


@pytest.mark.slow
def test_interweave_exact_on_prior_target():
    """With a zero likelihood and a vacuous constraint the posterior is the
    prior, whose scale marginals are sampled directly: lam2 a clipped
    half-Cauchy^2 (the horseshoe ladder), sigma2 an IG(3, 3). The chain's
    log-scale quartiles match direct prior draws."""
    def zero_ll(Y, WV, W, V, row=None, col=None):
        return torch.zeros(())

    C = np.concatenate([np.zeros((1, T_)), -np.ones((1, 1))], axis=1)
    mod = Model(N_, M_, T_, zero_ll, C, device="cpu", nembeds=NE,
                tf_order=0, sigma2_a=3.0, sigma2_b=3.0, gass_ngrid=40,
                v_block_size=3, seed=31, interweave=True)
    r = mod.run_gibbs(None, nburn=500, nthin=3, nsamples=1200,
                      verbose=False)
    lam2 = np.log(r["lam2"].reshape(-1))
    sig2 = np.log(r["sigma2"].reshape(-1))
    g = np.random.default_rng(0)
    n = 200_000
    hc2 = np.maximum(np.abs(g.standard_cauchy(n)) ** 2, 1e-5)
    ig = 3.0 / g.gamma(3.0, size=n)
    for chain, direct, tol in ((lam2, np.log(hc2), 0.45),
                               (sig2, np.log(ig), 0.35)):
        for q in (0.25, 0.5, 0.75):
            a, b = np.quantile(chain, q), np.quantile(direct, q)
            assert abs(a - b) < tol, (q, a, b)


@pytest.mark.slow
def test_interweave_multiplies_lam2_ess():
    """lam2's ESS improves by a large factor with the moves (the
    conjugate draw alone leaves lam2 random-walking the weakly identified
    W <-> V scale split)."""
    W, V, Mu, Y, C, W0, V0 = _toy(seed=3)
    ess = {}
    for iw in (False, True):
        mod = _model(C, W0, V0, sigma2_init=0.5, lam2_init=0.1,
                     gass_ngrid=40, seed=19, interweave=iw)
        r = mod.run_gibbs(Y, nburn=400, nthin=1, nsamples=600,
                          verbose=False)
        ess[iw] = effective_sample_size(np.log(r["lam2"].reshape(-1)))
    assert ess[True] > 3.0 * ess[False], ess


@pytest.mark.slow
def test_factor_rebalance_multiplies_split_ess():
    """The per-factor move: the relative scale of the rank-1 factors,
    log ||V[:,:,0]||^2 / ||V[:,:,1]||^2, is likelihood-invariant and
    random-walks without the move; the identified Mu agrees on and off.
    2000 draws, not the JAX test's 800: on 800 the ESS estimate of the
    random walk is biased up (the port's seeds 7-10 read 10-21 without
    the move and 8-44 with it; on 2000 draws 7.1-8.0 and 21-41)."""
    W, V, Mu, Y, C, W0, V0 = _toy(seed=5)
    out = {}
    for fr in (False, True):
        mod = _model(C, W0, V0, sigma2_init=0.5, lam2_init=0.1,
                     gass_ngrid=40, seed=7, factor_rebalance=fr)
        r = mod.run_gibbs(Y, nburn=600, nthin=1, nsamples=2000,
                          verbose=False)
        mu = np.einsum("znk,zmtk->znmt", r["W"], r["V"])
        assert mu.min() >= -1e-5 and mod.check_constraints()
        split = np.log((r["V"][..., 0] ** 2).sum(axis=(1, 2))
                       / (r["V"][..., 1] ** 2).sum(axis=(1, 2)))
        out[fr] = (mu.mean(0), effective_sample_size(split))
    rel = (np.abs(out[False][0] - out[True][0]).mean()
           / np.sqrt((Mu ** 2).mean()))
    assert rel < 0.12, rel
    assert out[True][1] > 2.0 * out[False][1], (out[False][1], out[True][1])
