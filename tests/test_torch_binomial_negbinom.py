"""The port's Polya-Gamma models (functionalmf_tpu_torch/models/binomial.py,
negbinom.py) against the JAX package's.

* ``_pg_update`` and ``_update_R`` from a carried state with the noise JAX
  draws from its own keys injected: rtol 1e-5 on omega-derived tensors,
  1e-5 on R.
* Short chains against the JAX models in distribution (success
  probability within 0.05 mean absolute difference; NB mean correlated
  above 0.9).
* ``R_true``, ``rdims`` shapes, the ``r_min`` gate, an ``inf`` in the
  Binomial ``nu2`` through interop and ``_compute_rhat``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from functionalmf_tpu import (
    BinomialBayesianTensorFiltering as JaxBinomial,
    NegativeBinomialBayesianTensorFiltering as JaxNegBinom)
from functionalmf_tpu.models.base import _fold
from functionalmf_tpu.ops.gamma import gamma_mt as jgamma_mt
from functionalmf_tpu_torch import (
    BinomialBayesianTensorFiltering as TorchBinomial,
    NegativeBinomialBayesianTensorFiltering as TorchNegBinom)
from functionalmf_tpu_torch.interop import state_from_numpy, state_to_numpy
from tests.test_torch_constrained import torch_one_thread  # noqa: F401


def ilogit(x):
    return 1.0 / (1.0 + np.exp(-x))


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def _binomial_data(rng, n=6, m=5, T=9, k=2, nrep=20):
    W = rng.normal(size=(n, k))
    W[np.triu_indices(k, 1)] = 0
    V = rng.normal(size=(m, T, k))
    Mu = np.einsum("nk,mtk->nmt", W, V)
    N = np.full((n, m, T), float(nrep))
    N[3, 2] = 80.0                      # the normal branch (b >= 50)
    Y = rng.binomial(N.astype(int), ilogit(Mu)).astype(float)
    Y[:2, :2] = np.nan
    N[np.isnan(Y)] = np.nan
    return Y, N, Mu


def _nb_data(rng, n=6, m=5, T=8, nrep=3):
    Y = rng.poisson(rng.gamma(2.0, 2.0, size=(n, m, T, nrep))).astype(float)
    Y[:2, :2] = np.nan
    Y[3, 1, 2, 0] = np.nan
    return Y


def _carry(jm, tm):
    tm.load_state({k: np.asarray(v) for k, v in jm.state.items()})


def _chain(state, c):
    return {k: v[c] for k, v in state.items()}


def test_pg_update_matches_jax_under_injected_noise(rng):
    Y, N, _ = _binomial_data(rng)
    n, m, T = Y.shape
    kw = dict(nembeds=2, seed=2, nchains=2, sigma2_init=0.5, lam2_init=0.1)
    jm = JaxBinomial(n, m, T, **kw)
    tm = TorchBinomial(n, m, T, device="cpu", **kw)
    _carry(jm, tm)
    jp, tp = jm.prepare_data((Y, N)), tm.prepare_data((Y, N))
    for key in jp:
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    K = tm.pg_num_terms
    b = np.asarray(jp["N"] * jp["mask"])
    b_safe = jnp.asarray(np.where((b > 0) & (b < 50), b, 1.0), jnp.float32)
    want, gs, zs = [], [], []
    for c in range(2):
        st, w8, wy = jm._pg_update(_chain(jm.state, c), jp["Y"], jp["N"],
                                   jp["mask"], keys[c])
        want.append((np.asarray(st["nu2"]), np.asarray(w8), np.asarray(wy)))
        k_g, k_n = jax.random.split(keys[c])
        gs.append(np.asarray(jgamma_mt(k_g, b_safe, shape=(K,) + b.shape)))
        zs.append(np.asarray(jax.random.normal(k_n, b.shape, jnp.float32)))
    st, w8, wy = tm._pg_update(tm.state, tp["Y"], tp["N"], tp["mask"], None,
                               g=_t(np.stack(gs, 1)), z=_t(np.stack(zs)))
    for got, idx in ((st["nu2"], 0), (w8, 1), (wy, 2)):
        np.testing.assert_allclose(
            got.numpy(), np.stack([w[idx] for w in want]), rtol=1e-5)
    nu2 = st["nu2"].numpy()
    assert np.isinf(nu2[:, :2, :2]).all()       # missing cells: omega = 0
    assert np.isfinite(nu2[:, 2:]).all() and (w8.numpy()[:, :2, :2] == 0).all()


def test_inf_in_nu2_crosses_interop_and_rhat(rng):
    """A Binomial state holds nu2 = inf at missing cells. It crosses
    interop both ways unchanged, and _compute_rhat treats it as the JAX
    model's does (NaN for that variable, the others unaffected)."""
    Y, N, _ = _binomial_data(rng)
    n, m, T = Y.shape
    kw = dict(nembeds=2, seed=2, nchains=2)
    jm = JaxBinomial(n, m, T, **kw)
    tm = TorchBinomial(n, m, T, device="cpu", **kw)
    res = tm.run_gibbs((Y, N), nburn=2, nthin=1, nsamples=6, verbose=False)
    assert res["nu2"].shape == (12, n, m, T)
    assert np.isinf(res["nu2"][:, :2, :2]).all()
    assert np.isfinite(res["nu2"][:, 2:]).all()
    back = state_to_numpy(tm.state)
    again = state_from_numpy(back, "cpu")
    assert torch.isinf(again["nu2"][:, :2, :2]).all()
    for key in back:
        np.testing.assert_array_equal(again[key].numpy(), back[key])
    jm_state = {k: jnp.asarray(v) for k, v in back.items()}
    assert set(jm_state) == set(jm.state)
    with np.errstate(invalid="ignore"):
        got = tm._compute_rhat(res)
        want = jm._compute_rhat(res)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_equal(got[key], want[key])
    assert np.isfinite([got[k] for k in ("W", "V", "sigma2", "lam2")]).all()


def test_update_R_matches_jax_under_injected_noise(rng):
    Y = _nb_data(rng)
    n, m, T, _ = Y.shape
    for rdims, shape in (((0, 1, 2), (1, 1, 1)), ((1, 2), (n, 1, 1)),
                         ((), (n, m, T))):
        kw = dict(nembeds=2, seed=3, nchains=2, rdims=rdims)
        jm = JaxNegBinom(n, m, T, **kw)
        tm = TorchNegBinom(n, m, T, device="cpu", **kw)
        assert tm._R_shape == jm._R_shape == shape
        assert tuple(tm.state["R"].shape) == (2,) + shape
        assert (tm.state["R"] > 1).all()
        _carry(jm, tm)
        # embeddings small enough that P is away from 0 and 1, and R away
        # from the r_min gate (exp(cand) > 1 at cand ~ 1 flips on an ulp)
        W0, R0 = np.asarray(jm.state["W"]) * 0.3, np.asarray(jm.state["R"])
        for mod in (jm, tm):
            mod.W = W0
            mod.R = R0 + 2.0
        jp, tp = jm.prepare_data(Y), tm.prepare_data(Y)
        for key in jp:
            np.testing.assert_array_equal(tp[key].numpy(),
                                          np.asarray(jp[key]))
        keys = jax.random.split(jax.random.PRNGKey(13), 2)
        want, zs, us = [], [], []
        for c in range(2):
            want.append(np.asarray(jm._update_R(_chain(jm.state, c), jp,
                                                keys[c])["R"]))
            zs.append([np.asarray(jax.random.normal(
                _fold(keys[c], 2 * i), shape, jnp.float32))
                for i in range(tm.nmetropolis)])
            us.append([np.asarray(jax.random.uniform(
                _fold(keys[c], 2 * i + 1), shape, jnp.float32))
                for i in range(tm.nmetropolis)])
        noise = (_t(np.stack(zs, 1)), _t(np.stack(us, 1)))
        assert noise[0].shape == (30, 2) + shape
        got = tm._update_R(tm.state, tp, None, noise=noise)["R"].numpy()
        np.testing.assert_allclose(got, np.stack(want), rtol=1e-5)
        assert (got > 1).all()
        assert (got != R0 + 2.0).any()                      # some step moved


def test_draw_R_noise_order_and_injection():
    tm = TorchNegBinom(4, 3, 5, device="cpu", nembeds=2, rdims=(2,), seed=0,
                       nmetropolis=7)
    z, u = tm.draw_R_noise(torch.Generator().manual_seed(4))
    assert z.shape == u.shape == (7, 1, 4, 3, 1)
    assert (u >= 0).all() and (u < 1).all()
    Y = np.random.default_rng(0).poisson(3.0, size=(4, 3, 5)).astype(float)
    pd = tm.prepare_data(Y)
    a = tm._update_R(tm.state, pd, torch.Generator().manual_seed(4))["R"]
    b = tm._update_R(tm.state, pd, None, noise=(z, u))["R"]
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_binomial_short_chain_agrees_with_jax_in_distribution(rng):
    Y, N, Mu = _binomial_data(rng, n=8, m=6, T=10)
    n, m, T = Y.shape
    kw = dict(nembeds=2, sigma2_init=0.5, lam2_init=0.1, seed=0, nchains=2)
    P = {}
    for tag, mod in (("jax", JaxBinomial(n, m, T, **kw)),
                     ("torch", TorchBinomial(n, m, T, device="cpu", **kw))):
        res = mod.run_gibbs((Y, N), nburn=300, nthin=1, nsamples=300,
                            verbose=False)
        P[tag] = ilogit(np.clip(np.einsum("znk,zmtk->znmt", res["W"],
                                          res["V"]), -10, 10)).mean(0)
        assert (res["nan_fallbacks"] == 0).all(), tag
        assert res["nu2"].shape == (600, n, m, T)
    P_true = ilogit(Mu)
    assert np.abs(P["torch"] - P["jax"])[2:, 2:].mean() < 0.02
    assert np.abs(P["torch"] - P["jax"]).mean() < 0.05
    assert np.abs(P["torch"][2:, 2:] - P_true[2:, 2:]).mean() < 0.08


def test_negbinom_short_chain_agrees_with_jax_in_distribution(rng):
    n, m, T, k, nrep = 8, 6, 8, 2, 4
    W = rng.gamma(1, 1, size=(n, k))
    W[np.triu_indices(k, 1)] = 0
    V = rng.gamma(1, 1, size=(m, 1, k)) + np.cumsum(
        rng.gamma(1, 1, size=(m, T, k)) * (rng.random((m, T, 1)) < 0.2), 1)
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Var = rng.gamma(1, 1, size=(n, 1, 1)) * Mu ** 2 + Mu
    P = 1 - Mu / Var
    R = Mu * (1 - P) / np.clip(P, 1e-6, 1)
    Y = rng.poisson(rng.gamma(np.maximum(R[..., None], 1e-3),
                              (P / (1 - P))[..., None],
                              size=(n, m, T, nrep))).astype(float)
    Y[:2, :2] = np.nan
    kw = dict(nembeds=k, tf_order=0, sigma2_init=1.0, lam2_init=0.1,
              rdims=(1, 2), seed=0)
    est = {}
    for tag, mod in (("jax", JaxNegBinom(n, m, T, **kw)),
                     ("torch", TorchNegBinom(n, m, T, device="cpu", **kw))):
        res = mod.run_gibbs(Y, nburn=400, nthin=1, nsamples=300,
                            verbose=False)
        assert res["R"].shape == (300, n, 1, 1)
        assert set(res) == {"W", "V", "sigma2", "lam2", "Tau2", "nu2", "R",
                            "nan_fallbacks", "pivot_repairs"}
        assert np.all(res["R"] > 1.0)               # the r_min gate
        Ps = ilogit(np.clip(np.einsum("znk,zmtk->znmt", res["W"], res["V"]),
                            -10, 10))
        est[tag] = (res["R"] * Ps / (1 - Ps)).mean(0)
        assert (res["nan_fallbacks"] == 0).all(), tag
    fit = (slice(2, None), slice(2, None))
    assert np.corrcoef(est["torch"][fit].ravel(),
                       Mu[fit].ravel())[0, 1] > 0.7
    assert np.corrcoef(np.log(est["torch"][fit]).ravel(),
                       np.log(est["jax"][fit]).ravel())[0, 1] > 0.9
    rel = np.abs(est["torch"][fit] - est["jax"][fit]).mean() \
        / est["jax"][fit].mean()
    assert rel < 0.2, rel


def test_negbinom_R_true_stays_fixed_and_logprob_matches_jax(rng):
    Y = rng.poisson(3.0, size=(4, 3, 5)).astype(float)
    R_true = np.full((1, 1, 1), 2.5)
    kw = dict(nembeds=2, R_true=R_true, seed=0)
    tm = TorchNegBinom(4, 3, 5, device="cpu", **kw)
    assert not tm.sample_R
    res = tm.run_gibbs(Y, nburn=5, nthin=1, nsamples=5, verbose=False)
    assert res["R"].shape == (5, 1, 1, 1) and np.allclose(res["R"], 2.5)
    jm = JaxNegBinom(4, 3, 5, **kw)
    _carry(jm, tm)
    assert tm.logprob(Y) == pytest.approx(jm.logprob(Y), rel=1e-6)
    with pytest.raises((ValueError, AssertionError)):
        TorchNegBinom(4, 3, 5, device="cpu", nembeds=2, R_true=2.5)


def test_binomial_logprob_and_data_checks_match_jax(rng):
    Y, N, _ = _binomial_data(rng)
    n, m, T = Y.shape
    jm = JaxBinomial(n, m, T, nembeds=2, seed=1)
    tm = TorchBinomial(n, m, T, device="cpu", nembeds=2, seed=1)
    _carry(jm, tm)
    assert tm.logprob((Y, N)) == pytest.approx(jm.logprob((Y, N)), rel=1e-6)
    with pytest.raises(AssertionError, match="pair of 3-tensors"):
        tm.prepare_data((Y, N[..., None]))
    if not torch.cuda.is_available():
        for cls in (TorchBinomial, TorchNegBinom):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cls(n, m, T, nembeds=2)
