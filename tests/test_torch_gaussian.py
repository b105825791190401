"""The port's Gaussian model (functionalmf_tpu_torch/models/gaussian.py)
against closed-form conditionals and against the JAX package's model.

* W and V conditional means against dense float64 algebra, as
  tests/test_gaussian.py:24-90 (6 standard errors).
* One sweep's updates (nu2, W, V) from a state carried over from the JAX
  model, with the noise JAX draws from its own keys injected: rtol=atol=
  2e-4 (float32 factorisations whose sums run in different orders).
* The V update alone at the JAX model's random horseshoe start (Tau2 and
  lam2 as drawn): port, JAX and a dense float64 draw of the same
  conditional within rtol=atol=1e-3 of one another.
* Short chains against the JAX model in distribution: posterior mean of Mu
  within 0.1 of the data's RMS, nu2 within 15%.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from functionalmf_tpu import GaussianBayesianTensorFiltering as JaxModel
from functionalmf_tpu.models.base import _fold
from functionalmf_tpu_torch import GaussianBayesianTensorFiltering as TorchModel
from functionalmf_tpu_torch.ops.penalty import (bayes_grid_penalty,
                                                num_penalty_rows)
from tests.test_torch_constrained import torch_one_thread  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-4)


def _make_data(rng, nrows=6, ncols=5, ndepth=8, nembeds=2, nu2=0.25, nrep=2):
    W = rng.normal(size=(nrows, nembeds))
    W[np.triu_indices(nembeds, k=1)] = 0
    V = rng.normal(size=(ncols, ndepth, nembeds))
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.normal(Mu[..., None], np.sqrt(nu2),
                   size=(nrows, ncols, ndepth, nrep))
    return W, V, Mu, Y


def _suff(Y):
    counts = (~np.isnan(Y)).sum(-1)
    ymean = np.where(counts > 0, np.nansum(np.nan_to_num(Y), -1)
                     / np.maximum(counts, 1), 0)
    return counts, ymean


def test_w_conditional_posterior_mean(rng):
    nrows, ncols, ndepth, nembeds, nu2 = 6, 5, 8, 2, 0.25
    W, V, Mu, Y = _make_data(rng, nrows, ncols, ndepth, nembeds, nu2)
    Y[0, :2] = np.nan
    sigma2 = 0.7
    model = TorchModel(
        nrows, ncols, ndepth, device="cpu", nembeds=nembeds, V_true=V,
        Tau2_true=np.ones((ncols, num_penalty_rows(ndepth, 2))),
        lam2_true=1.0, sigma2_true=sigma2, nu2_true=nu2, seed=3)
    res = model.run_gibbs(Y, nburn=50, nthin=1, nsamples=3000, verbose=False)
    Ws = res["W"]
    counts, ymean = _suff(Y)
    for i in range(nrows):
        nd = min(i + 1, nembeds)
        Vf = V.reshape(-1, nembeds)[:, :nd]
        w8 = (counts[i] / nu2).reshape(-1)
        Q = (Vf * w8[:, None]).T @ Vf + np.eye(nd) / sigma2
        mu = np.linalg.solve(Q, Vf.T @ (w8 * ymean[i].reshape(-1)))
        se = np.sqrt(np.diag(np.linalg.inv(Q)) / Ws.shape[0]) * 6 + 1e-3
        np.testing.assert_array_less(np.abs(Ws[:, i, :nd].mean(0) - mu), se)
        assert np.all(Ws[:, i, nd:] == 0)
    np.testing.assert_array_equal(res["V"], np.broadcast_to(
        V.astype(np.float32), res["V"].shape))


def test_v_conditional_posterior_mean(rng):
    nrows, ncols, ndepth, nembeds, nu2 = 6, 4, 6, 2, 0.25
    W, V, Mu, Y = _make_data(rng, nrows, ncols, ndepth, nembeds, nu2)
    Y[1, 0] = np.nan
    nD = num_penalty_rows(ndepth, 2)
    Tau2 = np.ones((ncols, nD))
    lam2 = 0.5
    model = TorchModel(
        nrows, ncols, ndepth, device="cpu", nembeds=nembeds, W_true=W,
        Tau2_true=Tau2, lam2_true=lam2, sigma2_true=1.0, nu2_true=nu2,
        seed=4)
    res = model.run_gibbs(Y, nburn=50, nthin=1, nsamples=3000, verbose=False)
    Vs = res["V"]
    Delta = bayes_grid_penalty(ndepth, 2)
    counts, ymean = _suff(Y)
    X = np.kron(W, np.eye(ndepth))  # (n*T, k*T), embed-major columns
    for j in range(ncols):
        w8 = (counts[:, j] / nu2).reshape(-1)
        Q_lik = (X * w8[:, None]).T @ X
        DtLD = Delta.T @ np.diag(1.0 / (lam2 * Tau2[j])) @ Delta
        Q = Q_lik + np.kron(np.eye(nembeds), DtLD)
        mu = np.linalg.solve(Q, X.T @ (w8 * ymean[:, j].reshape(-1)))
        mu_V = mu.reshape(nembeds, ndepth).T
        sd = np.sqrt(np.diag(np.linalg.inv(Q))).reshape(nembeds, ndepth).T
        se = sd / np.sqrt(Vs.shape[0]) * 6 + 2e-3
        np.testing.assert_array_less(np.abs(Vs[:, j].mean(0) - mu_V), se)
    assert (res["pivot_repairs"] == 0).all()


def _pair(rng, nchains=2, tf_order=2, seed_=1, **kw):
    n, m, T, k = 5, 4, 11, 2
    _, _, _, Y = _make_data(rng, n, m, T, k)
    Y[0, :2] = np.nan
    Y[2, 1, 3:6, 0] = np.nan
    common = dict(nembeds=k, tf_order=tf_order, seed=seed_, nchains=nchains,
                  **kw)
    jm = JaxModel(n, m, T, **common)
    tm = TorchModel(n, m, T, device="cpu", **common)
    tm.load_state({k_: np.asarray(v) for k_, v in jm.state.items()})
    return jm, tm, Y


def _chain(state, c):
    return {k: v[c] for k, v in state.items()}


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


@pytest.mark.parametrize("nu2_mode", ["scalar", "row"])
def test_one_sweep_of_updates_matches_jax_under_injected_noise(rng, nu2_mode):
    """nu2, then W, then V (the sweep's order with the priors held), two
    chains, from the JAX model's own random initial state (sigma2, nu2, W,
    V; Tau2 and lam2 start at 1 and 0.5: at a random horseshoe start the V
    precision's condition number is above 1e4, and the two float32
    factorisations then differ from the float64 draw, and from each other,
    by 3e-4); each chain's noise is what JAX draws from its key."""
    jm, tm, Y = _pair(rng, nu2_mode=nu2_mode, lam2_init=0.5,
                      Tau2_init=np.ones((4, num_penalty_rows(11, 2))))
    jp, tp = jm.prepare_data(Y), tm.prepare_data(Y)
    for key in jp:
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]))
    nch, n, m, T, k = 2, tm.nrows, tm.ncols, tm.ndepth, tm.nembeds
    keys = jax.random.split(jax.random.PRNGKey(5), nch)
    jstates = [_chain(jm.state, c) for c in range(nch)]

    # nu2
    nobs = (jp["counts"].sum((1, 2)) if nu2_mode == "row"
            else jp["counts"].sum())
    gam = [jax.random.gamma(_fold(keys[c], 10), tm.nu2_a + nobs / 2.0)
           for c in range(nch)]
    jstates = [jm._update_nu2(jstates[c], jp, _fold(keys[c], 10))
               for c in range(nch)]
    ts = tm._update_nu2(tm.state, tp, None, gamma=_t(np.stack(gam)))
    want = np.stack([np.asarray(s["nu2"]) for s in jstates])
    assert ts["nu2"].shape == want.shape
    np.testing.assert_allclose(ts["nu2"].numpy(), want, rtol=1e-5)

    # W
    def jweights(s):
        return jp["counts"] / s["nu2"], jp["ysum"] / s["nu2"]

    z = [jax.random.normal(_fold(keys[c], 14), (n, k), jnp.float32)
         for c in range(nch)]
    jstates = [jm._gaussian_update_W(jstates[c], *jweights(jstates[c]),
                                     _fold(keys[c], 14)) for c in range(nch)]
    nu2 = tm._nu2_cells(ts["nu2"])
    ts = tm._gaussian_update_W(ts, tp["counts"] / nu2, tp["ysum"] / nu2, None,
                               z=_t(np.stack(z)))
    np.testing.assert_allclose(
        ts["W"].numpy(), np.stack([np.asarray(s["W"]) for s in jstates]),
        **TOL)

    # V: JAX draws z for the retiled system, (m, T2, 8 k)
    T2 = -(-T // 8)
    z = [np.asarray(jax.random.normal(_fold(keys[c], 15), (m, T2, 8 * k),
                                      jnp.float32)
                    ).reshape(m, T2 * 8, k)[:, :T] for c in range(nch)]
    jstates = [jm._gaussian_update_V(jstates[c], *jweights(jstates[c]),
                                     _fold(keys[c], 15)) for c in range(nch)]
    ts = tm._gaussian_update_V(ts, tp["counts"] / nu2, tp["ysum"] / nu2, None,
                               z=_t(np.stack(z)))
    np.testing.assert_allclose(
        ts["V"].numpy(), np.stack([np.asarray(s["V"]) for s in jstates]),
        **TOL)
    for key in ("pivot_repairs", "nan_fallbacks"):
        np.testing.assert_array_equal(
            ts[key].numpy(), [float(s[key]) for s in jstates])


@pytest.mark.parametrize("seed", [1, 2])
def test_v_update_at_a_random_horseshoe_start_against_float64_dense(rng,
                                                                    seed):
    """The V update from the JAX model's own random initial state, Tau2
    and lam2 included: there the V precision's condition number is above
    1e4 and the two float32 block factorisations differ by up to 3e-4. A
    dense float64 draw of the same equilibrated, jittered conditional with
    the same z is the arbiter: both are within rtol=atol=1e-3 of it, and
    of each other."""
    from functionalmf_tpu_torch.ops.banded import bands_to_dense
    jm, tm, Y = _pair(rng, seed_=seed)
    jp, tp = jm.prepare_data(Y), tm.prepare_data(Y)
    nch, m, T, k = 2, tm.ncols, tm.ndepth, tm.nembeds
    keys = jax.random.split(jax.random.PRNGKey(7), nch)
    T2 = -(-T // 8)
    z = np.stack([np.asarray(jax.random.normal(
        _fold(keys[c], 15), (m, T2, 8 * k), jnp.float32)
    ).reshape(m, T2 * 8, k)[:, :T] for c in range(nch)])
    jstates = [_chain(jm.state, c) for c in range(nch)]
    jout = [jm._gaussian_update_V(
        s, jp["counts"] / s["nu2"], jp["ysum"] / s["nu2"], _fold(keys[c], 15))
        for c, s in enumerate(jstates)]
    nu2 = tm._nu2_cells(tm.state["nu2"])
    tout = tm._gaussian_update_V(tm.state, tp["counts"] / nu2,
                                 tp["ysum"] / nu2, None, z=_t(z))

    s64 = {k_: v.double() for k_, v in tm.state.items()}
    tm.Delta = tm.Delta.double()        # integer entries: exact in both
    nu2 = tm._nu2_cells(s64["nu2"])
    bands, mu_part = tm._v_bands(s64, tp["counts"].double() / nu2,
                                 tp["ysum"].double() / nu2)
    assert bands.dtype == torch.float64
    Q = bands_to_dense(bands).numpy()                     # (nch, m, Tk, Tk)
    assert np.linalg.cond(Q).max() > 1e4
    sc = 1.0 / np.sqrt(np.diagonal(Q, axis1=-2, axis2=-1))
    Qe = Q * sc[..., :, None] * sc[..., None, :] + 1e-4 * np.eye(T * k)
    L = np.linalg.cholesky(Qe)
    mean = np.linalg.solve(Qe, (mu_part.numpy().reshape(nch, m, -1)
                                * sc)[..., None])
    noise = np.linalg.solve(np.swapaxes(L, -1, -2),
                            z.reshape(nch, m, -1, 1).astype(np.float64))
    want = ((mean + noise)[..., 0] * sc).reshape(nch, m, T, k)

    jV = np.stack([np.asarray(s["V"]) for s in jout])
    loose = dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tout["V"].numpy(), want, **loose)
    np.testing.assert_allclose(jV, want, **loose)
    np.testing.assert_allclose(tout["V"].numpy(), jV, **loose)
    for key in ("pivot_repairs", "nan_fallbacks"):
        np.testing.assert_array_equal(
            tout[key].numpy(), [float(s[key]) for s in jout])


def test_repair_counts_are_per_chain(rng, monkeypatch):
    """The JAX package vmaps the sweep over chains, so a chain's
    pivot_repairs counts its own columns' repairs; the port sums over
    every axis but the chain axis."""
    from functionalmf_tpu_torch.models import gaussian as tg
    _, tm, Y = _pair(rng)
    tp = tm.prepare_data(Y)
    rep = torch.tensor([[1.0, 0, 2, 0], [0, 0, 0, 5]])
    ger = torch.tensor([[0.0, 0, 1, 0], [0, 0, 0, 0]])
    real = tg.sample_mvn_block_banded_retiled
    monkeypatch.setattr(
        tg, "sample_mvn_block_banded_retiled",
        lambda *a, **kw: (real(*a, **kw)[0], rep, ger))
    nu2 = tm._nu2_cells(tm.state["nu2"])
    out = tm._gaussian_update_V(tm.state, tp["counts"] / nu2,
                                tp["ysum"] / nu2,
                                torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out["pivot_repairs"].numpy(), [3, 5])
    np.testing.assert_array_equal(out["nan_fallbacks"].numpy(), [1, 0])


NU2_CASES = [
    (dict(), ()), (dict(nu2_init=2.0), ()), (dict(nu2_true=0.5), ()),
    (dict(nu2_mode="row"), (5, 1, 1)),
    (dict(nu2_mode="row", nu2_init=2.0), (5, 1, 1)),
    (dict(nu2_true="cells"), (5, 4, 11))]


def _nu2_kw(rng, kw):
    kw = dict(kw)
    if isinstance(kw.get("nu2_true"), str):
        kw["nu2_true"] = rng.gamma(2, 0.2, size=(5, 4, 11))
    return kw


@pytest.mark.parametrize("kw,nu2_shape", NU2_CASES)
@pytest.mark.parametrize("nchains", [1, 2])
def test_nu2_shapes_in_state_and_results(rng, kw, nu2_shape, nchains):
    """The three nu2 shapes (scalar, per row, fixed heteroskedastic
    cells) with one chain and two: the state's shape, a finite positive
    init draw, finite results of the JAX package's shapes (scalars as
    (S, 1)), and a fixed nu2 stays as given."""
    kw = _nu2_kw(rng, kw)
    _, _, _, Y = _make_data(rng, 5, 4, 11, 2)
    Y[0, :2] = np.nan
    tm = TorchModel(5, 4, 11, device="cpu", nembeds=2, nchains=nchains,
                    seed=3, tf_order=1, **kw)
    assert tuple(tm.state["nu2"].shape) == (nchains,) + nu2_shape
    assert torch.isfinite(tm.state["nu2"]).all()
    assert (tm.state["nu2"] > 0).all()
    assert np.shape(tm.nu2) == (() if nchains == 1 else (nchains,)) \
        + nu2_shape
    S = 4 * nchains
    got = tm.run_gibbs(Y, nburn=1, nthin=1, nsamples=4, verbose=False)
    assert got["nu2"].shape == (S,) + (nu2_shape or (1,))
    assert got["W"].shape == (S, 5, 2) and got["V"].shape == (S, 4, 11, 2)
    for key in ("W", "V", "sigma2", "lam2", "Tau2", "nu2"):
        assert np.isfinite(got[key]).all(), key
    if "nu2_true" in kw:
        want = np.asarray(kw["nu2_true"], np.float32)
        np.testing.assert_allclose(got["nu2"], np.broadcast_to(
            want if want.ndim else want.reshape(1, 1), got["nu2"].shape),
            rtol=1e-6)
    elif "nu2_init" not in kw and nchains == 2:
        assert not torch.equal(tm.state["nu2"][0], tm.state["nu2"][1])


@pytest.mark.parametrize("kw,nu2_shape", NU2_CASES[::2] + NU2_CASES[5:])
def test_state_and_results_keys_shapes_dtypes_match_jax(rng, kw, nu2_shape):
    """State and results of one model per nu2 shape, two chains, against
    the JAX model's: keys, shapes and dtypes."""
    kw = _nu2_kw(rng, kw)
    jm, tm, Y = _pair(rng, nchains=2, tf_order=1, **kw)
    assert set(tm.state) == set(jm.state)
    for key, val in jm.state.items():
        assert tuple(tm.state[key].shape) == tuple(val.shape), key
    want = jm.run_gibbs(Y, nburn=1, nthin=1, nsamples=4, verbose=False)
    got = tm.run_gibbs(Y, nburn=1, nthin=1, nsamples=4, verbose=False)
    assert set(got) == set(want)
    for key, val in want.items():
        if key == "rhat":
            assert set(got[key]) == set(val)
            continue
        assert got[key].shape == np.shape(val), key
        assert got[key].dtype == np.asarray(val).dtype, key
    assert np.shape(tm.nu2) == np.shape(jm.nu2)


def test_short_chain_agrees_with_jax_in_distribution(rng):
    n, m, T, k, nu2 = 8, 6, 10, 2, 0.5
    W, V, Mu, Y = _make_data(rng, n, m, T, k, nu2, nrep=3)
    Y[:2, :2] = np.nan
    common = dict(nembeds=k, sigma2_init=0.5, lam2_init=0.1, nu2_init=1.0,
                  seed=0, nchains=2)
    stats = {}
    for tag, mod in (("jax", JaxModel(n, m, T, **common)),
                     ("torch", TorchModel(n, m, T, device="cpu", **common))):
        res = mod.run_gibbs(Y, nburn=300, nthin=1, nsamples=300,
                            verbose=False)
        mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        assert np.isfinite(mu).all()
        stats[tag] = (mu.mean(0), res["nu2"].mean(), mu.std(0).mean())
        assert (res["nan_fallbacks"] == 0).all(), tag
    base = np.sqrt(np.mean(Mu ** 2))
    diff = np.abs(stats["jax"][0] - stats["torch"][0])
    assert diff[2:, 2:].mean() < 0.05 * base, diff[2:, 2:].mean() / base
    assert diff.mean() < 0.1 * base, diff.mean() / base
    assert abs(stats["torch"][1] / stats["jax"][1] - 1) < 0.15
    assert 0.5 * nu2 < stats["torch"][1] < 2.0 * nu2
    assert abs(stats["torch"][2] / stats["jax"][2] - 1) < 0.25
    fit = np.sqrt(np.mean((stats["torch"][0][2:, 2:] - Mu[2:, 2:]) ** 2))
    assert fit < 0.35 * base


def test_logprob_matches_jax(rng):
    for kw in (dict(), dict(nu2_mode="row"), dict(nchains=1)):
        jm, tm, Y = _pair(rng, **kw)
        assert tm.logprob(Y) == pytest.approx(jm.logprob(Y), rel=1e-6)
        assert tm.logprob(Y[..., 0]) == pytest.approx(jm.logprob(Y[..., 0]),
                                                      rel=1e-6)


def test_device_defaults_to_the_card_and_bad_rank_raises():
    if torch.cuda.is_available():
        assert TorchModel(4, 3, 6, nembeds=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchModel(4, 3, 6, nembeds=2)
    tm = TorchModel(4, 3, 6, device="cpu", nembeds=2)
    with pytest.raises(AssertionError, match="3- or 4-tensor"):
        tm.prepare_data(np.zeros((4, 3)))


def test_all_nan_column_stays_finite(rng):
    """A column with no data draws from its prior and stays finite."""
    _, _, _, Y = _make_data(rng, 5, 4, 9, 2)
    Y[:, 2] = np.nan
    tm = TorchModel(5, 4, 9, device="cpu", nembeds=2, seed=2, nu2_init=1.0,
                    lam2_init=0.1, sigma2_init=0.5)
    res = tm.run_gibbs(Y, nburn=20, nthin=1, nsamples=20, verbose=False)
    assert np.isfinite(res["V"]).all() and np.isfinite(res["W"]).all()
