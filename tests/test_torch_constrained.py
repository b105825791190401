"""The port's constrained red-black model against the JAX package's.

From a state carried across by ``interop`` the deterministic pieces agree
to float32 (rtol=1e-5): the prior Gram, logprob, the scale bounds, the
constraint slack and the red-black candidate log-likelihood of a colour
phase (the JAX package's inline einsum path). Whole chains agree in
distribution on a toy shape, with every draw feasible."""
import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.scipy.special import gammaln

from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering \
    as JaxModel
from functionalmf_tpu.models import constrained as jconstrained
from functionalmf_tpu.samplers import horseshoe as jhorseshoe
from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering as TorchModel, POISSON)
from functionalmf_tpu_torch.interop import state_from_numpy, state_to_numpy
from functionalmf_tpu_torch.models.constrained import collapsed_scale_dims
from functionalmf_tpu_torch.ops.penalty import num_penalty_rows
from functionalmf_tpu_torch.samplers.horseshoe import lam2_shape


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """The port's tests run tiny tensors: one intra-op thread is as fast
    as many, and the suite's parallel workers then do not oversubscribe
    the cores (many threads each made the chain tests ten times slower
    under xdist). Files that run chains import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_loglik(Y, WV, W, V, row=None, col=None):
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    rate = jnp.clip(WV, 1e-8, None)
    Y0 = jnp.where(jnp.isnan(Y), 0.0, Y)
    ll = Y0 * jnp.log(rate) - rate - gammaln(Y0 + 1.0)
    return jnp.sum(jnp.where(jnp.isnan(Y), 0.0, ll))


def jax_cellfn(y, tau):
    rate = jnp.clip(tau, 1e-8, None)
    y0 = jnp.where(jnp.isnan(y), 0.0, y)
    return jnp.where(jnp.isnan(y), 0.0, y0 * jnp.log(rate) - rate)


def torch_loglik(Y, WV, W, V, row=None, col=None):
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    rate = torch.clamp(WV, min=1e-8)
    nan = torch.isnan(Y)
    Y0 = torch.where(nan, 0.0, Y)
    ll = Y0 * torch.log(rate) - rate - torch.lgamma(Y0 + 1.0)
    return torch.where(nan, 0.0, ll).sum()


def _problem(seed, n, m, T, k):
    rng = np.random.default_rng(seed)
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
    return Y, C, W0, V0, Mu


def _pair(seed=3, n=5, m=4, T=11, k=2, tf_order=2, bs=4, nchains=2, **kw):
    Y, C, W0, V0, Mu = _problem(seed, n, m, T, k)
    common = dict(nembeds=k, tf_order=tf_order, sigma2_init=0.5,
                  lam2_init=0.1, W_init=W0, V_init=V0, gass_ngrid=16,
                  v_block_size=bs, v_schedule="redblack", seed=1,
                  nchains=nchains, **kw)
    jm = JaxModel(n, m, T, jax_loglik, C, loglikelihood_cellfn=jax_cellfn,
                  **common)
    tm = TorchModel(n, m, T, torch_loglik, C, device="cpu",
                    loglikelihood_cellfn=POISSON, **common)
    # carry the JAX model's (randomly initialised Tau2 ladder) state over
    tm.load_state({k_: np.asarray(v) for k_, v in jm.state.items()})
    return jm, tm, Y


def test_state_round_trip_and_prior_gram():
    jm, tm, _ = _pair()
    np_state = {k: np.asarray(v) for k, v in jm.state.items()}
    back = state_to_numpy(tm.state)
    assert set(back) == set(np_state)
    for key in np_state:
        np.testing.assert_array_equal(back[key], np_state[key])
    got = tm._v_prior_dtld(tm.state["lam2"], tm.state["Tau2"]).numpy()
    for c in range(tm.nchains):
        want = np.asarray(jm._v_prior_dtld(jm.state["lam2"][c],
                                           jm.state["Tau2"][c]))
        np.testing.assert_allclose(got[c], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    t = state_from_numpy(np_state, "cpu")
    assert all(isinstance(v, torch.Tensor) for v in t.values())


def test_logprob_and_constraint_slack_match():
    jm, tm, Y = _pair(nchains=1)
    assert tm.logprob(Y) == pytest.approx(jm.logprob(Y), rel=1e-5)
    assert tm._worst_constraint_slack() == pytest.approx(
        jm._worst_constraint_slack(), rel=1e-5, abs=1e-6)
    V = tm.V.copy()
    V[0, 0, 0] = -1.0
    tm.V = V
    jm.V = V
    assert tm._worst_constraint_slack() == pytest.approx(
        jm._worst_constraint_slack(), rel=1e-5)
    assert not tm.check_constraints()


def test_scale_bounds_match(rng):
    jm, tm, _ = _pair(nchains=1)
    vals = rng.normal(size=(3, 40)).astype(np.float32)
    vals[:, :4] = 0.0
    cs = rng.normal(size=(3, 40)).astype(np.float32) * 0.1
    lo, hi = tm._scale_bounds(torch.as_tensor(vals), torch.as_tensor(cs))
    for b in range(3):
        jlo, jhi = jm._scale_bounds(jnp.asarray(vals[b]), jnp.asarray(cs[b]))
        np.testing.assert_allclose([lo[b].item(), hi[b].item()],
                                   [float(jlo), float(jhi)], rtol=1e-6)


def test_redblack_phase_candidate_ll_matches_jax_inline_path(rng):
    """Every (chain, column, block) pair of each colour phase (the tail
    included) through the port's batched function equals the JAX
    package's inline einsum + derived cells likelihood
    (constrained.py:955-970) for that pair."""
    jm, tm, Y = _pair(T=11, bs=4)
    y = tm.prepare_data(Y)
    ydat = jnp.asarray(np.asarray(Y, np.float32))
    W = (tm.state["W"] * tm._wmask).contiguous()
    G, k = 6, tm.nembeds
    for ph in tm._phases:
        P = len(ph.pair_chain)
        cands = np.abs(rng.normal(1, 0.3, (P, G, ph.size, k))).astype(
            np.float32)
        got = tm._blocks_loglik(W, y, ph, torch.as_tensor(cands)).numpy()
        for p in range(P):
            c, j, t0 = (int(ph.pair_chain[p]), int(ph.pair_col[p]),
                        int(ph.pair_t0[p]))
            Wj = jnp.asarray(W[c].numpy())
            Vg = jnp.asarray(cands[p])
            tau = jnp.einsum("gtk,nk->gnt", Vg, Wj)
            want = jax.vmap(lambda tau_g, Vb_g: jm.loglikelihood_cells(
                ydat, tau_g, Wj, Vb_g, col=j, t0=t0, size=ph.size))(tau, Vg)
            np.testing.assert_allclose(got[p], np.asarray(want), rtol=1e-5,
                                       atol=1e-4)
    assert [ph.size for ph in tm._phases] == [4, 4, 3]


def test_slice_matches_jax_in_distribution():
    """The whole red-black recipe on a toy shape: the port (plain path)
    and the JAX package (fuse_cells=False, its shipped path) reach the
    same posterior mean of Mu (the rel < 0.12 criterion of
    tests/test_constrained.py:304-348) and of log lam2 and log sigma2
    (within 0.75, about a third of their posterior sd of ~2; the scale
    moves set these), and every draw is feasible."""
    n, m, T, k = 6, 5, 12, 2
    Y, C, W0, V0, Mu = _problem(5, n, m, T, k)
    common = dict(nembeds=k, tf_order=0, sigma2_init=0.5, lam2_init=0.1,
                  W_init=W0, V_init=V0, gass_ngrid=24, v_block_size=3,
                  v_schedule="redblack", seed=7)
    jm = JaxModel(n, m, T, jax_loglik, C, loglikelihood_cellfn=jax_cellfn,
                  fuse_cells=False, **common)
    tm = TorchModel(n, m, T, torch_loglik, C, device="cpu",
                    loglikelihood_cellfn=POISSON, **common)
    means, scales = {}, {}
    for tag, mod in (("jax", jm), ("torch", tm)):
        res = mod.run_gibbs(Y, nburn=400, nthin=1, nsamples=400,
                            verbose=False)
        mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        assert mu.min() >= -1e-5, tag
        assert np.isfinite(mu).all(), tag
        means[tag] = mu.mean(0)
        scales[tag] = np.array([np.log(res["lam2"]).mean(),
                                np.log(res["sigma2"]).mean()])
    rel = np.abs(means["jax"] - means["torch"]).mean() / np.sqrt(
        (Mu ** 2).mean())
    assert rel < 0.12, rel
    assert np.abs(scales["jax"] - scales["torch"]).max() < 0.75, scales
    assert tm.check_constraints()


def test_infeasible_start_raises():
    n, m, T, k = 4, 3, 6, 2
    Y, C, W0, V0, _ = _problem(1, n, m, T, k)
    V0[1, 2, 0] = -0.5
    tm = TorchModel(n, m, T, torch_loglik, C, device="cpu", nembeds=k,
                    tf_order=0, W_init=W0, V_init=V0, v_block_size=3,
                    v_schedule="redblack", loglikelihood_cellfn=POISSON)
    with pytest.raises(ValueError, match="violates the constraints"):
        tm.run_gibbs(Y, nburn=1, nsamples=1, verbose=False)


def test_lam2_exponents_pinned_as_in_the_reference():
    """The collapsed moves use dV_free = ncols*ndepth*k
    (constrained.py:1083); the conjugate lam2 update uses nD*ncols*k
    (horseshoe.py:111). They differ for tf_order >= 1 (the main path:
    nD = 3T-1 = 683 at T=228). Ported as the reference has them; a fix
    must change both packages."""
    m, T, k = 19, 228, 5
    nD = num_penalty_rows(T, 2)
    assert nD == 683
    assert collapsed_scale_dims(15, m, T, k) == (15.0, float(m * T * k))
    assert lam2_shape(nD, m, k) == (nD * m * k + 1) / 2.0
    src = inspect.getsource(jconstrained)
    assert "dV_free = float(self.ncols * self.ndepth * k)" in src
    assert "shape = (nD * ncols * nembeds + 1) / 2.0" in inspect.getsource(
        jhorseshoe.resample_lam2)
    assert num_penalty_rows(T, 0) == T      # tf_order=0: the two agree


@pytest.mark.parametrize("kw, match", [
    (dict(loglikelihood_cellfn=None), "loglikelihood_cellfn"),
    (dict(Row_constraints=np.zeros((1, 3))), "Row_constraints"),
    (dict(gass_method="shrink"), "shrink"),
])
def test_out_of_slice_options_raise(kw, match):
    n, m, T, k = 4, 3, 6, 2
    _, C, W0, V0, _ = _problem(1, n, m, T, k)
    args = dict(nembeds=k, tf_order=0, W_init=W0, V_init=V0, v_block_size=3,
                v_schedule="redblack", loglikelihood_cellfn=POISSON)
    args.update(kw)
    with pytest.raises(NotImplementedError, match=match):
        TorchModel(n, m, T, torch_loglik, C, device="cpu", **args)


def test_device_defaults_to_the_card():
    """Without ``device=`` the model runs on the card; where there is none
    it raises and never falls back to the CPU. ``device="cpu"`` runs."""
    n, m, T, k = 4, 3, 6, 2
    Y, C, W0, V0, _ = _problem(1, n, m, T, k)
    args = dict(nembeds=k, tf_order=0, W_init=W0, V_init=V0, v_block_size=3,
                v_schedule="redblack", loglikelihood_cellfn=POISSON)
    if torch.cuda.is_available():
        assert TorchModel(n, m, T, torch_loglik, C,
                          **args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchModel(n, m, T, torch_loglik, C, **args)
    tm = TorchModel(n, m, T, torch_loglik, C, device="cpu", **args)
    assert tm.device.type == "cpu"
    res = tm.run_gibbs(Y, nburn=1, nthin=1, nsamples=2, verbose=False)
    assert res["W"].shape == (2, n, k) and np.isfinite(res["W"]).all()


@pytest.mark.parametrize("force_psd", [True, False])
def test_w_prior_proposal_honours_force_psd(force_psd):
    """Without EP the W proposal's precision is I / sigma2, factored as
    sample_mvn_from_precision(**linalg_opts) factors it in the JAX package:
    the jitter ladder (eps * 100^a, a < 4) only under force_psd. At
    sigma2 = -10 the precision is -0.1 I; the last rung (+1) repairs it."""
    n, m, T, k = 4, 3, 6, 2
    _, C, W0, V0, _ = _problem(1, n, m, T, k)
    tm = TorchModel(n, m, T, torch_loglik, C, device="cpu", nembeds=k,
                    tf_order=0, W_init=W0, V_init=V0, v_block_size=3,
                    v_schedule="redblack", loglikelihood_cellfn=POISSON,
                    force_psd=force_psd)
    L, mu = tm._w_proposal(tm.state["V"], torch.full((1,), -10.0))
    assert mu is None and L.shape == (1, n, k, k)
    if force_psd:
        np.testing.assert_allclose(L.numpy(), np.broadcast_to(
            np.sqrt(0.9) * np.eye(k), L.shape), rtol=1e-6)
    else:
        assert torch.isnan(torch.diagonal(L, dim1=-2, dim2=-1)).all()


def test_redblack_validation_matches_reference():
    n, m, T, k = 4, 3, 9, 2
    _, C, W0, V0, _ = _problem(1, n, m, T, k)
    base = dict(nembeds=k, W_init=W0, V_init=V0, v_schedule="redblack",
                loglikelihood_cellfn=POISSON, device="cpu")
    with pytest.raises(ValueError, match="prior bandwidth"):
        TorchModel(n, m, T, torch_loglik, C, tf_order=2, v_block_size=2,
                   **base)
    wide = np.concatenate([np.ones((1, T)), np.zeros((1, 1))], axis=1)
    with pytest.raises(ValueError, match="constraint row spans"):
        TorchModel(n, m, T, torch_loglik, wide, tf_order=0, v_block_size=3,
                   **base)
    with pytest.raises(ValueError, match="finite v_block_size"):
        TorchModel(n, m, T, torch_loglik, C, tf_order=0, v_block_size=None,
                   **base)
