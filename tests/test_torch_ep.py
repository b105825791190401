"""EP centring in the port against the JAX package.

* The EP plain versions of both fused functions against the JAX Pallas
  kernels with the model's ``cellfn_ep`` (interpret mode) and against the
  unfused JAX expression ``sum cell - _ep_logpdf``; rtol=2e-5, atol=2e-3
  (sums in another order, as in tests/test_fused_ll.py). The JAX kernels
  pad ragged edges with y = NaN, mu = sig = 1 and tau = 0, and each padded
  cell adds -log N(0; 1, 1) = log(2 pi)/2 + 1/2; the port does not, so
  the comparison removes (#padded cells) x that constant.
* From the same state, the W update's EP proposal (Q, mean) and the EP
  block conditionals of the red-black, sequential and joint V updates
  (the t-major coupled precision, its mean and its draw from the same
  standard normal) against the JAX expressions (constrained.py:431-446,
  633-681, 853-906); rtol=1e-5.
* The port's seq+EP chain against the JAX package's in distribution.
"""
import math
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.scipy.stats import norm as jnorm

from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering \
    as JaxModel
from functionalmf_tpu.models.constrained import _ep_logpdf
from functionalmf_tpu.ops import fused_ll as jfl
from functionalmf_tpu.ops.mvn import _cho_solve as j_cho_solve
from functionalmf_tpu.ops.mvn import cholesky_psd as j_cholesky_psd
from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering as TorchModel, POISSON)
from functionalmf_tpu_torch.models.constrained import ep_block_precision
from functionalmf_tpu_torch.ops import fused_ll as F

from tests.test_torch_constrained import (  # noqa: F401 (fixture)
    _problem, jax_cellfn, jax_loglik, torch_loglik, torch_one_thread)
from tests.test_torch_fused_ll import cuda_device  # noqa: F401 (fixture)

PAD_CELL = 0.5 * math.log(2 * math.pi) + 0.5     # -log N(0; 1, 1)


def jax_cellfn_ep(y, tau, mu, sig):
    """constrained.py:466-468 with the Poisson cell."""
    lp = jnorm.logpdf(tau, mu, sig)
    return jax_cellfn(y, tau) - jnp.where(jnp.isnan(mu), 0.0, lp)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(got, want, rtol=2e-5, atol=2e-3):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _ep_cells(rng, shape, tau_scale):
    """y with ~10% NaN; mu finite at most of them (NaN at ~5%, some of
    those where y is present), sig in [0.5, 2]."""
    y = rng.poisson(2.0, size=shape).astype(np.float32)
    y[rng.random(shape) < 0.1] = np.nan
    mu = (rng.gamma(2, 1, size=shape) * tau_scale).astype(np.float32)
    mu[rng.random(shape) < 0.05] = np.nan
    sig = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    assert (np.isnan(y) & ~np.isnan(mu)).any()
    return y, mu, sig


def _row_pad(C):
    c_tile = min(2048, max(128, -(-C // 128) * 128))
    return -(-C // c_tile) * c_tile - C


def _col_pad(n, Tb):
    n_tile = min(2048, max(128, -(-n // 128) * 128))
    return Tb * (-(-n // n_tile) * n_tile - n)


@pytest.mark.parametrize("G,k,C", [(12, 5, 300), (101, 5, 1000)])
def test_row_ep_matches_jax_fused_and_unfused(rng, G, k, C):
    cands = rng.gamma(2, 1, size=(G, k)).astype(np.float32)
    B = rng.gamma(1, 0.5, size=(k, C)).astype(np.float32)
    y, mu, sig = _ep_cells(rng, (C,), k)
    got = F.fused_row_ll(_t(cands), _t(B), _t(y), POISSON,
                         extras=(_t(mu), _t(sig)))
    want = jfl.fused_row_ll(jnp.asarray(cands), jnp.asarray(B),
                            jnp.asarray(y), jax_cellfn_ep,
                            extras=(jnp.asarray(mu), jnp.asarray(sig)),
                            interpret=True)
    _close(got, np.asarray(want) - _row_pad(C) * PAD_CELL)
    tau = jnp.asarray(cands) @ jnp.asarray(B)                     # (G, C)
    unfused = (jax_cellfn(jnp.asarray(y)[None], tau).sum(-1)
               - jax.vmap(lambda t: _ep_logpdf(t, jnp.asarray(mu),
                                               jnp.asarray(sig)))(tau))
    _close(got, unfused)


@pytest.mark.parametrize("G,Tb,k,n", [(12, 4, 5, 70), (101, 40, 5, 19)])
def test_col_ep_matches_jax_fused_and_unfused(rng, G, Tb, k, n):
    cands3 = rng.gamma(2, 1, size=(G, Tb, k)).astype(np.float32)
    Wn = rng.gamma(1, 0.5, size=(n, k)).astype(np.float32)
    y, mu, sig = _ep_cells(rng, (Tb, n), k)
    got = F.fused_col_block_ll(_t(cands3), _t(Wn), _t(y), POISSON,
                               extras=(_t(mu), _t(sig)))
    want = jfl.fused_col_block_ll(jnp.asarray(cands3), jnp.asarray(Wn),
                                  jnp.asarray(y), jax_cellfn_ep,
                                  extras=(jnp.asarray(mu), jnp.asarray(sig)),
                                  interpret=True)
    _close(got, np.asarray(want) - _col_pad(n, Tb) * PAD_CELL)
    tau = jnp.einsum("gtk,nk->gtn", jnp.asarray(cands3), jnp.asarray(Wn))
    unfused = (jax_cellfn(jnp.asarray(y)[None], tau).sum((1, 2))
               - jax.vmap(lambda t: _ep_logpdf(t, jnp.asarray(mu),
                                               jnp.asarray(sig)))(tau))
    _close(got, unfused)


def test_row_ep_batched_matches_one_jax_call_per_row(rng):
    nch, n, m, T, k, G = 2, 4, 3, 10, 3, 9
    V = rng.gamma(1, 0.5, size=(nch, m, T, k)).astype(np.float32)
    y, mu, sig = _ep_cells(rng, (n, m * T), 1.0)
    cands = rng.gamma(2, 1, size=(nch * n, G, k)).astype(np.float32)
    rc = np.repeat(np.arange(nch), n).astype(np.int32)
    ri = np.tile(np.arange(n), nch).astype(np.int32)
    got = F.fused_row_ll_batched(
        _t(cands), _t(V.reshape(nch, m * T, k)), _t(y), _t(rc, torch.int32),
        _t(ri, torch.int32), POISSON, extras=(_t(mu), _t(sig)))
    for r in range(nch * n):
        want = jfl.fused_row_ll(
            jnp.asarray(cands[r]), jnp.asarray(V[rc[r]].reshape(m * T, k).T),
            jnp.asarray(y[ri[r]]), jax_cellfn_ep,
            extras=(jnp.asarray(mu[ri[r]]), jnp.asarray(sig[ri[r]])),
            interpret=True)
        _close(got[r], np.asarray(want) - _row_pad(m * T) * PAD_CELL)


def test_col_ep_batched_matches_one_jax_call_per_pair(rng):
    """A red-black colour phase and its tail, every pair against the JAX
    kernel on its own slice of y, mu and sig."""
    nch, n, m, T, k, G, bs = 2, 5, 3, 14, 2, 7, 4
    W = rng.gamma(1, 0.5, size=(nch, n, k)).astype(np.float32)
    y, mu, sig = _ep_cells(rng, (n, m, T), 1.0)
    for starts, Tb in (([0, 8], bs), ([12], 2)):
        cc, jj, bb = np.meshgrid(np.arange(nch), np.arange(m),
                                 np.arange(len(starts)), indexing="ij")
        pc, pj = cc.reshape(-1), jj.reshape(-1)
        pt = np.asarray(starts)[bb.reshape(-1)]
        cands = rng.gamma(2, 1, size=(len(pc), G, Tb, k)).astype(np.float32)
        got = F.fused_col_block_ll_batched(
            _t(cands), _t(W), _t(y), _t(pc, torch.int32),
            _t(pj, torch.int32), _t(pt, torch.int32), POISSON,
            extras=(_t(mu), _t(sig)))
        for p in range(len(pc)):
            sl = (slice(None), pj[p], slice(pt[p], pt[p] + Tb))
            want = jfl.fused_col_block_ll(
                jnp.asarray(cands[p]), jnp.asarray(W[pc[p]]),
                jnp.asarray(y[sl].T), jax_cellfn_ep,
                extras=(jnp.asarray(mu[sl].T), jnp.asarray(sig[sl].T)),
                interpret=True)
            _close(got[p], np.asarray(want) - _col_pad(n, Tb) * PAD_CELL)


def test_extras_shape_is_checked():
    y = torch.rand(3, 4)
    with pytest.raises(ValueError, match="extras mu"):
        F.fused_row_ll_batched(torch.rand(3, 2, 2), torch.rand(1, 4, 2), y,
                               torch.zeros(3, dtype=torch.int32),
                               torch.arange(3, dtype=torch.int32), POISSON,
                               extras=(torch.rand(3, 5), torch.rand(3, 5)))


# ----------------------------------------------------------------------
# proposals and block conditionals from the same state
# ----------------------------------------------------------------------
def _ep_pair(schedule, bs, seed=3, n=5, m=4, T=11, k=2, nchains=2):
    """Both models at one state. The prior scales are set to 1 and the EP
    is tight (sig ~ 0.5), so the block precisions are well conditioned
    and two float32 Cholesky solves agree to rtol=1e-5 (at the random
    initial horseshoe scales the equilibrated condition number reaches
    3e4, and the two float32 solves then differ by ~1e-3)."""
    Y, C, W0, V0, Mu = _problem(seed, n, m, T, k)
    rng = np.random.default_rng(seed + 100)
    mu_ep = Mu + rng.normal(0, 0.1, Mu.shape)
    mu_ep[0, 1, 2:5] = np.nan
    ep = (mu_ep, rng.uniform(0.4, 0.6, Mu.shape))
    common = dict(nembeds=k, tf_order=2, sigma2_init=0.5, lam2_init=0.1,
                  W_init=W0, V_init=V0, gass_ngrid=16, v_block_size=bs,
                  v_schedule=schedule, seed=1, nchains=nchains,
                  ep_approx=ep)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = JaxModel(n, m, T, jax_loglik, C,
                      loglikelihood_cellfn=jax_cellfn, **common)
        tm = TorchModel(n, m, T, torch_loglik, C, device="cpu",
                        loglikelihood_cellfn=POISSON, **common)
    jm.Tau2 = np.ones(np.shape(jm.Tau2), np.float32)
    jm.lam2 = np.ones(np.shape(jm.lam2), np.float32)
    tm.load_state({k_: np.asarray(v) for k_, v in jm.state.items()})
    return jm, tm


def test_w_ep_proposal_matches_jax():
    jm, tm = _ep_pair("redblack", 4)
    st = tm.state
    L, mu_all = tm._w_proposal(st["V"], st["sigma2"])
    Q = (L @ L.mT).numpy()
    k = tm.nembeds
    mask = np.asarray(jm._wmask)
    Mu, Sig = jnp.asarray(jm.Mu_ep), jnp.asarray(jm.Sigma_ep)
    Sinv2 = jnp.where(jnp.isnan(Mu), 0.0, 1.0 / Sig ** 2)
    Mu0 = jnp.where(jnp.isnan(Mu), 0.0, Mu)
    hp = jax.lax.Precision.HIGHEST
    for c in range(tm.nchains):
        V = jnp.asarray(jm.state["V"][c])
        jQ = (jnp.einsum("imt,mta,mtb->iab", Sinv2, V, V, precision=hp)
              * mask[:, :, None] * mask[:, None, :]
              + np.eye(k, dtype=np.float32) / jm.state["sigma2"][c])
        mu_part = jnp.einsum("imt,mta->ia", Mu0 * Sinv2, V,
                             precision=hp) * mask
        jL = j_cholesky_psd(jQ)
        jmu = jax.vmap(lambda Lq, b: jax.scipy.linalg.cho_solve(
            (Lq, True), b))(jL, mu_part)
        np.testing.assert_allclose(Q[c], np.asarray(jQ), rtol=1e-5,
                                   atol=1e-5 * float(jnp.abs(jQ).max()))
        np.testing.assert_allclose(mu_all[c].numpy(), np.asarray(jmu),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule,bs", [("redblack", 4), ("seq", 3),
                                         ("seq", None)])
def test_v_ep_block_conditionals_match_jax(rng, schedule, bs):
    """Every block of every round: the coupled precision (t-major), the
    conditional mean and the draw from the same z equal the JAX
    expressions (constrained.py:645-681)."""
    jm, tm = _ep_pair(schedule, bs)
    st = tm.state
    W = (st["W"] * tm._wmask).contiguous()
    DtLD = tm._v_prior_dtld(st["lam2"], st["Tau2"])
    G, mu_part = tm._v_ep_terms(W)
    X = st["V"]
    k = tm.nembeds
    Mu, Sig = jnp.asarray(jm.Mu_ep), jnp.asarray(jm.Sigma_ep)
    Sinv2 = jnp.where(jnp.isnan(Mu), 0.0, 1.0 / Sig ** 2)
    Mu0 = jnp.where(jnp.isnan(Mu), 0.0, Mu)
    hp = jax.lax.Precision.HIGHEST
    if bs is None:
        assert [ph.size for ph in tm._phases] == [tm.ndepth]
    for ph in tm._phases:
        nblk, size = len(ph.starts), ph.size
        z = rng.normal(size=(tm.nchains, tm.ncols, nblk, size, k)).astype(
            np.float32)
        X_out = X * ph.t_mask[:, None]
        mu_b, v_b = tm._block_gaussian(DtLD, G, mu_part, X_out, ph.tidx,
                                       torch.as_tensor(z))
        Qbb = ep_block_precision(
            DtLD[:, :, ph.tidx[:, :, None], ph.tidx[:, None, :]],
            G[:, :, ph.tidx])
        for c in range(tm.nchains):
            Wj = jnp.asarray(W[c].numpy())
            jG = jnp.einsum("ijt,ia,ib->jtab", Sinv2, Wj, Wj, precision=hp)
            jmp = jnp.einsum("ijt,ia->jta", Mu0 * Sinv2, Wj, precision=hp)
            jD = jnp.asarray(jm._v_prior_dtld(jm.state["lam2"][c],
                                              jm.state["Tau2"][c]))
            Xc = jnp.asarray(X[c].numpy())
            for b, s0 in enumerate(ph.starts):
                e0 = s0 + size
                D_blk = jD[:, s0:e0, s0:e0]
                cross = jnp.einsum("mts,msk->mtk", jD[:, s0:e0, :],
                                   Xc.at[:, s0:e0].set(0.0), precision=hp)
                rhs = (jmp[:, s0:e0] - cross).reshape(tm.ncols, size * k)
                Qd = (jnp.einsum("mts,ab->mtasb", D_blk, np.eye(k),
                                 precision=hp)
                      + jnp.einsum("mtab,ts->mtasb", jG[:, s0:e0],
                                   np.eye(size), precision=hp))
                jQ = Qd.reshape(tm.ncols, size * k, size * k)
                d = jnp.diagonal(jQ, axis1=-2, axis2=-1)
                dinv = jax.lax.rsqrt(jnp.where(d > 0, d, 1.0))
                jL = j_cholesky_psd(jQ * dinv[:, :, None] * dinv[:, None, :])
                jmu = j_cho_solve(jL, rhs * dinv) * dinv
                jv = jax.lax.linalg.triangular_solve(
                    jL, jnp.asarray(z[c, :, b]).reshape(
                        tm.ncols, size * k)[..., None],
                    left_side=True, lower=True, transpose_a=True)[..., 0] \
                    * dinv
                scale = float(jnp.abs(jQ).max())
                np.testing.assert_allclose(Qbb[c, :, b].numpy(),
                                           np.asarray(jQ), rtol=1e-5,
                                           atol=1e-6 * scale)
                np.testing.assert_allclose(mu_b[c, :, b].numpy(),
                                           np.asarray(jmu), rtol=1e-5,
                                           atol=1e-5)
                np.testing.assert_allclose(v_b[c, :, b].numpy(),
                                           np.asarray(jv), rtol=1e-5,
                                           atol=1e-5)


def test_overconfident_ep_warns_as_in_jax():
    n, m, T, k = 4, 3, 6, 2
    _, C, W0, V0, Mu = _problem(1, n, m, T, k)
    ep = (Mu * 10.0, np.full(Mu.shape, 1e-3))
    with pytest.warns(UserWarning, match="Sigma_ep is small"):
        TorchModel(n, m, T, torch_loglik, C, device="cpu", nembeds=k,
                   tf_order=0, W_init=W0, V_init=V0, ep_approx=ep,
                   loglikelihood_cellfn=POISSON)
    with pytest.raises(ValueError, match="ep_approx must be"):
        TorchModel(n, m, T, torch_loglik, C, device="cpu", nembeds=k,
                   tf_order=0, W_init=W0, V_init=V0,
                   ep_approx=(Mu[:, :, :2], Mu[:, :, :2]),
                   loglikelihood_cellfn=POISSON)


def test_seq_ep_matches_jax_seq_ep_in_distribution():
    """The politics recipe in small: seq schedule, EP-centred proposals.
    The port (plain path) and the JAX package (its shipped unfused path)
    reach the same posterior mean of Mu (rel < 0.12, the criterion of
    tests/test_constrained.py:397-441), every draw feasible."""
    n, m, T, k = 6, 5, 11, 2
    rng = np.random.default_rng(17)
    W = rng.gamma(1, 1, (n, k))
    W[np.triu_indices(k, 1)] = 0
    V = np.abs(rng.normal(1, .3, (m, T, k)))
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(Mu).astype(float)
    Y[0, 1] = np.nan
    C = np.concatenate([np.eye(T), np.zeros((T, 1))], axis=1)
    W0 = np.abs(rng.normal(1, .2, (n, k)))
    W0[np.triu_indices(k, 1)] = 0
    V0 = np.abs(rng.normal(1, .2, (m, T, k)))
    ep = (Mu + rng.normal(0, 0.1, Mu.shape), np.full(Mu.shape, 8.0))
    common = dict(nembeds=k, tf_order=0, sigma2_init=0.5, lam2_init=0.1,
                  W_init=W0, V_init=V0, gass_ngrid=40, v_block_size=3,
                  v_schedule="seq", ep_approx=ep, seed=7)
    jm = JaxModel(n, m, T, jax_loglik, C, loglikelihood_cellfn=jax_cellfn,
                  **common)
    tm = TorchModel(n, m, T, torch_loglik, C, device="cpu",
                    loglikelihood_cellfn=POISSON, **common)
    means = {}
    for tag, mod in (("jax", jm), ("torch", tm)):
        res = mod.run_gibbs(Y, nburn=400, nthin=1, nsamples=400,
                            verbose=False)
        mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        assert mu.min() >= -1e-5, tag
        assert np.isfinite(mu).all(), tag
        means[tag] = mu.mean(0)
    rel = np.abs(means["jax"] - means["torch"]).mean() / np.sqrt(
        (Mu ** 2).mean())
    assert rel < 0.12, rel


# ----------------------------------------------------------------------
# the EP kernels on a card
# ----------------------------------------------------------------------
@pytest.mark.cuda
def test_row_ep_kernel_matches_plain_on_card(rng, cuda_device):
    R, nch, n, G, k, C = 6, 2, 3, 101, 5, 4332
    y, mu, sig = _ep_cells(rng, (n, C), k)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    cands = t(rng.gamma(2, 1, size=(R, G, k)))
    bt = t(rng.gamma(1, 0.5, size=(nch, C, k)))
    rc = torch.tensor([0, 1] * 3, dtype=torch.int32, device=cuda_device)
    ri = torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32,
                      device=cuda_device)
    ex = (t(mu), t(sig))
    before = F.launch_counts["fused_row_ll_ep"]
    got = F.fused_row_ll_batched(cands, bt, t(y), rc, ri, POISSON, ex)
    assert F.launch_counts["fused_row_ll_ep"] == before + 1
    want = F.row_ll_plain(cands, bt, t(y), rc, ri, POISSON, ex)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("Tb, ep", [(8, True), (228, True), (228, False)])
def test_col_kernel_matches_plain_on_card_ep_and_joint(rng, cuda_device, Tb,
                                                       ep):
    nch, n, m, T, k, G, P = 2, 19, 4, 228, 5, 101, 6
    y, mu, sig = _ep_cells(rng, (n, m, T), k)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    cands = t(rng.gamma(2, 1, size=(P, G, Tb, k)))
    w = t(rng.gamma(1, 0.5, size=(nch, n, k)))
    pc = torch.as_tensor(rng.integers(0, nch, P), **i32)
    pj = torch.as_tensor(rng.integers(0, m, P), **i32)
    pt = torch.as_tensor(rng.integers(0, T - Tb + 1, P), **i32)
    ex = (t(mu), t(sig)) if ep else ()
    got = F.fused_col_block_ll_batched(cands, w, t(y), pc, pj, pt, POISSON,
                                       ex)
    want = F.col_block_ll_plain(cands, w, t(y), pc, pj, pt, POISSON, ex)
    torch.cuda.synchronize()
    _close(got.cpu(), want.cpu(), rtol=1e-5, atol=1e-3)
