"""The port's BNP-CovReg (apps/flutrends/bnp_covreg.py) against the JAX
package's.

The kernel and ``_mu_and_vardiag`` agree to float32 (equal; rtol=1e-5).
The GP conditional draw, each of the six Gibbs steps and one whole
iteration get JAX's own draws (its key splits, reproduced here and given
back at the port's draw sites ``_draw_scan_noise``, ``_normals`` and
``_gammas``) from one state carried across with ``interop``, and agree
to the tolerance each test states. The Matheron identity and the draw's
moments are tests/test_bnp_covreg.py's checks on the port; a short chain
agrees with JAX chains in distribution.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from functionalmf_tpu.apps.flutrends import bnp_covreg as jbnp
from functionalmf_tpu_torch.apps.flutrends import bnp_covreg as tbnp
from functionalmf_tpu_torch.interop import state_from_numpy, state_to_numpy
from tests.test_torch_constrained import torch_one_thread  # noqa: F401

P, N, L, K_ = 6, 30, 3, 4            # small: p, N, L, k
HP = dict(a_sig=1.0, b_sig=0.1, a_phi=1.5, b_phi=1.5, a1=10.0, a2=10.0)


def t(x):
    return torch.as_tensor(np.array(x, np.float32))


def problem(seed=0):
    """Data with about 15% missing, the kernel, and a state of the
    sampler's form (no chain axis) as numpy."""
    rng = np.random.default_rng(seed)
    inds = rng.random((P, N)) > 0.15
    y = np.where(inds, rng.normal(size=(P, N)), 0.0)
    K = jbnp.se_kernel(N, c=30.0)
    state = dict(theta=rng.normal(0, 0.5, (P, L)),
                 zeta=rng.normal(0, 0.3, (L, K_, N)),
                 psi=rng.normal(size=(K_, N)), xi=rng.normal(size=(K_, N)),
                 phi=rng.gamma(2.0, 1.0, (P, L)),
                 delta=rng.gamma(3.0, 1.0, L),
                 invSig=rng.uniform(4.0, 10.0, P))
    return y, inds.astype(float), K, np.linalg.cholesky(K), state


def both(seed=0):
    """The problem as JAX arrays and as the port's CPU tensors; the state
    crosses as the JAX state's numpy arrays through interop."""
    y, inds, K, cK, st = problem(seed)
    jargs = [jnp.asarray(x, jnp.float32) for x in (y, inds, K, cK)]
    jst = {a: jnp.asarray(v, jnp.float32) for a, v in st.items()}
    tst = state_from_numpy({a: np.asarray(v) for a, v in jst.items()}, "cpu")
    return jst, jargs, tst, [t(x) for x in (y, inds, K, cK)]


# ----------------------------------------------------------------------
# JAX's draws, in its own key splits
# ----------------------------------------------------------------------
def jax_gp_noise(key, n):
    """_sample_gp_conditional's (e0, z) (bnp_covreg.py:66-68)."""
    k1, k2 = jax.random.split(key)
    return jax.random.normal(k1, (n,)), jax.random.normal(k2, (n,))


def jax_scan_noise(key, nrows, k, n):
    """The permutations and each step's (e0, z) of the zeta (:86-90) and
    psi (:144-147) scans, as the port's ``_draw_scan_noise`` returns
    them."""
    kperm, kscan = jax.random.split(key)
    perms = jax.vmap(lambda kk: jax.random.permutation(kk, k))(
        jax.random.split(kperm, nrows))
    e0, z = jax.vmap(lambda kk: jax_gp_noise(kk, n))(
        jax.random.split(kscan, nrows * k))
    return (torch.as_tensor(np.array(perms)).long(), t(e0), t(z))


def jax_normals(key, nitems, dim):
    """xi's (:168) and theta's (:189) normals: one key an item."""
    return t(jax.vmap(lambda kk: jax.random.normal(kk, (dim,)))(
        jax.random.split(key, nitems)))


def jax_hyper_gammas(key, p, L, ninner=50):
    """_sample_hypers' standard-gamma draws (:213-235): phi's (ninner, p,
    L), then delta's (ninner, L)."""
    a = np.array([HP["a1"]] + [HP["a2"]] * (L - 1), np.float32)
    g_phi, g_delta = [], []
    for kiter in jax.random.split(key, ninner):
        k1, k2 = jax.random.split(kiter)
        g_phi.append(jax.random.gamma(
            k1, HP["a_phi"] + 0.5 * jnp.ones((p, L), jnp.float32)))
        g_delta.append([jax.random.gamma(kh, jnp.float32(
            a[hh] + 0.5 * p * (L - hh)))
            for hh, kh in enumerate(jax.random.split(k2, L))])
    return t(g_phi), t(g_delta)


def jax_invsig_gammas(key, inds):
    return t(jax.random.gamma(key, HP["a_sig"] + 0.5 * jnp.asarray(
        inds, jnp.float32).sum(axis=1)))


def inject(monkeypatch, scans=(), normals=(), gammas=()):
    """The port's draw sites give back these draws, in order."""
    q = dict(scan=list(scans), normal=list(normals), gamma=list(gammas))
    monkeypatch.setattr(tbnp, "_draw_scan_noise",
                        lambda *a: q["scan"].pop(0))
    monkeypatch.setattr(tbnp, "_normals", lambda *a: q["normal"].pop(0))
    monkeypatch.setattr(tbnp, "_gammas", lambda *a: q["gamma"].pop(0))
    return q


# ----------------------------------------------------------------------
# deterministic pieces
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(), dict(c=30.0, d=2.0, r=1e-4)])
def test_se_kernel_equal(kw):
    np.testing.assert_array_equal(tbnp.se_kernel(37, **kw),
                                  jbnp.se_kernel(37, **kw))


def test_mu_and_vardiag_match_jax():
    jst, _, tst, _ = both()
    for got, want in zip(tbnp._mu_and_vardiag(tst),
                         jbnp._mu_and_vardiag(jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


# ----------------------------------------------------------------------
# the GP conditional draw
# ----------------------------------------------------------------------
def test_gp_conditional_matches_jax_under_its_draws(monkeypatch):
    """At N=40, c=100 (the flu kernel's bandwidth) with some A = 0: float32
    through B = S K S + I, whose condition reaches 1 + max(A) lambda_max(K)
    (about 40 here); atol=2e-5 on draws of order 1."""
    n = 40
    rng = np.random.default_rng(1)
    K = jbnp.se_kernel(n)
    A = np.abs(rng.normal(size=n)) * (rng.random(n) > 0.2)
    h = rng.normal(size=n) * (A > 0)
    cK = np.linalg.cholesky(K)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jbnp._sample_gp_conditional(
        key, *(jnp.asarray(x, jnp.float32) for x in (A, h, K, cK))))
    inject(monkeypatch, normals=[t(x) for x in jax_gp_noise(key, n)])
    fails = torch.zeros((), dtype=torch.int64)
    got = tbnp._sample_gp_conditional(None, t(A), t(h), t(K), t(cK),
                                      fails=fails).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert int(fails) == 0


def test_matheron_matches_information_form():
    """tests/test_bnp_covreg.py's identity on the port's kernel: the
    pathwise draw's mean and covariance equal (invK + diag(A))^{-1}
    applied to the information vector, densely in float64."""
    rng = np.random.default_rng(42)
    n = 40
    K = tbnp.se_kernel(n, c=100.0, d=1.0, r=1e-5)
    A = np.abs(rng.normal(size=n)) * (rng.random(n) > 0.2)
    h = rng.normal(size=n) * (A > 0)
    Sig = np.linalg.inv(np.linalg.inv(K) + np.diag(A))
    S = np.sqrt(A)
    Binv = np.linalg.inv(S[:, None] * K * S[None, :] + np.eye(n))
    hS = np.where(A > 0, h / np.maximum(S, 1e-300), 0.0)
    C1 = np.eye(n) - K @ (S[:, None] * Binv * S[None, :])
    C2 = K @ (S[:, None] * Binv)
    np.testing.assert_allclose(K @ (S * (Binv @ hS)), Sig @ h, rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_allclose(C1 @ K @ C1.T + C2 @ C2.T, Sig, rtol=1e-7,
                               atol=1e-9)


def test_gp_conditional_sample_moments():
    """4000 batched float32 draws of the port against the dense float64
    posterior moments (tests/test_bnp_covreg.py:45-63): means within 5
    standard errors + 1e-4, variances within 25%."""
    rng = np.random.default_rng(42)
    n = 25
    K = tbnp.se_kernel(n, c=30.0, d=1.0, r=1e-4)
    A = np.abs(rng.normal(size=n)) + 0.5
    h = rng.normal(size=n)
    Sig = np.linalg.inv(np.linalg.inv(K) + np.diag(A))
    gen = torch.Generator().manual_seed(0)
    draws = tbnp._sample_gp_conditional(
        gen, t(A).expand(4000, n), t(h).expand(4000, n), t(K),
        t(np.linalg.cholesky(K))).double().numpy()
    se = np.sqrt(np.diag(Sig) / draws.shape[0])
    assert np.all(np.abs(draws.mean(0) - Sig @ h) < 5 * se + 1e-4)
    np.testing.assert_allclose(draws.var(0), np.diag(Sig), rtol=0.25,
                               atol=1e-5)


# ----------------------------------------------------------------------
# the six steps and one iteration under JAX's draws
# ----------------------------------------------------------------------
def test_zeta_and_psi_scans_match_jax_under_its_draws(monkeypatch):
    """The zeta scan (L k = 12 sequential GP updates) and a psi scan of 5
    passes (20 updates), each carrying its residual through every step in
    float32: atol=5e-5 on values of order 1 (measured about 6e-6 and 1e-6:
    the port factors all B matrices batched before the scan, JAX one a
    step)."""
    jst, ja, tst, ta = both()
    key = jax.random.PRNGKey(3)
    inject(monkeypatch, scans=[jax_scan_noise(key, L, K_, N),
                               jax_scan_noise(key, 5, K_, N)])
    fails = torch.zeros((), dtype=torch.int64)
    got = tbnp._sample_zeta(None, tst, *ta, L, K_, fails).numpy()
    want = np.asarray(jbnp._sample_zeta(key, jst, *ja, L, K_))
    np.testing.assert_allclose(got, want, atol=5e-5)
    assert not np.allclose(got, np.asarray(jst["zeta"]))
    got = tbnp._sample_psi(None, tst, *ta, K_, 5, fails).numpy()
    want = np.asarray(jbnp._sample_psi(key, jst, *ja, K_, 5))
    np.testing.assert_allclose(got, want, atol=5e-5)
    assert int(fails) == 0


def test_xi_theta_invsig_match_jax_under_their_draws(monkeypatch):
    """The batched k x k (xi) and L x L (theta) Gaussian draws and the
    invSig gamma draw: rtol=1e-5, atol=1e-5."""
    jst, ja, tst, ta = both(1)
    y, inds = ta[0], ta[1]
    key = jax.random.PRNGKey(7)
    inject(monkeypatch, normals=[jax_normals(key, N, K_),
                                 jax_normals(key, P, L)],
           gammas=[jax_invsig_gammas(key, ja[1])])
    for name, jfn, tfn in (
            ("xi", lambda: jbnp._sample_xi(key, jst, ja[0], ja[1]),
             lambda: tbnp._sample_xi(None, tst, y, inds)),
            ("theta", lambda: jbnp._sample_theta(key, jst, ja[0], ja[1]),
             lambda: tbnp._sample_theta(None, tst, y, inds)),
            ("invSig", lambda: jbnp._sample_invSig(
                key, jst, ja[0], ja[1], HP["a_sig"], HP["b_sig"]),
             lambda: tbnp._sample_invSig(None, tst, y, inds, HP["a_sig"],
                                         HP["b_sig"]))):
        np.testing.assert_allclose(tfn().numpy(), np.asarray(jfn()),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_hypers_match_jax_under_their_draws(monkeypatch):
    """50 outer passes of phi and the sequential delta recursion: the port
    takes tau by cumprod where JAX takes exp(cumsum(log)), and sums before
    dividing by delta_h; rtol=2e-5."""
    jst, _, tst, _ = both(2)
    key = jax.random.PRNGKey(5)
    inject(monkeypatch, gammas=jax_hyper_gammas(key, P, L))
    want = jbnp._sample_hypers(key, jst, HP["a_phi"], HP["b_phi"],
                               HP["a1"], HP["a2"])
    got = tbnp._sample_hypers(None, tst, HP["a_phi"], HP["b_phi"],
                              HP["a1"], HP["a2"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5)
    assert not np.allclose(got[1].numpy(), np.asarray(jst["delta"]))


def test_gibbs_iter_matches_jax_under_its_draws(monkeypatch):
    """One whole iteration (invSig, hypers, theta, psi of 5 passes, xi,
    zeta) from a state carried across: each step starts from the last
    one's float32 result, so the errors of the scans compound; atol=1e-4,
    rtol=1e-4 on every entry of the state."""
    jst, ja, tst, ta = both(3)
    key = jax.random.PRNGKey(11)
    ks = jax.random.split(key, 6)
    inject(monkeypatch,
           gammas=[jax_invsig_gammas(ks[0], ja[1]),
                   *jax_hyper_gammas(ks[1], P, L)],
           normals=[jax_normals(ks[2], P, L), jax_normals(ks[4], N, K_)],
           scans=[jax_scan_noise(ks[3], 5, K_, N),
                  jax_scan_noise(ks[5], L, K_, N)])
    want = jbnp._gibbs_iter(key, jst, *ja, L, K_, HP, psi_iters=5)
    got = state_to_numpy(tbnp._gibbs_iter(None, tst, *ta, L, K_, HP,
                                          psi_iters=5))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


# ----------------------------------------------------------------------
# the fit
# ----------------------------------------------------------------------
def _toy(seed=1, p=8, n=60):
    """tests/test_bnp_covreg.py:66-91's problem: a smooth rank-2 mean,
    noise sd 0.3, two held-out blocks."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, n)
    basis = np.stack([np.sin(2 * np.pi * x), np.cos(3 * np.pi * x)])
    mu_true = rng.normal(size=(p, 2)) @ basis
    y = mu_true + rng.normal(0, 0.3, size=(p, n))
    inds = np.ones((p, n), bool)
    inds[0, 10:25] = False
    inds[3, 40:55] = False
    return np.where(inds, y, np.nan), inds, mu_true


def test_fit_on_cpu_schema_chunks_and_device_default():
    """Keys and shapes of the JAX package's return dict, finite draws,
    var_diag > 0; a run cut into chunks of 5 draws what a run in chunks of
    10 does; the card by default, float32 only, chunk against
    store_every checked."""
    y, _, _ = _toy(p=5, n=24)
    kw = dict(L=3, k=3, niter=20, store_every=10, c=30.0, seed=2,
              device="cpu")
    out = tbnp.fit_bnp_covreg(y, chunk=5, **kw)
    assert set(out) == {"mu", "var_diag", "state"}
    assert out["mu"].shape == out["var_diag"].shape == (2, 5, 24)
    assert np.isfinite(out["mu"]).all() and (out["var_diag"] > 0).all()
    assert {k: v.shape for k, v in out["state"].items()} == dict(
        theta=(5, 3), zeta=(3, 3, 24), psi=(3, 24), xi=(3, 24),
        phi=(5, 3), delta=(3,), invSig=(5,))
    again = tbnp.fit_bnp_covreg(y, chunk=10, dtype="float32", **kw)
    np.testing.assert_array_equal(again["mu"], out["mu"])
    sig = inspect.signature(tbnp.fit_bnp_covreg).parameters
    assert sig["device"].default == "cuda"
    assert list(sig)[:-1] == list(
        inspect.signature(jbnp.fit_bnp_covreg).parameters)
    with pytest.raises(ValueError, match="float32"):
        tbnp.fit_bnp_covreg(y, dtype=torch.float64, **kw)
    with pytest.raises(ValueError, match="chunk"):
        tbnp.fit_bnp_covreg(y, chunk=3, **kw)


def test_posterior_mean_agrees_with_jax_in_distribution():
    """The toy problem at p=8, N=60, L=4, k=4, c=30, 300 iterations
    (nburn 100): the port's posterior mean of mu lies within twice the
    spread of two JAX seeds' (RMS over the cells), and recovers the
    truth as JAX's does."""
    y, inds, mu_true = _toy()
    kw = dict(L=4, k=4, niter=300, store_every=10, nburn=100, c=30.0,
              chunk=50)
    jm = [jbnp.fit_bnp_covreg(y, seed=s, **kw)["mu"].mean(0) for s in (1, 2)]
    tm = tbnp.fit_bnp_covreg(y, seed=1, device="cpu", **kw)["mu"].mean(0)
    spread = np.sqrt(np.mean((jm[0] - jm[1]) ** 2))
    rel = np.sqrt(np.mean((tm - jm[0]) ** 2))
    assert rel < 2 * spread, (rel, spread)
    assert np.sqrt(np.mean((tm - mu_true)[inds] ** 2)) < 0.5 * 0.3
