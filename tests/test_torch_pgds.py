"""The port's PGDS pieces (ops/crt.py, ops/gamma.py's log-space draws,
models/pgds.py's steps) against the JAX package.

Deterministic steps agree to float32 tolerance; a stochastic step given
JAX's own draws (its key split, injected) agrees as stated at each test;
every draw from a library sampler (torch.poisson, torch.binomial,
torch._standard_gamma) is tested in distribution, here or in
tests/test_torch_pgds_chain.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import digamma as jdigamma
from scipy import stats

from functionalmf_tpu.models import pgds as jpgds
from functionalmf_tpu.ops import crt as jcrt
from functionalmf_tpu_torch.models import pgds as tpgds
from functionalmf_tpu_torch.ops import crt as tcrt
from functionalmf_tpu_torch.ops.gamma import dirichlet, log_gamma

from tests.test_torch_constrained import torch_one_thread  # noqa: F401


def t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def gen(seed):
    return torch.Generator().manual_seed(seed)


# ----------------------------------------------------------------------
# the CRT under JAX's own draws
# ----------------------------------------------------------------------
def _jax_crt_draws(key, n, r, n_exact=128):
    """The draws JAX's chinese_restaurant_table takes from its key, in its
    own split (functionalmf_tpu/ops/crt.py:49-65): the exact part's
    uniforms (kb), the tail's Poisson draw at JAX's tail mean (kp) and its
    normals (kn)."""
    n, r = jnp.asarray(n, jnp.float32), jnp.asarray(r, jnp.float32)
    kb, kp, kn = jax.random.split(key, 3)
    u = jax.random.uniform(kb, n.shape + (n_exact,))
    nt = jnp.where(n > n_exact, n, n_exact + 1.0)
    rs = jnp.clip(r, 1e-20, None)
    mu = rs * (jdigamma(rs + nt) - jdigamma(rs + n_exact))
    pois = jax.random.poisson(kp, jnp.clip(mu, 0.0, None)).astype(jnp.float32)
    return u, jax.random.normal(kn, n.shape), pois


def test_crt_matches_jax_under_its_draws():
    """Lanes with n <= 128 are the exact part alone: bit for bit equal.
    Tail lanes may differ by one table, where the rounded-normal tail's
    mean (float32 digamma and trigamma of two libraries) lies within
    rounding of a half-integer; of the 3000 tail lanes here (933
    rounded-normal, 2067 Poisson) none does, and the test allows 0.5%."""
    rng = np.random.default_rng(0)
    S = 6000
    n = np.concatenate([rng.integers(0, 129, S // 2),
                        rng.integers(129, 3000, S // 2)]).astype(np.float32)
    r = (10.0 ** rng.uniform(-3, 3, S)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jcrt.chinese_restaurant_table(key, n, r))
    u, z, pois = (t(x) for x in _jax_crt_draws(key, n, r))
    got = tcrt.chinese_restaurant_table(None, t(n), t(r),
                                        noise=(u, z, pois)).numpy()
    exact = n <= 128
    np.testing.assert_array_equal(got[exact], want[exact])
    d = np.abs(got - want)[~exact]
    assert d.max() <= 1.0, d.max()
    assert (d > 0).mean() < 0.005, (d > 0).mean()
    small_p = np.maximum(r, 1e-20) < 0.1 * (np.maximum(r, 1e-20) + 128)
    assert (d[small_p[~exact]] == 0).all()
    assert ((got >= np.minimum(n, 1)) & (got <= n)).all()


def test_crt_prepare_then_finish_is_the_whole_draw():
    """The backward pass's split (the exact terms' cumulative count
    gathered at min(n, 128)) draws what the one-call CRT draws."""
    rng = np.random.default_rng(2)
    n = t(rng.integers(0, 400, (7, 5)))
    r = t(10.0 ** rng.uniform(-2, 2.5, (7, 5)))
    u, z = tcrt.draw_crt_noise(gen(3), (7, 5))
    pois = torch.poisson(t(rng.uniform(0, 5, (7, 5))), generator=gen(4))
    whole = tcrt.chinese_restaurant_table(None, n, r, noise=(u, z, pois))
    prep = tcrt.crt_prepare(r, u)
    rows = [tcrt.crt_finish(None, n[i], [x[i] for x in prep], z[i], pois[i])
            for i in range(7)]
    assert torch.equal(torch.stack(rows), whole)


def _crt_exact(rng, n, r, size):
    i = np.arange(1, n + 1)
    p = r / (r + i - 1)
    return (rng.random((size, n)) < p).sum(1)


@pytest.mark.parametrize("n,r", [
    (5, 1.0),          # all-exact branch
    (50, 3.0),         # all-exact branch
    (500, 2.0),        # Poisson tail (small r)
    (5000, 10.0),      # Poisson tail, long
    (300, 200.0),      # normal tail (large r)
    (2000, 500.0),     # normal tail, long
])
def test_crt_matches_exact_sampler(n, r):
    """tests/test_pgds.py's check: the hybrid CRT against a brute-force
    Bernoulli sum, two-sample KS at alpha=1e-3 and the mean within 4 se."""
    S = 4000
    ours = tcrt.chinese_restaurant_table(
        gen(7), torch.full((S,), float(n)), torch.full((S,), r)).numpy()
    exact = _crt_exact(np.random.default_rng(0), n, r, S)
    ks = stats.ks_2samp(ours, exact)
    assert ks.pvalue > 1e-3, (n, r, ks)
    assert abs(ours.mean() - exact.mean()) < 4 * exact.std() / np.sqrt(S)


def test_crt_edge_cases():
    n = t([0.0, 1.0, 1.0, 10.0])
    r = t([5.0, 5.0, 1e-8, 0.0])
    out = tcrt.chinese_restaurant_table(gen(0), n, r).numpy()
    assert out[0] == 0.0          # no customers, no tables
    assert out[1] == 1.0          # the first customer opens a table
    assert out[2] == 1.0
    assert 0 <= out[3] <= 10


# ----------------------------------------------------------------------
# the multinomial split (torch.binomial) in distribution
# ----------------------------------------------------------------------
def test_multinomial_split_exactness():
    S = 5000
    p = t(np.tile([0.1, 0.2, 0.3, 0.4], (S, 1)))
    c = tcrt.multinomial_split(gen(1), torch.full((S,), 50.0), p).numpy()
    assert (c.sum(-1) == 50).all()
    assert (c >= 0).all()
    for j, pj in enumerate([0.1, 0.2, 0.3, 0.4]):
        se = np.sqrt(50 * pj * (1 - pj) / S)
        assert abs(c[:, j].mean() - 50 * pj) < 4 * se, j
        # each cell is Binomial(50, p_j): its variance too
        assert abs(c[:, j].var() / (50 * pj * (1 - pj)) - 1) < 0.1, j


def test_multinomial_split_zero_and_degenerate():
    c = tcrt.multinomial_split(gen(2), t([0.0, 7.0]),
                               t([[0.5, 0.5], [1.0, 0.0]])).numpy()
    assert (c[0] == 0).all()
    assert c[1, 0] == 7 and c[1, 1] == 0


def test_multinomial_split_large_counts_and_zero_cells():
    """Counts beyond the inversion range of the binomial sampler (its
    BTRS branch) and cells of probability 0 in the middle of the chain."""
    S = 4000
    p = t(np.tile([0.25, 0.0, 0.5, 0.25], (S, 1)))
    c = tcrt.multinomial_split(gen(3), torch.full((S,), 1e5), p).numpy()
    assert (c.sum(-1) == 1e5).all() and (c[:, 1] == 0).all()
    for j, pj in ((0, 0.25), (2, 0.5), (3, 0.25)):
        se = np.sqrt(1e5 * pj * (1 - pj) / S)
        assert abs(c[:, j].mean() - 1e5 * pj) < 4 * se, j


# ----------------------------------------------------------------------
# log-space gamma and the Dirichlet
# ----------------------------------------------------------------------
@pytest.mark.parametrize("a", [0.05, 0.3, 1.0, 4.0])
def test_log_gamma_in_distribution(a):
    """exp(log_gamma(a)) is Gamma(a, 1): KS against scipy, both branches
    (the boost below 1, torch._standard_gamma above)."""
    lg = log_gamma(gen(5), torch.full((20000,), a)).double().numpy()
    assert np.isfinite(lg).all()
    ks = stats.kstest(np.exp(lg), stats.gamma(a).cdf)
    assert ks.pvalue > 1e-3, (a, ks)


def test_dirichlet_moments():
    alpha = np.array([0.1, 0.5, 2.0, 7.4])
    S = 20000
    x = dirichlet(gen(6), t(np.tile(alpha, (S, 1)))).double().numpy()
    np.testing.assert_allclose(x.sum(-1), 1.0, atol=1e-5)
    a0 = alpha.sum()
    mean = alpha / a0
    var = mean * (1 - mean) / (a0 + 1)
    assert (np.abs(x.mean(0) - mean) < 4 * np.sqrt(var / S)).all()
    np.testing.assert_allclose(x.var(0), var, rtol=0.06)


def test_dirichlet_at_tiny_concentration():
    """At alpha = 1e-6 every linear gamma draw underflows; the log-space
    draw is finite and sums to one, all its mass on one component."""
    x = dirichlet(gen(8), torch.full((2000, 5), 1e-6))
    assert torch.isfinite(x).all()
    torch.testing.assert_close(x.sum(-1), torch.ones(2000))
    assert (x.max(-1).values > 0.999).all()
    # each component takes the mass equally often
    share = np.bincount(x.argmax(-1).numpy(), minlength=5) / 2000
    assert (np.abs(share - 0.2) < 0.04).all(), share


# ----------------------------------------------------------------------
# the sampler's deterministic steps and its MH step
# ----------------------------------------------------------------------
def test_ztp_matches_jax_with_its_uniforms():
    """Given JAX's uniforms, the zero-truncated Poisson inversion agrees
    but where u lies within float32 rounding of a cdf step (the port sums
    the log-pmf steps with a cumulative sum, JAX in a scan): no such lane
    in these 20000; rates above 64 reach the ceil(lam) guard."""
    rng = np.random.default_rng(1)
    lam = (10.0 ** rng.uniform(-3, 2.2, 20000)).astype(np.float32)
    y = (rng.random(20000) < 0.8).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jpgds._ztp(key, lam, y))
    u = t(jax.random.uniform(key, lam.shape))
    got = tpgds._ztp(u, t(lam), t(y)).numpy()
    diff = got != want
    assert diff.mean() <= 1e-4, diff.mean()
    assert (np.abs(got - want)[diff] <= 1).all()
    assert (got[y == 0] == 0).all() and (got[y > 0] >= 1).all()
    assert (lam > 64).any() and (got[(lam > 80) & (y > 0)] ==
                                 np.ceil(lam[(lam > 80) & (y > 0)])).any()


def _jax_rho(Pi, delta, tau):
    """The rho recursion of JAX's backward scan
    (functionalmf_tpu/models/pgds.py:184-200), alone."""
    K = Pi.shape[0]

    def back(rho_next, d_t):
        return tau * (Pi.T @ jnp.log1p((d_t + rho_next) / tau)), rho_next

    rho0, rho_rev = jax.lax.scan(back, jnp.zeros(K), delta[1:][::-1])
    return jnp.concatenate([rho0[None], rho_rev[::-1]], 0)


def _random_state(rng, K=4, T=15):
    Pi = rng.dirichlet(np.ones(K), size=K).T.astype(np.float32)
    return dict(Pi=Pi, delta=rng.gamma(2.0, 1.0, T).astype(np.float32),
                nu=rng.gamma(2.0, 0.5, K).astype(np.float32),
                xi=np.float32(rng.gamma(2.0, 0.5)),
                theta1=rng.gamma(1.0, 1.0, K).astype(np.float32),
                beta=np.float32(rng.gamma(2.0, 0.5)))


@pytest.mark.parametrize("tau", [0.25, 1.0])
def test_rho_recursion_matches_jax(tau):
    s = _random_state(np.random.default_rng(4), T=40)
    want = np.asarray(_jax_rho(jnp.asarray(s["Pi"]), jnp.asarray(s["delta"]),
                               tau))
    got = tpgds._rho_recursion(t(s["Pi"]), t(s["delta"]), tau).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("tau", [0.5, 1.0])
def test_hyper_logpost_and_its_parts_match_jax(tau):
    rng = np.random.default_rng(5)
    s = _random_state(rng)
    alpha_j = jpgds._pi_alpha(jnp.asarray(s["nu"]), s["xi"])
    alpha_t = tpgds._pi_alpha(t(s["nu"]), t(s["xi"]))
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j),
                               rtol=1e-7)
    P = rng.dirichlet(np.ones(6), size=3).astype(np.float32)
    A = rng.gamma(1.0, 1.0, (3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tpgds._log_dir(t(P), t(A)).numpy(),
        np.asarray(jpgds._log_dir(jnp.asarray(P), jnp.asarray(A))),
        rtol=1e-5)
    args = (s["nu"], s["xi"], s["theta1"], s["Pi"])
    want = float(jpgds._hyper_logpost(*map(jnp.asarray, args), tau, 10.0,
                                      0.1, s["beta"]))
    got = float(tpgds._hyper_logpost(*map(t, args), tau, 10.0, 0.1,
                                     t(s["beta"])))
    assert abs(got - want) <= 1e-5 * abs(want) + 1e-4, (got, want)


def _jax_mh_step(kk, nu, xi, logpost, mh_step):
    """One step of JAX's (nu, xi) MH scan (functionalmf_tpu/models/
    pgds.py:245-262) with its key split; returns its draws too."""
    K = nu.shape[0]
    k1, k2 = jax.random.split(kk)
    z = jax.random.normal(k1, (K + 1,)) * mh_step
    nu_p, xi_p = nu * jnp.exp(z[:K]), xi * jnp.exp(z[K])
    lp_c = logpost(nu, xi) + jnp.log(nu).sum() + jnp.log(xi)
    lp_p = logpost(nu_p, xi_p) + jnp.log(nu_p).sum() + jnp.log(xi_p)
    u = jax.random.uniform(k2)
    acc = jnp.log(u) < (lp_p - lp_c)
    return (jnp.where(acc, nu_p, nu), jnp.where(acc, xi_p, xi), z, u,
            float(lp_p - lp_c - jnp.log(u)))


def test_mh_step_matches_jax_under_its_draws():
    """One (nu, xi) MH step given JAX's (z, u): the same decision and the
    same proposal, for 24 keys (a step of 0.4 so that both happen)."""
    s = _random_state(np.random.default_rng(6))
    tau, gam, eps = 1.0, 10.0, 0.1
    jlp = lambda a, b: jpgds._hyper_logpost(
        a, b, jnp.asarray(s["theta1"]), jnp.asarray(s["Pi"]), tau, gam, eps,
        s["beta"])
    tlp = lambda a, b: tpgds._hyper_logpost(
        a, b, t(s["theta1"]), t(s["Pi"]), tau, gam, eps, t(s["beta"]))
    accepted = []
    for i in range(24):
        nu_j, xi_j, z, u, margin = _jax_mh_step(
            jax.random.PRNGKey(100 + i), jnp.asarray(s["nu"]),
            jnp.asarray(s["xi"]), jlp, 0.4)
        assert abs(margin) > 1e-3       # no decision within rounding
        nu_t, xi_t = tpgds._mh_nu_xi(t(s["nu"]), t(s["xi"]), t(z)[None],
                                     t(u)[None], tlp)
        np.testing.assert_allclose(nu_t.numpy(), np.asarray(nu_j), rtol=1e-6)
        np.testing.assert_allclose(float(xi_t), float(xi_j), rtol=1e-6)
        accepted.append(margin > 0)
    assert 0 < sum(accepted) < 24, accepted
