"""The port's ``gass`` and ``elliptical_slice`` in the JAX package's
one-point call forms (functionalmf_tpu/samplers/gass.py:51, ess.py:18),
a ``torch.Generator`` in the key's place.

* One step against the JAX function under the draws JAX makes from its
  key (the proposal, the slice height, the Gumbel scores or the wrap
  angle and bracket uniforms; ESS's height, bracket and angles), injected
  where the port draws them: the new point to atol=1e-5, its
  log-likelihood to rtol=1e-5, atol=1e-4.
* In distribution with the port's own draws, JAX's standalone cases of
  tests/test_samplers.py at its tolerances: the truncated normal under
  both methods (mean atol 0.03, sd rtol 0.12), the monotone curve (RMSE to
  the truth < 0.1), the mask, staying put, the callable operator, ESS's
  Gaussian posterior (mean atol 0.05, variance rtol 0.15; also with an
  ``angle_range``) and its mean offset (atol 0.08, rtol 0.15).
"""
import math

import numpy as np
import pytest
from scipy import stats

import jax
import jax.numpy as jnp
import torch

from functionalmf_tpu import elliptical_slice as jess
from functionalmf_tpu import gass as jgass
from functionalmf_tpu_torch import elliptical_slice, gass
from functionalmf_tpu_torch.samplers import ess as E
from functionalmf_tpu_torch.samplers import gass as G

NGRID, MAX_SHRINK, MAX_ITERS = 24, 30, 40


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax_gass_draws(key, D, method):
    """What gass.py draws from ``key``: the proposal v, log u, and the
    Gumbel scores (grid) or the wrap angle and bracket uniforms (shrink)
    (gass.py:98-102, 183, 205-206, 222)."""
    k_h, k_v, k_pick = jax.random.split(key, 3)
    log_u = float(jnp.log(jax.random.uniform(k_h)))
    v = np.asarray(jax.random.normal(k_v, (D,)))
    if method == "grid":
        return v, (_t([log_u]), _t(np.asarray(
            jax.random.gumbel(k_pick, (NGRID,)))[None]))
    k_wrap, k_loop = jax.random.split(k_pick)
    phi = float(jax.random.uniform(k_wrap) * (2.0 * jnp.pi))
    u = [float(jax.random.uniform(jax.random.fold_in(k_loop, it)))
         for it in range(MAX_SHRINK)]
    return v, (_t([log_u]), _t([phi]), _t(u)[None])


def _gass_case(case, rng):
    """(x, A for JAX, A for the port, c, mu, dim_mask, cur_ll, centre,
    scale) of a one-step case."""
    D = 3
    x = np.abs(rng.normal(1, 0.3, D)).astype(np.float32)
    mu = np.abs(rng.normal(0.5, 0.2, D)).astype(np.float32)
    centre, scale = np.full(D, 1.2, np.float32), 0.3
    A = np.eye(D, dtype=np.float32)
    mask = cur = None
    if case == "callable":
        A = np.abs(rng.normal(1, 0.3, (5, D))).astype(np.float32)
        jA, tA = (lambda y: jnp.dot(jnp.asarray(A), y)), (lambda y: _t(A) @ y)
        cur = float(-0.5 * np.sum(((x - centre) / scale) ** 2))
    else:
        jA, tA = jnp.asarray(A), _t(A)
    if case == "dim_mask":
        mask = np.array([1.0, 1.0, 0.0], np.float32)
        x, mu = x * mask, None
    return x, jA, tA, np.zeros(A.shape[0], np.float32), mu, mask, cur, \
        centre, scale


@pytest.mark.parametrize("case", ["dense", "callable", "dim_mask"])
@pytest.mark.parametrize("method", ["grid", "shrink"])
def test_gass_step_matches_jax_under_its_draws(monkeypatch, rng, method,
                                               case):
    x, jA, tA, c, mu, mask, cur, centre, scale = _gass_case(case, rng)
    D = x.size
    key = jax.random.PRNGKey(17)
    want, want_ll = jgass(
        key, jnp.asarray(x), lambda kk: jax.random.normal(kk, (D,)),
        lambda p: -0.5 * jnp.sum(((p - centre) / scale) ** 2, axis=-1), jA,
        jnp.asarray(c), mu=None if mu is None else jnp.asarray(mu),
        cur_ll=None if cur is None else jnp.float32(cur), ngrid=NGRID,
        dim_mask=None if mask is None else jnp.asarray(mask), method=method,
        max_shrink=MAX_SHRINK)
    v, noise = _jax_gass_draws(key, D, method)
    draw = "draw_gass_noise" if method == "grid" else "draw_gass_shrink_noise"
    monkeypatch.setattr(G, draw, lambda *a: noise)
    calls = []

    def sample_v(gen):
        calls.append(gen)
        return _t(v)

    got, got_ll = gass(
        _gen(), _t(x), sample_v,
        lambda p: -0.5 * (((p - _t(centre)) / scale) ** 2).sum(-1), tA,
        _t(c), mu=None if mu is None else _t(mu), cur_ll=cur, ngrid=NGRID,
        dim_mask=None if mask is None else _t(mask), method=method,
        max_shrink=MAX_SHRINK)
    assert len(calls) == 1 and got.shape == (D,) and got_ll.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=1e-5,
                               atol=1e-4)
    assert not np.allclose(got.numpy(), x)          # the step moved
    if mask is not None:
        assert got[2] == 0.0


def _jax_ess_draws(key, angle_range):
    """What ess.py draws from ``key``: log u, the bracket's place and the
    first angle, the bracket uniforms (ess.py:40-50, 70)."""
    k_h, k_phi, k_loop = jax.random.split(key, 3)
    log_u = float(jnp.log(jax.random.uniform(k_h)))
    u_phi = [float(jax.random.uniform(k_phi))]
    if angle_range > 0:
        u_phi.append(float(jax.random.uniform(jax.random.fold_in(k_phi, 1))))
    u = [float(jax.random.uniform(jax.random.fold_in(k_loop, it)))
         for it in range(MAX_ITERS)]
    u_phi = _t(u_phi)[:, None] if angle_range > 0 else _t(u_phi)
    return _t([log_u]), u_phi, _t(u)[:, None]


@pytest.mark.parametrize("with_mu,angle_range", [(False, 0.0), (True, 0.0),
                                                 (False, 0.7), (True, 2.5)])
def test_elliptical_slice_step_matches_jax_under_its_draws(
        monkeypatch, rng, with_mu, angle_range):
    """A 2 x 3 point, a likelihood sharp enough for several shrinks."""
    x = rng.normal(0, 1, (2, 3)).astype(np.float32)
    nu = rng.normal(0, 1, (2, 3)).astype(np.float32)
    mu = rng.normal(0.5, 0.2, (2, 3)).astype(np.float32) if with_mu else None
    centre = np.full((2, 3), 0.7, np.float32)
    key = jax.random.PRNGKey(5)
    want, want_ll = jess(key, jnp.asarray(x), jnp.asarray(nu),
                         lambda p: -15.0 * jnp.sum((p - centre) ** 2),
                         mu=None if mu is None else jnp.asarray(mu),
                         angle_range=angle_range, max_iters=MAX_ITERS)
    noise = _jax_ess_draws(key, angle_range)
    monkeypatch.setattr(E, "draw_ess_noise", lambda *a: noise)
    got, got_ll = elliptical_slice(
        _gen(), _t(x), _t(nu), lambda p: -15.0 * ((p - _t(centre)) ** 2).sum(),
        mu=None if mu is None else _t(mu), angle_range=angle_range,
        max_iters=MAX_ITERS)
    assert got.shape == x.shape and got_ll.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(got_ll), float(want_ll), rtol=1e-5,
                               atol=1e-4)
    assert not np.allclose(got.numpy(), x)


def test_the_noise_draws_of_an_angle_range():
    """With an angle range the first uniform is (2, B): the bracket's
    place and the first angle; without, (B,) as the models draw it."""
    log_u, u_phi, u = E.draw_ess_noise(_gen(), 3, 4, "cpu", angle_range=1.0)
    assert log_u.shape == (3,) and u_phi.shape == (2, 3) and u.shape == (4, 3)
    assert E.draw_ess_noise(_gen(), 3, 4, "cpu")[1].shape == (3,)


def test_devices_follow_x_and_an_array_defaults_to_the_card():
    """A tensor keeps its device; an array goes to "cuda" unless told
    otherwise (no fallback: without a card that raises); a generator on
    another device than x raises."""
    A, c = np.eye(1, dtype=np.float32), np.zeros(1, np.float32)
    ll = lambda p: torch.zeros(p.shape[0])                        # noqa
    x, _ = gass(_gen(), np.ones(1), lambda g: torch.randn(1, generator=g),
                ll, A, c, device="cpu")
    assert x.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            gass(_gen(), np.ones(1), lambda g: torch.randn(1, generator=g),
                 ll, A, c)
        with pytest.raises((RuntimeError, AssertionError)):
            elliptical_slice(_gen(), np.ones(1), np.ones(1),
                             lambda p: p.sum())
    with pytest.raises(ValueError, match="generator"):
        gass(_gen(), torch.ones(1, device="meta"), None, ll, A, c,
             v=np.ones(1))
    with pytest.raises(ValueError, match="generator"):
        elliptical_slice(_gen(), torch.ones(1, device="meta"), np.ones(1),
                         lambda p: p.sum())
    with pytest.raises(ValueError, match="unknown gass method"):
        gass(_gen(), torch.ones(1), None, ll, A, c, v=np.ones(1),
             method="slice")


# ----------------------------------------------------------------------
# in distribution, the port's own draws (tests/test_samplers.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", ["grid", "shrink"])
def test_gass_truncated_normal(method):
    """N(0, 1) truncated to x >= 0.5 under a flat likelihood
    (tests/test_samplers.py:62), 6000 steps after 500."""
    g = _gen(1)
    A, c = torch.ones(1, 1), torch.full((1,), 0.5)
    x, ll = torch.ones(1), torch.zeros(())
    xs = []
    for i in range(6500):
        x, ll = gass(g, x, lambda gg: torch.randn(1, generator=gg),
                     lambda p: torch.zeros(p.shape[0]), A, c, cur_ll=ll,
                     method=method)
        xs.append(float(x[0]))
    xs = np.asarray(xs[500:])
    assert np.all(xs >= 0.5 - 1e-5)
    tn = stats.truncnorm(0.5, np.inf)
    np.testing.assert_allclose(xs.mean(), tn.mean(), atol=0.03)
    np.testing.assert_allclose(xs.std(), tn.std(), rtol=0.12)


@pytest.mark.parametrize("method", ["grid", "shrink"])
def test_gass_monotone_curve(method):
    """The reference's standalone demo at reduced scale
    (tests/test_samplers.py:92): a non-increasing curve in [0.1, 1] under
    an iid normal likelihood, 2000 steps after 500."""
    T, nobs = 6, 5
    truth = np.array([0.95, 0.8, 0.6, 0.45, 0.3, 0.15])
    data = _t(np.random.default_rng(0).normal(truth[:, None], 0.2,
                                              size=(T, nobs)))
    C = np.concatenate([
        np.concatenate([np.eye(T), np.full((T, 1), 0.1)], 1),
        np.concatenate([-np.eye(T), np.full((T, 1), -1.0)], 1),
        np.array([np.concatenate([np.zeros(i), [1, -1], np.zeros(T - i - 2),
                                  [0]]) for i in range(T - 1)])])
    A, c = _t(C[:, :-1]), _t(C[:, -1])

    def loglik(pts):                                     # (G, T) -> (G,)
        return (-0.5 * (data[None] - pts[:, :, None]) ** 2 / 0.04).sum((1, 2))

    g = _gen(2)
    x = _t(np.clip((T - np.arange(T)) / T, 0.15, 0.99))
    ll = loglik(x[None])[0]
    xs = []
    for _ in range(2500):
        x, ll = gass(g, x, lambda gg: torch.randn(T, generator=gg), loglik, A,
                     c, mu=torch.full((T,), 0.5), cur_ll=ll, method=method)
        xs.append(x.numpy())
    xs = np.stack(xs[500:])
    assert xs.min() >= 0.1 - 1e-4 and xs.max() <= 1.0 + 1e-4
    assert np.all(np.diff(xs, axis=1) <= 1e-4)
    assert np.sqrt(np.mean((xs.mean(0) - truth) ** 2)) < 0.1


@pytest.mark.parametrize("method", ["grid", "shrink"])
def test_gass_dim_mask(method):
    """A masked dimension stays at 0 (tests/test_samplers.py:137)."""
    g = _gen(3)
    A, c, mask = _t([[1.0, 0.0]]), _t([-10.0]), _t([1.0, 0.0])
    x = _t([0.3, 0.0])
    for _ in range(20):
        x, _ = gass(g, x, lambda gg: torch.randn(2, generator=gg),
                    lambda p: torch.zeros(p.shape[0]), A, c, dim_mask=mask,
                    method=method)
    assert float(x[1]) == 0.0 and float(x[0]) != 0.3


@pytest.mark.parametrize("method", ["grid", "shrink"])
def test_gass_stays_put_when_the_slice_is_empty(method):
    """Contradictory slice: every candidate rejects, x stays
    (tests/test_samplers.py:154)."""
    x_new, ll = gass(_gen(4), _t([1.0]),
                     lambda gg: torch.randn(1, generator=gg),
                     lambda p: torch.full((p.shape[0],), -math.inf),
                     _t([[1.0], [-1.0]]), _t([0.99, -1.01]),
                     cur_ll=torch.zeros(()), method=method)
    np.testing.assert_array_equal(x_new.numpy(), [1.0])
    assert float(ll) == 0.0


def test_gass_callable_operator():
    """A factorised operator gives the dense matrix's draw from the same
    generator (tests/test_samplers.py:169), feasible and moved."""
    rng = np.random.default_rng(7)
    D, J = 6, 9
    A = rng.normal(size=(J, D)).astype(np.float32)
    x0 = np.full(D, 2.0, np.float32)
    c = (A @ x0 - 1.0).astype(np.float32)
    v = rng.normal(size=D).astype(np.float32)

    def loglik(p):
        return -0.5 * (p ** 2).sum(-1)

    x_d, ll_d = gass(_gen(5), _t(x0), None, loglik, _t(A), _t(c), v=v,
                     ngrid=32)
    x_o, ll_o = gass(_gen(5), _t(x0), None, loglik, lambda y: _t(A) @ y,
                     _t(c), v=v, ngrid=32)
    np.testing.assert_allclose(x_d.numpy(), x_o.numpy())
    np.testing.assert_allclose(float(ll_d), float(ll_o))
    assert np.all(A @ x_d.numpy() >= c - 1e-5)
    assert not np.allclose(x_d.numpy(), x0)


@pytest.mark.parametrize("angle_range", [0.0, 1.5])
def test_ess_gaussian_posterior(angle_range):
    """Prior N(0, 1), y = 1.2 ~ N(x, 0.5^2): the exact posterior's mean and
    variance (tests/test_samplers.py:23), 5000 steps after 1000."""
    s2_lik, y = 0.25, 1.2
    post_var = 1.0 / (1.0 + 1.0 / s2_lik)
    post_mean = post_var * y / s2_lik
    g = _gen(6)
    x, ll, xs = torch.zeros(1), None, []
    for _ in range(6000):
        nu = torch.randn(1, generator=g)
        x, ll = elliptical_slice(g, x, nu,
                                 lambda p: -0.5 * (y - p[0]) ** 2 / s2_lik,
                                 cur_ll=ll, angle_range=angle_range)
        xs.append(float(x[0]))
    xs = np.asarray(xs[1000:])
    np.testing.assert_allclose(xs.mean(), post_mean, atol=0.05)
    np.testing.assert_allclose(xs.var(), post_var, rtol=0.15)


def test_ess_with_mean_offset():
    """A flat likelihood around mu = 2 gives N(2, 1)
    (tests/test_samplers.py:44), 3500 steps after 500."""
    g = _gen(7)
    mu = torch.full((1,), 2.0)
    x, xs = mu.clone(), []
    for _ in range(4000):
        nu = torch.randn(1, generator=g)
        x, _ = elliptical_slice(g, x, nu, lambda p: torch.zeros(()), mu=mu)
        xs.append(float(x[0]))
    xs = np.asarray(xs[500:])
    np.testing.assert_allclose(xs.mean(), 2.0, atol=0.08)
    np.testing.assert_allclose(xs.var(), 1.0, rtol=0.15)
