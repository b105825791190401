"""The port's Marsaglia-Tsang gamma sampler and Polya-Gamma sampler
(functionalmf_tpu_torch/ops/gamma.py, ops/polyagamma.py) against the JAX
package's: equal under the noise JAX itself draws from the same key
(rtol=1e-5), the closed forms equal (pg_mean 1e-6, pg_var 1e-5 relative), and the port's own
draws against the closed-form moments and an exact Devroye sampler."""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy.stats import ks_2samp

from functionalmf_tpu.ops.gamma import gamma_mt as jgamma_mt
from functionalmf_tpu.ops.polyagamma import (pg_mean as jpg_mean,
                                             pg_var as jpg_var,
                                             polya_gamma as jpolya_gamma)
from functionalmf_tpu_torch.ops.gamma import draw_gamma_mt_noise, gamma_mt
from functionalmf_tpu_torch.ops.polyagamma import (pg_mean, pg_var,
                                                   polya_gamma)
from tests.pg_exact import exact_pg, exact_pg1


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def _jax_mt_noise(key, shape, rounds=6):
    """The normals and uniforms of functionalmf_tpu/ops/gamma.py:36-58,
    from its own key splits."""
    k_boost, k_rounds = jax.random.split(key)
    xs, us = [], []
    for r in range(rounds):
        kx, ku = jax.random.split(jax.random.fold_in(k_rounds, r))
        xs.append(jax.random.normal(kx, shape, jnp.float32))
        us.append(jax.random.uniform(ku, shape, jnp.float32, minval=1e-12))
    ub = jax.random.uniform(k_boost, shape, jnp.float32, minval=1e-12)
    return _t(np.stack(xs)), _t(np.stack(us)), _t(ub)


def test_gamma_mt_matches_jax_under_injected_noise(key):
    a = np.array([[0.05, 0.3, 0.9, 1.0], [2.5, 30.0, 300.0, 0.0]],
                 np.float32)
    shape = (50, 2, 4)
    want = np.asarray(jgamma_mt(key, jnp.asarray(a), shape=shape))
    got = gamma_mt(None, _t(a), shape=shape,
                   noise=_jax_mt_noise(key, shape)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    assert (got[..., 1, 3] == 0).all() and (got[..., :3] > 0).all()


def test_gamma_mt_mean_fallback_and_rounds(key):
    """A lane whose every proposal is rejected (u = 1 cannot pass log u <
    ...) takes the mean a_eff, boosted for a < 1, as in JAX."""
    a = _t([0.5, 4.0])
    x = torch.zeros(6, 2)
    u = torch.full((6, 2), 1.0)
    ub = _t([0.25, 0.25])
    got = gamma_mt(None, a, noise=(x, u, ub)).numpy()
    np.testing.assert_allclose(got, [1.5 * 0.25 ** 2, 4.0], rtol=1e-6)


@pytest.mark.parametrize("a", [0.3, 1.0, 2.5, 300.0])
def test_gamma_mt_moments(a):
    n = 50000
    gen = torch.Generator().manual_seed(int(a * 10))
    draws = gamma_mt(gen, torch.full((n,), a)).numpy()
    assert (draws > 0).all()
    assert abs(draws.mean() - a) < 6 * np.sqrt(a / n) + 1e-3
    assert abs(draws.var() - a) < 0.05 * a + 6 * a * np.sqrt(3.0 / n)


def test_draw_gamma_mt_noise_order_and_shapes():
    g1 = torch.Generator().manual_seed(5)
    x, u, ub = draw_gamma_mt_noise(g1, (3, 2), rounds=4)
    assert x.shape == u.shape == (4, 3, 2) and ub.shape == (3, 2)
    assert (u > 0).all() and (ub > 0).all()
    g2 = torch.Generator().manual_seed(5)
    a = torch.full((3, 2), 1.7)
    np.testing.assert_array_equal(gamma_mt(g2, a, rounds=4).numpy(),
                                  gamma_mt(None, a, rounds=4,
                                           noise=(x, u, ub)).numpy())


def test_pg_mean_and_var_match_jax_through_the_series_cutoffs():
    cs = np.concatenate([np.logspace(-6, 1, 200), -np.logspace(-6, 1, 200),
                         [0.0, 0.0999, 0.1001, 0.4999, 0.5001, 0.009]]
                        ).astype(np.float32)
    b = 2.5
    np.testing.assert_allclose(pg_mean(b, _t(cs)).numpy(),
                               np.asarray(jpg_mean(b, jnp.asarray(cs))),
                               rtol=1e-6)
    got = pg_var(b, _t(cs)).numpy()
    # the direct branch subtracts c from sinh(c): two libraries' sinh differ
    # by an ulp, which the difference amplifies near the cut-off
    np.testing.assert_allclose(got, np.asarray(jpg_var(b, jnp.asarray(cs))),
                               rtol=1e-5)
    assert got.dtype == np.float32 and (got >= 0).all()
    # float64 truth through the cancellation zone |c| < 0.01
    c = cs.astype(np.float64)
    safe = np.where(np.abs(c) < 1e-3, 1.0, c)
    ref = np.where(np.abs(c) < 1e-3, (1.0 + c ** 2 / 20.0) / 24.0,
                   (np.sinh(safe) - safe) / (4.0 * safe ** 3))
    np.testing.assert_allclose(got, b * ref / np.cosh(c / 2.0) ** 2,
                               rtol=2e-3)


@pytest.mark.parametrize("use_mt", [True, False])
def test_polya_gamma_matches_jax_under_injected_noise(key, rng, use_mt):
    """b spans 0 (missing), fractional, the gamma branch and the normal
    branch (>= 50); c spans both series cut-offs. The gammas and normals
    are JAX's own, from its key split (polyagamma.py:112-126)."""
    shape = (6, 40)
    b = rng.choice([0.0, 0.5, 1.0, 3.7, 49.0, 50.0, 120.0],
                   size=shape).astype(np.float32)
    c = (rng.normal(0, 2, size=shape)
         * rng.choice([1e-3, 0.05, 1.0], size=shape)).astype(np.float32)
    K = 16
    want = np.asarray(jpolya_gamma(key, jnp.asarray(b), jnp.asarray(c),
                                   num_terms=K, use_mt=use_mt))
    k_g, k_n = jax.random.split(key)
    b_safe = np.where((b > 0) & (b < 50.0), b, 1.0).astype(np.float32)
    if use_mt:
        g = jgamma_mt(k_g, jnp.asarray(b_safe), shape=(K,) + shape)
    else:
        g = jax.random.gamma(k_g, jnp.asarray(b_safe), shape=(K,) + shape)
    z = jax.random.normal(k_n, shape, jnp.float32)
    got = polya_gamma(None, _t(b), _t(c), num_terms=K, use_mt=use_mt,
                      g=_t(g), z=_t(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    assert (got[b == 0] == 0).all() and (got[b > 0] > 0).all()


@pytest.mark.parametrize("b,c", [(1.0, 0.5), (3.0, 1.0), (50.0, 0.1),
                                 (200.0, 3.0)])
@pytest.mark.parametrize("use_mt", [True, False])
def test_pg_moments(b, c, use_mt):
    n = 8000
    gen = torch.Generator().manual_seed(int(b + 10 * c))
    draws = polya_gamma(gen, torch.full((n,), b), torch.full((n,), c),
                        use_mt=use_mt).numpy()
    m_true = float(pg_mean(b, torch.tensor(c)))
    v_true = float(pg_var(b, torch.tensor(c)))
    assert abs(draws.mean() - m_true) < 5 * np.sqrt(v_true / n) + 1e-4
    assert abs(draws.var() - v_true) < 0.03 * v_true \
        + 6 * v_true * np.sqrt(2.0 / n)


def test_pg_zero_b_and_large_b_small_c():
    gen = torch.Generator().manual_seed(0)
    out = polya_gamma(gen, _t([0.0, 1.0]), _t([1.0, 1.0]))
    assert float(out[0]) == 0.0 and float(out[1]) > 0.0
    # b in the normal branch with |c| in the cancellation band
    draws = polya_gamma(gen, torch.full((1000,), 50.6),
                        torch.full((1000,), -0.0117))
    assert torch.isfinite(draws).all()
    m = float(pg_mean(50.6, torch.tensor(-0.0117)))
    assert abs(float(draws.mean()) - m) < 0.05 * m
    # normal_approx_above=inf forces the gamma sum
    d2 = polya_gamma(gen, torch.full((2000,), 60.0), torch.full((2000,), 1.0),
                     normal_approx_above=math.inf)
    m2 = float(pg_mean(60.0, torch.tensor(1.0)))
    assert abs(float(d2.mean()) - m2) < 0.02 * m2


@pytest.mark.parametrize("b,c", [(1, 1.0), (4, 1.5)])
def test_pg_ks_against_exact_sampler(b, c):
    """Whole-distribution agreement with the Devroye sampler of
    tests/pg_exact.py: D below the alpha=1e-3 two-sample critical value."""
    n = 20000
    rng = np.random.default_rng(7)
    exact = exact_pg1(rng, c, n) if b == 1 else exact_pg(rng, b, c, n)
    gen = torch.Generator().manual_seed(3)
    ours = polya_gamma(gen, torch.full((n,), float(b)),
                       torch.full((n,), c)).numpy()
    d = ks_2samp(ours, exact).statistic
    assert d < 1.949 * np.sqrt(2.0 / n), d
