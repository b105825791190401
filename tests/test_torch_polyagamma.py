"""The port's Marsaglia-Tsang gamma sampler and Polya-Gamma sampler
(functionalmf_tpu_torch/ops/gamma.py, ops/polyagamma.py) against the JAX
package's: equal under the noise JAX itself draws from the same key
(rtol=1e-5), the closed forms equal (pg_mean 1e-6, pg_var 1e-5 relative), and the port's own
draws against the closed-form moments and an exact Devroye sampler.

The Polya-Gamma draw's JAX comparison also holds on a card, where
``polya_gamma`` launches the kernel of csrc/polyagamma.cu: live here
(marker ``cuda``), and through tests/pg_jax_draws.npz, the JAX draws and
the noise behind them, which a test here keeps equal to what the JAX
package draws and tests/test_torch_polyagamma_kernel.py compares the
kernel with on a card without jax."""
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
from tests.test_torch_polyagamma_kernel import (RECORDED,
                                                kernel_against_jax_draw)


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


def _jax_pg_case(key, rng, use_mt, K=16):
    """b spanning 0 (missing), fractional, the gamma branch and the normal
    branch (>= 50), c spanning both series cut-offs; the JAX package's
    draw from ``key``, and its own gammas (or, with ``use_mt``, the
    Marsaglia-Tsang noise behind them) and normals, from its key split
    (polyagamma.py:112-126), as float32 tensors."""
    shape = (6, 40)
    b = rng.choice([0.0, 0.5, 1.0, 3.7, 49.0, 50.0, 120.0],
                   size=shape).astype(np.float32)
    c = (rng.normal(0, 2, size=shape)
         * rng.choice([1e-3, 0.05, 1.0], size=shape)).astype(np.float32)
    want = np.asarray(jpolya_gamma(key, jnp.asarray(b), jnp.asarray(c),
                                   num_terms=K, use_mt=use_mt))
    k_g, k_n = jax.random.split(key)
    b_safe = np.where((b > 0) & (b < 50.0), b, 1.0).astype(np.float32)
    if use_mt:
        g = jgamma_mt(k_g, jnp.asarray(b_safe), shape=(K,) + shape)
        noise = _jax_mt_noise(k_g, (K,) + shape)
    else:
        g = jax.random.gamma(k_g, jnp.asarray(b_safe), shape=(K,) + shape)
        noise = None
    z = jax.random.normal(k_n, shape, jnp.float32)
    return dict(b=_t(b), c=_t(c), g=_t(g), z=_t(z), noise=noise,
                want=_t(want))


@pytest.mark.parametrize("use_mt", [True, False])
def test_polya_gamma_matches_jax_under_injected_noise(key, rng, use_mt):
    """b spans 0 (missing), fractional, the gamma branch and the normal
    branch (>= 50); c spans both series cut-offs. The gammas and normals
    are JAX's own, from its key split (polyagamma.py:112-126)."""
    case = _jax_pg_case(key, rng, use_mt)
    b, want = case["b"].numpy(), case["want"].numpy()
    got = polya_gamma(None, case["b"], case["c"], num_terms=16,
                      use_mt=use_mt, g=case["g"], z=case["z"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    assert (got[b == 0] == 0).all() and (got[b > 0] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("use_mt", [True, False])
def test_polya_gamma_kernel_matches_jax_under_injected_noise_on_card(
        key, rng, use_mt):
    """The kernel on the card (``polya_gamma`` on CUDA tensors) against the
    JAX package's draw at the CPU test's tolerance: with ``use_mt`` from
    the Marsaglia-Tsang noise JAX drew (the kernel's rounds), else from
    JAX's gammas (the kernel's variant that reads g); a lane whose
    acceptance test lies within rounding of its threshold left out."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    kernel_against_jax_draw(_jax_pg_case(key, rng, use_mt), use_mt,
                            torch.device("cuda"))


def record_jax_draws(path=RECORDED):
    """Write the JAX package's draws of ``_jax_pg_case`` at the suite's
    fixtures (PRNGKey(0), default_rng(42)), with the noise and gammas
    behind them, for the card test of tests/test_torch_polyagamma_kernel.py
    (the card's machine has no jax): ``python -m tests.test_torch_polyagamma``
    from the repository's root."""
    mt = _jax_pg_case(jax.random.PRNGKey(0), np.random.default_rng(42), True)
    std = _jax_pg_case(jax.random.PRNGKey(0), np.random.default_rng(42),
                       False)
    x, u, ub = mt["noise"]
    np.savez_compressed(path, b=mt["b"], c=mt["c"], z=mt["z"], x=x, u=u,
                        ub=ub, want_mt=mt["want"], g_std=std["g"],
                        want_std=std["want"])


@pytest.mark.parametrize("use_mt", [True, False])
def test_the_recorded_jax_draws_are_the_jax_packages(key, rng, use_mt):
    """tests/pg_jax_draws.npz holds what the JAX package draws now: the
    card's test against it is a test against the JAX package."""
    case = _jax_pg_case(key, rng, use_mt)
    rec = np.load(RECORDED)
    np.testing.assert_array_equal(rec["b"], case["b"].numpy())
    np.testing.assert_array_equal(rec["c"], case["c"].numpy())
    np.testing.assert_allclose(rec["z"], case["z"].numpy(), rtol=1e-6)
    if use_mt:
        for name, t in zip(("x", "u", "ub"), case["noise"]):
            np.testing.assert_allclose(rec[name], t.numpy(), rtol=1e-6,
                                       atol=1e-30)
    else:
        np.testing.assert_allclose(rec["g_std"], case["g"].numpy(),
                                   rtol=1e-6)
    np.testing.assert_allclose(rec["want_mt" if use_mt else "want_std"],
                               case["want"].numpy(), rtol=1e-6, atol=1e-30)


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


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    record_jax_draws()
    print(f"wrote {RECORDED}")
