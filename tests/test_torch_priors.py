"""The port's horseshoe and inverse-gamma updates against the JAX
package's, with the gamma and exponential draws JAX makes from the same
key injected (exact to float32), and one moment check per sampler with
the port's own generator."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from functionalmf_tpu.samplers import horseshoe as jhs
from functionalmf_tpu.samplers.conjugate import (
    ConjugateInverseGammaPrior as JIG, resample_precision as j_resample)
from functionalmf_tpu_torch.samplers import horseshoe as ths
from functionalmf_tpu_torch.samplers.conjugate import (
    ConjugateInverseGammaPrior as TIG, resample_precision as t_resample)

TOL = dict(rtol=1e-6, atol=0)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def test_horseshoe_plus_matches_jax():
    key = jax.random.PRNGKey(11)
    size = (3, 4)
    ks = jax.random.split(key, 4)
    gs = [_t(jax.random.gamma(k, jnp.asarray(0.5), shape=size)) for k in ks]
    want = jhs.sample_horseshoe_plus(key, size=size)
    got = ths.sample_horseshoe_plus(None, noise=gs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_horseshoe_matches_jax():
    key = jax.random.PRNGKey(12)
    k1, k2 = jax.random.split(key)
    gs = [_t(jax.random.gamma(k, jnp.asarray(0.5), shape=(5,)))
          for k in (k1, k2)]
    want = jhs.sample_horseshoe(key, size=(5,))
    got = ths.sample_horseshoe(None, noise=gs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_tau2_ladder_matches_jax(rng):
    key = jax.random.PRNGKey(13)
    m, nD, k = 4, 9, 5
    deltas_sq = rng.gamma(1, 1, (m, nD)).astype(np.float32)
    ladder = [rng.gamma(1, 1, (m, nD)).astype(np.float32) for _ in range(4)]
    lam2 = np.float32(0.3)
    want = jhs.resample_tau2_ladder(key, jnp.asarray(deltas_sq), lam2,
                                    *map(jnp.asarray, ladder), k)
    k1, k2 = jax.random.split(key)
    shape = (k + 1) / 2.0
    gamma = jax.random.gamma(k1, jnp.full((m, nD), shape), shape=(m, nD))
    expo = jax.random.exponential(k2, (3, m, nD))
    got = ths.resample_tau2_ladder(None, _t(deltas_sq), _t(lam2),
                                   *map(_t, ladder), k,
                                   noise=(_t(gamma), _t(expo)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6)


def test_lam2_matches_jax():
    key = jax.random.PRNGKey(14)
    s, lam2_a, nD, m, k = 37.5, 0.8, 11, 4, 3
    want = jhs.resample_lam2(key, jnp.float32(s), jnp.float32(lam2_a), nD,
                             m, k)
    k1, k2 = jax.random.split(key)
    gamma = jax.random.gamma(k1, (nD * m * k + 1) / 2.0)
    expo = jax.random.exponential(k2)
    got = ths.resample_lam2(None, _t(s), _t(lam2_a), nD, m, k,
                            noise=(_t(gamma), _t(expo)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_conjugate_ig_matches_jax(rng):
    key = jax.random.PRNGKey(15)
    means = rng.normal(size=(6, 5)).astype(np.float32)
    obs = rng.normal(size=(6, 5)).astype(np.float32)
    obs[0, 0] = np.nan
    want = j_resample(key, jnp.asarray(means), jnp.asarray(obs), 0.1, 0.1)
    a_post = 0.1 + np.sum(~np.isnan(obs)) / 2.0
    gamma = jax.random.gamma(key, jnp.float32(a_post))
    got = t_resample(None, _t(means), _t(obs), 0.1, 0.1, gamma=_t(gamma))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5)
    prior_want = JIG(1, 0.1, 0.2).draw_from_prior(key, size=(3,))
    g3 = jax.random.gamma(key, jnp.asarray(0.1), shape=(3,))
    prior_got = TIG(1, 0.1, 0.2).draw_from_prior(None, gamma=_t(g3))
    np.testing.assert_allclose(prior_got.numpy(), _np(prior_want), **TOL)


def test_zero_exponential_draw_is_guarded():
    """An exact-zero Exp(1) draw (the tiny guard, horseshoe.py:90-91,
    115) leaves the ladder finite."""
    one = torch.ones(2, 3)
    out = ths.resample_tau2_ladder(
        None, one, torch.tensor(0.5), one, one, one, one, 5,
        noise=(one, torch.zeros(3, 2, 3)))
    assert all(torch.isfinite(o).all() for o in out)
    lam2, lam2_a = ths.resample_lam2(None, torch.tensor(2.0),
                                     torch.tensor(1.0), 3, 2, 2,
                                     noise=(torch.tensor(4.0),
                                            torch.tensor(0.0)))
    assert torch.isfinite(lam2) and torch.isfinite(lam2_a)


N = 40000


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(0)


def test_horseshoe_moments(gen):
    """lam2 = G1/G2 with Gammas of shape 1/2 is F(1, 1): median 1; the
    horseshoe+ d is a ratio of two such products: median 1 too."""
    lam2, a = ths.sample_horseshoe(gen, (N,))
    assert abs(float(lam2.median()) - 1.0) < 0.05
    assert abs(float((1.0 / a).mean()) - 0.5) < 0.02    # Gamma(1/2) mean
    d = ths.sample_horseshoe_plus(gen, (N,))[0]
    assert abs(float(torch.log(d).median())) < 0.08


def test_tau2_ladder_moments(gen):
    """tau2 ~ IG((k+1)/2, rate): mean rate / ((k+1)/2 - 1)."""
    k = 5
    rate_in = torch.full((N,), 2.0)
    tau2_c = torch.full((N,), 1e6)        # 1/tau2_c ~ 0: rate = d/(2 lam2)
    out = ths.resample_tau2_ladder(gen, rate_in, torch.tensor(0.5),
                                   torch.ones(N), tau2_c, torch.ones(N),
                                   torch.ones(N), k)
    rate = 2.0 / (2 * 0.5) + 1e-6
    assert abs(float(out[0].mean()) / (rate / ((k + 1) / 2 - 1)) - 1) < 0.03


def test_lam2_moments(gen):
    """lam2 ~ IG(shape, rate), shape = (nD*m*k+1)/2: mean rate/(shape-1);
    lam2_a = (1/lam2 + 1)/Exp(1): median (1/lam2 + 1)/ln 2."""
    nD, m, k = 3, 2, 2
    s = torch.full((N,), 6.0)
    lam2_a = torch.full((N,), 2.0)
    lam2, la = ths.resample_lam2(gen, s, lam2_a, nD, m, k)
    shape = ths.lam2_shape(nD, m, k)
    rate = 1 / 2.0 + 6.0 / 2
    assert abs(float(lam2.mean()) / (rate / (shape - 1)) - 1) < 0.03
    ratio = la * np.log(2) / (1 / lam2 + 1)
    assert abs(float(ratio.median()) - 1) < 0.03


def test_conjugate_ig_moments(gen):
    prior = TIG(1, 2.0, 4.0)
    draws = prior.draw_from_prior(gen, (N,))
    assert abs(float(draws.mean()) / (2.0 / 4.0) - 1) < 0.03
