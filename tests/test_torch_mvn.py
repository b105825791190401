"""The port's batched Gaussian draws (functionalmf_tpu_torch/ops/mvn.py)
against functionalmf_tpu.ops.mvn, with the standard-normal draw that JAX
makes from the same key injected. Tolerance rtol=atol=1e-5 (float32)."""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from functionalmf_tpu.ops import mvn as jmvn
from functionalmf_tpu_torch.ops import mvn as tmvn

TOL = dict(rtol=1e-5, atol=1e-5)


def _spd(rng, batch, D):
    A = rng.normal(size=batch + (D, D))
    return (A @ np.swapaxes(A, -1, -2) + D * np.eye(D)).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def test_cholesky_psd_matches_jax(rng):
    Q = _spd(rng, (3, 2), 5)
    got = tmvn.cholesky_psd(_t(Q))
    want = jmvn.cholesky_psd(jnp.asarray(Q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cholesky_jitter_ladder_on_indefinite_input(rng):
    """Member 0 factors as is; member 1 is indefinite (eigenvalue about
    -5e-4) and needs the third rung (eps*100^2 = 1e-2); member 2 is
    hopeless and comes back NaN on both sides."""
    Q = np.stack([np.array([[2.0, 0.3], [0.3, 1.0]]),
                  np.array([[1.0, 1.0], [1.0, 1.0 - 1e-3]]),
                  np.array([[1.0, 0.0], [0.0, -10.0]])]).astype(np.float32)
    got = tmvn.cholesky_psd(_t(Q), eps=1e-6, attempts=4).numpy()
    want = np.asarray(jmvn.cholesky_psd(jnp.asarray(Q), eps=1e-6,
                                        attempts=4))
    low = np.tril_indices(2)
    assert np.isfinite(got[:2]).all() and np.isnan(got[2][low]).all()
    np.testing.assert_allclose(got, want, **TOL)
    # the factor of member 1 is that of Q + 1e-2 I
    np.testing.assert_allclose(got[1] @ got[1].T, Q[1] + 1e-2 * np.eye(2),
                               rtol=1e-5, atol=1e-5)
    # no retries: the failed member is NaN, as JAX leaves it
    got0 = tmvn.cholesky_psd(_t(Q), attempts=0).numpy()
    assert np.isnan(got0[1][low]).all() and np.isfinite(got0[0]).all()


def test_cho_solve_and_solve_lt_match_jax(rng):
    Q = _spd(rng, (4,), 6)
    b = rng.normal(size=(4, 6)).astype(np.float32)
    L = np.asarray(jmvn.cholesky_psd(jnp.asarray(Q)))
    np.testing.assert_allclose(
        tmvn._cho_solve(_t(L), _t(b)).numpy(),
        np.asarray(jmvn._cho_solve(jnp.asarray(L), jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(
        tmvn._solve_lt(_t(L), _t(b)).numpy(),
        np.asarray(jmvn._solve_lt(jnp.asarray(L), jnp.asarray(b))), **TOL)


def test_sample_mvn_from_precision_with_injected_z(rng):
    """z is the draw JAX makes from the key (mvn.py:143); the port gets it
    injected. With mu_part, with mu, and equilibrated."""
    key = jax.random.PRNGKey(3)
    Q = _spd(rng, (3,), 4)
    Q[0] *= 1e3                                   # spread for equilibrate
    mu_part = rng.normal(size=(3, 4)).astype(np.float32)
    z = np.asarray(jax.random.normal(key, (3, 4), dtype=jnp.float32))
    for kw in (dict(mu_part=mu_part), dict(mu=mu_part), {},
               dict(mu_part=mu_part, equilibrate=True)):
        want = jmvn.sample_mvn_from_precision(
            key, jnp.asarray(Q), **{k: (jnp.asarray(v) if k != "equilibrate"
                                        else v) for k, v in kw.items()})
        got = tmvn.sample_mvn_from_precision(
            None, _t(Q), z=_t(z), **{k: (_t(v) if k != "equilibrate" else v)
                                     for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sample_mvn_from_precision_covariance(rng):
    """Moment check of the port's own draws: the sample covariance of
    N(0, Q^-1) draws approaches Q^-1."""
    Q = _spd(rng, (), 3)
    g = torch.Generator().manual_seed(0)
    x = tmvn.sample_mvn_from_precision(g, _t(Q).expand(40000, 3, 3))
    cov = np.cov(x.numpy().T)
    np.testing.assert_allclose(cov, np.linalg.inv(Q), rtol=0.05, atol=2e-3)
