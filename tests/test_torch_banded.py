"""The port's block-banded factorisation, solves and samplers
(functionalmf_tpu_torch/ops/banded.py) against functionalmf_tpu.ops.banded
on the same numpy inputs, and against dense linear algebra in float64.

Tolerances: factor and solves against JAX rtol=1e-4 (two float32
factorisations whose sums run in different orders), the re-layouts
(``retile_bands``, ``equilibrate_bands``, ``build_v_bands``) 1e-6, the
draws under JAX's own z rtol=atol=2e-4."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from functionalmf_tpu.ops import banded as jb
from functionalmf_tpu.ops.penalty import bayes_grid_penalty
from functionalmf_tpu_torch.ops import banded as tb
from functionalmf_tpu_torch.ops.penalty import penalty_half_bandwidth


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def _system(rng, T=12, k=3, tf_order=2, m=2):
    p = penalty_half_bandwidth(tf_order)
    Delta = bayes_grid_penalty(T, tf_order)
    w = rng.gamma(2, 1, size=(m, Delta.shape[0]))
    DtLD = np.einsum("dt,jd,ds->jts", Delta, w, Delta).astype(np.float32)
    A = rng.normal(size=(m, T, k, 7))
    G = (np.einsum("jtkr,jtlr->jtkl", A, A) * 0.3).astype(np.float32)
    return DtLD, G, p


def _bands(rng, **kw):
    DtLD, G, p = _system(rng, **kw)
    jbands = jb.build_v_bands(jnp.asarray(DtLD), jnp.asarray(G), p)
    tbands = tb.build_v_bands(_t(DtLD), _t(G), p)
    np.testing.assert_allclose(tbands.numpy(), np.asarray(jbands), rtol=1e-6)
    return jbands, tbands


@pytest.mark.parametrize("tf_order", [0, 1, 2, 3])
def test_cholesky_matches_jax_and_dense(rng, tf_order):
    jbands, tbands = _bands(rng, T=10, k=2, tf_order=tf_order)
    L, rep, ger = tb.block_banded_cholesky(tbands, return_repairs=True)
    Lj, rep_j, ger_j = jb.block_banded_cholesky(jbands, return_repairs=True)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(rep_j))
    np.testing.assert_array_equal(ger.numpy(), np.asarray(ger_j))
    assert float(rep.sum()) == 0.0
    Q = tb.bands_to_dense(tbands).double().numpy()
    np.testing.assert_allclose(Q, np.asarray(jb.bands_to_dense(jbands)),
                               rtol=1e-6)
    Ld = np.tril(tb.bands_to_dense(L).double().numpy())
    want = np.linalg.cholesky(Q)
    np.testing.assert_allclose(Ld, want, rtol=1e-4, atol=1e-4)


def test_prior_only_bands_and_no_bandwidth(rng):
    """G=None gives k=1 blocks; p=0 (a block-diagonal system) factors."""
    DtLD, _, p = _system(rng, T=7, k=1, tf_order=1)
    got = tb.build_v_bands(_t(DtLD), None, p)
    want = jb.build_v_bands(jnp.asarray(DtLD), None, p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    diag = got[..., :1, :, :]
    L = tb.block_banded_cholesky(diag)
    np.testing.assert_allclose(L.numpy()[..., 0, 0, 0],
                               np.sqrt(diag.numpy()[..., 0, 0, 0]), rtol=1e-6)


def test_solves_match_jax_and_dense(rng):
    jbands, tbands = _bands(rng, T=14, k=3)
    L = tb.block_banded_cholesky(tbands)
    Lj = jb.block_banded_cholesky(jbands)
    b = rng.normal(size=(2, 14, 3)).astype(np.float32)
    Q = tb.bands_to_dense(tbands).double().numpy()
    Ld = np.tril(tb.bands_to_dense(L).double().numpy())
    for tfn, jfn, dense in (
            (tb.block_banded_solve_lower, jb.block_banded_solve_lower,
             lambda j: np.linalg.solve(Ld[j], b[j].reshape(-1))),
            (tb.block_banded_solve_upper, jb.block_banded_solve_upper,
             lambda j: np.linalg.solve(Ld[j].T, b[j].reshape(-1))),
            (tb.block_banded_solve, jb.block_banded_solve,
             lambda j: np.linalg.solve(Q[j], b[j].reshape(-1)))):
        got = tfn(L, _t(b)).numpy()
        np.testing.assert_allclose(got, np.asarray(jfn(Lj, jnp.asarray(b))),
                                   rtol=1e-4, atol=1e-5)
        for j in range(2):
            np.testing.assert_allclose(got[j].reshape(-1), dense(j),
                                       rtol=2e-3, atol=2e-3)


def test_tsolve_right_side_and_transpose(rng):
    """X Lcc^T = S: a wrong side or transpose still gives finite numbers,
    so hold it to the definition."""
    Lcc = np.tril(rng.normal(size=(3, 4, 4))) + 3 * np.eye(4)
    S = rng.normal(size=(3, 4, 4))
    X = tb._tsolve_right(_t(Lcc), _t(S)).numpy()
    np.testing.assert_allclose(X @ np.swapaxes(Lcc, -1, -2), S, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        X, np.asarray(jb._tsolve_right(jnp.asarray(Lcc, jnp.float32),
                                       jnp.asarray(S, jnp.float32))),
        rtol=1e-4, atol=1e-5)


def test_matvec_slice_and_block_to_dense_match_jax(rng):
    jbands, tbands = _bands(rng, T=11, k=2, tf_order=2)
    x = rng.normal(size=(2, 11, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tb.block_banded_matvec(tbands, _t(x)).numpy(),
        np.asarray(jb.block_banded_matvec(jbands, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)
    Q = tb.bands_to_dense(tbands).numpy()
    np.testing.assert_allclose(
        tb.block_banded_matvec(tbands, _t(x)).numpy().reshape(2, -1),
        np.einsum("jab,jb->ja", Q, x.reshape(2, -1)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.slice_bands(tbands, 3, 5).numpy(),
                               np.asarray(jb.slice_bands(jbands, 3, 5)),
                               rtol=1e-6)
    np.testing.assert_allclose(tb.block_to_dense(tbands, 3, 5).numpy(),
                               np.asarray(jb.block_to_dense(jbands, 3, 5)),
                               rtol=1e-6)
    np.testing.assert_allclose(tb.block_to_dense(tbands, 3, 5).numpy(),
                               Q[:, 6:16, 6:16], rtol=1e-6)


@pytest.mark.parametrize("T,B", [(13, 4), (16, 8), (5, 8)])
def test_retile_and_equilibrate_match_jax(rng, T, B):
    jbands, tbands = _bands(rng, T=T, k=2, tf_order=2)
    te, ts = tb.equilibrate_bands(tbands)
    je, js = jb.equilibrate_bands(jbands)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    B = min(B, T)
    t2, T2 = tb.retile_bands(te, B)
    j2, T2j = jb.retile_bands(je, B)
    assert T2 == T2j
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=1e-6,
                               atol=1e-7)
    # the retiled system is the same matrix, identity on the padding
    Q = tb.bands_to_dense(te).numpy()
    Q2 = tb.bands_to_dense(t2).numpy()
    n = T * 2
    np.testing.assert_allclose(Q2[:, :n, :n], Q, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(Q2[:, n:, :n], 0.0)
    np.testing.assert_array_equal(
        Q2[:, n:, n:], np.broadcast_to(np.eye(Q2.shape[-1] - n),
                                       Q2[:, n:, n:].shape))


def _indefinite_blocks():
    """Four 3x3 blocks: positive definite (rung 0); eigenvalue about
    -3e-3 of a mean diagonal 1 (rung 1, relative jitter 1e-2); eigenvalue
    -2 (only the Gershgorin shift); and a NaN (no rung)."""
    good = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]])
    slight = np.array([[1.0, 1.0015, 0.0], [1.0015, 1.0, 0.0],
                       [0.0, 0.0, 1.0]])
    bad = np.array([[1.0, 3.0, 0.0], [3.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    nan = good.copy()
    nan[1, 1] = np.nan
    return np.stack([good, slight, bad, nan]).astype(np.float32)


def test_pivot_guard_takes_the_same_rung_as_jax():
    S = _indefinite_blocks()
    L, rep, ger = tb._chol_pivot_guarded(_t(S))
    Lj, rep_j, ger_j = jb._chol_pivot_guarded(jnp.asarray(S))
    np.testing.assert_array_equal(rep.numpy(), [0, 1, 1, 0])
    np.testing.assert_array_equal(ger.numpy(), [0, 0, 1, 0])
    np.testing.assert_array_equal(rep.numpy(), np.asarray(rep_j))
    np.testing.assert_array_equal(ger.numpy(), np.asarray(ger_j))
    np.testing.assert_allclose(L.numpy()[:3], np.asarray(Lj)[:3], rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(L.numpy()[:3]).all()
    # no good rung: NaN on both sides, never a partial factor
    assert np.isnan(L.numpy()[3]).any() and np.isnan(np.asarray(Lj)[3]).any()
    # the repaired factors reproduce the shifted blocks
    LLt = L.numpy()[:3] @ np.swapaxes(L.numpy()[:3], -1, -2)
    shift = LLt - S[:3]
    off = ~np.eye(3, dtype=bool)
    np.testing.assert_allclose(shift[:, off], 0.0, atol=1e-5)
    np.testing.assert_allclose(np.diagonal(shift, axis1=-2, axis2=-1)[1],
                               1e-2, rtol=1e-3)


def test_indefinite_diagonal_block_counts_match_jax(rng):
    """A banded system whose third diagonal block is indefinite: the
    factor stays finite and `repaired`/`gershgorin` equal the JAX
    package's, per batch element."""
    DtLD, G, p = _system(rng, T=8, k=3, tf_order=1, m=3)
    S = _indefinite_blocks()
    G[1, 2] = S[1] - np.eye(3, dtype=np.float32) * DtLD[1, 2, 2]
    G[2, 2] = S[2] * 50
    jbands = jb.build_v_bands(jnp.asarray(DtLD), jnp.asarray(G), p)
    tbands = tb.build_v_bands(_t(DtLD), _t(G), p)
    L, rep, ger = tb.block_banded_cholesky(tbands, return_repairs=True)
    Lj, rep_j, ger_j = jb.block_banded_cholesky(jbands, return_repairs=True)
    assert torch.isfinite(L).all()
    np.testing.assert_array_equal(rep.numpy(), np.asarray(rep_j))
    np.testing.assert_array_equal(ger.numpy(), np.asarray(ger_j))
    assert float(rep[0]) == 0 and float(rep[2]) >= 1 and float(ger[2]) >= 1
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-3,
                               atol=1e-4)


def test_psd_ladder_is_a_backstop_for_non_finite_input(rng):
    """A NaN band leaves that batch element's factor non-finite (the
    ladder cannot cure it), the others untouched."""
    _, tbands = _bands(rng, T=6, k=2, tf_order=1)
    clean = tb.block_banded_cholesky(tbands)
    tbands = tbands.clone()
    tbands[1, 3, 0, 0, 0] = torch.nan
    L = tb.block_banded_cholesky(tbands, psd_attempts=2)
    np.testing.assert_array_equal(L[0].numpy(), clean[0].numpy())
    assert not torch.isfinite(L[1]).all()


@pytest.mark.parametrize("equilibrate", [False, True])
def test_sample_mvn_block_banded_matches_jax_with_its_z(rng, key,
                                                        equilibrate):
    jbands, tbands = _bands(rng, T=9, k=2, tf_order=2)
    mu_part = rng.normal(size=(2, 9, 2)).astype(np.float32)
    z = jax.random.normal(key, (2, 9, 2), dtype=jnp.float32)
    want, rep_j, _ = jb.sample_mvn_block_banded(
        key, jbands, mu_part=jnp.asarray(mu_part), equilibrate=equilibrate,
        return_repairs=True)
    got, rep, _ = tb.sample_mvn_block_banded(
        None, tbands, mu_part=_t(mu_part), equilibrate=equilibrate,
        return_repairs=True, z=_t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(rep_j))
    # from a precomputed factor, no mean
    L = tb.block_banded_cholesky(tbands)
    got = tb.sample_mvn_block_banded(None, L=L, z=_t(z))
    want = jb.sample_mvn_block_banded(key, L=jb.block_banded_cholesky(jbands))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("T,B,equilibrate", [(13, 4, True), (16, 8, True),
                                             (13, 4, False), (5, 8, True)])
def test_retiled_sampler_matches_jax_with_its_z(rng, key, T, B, equilibrate):
    """JAX draws z for the padded, tiled system, (m, T2, B*k); the rows
    past T belong to the identity padding and reach no returned
    coordinate, so the port takes the first T."""
    m, k = 2, 2
    jbands, tbands = _bands(rng, T=T, k=k, tf_order=2, m=m)
    mu_part = rng.normal(size=(m, T, k)).astype(np.float32)
    Be = min(max(B, 3), T)
    T2 = -(-T // Be)
    z = np.asarray(jax.random.normal(key, (m, T2, Be * k), dtype=jnp.float32))
    z = z.reshape(m, T2 * Be, k)[:, :T]
    want, rep_j, ger_j = jb.sample_mvn_block_banded_retiled(
        key, jbands, mu_part=jnp.asarray(mu_part), B=B,
        equilibrate=equilibrate, return_repairs=True)
    got, rep, ger = tb.sample_mvn_block_banded_retiled(
        None, tbands, mu_part=_t(mu_part), B=B, equilibrate=equilibrate,
        return_repairs=True, z=_t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(rep_j))
    np.testing.assert_array_equal(ger.numpy(), np.asarray(ger_j))


def test_retiled_sampler_moments(rng):
    """The port's own draws: mean and covariance of the (jittered)
    conditional against dense float64."""
    _, tbands = _bands(rng, T=6, k=2, tf_order=2, m=1)
    mu_part = _t(rng.normal(size=(1, 6, 2)))
    Q = tb.bands_to_dense(tbands).double().numpy()[0]
    n = 4000
    gen = torch.Generator().manual_seed(3)
    X = tb.sample_mvn_block_banded_retiled(
        gen, tbands.expand(n, -1, -1, -1, -1, -1),
        mu_part=mu_part.expand(n, -1, -1, -1), B=4).numpy().reshape(n, -1)
    Qj = Q + 1e-4 * np.diag(np.diag(Q))
    mean_ref = np.linalg.solve(Qj, mu_part.numpy().reshape(-1))
    cov_ref = np.linalg.inv(Qj)
    sd = np.sqrt(np.diag(cov_ref))
    assert np.all(np.abs(X.mean(0) - mean_ref) < 6 * sd / np.sqrt(n) + 1e-3)
    np.testing.assert_allclose(np.cov(X.T), cov_ref,
                               atol=6 * sd.max() ** 2 / np.sqrt(n) + 1e-3)
