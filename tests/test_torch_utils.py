"""The port's host utilities against the JAX package's and their plain
versions: ``pav`` (native and numpy) against JAX's ``_pav_numpy``
(atol=1e-12), ``grid_penalty_matrix`` equal, ``binary_mf`` and the
logistic loss and gradient equal under the same numpy generator, the
native bindings against the port's numpy versions and scipy
(``utils/native.py`` builds ``native/fmf_host.cpp`` into ``_build/``),
and the utils surface."""
import importlib
import threading

import numpy as np
import pytest
from scipy.optimize import isotonic_regression, nnls as scipy_nnls

import functionalmf_tpu.utils as jutils
from functionalmf_tpu.ops import penalty as jpenalty
from functionalmf_tpu.utils.pav import _pav_numpy as jax_pav_numpy
import functionalmf_tpu_torch.utils as tutils
from functionalmf_tpu_torch.ops import penalty as tpenalty
from functionalmf_tpu_torch.utils import native
from functionalmf_tpu_torch.utils.nmf import _nnls_gram_one
from functionalmf_tpu_torch.utils.pav import _pav_numpy, pav

# the modules (each package's utils re-exports the function binary_mf
# under the module's name)
jbmf = importlib.import_module("functionalmf_tpu.utils.binary_mf")
tbmf = importlib.import_module("functionalmf_tpu_torch.utils.binary_mf")


def test_pav_native_and_numpy_match_jax(rng):
    for _ in range(100):
        y = rng.normal(size=rng.integers(1, 40))
        want = jax_pav_numpy(y)
        np.testing.assert_allclose(pav(y), want, atol=1e-12)
        np.testing.assert_allclose(_pav_numpy(y), want, atol=1e-12)
        assert (np.diff(pav(y)) >= -1e-12).all()
    with pytest.raises(ValueError):
        _pav_numpy(np.zeros((2, 2)))


def test_pav_weighted_is_weighted_isotonic_regression(rng):
    for _ in range(50):
        n = rng.integers(1, 30)
        y, w = rng.normal(size=n), rng.uniform(0.1, 5.0, n)
        np.testing.assert_allclose(native.pav_weighted(y, w),
                                   isotonic_regression(y, weights=w).x,
                                   atol=1e-10)
    y = rng.normal(size=12)
    np.testing.assert_allclose(native.pav_weighted(y, np.ones(12)), pav(y),
                               atol=1e-14)


def test_nnls_matches_scipy(rng):
    for _ in range(100):
        m, n = rng.integers(3, 40), rng.integers(1, 8)
        A, b = rng.normal(size=(m, n)), rng.normal(size=m)
        x = native.nnls(A, b)
        ref = scipy_nnls(A, b)[0]
        assert x.min() >= 0
        assert np.linalg.norm(A @ x - b) <= np.linalg.norm(A @ ref - b) + 1e-8
        np.testing.assert_allclose(x, ref, atol=1e-7)
    A, B = rng.normal(size=(20, 4)), rng.normal(size=(10, 20))
    X = native.nnls_batch(A, B)
    for i in range(10):
        np.testing.assert_allclose(X[i], native.nnls(A, B[i]), atol=1e-12)


def test_nnls_gram_matches_the_numpy_solver(rng):
    """The Gram-form solvers against the port's numpy ``_nnls_gram_one``
    (the plain version of ``tensor_nmf``'s inner solve): atol=1e-10."""
    nb, n = 40, 5
    A = rng.normal(size=(nb, 12, n))
    G = np.einsum("bmi,bmj->bij", A, A)
    F = np.einsum("bmi,bm->bi", A, rng.normal(size=(nb, 12)))
    X = native.nnls_gram_batch(G, F)
    for i in range(nb):
        want = _nnls_gram_one(G[i], F[i])
        np.testing.assert_allclose(X[i], want, atol=1e-10)
        np.testing.assert_allclose(native.nnls_gram(G[i], F[i]), want,
                                   atol=1e-10)
    assert X.min() >= 0 and (X == 0).any()
    with pytest.raises(ValueError):
        native.nnls_gram_batch(G[:, :4], F)


def test_native_build_goes_to_build_dir_and_raises_on_failure(
        tmp_path, monkeypatch):
    """The library is built into functionalmf_tpu_torch/_build/ from
    native/fmf_host.cpp; four builds at once each rename their own
    temporary file into place and leave none behind; a source that does
    not compile raises with the compiler's message."""
    path = native.build()
    assert path.parent.name == "_build" and path.exists()
    assert path.parent.parent.name == "functionalmf_tpu_torch"
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "b")
    outs, errors = [], []

    def one():
        try:
            outs.append(native.build(force=True))
        except Exception as e:   # noqa: BLE001 (reported below)
            errors.append(e)
    threads = [threading.Thread(target=one) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(set(outs)) == 1 and outs[0].name == path.name
    assert [p.name for p in (tmp_path / "b").iterdir()] == [path.name]
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC", bad)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        native.build()
    assert [p.name for p in (tmp_path / "b").iterdir()] == [path.name]


@pytest.mark.parametrize("dims,k", [((2, 3), 0), ((4, 3), 1), ((3, 3, 2), 2),
                                    ((5,), 3)])
def test_grid_penalty_matrix_matches_jax(dims, k):
    np.testing.assert_array_equal(tpenalty.grid_penalty_matrix(dims, k),
                                  jpenalty.grid_penalty_matrix(dims, k))


@pytest.mark.parametrize("icpt", [False, True])
def test_logistic_loss_and_grad_match_jax(rng, icpt):
    X = rng.normal(size=(30, 4))
    y = (rng.random(30) < 0.4).astype(float)
    beta = rng.normal(size=5 if icpt else 4)
    for name in ("logistic_regression_loss", "logistic_regression_grad"):
        np.testing.assert_array_equal(
            getattr(tbmf, name)(X, y, 0.3, beta),
            getattr(jbmf, name)(X, y, 0.3, beta), err_msg=name)


@pytest.mark.parametrize("lam", [0.5, None])
def test_binary_mf_matches_jax(lam):
    """A fixed ridge, and the ridge chosen by 2-fold CV over 3 values:
    the same (W, V) from the same generator."""
    rng = np.random.default_rng(0)
    W0, V0 = rng.normal(size=(12, 2)), rng.normal(size=(9, 2))
    Y = (rng.random((12, 9)) < 1 / (1 + np.exp(-W0 @ V0.T))).astype(float)
    Y[rng.random(Y.shape) < 0.1] = np.nan
    kw = dict(lam=lam, lams=3, cv=2, max_steps=10)
    got = tbmf.binary_mf(Y, 2, rng=np.random.default_rng(1), **kw)
    want = jbmf.binary_mf(Y, 2, rng=np.random.default_rng(1), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    assert got[0].shape == (12, 2) and got[1].shape == (9, 2)


def test_setup_bench_times_both_nnls_on_a_small_simulation():
    """``utils/nmf_bench.py`` end to end on a small dose-response
    simulation: a run a solver, the NNLS and SLSQP seconds inside the
    total, and the patched solvers put back."""
    from functionalmf_tpu_torch.utils import nmf, nmf_bench
    before = (nmf._nnls_gram_batch, nmf._capped_resolve)
    out = nmf_bench.run(dict(k=2, n=8, m=6, t=4, r=2, p=4, seed=0),
                        order=("native", "numpy"))
    assert [r["nnls"] for r in out["runs"]] == ["native", "numpy"]
    for r in out["runs"]:
        assert 0 < r["nnls_s"] and r["nnls_s"] + r["slsqp_s"] <= r["total_s"]
    assert (nmf._nnls_gram_batch, nmf._capped_resolve) == before
    assert out["features"] == 4


def test_utils_surface_matches_jax():
    assert tutils.__all__ == jutils.__all__
    for name in tutils.__all__:
        assert getattr(tutils, name).__module__.startswith(
            "functionalmf_tpu_torch."), name
