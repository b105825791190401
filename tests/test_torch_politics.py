"""The port's politics pipeline against the JAX package: the host helpers
(``tensor_nmf``, ``ep_from_mf``, ``grid_ep_approx``, the app's
``ep_from_nmf`` and ``load_data``) at float64 tolerance (rtol=1e-9: the
same numpy arithmetic, the NNLS solves possibly in another order), and
the app's ``main`` on the CPU on a tiny tensor written as the benchmark's
three arrays."""
import os

import numpy as np
import pytest

from functionalmf_tpu.apps.politics import benchmark as jbench
from functionalmf_tpu.utils import ep as jep
from functionalmf_tpu.utils import nmf as jnmf
from functionalmf_tpu_torch.apps.politics import benchmark as tbench
from functionalmf_tpu_torch.utils import ep as tep
from functionalmf_tpu_torch.utils import nmf as tnmf

from tests.test_torch_constrained import torch_one_thread  # noqa: F401

RTOL = 1e-9


def _counts(rng, n=6, m=5, T=12, k=2, hold=0.1, drift=0.05):
    W = rng.gamma(1.5, 1, size=(n, k))
    V = np.abs(np.cumsum(rng.normal(0, drift, size=(m, T, k)), axis=1)
               + rng.gamma(1, 0.5, size=(m, 1, k)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
    Y[rng.random((n, m)) < hold] = np.nan
    return Y


@pytest.mark.parametrize("monotone", [False, True])
def test_tensor_nmf_matches_jax(monotone):
    Y = _counts(np.random.default_rng(3))
    Wj, Vj = jnmf.tensor_nmf(Y, 3, monotone=monotone,
                             rng=np.random.default_rng(1))
    Wt, Vt = tnmf.tensor_nmf(Y, 3, monotone=monotone,
                             rng=np.random.default_rng(1))
    np.testing.assert_allclose(Wt, Wj, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(Vt, Vj, rtol=RTOL, atol=1e-12)
    assert np.all(np.triu(Wt[:3], 1) == 0) and Vt.min() >= 1e-3


@pytest.mark.parametrize("mode", ["max", "multiplier"])
def test_ep_from_mf_matches_jax(mode):
    rng = np.random.default_rng(4)
    Y = _counts(rng)
    W, V = rng.gamma(1, 1, (6, 2)), rng.gamma(1, 1, (5, 12, 2))
    got = tep.ep_from_mf(Y, W, V, mode=mode, multiplier=3, verbose=False)
    want = jep.ep_from_mf(Y, W, V, mode=mode, multiplier=3, verbose=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL)
    with pytest.raises(ValueError, match="unknown mode"):
        tep.ep_from_mf(Y, W, V, mode="min")


@pytest.mark.parametrize("y", [0.0, 3.0, 40.0])
def test_grid_ep_approx_matches_jax(y):
    from scipy.stats import poisson

    def lik(x):
        return poisson.pmf(y, np.clip(x, 1e-12, None))

    got = tep.grid_ep_approx(lik, x_min=0, x_max=100)
    want = jep.grid_ep_approx(lik, x_min=0, x_max=100)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_app_helpers_match_jax(tmp_path):
    rng_t, rng_j = np.random.default_rng(42), np.random.default_rng(42)
    got = tbench.load_data(str(tmp_path), rng_t)
    want = jbench.load_data(str(tmp_path), rng_j)
    assert got[0].shape == (19, 19, 228)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    Y = _counts(np.random.default_rng(5))
    W, V = np.random.default_rng(6).gamma(1, 1, (6, 2)), \
        np.random.default_rng(7).gamma(1, 1, (5, 12, 2))
    for g, w in zip(tbench.ep_from_nmf(Y, W, V), jbench.ep_from_nmf(Y, W, V)):
        np.testing.assert_allclose(g, w, rtol=RTOL)


def _write_tensors(d, seed=0, n=6, T=16):
    """The benchmark's three arrays for a tiny n x n x T tensor whose
    curves move in time (so a per-pair mean is a poor fit)."""
    rng = np.random.default_rng(seed)
    Y = _counts(rng, n=n, m=n, T=T, hold=0.0, drift=0.5)
    hold = np.array([[0, 1], [2, 3], [4, 4]])
    Y_train = Y.copy()
    for i, j in hold:
        Y_train[i, j] = np.nan
    for name, arr in (("cooperate", Y), ("cooperate_train", Y_train),
                      ("held_out", hold)):
        np.save(os.path.join(d, name + ".npy"), arr)
    return Y


@pytest.mark.parametrize("extra", [["--v-schedule", "seq"],
                                   ["--v-schedule", "redblack",
                                    "--nchains", "2"],
                                   ["--v-block-size", "0"]])
def test_app_main_runs_on_cpu(tmp_path, extra):
    """The app end to end, EP on, at 6x6x16 and k=2: the report's metrics
    for both arms, the BTF's finite and its in-sample RMSE below the
    empirical mean's; the draws feasible and of the JAX package's shapes.
    (The empirical mean of a held-out pair is NaN, as in the JAX app: the
    pair has no training data.)"""
    _write_tensors(str(tmp_path))
    argv = ["--data-dir", str(tmp_path), "--device", "cpu", "--no-pgds",
            "--nembeds", "2", "--nburn", "15", "--nthin", "1",
            "--nsamples", "15", "--outdir", str(tmp_path / "out")] + extra
    out = tbench.run(tbench.parse_args(argv))
    assert set(out.table) == {"Empirical mean", "BTF"}
    for row in out.table.values():
        assert {"rmse_in", "rmse_out", "mae_in", "mae_out", "ll_in",
                "ll_out"} <= set(row)
    assert all(np.isfinite(v) for v in out.table["BTF"].values())
    assert out.table["BTF"]["rmse_in"] < out.table["Empirical mean"]["rmse_in"]
    nch = 2 if "--nchains" in extra else 1
    assert out.results["W"].shape == (nch * 15, 6, 2)
    assert out.results["V"].shape == (nch * 15, 6, 16, 2)
    assert [a.shape for a in out.warm_start] == [(6, 2), (6, 16, 2)]
    assert out.model.Mu_ep is not None and out.model.check_constraints()
    assert ("rhat_max" in out.table["BTF"]) == (nch > 1)
    assert os.path.exists(tmp_path / "out" / "metrics.json")
    assert os.path.exists(tmp_path / "out" / "btf_mu.npy")


def test_app_nb_arm_runs_on_cpu(tmp_path):
    """--nb adds the NegBinom BTF arm (global dispersion, Mu = R P /
    (1 - P)): its report row carries the same keys, finite, and its
    results the JAX package's keys, with R > 1."""
    _write_tensors(str(tmp_path))
    argv = ["--data-dir", str(tmp_path), "--device", "cpu", "--no-pgds",
            "--nb", "--nembeds", "2", "--nburn", "30", "--nthin", "1",
            "--nsamples", "20", "--outdir", str(tmp_path / "out")]
    out = tbench.run(tbench.parse_args(argv))
    assert set(out.table) == {"Empirical mean", "BTF", "NB-BTF"}
    assert set(out.table["NB-BTF"]) == {"rmse_in", "rmse_out", "mae_in",
                                        "mae_out", "ll_in", "ll_out"}
    assert all(np.isfinite(v) for v in out.table["NB-BTF"].values())
    nb = out.nb_results
    assert set(nb) == {"W", "V", "sigma2", "lam2", "Tau2", "nu2", "R",
                       "nan_fallbacks", "pivot_repairs"}
    assert nb["R"].shape == (20, 1, 1, 1) and (nb["R"] > 1).all()
    assert nb["nu2"].shape == (20, 6, 6, 16)
    assert (nb["nan_fallbacks"] == 0).all()
    assert out.nb_model.rdims == (0, 1, 2)
    import json
    with open(tmp_path / "out" / "metrics.json") as f:
        assert "NB-BTF" in json.load(f)


def test_app_pgds_mu_warm_start(tmp_path):
    Y = _write_tensors(str(tmp_path))
    np.save(tmp_path / "pgds_mu.npy", np.nan_to_num(Y) + 0.5)
    table = tbench.main(["--data-dir", str(tmp_path), "--device", "cpu",
                         "--pgds-mu", str(tmp_path / "pgds_mu.npy"),
                         "--no-ep", "--nembeds", "2", "--nburn", "5",
                         "--nthin", "1", "--nsamples", "5"])
    assert np.isfinite(table["BTF"]["rmse_in"])


def test_app_pgds_arm_runs_on_cpu(tmp_path, monkeypatch):
    """Without --no-pgds the app fits PGDS in process at its own sweep
    counts (and, as the JAX app, at fit_pgds's default seed, not the
    app's), reports it as "Schein et al (2016)" and takes the NMF warm
    start from its posterior mean."""
    Y = _write_tensors(str(tmp_path))
    targets, pgds_kw = [], []
    nmf, pgds = tbench.tensor_nmf, tbench.fit_pgds

    def spy(target, *args, **kwargs):
        targets.append(target)
        return nmf(target, *args, **kwargs)

    def pgds_spy(*args, **kwargs):
        pgds_kw.append(kwargs)
        return pgds(*args, **kwargs)
    monkeypatch.setattr(tbench, "tensor_nmf", spy)
    monkeypatch.setattr(tbench, "fit_pgds", pgds_spy)
    out = tbench.run(tbench.parse_args(
        ["--data-dir", str(tmp_path), "--device", "cpu", "--no-ep",
         "--nembeds", "2", "--nburn", "10", "--nthin", "2",
         "--nsamples", "6"]))
    assert set(out.table) == {"Empirical mean", "Schein et al (2016)",
                              "BTF"}
    row = out.table["Schein et al (2016)"]
    assert set(row) == {"rmse_in", "rmse_out", "mae_in", "mae_out", "ll_in",
                        "ll_out"}
    assert all(np.isfinite(v) for v in row.values())
    Mu, (W, V, U) = out.pgds_draws
    assert Mu.shape == (6,) + Y.shape and (Mu >= 0).all()
    assert W.shape == (6, 6, 2) and U.shape == (6, 16, 2)
    np.testing.assert_allclose(W.sum(1), 1.0, atol=1e-4)
    assert out.pgds_seconds > 0
    assert len(targets) == 1
    np.testing.assert_array_equal(targets[0], Mu.mean(axis=0))
    (kw,) = pgds_kw
    assert (kw["nburn"], kw["nthin"], kw["nsamples"]) == (10, 2, 6)
    assert "seed" not in kw and kw["device"] == "cpu"
