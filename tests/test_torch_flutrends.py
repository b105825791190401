"""The port's flu-trends app, examples and metric helpers against the JAX
package's: ``predictive_bands`` and the synthetic ``load_data`` equal under
the same numpy generator, the metric helpers equal to float64 (rtol=1e-12),
and the app's ``main`` and the three examples run on the CPU at small
sizes with their report keys present."""
import numpy as np
import pytest

from functionalmf_tpu.apps.flutrends import benchmark as jbench
from functionalmf_tpu.utils import metrics as jmetrics
from functionalmf_tpu_torch.apps.flutrends import benchmark as tbench
from functionalmf_tpu_torch.examples import (
    binomial_tensor_filtering as ex_binomial,
    gaussian_tensor_filtering as ex_gaussian,
    negbinom_tensor_filtering as ex_negbinom)
from functionalmf_tpu_torch.utils import metrics as tmetrics
from tests.test_torch_constrained import torch_one_thread  # noqa: F401


def test_predictive_bands_match_jax_and_are_per_cell():
    S, n, m, T = 40, 3, 1, 12
    rng = np.random.default_rng(0)
    centers = 1000.0 * np.arange(T)
    Mu_hat = centers[None, None, None, :] + rng.normal(0, 0.5, (S, n, m, T))
    nu2s = np.full((S, 1, 1, 1), 0.25)
    lo, hi = tbench.predictive_bands(Mu_hat, nu2s,
                                     np.random.default_rng(1), nsim=200)
    jlo, jhi = jbench.predictive_bands(Mu_hat, nu2s,
                                       np.random.default_rng(1), nsim=200)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert lo.shape == hi.shape == (n, m, T)
    # each cell's band is built from that cell's values only
    assert np.max(np.abs((lo + hi) / 2 - centers[None, None, :])) < 10.0
    assert 1.5 < (hi - lo).mean() < 4.5
    # per-row nu2, as nu2_mode="row" returns it
    row = np.broadcast_to(np.array([0.01, 0.25, 4.0])[None, :, None, None],
                          (S, n, 1, 1))
    lo, hi = tbench.predictive_bands(Mu_hat, row, np.random.default_rng(2))
    w = (hi - lo).mean(axis=(1, 2))
    assert w[0] < w[1] < w[2]


def test_synthetic_load_data_matches_jax(tmp_path):
    got = tbench.load_data(str(tmp_path), np.random.default_rng(42))
    want = jbench.load_data(str(tmp_path), np.random.default_rng(42))
    assert got[0].shape == (50, 1, 370) and got[2].shape == (30, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert np.isnan(got[1]).sum() == 30 * 52 and not np.isnan(got[0]).any()


def _write_mats(d, n=10, T=60, seed=0):
    from scipy.io import savemat
    rng = np.random.default_rng(seed)
    base = (np.sin(np.linspace(0, 6, T))[None]
            * rng.normal(1, 0.3, size=(n, 1)) + 5)
    Y = np.exp(base + rng.normal(0, 0.2, size=(n, T)))
    train = Y.copy()
    hold = np.array([[i, 5 * i, 5 * i + 5] for i in range(3)])
    for i, a, b in hold:
        train[i, a:b] = np.nan
    savemat(str(d / "flu_US_states.mat"), {"data": Y.T})
    savemat(str(d / "flu_US_states_train.mat"), {"data": train.T})
    np.save(d / "held_out_years.npy", hold)
    return Y


@pytest.mark.parametrize("nu2_mode", ["scalar", "row"])
def test_app_main_runs_on_cpu(tmp_path, nu2_mode):
    """The app from .mat files of 10 states x 60 weeks, two nembeds: the
    report's keys per nembeds, finite; the in-sample RMSE below the
    data's standard deviation; results with the JAX package's nu2 shape.
    (On a much smaller tensor a chain of either package can settle in the
    mode that calls the whole signal noise, Mu = 0 and nu2 = mean(y^2).)"""
    Y = _write_mats(tmp_path)
    got = tbench.load_data(str(tmp_path), np.random.default_rng(0))
    want = jbench.load_data(str(tmp_path), np.random.default_rng(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    argv = ["--data-dir", str(tmp_path), "--device", "cpu", "--nembeds", "2",
            "3", "--nburn", "40", "--nthin", "1", "--nsamples", "40",
            "--nu2-mode", nu2_mode, "--outdir", str(tmp_path / "out")]
    table, fits = tbench.run(tbench.parse_args(argv))
    assert set(table) == {2, 3}
    for k, row in table.items():
        assert set(row) == {"cov_in", "cov_out", "rmse_in", "rmse_out",
                            "mae_in", "mae_out"}
        assert all(np.isfinite(v) for v in row.values())
        assert row["rmse_in"] < np.log(Y).std()
        assert 50 < row["cov_in"] <= 100
        res, model = fits[k]
        assert res["nu2"].shape == ((40, 1) if nu2_mode == "scalar"
                                    else (40, 10, 1, 1))
        assert res["V"].shape == (40, 1, 60, k)
        assert (res["nan_fallbacks"] == 0).all()
        for name in ("mu_mean", "y_upper", "y_lower"):
            assert (tmp_path / "out" / f"btf{k}_{name}.csv").exists()
    assert tbench.main(argv[:-2] + ["--nembeds", "2", "--nsamples",
                                    "4"]).keys() == {2}


def test_bnp_arm_raises_and_device_defaults_to_the_card(tmp_path):
    """``--bnp`` fits BNP-CovReg (L=10, k=20, 20 iterations) on the CPU
    beside a short BTF run: a ``bnp_covreg`` row with RMSE, MAE and band
    coverage, finite, its mean written under --outdir; the BNP draws of
    the JAX package's shapes. (20 iterations from the prior fit little in
    either package; fit quality is tests/test_torch_bnp_covreg.py's
    in-distribution test and chip_smoke.py's gate.) Both arms still run
    on the card by default."""
    Y = _write_mats(tmp_path)
    argv = ["--data-dir", str(tmp_path), "--device", "cpu", "--nembeds", "2",
            "--nburn", "5", "--nthin", "1", "--nsamples", "5", "--bnp",
            "--bnp-niter", "20", "--outdir", str(tmp_path / "out")]
    table, fits = tbench.run(tbench.parse_args(argv))
    row = table["bnp_covreg"]
    assert set(row) == {"cov_in", "cov_out", "rmse_in", "rmse_out",
                        "mae_in", "mae_out"}
    assert all(np.isfinite(v) for v in row.values())
    assert 0 <= row["cov_out"] <= 100 and 0 < row["cov_in"] <= 100
    assert row["mae_in"] <= row["rmse_in"] < 2 * np.log(Y).std()
    out = fits["bnp_covreg"]
    assert out["mu"].shape == out["var_diag"].shape == (2, 10, 60)
    assert out["state"]["zeta"].shape == (10, 20, 60)
    mean = np.loadtxt(tmp_path / "out" / "bnpcovreg_mu_mean.csv",
                      delimiter=",")
    np.testing.assert_allclose(mean, out["mu"].mean(0), rtol=1e-6)
    args = tbench.parse_args([])
    assert args.device == "cuda" and args.nembeds == [5, 10]
    assert (args.bnp, args.bnp_niter, args.bnp_burn) == (False, 10000, 0)


def test_metrics_match_jax(rng):
    x = rng.normal(size=(4, 5))
    y = rng.normal(size=(4, 5))
    y[1, 2] = np.nan
    p = rng.uniform(0.05, 0.95, size=(4, 5))
    for name, args in (("ilogit", (x,)), ("mse", (x, y)), ("mae", (x, y)),
                       ("moving_average", (x[0], 3)),
                       ("cross_entropy", ((y > 0) * 1.0, p)),
                       ("coverage_at", (x[0], rng.normal(size=(50, 5)), 90))):
        np.testing.assert_allclose(getattr(tmetrics, name)(*args),
                                   getattr(jmetrics, name)(*args),
                                   rtol=1e-12, err_msg=name)
    Y = rng.normal(size=(5, 4, 3, 2))
    got = tmetrics.random_holdouts(Y, 3, rng=np.random.default_rng(1),
                                   verbose=False)
    want = jmetrics.random_holdouts(Y, 3, rng=np.random.default_rng(1),
                                    verbose=False)
    np.testing.assert_array_equal(got, want)
    assert set(tmetrics.__all__) == set(jmetrics.__all__)


@pytest.mark.parametrize("example,keys", [
    (ex_gaussian, {"mae", "rmse", "coverage", "nu2"}),
    (ex_binomial, {"mae", "rmse", "coverage"}),
    (ex_negbinom, {"mae", "rmse", "coverage"})])
def test_examples_run_on_cpu(example, keys):
    """Each example end to end at its own 11x12x20, k=3, with a short
    chain: finite report values. (Recovery at the examples' full sweep
    counts is the card's work.)"""
    out = example.main(["--device", "cpu"], nburn=30, nthin=1, nsamples=30)
    assert set(out) == keys
    assert all(np.isfinite(v) for v in out.values())
    assert 0 <= out["coverage"] <= 100
    assert example.init_model(device="cpu").nembeds == 3
