"""The port's dose-response app against the JAX package's.

The same inputs, made from a numpy seed, go through both: the Gamma grid
likelihood (within the float32 rounding of each cell's terms, and against
a float64 per-replicate evaluation at the benchmark's grid shapes),
``make_loglikelihood`` at row, column and full-tensor calls (rtol=1e-5),
``tensor_nmf`` with ``max_entry`` and ``row_features`` under the same rng
(rtol=1e-6: float64 host code), the U step under the noise JAX itself
draws (atol=1e-5). The host and the device hook give feasible chains and
the same U in distribution, and the app runs end to end through its entry
point on ``--device cpu`` at simulate(k=2, n=5, m=4, t=5, r=3, p=6) with a
handful of sweeps.
"""
import csv

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from functionalmf_tpu.apps.doseresponse import fit as jfit
from functionalmf_tpu.apps.doseresponse.empirical_bayes import (
    GammaGridLikelihood as JaxLikelihood)
from functionalmf_tpu.utils.nmf import tensor_nmf as jax_tensor_nmf
from functionalmf_tpu_torch.apps.doseresponse import fit, sim
from functionalmf_tpu_torch.apps.doseresponse.empirical_bayes import (
    estimate_likelihood, poisson_glm_fit, read_csv_columns)
from functionalmf_tpu_torch.interop import (data_from_numpy, data_to_numpy,
                                            gamma_grid_likelihood)
from functionalmf_tpu_torch.utils.nmf import tensor_nmf

from tests.test_torch_constrained import torch_one_thread  # noqa: F401
from tests.test_torch_samplers import _gass_noise

GRID = (np.array([0.8, 0.95, 1.0, 1.1, 1.25]),
        np.array([0.1, 0.2, 0.4, 0.2, 0.1]), 0.02)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _likelihoods():
    return JaxLikelihood(*GRID), gamma_grid_likelihood(*GRID, device="cpu")


def _dose_data(seed=0, n=5, m=4, T=6, r=3, p=7, k=2):
    rng = np.random.default_rng(seed)
    W = rng.gamma(2, 0.3, (n, k))
    V = np.sort(rng.uniform(0.05, 0.6, (m, T, k)), axis=1)[:, ::-1]
    Mu = np.clip(np.einsum("nk,mtk->nmt", W, V), 0.02, 0.98)
    Y = rng.gamma(50.0, Mu[..., None] / 50.0, size=(n, m, T, r))
    Y[0, 1, 2, 1] = np.nan
    Y[2, 3] = np.nan
    U = rng.uniform(0.0, 0.5, (p, k)) / W.max()
    X = (rng.random((n, p)) < 0.5).astype(float)
    X[1] = np.nan
    X[3, 2] = np.nan
    return Y, X, U, W, V, Mu


EPS32 = float(np.finfo(np.float32).eps)


def _logpdf64(y, effect, mean_grid, probs, variance):
    """The mixture evaluated replicate by replicate in float64, as the
    reference writes it (empirical_bayes.py:15-31), and each cell's
    float32 rounding scale: over the components, the largest sum of the
    magnitudes of its terms (the replicates' four, the rounding of the
    scale through shape log scale, and log p). Returns (ll, mag), (...)."""
    from scipy.special import gammaln, logsumexp
    a = mean_grid ** 2 / variance
    y = np.asarray(y, np.float64)[..., None]               # (..., R, 1)
    scale = np.maximum(variance / mean_grid
                       * np.asarray(effect, np.float64)[..., None, None],
                       1e-12)
    nan = np.isnan(y)
    ys = np.maximum(np.where(nan, 1.0, y), 1e-12)
    terms = ((a - 1) * np.log(ys), -ys / scale,
             -gammaln(a) * np.ones_like(ys), -a * np.log(scale))
    comp = np.where(nan, 0.0, sum(terms)).sum(-2)            # (..., G)
    mag = np.where(nan, 0.0, sum(np.abs(t) for t in terms) + a).sum(-2)
    return (logsumexp(comp, b=probs, axis=-1),
            (mag + np.abs(np.log(probs))).max(-1))


def test_gamma_grid_logpdf_matches_jax():
    """The port's mixture against the JAX package's at seeds 0-3 and 42,
    each within the float32 rounding of the cell's terms (4 eps of their
    magnitudes a side, ``_logpdf64``): the terms reach hundreds and cancel,
    so a fixed rtol holds at one seed and not at the next."""
    jl, tl = _likelihoods()
    for seed in (0, 1, 2, 3, 42):
        rng = np.random.default_rng(seed)
        y = rng.gamma(20.0, 0.05, size=(4, 5, 6, 3))
        y[0, 1, 2, 0] = np.nan
        y[1, 2] = np.nan
        effect = rng.uniform(0.05, 1.0, size=(4, 5, 6))
        y32, e32 = y.astype(np.float32), effect.astype(np.float32)
        want = np.asarray(jl.logpdf(jnp.asarray(y32), jnp.asarray(e32)))
        got = tl.logpdf(_t(y), _t(effect)).numpy()
        assert got.shape == (4, 5, 6)
        _, mag = _logpdf64(y32, e32, *GRID)
        np.testing.assert_array_less(np.abs(got - want), 8 * EPS32 * mag)
        # numpy inputs, as results.py and select_btf.py pass them
        np.testing.assert_array_equal(tl.logpdf(y, effect).numpy(), got)


# the dose-response benchmark's grid: 20 means whose shapes span 1e2-2e3 at
# variance 1.3e-3
DOSE_GRID = (np.linspace(0.43, 1.57, 20),
             np.r_[np.linspace(1.0, 4.0, 10), np.linspace(4.0, 1.0, 10)]
             / 50.0, 1.3e-3)


def _dose_cells(R, seed):
    """(cells, R) replicates near their effect, a few missing, one cell
    with every replicate missing, and an effect of 0 in two cells."""
    rng = np.random.default_rng(seed)
    effect = rng.uniform(0.05, 1.0, size=40)
    effect[[3, 17]] = 0.0
    y = rng.gamma(700.0, np.maximum(effect, 0.3)[:, None] / 700.0,
                  size=(40, R))
    y[5] = np.nan
    if R > 1:
        y[[7, 8, 30], [0, R - 1, 1]] = np.nan
    return y, effect


@pytest.mark.parametrize("R", [1, 6])
def test_gamma_grid_logpdf_matches_float64_per_replicate(R):
    """The three-statistic form against the per-replicate mixture in
    float64, within 4 float32 eps of each cell's terms, at DOSE_GRID's shapes;
    the all-missing cell is log sum p exactly, and an effect of 0 meets
    the scale's clamp."""
    lik = gamma_grid_likelihood(*DOSE_GRID, device="cpu")
    for seed in range(3):
        y, effect = _dose_cells(R, seed)
        y32, e32 = y.astype(np.float32), effect.astype(np.float32)
        got = lik.logpdf(_t(y32), _t(e32)).numpy()
        want, mag = _logpdf64(y32, e32, *DOSE_GRID)
        np.testing.assert_array_less(np.abs(got - want), 4 * EPS32 * mag)
        assert got[5] == float(torch.logsumexp(lik.log_probs, 0))
        assert np.all(got[[3, 17]] < -1e9) and np.all(np.isfinite(got))


def test_gamma_grid_logpdf_lifted_over_candidates():
    """Lifted by vmap over candidates with y unbatched, and over items
    and candidates with y batched by item, the mixture equals the loop."""
    lik = gamma_grid_likelihood(*DOSE_GRID, device="cpu")
    y, _ = _dose_cells(6, 0)
    y = _t(y).reshape(4, 10, 6)                             # (item, T, R)
    gen = torch.Generator().manual_seed(0)
    eff = torch.rand(4, 7, 10, generator=gen)               # (item, G, T)
    eff[1, 2, 3] = 0.0

    def one(y_i, e_g):
        return lik.logpdf(y_i, e_g).sum()

    loop = torch.stack([torch.stack([one(y[i], eff[i, g]) for g in range(7)])
                        for i in range(4)])
    cands = torch.func.vmap(lambda e_g: one(y[2], e_g))(eff[2])
    np.testing.assert_allclose(cands.numpy(), loop[2].numpy(), rtol=1e-6)
    lifted = torch.func.vmap(lambda y_i, e_i: torch.func.vmap(
        lambda e_g: one(y_i, e_g))(e_i))(y, eff)
    np.testing.assert_allclose(lifted.numpy(), loop.numpy(), rtol=1e-6)


def test_gamma_grid_logpdf_matches_scipy():
    """tests/test_doseresponse.py:test_gamma_grid_likelihood_matches_scipy
    for the port; rtol=1e-4 as there."""
    from scipy.special import logsumexp
    from scipy.stats import gamma
    mean_grid = np.array([0.8, 1.0, 1.2])
    probs = np.array([0.25, 0.5, 0.25])
    var = 0.05
    lik = gamma_grid_likelihood(mean_grid, probs, var, device="cpu")
    y = np.array([[0.9, 1.1, np.nan], [0.5, 0.6, 0.7]])
    effect = np.array([1.0, 0.6])
    ours = lik.logpdf(y, effect).numpy()
    shapes, scales = mean_grid ** 2 / var, var / mean_grid
    ref = np.zeros(2)
    for t in range(2):
        comp = [np.nansum(gamma.logpdf(y[t], shapes[g],
                                       scale=scales[g] * effect[t]))
                for g in range(3)]
        ref[t] = logsumexp(comp, b=probs)
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_gamma_grid_sample_and_glm(rng):
    lik = gamma_grid_likelihood(np.array([1.0]), np.array([1.0]), 0.01,
                                device="cpu")
    draws = lik.sample(np.ones(5000), size=5000, rng=rng)
    np.testing.assert_allclose(draws.mean(), 1.0, rtol=0.05)
    x = np.arange(25)
    mu = np.exp(1.0 + 0.2 * x - 0.01 * x ** 2)
    counts = np.random.default_rng(0).poisson(mu)
    from functionalmf_tpu.apps.doseresponse.empirical_bayes import (
        poisson_glm_fit as jax_glm)
    np.testing.assert_allclose(poisson_glm_fit(counts), jax_glm(counts),
                               rtol=1e-8)


@pytest.mark.parametrize("with_features", [False, True])
def test_make_loglikelihood_row_column_and_full_calls(with_features):
    """One item at a time, as the contract has it: a row call, a column
    call and the full-tensor call equal the JAX functions; then the row
    call lifted by vmap over rows and candidates equals the loop."""
    Y, X, U, W, V, Mu = _dose_data()
    jl, tl = _likelihoods()
    jll = jfit.make_loglikelihood(jl, with_features)
    tll = fit.make_loglikelihood(tl, with_features)
    np_data = {"Y": Y, "X": X, "U": U} if with_features else {"Y": Y}
    jdata = {key: jnp.asarray(v, jnp.float32) for key, v in np_data.items()}
    # the data dict crosses between the packages through interop
    tdata = data_from_numpy({key: np.asarray(v) for key, v in jdata.items()},
                            "cpu")
    assert set(tdata) == set(np_data) and tdata["Y"].dtype == torch.float32
    for key, v in data_to_numpy(tdata).items():
        np.testing.assert_array_equal(v, np.asarray(jdata[key]))
    jW, jV, jMu = (jnp.asarray(a, jnp.float32) for a in (W, V, Mu))
    tW, tV, tMu = _t(W), _t(V), _t(Mu)
    for i in (0, 1, 4):
        want = float(jll(jdata, jMu[i], jW[i], jV, row=i))
        got = float(tll(tdata, tMu[i], tW[i], tV, row=torch.tensor(i)))
        assert got == pytest.approx(want, rel=1e-5)
    for j in (0, 3):
        want = float(jll(jdata, jMu[:, j], jW, jV[j], col=j))
        got = float(tll(tdata, tMu[:, j], tW, tV[j], col=torch.tensor(j)))
        assert got == pytest.approx(want, rel=1e-5)
    assert float(tll(tdata, tMu, tW, tV)) == pytest.approx(
        float(jll(jdata, jMu, jW, jV)), rel=1e-5)

    G = 3
    cands = tW[:, None, :] * torch.linspace(0.8, 1.1, G)[None, :, None]
    tau = torch.einsum("igk,mtk->igmt", cands, tV)
    lifted = torch.func.vmap(lambda i, t_i, w_i: torch.func.vmap(
        lambda t_g, w_g: tll(tdata, t_g, w_g, tV, row=i))(t_i, w_i))(
            torch.arange(W.shape[0]), tau, cands)
    loop = torch.stack([torch.stack([
        tll(tdata, tau[i, g], cands[i, g], tV, row=torch.tensor(i))
        for g in range(G)]) for i in range(W.shape[0])])
    np.testing.assert_allclose(lifted.numpy(), loop.numpy(), rtol=1e-5)


@pytest.mark.parametrize("nnls", ["numpy", "native"])
@pytest.mark.parametrize("features", [False, True])
def test_tensor_nmf_max_entry_and_row_features_match_jax(features, nnls,
                                                         monkeypatch):
    """Both packages solve their NNLS problems the same way: through their
    numpy versions (``_nnls_gram_one``, each its own), or through their
    native libraries, both built from native/fmf_host.cpp. The native and
    the numpy solver agree to 1e-15 only, and the monotone projection
    pools on exact ties between cells that sit at the cap."""
    from functionalmf_tpu.utils import nmf as jnmf
    from functionalmf_tpu_torch.utils import nmf as tnmf
    if nnls == "numpy":
        for mod in (jnmf, tnmf):
            monkeypatch.setattr(mod, "_nnls_gram_batch", lambda G, F, m=mod:
                                np.stack([m._nnls_gram_one(G[i], F[i])
                                          for i in range(len(F))]))
    else:
        from functionalmf_tpu.utils import native as jnative  # noqa: F401
    Y, X, *_ = _dose_data(seed=3, n=6, m=5, T=7)
    Y = Y * 1.6               # some reconstructions reach the cap
    kw = dict(monotone=True, max_entry=0.999)
    if features:
        kw["row_features"] = X
    want = jax_tensor_nmf(Y, 2, rng=np.random.default_rng(5), **kw)
    got = tensor_nmf(Y, 2, rng=np.random.default_rng(5), **kw)
    assert len(got) == len(want) == (3 if features else 2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    Mu = np.einsum("nk,mtk->nmt", got[0], got[1])
    assert Mu.min() >= 0 and Mu.max() <= 1.0
    assert (np.diff(Mu, axis=-1) <= 1e-9).all()        # monotone
    if features:
        assert got[2].shape == (X.shape[1], 2)
        assert (got[0] @ got[2].T).max() <= 0.999 + 1e-6


def test_u_step_matches_jax_under_injected_noise(monkeypatch):
    """``_make_u_all``: the feature embeddings' batched GASS update from
    the same U, W, proposal draws, slice heights and Gumbel scores as the
    JAX package's per-feature updates; atol=1e-5."""
    Y, X, U, W, *_ = _dose_data(seed=2)
    p, k = U.shape
    key = jax.random.PRNGKey(9)
    want = np.asarray(jfit._make_u_all(X)(
        key, jnp.asarray(U, jnp.float32), jnp.asarray(W, jnp.float32)))
    v, log_u, gum = [], [], []
    for i in range(p):
        k_i = jax.random.fold_in(key, i)
        _, k_v, _ = jax.random.split(k_i, 3)
        v.append(np.asarray(jax.random.normal(k_v, (k,))))
        lu, g = _gass_noise(k_i, fit.U_NGRID)
        log_u.append(lu)
        gum.append(g)
    # the port's draw sites give back the JAX draws: the proposal draws
    # (p, k), then log u (p,) and the Gumbels (p, ngrid)
    monkeypatch.setattr(fit.torch, "randn", lambda *a, **kw: _t(np.stack(v)))
    monkeypatch.setattr(fit, "draw_gass_noise",
                        lambda *a: (_t(log_u), _t(np.stack(gum))))
    got = fit._make_u_all(X, torch.device("cpu"))(None, _t(U), _t(W)).numpy()
    monkeypatch.undo()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not np.allclose(got, U)
    wu = W @ got.T
    assert wu.min() >= -1e-6 and wu.max() <= 1 + 1e-6


def _write_sim(path):
    s = sim.simulate(k=2, n=5, m=4, t=5, r=3, p=6, n_missing=1, p_missing=1,
                     seed=0)
    sim.write_csv(s, str(path))
    return s


def test_sim_csv_and_estimate_likelihood_match_jax(tmp_path):
    """The simulator draws what the JAX package's draws; the CSVs written
    with the csv module read back, through ``read_csv_columns``, to the
    tensor, grid and noise the JAX package gets through pandas."""
    import pandas as pd
    from functionalmf_tpu.apps.doseresponse import sim as jsim
    from functionalmf_tpu.apps.doseresponse.empirical_bayes import (
        estimate_likelihood as jax_estimate)
    s = _write_sim(tmp_path)
    js = jsim.simulate(k=2, n=5, m=4, t=5, r=3, p=6, n_missing=1,
                       p_missing=1, seed=0)
    for key in ("obs", "effects", "features", "U"):
        np.testing.assert_array_equal(s[key], js[key])
    Y, lik, cells, drugs, concs, _ = estimate_likelihood(
        read_csv_columns(tmp_path / "data.csv"), nbins=10,
        tensor_outcomes=True, verbose=False, device="cpu")
    jY, jlik, jcells, jdrugs, jconcs, _ = jax_estimate(
        pd.read_csv(tmp_path / "data.csv", header=0), nbins=10,
        tensor_outcomes=True, verbose=False)
    assert Y.shape == (4, 4, 5, 3) and len(concs) == 5
    assert (cells, drugs) == (jcells, jdrugs)
    np.testing.assert_allclose(concs, jconcs)
    np.testing.assert_allclose(Y, jY, rtol=1e-12)
    np.testing.assert_allclose(lik.shape_grid.numpy(),
                               np.asarray(jlik.shape_grid), rtol=1e-6)
    np.testing.assert_allclose(lik.probs_grid.numpy(),
                               np.asarray(jlik.probs_grid), rtol=1e-6)
    X, names = fit.read_features(tmp_path / "features.csv", cells)
    fdf = pd.read_csv(tmp_path / "features.csv", index_col=0, header=0)
    assert names == list(fdf.columns) and X.shape == (4, 6)
    assert np.isnan(X[0]).all()              # Tumor0 has no features
    np.testing.assert_array_equal(X[1:], fdf.loc[cells[1:]].values)
    with open(tmp_path / "data.csv", newline="") as f:
        assert next(csv.reader(f)) == ["cell line", "drug", "concentration",
                                       "outcome"]


def _run_app(tmp_path, *extra):
    _write_sim(tmp_path)
    out = tmp_path / "out"
    res = fit.run(fit.parse_args([
        "--data", str(tmp_path / "data.csv"), "--outdir", str(out),
        "--nembeds", "2", "--seed", "0", "--nbins", "10", "--device", "cpu",
        *extra]))
    return res, out


def test_fit_pipeline_end_to_end(tmp_path):
    """tests/test_doseresponse.py:test_fit_pipeline_end_to_end at 12 + 12
    sweeps: the saved arrays under the JAX package's names, every draw
    finite and inside the [0, 1] constraints."""
    res, out = _run_app(tmp_path, "--nburn", "12", "--nsamples", "12",
                        "--nholdout", "2")
    Mu_hat = np.load(out / "btf.npy")
    assert Mu_hat.shape == (12, 4, 4, 5)
    assert np.isfinite(Mu_hat).all()
    assert Mu_hat.min() >= -1e-4 and Mu_hat.max() <= 1 + 1e-4
    assert (Mu_hat[..., :-1] - Mu_hat[..., 1:]).min() >= -1e-2 - 1e-4
    for name in ("y", "nmf", "nmf_mono", "btf_w", "btf_v", "btf_mono",
                 "btf_ep_sigma", "held_out", "cells", "drugs"):
        assert (out / f"{name}.npy").exists(), name
    assert not (out / "btf_u.npy").exists()
    assert set(res["report"]) == {"mae_in", "rmse_in", "mae_out", "rmse_out"}
    assert res["model"].loglikelihood_cellfn is None
    mono = np.load(out / "btf_mono.npy")
    assert (np.diff(mono, axis=-1) <= 1e-6).all()


@pytest.mark.parametrize("flavour", ["device", "host"])
def test_fit_pipeline_with_features(tmp_path, flavour):
    """--features --sample_features with the device-side hook (the
    default) and with --host-callback: U (nsamples, p, k) moves, and every
    draw keeps the curve and the row constraints."""
    extra = ("--host-callback",) if flavour == "host" else ()
    res, out = _run_app(
        tmp_path, "--features", str(tmp_path / "features.csv"),
        "--sample_features", "--nburn", "10", "--nsamples", "10", *extra)
    U = np.load(out / "btf_u.npy")
    W = np.load(out / "btf_w.npy")
    Mu = np.load(out / "btf.npy")
    assert U.shape == (10, 6, 2) and np.isfinite(U).all()
    assert not np.allclose(U[0], U[-1])
    assert not np.allclose(U[0], res["U0"])
    wu = np.einsum("snk,spk->snp", W, U)
    assert wu.min() >= -1e-5 and wu.max() <= 1 + 1e-5
    assert Mu.min() >= -1e-4 and Mu.max() <= 1 + 1e-4
    assert res["model"].check_constraints()
    assert res["model"].nchains == 1


def test_fixed_w_with_features_and_forced_single_chain(tmp_path, capsys,
                                                       monkeypatch):
    """--features without --sample_features fixes W at the NMF start;
    a second run given the first one's host fits repeats it without
    fitting anything again; --sample_features with --nchains 2 runs one
    chain and says so."""
    argv = ("--features", str(tmp_path / "features.csv"), "--nburn", "3",
            "--nsamples", "3")
    res, out = _run_app(tmp_path, *argv)
    W = np.load(out / "btf_w.npy")
    np.testing.assert_array_equal(W[0], W[-1])
    assert not res["model"].sample_W
    with monkeypatch.context() as mp:
        mp.setattr(fit, "tensor_nmf", None)
        mp.setattr(fit, "ep_from_mf", None)
        again = fit.run(fit.parse_args([
            "--data", str(tmp_path / "data.csv"), "--outdir",
            str(tmp_path / "again"), "--nembeds", "2", "--seed", "0",
            "--nbins", "10", "--device", "cpu", *argv]), fits=res["fits"])
    np.testing.assert_array_equal(again["results"]["V"], res["results"]["V"])
    assert again["report"] == res["report"]
    res, _ = _run_app(tmp_path, "--features", str(tmp_path / "features.csv"),
                      "--sample_features", "--nchains", "2", "--nburn", "2",
                      "--nsamples", "2")
    assert res["model"].nchains == 1
    assert "forces nchains=1" in capsys.readouterr().out


def test_host_and_device_hooks_agree_in_distribution(tmp_path):
    """The two hook flavours are the same sampler with different noise
    sites: their posterior means of W U^T (identified, in [0, 1]) agree
    within a mean absolute difference of 0.1 (0.03 measured; two device
    runs that differ in the seed, and so in the NMF start, differ by
    0.05)."""
    _write_sim(tmp_path)
    df = read_csv_columns(tmp_path / "data.csv")
    Y, lik, cells, *_ = estimate_likelihood(df, nbins=10,
                                            tensor_outcomes=True,
                                            verbose=False, device="cpu")
    X, _ = fit.read_features(tmp_path / "features.csv", cells)
    means = {}
    for flavour in ("device", "host"):
        args = fit.parse_args(["--nembeds", "2", "--seed", "0", "--device",
                               "cpu", "--features", "x", "--sample_features"])
        model, U0 = fit.init_model(Y, lik, args, X=X)
        data = {"Y": Y, "X": X, "U": U0}
        kw = (dict(traced_callback=fit.make_traced_u_step(X, model.device))
              if flavour == "device"
              else dict(callback=fit.make_u_step(args, X, model.device)))
        res = model.run_gibbs(data, nburn=60, nthin=1, nsamples=140,
                              verbose=False, collect_data_keys=("U",), **kw)
        wu = np.einsum("snk,spk->snp", res["W"], res["U"])
        assert wu.min() >= -1e-5 and wu.max() <= 1 + 1e-5, flavour
        assert model.check_constraints(), flavour
        means[flavour] = wu.mean(0)
    assert np.abs(means["device"] - means["host"]).mean() < 0.1, means


def test_helper_modules_run(tmp_path):
    """select_btf's DIC, results' table, the logistic baseline (its
    autograd gradient against finite differences), the feature screen and
    the plots, on a run the app saved."""
    from functionalmf_tpu_torch.apps.doseresponse import (
        feature_importance, logistic, plots, results, select_btf)
    res, out = _run_app(
        tmp_path, "--features", str(tmp_path / "features.csv"),
        "--sample_features", "--nburn", "4", "--nsamples", "6")
    Y, lik = res["Y"], res["likelihood"]
    Mu = np.load(out / "btf.npy")
    from functionalmf_tpu.apps.doseresponse import select_btf as jselect
    jl = JaxLikelihood(lik.mean_grid, lik.mean_probs, lik.variance)
    # DIC is a difference of float32 log-likelihood sums whose terms
    # cancel (lgamma(shape) against shape log(scale)): rel=5e-3
    assert select_btf.dic(Y, Mu, lik) == pytest.approx(
        jselect.dic(Y, Mu, jl), rel=5e-3)

    Yl, cells, drugs, concs = logistic.estimate_likelihood(
        read_csv_columns(tmp_path / "data.csv"))
    assert Yl.shape == Y.shape[:3] and np.nanmax(Yl) <= 1
    Mu_l, W, V, a, b = logistic.fit_logistic_factors(
        Yl, 2, concentrations=concs, rng=np.random.default_rng(0),
        max_steps=2, device="cpu")
    assert Mu_l.shape == Yl.shape and np.isfinite(Mu_l).all()
    assert np.nanmean((Mu_l - Yl) ** 2) < np.nanvar(Yl)
    from functionalmf_tpu.apps.doseresponse import logistic as jlogistic
    jMu, *_ = jlogistic.fit_logistic_factors(
        Yl, 2, concentrations=concs, rng=np.random.default_rng(0),
        max_steps=2)
    # the same optimiser from the same start, the gradient by autograd
    # here and by hand there: rounding differences grow over the L-BFGS
    # iterations of this non-convex fit, so the two fits are held to each
    # other loosely (atol=0.05 a cell, the fit error within 20%)
    np.testing.assert_allclose(Mu_l, jMu, atol=0.05)
    err, jerr = (np.nanmean((m_ - Yl) ** 2) for m_ in (Mu_l, jMu))
    assert abs(err - jerr) < 0.2 * jerr

    seed_dir = out.parent / "seed0"
    out.rename(seed_dir)
    np.save(seed_dir / "logistic_mf.npy", Mu_l)
    table = results.main(["0", "--data", str(tmp_path / "data.csv"),
                          "--outdir", str(out.parent), "--latex",
                          "--device", "cpu"])
    assert table.shape == (1, 3, 4) and np.isfinite(table).all()

    fits = feature_importance.feature_auc_screen(
        np.load(seed_dir / "btf_w.npy"), np.load(seed_dir / "btf_v.npy"),
        np.load(seed_dir / "btf_u.npy"),
        [f"Feature{i}" for i in range(6)], drugs, min_std=0.0, verbose=False)
    assert len(fits) == 6 * len(drugs)
    assert set(fits[0]) == {"feature", "drug",
                            *feature_importance.FIT_FIELDS}

    pytest.importorskip("matplotlib")
    plots.main(["--outdir", str(seed_dir), "--plotdir",
                str(tmp_path / "plots"), "--big_plot"])
    assert (tmp_path / "plots" / "embeddings.pdf").exists()
    assert (tmp_path / "plots" / "all.pdf").exists()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="with a card the default device is there")
@pytest.mark.parametrize("module", ["fit", "select_btf", "results",
                                    "logistic"])
def test_entry_points_default_to_the_card(module, tmp_path):
    """Every entry point that does torch work takes ``--device`` and
    defaults to the card: without one, and without ``--device cpu``, it
    raises before it reads anything."""
    import importlib
    mod = importlib.import_module(
        f"functionalmf_tpu_torch.apps.doseresponse.{module}")
    argv = ["--data", str(tmp_path / "absent.csv"), "--outdir", str(tmp_path)]
    if module == "results":
        argv = ["0"] + argv
    if module == "select_btf":
        argv = ["--data", str(tmp_path / "absent.csv")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    from functionalmf_tpu_torch.interop import gamma_grid_likelihood
    with pytest.raises(TypeError):       # the device is named, never implied
        gamma_grid_likelihood(*GRID)
