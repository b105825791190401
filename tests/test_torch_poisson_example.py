"""The port's Poisson example (functionalmf_tpu_torch/examples/
poisson_tensor_filtering.py) against the JAX package's
(examples/poisson_tensor_filtering.py, loaded from its path; its
``__main__`` guard keeps it from running): the truth generator, the
constraint matrices, the likelihood and the metrics on the same inputs,
then a whole run at tiny counts on the CPU and the ``agg`` mode."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from functionalmf_tpu_torch.examples import poisson_tensor_filtering as tex

from tests.test_torch_constrained import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jex():
    path = os.path.join(REPO, "examples", "poisson_tensor_filtering.py")
    spec = importlib.util.spec_from_file_location("jax_poisson_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed, break_prob", [(1, 0.2), (2, 0.2), (7, 0.6)])
def test_piecewise_constant_truth_is_the_jax_examples(jex, seed, break_prob):
    got = tex.create_piecewise_constant(np.random.default_rng(seed),
                                        break_prob)
    want = jex.create_piecewise_constant(np.random.default_rng(seed),
                                         break_prob)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("monotone", [False, True])
def test_constraints_match_the_jax_examples(jex, monotone):
    tm = tex.init_model(3, monotone=monotone, seed=1, device="cpu")
    jm = jex.init_model(3, monotone=monotone, seed=1)
    np.testing.assert_array_equal(tm.Constraints_A.numpy(),
                                  np.asarray(jm.Constraints_A))
    np.testing.assert_array_equal(tm.Constraints_C.numpy(),
                                  np.asarray(jm.Constraints_C))
    assert tm.Constraints_A.shape[0] == tex.ndepth + monotone * (tex.ndepth
                                                                 - 1)
    assert (tm.v_schedule, tm.v_block_size, tm.tf_order) == ("seq", 8, 0)


def test_rowcol_loglikelihood_matches_the_jax_examples(jex):
    rng = np.random.default_rng(3)
    Y = rng.poisson(2.0, (11, 12, 20)).astype(np.float32)
    Y[:3, :3] = np.nan
    tau_row = rng.gamma(2.0, 1.0, (12, 20)).astype(np.float32)
    tau_col = rng.gamma(2.0, 1.0, (11, 20)).astype(np.float32)
    for kw, tau in (({"row": 1}, tau_row), ({"col": 2}, tau_col),
                    ({"row": 5}, tau_row)):
        want = float(jex.rowcol_loglikelihood(jnp.asarray(Y),
                                              jnp.asarray(tau), None, None,
                                              **kw))
        got = float(tex.rowcol_loglikelihood(
            torch.as_tensor(Y), torch.as_tensor(tau), None, None,
            **{k: torch.tensor(v) for k, v in kw.items()}))
        assert got == pytest.approx(want, rel=1e-5)


def test_metrics_match_the_jax_examples(jex):
    rng = np.random.default_rng(4)
    Y = rng.poisson(3.0, (11, 12, 20, 1)).astype(float)
    Mu = rng.gamma(3.0, 1.0, (11, 12, 20))
    samples = Mu[None] * rng.gamma(20.0, 0.05, (40, 11, 12, 20))
    pred = samples.mean(0)
    assert [m["name"] for m in tex.METRICS] == [m["name"]
                                                for m in jex.METRICS]
    for tm, jm in zip(tex.METRICS, jex.METRICS):
        got = tm["fun"](Y, Mu, pred, samples)
        want = jm["fun"](Y, Mu, pred, samples)
        assert got == pytest.approx(want, rel=1e-12), tm["name"]


def test_setup_sampler_assigns_the_warm_start_and_draws_the_scales():
    model = tex.init_model(2, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    Y = rng.poisson(2.0, (11, 12, 20, 1)).astype(float)
    before = {k: model.state[k].clone() for k in ("lam2", "Tau2", "sigma2")}
    tex.setup_sampler(model, Y, rng=np.random.default_rng(6))
    from functionalmf_tpu_torch.utils.nmf import tensor_nmf
    W0, V0 = tensor_nmf(Y, 2, rng=np.random.default_rng(6))
    np.testing.assert_allclose(model.W, W0, rtol=1e-6)
    np.testing.assert_allclose(model.V, V0, rtol=1e-6)
    for k, v in before.items():
        now = model.state[k]
        assert now.shape == v.shape and torch.isfinite(now).all()
        assert not torch.equal(now, v), k
    # the other two entry points, each from the next init generator
    W = model.state["W"].clone()
    model._init_W()
    model._init_V()
    assert not torch.equal(model.state["W"], W)
    assert model.state["V"].shape == (1, 12, 20, 2)


def test_example_runs_on_cpu_and_agg_reads_it(tmp_path, monkeypatch):
    """The whole comparison at tiny counts: a finite (9, 6) table, every
    Poisson-BTF draw positive, the saved table read back by ``agg``."""
    monkeypatch.chdir(tmp_path)
    out = tex.main(["2", "1", "--device", "cpu"], nburn=6, nthin=1,
                   nsamples=6)
    assert out["names"] == tex.MODEL_NAMES
    assert out["table"].shape == (9, 6) and np.isfinite(out["table"]).all()
    assert set(out["seconds"]) == set(tex.MODEL_NAMES)
    res = out["results"]
    mu = np.einsum("snk,smtk->snmt", res["W"], res["V"])
    assert mu.shape == (6, 11, 12, 20) and mu.min() >= -1e-5
    saved = tmp_path / "data" / "poisson_tensor_filtering" / \
        "seed1-nembeds2" / "results.npy"
    np.testing.assert_array_equal(np.load(saved), out["table"])
    agg = tex.agg_results(tex.MODEL_NAMES, tex.METRICS, nembeds_options=(2,),
                          seeds=(1,))
    np.testing.assert_array_equal(agg[2], out["table"])


def test_example_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tex.init_model(3)


# twice the largest spread of each metric over three JAX seeds (42, 43,
# 44) of the PGDS arm below
PGDS_ARM_TOL = {"NLL (held out)": 2 * 3.2832, "MAE (true rate)": 2 * 0.0209,
                "RMSE (true rate)": 2 * 0.0163, "50% Coverage": 2 * 0.606,
                "90% Coverage": 2 * 2.4243}


def test_pgds_arm_on_the_examples_data_agrees_with_jax(jex):
    """The example's PGDS arm (tau=1) on its seed-1 data, 300 + 200
    sweeps: the port's metrics against the JAX package's, seed 42 each."""
    from functionalmf_tpu.pgds import fit_pgds as jax_fit_pgds
    from functionalmf_tpu_torch.pgds import fit_pgds
    rng = np.random.default_rng(1)
    W, V = tex.create_piecewise_constant(rng)
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(Mu[..., None], size=Mu.shape + (1,)).astype(float)
    Ym = Y.copy()
    Ym[:3, :3] = np.nan
    kw = dict(nburn=300, nthin=1, nsamples=200, tau=1, seed=42)
    got = fit_pgds(Ym.sum(-1), 3, device="cpu", **kw)[0]
    want = jax_fit_pgds(Ym.sum(-1), 3, **kw)[0]
    for tm, jm in zip(tex.METRICS, jex.METRICS):
        if tm["name"] in PGDS_ARM_TOL:
            g = tm["fun"](Y, Mu, got.mean(0), got)
            w = jm["fun"](Y, Mu, want.mean(0), want)
            assert abs(g - w) < PGDS_ARM_TOL[tm["name"]], (tm["name"], g, w)
