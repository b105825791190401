"""The port's run_gibbs options (functionalmf_tpu_torch/models/base.py)
against the JAX run_gibbs's contract (functionalmf_tpu/models/base.py:
675-855): the host ``callback`` with ``mark_data_dirty`` and the property
setters, the device-side ``traced_callback`` with a noise site of its own
and ``collect_data_keys``, ``checkpoint_path`` / ``resume`` (chunked ==
unchunked == resumed draws, bit for bit), ``profile_dir``, ``key`` and
the constructor's ``data_dtype`` (float16 storage; counts up to 2048 are
exact, so the float16 chain equals the float32 chain)."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from functionalmf_tpu import GaussianBayesianTensorFiltering as JaxGaussian
from functionalmf_tpu import ConstrainedNonconjugateBayesianTensorFiltering \
    as JaxModel
from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering as TorchModel,
    GaussianBayesianTensorFiltering, POISSON)

from tests.test_torch_constrained import (  # noqa: F401 (fixture)
    _problem, jax_loglik, torch_loglik, torch_one_thread)

N, M, T, K = 4, 3, 6, 2


def _gauss(nchains=1, cap=None, seed=7):
    m = GaussianBayesianTensorFiltering(N, M, T, device="cpu", nembeds=K,
                                        seed=seed, nchains=nchains)
    if cap is not None:
        m.max_sweeps_per_call = cap
    return m


def _gauss_data():
    Y = np.random.default_rng(0).normal(size=(N, M, T))
    Y[1, 2] = np.nan
    return Y


def bump_hook(state, pdata, gen, step):
    """Key-dependent multiplicative noise on a data entry the sweep reads:
    a run resumed without the carried data, or with another noise site,
    would diverge."""
    bump = 1.0 + 0.01 * torch.randn((), generator=gen)
    return state, dict(pdata, ysum=pdata["ysum"] * bump)


def test_both_hooks_raise_and_unknown_kwargs_raise():
    m, Y = _gauss(), _gauss_data()
    with pytest.raises(ValueError, match="not both"):
        m.run_gibbs(Y, nburn=1, nsamples=1, callback=lambda *a: None,
                    traced_callback=bump_hook)
    with pytest.raises(TypeError, match="unexpected run_gibbs kwargs"):
        m.run_gibbs(Y, nburn=1, nsamples=1, nonsense=3)
    with pytest.raises(ValueError, match="host callback"):
        m.run_gibbs(Y, nburn=1, nsamples=1, callback=lambda *a: None,
                    checkpoint_path="x")


def test_host_callback_sees_the_state_and_its_setters_reach_the_sweep():
    """callback(model, data, step, **kwargs) after every sweep; what it
    sets through the properties is what the next sweep starts from, and
    mark_data_dirty() makes run_gibbs prepare the data again."""
    m, Y = _gauss(), _gauss_data()
    seen, prepared = [], []
    real_prepare = m.prepare_data
    m.prepare_data = lambda d: prepared.append(1) or real_prepare(d)
    W_fixed = np.tril(np.full((N, K), 0.5))

    def cb(model, data, step, tag=None):
        assert tag == "x" and data is Y
        seen.append((step, model.W.copy(), float(model.lam2)))
        model.lam2 = 0.25
        if step == 1:
            data[0, 0, 0] = 5.0
            model.mark_data_dirty()
        if step == 2:
            model.W = W_fixed

    m.sample_lam2 = False          # lam2 stays where the callback put it
    res = m.run_gibbs(Y, nburn=2, nthin=1, nsamples=2, verbose=False,
                      callback=cb, tag="x")
    assert [s[0] for s in seen] == [0, 1, 2, 3]
    assert len(prepared) == 2                  # at the start, after step 1
    assert seen[1][2] == 0.25 and (res["lam2"] == 0.25).all()
    # the draw collected after sweep 3 (step index 2) is the callback's W
    np.testing.assert_array_equal(res["W"][0], W_fixed.astype(np.float32))
    assert not np.array_equal(res["W"][1], res["W"][0])
    assert res["W"].shape == (2, N, K)


def test_traced_callback_contract_and_results_match_jax():
    """The hook gets the chain-batched state dict, the prepared data, a
    generator and the absolute sweep; collect_data_keys come back without
    a chain axis, under the JAX package's keys and shapes."""
    Y = _gauss_data()
    calls = []

    def hook(state, pdata, gen, step):
        assert isinstance(gen, torch.Generator)
        assert state["W"].shape == (2, N, K) and "ysum" in pdata
        calls.append(step)
        return bump_hook(state, pdata, gen, step)

    got = _gauss(nchains=2).run_gibbs(
        Y, nburn=2, nthin=2, nsamples=3, verbose=False, traced_callback=hook,
        collect_data_keys=("ysum", "counts"))
    assert calls == list(range(8))

    def jhook(state, pdata, key, step):
        bump = 1.0 + 0.01 * jax.random.normal(key, ())
        return state, dict(pdata, ysum=pdata["ysum"] * bump)

    jm = JaxGaussian(N, M, T, nembeds=K, seed=7, nchains=2)
    want = jm.run_gibbs(Y, nburn=2, nthin=2, nsamples=3, verbose=False,
                        traced_callback=jhook,
                        collect_data_keys=("ysum", "counts"))
    assert set(got) == set(want)
    for key in ("W", "V", "nu2", "ysum", "counts"):
        assert got[key].shape == np.shape(want[key]), key
    assert got["ysum"].shape == (3, N, M, T)
    assert not np.array_equal(got["ysum"][0], got["ysum"][-1])
    np.testing.assert_array_equal(got["counts"][0], got["counts"][-1])


@pytest.mark.parametrize("hook", [None, bump_hook], ids=["plain", "hooked"])
def test_chunked_unchunked_and_resumed_runs_are_identical(tmp_path, hook):
    """One request three ways: uncut, cut into chunks of 3 sweeps, and
    stopped after 4 of 12 draws then resumed from the checkpoint. The
    draws (and the collected data entry the hook rewrites) are equal bit
    for bit: a sweep's generator and the hook's are functions of (seed,
    sweep), and the checkpoint carries the state and the hooked data."""
    Y = _gauss_data()
    kw = dict(nburn=5, nthin=2, verbose=False)
    if hook is not None:
        kw.update(traced_callback=hook, collect_data_keys=("ysum",))
    full = _gauss(nchains=2).run_gibbs(Y, nsamples=12, **kw)
    chunked = _gauss(nchains=2, cap=3).run_gibbs(Y, nsamples=12, **kw)
    ck = str(tmp_path / "chain.npz")
    _gauss(nchains=2, cap=4).run_gibbs(Y, nsamples=4, checkpoint_path=ck,
                                       **kw)
    assert os.path.exists(ck) and os.path.exists(ck + ".chunk0.npz")
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    resumed_model = _gauss(nchains=2, cap=7)
    resumed = resumed_model.run_gibbs(Y, nsamples=12, checkpoint_path=ck,
                                      resume=True, **kw)
    keys = ("W", "V", "nu2", "sigma2", "lam2", "Tau2") + (
        ("ysum",) if hook else ())
    for key in keys:
        np.testing.assert_array_equal(chunked[key], full[key])
        np.testing.assert_array_equal(resumed[key], full[key])
    assert full["W"].shape == (24, N, K)
    # a resume from the complete checkpoint runs no sweep
    again = _gauss(nchains=2).run_gibbs(Y, nsamples=12, checkpoint_path=ck,
                                        resume=True, **kw)
    np.testing.assert_array_equal(again["V"], full["V"])
    np.testing.assert_array_equal(resumed_model.V, full["V"][[11, 23]])


def test_checkpoint_chunks_are_written_once(tmp_path):
    Y = _gauss_data()
    ck = str(tmp_path / "c.npz")
    _gauss(cap=2).run_gibbs(Y, nburn=2, nsamples=2, verbose=False,
                            checkpoint_path=ck)
    first = os.stat(ck + ".chunk0.npz").st_mtime_ns
    with np.load(ck) as z:
        assert int(z["__offset"]) == 4 and int(z["__collected"]) == 2
        assert {"state__W", "state__nu2"} <= set(z.files)
        assert "__npdata_leaves" not in z.files        # no hook, no data
    _gauss(cap=2).run_gibbs(Y, nburn=2, nsamples=6, verbose=False,
                            checkpoint_path=ck, resume=True)
    assert os.stat(ck + ".chunk0.npz").st_mtime_ns == first
    assert os.path.exists(ck + ".chunk2.npz")
    # a resumed run whose data has another structure is refused
    _gauss().run_gibbs(Y, nburn=1, nsamples=1, verbose=False,
                       checkpoint_path=ck, traced_callback=bump_hook)
    broken = _gauss()
    broken.prepare_data = lambda d: {"ysum": torch.zeros(N, M, T)}
    with pytest.raises(ValueError, match="same structure"):
        broken.run_gibbs(Y, nburn=1, nsamples=2, verbose=False,
                         checkpoint_path=ck, resume=True,
                         traced_callback=bump_hook)


def _poisson_pair(**kw):
    Y, C, W0, V0, _ = _problem(3, N, M, 8, K)
    common = dict(nembeds=K, tf_order=0, sigma2_init=0.5, lam2_init=0.1,
                  W_init=W0, V_init=V0, gass_ngrid=24, v_block_size=4, seed=5,
                  **kw)
    return Y, C, common


def test_resume_carries_row_constraints_a_hook_rewrites(tmp_path):
    """The constrained model with Row_constraints that a device-side hook
    loosens a little every sweep: state["Row_constraints"] is in the
    checkpoint like every other entry, and ``collect_data_keys`` names it
    (a state entry, so it comes back like the model's variables)."""
    Y, C, common = _poisson_pair(
        Row_constraints=np.concatenate([np.eye(K), np.zeros((K, 1))], 1))

    def hook(state, pdata, gen, step):
        RC = state["Row_constraints"].clone()
        RC[:, :, K] = RC[:, :, K] - 0.01 * torch.rand((), generator=gen)
        return dict(state, Row_constraints=RC), pdata

    def make():
        return TorchModel(N, M, 8, torch_loglik, C, device="cpu",
                          loglikelihood_cellfn=POISSON, **common)
    kw = dict(nburn=3, nthin=1, verbose=False, traced_callback=hook,
              collect_data_keys=("Row_constraints",))
    full_model = make()
    full = full_model.run_gibbs(Y, nsamples=6, **kw)
    ck = str(tmp_path / "rc.npz")
    make().run_gibbs(Y, nsamples=2, checkpoint_path=ck, **kw)
    resumed_model = make()
    resumed = resumed_model.run_gibbs(Y, nsamples=6, checkpoint_path=ck,
                                      resume=True, **kw)
    for key in ("W", "V", "sigma2", "lam2", "Row_constraints"):
        np.testing.assert_array_equal(resumed[key], full[key])
    assert full["Row_constraints"].shape == (6, K, K + 1)
    assert (np.diff(full["Row_constraints"][:, :, K], axis=0) < 0).all()
    np.testing.assert_array_equal(full["Row_constraints"][-1],
                                  full_model.Row_constraints)
    np.testing.assert_array_equal(resumed_model.Row_constraints,
                                  full_model.Row_constraints)
    assert (full_model.Row_constraints[:, K] < 0).all()


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    """tests/test_driver.py:test_profile_dir_captures_trace for the port:
    the head and the first sweeps (a bounded number) run under
    torch.profiler and the trace lands in the directory, with the run
    record's spans labelled fmf:<span>; where no sweep follows the first
    chunk, the tail (flush and report) is in it too."""
    import json
    from functionalmf_tpu_torch.models import base as tbase
    m, Y = _gauss(), _gauss_data()
    monkeypatch.setattr(tbase, "_PROFILE_MAX_SWEEPS", 2)
    pdir = str(tmp_path / "prof")
    plain = _gauss().run_gibbs(Y, nburn=4, nthin=1, nsamples=2,
                               verbose=False)
    res = m.run_gibbs(Y, nburn=4, nthin=1, nsamples=2, verbose=False,
                      profile_dir=pdir)
    assert os.path.getsize(os.path.join(pdir, "trace.json")) > 0
    np.testing.assert_array_equal(res["V"], plain["V"])

    def labels(d):
        with open(os.path.join(d, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        return {e["name"][4:] for e in events
                if str(e.get("name", "")).startswith("fmf:")}

    spans = {"head", "sweep", "prior", "w_update", "v_update", "hook",
             "flush"}
    assert labels(pdir) == spans
    whole = str(tmp_path / "whole")
    _gauss().run_gibbs(Y, nburn=1, nthin=1, nsamples=1, verbose=False,
                       profile_dir=whole)
    assert labels(whole) == spans | {"tail", "report"}


def test_key_replaces_the_seed_of_the_run():
    Y = _gauss_data()
    a = _gauss().run_gibbs(Y, nburn=2, nsamples=2, verbose=False, key=11)
    b = _gauss().run_gibbs(Y, nburn=2, nsamples=2, verbose=False, key=11)
    c = _gauss().run_gibbs(Y, nburn=2, nsamples=2, verbose=False, key=12)
    d = _gauss().run_gibbs(Y, nburn=2, nsamples=2, verbose=False)
    np.testing.assert_array_equal(a["V"], b["V"])
    for other in (c, d):
        assert not np.array_equal(a["V"], other["V"])
    # the model's own seed is key's default
    f = _gauss().run_gibbs(Y, nburn=2, nsamples=2, verbose=False, key=7)
    np.testing.assert_array_equal(d["V"], f["V"])


@pytest.mark.parametrize("path", ["cellfn", "blackbox"])
def test_data_dtype_float16_stores_half_and_matches_float32(path):
    """tests/test_driver.py:test_data_dtype_f16 for the port: the prepared
    data is stored in float16, as in the JAX package; counts <= 2048 are
    exact in float16 and arithmetic is float32, so the chain equals the
    float32 chain (atol=1e-6), finite and feasible. With a cellfn one
    float32 copy is made of the prepared tensor, once."""
    Y, C, common = _poisson_pair()
    extra = dict(loglikelihood_cellfn=POISSON) if path == "cellfn" else {}
    want = TorchModel(N, M, 8, torch_loglik, C, device="cpu", **common,
                      **extra).run_gibbs(Y, nburn=10, nsamples=10,
                                         verbose=False)
    tm = TorchModel(N, M, 8, torch_loglik, C, device="cpu",
                    data_dtype=torch.float16, **common, **extra)
    pd = tm.prepare_data(Y)
    assert pd.dtype == torch.float16
    jm = JaxModel(N, M, 8, jax_loglik, C, data_dtype=jnp.float16, **common)
    assert jm.prepare_data(Y).dtype == jnp.float16
    np.testing.assert_array_equal(
        np.asarray(jm.prepare_data(Y), np.float32), pd.float().numpy())
    got = tm.run_gibbs(Y, nburn=10, nsamples=10, verbose=False)
    for key in ("W", "V", "sigma2"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6)
    mu = np.einsum("znk,zmtk->znmt", got["W"], got["V"])
    assert np.isfinite(mu).all() and mu.min() >= -1e-5
    if path == "cellfn":
        copy = tm._f32(pd)
        assert copy.dtype == torch.float32 and tm._f32(pd) is copy
    with pytest.raises(ValueError, match="data_dtype"):
        TorchModel(N, M, 8, torch_loglik, C, device="cpu",
                   data_dtype=torch.int32, **common)
    assert _gauss().data_dtype is None
