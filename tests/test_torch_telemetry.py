"""The run record of the port's ``run_gibbs``
(functionalmf_tpu_torch/utils/telemetry.py): the draws do not depend on
it, its spans account for a call's time, its counters count where the
program waits for the device, and its fused launches are those of
``launch_counts``. The file imports no jax, so that it also runs on the
card (``python -m pytest --noconftest tests/test_torch_telemetry.py``)."""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering as Constrained,
    GaussianBayesianTensorFiltering as Gaussian, POISSON)
from functionalmf_tpu_torch.models import constrained
from functionalmf_tpu_torch.ops import fused_ll
from functionalmf_tpu_torch.ops.mvn import cholesky_psd
from functionalmf_tpu_torch.utils import telemetry

N, M, T, K = 4, 3, 9, 2
PHASES = ("prior", "w_update", "v_update", "scale_moves", "hook")
RUN = dict(nburn=3, nthin=2, nsamples=3, verbose=False)
KEYS = ("W", "V", "sigma2", "lam2", "Tau2")


def _poisson_ll(Y, WV, W, V, row=None, col=None):
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    rate = torch.clamp(WV, min=1e-8)
    nan = torch.isnan(Y)
    return torch.where(nan, 0.0, torch.where(nan, 0.0, Y) * torch.log(rate)
                       - rate).sum()


def _model(family, device="cpu", nchains=2):
    """A small red-black recipe (cell function), the same model through
    the black-box path (seq schedule) or a Gaussian model, and its data."""
    rng = np.random.default_rng(2)
    if family == "gaussian":
        Y = rng.normal(1.0, 1.0, size=(N, M, T))
        Y[1, 2] = np.nan
        return Gaussian(N, M, T, device=device, nembeds=K, seed=5,
                        nchains=nchains), Y
    W = np.abs(rng.normal(1, 0.3, (N, K)))
    W[np.triu_indices(K, 1)] = 0
    V = np.abs(rng.normal(1, 0.3, (M, T, K)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
    Y[1, 2] = np.nan
    C = np.concatenate([np.eye(T), np.zeros((T, 1))], axis=1)
    W0 = np.abs(rng.normal(1, .2, (N, K)))
    W0[np.triu_indices(K, 1)] = 0
    V0 = np.abs(rng.normal(1, .2, (M, T, K)))
    kw = dict(nembeds=K, tf_order=1, sigma2_init=0.5, lam2_init=0.1,
              W_init=W0, V_init=V0, gass_ngrid=12, v_block_size=3, seed=4,
              nchains=nchains, device=device)
    if family == "recipe":
        return Constrained(N, M, T, _poisson_ll, C, v_schedule="redblack",
                           loglikelihood_cellfn=POISSON, **kw), Y
    return Constrained(N, M, T, _poisson_ll, C, v_schedule="seq", **kw), Y


@pytest.mark.parametrize("family", ["recipe", "gaussian"])
def test_draws_are_the_same_with_the_record_on_and_off(family):
    on, Y = _model(family)
    off, _ = _model(family)
    off.trace_runs = False
    a = on.run_gibbs(Y, **RUN)
    b = off.run_gibbs(Y, **RUN)
    for key in KEYS:
        np.testing.assert_array_equal(a[key], b[key])
    assert on.last_run["sweeps"] == 3 + 2 * 3
    assert on.last_run["nchains"] == 2


def test_record_off_leaves_recent_and_last_run_untouched():
    m, Y = _model("gaussian")
    m.trace_runs = False
    before = [id(r) for r in telemetry.recent()]
    m.run_gibbs(Y, **RUN)
    assert not hasattr(m, "last_run")
    assert [id(r) for r in telemetry.recent()] == before
    # every span and counter is the one shared null context
    with telemetry.record(m) as run:
        assert run is telemetry.NULL
        assert telemetry.phase("prior") is telemetry.NULL
        assert telemetry.span("blackbox_ll") is telemetry.NULL
        assert run.sweep() is telemetry.NULL
    assert not hasattr(m, "last_run")


@pytest.mark.parametrize("family", ["recipe", "blackbox", "gaussian"])
def test_the_spans_account_for_the_call(family):
    m, Y = _model(family)
    t0 = time.perf_counter()
    m.run_gibbs(Y, **RUN)
    call_ms = 1e3 * (time.perf_counter() - t0)
    rec = m.last_run
    assert rec is telemetry.recent()[-1]
    sm, host = rec["stream_ms"], rec["host_ms"]
    ran = {"recipe": PHASES, "blackbox": PHASES + ("blackbox_ll",),
           "gaussian": ("prior", "w_update", "v_update", "hook", "v_bands",
                        "banded_sample")}[family]
    assert set(sm) == {"sweep", *ran}
    assert sum(sm.get(p, 0.0) for p in PHASES) == pytest.approx(
        sm["sweep"], rel=0.05)
    assert host["head"] + sm["sweep"] + host["tail"] == pytest.approx(
        call_ms, rel=0.05)
    # the tail holds the last flush and the report; the lifted calls lie
    # inside the W and V updates
    assert host["flush"] + host["report"] <= host["tail"]
    if family == "blackbox":
        assert 0 < sm["blackbox_ll"] <= sm["w_update"] + sm["v_update"]
    if family == "gaussian":        # the conjugate V update's two spans
        assert 0 < sm["v_bands"] + sm["banded_sample"] <= sm["v_update"]
    # every sync site the sweeps passed, none outside them
    syncs = rec["counts"]["sweep"]
    per_sweep = {"recipe": {"sync:cholesky_psd": 3},
                 "blackbox": {"sync:cholesky_psd": 4,
                              "sync:block_starts": 3},
                 "gaussian": {"sync:cholesky_psd": 1}}[family]
    assert {k: v for k, v in syncs.items() if k.startswith("sync:")} == {
        k: 9 * v for k, v in per_sweep.items()}
    assert set(rec["counts"]) <= {"sweep", "launches"}
    # the draws of every collected sample, as float32
    draws = sum(np.asarray(v).nbytes for k, v in m.run_gibbs(
        Y, **RUN).items() if k in m._collect_keys)
    assert m.last_run["d2h_bytes"] == draws


def test_cholesky_psd_counts_one_sync_and_one_retry():
    owner = SimpleNamespace(device=torch.device("cpu"), nchains=1,
                            trace_runs=True)
    indefinite = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]])
    with telemetry.record(owner):
        cholesky_psd(indefinite, eps=1e-6, attempts=2)
    assert owner.last_run["counts"]["head"] == {
        "sync:cholesky_psd": 1, "cholesky_retries": 1}
    # a PSD precision: the check alone; without a ladder: no host read
    with telemetry.record(owner):
        cholesky_psd(torch.eye(2)[None], attempts=2)
        cholesky_psd(indefinite, attempts=0)
    assert owner.last_run["counts"]["head"] == {"sync:cholesky_psd": 1}


def test_fused_launches_are_the_deltas_of_launch_counts(monkeypatch):
    """On the CPU the kernels' plain versions run and count nothing; here
    each call counts as the card's launch would."""
    row0 = constrained.fused_row_ll_batched
    col0 = constrained.fused_col_block_ll_batched

    def row(*a, **kw):
        fused_ll.launch_counts["fused_row_ll"] += 1
        return row0(*a, **kw)

    def col(*a, **kw):
        fused_ll.launch_counts["fused_col_block_ll"] += 1
        return col0(*a, **kw)

    monkeypatch.setattr(constrained, "fused_row_ll_batched", row)
    monkeypatch.setattr(constrained, "fused_col_block_ll_batched", col)
    m, Y = _model("recipe")
    before = telemetry.launch_counts()
    m.run_gibbs(Y, **RUN)
    delta = {k: v - before[k] for k, v in telemetry.launch_counts().items()}
    assert m.last_run["counts"]["launches"] == delta
    assert delta["fused_row_ll"] == 9 and delta["fused_col_block_ll"] > 9
    assert delta["polya_gamma"] == delta["polya_gamma_g"] == 0


@pytest.mark.cuda
def test_sweep_sum_equals_a_traced_callbacks_intervals_on_the_card():
    """The record's stream-clock sweeps against the CUDA events of a
    traced callback at each sweep's end, from an event recorded before
    the call: the first interval also holds the head, which the host runs
    while the stream waits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    m, Y = _model("recipe", device="cuda")
    m.run_gibbs(Y, nburn=2, nthin=1, nsamples=2, verbose=False)
    marks = []

    def hook(state, pdata, gen, step):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return state, pdata

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    before = telemetry.launch_counts()
    m.run_gibbs(Y, nburn=39, nthin=1, nsamples=1, verbose=False,
                traced_callback=hook)
    torch.cuda.synchronize()
    marks = [start] + marks
    callback_ms = sum(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    rec = m.last_run
    assert rec["sweeps"] == 40
    assert rec["stream_ms"]["sweep"] == pytest.approx(
        callback_ms - rec["host_ms"]["head"], rel=0.01)
    delta = {k: v - before[k] for k, v in telemetry.launch_counts().items()}
    assert rec["counts"]["launches"] == delta
    assert delta["fused_row_ll"] == 40
