"""The seven readers of the program's run record against hand-made
records: each reads the latest record whose sweep count is the window's,
and reads None where no record matches or the program keeps none."""
import collections
import sys

import pytest

from portbench import harness, trace

NAMES = ("run_head_ms", "run_tail_ms", "w_update_stream_ms",
         "v_update_stream_ms", "scale_moves_stream_ms",
         "blackbox_ll_stream_ms", "program_syncs_per_sweep")


def _record(sweeps, head=1.0, tail=2.0, blackbox=True, syncs=4):
    stream = dict(sweep=250.0 * sweeps, prior=5.0 * sweeps,
                  w_update=20.0 * sweeps, v_update=130.0 * sweeps,
                  scale_moves=65.0 * sweeps, hook=30.0 * sweeps)
    if blackbox:
        stream["blackbox_ll"] = 160.0 * sweeps
    return dict(sweeps=sweeps, nchains=4,
                host_ms=dict(head=head, tail=tail, flush=0.5, report=1.0),
                stream_ms=stream,
                counts=dict(sweep={"sync:cholesky_psd": 3 * sweeps,
                                   "sync:block_starts": (syncs - 3) * sweeps,
                                   "cholesky_retries": 7},
                            head={"sync:cholesky_psd": 11},
                            launches={"fused_row_ll": sweeps}),
                d2h_bytes=1024)


@pytest.fixture
def records(monkeypatch):
    from functionalmf_tpu_torch.utils import telemetry
    kept = collections.deque(maxlen=telemetry.KEEP)
    monkeypatch.setattr(telemetry, "_recent", kept)
    return kept


def _read(nsweeps):
    t = trace.TraceData(window_s=50.0, nsweeps=nsweeps, flops_per_sweep=1.0,
                        spans={}, prof=None)
    return {name: mod.read(t)
            for name, mod in harness.metric_readers(NAMES).items()}


def test_readers_read_the_windows_record(records):
    # warm-up, the window, the spans' stretch, the profiler's stretch
    records.extend([_record(12, head=9.0), _record(190, head=2500.0,
                                                   tail=4000.0),
                    _record(6, head=7.0), _record(4, head=8.0)])
    got = _read(190)
    assert got == dict(run_head_ms=2500.0, run_tail_ms=4000.0,
                       w_update_stream_ms=20.0, v_update_stream_ms=130.0,
                       scale_moves_stream_ms=65.0,
                       blackbox_ll_stream_ms=160.0,
                       program_syncs_per_sweep=4.0)


def test_the_latest_matching_record_is_read(records):
    records.extend([_record(190, head=1.0, syncs=5),
                    _record(190, head=3.0, syncs=4)])
    got = _read(190)
    assert got["run_head_ms"] == 3.0
    assert got["program_syncs_per_sweep"] == 4.0


def test_a_sweep_count_no_record_has_reads_none(records):
    records.extend([_record(12), _record(6), _record(4)])
    assert _read(190) == dict.fromkeys(NAMES)
    assert _read(0) == dict.fromkeys(NAMES)


def test_a_span_that_never_ran_reads_none(records):
    records.append(_record(230, blackbox=False))
    got = _read(230)
    assert got["blackbox_ll_stream_ms"] is None
    assert got["v_update_stream_ms"] == 130.0


def test_a_program_without_the_record_reads_none(monkeypatch, records):
    """A checkout whose package has no telemetry module (as before the
    record): every reader returns None and none raises."""
    import functionalmf_tpu_torch.utils as utils
    records.append(_record(190))
    monkeypatch.delattr(utils, "telemetry")
    monkeypatch.setitem(sys.modules, "functionalmf_tpu_torch.utils.telemetry",
                        None)
    assert _read(190) == dict.fromkeys(NAMES)


def test_traced_tiny_run_reads_the_program_spans(run_tiny):
    """On the CPU the record's spans read the host clock: a traced run of
    a tiny black-box cell reports all seven, each with a value."""
    r = run_tiny("tiny-gamma", trace=1)
    assert r["correct"] is True
    for name in NAMES:
        assert r["metrics"][name]["value"] >= 0.0, name
    assert r["metrics"]["program_syncs_per_sweep"]["value"] > 0
