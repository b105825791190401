"""The metric arithmetic against hand counts."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.work import model as work


def test_rate_and_tail_over_every_sweep():
    rec = harness.Recorder(1, "cpu")
    rec.start_marks(100)
    rec.marks = [0.0] + list(np.cumsum(np.arange(1, 101) / 1000.0))
    secs = rec.sweep_seconds()
    assert len(secs) == 100 and secs[0] == pytest.approx(0.001)
    # statistics' exclusive 90th percentile of 1..100 ms: 90.9 ms
    assert 1e3 * harness.quantile(secs, 90) == pytest.approx(90.9)
    # the rate is chains x every sweep over the whole window
    assert harness.window_rate(256, 100, 5.05) == pytest.approx(256 * 100
                                                                / 5.05)


def test_window_sweeps_are_fixed_by_the_traffic():
    assert harness.window_sweeps(30.0, 4.3, 10) == 130
    assert harness.window_sweeps(30.0, 4.5, 1) == 135
    assert harness.window_sweeps(1.0, 4.5, 10) == 10


def test_row_launch_work_hand_count():
    y = np.array([[1.0, np.nan, 2.0, 0.0], [3.0, 1.0, 1.0, 4.0]])
    w = work.row_launch_work(G=3, k=2, row_idx=[0, 1], row_chain=[0, 0], y=y)
    # 7 present cells, 3 candidates: 2k + 4 operations and one log a pair
    assert w["flops"] == 3 * 7 * (4 + 4) and w["sfu"] == 21
    # cands 2x3x2 and out 2x3, bt of one chain 4x2, two index arrays of 2,
    # the two rows of y
    assert w["bytes"] == 4 * (12 + 6) + 4 * 8 + 4 * 4 + 4 * 8
    assert w["bound_us"] == pytest.approx(
        max(w["bytes"] / 3.35e12, w["flops"] / 67e12,
            21 / (132 * 16 * 1.98e9)) * 1e6)


def test_col_launch_work_hand_count():
    y = np.ones((2, 3, 5))
    y[0, 1, 4] = np.nan
    w = work.col_launch_work(G=2, Tb=2, k=3, pair_chain=[0, 1],
                             pair_col=[1, 2], pair_t0=[3, 4], y=y)
    # pair 0: t 3, 4 of column 1 (one NaN): 3 cells; pair 1: t 4 of
    # column 2 (t 5 is outside): 2 cells
    assert w["flops"] == 2 * 5 * (6 + 4) and w["sfu"] == 10
    assert w["bytes"] == (4 * (2 * 2 * 2 * 3 + 2 * 2) + 4 * 2 * 2 * 3
                          + 4 * 3 * 2 + 4 * 6)


def test_gamma_cell_and_sweep_counts():
    assert work.gamma_mixture_cell_flops(5, 6, 20, ep=True) == \
        10 + 60 + 960 + 100 + 2 + 6 + 1
    assert work.poisson_cell_flops(5) == 14
    assert work.gass_sweep_flops(4, 100, 1000) == 2 * 4 * 101 * 1000


def _td(**prof):
    return trace.TraceData(window_s=2.0, nsweeps=4,
                           flops_per_sweep=6.7e10, spans={"v_update": 3.0},
                           prof=prof or None)


def test_roofline_and_mfu_readers():
    readers = harness.metric_readers(["fused_row_ll_roofline",
                                      "fused_col_block_ll_roofline",
                                      "sweep_mfu", "v_update_ms"])
    prof = dict(kernels={
        "void (anonymous namespace)::row_ll_kernel<P, 5>(RowArgs)": (2, 2e-5),
        "void (anonymous namespace)::col_block_ll_kernel<P, 5>(Col)": (3, 6e-5)},
        bounds={"fused_row_ll": [5.0, 5.0], "fused_col_block_ll": [4.0, 4.0]})
    t = _td(**prof)
    assert readers["fused_row_ll_roofline"].read(t) == pytest.approx(50.0)
    # two launches' bounds recorded, three kept by the profiler: scaled
    assert readers["fused_col_block_ll_roofline"].read(t) == pytest.approx(
        100 * 12e-6 / 6e-5)
    # 6.7e10 FLOPs a sweep in 0.5 s a sweep at 67 TFLOP/s
    assert readers["sweep_mfu"].read(t) == pytest.approx(0.2)
    assert readers["v_update_ms"].read(t) == 3.0
    assert readers["fused_row_ll_roofline"].read(_td()) is None


class _Ev(SimpleNamespace):
    pass


def _ev(name, s, e, cuda):
    from torch.autograd import DeviceType
    return _Ev(name=name, time_range=SimpleNamespace(start=s, end=e),
               device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_read_profile_window_idle_syncs():
    cell = SimpleNamespace(launch_bound_us=lambda kernel, a: 1.0)
    ev = [_ev(trace.MARK, 100, 101, False), _ev(trace.MARK, 300, 301, False),
          _ev(trace.MARK, 500, 501, False),
          _ev("portbench:v_update", 100, 400, False),
          _ev("portbench:v_update", 100, 400, True),    # a label, not work
          _ev("k1", 150, 250, True), _ev("k2", 200, 300, True),
          _ev("Memcpy DtoH", 320, 340, True), _ev("k3", 450, 600, True),
          _ev("cudaStreamSynchronize", 305, 345, False),
          _ev("aten::mul", 260, 280, False),
          _ev("k0", 10, 50, True)]                      # before the window
    launches = [(0, "fused_row_ll", {}), (1, "fused_row_ll", {}),
                (2, "fused_row_ll", {})]
    p = trace.read_profile(ev, cell, launches)
    assert p["sweeps"] == 2 and p["window_s"] == pytest.approx(400e-6)
    # busy: 150-300, 320-340, 450-500 (clipped at the last mark)
    assert p["busy_s"] == pytest.approx(220e-6)
    assert p["kernel_launches"] == 3 and p["syncs"] == 1
    assert p["bounds"] == {"fused_row_ll": [1.0, 1.0]}
    readers = harness.metric_readers(["device_idle_share",
                                      "launches_per_sweep",
                                      "host_syncs_per_sweep"])
    t = _td(**p)
    assert readers["device_idle_share"].read(t) == pytest.approx(45.0)
    assert readers["launches_per_sweep"].read(t) == 1.5
    assert readers["host_syncs_per_sweep"].read(t) == 0.5
    gaps = dict(p["breakdown"]["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(180e-6)
    assert gaps["v_update: python"] == pytest.approx(160e-6)
    assert gaps["v_update: cudaStreamSynchronize"] == pytest.approx(20e-6)
