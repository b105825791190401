"""The traced run's second and third stretches, after the window (the
first stretch, whose sweep time ``sweep_mfu`` reads):

2. a few sweeps with synchronised spans, wrapped from outside around the
   model's phase methods (and, through the recorder, around the lifted
   likelihood calls): ms a sweep a phase;
3. last, because the profiler slows every later launch, a
   ``torch.profiler`` window of a few sweeps: the device's busy time,
   kernels by name, launches, host syncs, each fused kernel launch's
   arguments (for the roofline), and the breakdown.

The profiled window runs from the end of the call's first sweep to the end
of its last (marks the benchmark's callback leaves in the trace), so the
call's data preparation stays outside it.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

SPAN_SWEEPS = 6
PROF_SWEEPS = 4
MARK = "portbench.sweep_end"
PHASE = "portbench:"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
INNER_MAX_US = 20_000
KERNEL_NAMES = {"fused_row_ll": "row_ll_kernel",
                "fused_col_block_ll": "col_block_ll_kernel"}


class TraceData:
    """What the per-layer readers read.

    * ``window_s``, ``nsweeps``: the measured window (stretch 1);
    * ``flops_per_sweep``: the cell's grid work a sweep (frozen work model);
    * ``spans``: {label: ms a sweep} (stretch 2);
    * ``prof``: None without device events, else dict(sweeps, window_s,
      busy_s, kernel_launches, syncs, kernels {name: (count, seconds)},
      bounds {kernel: [bound µs of each launch]}, breakdown)."""

    def __init__(self, window_s, nsweeps, flops_per_sweep, spans, prof):
        self.window_s, self.nsweeps = window_s, nsweeps
        self.flops_per_sweep = flops_per_sweep
        self.spans, self.prof = spans, prof


@contextlib.contextmanager
def _wrapped(targets, make):
    """Wrap each (owner, attribute) of ``targets`` by make(fn, label)."""
    undo = []
    try:
        for owner, attr, label in targets:
            fn = getattr(owner, attr)
            setattr(owner, attr, make(fn, label))
            undo.append((owner, attr, fn))
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)


def _synced(rec):
    def make(fn, label):
        def wrapper(*a, **kw):
            with rec.span(label):
                return fn(*a, **kw)
        return wrapper
    return make


def _labelled(fn, label):
    def wrapper(*a, **kw):
        with torch.profiler.record_function(PHASE + label):
            return fn(*a, **kw)
    return wrapper


def traced_stretches(cell, rec, model, data, seed, dev, window_s, nsweeps,
                     log):
    from portbench.harness import _key, _sync
    run = dict(traced_callback=rec.hook, verbose=False)
    # stretch 2: synchronised spans
    rec.spans = {}
    with _wrapped(cell.phases(), _synced(rec)):
        model.run_gibbs(data, nburn=SPAN_SWEEPS - 1, nthin=1, nsamples=1,
                        key=_key(seed, 4), **run)
    spans = {k: 1e3 * v / SPAN_SWEEPS for k, v in rec.spans.items()}
    rec.spans = None
    log("spans (ms a sweep, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))

    # stretch 3: the profiler
    prof = None
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        rec.launches = []
        hook = rec.hook

        def marked(*a):
            with torch.profiler.record_function(MARK):
                return hook(*a)

        with _wrapped(cell.phases(), _labelled), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as p:
            model.run_gibbs(data, nburn=PROF_SWEEPS - 1, nthin=1, nsamples=1,
                            key=_key(seed, 5), traced_callback=marked,
                            verbose=False)
            _sync(dev)
        t0 = time.perf_counter()
        prof = read_profile(p.events(), cell, rec.launches)
        rec.launches = None
        log(f"profile read in {time.perf_counter() - t0:.1f}s: "
            f"{prof['sweeps']} sweeps, busy {prof['busy_s']:.4f} of "
            f"{prof['window_s']:.4f}s, {prof['kernel_launches']} launches")
    return TraceData(window_s, nsweeps, cell.flops_per_sweep, spans, prof)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_profile(events, cell, launches):
    """The profiled window's numbers from torch.profiler's events (µs)."""
    from torch.autograd import DeviceType
    marks = sorted(e.time_range.start for e in events if e.name == MARK)
    if len(marks) < 2:
        return None
    lo, hi = marks[0], marks[-1]
    sweeps = len(marks) - 1
    dev_ev, cpu_ev = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the benchmark's own labels show on the device's timeline
            # too, as spans over their kernels: not device work
            if e.name.startswith((PHASE, MARK)):
                continue
            if t > lo and s < hi:
                dev_ev.append((max(s, lo), min(t, hi), e.name))
        elif lo <= s < hi:
            cpu_ev.append((s, t, e.name))
    busy = _union([(s, t) for s, t, _ in dev_ev])
    busy_us = sum(t - s for s, t in busy)
    kernels = defaultdict(lambda: [0, 0.0])
    nkern = 0
    for s, t, name in dev_ev:
        k = kernels[name]
        k[0] += 1
        k[1] += (t - s) / 1e6
        if not name.lower().startswith(("memcpy", "memset")):
            nkern += 1
    syncs = sum(1 for _, _, n in cpu_ev if n in SYNC_CALLS)
    # each fused launch's bound, from its arguments, after the window; the
    # launches of the first sweep (before the first mark) are left out
    bounds = defaultdict(list)
    for sweep, kernel, work in launches or ():
        if 1 <= sweep <= sweeps:
            bounds[kernel].append(cell.launch_bound_us(kernel, work))
    return dict(sweeps=sweeps, window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
                kernel_launches=nkern, syncs=syncs,
                kernels={n: tuple(v) for n, v in kernels.items()},
                bounds=dict(bounds),
                breakdown=dict(device_ops=_top_ops(kernels),
                               idle_gaps=_idle_by_host(busy, lo, hi, cpu_ev)))


def _top_ops(kernels, n=10):
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:n]
    return [[name[:160], secs] for name, (_, secs) in top]


def _idle_by_host(busy, lo, hi, cpu_ev, n=10):
    """Idle seconds of the device, summed by what the host was doing at
    each gap's middle: the benchmark's phase label and the innermost host
    operation under way."""
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    phases = [(s, t, name[len(PHASE):]) for s, t, name in cpu_ev
              if name.startswith(PHASE)]
    # innermost host operations; the long waits that hold many of them
    # are never the innermost
    ops = sorted((s, t, name) for s, t, name in cpu_ev
                 if not name.startswith(PHASE) and name != MARK
                 and t - s <= INNER_MAX_US)
    starts = [s for s, _, _ in ops]
    longest = max((t - s for s, t, _ in ops), default=0.0)
    idle = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        phase = min((t - s0, name) for s0, t, name in phases
                    if s0 <= mid <= t)[1] if any(
            s0 <= mid <= t for s0, t, _ in phases) else "outside phases"
        j0 = bisect.bisect_left(starts, mid - longest)
        j1 = bisect.bisect_right(starts, mid)
        inner = [(t - s0, name) for s0, t, name in ops[j0:j1] if t >= mid]
        op = min(inner)[1] if inner else "python"
        idle[f"{phase}: {op}"] += (e - s) / 1e6
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:n]
    return [[name, secs] for name, secs in top]
