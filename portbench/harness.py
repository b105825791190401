"""The run of one cell: set-up, warm-up, the measured window, the traced
stretches, the check against the reference, the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name in files of its own:

* ``workloads/<cell>.json``: {config, traffic, chips, why};
* ``configs/<config>.json``: the configuration, whose ``family`` names the
  module ``families/<family>.py`` that builds its model, captures its
  answers and checks them against ``reference/``;
* ``traffic/<traffic>.json``: the run's parameters (chains, thinning,
  schedule, EP), read by the family;
* ``metrics/<metric>.py``: a reader ``read(t)`` of the traced run (a
  :class:`portbench.trace.TraceData`) that returns the number or None.

The window is one ``run_gibbs`` call of the model built in set-up, the
way a user makes it: its sweep count comes from the warm-up's rate, its
draws go to the host at the cell's ``nthin``, and it ends when the call
returns, after a synchronise. A ``traced_callback`` of the benchmark's own
records a CUDA event at each sweep's end and returns its inputs unchanged.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from portbench import capture

HERE = Path(__file__).resolve().parent
WARM_SWEEPS = 12          # the warm-up call: every shape, a captured sweep
CAPTURE_SWEEPS = 3        # sweeps of the window whose steps are kept
CAPTURE_ITEMS = 256       # items drawn anew for each of their GASS steps
CHECK_CHAINS = 2          # chains followed through each captured sweep
FOREIGN = ("jax", "jaxlib", "flax", "functionalmf_tpu")


class NoDevice(RuntimeError):
    pass


# ----------------------------------------------------------------------
# finding things by name
# ----------------------------------------------------------------------
def _json(kind, name, root=HERE):
    path = root / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    return json.loads(path.read_text())


def load_workload(name, root=HERE):
    """The cell with its configuration and traffic dicts."""
    wl = _json("workloads", name, root)
    return dict(wl, name=name, config_data=_json("configs", wl["config"], root),
                traffic_data=_json("traffic", wl["traffic"], root))


def family(config, root=HERE):
    """The module that builds and checks a configuration's model."""
    path = root / "families" / f"{config['family']}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.families.{config['family']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(names, root=HERE):
    """{name: module} of the per-layer metrics of ``names``: each has
    ``UNIT`` and ``read(t)``."""
    out = {}
    for name in names:
        path = root / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def benchmark_spec(root=HERE):
    """BENCHMARK.json beside the benchmark's folder, or None."""
    path = root.parent / "BENCHMARK.json"
    return json.loads(path.read_text()) if path.exists() else None


def per_layer_names(cell, root=HERE):
    """The per-layer metrics that BENCHMARK.json lists for ``cell`` (all
    of the readers under metrics/ where there is no BENCHMARK.json)."""
    spec = benchmark_spec(root)
    if spec is None:
        return sorted(p.stem for p in (root / "metrics").glob("*.py")
                      if not p.stem.startswith("_"))
    return [m["name"] for m in spec["per_layer"]
            if cell in m.get("workloads", [cell])]


def foreign_modules(modules):
    """Names in ``modules`` whose top-level name is a JAX one or the JAX
    package's, compared whole."""
    return sorted(n for n in modules if n.split(".")[0] in FOREIGN)


# ----------------------------------------------------------------------
# the recorder: sweep marks, captured answers, launches
# ----------------------------------------------------------------------
class Recorder:
    """What the benchmark's wrappers and its ``traced_callback`` record.

    ``hook`` is the traced callback: it marks the sweep's end (a CUDA
    event, or the host clock on the CPU), keeps the captured chains' state
    at the start and end of each captured sweep, and keeps the index of
    the sweep under way. ``capture_at`` maps each captured sweep to its
    chains (a device tensor); the wrappers (``capture.py`` and a family's
    own) ask ``capturing()`` whether to keep a step, ``sample_items(B)``
    for the items to keep of it, and fill ``pending`` with a step's
    likelihood answers; ``launches`` (a list, or None) records each kernel
    launch, ``span(label)`` a synchronised span in the traced run's second
    stretch."""

    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rng = np.random.default_rng([int(seed), 0xCA9])
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(self.rng.integers(1 << 62)))
        self.nchains = 1
        self.sweep = 0
        self.marks = None          # preallocated events / host stamps
        self.capture_at = {}
        self.captures = []
        self.pending = None
        self.in_scales = False
        self.launches = None
        self.spans = None          # {label: seconds} in stretch 2

    def hook(self, state, pdata, gen, step):
        if self.marks is not None:
            i = step + 1
            if self.cuda:
                self.marks[i].record()
            else:
                self.marks[i] = time.perf_counter()
        if step + 1 in self.capture_at:
            capture.keep_state(self, state, "before", step + 1)
        if step in self.capture_at:
            capture.keep_state(self, state, "after", step)
        self.sweep = step + 1
        return state, pdata

    def start_marks(self, nsweeps):
        """Prepare nsweeps + 1 marks and set mark 0 (the call's start)."""
        self.sweep = 0
        if self.cuda:
            self.marks = [torch.cuda.Event(enable_timing=True)
                          for _ in range(nsweeps + 1)]
            self.marks[0].record()
        else:
            self.marks = [None] * (nsweeps + 1)
            self.marks[0] = time.perf_counter()

    def sweep_seconds(self):
        """The time of every sweep: the intervals between marks."""
        if self.cuda:
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks[:-1], self.marks[1:])]
        return list(np.diff(self.marks))

    def choose_captures(self, nsweeps, nchains):
        """Sweeps whose steps are kept: the last and others drawn from the
        seed, never the call's first (its start state is the hook's only
        after it); each with CHECK_CHAINS chains drawn from the seed."""
        self.nchains = nchains
        later = np.arange(1, nsweeps - 1)
        pick = self.rng.choice(later, size=min(len(later),
                                               CAPTURE_SWEEPS - 1),
                               replace=False) if len(later) else []
        sweeps = sorted({nsweeps - 1, *map(int, pick)}) if nsweeps > 1 \
            else []
        self.capture_at = {
            s: torch.as_tensor(np.sort(self.rng.choice(
                nchains, size=min(nchains, CHECK_CHAINS), replace=False)),
                device=self.device) for s in sweeps}

    def capturing(self):
        return self.sweep in self.capture_at

    def sample_items(self, B):
        """The items of a B-item step to keep, sorted, on the device:
        CAPTURE_ITEMS drawn from the seed at this step, and every item of
        the sweep's captured chains (items are chain-major)."""
        per = B // self.nchains
        rand = torch.randperm(B, generator=self.gen,
                              device=self.device)[:CAPTURE_ITEMS]
        ch = self.capture_at[self.sweep]
        whole = (ch[:, None] * per + torch.arange(
            per, device=self.device)).reshape(-1)
        return torch.sort(torch.cat([rand, whole])).values

    def span(self, label):
        return _Span(self, label)


class _Span:
    def __init__(self, rec, label):
        self.rec, self.label = rec, label

    def __enter__(self):
        if self.rec.spans is not None:
            _sync(self.rec.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.rec.spans is not None:
            _sync(self.rec.device)
            self.rec.spans[self.label] = (self.rec.spans.get(self.label, 0.0)
                                          + time.perf_counter() - self.t0)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------
def process_start():
    """The wall-clock time this process started (from /proc, to 10 ms)."""
    import os
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, IndexError, ValueError):
        return None


def device_info(chips):
    """{platform, kind, count} of the run; NoDevice without enough cards."""
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: portbench "
                       "measures the port on an NVIDIA GPU and has no CPU "
                       "fallback")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} GPUs, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _key(seed, site):
    return (int(seed) * 1_000_003 + site) % (1 << 62)


def window_rate(nchains, nsweeps, window_s):
    """Chain-sweeps a second: every sweep of every chain over the whole
    window."""
    return nchains * nsweeps / window_s


def window_sweeps(seconds, sweeps_per_second, nthin):
    """The window's sweeps: ``seconds`` at the traffic's planned rate, in
    whole thinning intervals, at least two sweeps. A fixed amount of work
    for a given ``--seconds``: the same on a slow host as on a fast one."""
    n = seconds * sweeps_per_second
    return max(nthin * -(-2 // nthin), int(round(n / nthin)) * nthin)


def quantile(values, q):
    """The q-th of 100 quantiles of all the values (statistics'
    exclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100)[q - 1]


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None,
             log=print, root=HERE, control=()):
    """One run of cell ``name``; returns the result dict. On "cuda" it
    refuses to run without the cards the cell asks for. With ``control``
    (names in ``reference.checks.LOWP``) the result also holds
    ``control_checks``: for each, the same numbers with the reference
    computed from inputs so rounded in the program's place
    (``calibrate.py``)."""
    wl = load_workload(name, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        info = device_info(int(wl["chips"]))
        log(f"device: {info['kind']} x{info['count']}; nvidia-smi: "
            f"{power_limit()}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
    else:
        info = dict(platform="cpu", kind="cpu", count=1)
    fam = family(wl["config_data"], root)
    t_build = time.perf_counter()
    built = fam.prepare_device(dev)
    log(f"kernels: {built} in {time.perf_counter() - t_build:.3f}s")
    cell = fam.build(wl["config_data"], wl["traffic_data"], int(seed), dev)
    rec = Recorder(seed, dev)
    restore = cell.install(rec)
    try:
        result = _measure(wl, cell, rec, seed, seconds, trace, dev, t_start,
                          log, root, control)
    finally:
        restore()
    result["device"] = dict(info, **result.pop("device_extra"))
    return result


def _measure(wl, cell, rec, seed, seconds, trace, dev, t_start, log, root,
             control):
    model, data, nthin = cell.model, cell.data, cell.nthin
    run = dict(traced_callback=rec.hook, verbose=False)
    # warm-up: one call over every shape of the window (the sweeps, the
    # draws' snapshot, their copy to the host, the end-of-run report) and
    # the capture's own operations at one captured sweep
    t_warm = time.perf_counter()
    rec.choose_captures(WARM_SWEEPS, cell.nchains)
    model.run_gibbs(data, nburn=1, nthin=1, nsamples=WARM_SWEEPS - 1,
                    key=_key(seed, 1), **run)
    _sync(dev)
    rec.capture_at, rec.captures = {}, []
    nsweeps = window_sweeps(seconds,
                            float(wl["traffic_data"]["sweeps_per_second"]),
                            nthin)
    rec.choose_captures(nsweeps, cell.nchains)
    log(f"warm-up: {WARM_SWEEPS} sweeps in "
        f"{time.perf_counter() - t_warm:.3f}s; window: {nsweeps} sweeps of "
        f"{cell.nchains} chains, nthin {nthin}")

    # the window
    rec.start_marks(nsweeps)
    t0 = time.perf_counter()
    setup_s = (time.time() - t_start) if t_start is not None else None
    results = model.run_gibbs(data, nburn=0, nthin=nthin,
                              nsamples=nsweeps // nthin,
                              key=_key(seed, 3), **run)
    _sync(dev)
    window_s = time.perf_counter() - t0
    sweep_s = rec.sweep_seconds()
    rec.marks = None
    rec.captured, rec.capture_at = rec.capture_at, {}
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    rate = window_rate(cell.nchains, nsweeps, window_s)
    log(f"window: {nsweeps} sweeps in {window_s:.3f}s, "
        f"{rate:.3f} chain-sweeps/s")

    out = dict(device_extra=dict(memory_peak_bytes=int(memory_peak)))
    if trace:
        from portbench import trace as tr
        names = per_layer_names(wl["name"], root)
        td = tr.traced_stretches(cell, rec, model, data, seed, dev,
                                 window_s, nsweeps, log)
        metrics = {}
        for name, mod in metric_readers(names, root).items():
            value = mod.read(td)
            if value is not None:
                metrics[name] = dict(value=float(value), unit=mod.UNIT)
        out["metrics"] = metrics
        if td.prof is not None:
            out["device_extra"].update(busy_s=td.prof["busy_s"],
                                       window_s=td.prof["window_s"])
            out["breakdown"] = td.prof["breakdown"]
    else:
        out["metrics"] = {
            "chain_sweeps_per_sec": dict(value=rate, unit="sweeps/s"),
            "sweep_ms_p90": dict(value=1e3 * quantile(sweep_s, 90),
                                 unit="ms")}
        if setup_s is not None:
            out["metrics"]["setup_s"] = dict(value=setup_s, unit="s")

    # the check, once the window has closed and the program's state is
    # freed: the reference runs in blocks
    cell.free_model()
    del model
    gc.collect()              # the wrappers on the model make a cycle
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = cell.check(rec, results)
    log(f"check: {time.perf_counter() - t_check:.3f}s")
    out["attempted"] = sum(c["compared"] for c in checks.values())
    out["failed"] = sum(c["failed"] for c in checks.values())
    out["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    out["checks"] = {k: dict(value=c["value"], limit=c["limit"])
                     for k, c in checks.items()}
    for name in control:
        out.setdefault("control_checks", {})[name] = {
            k: c["value"]
            for k, c in cell.check(rec, results, control=name).items()}
    return out


def result_line(result):
    """The JSON line the driver reads: its keys in order, the compared
    numbers last."""
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    return json.dumps({k: result[k] for k in keys if k in result})
