"""Check and time the fused GASS log-likelihood kernels at the shapes of
the port's paths.

    python -m functionalmf_tpu_torch.ops.fused_ll_bench \\
        [--baseline OLD.cu] [--out FILE]

Each case is one kernel (row or column block, with or without EP) at one
shape that a path launches it at, built on the card from a seed. For each
case the kernel is held against its plain version (rtol=1e-5, atol=1e-3:
the sums run in another order), two launches must agree bit for bit, and
these are measured:

* ``device_us``: the kernel's device time per launch, torch.profiler's
  CUDA kernel time (``key_averages()`` by kernel name over the count) over
  50 launches; where the profiler shows no device time, CUDA events around
  50 replays of a CUDA graph that holds one launch;
* ``host_us``: the wrapper's host time per call (checks, output
  allocation, the ctypes call), 50 calls without a synchronise;
* ``event_ms``: the median of CUDA events around one call, host work
  included (the kernels' earlier timing); ``plain_ms`` the same for
  the plain PyTorch version;
* ``bound_us``: the least time an H100 SXM could take for the work this
  case's data needs (:func:`work`).

With ``--baseline``, a second library is built from OLD.cu (an earlier
``csrc/fused_ll.cu`` with the same C entry points, without the launch-plan
arguments) and its device time is taken beside the current kernels' in
turns: old, new, new, old. ``chip_smoke.py`` runs :func:`run_cases` on the
paths' own data.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import time
from pathlib import Path
import numpy as np
import torch

from functionalmf_tpu_torch.ops import fused_ll as F

__all__ = ["H100", "Case", "path_cases", "work", "device_us", "host_us",
           "event_ms", "check_case", "time_case", "run_cases", "Baseline"]

RTOL, ATOL = 1e-5, 1e-3
REPS = 50
# Published H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, FP32
# FLOP/s outside the tensor cores, and special-function (MUFU) ops/s at 16
# per clock per SM, 132 SMs, the 1.98 GHz boost clock.
H100 = dict(bytes_per_s=3.35e12, fp32_per_s=67e12,
            sfu_per_s=132 * 16 * 1.98e9)
# FP32 operations per (candidate, cell) pair besides the k-term dot (2k):
# the Poisson cell (clamp, y*log(rate) - rate, the sum) and the EP term
# ((tau - mu) / sig, its square, the constant, the difference)
POISSON_FLOPS, EP_FLOPS = 4, 4


@dataclasses.dataclass
class Case:
    """One launch shape of one kernel. ``args`` are the batched wrapper's
    positional tensors: (cands, bt, y, row_chain, row_idx) for the row
    kernel, (cands, w, y, pair_chain, pair_col, pair_t0) for the column
    kernel."""
    name: str                  # the launch_counts key
    shape: str
    args: tuple
    extras: tuple = ()

    @property
    def row(self):
        return self.name.startswith("fused_row_ll")

    def kernel(self):
        fn = F.fused_row_ll_batched if self.row else \
            F.fused_col_block_ll_batched
        return fn(*self.args, F.POISSON, self.extras)

    def plain(self):
        fn = F.row_ll_plain if self.row else F.col_block_ll_plain
        return fn(*self.args, F.POISSON, self.extras)


def _cells(case):
    """(y, mu) at every cell of every item, NaN outside [0, T); mu None
    without EP. Row: (R, C); column: (P, Tb, n)."""
    if case.row:
        _, _, y, _, ri = case.args
        ri = ri.long()
        pick = lambda x: x[ri]
    else:
        cands, _, y, _, pj, pt = case.args
        T, Tb = y.shape[2], cands.shape[2]
        tt = pt.long()[:, None] + torch.arange(Tb, device=y.device)
        inside = (tt >= 0) & (tt < T)

        def pick(x):
            xb = x.permute(1, 2, 0)[pj.long()[:, None], tt.clamp(0, T - 1)]
            return torch.where(inside[..., None], xb, torch.nan)
    mu = pick(case.extras[0]) if case.extras else None
    return pick(y), mu


def work(case) -> dict:
    """What the case's data needs: (candidate, cell) pairs, FP32
    operations, special-function operations (one log per pair whose y is
    present) and bytes (each input read once, the output written once);
    the bound is the largest of the three over the H100's peaks."""
    cands = case.args[0]
    G, k = cands.shape[1], cands.shape[-1]
    y, mu = _cells(case)
    has_y = ~torch.isnan(y)
    has_ep = ~torch.isnan(mu) if mu is not None else torch.zeros_like(has_y)
    n_act = int((has_y | has_ep).sum())
    n_y, n_ep = int(has_y.sum()), int(has_ep.sum())
    flops = G * (n_act * 2 * k + n_y * POISSON_FLOPS + n_ep * EP_FLOPS)
    sfu = G * n_y
    nbytes = 4 * cands.numel() + 4 * cands.shape[0] * G          # in, out
    vec, chains = case.args[1], case.args[3]
    nbytes += 4 * int(torch.unique(chains).numel()) * vec[0].numel()
    nbytes += 4 * sum(t.numel() for t in case.args[3:])          # indices
    per_cell = 1 + 2 * bool(case.extras)                         # y[, mu, sig]
    if case.row:
        nrows_used = int(torch.unique(case.args[4]).numel())
        nbytes += 4 * per_cell * nrows_used * y.shape[1]
    else:
        nbytes += 4 * per_cell * (y.numel() - _outside(case))
    times = dict(bytes=nbytes / H100["bytes_per_s"],
                 operations=flops / H100["fp32_per_s"],
                 special_function=sfu / H100["sfu_per_s"])
    side = max(times, key=times.get)
    return dict(pairs=G * n_act, flops=flops, sfu=sfu, bytes=nbytes,
                bound_us=times[side] * 1e6,
                bound_by="bytes" if side == "bytes" else "operations",
                bound_detail=side)


def _outside(case):
    """Cells of the column kernel's pairs with t0 + t outside [0, T)."""
    cands, _, y, _, _, pt = case.args
    T, Tb, n = y.shape[2], cands.shape[2], y.shape[0]
    tt = pt.long()[:, None] + torch.arange(Tb, device=y.device)
    return int(((tt < 0) | (tt >= T)).sum()) * n


def path_cases(dev, Y, W0, V0, pol, wide_T=1000, seed=7):
    """Every shape the paths launch each kernel at, 19x19x228 and k=5:
    with 101 candidates (the grid method: ngrid=100 + the current point),
    then with one (the shrink method; ``G=1`` in the shape). The W update at
    nchains 1 and 4 (R=19, 76); the V updates' red-black colour phase
    (nchains 1 and 4: P=266, 1064; Tb=8), sequential round (P=19, Tb=8),
    4-wide tail (P=19, Tb=4) and joint update (P=19, Tb=228), and a joint
    update at T=``wide_T`` on synthetic counts. Without EP the data are
    ``Y``, ``W0``, ``V0`` (the bench.py recipe); with EP ``pol`` = (y, W,
    V, (mu, sig)) (the politics path), candidates within 10% of W or V."""
    return [case for G in (101, 1)
            for case in _path_cases(dev, Y, W0, V0, pol, wide_T, seed, G)]


def _path_cases(dev, Y, W0, V0, pol, wide_T, seed, G):
    tag = "" if G == 101 else f", G={G}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=dev)
    i32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                    device=dev)
    n, m, T = Y.shape
    k = W0.shape[1]
    C = m * T

    def jitter(shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.2 + 0.9

    y_pol, Wp, Vp, ep = t(pol[0]), t(pol[1]), t(pol[2]), tuple(map(t, pol[3]))
    data = {False: (t(Y), t(W0), t(V0), ()), True: (y_pol, Wp, Vp, ep)}
    cases = []
    for ep_on in (False, True):
        y, W, V, ex = data[ep_on]
        name = "fused_row_ll" + "_ep" * ep_on
        for nch in (1, 4):
            R = nch * n
            rc = i32(np.repeat(np.arange(nch), n))
            ri = i32(np.tile(np.arange(n), nch))
            bt = (V.reshape(1, C, k) * jitter((nch, C, k))).contiguous()
            if ep_on:
                cw = W[ri.long()][:, None, :] * jitter((R, G, k))
            else:
                cw = torch.rand((R, G, k), generator=gen, device=dev) * 0.4 + .8
                cw = cw * (torch.arange(k, device=dev)[None] <=
                           torch.arange(n, device=dev)[:, None]
                           ).repeat(nch, 1)[:, None, :]
            cases.append(Case(name, f"R={R}, C={C}{tag}", (
                cw.contiguous(), bt, y.reshape(n, C).contiguous(), rc, ri),
                tuple(e.reshape(n, C).contiguous() for e in ex)))

    # synthetic counts for the wide joint update
    rng = np.random.default_rng(seed)
    Vw = np.abs(np.cumsum(rng.normal(0, 0.05, (m, wide_T, k)), axis=1)
                + rng.gamma(1, 0.5, (m, 1, k)))
    Mw = np.einsum("nk,mtk->nmt", W0, Vw)
    Yw = rng.poisson(Mw).astype(np.float32)
    Yw[rng.random((n, m)) < 0.1] = np.nan
    wide = {False: (t(Yw), t(W0), t(Vw), ()),
            True: (t(Yw), t(W0), t(Vw), (t(Mw), t(np.full(Mw.shape, 0.068))))}

    bs = 8
    nb_full, rem = divmod(T, bs)
    phase = [b * bs for b in range(0, nb_full, 2)]
    shapes = (("red-black phase", phase, bs, 1, False),
              ("red-black phase", phase, bs, 4, False),
              ("seq round", [(nb_full // 2) * bs], bs, 1, False),
              ("tail", [nb_full * bs], rem, 1, False),
              ("joint", [0], T, 1, False),
              ("joint", [0], wide_T, 1, True))
    for ep_on in (False, True):
        name = "fused_col_block_ll" + "_ep" * ep_on
        for label, starts, Tb, nch, is_wide in shapes:
            y, W, V, ex = (wide if is_wide else data)[ep_on]
            nb = len(starts)
            P = nch * m * nb
            pc = i32(np.repeat(np.arange(nch), m * nb))
            pj = i32(np.tile(np.repeat(np.arange(m), nb), nch))
            pt = i32(np.tile(starts, nch * m))
            w = (W[None] * jitter((nch, n, k))).contiguous()
            if ep_on:
                tt = pt[:, None].long() + torch.arange(Tb, device=dev)
                c3 = V[pj[:, None].long(), tt][:, None] * jitter((P, G, Tb, k))
            else:
                c3 = torch.rand((P, G, Tb, k), generator=gen,
                                device=dev) * 0.4 + 0.8
            cases.append(Case(name, f"{label}: P={P}, Tb={Tb}{tag}",
                              (c3.contiguous(), w, y, pc, pj, pt), ex))
    return cases


def example_cases(dev, Y, W0, V0, block=8, seed=7):
    """The Poisson example's shapes (examples/poisson_tensor_filtering.py:
    11x12x20, k=3, the seq schedule in blocks of ``block``, no EP), 101
    candidates, on its data ``Y`` (n, m, T) and NMF warm start: the W
    update (R=n, C=m T), a seq round (P=m, Tb=block; T // block of them a
    sweep) and the tail (P=m, Tb=T % block)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=dev)
    i32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                    device=dev)
    n, m, T = Y.shape
    k, G, C = W0.shape[1], 101, m * T
    y, W, V = t(Y), t(W0), t(V0)
    jitter = lambda shape: torch.rand(shape, generator=gen,
                                      device=dev) * 0.2 + 0.9
    cw = torch.rand((n, G, k), generator=gen, device=dev) * 0.4 + 0.8
    cw = cw * (torch.arange(k, device=dev)[None]
               <= torch.arange(n, device=dev)[:, None])[:, None, :]
    cases = [Case("fused_row_ll", f"example R={n}, C={C}", (
        cw.contiguous(), (V.reshape(1, C, k) * jitter((1, C, k))).contiguous(),
        y.reshape(n, C).contiguous(), i32(np.zeros(n)), i32(np.arange(n))))]
    nb, rem = divmod(T, block)
    for label, t0, Tb in (("seq round", (nb - 1) * block, block),
                          ("tail", nb * block, rem)):
        c3 = torch.rand((m, G, Tb, k), generator=gen, device=dev) * 0.4 + 0.8
        cases.append(Case("fused_col_block_ll",
                          f"example {label}: P={m}, Tb={Tb}",
                          (c3, (W[None] * jitter((1, n, k))).contiguous(), y,
                           i32(np.zeros(m)), i32(np.arange(m)),
                           i32(np.full(m, t0)))))
    return cases


def device_us(launch, pattern="ll_kernel", reps=REPS):
    """Device time per launch of the kernels whose name holds ``pattern``:
    torch.profiler over ``reps`` launches, or CUDA events around ``reps``
    replays of a CUDA graph of one launch where the profiler sees no
    device time. Returns (µs, how)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    for _ in range(2):          # a window can miss kernel records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if pattern in ev.key:
                total += getattr(ev, "device_time_total", 0.0) or 0.0
                count += ev.count
        if count == reps and total > 0:
            return total / count, "profiler"
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        launch()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    graph.replay()
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / reps, "graph"


def host_us(launch, reps=REPS):
    """Host time per call, ``reps`` calls without a synchronise."""
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        launch()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def event_ms(fn, reps=REPS, warm=5):
    """Median of CUDA events around one call (host work included)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(got, want):
    """Max |err| of the kernel against its plain version and the worst
    |err| / (atol + rtol |want|); raises where that is above 1 or the
    output is not finite."""
    got, want = got.double(), want.double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("non-finite output")
    err = (got - want).abs()
    bound = ATOL + RTOL * want.abs()
    if bool((err > bound).any()):
        raise AssertionError(
            f"kernel disagrees with its plain version (max |err| "
            f"{float(err.max()):.3e}, worst err/bound "
            f"{float((err / bound).max()):.3f})")
    return float(err.max()), float((err / bound).max())


def check_case(case):
    """Hold the kernel against its plain version, twice bit for bit, and
    take the host-side times: a record without device time."""
    got = case.kernel()
    again = case.kernel()
    want = case.plain()
    torch.cuda.synchronize()
    try:
        err, ratio = compare(got, want)
    except AssertionError as exc:
        raise AssertionError(f"{case.name} ({case.shape}): {exc}") from None
    if not torch.equal(got, again):
        raise AssertionError(f"{case.name} ({case.shape}): two launches on "
                             "the same inputs differ")
    return dict(name=case.name, shape=case.shape, max_abs_err=err,
                err_ratio=ratio, **work(case), host_us=host_us(case.kernel),
                event_ms=event_ms(case.kernel), plain_ms=event_ms(case.plain))


def time_case(case, rec, baseline=None):
    """Add the kernel's device time to ``rec``; with a :class:`Baseline`,
    the old kernel's too, in turns (old, new, new, old)."""
    old = baseline.launcher(case) if baseline is not None else None
    if old is not None:
        base = compare(old(), case.plain())[0]
        t_old1, how = device_us(old)
        t_new1, _ = device_us(case.kernel)
        t_new2, _ = device_us(case.kernel)
        t_old2, _ = device_us(old)
        rec.update(device_us=(t_new1 + t_new2) / 2,
                   device_us_old=(t_old1 + t_old2) / 2,
                   device_us_runs=[t_old1, t_new1, t_new2, t_old2],
                   max_abs_err_old=base, timing=how)
    else:
        rec["device_us"], rec["timing"] = device_us(case.kernel)
    rec["pct_of_bound"] = 100.0 * rec["bound_us"] / rec["device_us"]
    return rec


def run_cases(cases, baseline=None):
    """Check every case, then time every case. The host-side times come
    first: once torch.profiler has run in a process, later launches there
    measured slower on the host."""
    checked = [check_case(case) for case in cases]
    return [time_case(case, rec, baseline)
            for case, rec in zip(cases, checked)]


def format_record(rec):
    old = (f" old_device_us={rec['device_us_old']:.2f}"
           if "device_us_old" in rec else "")
    return (f"kernel {rec['name']} ({rec['shape']}): "
            f"max_abs_err={rec['max_abs_err']:.3e} "
            f"(err/bound {rec['err_ratio']:.3f}) "
            f"device_us={rec['device_us']:.2f}{old} "
            f"host_us={rec['host_us']:.2f} bound_us={rec['bound_us']:.3f} "
            f"({rec['bound_detail']}) pct_of_bound="
            f"{rec['pct_of_bound']:.1f} event_ms={rec['event_ms']:.4f} "
            f"plain_ms={rec['plain_ms']:.4f} [{rec['timing']}]")


class Baseline:
    """An earlier fused_ll.cu built into its own library and launched on
    a case's tensors through its C entry points (the argument lists of
    ``fmf_row_ll`` / ``fmf_col_block_ll`` without the launch-plan
    arguments)."""

    def __init__(self, source):
        from functionalmf_tpu_torch.ops import _build
        self.lib = ctypes.CDLL(str(_build.build([Path(source)],
                                                name="fmf_baseline")))
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.fmf_row_ll.argtypes = [i, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i, p]
        self.lib.fmf_col_block_ll.argtypes = [i, p, p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, i, i, i, p]

    def launcher(self, case):
        """A launch of the old kernel on the case, or None where the old
        wrapper refused the shape (a 16 x Tb x k candidate tile wholly in
        shared memory)."""
        a = case.args
        if not case.row and 16 * a[0].shape[2] * a[0].shape[3] * 4 > \
                227 * 1024 - 256:
            return None
        mu, sig = (e.data_ptr() for e in case.extras) if case.extras \
            else (None, None)
        G = a[0].shape[1]

        def launch():
            out = torch.empty((a[0].shape[0], G), dtype=torch.float32,
                              device=a[0].device)
            stream = torch.cuda.current_stream().cuda_stream
            ptrs = [x.data_ptr() for x in a]
            if case.row:
                R, _, k = a[0].shape
                nch, C, _ = a[1].shape
                code = self.lib.fmf_row_ll(
                    0, ptrs[0], ptrs[1], ptrs[2], mu, sig, ptrs[3], ptrs[4],
                    out.data_ptr(), R, G, k, C, nch, a[2].shape[0], stream)
            else:
                P, _, Tb, k = a[0].shape
                nch, n, _ = a[1].shape
                _, m, T = a[2].shape
                code = self.lib.fmf_col_block_ll(
                    0, ptrs[0], ptrs[1], ptrs[2], mu, sig, ptrs[3], ptrs[4],
                    ptrs[5], out.data_ptr(), P, G, Tb, k, n, m, T, nch,
                    stream)
            if code != 0:
                raise RuntimeError(f"baseline launch failed ({code})")
            return out
        return launch


def synthetic_problem(seed=42, n=19, m=19, T=228, k=5):
    """GDELT-shaped counts with 10% of pairs held out (NaN), a random warm
    start and EP centred on its rates at the politics app's sigma."""
    rng = np.random.default_rng(seed)
    W = rng.gamma(1.5, 1, size=(n, k))
    V = np.abs(np.cumsum(rng.normal(0, 0.05, (m, T, k)), axis=1)
               + rng.gamma(1, 0.5, (m, 1, k)))
    M = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(M).astype(float)
    Y[rng.random((n, m)) < 0.1] = np.nan
    return Y, W, V, (Y, W, V, (M, np.full(M.shape, 0.068)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", default=None,
                    help="an earlier fused_ll.cu to time beside the current")
    ap.add_argument("--out", default=None, help="write the records as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_ll_bench: needs a CUDA device")
    dev = torch.device("cuda:0")
    from functionalmf_tpu_torch._runtime import require_full_f32
    require_full_f32()
    baseline = Baseline(args.baseline) if args.baseline else None
    Y, W, V, pol = synthetic_problem()
    records = run_cases(path_cases(dev, Y, W, V, pol), baseline)
    for rec in records:
        print(format_record(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            device=torch.cuda.get_device_name(0), records=records),
            indent=1))


if __name__ == "__main__":
    main()
