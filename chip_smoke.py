"""Drive the PyTorch/CUDA port of the constrained-Poisson red-black Gibbs
path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of functionalmf_tpu_torch/csrc from source;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (19x19x228, k=5, 101 candidates, 8-wide time
     blocks and the 4-wide tail), NaNs in y, rtol=1e-5 / atol=1e-3 (the
     sums run in another order); median times from CUDA events;
  4. slice: the bench.py data (seed 42) and red-black recipe on the card,
     run_gibbs at nchains=1 and nchains=4; both kernels must have launched
     in each run, every draw must be finite and feasible, and the results
     must carry the JAX package's keys and shapes;
  5. agreement: a small model run on the card (kernels) and on the CPU
     (plain versions) must reach the same posterior mean of Mu.
The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

NROWS, NCOLS, NDEPTH, NEMBEDS = 19, 19, 228, 5
NGRID = 100
BLOCK = 8
RTOL, ATOL = 1e-5, 1e-3


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def bench_data():
    """bench.py:138-150, seed 42."""
    rng = np.random.default_rng(42)
    W = np.abs(rng.normal(1, 0.3, size=(NROWS, NEMBEDS)))
    W[np.triu_indices(NEMBEDS, k=1)] = 0
    V = np.abs(rng.normal(1, 0.3, size=(NCOLS, NDEPTH, NEMBEDS)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
    hold = rng.random((NROWS, NCOLS)) < 0.1
    Y[hold] = np.nan
    Con = np.concatenate([np.eye(NDEPTH), np.zeros((NDEPTH, 1))], axis=1)
    W0 = np.abs(rng.normal(1, 0.2, size=(NROWS, NEMBEDS)))
    W0[np.triu_indices(NEMBEDS, k=1)] = 0
    V0 = np.abs(rng.normal(1, 0.2, size=(NCOLS, NDEPTH, NEMBEDS)))
    return Y, Con, W0, V0, np.einsum("nk,mtk->nmt", W, V)


def poisson_loglik(Y, WV, W, V, row=None, col=None):
    """bench.py:54-64 in torch."""
    if row is not None:
        Y = Y[row]
    if col is not None:
        Y = Y[:, col]
    if Y.dim() > WV.dim():
        WV = WV[..., None]
    rate = torch.clamp(WV, min=1e-8)
    nan = torch.isnan(Y)
    Y0 = torch.where(nan, 0.0, Y)
    ll = Y0 * torch.log(rate) - rate - torch.lgamma(Y0 + 1.0)
    return torch.where(nan, 0.0, ll).sum()


def cuda_median_ms(fn, reps=50, warm=5):
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


def compare(name, got, want):
    got, want = got.double(), want.double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    bound = ATOL + RTOL * want.abs()
    if bool((err > bound).any()):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max |err| {float(err.max()):.3e}, worst err/bound "
             f"{float((err / bound).max()):.3f})")
    return float(err.max())


def kernel_phase(dev, Y, W0, V0):
    from functionalmf_tpu_torch.ops import fused_ll as F
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    G = NGRID + 1                      # grid candidates + the current point
    k = NEMBEDS
    records = {}

    # W update: every row of one chain, C = m*T cells per row
    cands = (torch.rand((NROWS, G, k), generator=gen, device=dev) * 0.4 + 0.8)
    cands = cands * torch.as_tensor(np.tril(np.ones((NROWS, k))) > 0,
                                    device=dev)[:, None, :]
    bt = torch.as_tensor(V0, dtype=torch.float32,
                         device=dev).reshape(1, NCOLS * NDEPTH, k).contiguous()
    y2 = y.reshape(NROWS, NCOLS * NDEPTH).contiguous()
    rc = torch.zeros(NROWS, dtype=torch.int32, device=dev)
    ri = torch.arange(NROWS, dtype=torch.int32, device=dev)
    got = F.fused_row_ll_batched(cands, bt, y2, rc, ri, F.POISSON)
    want = F.row_ll_plain(cands, bt, y2, rc, ri, F.POISSON)
    torch.cuda.synchronize()
    err = compare("fused_row_ll", got, want)
    ms = cuda_median_ms(lambda: F.fused_row_ll_batched(cands, bt, y2, rc, ri,
                                                        F.POISSON))
    pms = cuda_median_ms(lambda: F.row_ll_plain(cands, bt, y2, rc, ri,
                                                F.POISSON))
    records["fused_row_ll"] = dict(
        replaces="functionalmf_tpu/ops/fused_ll.py:80", max_abs_err=err,
        ms=ms, plain_ms=pms)
    print(f"kernel fused_row_ll: max_abs_err={err:.3e} ms={ms:.4f} "
          f"plain_ms={pms:.4f} (R={NROWS}, G={G}, k={k}, C={NCOLS * NDEPTH})")

    # V update: one colour phase (19 columns x 14 blocks of 8) and the tail
    w = torch.as_tensor(W0, dtype=torch.float32, device=dev)[None].contiguous()
    nb_full, rem = divmod(NDEPTH, BLOCK)
    even = [b * BLOCK for b in range(0, nb_full, 2)]
    errs, times = [], []
    for starts, Tb in ((even, BLOCK), ([nb_full * BLOCK], rem)):
        P = NCOLS * len(starts)
        pc = torch.zeros(P, dtype=torch.int32, device=dev)
        pj = torch.arange(NCOLS, dtype=torch.int32,
                          device=dev).repeat_interleave(len(starts))
        pt = torch.as_tensor(starts * NCOLS, dtype=torch.int32, device=dev)
        c3 = torch.rand((P, G, Tb, k), generator=gen, device=dev) * 0.4 + 0.8
        got = F.fused_col_block_ll_batched(c3, w, y, pc, pj, pt, F.POISSON)
        want = F.col_block_ll_plain(c3, w, y, pc, pj, pt, F.POISSON)
        torch.cuda.synchronize()
        errs.append(compare(f"fused_col_block_ll (Tb={Tb})", got, want))
        ms = cuda_median_ms(lambda: F.fused_col_block_ll_batched(
            c3, w, y, pc, pj, pt, F.POISSON))
        pms = cuda_median_ms(lambda: F.col_block_ll_plain(
            c3, w, y, pc, pj, pt, F.POISSON))
        times.append((ms, pms))
        print(f"kernel fused_col_block_ll: max_abs_err={errs[-1]:.3e} "
              f"ms={ms:.4f} plain_ms={pms:.4f} (P={P}, G={G}, Tb={Tb}, k={k})")
    # the JSON record times the full-block phase, the one that runs twice
    # per sweep; the tail's times are on the line above
    records["fused_col_block_ll"] = dict(
        replaces="functionalmf_tpu/ops/fused_ll.py:138",
        max_abs_err=max(errs), ms=times[0][0], plain_ms=times[0][1])
    return records


def expected_result_shapes(nchains, nsamples):
    """The JAX package's results dict for this config (base.py:912-922,
    857-885): chain-major draws, scalars as (S, 1)."""
    S = nchains * nsamples
    nD = 3 * NDEPTH - 1                       # tf_order=2 penalty rows
    out = {"W": (S, NROWS, NEMBEDS), "V": (S, NCOLS, NDEPTH, NEMBEDS),
           "sigma2": (S, 1), "lam2": (S, 1), "Tau2": (S, NCOLS, nD),
           "nan_fallbacks": (nchains,), "pivot_repairs": (nchains,)}
    if nchains > 1:
        out["rhat"] = None
    return out


def slice_run(dev, Y, Con, W0, V0, nchains, nburn, nsamples):
    from functionalmf_tpu_torch import (
        ConstrainedNonconjugateBayesianTensorFiltering as Model)
    from functionalmf_tpu_torch.ops import fused_ll as F
    model = Model(
        NROWS, NCOLS, NDEPTH, poisson_loglik, Con, device=dev,
        nembeds=NEMBEDS, tf_order=2, sigma2_init=0.5, lam2_init=0.1,
        W_init=W0, V_init=V0, gass_ngrid=NGRID, seed=0, nchains=nchains,
        v_schedule="redblack", v_block_size=BLOCK,
        loglikelihood_cellfn=F.POISSON)
    # warm-up: the first sweeps load the kernels and the cuBLAS/cuSOLVER
    # handles; the timed run below continues from the warmed state
    t0 = time.perf_counter()
    model.run_gibbs(Y, nburn=2, nthin=1, nsamples=1, verbose=False)
    torch.cuda.synchronize()
    print(f"warm-up nchains={nchains}: 3 sweeps in "
          f"{time.perf_counter() - t0:.3f}s")
    F.reset_launch_counts()
    t0 = time.perf_counter()
    res = model.run_gibbs(Y, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(F.launch_counts)
    nsweeps = nburn + nsamples
    tag = f"nchains={nchains}"
    for name, cnt in launches.items():
        if cnt <= 0:
            fail(f"{tag}: kernel {name} was not launched by the main path")
    want = expected_result_shapes(nchains, nsamples)
    if set(res) != set(want):
        fail(f"{tag}: results keys {sorted(res)} != {sorted(want)}")
    for key, shape in want.items():
        if shape is None:
            continue
        if tuple(res[key].shape) != shape:
            fail(f"{tag}: results[{key!r}] has shape {res[key].shape}, "
                 f"expected {shape}")
        if not np.isfinite(res[key]).all():
            fail(f"{tag}: non-finite draws in {key}")
    if not model.check_constraints():
        fail(f"{tag}: final state violates the constraints")
    mu = np.einsum("snk,smtk->snmt", res["W"], res["V"])
    if mu.min() < -1e-5:
        fail(f"{tag}: a collected draw violates positivity "
             f"(min Mu {mu.min():.3e})")
    print(f"slice {tag}: sweeps={nsweeps} seconds={dt:.3f}")
    print(f"sweeps_per_sec {tag}: {nsweeps / dt:.3f}")
    print(f"nan_fallbacks {tag}: {res['nan_fallbacks'].tolist()}")
    print(f"launches {tag}: {json.dumps(launches)}")
    if nchains > 1:
        print(f"rhat {tag}: max={res['rhat'].get('max')}")
    return res, launches


def agreement_phase(dev):
    """A small red-black model on the card (kernels) and on the CPU (plain
    versions): same posterior mean of Mu up to Monte Carlo error, the
    rel < 0.12 criterion of tests/test_constrained.py:347."""
    from functionalmf_tpu_torch import (
        ConstrainedNonconjugateBayesianTensorFiltering as Model)
    from functionalmf_tpu_torch.ops import fused_ll as F
    n_, m_, T_, k_ = 6, 5, 12, 2
    rng = np.random.default_rng(5)
    W = rng.gamma(1, 1, (n_, k_))
    W[np.triu_indices(k_, 1)] = 0
    V = np.abs(rng.normal(1, .3, (m_, T_, k_)))
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(Mu).astype(float)
    Y[0, 0] = np.nan
    C = np.concatenate([np.eye(T_), np.zeros((T_, 1))], axis=1)
    W0 = np.abs(rng.normal(1, .2, (n_, k_)))
    W0[np.triu_indices(k_, 1)] = 0
    V0 = np.abs(rng.normal(1, .2, (m_, T_, k_)))
    means = {}
    for d in (dev, "cpu"):
        mod = Model(
            n_, m_, T_, poisson_loglik, C, device=d, nembeds=k_, tf_order=0,
            sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
            gass_ngrid=24, v_block_size=3, v_schedule="redblack", seed=7,
            loglikelihood_cellfn=F.POISSON)
        res = mod.run_gibbs(Y, nburn=400, nthin=1, nsamples=400,
                            verbose=False)
        mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        if mu.min() < -1e-5 or not np.isfinite(mu).all():
            fail(f"agreement run on {d}: infeasible or non-finite draws")
        means[str(d)] = mu.mean(0)
    rel = float(np.abs(means[str(dev)] - means["cpu"]).mean()
                / np.sqrt((Mu ** 2).mean()))
    print(f"agreement card vs cpu: rel={rel:.4f} (limit 0.12)")
    if not rel < 0.12:
        fail(f"card and CPU posteriors disagree (rel={rel:.4f})")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda:0")

    from functionalmf_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f}s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    _build.load_library()

    Y, Con, W0, V0, _ = bench_data()
    records = kernel_phase(dev, Y, W0, V0)

    _, l1 = slice_run(dev, Y, Con, W0, V0, nchains=1, nburn=100,
                      nsamples=100)
    slice_run(dev, Y, Con, W0, V0, nchains=4, nburn=20, nsamples=20)
    agreement_phase(dev)

    kernels = [dict(name=name, route="cuda",
                    source="functionalmf_tpu_torch/csrc/fused_ll.cu",
                    replaces=rec["replaces"], launches=l1[name],
                    max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                    plain_ms=rec["plain_ms"])
               for name, rec in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
