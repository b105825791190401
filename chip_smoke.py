"""Drive the PyTorch/CUDA port on one NVIDIA GPU through its two paths, the
red-black constrained-Poisson recipe and the GDELT politics benchmark with
EP centring, and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of functionalmf_tpu_torch/csrc from source;
  3. red-black slice: the bench.py data (seed 42) and red-black recipe on
     the card, run_gibbs at nchains=1 and nchains=4; both non-EP kernels
     must have launched in each run, every draw must be finite and
     feasible, and the results must carry the JAX package's keys and
     shapes;
  4. politics: the port's app (functionalmf_tpu_torch.apps.politics.
     benchmark) on its synthetic 19x19x228 tensor, EP on, with the seq
     schedule (nchains=1), the red-black schedule (nchains=4) and the joint
     update; only the EP kernels may launch and both must, the draws must
     be finite, feasible and of the JAX package's shapes, every collected
     draw must differ from the warm start, and the BTF's in-sample RMSE
     must beat the empirical mean's (the warm start alone does: the app's
     EP is overconfident on this tensor and holds the chain near it);
     sweeps/s from the app's cold timer and from 20 more warmed sweeps;
  5. agreement: models run on the card (kernels) and on the CPU (plain
     versions) must reach the same posterior mean of Mu: small models of
     the red-black recipe and of the seq schedule with EP, and the
     politics tensor at full width (seq, EP at a sigma the model does not
     call overconfident), started at half the warm start's rates;
  6. kernels: each of the four kernels (row and column-block, each with and
     without EP) against its plain PyTorch version on the card, at every
     shape the paths launch it at (functionalmf_tpu_torch/ops/
     fused_ll_bench.py: 19x19x228, k=5, 101 candidates; the W update at
     nchains 1 and 4; column blocks of 8 in a colour phase at nchains 1
     and 4 and in a seq round, the 4-wide tail, the joint update's 228,
     and a joint update at T=1000 on synthetic counts), NaN y at held-out
     pairs; the EP variants with the politics path's own EP (the app's NMF
     warm start and ep_from_nmf sigma) and candidates around the warm
     start; rtol=1e-5 / atol=1e-3 (the sums run in another order); two
     launches on the same inputs must agree bit for bit; each kernel's
     device time (torch.profiler), the wrapper's host time, its bound on
     an H100 and its share of it. Last, because torch.profiler slows every
     later launch of the process on the host.
The line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NROWS, NCOLS, NDEPTH, NEMBEDS = 19, 19, 228, 5
NGRID = 100
BLOCK = 8
WARM_SWEEPS = 20
REPLACES = {"fused_row_ll": "functionalmf_tpu/ops/fused_ll.py:80",
            "fused_col_block_ll": "functionalmf_tpu/ops/fused_ll.py:138"}
# the shape of each kernel's record in the JSON line: the one its main
# path launches most (the bench.py recipe without EP, politics seq with)
RECORD_SHAPE = {"fused_row_ll": "R=19,", "fused_row_ll_ep": "R=19,",
                "fused_col_block_ll": "red-black phase: P=266,",
                "fused_col_block_ll_ep": "seq round"}


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


def politics_problem():
    """The politics path's inputs as the app builds them (seed 42): the
    synthetic tensor with NaN at the held-out pairs, the NMF warm start
    W0, V0 and the app's EP (ep_from_nmf: the warm start's rates, finite at
    every cell, and one sigma for all)."""
    from functionalmf_tpu_torch.apps.politics.benchmark import (
        ep_from_nmf, load_data)
    from functionalmf_tpu_torch.utils.nmf import tensor_nmf
    rng = np.random.default_rng(42)
    with tempfile.TemporaryDirectory() as empty:
        _, Y_train, _ = load_data(empty, rng)
    W0, V0 = tensor_nmf(Y_train, NEMBEDS, rng=rng)
    return Y_train, W0, V0, ep_from_nmf(Y_train, W0, V0)


def kernel_phase(dev, Y, W0, V0, pol):
    """Every kernel at every shape of the paths: agreement with its plain
    version, two launches bit-identical, device and host time, bound."""
    from functionalmf_tpu_torch.ops import fused_ll_bench as B
    try:
        records = B.run_cases(B.path_cases(dev, Y, W0, V0, pol))
    except AssertionError as exc:
        fail(str(exc))
    for rec in records:
        print(B.format_record(rec))
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


def check_launches(tag, launches, want):
    """The kernels in ``want`` launched on the path, the others did not."""
    for name, cnt in launches.items():
        if (cnt > 0) != (name in want):
            fail(f"{tag}: kernel {name} launched {cnt} times on this path; "
                 f"expected launches of exactly {list(want)}")


def check_results(tag, res, model, nchains, nsamples):
    """The JAX package's keys and shapes, finite draws, every draw and the
    final state feasible."""
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


def politics_run(tag, argv, nchains, nsamples, Y_train):
    """The port's politics app on the card, EP on, through its entry point;
    returns the kernels' launches on this run and its sweeps."""
    from functionalmf_tpu_torch.apps.politics import benchmark
    from functionalmf_tpu_torch.ops import fused_ll as F
    with tempfile.TemporaryDirectory() as empty:    # the synthetic tensor
        args = benchmark.parse_args(
            ["--no-pgds", "--device", "cuda", "--data-dir", empty,
             "--nthin", "1", "--nsamples", str(nsamples),
             "--nchains", str(nchains)] + argv)
        F.reset_launch_counts()
        out = benchmark.run(args)
    launches = dict(F.launch_counts)
    check_launches(tag, launches, ("fused_row_ll_ep", "fused_col_block_ll_ep"))
    check_results(tag, out.results, out.model, nchains, nsamples)
    if out.model.Mu_ep is None:
        fail(f"{tag}: EP is off")
    # the chain left the warm start: no collected draw equals it
    S = nchains * nsamples
    moved = []
    for key, x0 in zip(("W", "V"), out.warm_start):
        d = np.abs(out.results[key] - x0.astype(np.float32)).reshape(S, -1)
        if not (d.max(axis=1) > 0).all():
            fail(f"{tag}: a collected {key} draw equals the warm start")
        moved.append(f"{key} {d.mean() / np.abs(x0).mean():.4f}")
    r_btf = out.table["BTF"]["rmse_in"]
    r_emp = out.table["Empirical mean"]["rmse_in"]
    if not r_btf < r_emp:
        fail(f"{tag}: BTF in-sample RMSE {r_btf:.4f} is not below the "
             f"empirical mean's {r_emp:.4f}")
    print(f"politics {tag}: sweeps={out.nsweeps} "
          f"seconds={out.gibbs_seconds:.3f} "
          f"sweeps_per_sec={out.nsweeps / out.gibbs_seconds:.3f} "
          f"nmf_seconds={out.nmf_seconds:.3f} rmse_in={r_btf:.4f} "
          f"(empirical mean {r_emp:.4f}) "
          f"rmse_out={out.table['BTF']['rmse_out']:.4f} "
          f"(smoke values: a cold timer over the app's first sweeps)")
    print(f"politics {tag}: mean |draw - warm start| / mean |warm start|: "
          f"{', '.join(moved)}")
    # the rate, from more sweeps of the same, warmed model
    t0 = time.perf_counter()
    out.model.run_gibbs(Y_train, nburn=WARM_SWEEPS - 1, nthin=1, nsamples=1,
                        verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"politics {tag} warmed: sweeps={WARM_SWEEPS} seconds={dt:.3f} "
          f"sweeps_per_sec={WARM_SWEEPS / dt:.3f}")
    print(f"launches politics {tag}: {json.dumps(launches)} in "
          f"{out.nsweeps} sweeps")
    return launches, out.nsweeps


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
    check_launches(tag, launches, ("fused_row_ll", "fused_col_block_ll"))
    check_results(tag, res, model, nchains, nsamples)
    print(f"slice {tag}: sweeps={nsweeps} seconds={dt:.3f}")
    print(f"sweeps_per_sec {tag}: {nsweeps / dt:.3f}")
    print(f"nan_fallbacks {tag}: {res['nan_fallbacks'].tolist()}")
    print(f"launches {tag}: {json.dumps(launches)} in {nsweeps} sweeps")
    if nchains > 1:
        print(f"rhat {tag}: max={res['rhat'].get('max')}")
    return res, launches


def agreement_phase(dev, v_schedule, ep):
    """A small model on the card (kernels) and on the CPU (plain versions):
    same posterior mean of Mu up to Monte Carlo error, the rel < 0.12
    criterion of tests/test_constrained.py:347 and 441."""
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
    ep_approx = ((Mu + rng.normal(0, 0.1, Mu.shape), np.full(Mu.shape, 8.0))
                 if ep else None)
    means = {}
    for d in (dev, "cpu"):
        mod = Model(
            n_, m_, T_, poisson_loglik, C, device=d, nembeds=k_, tf_order=0,
            sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
            gass_ngrid=24, v_block_size=3, v_schedule=v_schedule, seed=7,
            ep_approx=ep_approx, loglikelihood_cellfn=F.POISSON)
        res = mod.run_gibbs(Y, nburn=400, nthin=1, nsamples=400,
                            verbose=False)
        mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        if mu.min() < -1e-5 or not np.isfinite(mu).all():
            fail(f"agreement run on {d}: infeasible or non-finite draws")
        means[str(d)] = mu.mean(0)
    rel = float(np.abs(means[str(dev)] - means["cpu"]).mean()
                / np.sqrt((Mu ** 2).mean()))
    print(f"agreement card vs cpu ({v_schedule}, ep={ep}): rel={rel:.4f} "
          "(limit 0.12)")
    if not rel < 0.12:
        fail(f"card and CPU posteriors disagree (rel={rel:.4f})")


def politics_agreement(dev, pol, nburn=20, nsamples=20):
    """The politics tensor at full width, seq schedule, on the card
    (kernels) and on the CPU (plain versions), both started at half the
    warm start's rates (V0 / 2), with EP centred on the warm start at a
    sigma the model does not call overconfident (ep_from_mf's multiplier
    mode: three times the warm start's RMS error). Each chain must leave
    its start, and the two posterior means of Mu, averaged over time per
    pair, must agree: rel < 0.12 of the warm start's RMS pair mean. (With
    the app's own sigma the chain stays near the warm start, so an update
    that never moved would pass the path's RMSE gate.)"""
    from functionalmf_tpu_torch import (
        ConstrainedNonconjugateBayesianTensorFiltering as Model)
    from functionalmf_tpu_torch.apps.politics.benchmark import (
        rowcol_cellfn, rowcol_loglikelihood)
    from functionalmf_tpu_torch.utils.ep import ep_from_mf
    Y_train, W0, V0, _ = pol
    ep = ep_from_mf(Y_train, W0, V0, mode="multiplier", multiplier=3,
                    verbose=False)
    Con = np.concatenate([np.eye(NDEPTH), np.zeros((NDEPTH, 1))], axis=1)
    pair = lambda mu: mu.mean(-1)
    ref = pair(np.einsum("nk,mtk->nmt", W0, V0))
    scale = np.sqrt((ref ** 2).mean())
    start = pair(np.einsum("nk,mtk->nmt", W0, V0 / 2))
    means = {}
    for d in (dev, "cpu"):
        mod = Model(
            NROWS, NCOLS, NDEPTH, rowcol_loglikelihood, Con, device=d,
            nembeds=NEMBEDS, tf_order=2, sigma2_init=0.5, lam2_init=0.1,
            ep_approx=ep, W_init=W0, V_init=V0 / 2, seed=0,
            v_block_size=BLOCK, v_schedule="seq",
            loglikelihood_cellfn=rowcol_cellfn)
        t0 = time.perf_counter()
        res = mod.run_gibbs(Y_train, nburn=nburn, nthin=1, nsamples=nsamples,
                            verbose=False)
        dt = time.perf_counter() - t0
        mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        if mu.min() < -1e-5 or not np.isfinite(mu).all():
            fail(f"politics agreement on {d}: infeasible or non-finite draws")
        means[str(d)] = pair(mu.mean(0))
        moved = float(np.abs(means[str(d)] - start).mean() / scale)
        print(f"politics agreement on {d}: {nburn + nsamples} sweeps in "
              f"{dt:.3f}s, moved {moved:.4f} from its start")
        if not moved > 0.25:
            fail(f"politics agreement on {d}: the chain stayed near its "
                 f"start (moved {moved:.4f}, at least 0.25 expected)")
    rel = float(np.abs(means[str(dev)] - means["cpu"]).mean() / scale)
    print(f"agreement card vs cpu (politics {NROWS}x{NCOLS}x{NDEPTH}, seq, "
          f"EP sigma {float(ep[1].flat[0]):.4f}): rel={rel:.4f} "
          "(limit 0.12)")
    if not rel < 0.12:
        fail(f"politics: card and CPU posteriors disagree (rel={rel:.4f})")


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
    pol = politics_problem()

    _, l1 = slice_run(dev, Y, Con, W0, V0, nchains=1, nburn=100,
                      nsamples=100)
    slice_run(dev, Y, Con, W0, V0, nchains=4, nburn=20, nsamples=20)
    # the politics app's default schedule first: its launches are the EP
    # kernels' record
    l_ep, s_ep = politics_run("seq nchains=1", ["--nburn", "30"], 1, 30,
                              pol[0])
    politics_run("redblack nchains=4",
                 ["--v-schedule", "redblack", "--nburn", "20"], 4, 20, pol[0])
    politics_run("joint nchains=1", ["--v-block-size", "0", "--nburn", "3"],
                 1, 3, pol[0])
    agreement_phase(dev, "redblack", ep=False)
    agreement_phase(dev, "seq", ep=True)
    politics_agreement(dev, pol)
    # last: torch.profiler, which times the kernels, slows every later
    # launch of the process on the host; the recipe once more shows how much
    records = kernel_phase(dev, Y, W0, V0, pol)
    print("red-black recipe again, after the profiled kernel phase:")
    slice_run(dev, Y, Con, W0, V0, nchains=1, nburn=20, nsamples=20)

    # launches and launches per sweep of each kernel's main path: the
    # bench.py recipe at nchains=1 (200 sweeps), politics seq (EP)
    launches = {**l1, **{k: v for k, v in l_ep.items() if k.endswith("_ep")}}
    sweeps = {k: (s_ep if k.endswith("_ep") else 200) for k in launches}
    kernels = []
    for name in RECORD_SHAPE:
        mine = [r for r in records if r["name"] == name]
        rec = next(r for r in mine if RECORD_SHAPE[name] in r["shape"])
        kernels.append(dict(
            name=name, route="cuda",
            source="functionalmf_tpu_torch/csrc/fused_ll.cu",
            replaces=REPLACES[name.removesuffix("_ep")],
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=rec["device_us"] / 1e3, plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_us"] / 1e3, bound_by=rec["bound_by"],
            library_ms=None, shape=rec["shape"],
            device_us=rec["device_us"], bound_us=rec["bound_us"],
            host_us=rec["host_us"], event_ms=rec["event_ms"],
            launches_per_sweep=launches[name] / sweeps[name],
            device_us_by_shape={r["shape"]: r["device_us"] for r in mine}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
