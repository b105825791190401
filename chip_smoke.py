"""Drive the PyTorch/CUDA port on one NVIDIA GPU through its two paths, the
red-black constrained-Poisson recipe and the GDELT politics benchmark with
EP centring, and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of functionalmf_tpu_torch/csrc from source;
  3. kernels: each of the four kernels (row and column-block, each with and
     without EP) against its plain PyTorch version on the card, at the
     paths' shapes (19x19x228, k=5, 101 candidates; column blocks of 8, the
     4-wide tail and the joint update's 228), NaN y at held-out pairs; the
     EP variants with the politics path's own EP (the app's NMF warm start
     and ep_from_nmf sigma, finite at the held-out pairs) and candidates
     around the warm start; rtol=1e-5 / atol=1e-3 (the sums run in another
     order); median times from CUDA events;
  4. red-black slice: the bench.py data (seed 42) and red-black recipe on
     the card, run_gibbs at nchains=1 and nchains=4; both non-EP kernels
     must have launched in each run, every draw must be finite and
     feasible, and the results must carry the JAX package's keys and
     shapes;
  5. politics: the port's app (functionalmf_tpu_torch.apps.politics.
     benchmark) on its synthetic 19x19x228 tensor, EP on, with the seq
     schedule (nchains=1), the red-black schedule (nchains=4) and the joint
     update; only the EP kernels may launch and both must, the draws must
     be finite, feasible and of the JAX package's shapes, every collected
     draw must differ from the warm start, and the BTF's in-sample RMSE
     must beat the empirical mean's (the warm start alone does: the app's
     EP is overconfident on this tensor and holds the chain near it);
     sweeps/s from the app's cold timer and from 20 more warmed sweeps;
  6. agreement: models run on the card (kernels) and on the CPU (plain
     versions) must reach the same posterior mean of Mu: small models of
     the red-black recipe and of the seq schedule with EP, and the
     politics tensor at full width (seq, EP at a sigma the model does not
     call overconfident), started at half the warm start's rates.
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
RTOL, ATOL = 1e-5, 1e-3
WARM_SWEEPS = 20
REPLACES = {"fused_row_ll": "functionalmf_tpu/ops/fused_ll.py:80",
            "fused_col_block_ll": "functionalmf_tpu/ops/fused_ll.py:138"}


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


def check_kernel(name, fn, plain, shape_note):
    """fn and plain on the same inputs: agreement and median ms of each."""
    got = fn()
    want = plain()
    torch.cuda.synchronize()
    err = compare(f"{name} ({shape_note})", got, want)
    ms = cuda_median_ms(fn)
    pms = cuda_median_ms(plain)
    print(f"kernel {name}: max_abs_err={err:.3e} ms={ms:.4f} "
          f"plain_ms={pms:.4f} ({shape_note})")
    return err, ms, pms


def kernel_phase(dev, Y, W0, V0, pol):
    from functionalmf_tpu_torch.ops import fused_ll as F
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    y_pol, Wp, Vp = t(pol[0]), t(pol[1]), t(pol[2])
    ep = tuple(t(e) for e in pol[3])
    G = NGRID + 1                      # grid candidates + the current point
    k = NEMBEDS
    C = NCOLS * NDEPTH
    records = {}

    def jitter(shape):                 # candidates within 10% of a state
        return torch.rand(shape, generator=gen, device=dev) * 0.2 + 0.9

    # W update: every row of one chain, C = m*T cells per row; without EP
    # the bench.py data, with EP the politics warm start and its EP
    cands = (torch.rand((NROWS, G, k), generator=gen, device=dev) * 0.4 + 0.8)
    cands = cands * torch.as_tensor(np.tril(np.ones((NROWS, k))) > 0,
                                    device=dev)[:, None, :]
    rc = torch.zeros(NROWS, dtype=torch.int32, device=dev)
    ri = torch.arange(NROWS, dtype=torch.int32, device=dev)
    for name, y, cw, bt, extras in (
            ("fused_row_ll", t(Y), cands, t(V0), ()),
            ("fused_row_ll_ep", y_pol, Wp[:, None, :] * jitter((NROWS, G, k)),
             Vp, ep)):
        y2 = y.reshape(NROWS, C).contiguous()
        bt = bt.reshape(1, C, k).contiguous()
        ex = tuple(e.reshape(NROWS, C).contiguous() for e in extras)
        err, ms, pms = check_kernel(
            name, lambda: F.fused_row_ll_batched(cw, bt, y2, rc, ri,
                                                 F.POISSON, ex),
            lambda: F.row_ll_plain(cw, bt, y2, rc, ri, F.POISSON, ex),
            f"R={NROWS}, G={G}, k={k}, C={C}")
        records[name] = dict(replaces=REPLACES["fused_row_ll"],
                             max_abs_err=err, ms=ms, plain_ms=pms)

    # V updates: a red-black colour phase (19 columns x 14 blocks of 8), a
    # sequential round (19 columns, one block of 8), the 4-wide tail and the
    # joint update (one block of 228); the JSON record times the shape its
    # path launches most: the colour phase without EP (the red-black
    # recipe), the sequential round with EP (the politics default)
    nb_full, rem = divmod(NDEPTH, BLOCK)
    shapes = (("red-black phase", [b * BLOCK for b in range(0, nb_full, 2)],
               BLOCK),
              ("seq round", [8 * BLOCK], BLOCK),
              ("tail", [nb_full * BLOCK], rem),
              ("joint", [0], NDEPTH))
    timed = {"fused_col_block_ll": "red-black phase",
             "fused_col_block_ll_ep": "seq round"}
    for name, y, w, extras in (("fused_col_block_ll", t(Y), t(W0), ()),
                               ("fused_col_block_ll_ep", y_pol, Wp, ep)):
        w = w[None].contiguous()
        errs = []
        for label, starts, Tb in shapes:
            P = NCOLS * len(starts)
            pc = torch.zeros(P, dtype=torch.int32, device=dev)
            pj = torch.arange(NCOLS, dtype=torch.int32,
                              device=dev).repeat_interleave(len(starts))
            pt = torch.as_tensor(starts * NCOLS, dtype=torch.int32,
                                 device=dev)
            if extras:
                tt = pt[:, None].long() + torch.arange(Tb, device=dev)
                c3 = Vp[pj[:, None].long(), tt][:, None] * jitter((P, G, Tb, k))
            else:
                c3 = (torch.rand((P, G, Tb, k), generator=gen, device=dev)
                      * 0.4 + 0.8)
            err, ms, pms = check_kernel(
                name, lambda: F.fused_col_block_ll_batched(
                    c3, w, y, pc, pj, pt, F.POISSON, extras),
                lambda: F.col_block_ll_plain(c3, w, y, pc, pj, pt,
                                             F.POISSON, extras),
                f"{label}: P={P}, G={G}, Tb={Tb}, k={k}")
            errs.append(err)
            if label == timed[name]:
                rec = dict(ms=ms, plain_ms=pms)
        records[name] = dict(replaces=REPLACES["fused_col_block_ll"],
                             max_abs_err=max(errs), **rec)
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
    returns the EP kernels' launches on this run."""
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
    print(f"launches politics {tag}: {json.dumps(launches)}")
    return launches


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
    print(f"launches {tag}: {json.dumps(launches)}")
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
    records = kernel_phase(dev, Y, W0, V0, pol)

    _, l1 = slice_run(dev, Y, Con, W0, V0, nchains=1, nburn=100,
                      nsamples=100)
    slice_run(dev, Y, Con, W0, V0, nchains=4, nburn=20, nsamples=20)
    # the politics app's default schedule first: its launches are the EP
    # kernels' record
    l_ep = politics_run("seq nchains=1", ["--nburn", "30"], 1, 30, pol[0])
    politics_run("redblack nchains=4",
                 ["--v-schedule", "redblack", "--nburn", "20"], 4, 20, pol[0])
    politics_run("joint nchains=1", ["--v-block-size", "0", "--nburn", "3"],
                 1, 3, pol[0])
    agreement_phase(dev, "redblack", ep=False)
    agreement_phase(dev, "seq", ep=True)
    politics_agreement(dev, pol)

    launches = {**l1, **{k: v for k, v in l_ep.items() if k.endswith("_ep")}}
    kernels = [dict(name=name, route="cuda",
                    source="functionalmf_tpu_torch/csrc/fused_ll.cu",
                    replaces=rec["replaces"], launches=launches[name],
                    max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                    plain_ms=rec["plain_ms"])
               for name, rec in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
