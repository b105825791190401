"""Drive the PyTorch/CUDA port on one NVIDIA GPU through its paths and check
them: the red-black constrained-Poisson recipe (grid and shrink GASS), the
GDELT politics benchmark with EP centring and its NegBinom and PGDS arms,
the conjugate and Polya-Gamma families (the flu-trends app, Gaussian and
Binomial models at the GDELT width), the black-box-likelihood paths (the
dose-response app with its U hook in both flavours, Row_constraints and a
device hook on the Poisson recipe, checkpoint/resume, ESS), PGDS and the
Poisson example.

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
  5. shrink: the red-black recipe with gass_method="shrink" at full width;
     both non-EP kernels must launch (one candidate an item), every draw
     finite and feasible;
  6. Gaussian: the port's flu-trends app on its synthetic 50x1x370 tensor
     (--nembeds 5 10, tf_order=2, 60 + 40 sweeps each) and a Gaussian model
     at 19x19x228, k=5, nchains 1 and 4 (30 + 20 sweeps): finite draws, the
     JAX package's keys and shapes (nu2 (S, 1)), in-sample RMSE below the
     data's standard deviation, pivot repairs and failsafe events per
     chain; the run fails if the failsafe events (Gershgorin shifts and
     non-finite fallbacks) exceed 1% of the factored blocks;
  7. Binomial on synthetic (Y, N) and NegBinom through the politics app's
     --nb arm, both at 19x19x228, k=5: finite draws, R > 1, the JAX
     package's keys and shapes, nan_fallbacks == 0;
  8. agreement: models run on the card (kernels) and on the CPU (plain
     versions) must reach the same posterior mean of Mu (rel < 0.12; 400
     draws from 4 chains of 120 + 100 sweeps):
     small models of the red-black recipe (grid and shrink), of the seq
     schedule with EP and of the Gaussian, Binomial and NegBinom families,
     and the politics tensor at full width (seq, EP at a sigma the model
     does not call overconfident), started at half the warm start's rates;
  9. black-box likelihoods (no cell function: the fused kernels' counters
     must stay 0 on these paths, plain PyTorch lifted by torch.func.vmap):
     the dose-response app through its entry point on its own simulation
     at full width (simulate(k=5, n=100, m=50, t=9, r=6, p=20, seed=42),
     written and read back as CSV; --nembeds 5 --tf_order 2 --features
     --sample_features, the device-side U hook, 20 + 20 sweeps): every
     draw finite, every curve constraint ([0, 1], softened monotone) and
     every row constraint (W U^T in [0, 1]) holds at every collected draw,
     U (nsamples, p, k) moved from its start, W and V moved from the NMF
     start; at that model's state, the lifted candidate log-likelihoods of
     the W update and of both V rounds (EP term included) against a Python
     loop of the app's one-item likelihood, for 3 rows and 3 columns of
     101 candidates each; the same model with the host hook for 5 + 5
     sweeps, from the same host fits; the app on its default simulation
     (8x11x9, r=6, no features, 4 chains of 10 + 15 sweeps, --nbins 10) on
     the card and on the CPU: posterior means of Mu within rel < 0.12;
     Row_constraints with a device hook that rewrites
     them every sweep on the red-black Poisson recipe at 19x19x228 (both
     non-EP kernels must launch; every draw satisfies the curve
     constraints and the row constraints its sweep ran under);
     checkpoint/resume of that recipe on the card (a run cut in two
     equals the whole run exactly); NonconjugateBayesianTensorFiltering
     (ESS) with a Poisson log-link likelihood at 19x19x228 (finite draws)
     and at a toy shape on the card and on the CPU (rel < 0.12);
     PGDS: the politics app with its in-process PGDS arm (no --no-pgds;
     60 + 10 sweeps, seq + EP), PGDS draws finite, Mu >= 0, factor columns
     summing to 1 within 1e-4, a finite "Schein et al (2016)" row and the
     BTF checks of phase 4 on the PGDS warm start; fit_pgds timed over 50
     + 50 warmed sweeps; PGDS on the card and on the CPU at 8x7x20, K=3
     (posterior-mean rates within twice the spread of two CPU seeds) and
     the binary mode on the card; the Poisson example through its main at
     k=3, seed 1, 100 + 100 sweeps an arm: the 9-metric table finite,
     every Poisson-BTF draw positive, its V rounds two seq rounds of 8 and
     a tail of 4, exactly one row and three column launches of the non-EP
     kernels a sweep and none of the EP ones; each of these phases prints
     its seconds;
 10. where the time goes: ms a sweep of every phase of the new paths
     (nu2 or Polya-Gamma draw, R moves, priors, W update, V update split
     into band assembly, equilibrate + retile, factor scan, solve scans;
     the PGDS sampler's eight steps at 19x19x228, K=5 and 11x12x20, K=3),
     each with a synchronise around it;
 11. kernels: each of the four kernels (row and column-block, each with and
     without EP) against its plain PyTorch version on the card, at every
     shape the paths launch it at (functionalmf_tpu_torch/ops/
     fused_ll_bench.py: 19x19x228, k=5, 101 candidates and again with one,
     the shrink method's shape; the W update at
     nchains 1 and 4; column blocks of 8 in a colour phase at nchains 1
     and 4 and in a seq round, the 4-wide tail, the joint update's 228,
     and a joint update at T=1000 on synthetic counts; the Poisson
     example's 11x12x20, k=3: R=11, a seq round and the tail of 12
     columns), NaN y at held-out pairs; the EP variants with the politics path's own EP (the app's NMF
     warm start and ep_from_nmf sigma) and candidates around the warm
     start; rtol=1e-5 / atol=1e-3 (the sums run in another order); two
     launches on the same inputs must agree bit for bit; each kernel's
     device time (torch.profiler), the wrapper's host time, its bound on
     an H100 and its share of it; then the launches, device time and host
     waits a sweep of the new paths but the row-constraints recipe and
     ESS, and of a PGDS sweep at both widths (torch.profiler). Last, because
     torch.profiler slows every later launch of the process on the host.
After each group of phases a line gives the seconds elapsed so far. The
line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""
import contextlib
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
# the small card-vs-CPU agreement runs: 400 draws from 4 chains of
# 120 + 100 sweeps (a sweep costs the host the same at 1 chain and at 4)
AGREE = dict(nchains=4, nburn=120, nsamples=100)
RECIPE_SWEEPS = 100       # the red-black recipe's timed run at nchains=1
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


def kernel_phase(dev, Y, W0, V0, pol, example):
    """Every kernel at every shape of the paths, the Poisson example's
    (``example`` = its data and NMF warm start) included: agreement with
    its plain version, two launches bit-identical, device and host time,
    bound."""
    from functionalmf_tpu_torch.ops import fused_ll_bench as B
    try:
        records = B.run_cases(B.path_cases(dev, Y, W0, V0, pol)
                              + B.example_cases(dev, *example))
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


def politics_run(tag, argv, nchains, nsamples, Y_train, pgds=False):
    """The port's politics app on the card, EP on, through its entry point
    (``pgds``: with its in-process PGDS arm as the warm start's target);
    returns the kernels' launches on this run, its sweeps and the run."""
    from functionalmf_tpu_torch.apps.politics import benchmark
    from functionalmf_tpu_torch.ops import fused_ll as F
    with tempfile.TemporaryDirectory() as empty:    # the synthetic tensor
        args = benchmark.parse_args(
            ["--no-pgds"] * (not pgds)
            + ["--device", "cuda", "--data-dir", empty,
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
    return launches, out.nsweeps, out


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


def agreement_phase(dev, v_schedule, ep, gass_method="grid"):
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
            nchains=AGREE["nchains"],
            ep_approx=ep_approx, gass_method=gass_method,
            loglikelihood_cellfn=F.POISSON)
        res = mod.run_gibbs(Y, nburn=AGREE["nburn"], nthin=1,
                            nsamples=AGREE["nsamples"], verbose=False)
        mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        if mu.min() < -1e-5 or not np.isfinite(mu).all():
            fail(f"agreement run on {d}: infeasible or non-finite draws")
        means[str(d)] = mu.mean(0)
    rel = float(np.abs(means[str(dev)] - means["cpu"]).mean()
                / np.sqrt((Mu ** 2).mean()))
    print(f"agreement card vs cpu ({v_schedule}, ep={ep}, {gass_method}): "
          f"rel={rel:.4f} (limit 0.12)")
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


def synthetic_mu():
    """A smooth 19x19x228 mean tensor of rank 5 with entries of order 1
    (seed 42): the Gaussian phase's truth and the Binomial phase's logits."""
    rng = np.random.default_rng(42)
    W = rng.normal(0, 1, size=(NROWS, NEMBEDS))
    W[np.triu_indices(NEMBEDS, k=1)] = 0
    V = np.cumsum(rng.normal(0, 0.08, size=(NCOLS, NDEPTH, NEMBEDS)), axis=1) \
        + rng.normal(0, 0.5, size=(NCOLS, 1, NEMBEDS))
    return np.einsum("nk,mtk->nmt", W, V), rng


def family_shapes(n, m, T, k, nchains, nsamples, nu2, R=None):
    """The JAX package's results dict of a conjugate-family model
    (tf_order=2): chain-major draws, scalars as (S, 1)."""
    S = nchains * nsamples
    out = {"W": (S, n, k), "V": (S, m, T, k), "sigma2": (S, 1),
           "lam2": (S, 1), "Tau2": (S, m, 3 * T - 1), "nu2": (S,) + nu2,
           "nan_fallbacks": (nchains,), "pivot_repairs": (nchains,)}
    if R is not None:
        out["R"] = (S,) + R
    if nchains > 1:
        out["rhat"] = None
    return out


def check_family(tag, res, want, nsweeps, inf_ok=()):
    """Keys, shapes and finite draws (``inf_ok``: keys that may hold inf,
    the Binomial nu2 at cells without data), and the failsafe events per
    chain: they must stay below 1% of the blocks the V update factored."""
    if set(res) != set(want):
        fail(f"{tag}: results keys {sorted(res)} != {sorted(want)}")
    for key, shape in want.items():
        if shape is None:
            continue
        if tuple(res[key].shape) != shape:
            fail(f"{tag}: results[{key!r}] has shape {res[key].shape}, "
                 f"expected {shape}")
        bad = np.isnan(res[key]) if key in inf_ok else ~np.isfinite(res[key])
        if bad.any():
            fail(f"{tag}: non-finite draws in {key}")
    nch = want["nan_fallbacks"][0]
    m, T = want["V"][1], want["V"][2]
    blocks = nsweeps * m * -(-T // 8)                 # a chain
    print(f"{tag}: pivot_repairs per chain {res['pivot_repairs'].tolist()}, "
          f"failsafe events (Gershgorin shifts + non-finite fallbacks) per "
          f"chain {res['nan_fallbacks'].tolist()}, of {blocks} factored "
          f"blocks a chain in {nsweeps} sweeps, {nch} chain(s)")
    if (res["nan_fallbacks"] > 0.01 * blocks).any():
        fail(f"{tag}: failsafe events above 1% of the factored blocks: a "
             "materially perturbed V conditional")


def timed_run(model, data, nburn, nsamples):
    """run_gibbs after a 2-sweep warm-up; returns (results, sweeps/s)."""
    model.run_gibbs(data, nburn=1, nthin=1, nsamples=1, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.run_gibbs(data, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False)
    torch.cuda.synchronize()
    return res, (nburn + nsamples) / (time.perf_counter() - t0)


def flutrends_phase():
    """The port's flu-trends app through its entry point, on the card."""
    from functionalmf_tpu_torch.apps.flutrends import benchmark
    nburn, nsamples = 60, 40
    with tempfile.TemporaryDirectory() as empty:      # the synthetic tensor
        args = benchmark.parse_args(
            ["--device", "cuda", "--data-dir", empty, "--nembeds", "5", "10",
             "--nburn", str(nburn), "--nthin", "1", "--nsamples",
             str(nsamples)])
        t0 = time.perf_counter()
        table, fits = benchmark.run(args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        Y = benchmark.load_data(empty, np.random.default_rng(args.seed))[0]
    if Y.shape != (50, 1, 370):
        fail(f"flutrends: data shape {Y.shape}")
    for k, row in table.items():
        res, model = fits[k]
        if model.device.type != "cuda":
            fail("flutrends: the model is not on the card")
        check_family(f"flutrends k={k}", res,
                     family_shapes(50, 1, 370, k, 1, nsamples, (1,)),
                     nburn + nsamples)
        if not all(np.isfinite(v) for v in row.values()):
            fail(f"flutrends k={k}: non-finite report {row}")
        if not row["rmse_in"] < Y.std():
            fail(f"flutrends k={k}: in-sample RMSE {row['rmse_in']:.4f} is "
                 f"not below the data's standard deviation {Y.std():.4f}")
        print(f"flutrends k={k}: " + " ".join(
            f"{a}={b:.4f}" for a, b in row.items())
            + f" nu2={res['nu2'].mean():.4f} (data sd {Y.std():.4f})")
    print(f"flutrends: {2 * (nburn + nsamples)} sweeps and the report in "
          f"{dt:.3f}s (cold: the first sweeps load cuSOLVER)")
    return Y


def gaussian_phase(dev, nchains, nburn=30, nsamples=20):
    from functionalmf_tpu_torch import GaussianBayesianTensorFiltering
    Mu, rng = synthetic_mu()
    Y = Mu[..., None] + rng.normal(0, 0.5, size=Mu.shape + (2,))
    Y[rng.random((NROWS, NCOLS)) < 0.1] = np.nan
    model = GaussianBayesianTensorFiltering(
        NROWS, NCOLS, NDEPTH, device=dev, nembeds=NEMBEDS, tf_order=2,
        sigma2_init=0.5, lam2_init=0.1, nu2_init=1, seed=0, nchains=nchains)
    res, rate = timed_run(model, Y, nburn, nsamples)
    tag = f"gaussian nchains={nchains}"
    check_family(tag, res, family_shapes(NROWS, NCOLS, NDEPTH, NEMBEDS,
                                         nchains, nsamples, (1,)),
                 nburn + nsamples + 2)
    mu = np.einsum("snk,smtk->nmt", res["W"], res["V"]) / res["W"].shape[0]
    obs = ~np.isnan(Y[..., 0])
    rmse = float(np.sqrt(np.mean((Y.mean(-1)[obs] - mu[obs]) ** 2)))
    sd = float(np.nanstd(Y))
    print(f"{tag}: sweeps={nburn + nsamples} sweeps_per_sec={rate:.3f} "
          f"rmse_in={rmse:.4f} (data sd {sd:.4f}) "
          f"nu2={res['nu2'].mean():.4f} (truth 0.25)")
    if not rmse < sd:
        fail(f"{tag}: in-sample RMSE {rmse:.4f} is not below the data's "
             f"standard deviation {sd:.4f}")
    return model, Y


def binomial_phase(dev, nburn=25, nsamples=15):
    from functionalmf_tpu_torch import BinomialBayesianTensorFiltering
    Mu, rng = synthetic_mu()
    N = rng.choice([5.0, 20.0, 80.0], size=Mu.shape)    # both PG branches
    Y = rng.binomial(N.astype(int), 1 / (1 + np.exp(-Mu))).astype(float)
    hold = rng.random((NROWS, NCOLS)) < 0.1
    Y[hold] = np.nan
    N[hold] = np.nan
    model = BinomialBayesianTensorFiltering(
        NROWS, NCOLS, NDEPTH, device=dev, nembeds=NEMBEDS, tf_order=2,
        sigma2_init=0.5, lam2_init=0.1, seed=0)
    res, rate = timed_run(model, (Y, N), nburn, nsamples)
    check_family("binomial", res, family_shapes(
        NROWS, NCOLS, NDEPTH, NEMBEDS, 1, nsamples,
        (NROWS, NCOLS, NDEPTH)), nburn + nsamples + 2, inf_ok=("nu2",))
    if res["nan_fallbacks"].sum() != 0:
        fail(f"binomial: nan_fallbacks {res['nan_fallbacks'].tolist()}")
    if not np.isinf(res["nu2"][:, hold]).all():
        fail("binomial: nu2 is not inf at the cells without data")
    P = 1 / (1 + np.exp(-np.clip(np.einsum(
        "snk,smtk->snmt", res["W"], res["V"]), -10, 10))).mean(0)
    err = float(np.abs(P - 1 / (1 + np.exp(-Mu)))[~hold].mean())
    print(f"binomial: sweeps={nburn + nsamples} sweeps_per_sec={rate:.3f} "
          f"mean |P_hat - P| = {err:.4f}")
    if not err < 0.15:
        fail(f"binomial: mean |P_hat - P| = {err:.4f}, 0.15 at most expected")
    return model, (Y, N)


def negbinom_phase(nburn=10, nsamples=10):
    """NegBinom through the politics app's --nb arm, on the card."""
    from functionalmf_tpu_torch.apps.politics import benchmark
    with tempfile.TemporaryDirectory() as empty:
        args = benchmark.parse_args(
            ["--no-pgds", "--nb", "--device", "cuda", "--data-dir", empty,
             "--nthin", "1", "--nburn", str(nburn), "--nsamples",
             str(nsamples)])
        t0 = time.perf_counter()
        out = benchmark.run(args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    res, model = out.nb_results, out.nb_model
    if model.device.type != "cuda":
        fail("negbinom: the model is not on the card")
    check_family("negbinom (politics --nb)", res, family_shapes(
        NROWS, NCOLS, NDEPTH, NEMBEDS, 1, nsamples, (NROWS, NCOLS, NDEPTH),
        R=(1, 1, 1)), nburn + nsamples, inf_ok=("nu2",))
    if res["nan_fallbacks"].sum() != 0:
        fail(f"negbinom: nan_fallbacks {res['nan_fallbacks'].tolist()}")
    if not (res["R"] > 1).all():
        fail(f"negbinom: R <= 1 in a draw (min {res['R'].min()})")
    row = out.table["NB-BTF"]
    if not all(np.isfinite(v) for v in row.values()):
        fail(f"negbinom: non-finite report {row}")
    print(f"negbinom (politics --nb): both arms, {2 * (nburn + nsamples)} "
          f"sweeps and the report in {dt:.3f}s; R={res['R'].mean():.4f} "
          + " ".join(f"{a}={b:.4f}" for a, b in row.items()))
    return model


def shrink_phase(dev, Y, Con, W0, V0, nburn=10, nsamples=10):
    """The red-black recipe with gass_method="shrink" at full width."""
    from functionalmf_tpu_torch import (
        ConstrainedNonconjugateBayesianTensorFiltering as Model)
    from functionalmf_tpu_torch.ops import fused_ll as F
    model = Model(
        NROWS, NCOLS, NDEPTH, poisson_loglik, Con, device=dev,
        nembeds=NEMBEDS, tf_order=2, sigma2_init=0.5, lam2_init=0.1,
        W_init=W0, V_init=V0, gass_method="shrink", seed=0,
        v_schedule="redblack", v_block_size=BLOCK,
        loglikelihood_cellfn=F.POISSON)
    model.run_gibbs(Y, nburn=1, nthin=1, nsamples=1, verbose=False)
    torch.cuda.synchronize()
    F.reset_launch_counts()
    t0 = time.perf_counter()
    res = model.run_gibbs(Y, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(F.launch_counts)
    nsweeps = nburn + nsamples
    check_launches("shrink", launches, ("fused_row_ll", "fused_col_block_ll"))
    check_results("shrink", res, model, 1, nsamples)
    moved = np.abs(np.diff(res["V"], axis=0)).reshape(nsamples - 1, -1)
    if not (moved.max(axis=1) > 0).all():
        fail("shrink: two successive V draws are equal")
    # an update is 1 launch for the current points and 1 an iteration
    w_it = launches["fused_row_ll"] / nsweeps - 1
    v_it = launches["fused_col_block_ll"] / (3 * nsweeps) - 1
    print(f"shrink: sweeps={nsweeps} seconds={dt:.3f} "
          f"sweeps_per_sec={nsweeps / dt:.3f}; launches "
          f"{json.dumps(launches)}: {w_it:.2f} shrink iterations a W "
          f"update, {v_it:.2f} a V round (each ends on a host sync)")
    return model


def family_agreement(dev, family):
    """A small model of a conjugate family on the card and on the CPU: the
    posterior mean of Mu (of the success probability for the Polya-Gamma
    families) within rel < 0.12 of its RMS."""
    import functionalmf_tpu_torch as P
    n_, m_, T_, k_ = 8, 6, 12, 2
    rng = np.random.default_rng(9)
    W = rng.normal(size=(n_, k_))
    W[np.triu_indices(k_, 1)] = 0
    V = np.cumsum(rng.normal(0, 0.4, size=(m_, T_, k_)), axis=1)
    Mu = np.einsum("nk,mtk->nmt", W, V)
    kw = dict(nembeds=k_, tf_order=1, sigma2_init=0.5, lam2_init=0.1, seed=7,
              nchains=AGREE["nchains"])
    link = lambda x: 1 / (1 + np.exp(-np.clip(x, -10, 10)))
    if family == "gaussian":
        cls, kw = P.GaussianBayesianTensorFiltering, dict(kw, nu2_init=1.0)
        data = Mu[..., None] + rng.normal(0, 0.5, size=Mu.shape + (3,))
        stat, truth = (lambda mu, res: mu), Mu
    elif family == "binomial":
        cls = P.BinomialBayesianTensorFiltering
        N = np.full(Mu.shape, 20.0)
        data = (rng.binomial(20, link(Mu)).astype(float), N)
        stat, truth = (lambda mu, res: link(mu)), link(Mu)
    else:
        cls = P.NegativeBinomialBayesianTensorFiltering
        kw = dict(kw, rdims=(1, 2))
        data = rng.poisson(rng.gamma(3.0, np.exp(0.5 * Mu)[..., None] / 3.0,
                                     size=Mu.shape + (3,))).astype(float)
        stat = lambda mu, res: np.log(res["R"] * link(mu) / (1 - link(mu)))
        truth = 0.5 * Mu
    means = {}
    for d in (dev, "cpu"):
        res = cls(n_, m_, T_, device=d, **kw).run_gibbs(
            data, nburn=AGREE["nburn"], nthin=1, nsamples=AGREE["nsamples"],
            verbose=False)
        mu = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
        s = stat(mu, res)
        if not np.isfinite(s).all():
            fail(f"{family} agreement run on {d}: non-finite draws")
        if res["nan_fallbacks"].sum() != 0:
            fail(f"{family} agreement run on {d}: nan_fallbacks "
                 f"{res['nan_fallbacks'].tolist()}")
        means[len(means)] = s.mean(0)
    scale = np.sqrt((truth ** 2).mean())
    rel = float(np.abs(means[0] - means[1]).mean() / scale)
    fit = float(np.abs(means[0] - truth).mean() / scale)
    print(f"agreement card vs cpu ({family}): rel={rel:.4f} (limit 0.12); "
          f"card vs truth {fit:.4f}")
    if not rel < 0.12:
        fail(f"{family}: card and CPU posteriors disagree (rel={rel:.4f})")


# ----------------------------------------------------------------------
# black-box likelihoods: the dose-response app, Row_constraints and hooks,
# checkpoint/resume, ESS
# ----------------------------------------------------------------------
DOSE_SIM = dict(k=5, n=100, m=50, t=9, r=6, p=20, seed=42)
DOSE_SWEEPS = (20, 20)          # burn-in, draws: the device-side hook
DOSE_HOST_SWEEPS = (5, 5)       # the host hook
DOSE_AGREE = dict(nchains=4, nburn=10, nsamples=15)
# rows and columns whose lifted candidate log-likelihoods are held against
# a Python loop of the user's one-item function, and the tolerance for
# every candidate: |lifted - loop| <= LIFT_RTOL * (|ll| + |ep|) + LIFT_ATOL
# * cells, ll the user's value, ep the EP log-density that is taken from it
# and cells the (row, column, time) cells the item covers. Both are float32
# sums in another order; inside a cell the Gamma terms (lgamma(shape),
# shape log(scale): hundreds each) cancel, which is what LIFT_ATOL allows
LIFT_ROWS, LIFT_COLS = (0, 41, 97), (0, 23, 49)
LIFT_RTOL, LIFT_ATOL = 1e-5, 2e-4


def check_no_launches(tag, launches):
    if any(launches.values()):
        fail(f"{tag}: a fused kernel launched ({launches}) on a path "
             "without a cell function")
    print(f"launches {tag}: {json.dumps(launches)}: 0 as expected, this "
          "path has no cell function (plain PyTorch lifted by "
          "torch.func.vmap, as the JAX path is plain XLA)")


def check_dose_draws(tag, Ws, Vs, Us, U0, warm_start, tol=1e-4):
    """Every collected draw: finite, Mu in [0, 1], softened monotone
    (Mu[t] - Mu[t+1] >= -1e-2), W U^T in [0, 1]; U, W and V moved."""
    for name, x in (("W", Ws), ("V", Vs), ("U", Us)):
        if not np.isfinite(x).all():
            fail(f"{tag}: non-finite draws in {name}")
    mu = np.einsum("snk,smtk->snmt", Ws, Vs)
    if mu.min() < -tol or mu.max() > 1 + tol:
        fail(f"{tag}: a draw leaves [0, 1] (Mu in [{mu.min():.6f}, "
             f"{mu.max():.6f}])")
    step = (mu[..., :-1] - mu[..., 1:]).min()
    if step < -1e-2 - tol:
        fail(f"{tag}: a draw violates the softened monotonicity "
             f"(min Mu[t] - Mu[t+1] = {step:.6f}, limit -0.01)")
    wu = np.einsum("snk,spk->snp", Ws, Us)
    if wu.min() < -tol or wu.max() > 1 + tol:
        fail(f"{tag}: a draw violates the row constraints (W U^T in "
             f"[{wu.min():.6f}, {wu.max():.6f}])")
    S = Ws.shape[0]
    if Us.shape != (S,) + U0.shape:
        fail(f"{tag}: U draws have shape {Us.shape}, expected "
             f"{(S,) + U0.shape}")
    moved = {}
    for name, x, x0 in (("U", Us, U0), ("W", Ws, warm_start[0]),
                        ("V", Vs, warm_start[1])):
        d = np.abs(x - x0.astype(np.float32)).reshape(S, -1).max(axis=1)
        if not (d > 0).all():
            fail(f"{tag}: a collected {name} draw equals its start")
        moved[name] = float(np.abs(x - x0).mean() / np.abs(x0).mean())
    print(f"doseresponse {tag}: {S} draws finite and feasible: Mu in "
          f"[{mu.min():.5f}, {mu.max():.5f}], min step {step:.5f}, W U^T in "
          f"[{wu.min():.5f}, {wu.max():.5f}]; mean |draw - start| / mean "
          f"|start|: " + ", ".join(f"{a} {b:.4f}" for a, b in moved.items()))


def lifted_loglik_gate(model, data, dev):
    """The black-box contract at the app's full width on the card: the
    candidate log-likelihoods that the W update and each V round get from
    the lifted (torch.func.vmap) call, EP term included, against a Python
    loop of the user's one-item function over the same candidates, for a
    few rows and columns. A lifted call that drops the EP term, indexes
    another row or rebuilds the curve around the wrong block fails here."""
    from functionalmf_tpu_torch.ops.fused_ll import ep_log_density
    n, m, k, G = model.nrows, model.ncols, model.nembeds, model.gass_ngrid + 1
    pdata = model.prepare_data(data)
    user_ll, (mu, sig) = model.loglikelihood, model._ep
    gen = torch.Generator(device=dev).manual_seed(0)
    W = (model._state["W"] * model._wmask).contiguous()       # (1, n, k)
    V = model._state["V"]                                     # (1, m, T, k)
    dmask = model._wmask.expand(1, n, k).reshape(n, k)
    worst = {}

    def jitter(x):          # G candidates around each item's current value
        z = torch.randn((x.shape[0], G) + x.shape[1:], generator=gen,
                        device=dev)
        return x[:, None] * (1 + 0.05 * z)

    def one(ll, ep):
        return float(ll), float(ep.sum())

    def hold(tag, got, parts, cells):
        got, (ll, ep) = got.cpu().numpy(), np.array(parts).T
        want = ll - ep
        if not np.isfinite(got).all() or np.ptp(want) == 0:
            fail(f"lifted {tag}: non-finite or constant log-likelihoods")
        tol = LIFT_RTOL * (np.abs(ll) + np.abs(ep)) + LIFT_ATOL * cells
        err = np.abs(got - want)
        worst[tag] = dict(max_abs_err=float(err.max()),
                          of_tolerance=float((err / tol).max()),
                          mean_abs_ep=float(np.abs(ep).mean()))
        if not (err <= tol).all():
            fail(f"lifted {tag}: |lifted - loop| reaches {err.max():.3e}, "
                 f"{(err / tol).max():.2f} of its tolerance; loop values in "
                 f"[{want.min():.4g}, {want.max():.4g}]")

    cands = jitter(W[0]) * dmask[:, None]                     # (n, G, k)
    got = model._w_loglik_blackbox(pdata, V, dmask)(cands)
    want = []
    for i in LIFT_ROWS:
        for w_g in cands[i]:
            tau = torch.einsum("k,mtk->mt", w_g, V[0])
            want.append(one(
                user_ll(pdata, tau, w_g, V[0], row=torch.tensor(i, device=dev)),
                ep_log_density(tau, mu[i], sig[i])))
    hold("W update", got[list(LIFT_ROWS)].reshape(-1), want, m * model.ndepth)

    for ph in model._phases:
        s0, e0 = ph.starts[0], ph.starts[0] + ph.size
        cands = jitter(V[0][:, s0:e0])                        # (m, G, size, k)
        got = model._v_loglik_blackbox(pdata, W, V, ph)(
            cands.reshape(m, G, -1))
        want = []
        for j in LIFT_COLS:
            for Vb_g in cands[j]:
                V_g = torch.cat([V[0, j, :s0], Vb_g, V[0, j, e0:]])
                tau = torch.einsum("tk,nk->nt", V_g, W[0])
                want.append(one(
                    user_ll(pdata, tau, W[0], V_g,
                            col=torch.tensor(j, device=dev)),
                    ep_log_density(tau, mu[:, j], sig[:, j])))
        hold(f"V round t={s0}:{e0}", got[list(LIFT_COLS)].reshape(-1), want,
             n * model.ndepth)
    print(f"lifted log-likelihoods vs a loop of the user's function "
          f"({len(LIFT_ROWS)} rows, {len(LIFT_COLS)} columns, {G} candidates "
          f"each; tolerance {LIFT_RTOL} (|ll| + |ep|) + {LIFT_ATOL} cells): "
          + json.dumps({k_: {a: float(f"{b:.3e}") for a, b in v.items()}
                        for k_, v in worst.items()}))


def doseresponse_phase(dev):
    """The dose-response app through its entry point at full width, the
    device-side U hook; then the host hook on a model the app builds."""
    from functionalmf_tpu_torch.apps.doseresponse import fit, sim
    from functionalmf_tpu_torch.ops import fused_ll as F
    nburn, nsamples = DOSE_SWEEPS
    with tempfile.TemporaryDirectory() as d:
        sim.write_csv(sim.simulate(**DOSE_SIM), d)
        argv = ["--data", f"{d}/data.csv", "--features", f"{d}/features.csv",
                "--sample_features", "--outdir", f"{d}/out", "--nembeds", "5",
                "--tf_order", "2", "--device", "cuda", "--nthin", "1"]
        args = fit.parse_args(argv + ["--nburn", str(nburn), "--nsamples",
                                      str(nsamples)])
        F.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out = fit.run(args)
        launches = dict(F.launch_counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        saved = {name: np.load(f"{d}/out/{name}.npy")
                 for name in ("btf", "btf_w", "btf_v", "btf_u", "btf_mono")}
    model, res, Y, X = out["model"], out["results"], out["Y"], out["X"]
    n, m, T, r = Y.shape
    p, k = out["U0"].shape
    if (n, m, T, r, p, k) != (98, 50, 9, 6, 20, 5):
        fail(f"doseresponse: shapes {(n, m, T, r, p, k)}")
    if model.device.type != "cuda" or model.loglikelihood_cellfn is not None:
        fail("doseresponse: the model is not the black-box model on the card")
    check_no_launches("doseresponse", launches)
    if saved["btf_u"].shape != (nsamples, p, k) or \
            saved["btf"].shape != (nsamples, n, m, T):
        fail(f"doseresponse: saved shapes {saved['btf_u'].shape}, "
             f"{saved['btf'].shape}")
    check_dose_draws("device hook", res["W"], res["V"], out["U_samples"],
                     out["U0"], out["warm_start"])
    if not model.check_constraints():
        fail("doseresponse: the final state violates its constraints")
    lifted_loglik_gate(model, dict(out["data"],
                                   U=model.Row_constraints[:p, :k]), dev)
    rep = out["report"]["mae_in"]
    print(f"doseresponse device hook: {n}x{m}x{T}x{r}, p={p}, k={k}; "
          f"sweeps={out['nsweeps']} seconds={out['gibbs_seconds']:.3f} "
          f"sweeps_per_sec={out['nsweeps'] / out['gibbs_seconds']:.3f} "
          f"(cold); peak device memory {peak:.3f} GiB; set-up (3 NMF fits, "
          f"EP) {out['nmf_seconds']:.1f}s; "
          f"in-sample MAE posterior mean {rep['Posterior mean']:.5f}, "
          f"monotone NMF {rep['Monotone NMF']:.5f}, NMF {rep['NMF']:.5f}")

    # the rate of each hook flavour from warmed sweeps of the same model.
    # The device hook keeps U in the prepared data, which a run does not
    # give back: a later run continues from the U in the state's
    # Row_constraints, [U | 0; -U | -1], which the current W is feasible for
    def data():
        return dict(out["data"], U=model.Row_constraints[:p, :k])

    hook = fit.make_traced_u_step(X, dev)
    t0 = time.perf_counter()
    run_sweeps(model, data, WARM_SWEEPS, traced_callback=hook)
    dt_dev = time.perf_counter() - t0
    # the host hook, on a model of its own built by the app from the same
    # host fits (NMF warm start, EP)
    hb, hs = DOSE_HOST_SWEEPS
    hargs = fit.parse_args(argv + ["--host-callback", "--nburn", str(hb),
                                   "--nsamples", str(hs)])
    hmodel, U0 = fit.init_model(Y, out["likelihood"], hargs, X=X,
                                warm=out["fits"]["warm"])
    start = (hmodel.W.copy(), hmodel.V.copy())
    hdata = {"Y": Y, "X": X, "U": U0}
    F.reset_launch_counts()
    hres = hmodel.run_gibbs(hdata, nburn=hb, nthin=1, nsamples=hs,
                            verbose=False, collect_data_keys=("U",),
                            callback=fit.make_u_step(hargs, X, dev))
    check_no_launches("doseresponse host hook", dict(F.launch_counts))
    check_dose_draws("host hook", hres["W"], hres["V"], hres["U"], U0, start)
    if not hmodel.check_constraints():
        fail("doseresponse host hook: the final state violates its "
             "constraints")
    t0 = time.perf_counter()
    run_sweeps(hmodel, hdata, WARM_SWEEPS,
               callback=fit.make_u_step(hargs, X, dev))
    dt_host = time.perf_counter() - t0
    print(f"doseresponse warmed, {WARM_SWEEPS} sweeps each: device hook "
          f"sweeps_per_sec={WARM_SWEEPS / dt_dev:.3f}, host hook "
          f"sweeps_per_sec={WARM_SWEEPS / dt_host:.3f}")
    return model, data, hook


def doseresponse_agreement(dev):
    """The app on its default simulation (no features), on the card and on
    the CPU (from the card run's host fits: the NMF baselines, the warm
    start and EP do not depend on the device): the posterior means of Mu
    within rel < 0.12 of its RMS."""
    from functionalmf_tpu_torch.apps.doseresponse import fit, sim
    from functionalmf_tpu_torch.ops import fused_ll as F
    means, maes, fits = {}, {}, None
    with tempfile.TemporaryDirectory() as d:
        sim.write_csv(sim.simulate(), d)
        for device in ("cuda", "cpu"):
            args = fit.parse_args(
                ["--data", f"{d}/data.csv", "--outdir", f"{d}/{device}",
                 "--nembeds", "3", "--nbins", "10", "--device", device,
                 "--nchains", str(DOSE_AGREE["nchains"]), "--nburn",
                 str(DOSE_AGREE["nburn"]), "--nsamples",
                 str(DOSE_AGREE["nsamples"])])
            F.reset_launch_counts()
            t0 = time.perf_counter()
            out = fit.run(args, fits=fits)
            fits = out["fits"]
            dt = time.perf_counter() - t0
            if any(F.launch_counts.values()):
                fail("doseresponse agreement: a fused kernel launched")
            mu = np.einsum("znk,zmtk->znmt", out["results"]["W"],
                           out["results"]["V"])
            if not np.isfinite(mu).all() or mu.min() < -1e-4 \
                    or mu.max() > 1 + 1e-4:
                fail(f"doseresponse agreement on {device}: non-finite or "
                     "infeasible draws")
            means[device] = mu.mean(0)
            maes[device] = out["report"]["mae_in"]
            print(f"doseresponse agreement on {device}: "
                  f"{out['Y'].shape} in {dt:.1f}s")
    scale = np.sqrt((means["cpu"] ** 2).mean())
    rel = float(np.abs(means["cuda"] - means["cpu"]).mean() / scale)
    print(f"agreement card vs cpu (doseresponse 8x11x9, r=6, "
          f"{DOSE_AGREE['nchains']} chains): rel={rel:.4f} (limit 0.12); "
          f"in-sample MAE posterior mean card "
          f"{maes['cuda']['Posterior mean']:.5f} cpu "
          f"{maes['cpu']['Posterior mean']:.5f}, monotone NMF "
          f"{maes['cuda']['Monotone NMF']:.5f}")
    if not rel < 0.12:
        fail(f"doseresponse: card and CPU posteriors disagree (rel={rel:.4f})")


def rc_hook(state, pdata, gen, step):
    """A device-side hook that rewrites Row_constraints every sweep:
    w_a >= c for every embedding a and w_0 - w_1 >= c2, the offsets drawn
    just below what the chain's current W attains, so that the new rows
    hold for it and bind in the next sweep."""
    W = state["W"]
    nch, _, k = W.shape
    u = torch.rand((nch, 2), generator=gen, device=W.device)
    c = W.amin((1, 2)).clamp(max=0.0) - 0.01 - 0.1 * u[:, 0]
    c2 = (W[:, :, 0] - W[:, :, 1]).amin(1) - 0.01 - 0.1 * u[:, 1]
    RC = state["Row_constraints"].clone()
    RC[:, :k, k] = c[:, None]
    RC[:, k, k] = c2
    return dict(state, Row_constraints=RC), pdata


def rc_recipe_model(dev, Con, W0, V0):
    from functionalmf_tpu_torch import (
        ConstrainedNonconjugateBayesianTensorFiltering as Model)
    from functionalmf_tpu_torch.ops import fused_ll as F
    k = NEMBEDS
    mixed = np.zeros((1, k + 1))
    mixed[0, :2] = 1.0, -1.0
    RC = np.concatenate([np.concatenate([np.eye(k), np.zeros((k, 1))], 1),
                         mixed])
    RC[:, k] = -0.05
    RC[k, k] = float((W0[:, 0] - W0[:, 1]).min()) - 0.05
    model = Model(
        NROWS, NCOLS, NDEPTH, poisson_loglik, Con, device=dev,
        nembeds=k, tf_order=2, sigma2_init=0.5, lam2_init=0.1,
        W_init=W0, V_init=V0, gass_ngrid=NGRID, seed=0,
        v_schedule="redblack", v_block_size=BLOCK, Row_constraints=RC,
        loglikelihood_cellfn=F.POISSON)
    return model


def rc_recipe_phase(dev, Y, Con, W0, V0, nburn=10, nsamples=20):
    """Row_constraints, rewritten every sweep by a device-side hook, on
    the red-black Poisson recipe: the W update's candidates go through
    the row kernel, the V rounds' through the column kernel."""
    from functionalmf_tpu_torch.ops import fused_ll as F
    model = rc_recipe_model(dev, Con, W0, V0)
    run_sweeps(model, Y, 2, traced_callback=rc_hook)
    F.reset_launch_counts()
    t0 = time.perf_counter()
    res = model.run_gibbs(Y, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False, traced_callback=rc_hook,
                          collect_data_keys=("Row_constraints",))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(F.launch_counts)
    check_launches("row constraints", launches,
                   ("fused_row_ll", "fused_col_block_ll"))
    RCs = res.pop("Row_constraints")
    check_results("row constraints", res, model, 1, nsamples)
    k = NEMBEDS
    vals = np.einsum("snk,sjk->snj", res["W"], RCs[:, :, :k])
    own = float((vals - RCs[:, None, :, k]).min())
    # the sweep of draw s ran under the rows the hook wrote after draw s-1
    ran = float((vals[1:] - RCs[:-1, None, :, k]).min())
    if own < -1e-5 or ran < -1e-5:
        fail(f"row constraints: a draw violates its rows (slack {own:.3e} "
             f"against the rows written after it, {ran:.3e} against the "
             "rows its sweep ran under)")
    if not (np.abs(np.diff(RCs[:, :, k], axis=0)).max(axis=1) > 0).all():
        fail("row constraints: the hook did not rewrite the rows at a sweep")
    tight = float((vals[1:] - RCs[:-1, None, :, k]).min(axis=(1, 2)).mean())
    nsweeps = nburn + nsamples
    print(f"row constraints + device hook on the recipe: sweeps={nsweeps} "
          f"seconds={dt:.3f} sweeps_per_sec={nsweeps / dt:.3f}; launches "
          f"{json.dumps(launches)}; worst slack {ran:.2e} under the rows of "
          f"its sweep (mean over draws of the tightest row {tight:.4f})")
    return model


def resume_phase(dev, Y, Con, W0, V0, tmpdir):
    """Checkpoint/resume on the card: a run cut after 2 of 5 draws and
    resumed equals the whole run, bit for bit (state and hook rewritten
    Row_constraints included)."""
    kw = dict(nburn=4, nthin=2, verbose=False, traced_callback=rc_hook,
              collect_data_keys=("Row_constraints",))
    whole = rc_recipe_model(dev, Con, W0, V0)
    whole.max_sweeps_per_call = 3
    full = whole.run_gibbs(Y, nsamples=5, **kw)
    ck = f"{tmpdir}/chain.npz"
    first = rc_recipe_model(dev, Con, W0, V0)
    first.max_sweeps_per_call = 3
    first.run_gibbs(Y, nsamples=2, checkpoint_path=ck, **kw)
    second = rc_recipe_model(dev, Con, W0, V0)
    second.max_sweeps_per_call = 5
    resumed = second.run_gibbs(Y, nsamples=5, checkpoint_path=ck, resume=True,
                               **kw)
    for key in ("W", "V", "sigma2", "lam2", "Tau2", "Row_constraints"):
        if not np.array_equal(full[key], resumed[key]):
            d = np.abs(full[key] - resumed[key]).max()
            fail(f"resume: {key} of the resumed run differs from the whole "
                 f"run's (max abs difference {d:.3e})")
    if np.array_equal(full["V"][0], full["V"][-1]):
        fail("resume: the chain did not move")
    print("checkpoint/resume on the card: 14 sweeps cut after 8 and resumed "
          "equal the whole run exactly (W, V, sigma2, lam2, Tau2, "
          "Row_constraints)")


def ess_loglik(W, V, Y):
    """Poisson with a log link, for one chain; NaN = missing."""
    eta = torch.einsum("nk,mtk->nmt", W, V).clamp(-20.0, 20.0)
    nan = torch.isnan(Y)
    return torch.where(nan, 0.0, torch.where(nan, 0.0, Y) * eta
                       - torch.exp(eta)).sum()


def ess_phase(dev, nburn=100, nsamples=50):
    """NonconjugateBayesianTensorFiltering (elliptical slice sampling) at
    19x19x228 on the card, then card against CPU at a toy shape."""
    from functionalmf_tpu_torch import NonconjugateBayesianTensorFiltering
    from functionalmf_tpu_torch.ops import fused_ll as F
    Mu, rng = synthetic_mu()
    Y = rng.poisson(np.exp(np.clip(Mu, -3, 3))).astype(float)
    Y[rng.random((NROWS, NCOLS)) < 0.1] = np.nan
    model = NonconjugateBayesianTensorFiltering(
        NROWS, NCOLS, NDEPTH, ess_loglik, device=dev, nembeds=NEMBEDS,
        tf_order=2, sigma2_init=0.5, lam2_init=0.1, seed=0)
    F.reset_launch_counts()
    res, rate = timed_run(model, Y, nburn, nsamples)
    check_no_launches("ess", dict(F.launch_counts))
    want = {"W": (nsamples, NROWS, NEMBEDS),
            "V": (nsamples, NCOLS, NDEPTH, NEMBEDS), "sigma2": (nsamples, 1),
            "lam2": (nsamples, 1), "Tau2": (nsamples, NCOLS, 3 * NDEPTH - 1),
            "nan_fallbacks": (1,), "pivot_repairs": (1,)}
    if set(res) != set(want):
        fail(f"ess: results keys {sorted(res)} != {sorted(want)}")
    for key, shape in want.items():
        if tuple(res[key].shape) != shape or not np.isfinite(res[key]).all():
            fail(f"ess: results[{key!r}] has shape {res[key].shape} or is "
                 f"not finite (expected {shape})")
    if np.array_equal(res["V"][0], res["V"][-1]):
        fail("ess: the chain did not move")
    print(f"ess 19x19x228 k=5: sweeps={nburn + nsamples} "
          f"sweeps_per_sec={rate:.3f} nan_fallbacks "
          f"{res['nan_fallbacks'].tolist()}")

    # one embedding: with two, chains of this length sit in different
    # rotations of (W, V) and two CPU runs already differ by rel 0.10
    n_, m_, T_, k_ = 6, 5, 12, 1
    rng = np.random.default_rng(11)
    W = rng.normal(size=(n_, k_))
    W[np.triu_indices(k_, 1)] = 0
    V = np.cumsum(rng.normal(0, 0.3, size=(m_, T_, k_)), axis=1)
    truth = np.einsum("nk,mtk->nmt", W, V)
    Yt = rng.poisson(np.exp(truth)[..., None], size=truth.shape + (4,))
    Yt = Yt.sum(-1).astype(float)

    def toy_loglik(W, V, Y):            # 4 replicates summed
        eta = torch.einsum("nk,mtk->nmt", W, V).clamp(-20.0, 20.0)
        return (Y * eta - 4.0 * torch.exp(eta)).sum()

    means = {}
    for d in (dev, "cpu"):
        mod = NonconjugateBayesianTensorFiltering(
            n_, m_, T_, toy_loglik, device=d, nembeds=k_, tf_order=1,
            sigma2_init=0.5, lam2_init=0.1, seed=7, nchains=4)
        r = mod.run_gibbs(Yt, nburn=500, nthin=2, nsamples=250,
                          verbose=False)
        eta = np.einsum("znk,zmtk->znmt", r["W"], r["V"])
        if not np.isfinite(eta).all():
            fail(f"ess agreement on {d}: non-finite draws")
        means[str(d)] = eta.mean(0)
    scale = np.sqrt((truth ** 2).mean())
    rel = float(np.abs(means[str(dev)] - means["cpu"]).mean() / scale)
    fit = float(np.abs(means[str(dev)] - truth).mean() / scale)
    print(f"agreement card vs cpu (ess toy {n_}x{m_}x{T_}): rel={rel:.4f} "
          f"(limit 0.12); card vs truth {fit:.4f}")
    if not rel < 0.12:
        fail(f"ess: card and CPU posteriors disagree (rel={rel:.4f})")
    return model, Y


# ----------------------------------------------------------------------
# PGDS: the politics app's in-process arm, the sampler on the card and on
# the CPU, the Poisson example
# ----------------------------------------------------------------------
PGDS_APP_SWEEPS = (60, 10)      # burn-in, draws of the politics app's run
PGDS_TIMED_SWEEPS = (50, 50)    # fit_pgds warmed, timed (nthin=1)
PGDS_AGREE = dict(nburn=400, nthin=1, nsamples=200, seed=0)
# card against CPU on the recovery toy of tests/test_pgds.py: twice the
# spread of two CPU seeds of the port at these counts (RMS over cells of
# the posterior-mean rates' difference over the true rates' RMS, seeds 0
# and 1, measured on the CPU; three seeds read 0.1085 to 0.1306, and at
# 300 + 600 sweeps 0.0990 to 0.1123: the chains settle in different
# modes, so longer runs do not shrink it)
PGDS_SEED_SPREAD = 0.1085
EXAMPLE_SWEEPS = (100, 1, 100)  # the Poisson example: nburn, nthin, nsamples
# the sampler's steps, timed one by one: (method, label)
PGDS_STEPS = (("_impute", "impute"), ("_allocate", "allocate"),
              ("_factors", "A, B"), ("_backward", "backward pass"),
              ("_forward", "forward pass"), ("_pi", "Pi"),
              ("_delta", "delta"), ("_hyper", "nu, xi, beta"))


def phase_seconds(name, t0):
    print(f"phase seconds {name}: {time.perf_counter() - t0:.1f}")


def check_pgds_draws(tag, Mu, W, V, U, shape):
    """Finite draws of the expected shapes, Mu >= 0, the Dirichlet factor
    columns summing to 1."""
    S, (n, m, T), k = Mu.shape[0], shape, W.shape[-1]
    want = ((S, n, m, T), (S, n, k), (S, m, k), (S, T, k))
    if (Mu.shape, W.shape, V.shape, U.shape) != want:
        fail(f"{tag}: PGDS draws of shapes {Mu.shape}, {W.shape}, {V.shape},"
             f" {U.shape}; expected {want}")
    for name, x in (("Mu", Mu), ("W", W), ("V", V), ("U", U)):
        if not np.isfinite(x).all():
            fail(f"{tag}: non-finite PGDS draws in {name}")
    if Mu.min() < 0:
        fail(f"{tag}: a PGDS rate is negative ({Mu.min():.3e})")
    err = max(np.abs(W.sum(1) - 1).max(), np.abs(V.sum(1) - 1).max())
    if err > 1e-4:
        fail(f"{tag}: PGDS factor columns sum to 1 within {err:.2e} only")
    return err


def politics_pgds_phase(dev, pol):
    """The politics app with its in-process PGDS arm (the default, no
    --no-pgds) on its synthetic 19x19x228 tensor, seq + EP, then fit_pgds
    timed warmed; returns a PGDS sampler at that width for the phase times
    and the launch profile."""
    from functionalmf_tpu_torch.models.pgds import PGDSSampler
    from functionalmf_tpu_torch.pgds import fit_pgds
    nb, ns = PGDS_APP_SWEEPS
    _, _, out = politics_run("seq nchains=1, PGDS warm start",
                             ["--nburn", str(nb)], 1, ns, pol[0], pgds=True)
    Mu, (W, V, U) = out.pgds_draws
    err = check_pgds_draws("politics PGDS", Mu, W, V, U,
                           (NROWS, NCOLS, NDEPTH))
    row = out.table["Schein et al (2016)"]
    if not all(np.isfinite(v) for v in row.values()):
        fail(f"politics PGDS: non-finite report {row}")
    print(f"politics PGDS arm: {nb + ns} sweeps in {out.pgds_seconds:.3f}s "
          f"(cold, Mu on the host included); factor columns sum to 1 within "
          f"{err:.2e}; Schein et al (2016): "
          + " ".join(f"{a}={b:.4f}" for a, b in row.items()))
    nb, ns = PGDS_TIMED_SWEEPS
    t0 = time.perf_counter()
    fit_pgds(pol[0], NEMBEDS, nburn=nb, nthin=1, nsamples=ns, device=dev)
    dt = time.perf_counter() - t0
    print(f"fit_pgds 19x19x228 k=5 warmed: sweeps={nb + ns} seconds={dt:.3f}"
          f" sweeps_per_sec={(nb + ns) / dt:.3f} (the draws' copies and Mu "
          "on the host included)")
    sampler = PGDSSampler(pol[0], NEMBEDS, device=dev)
    sampler.run(1)
    return sampler


def recovery_problem():
    """tests/test_pgds.py:test_pgds_recovers_rates's data, 8x7x20."""
    rng = np.random.default_rng(3)
    N, M, T, K = 8, 7, 20, 2
    A = rng.dirichlet(np.ones(N) * 2, size=K).T
    B = rng.dirichlet(np.ones(M) * 2, size=K).T
    U = np.abs(np.cumsum(rng.normal(0, 1, (T, K)), axis=0)) + 5
    Mu = np.einsum("ik,jk,tk->ijt", A, B, U) * 8
    return rng.poisson(Mu).astype(float), Mu


def pgds_agreement(dev):
    """The PGDS posterior-mean rates on the card and on the CPU at a toy
    shape, within twice the spread of two CPU seeds; then the binary mode
    on the card."""
    from functionalmf_tpu_torch.pgds import fit_pgds
    Y, Mu = recovery_problem()
    means = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        M_, _ = fit_pgds(Y, 3, device=d, **PGDS_AGREE)
        if not np.isfinite(M_).all() or M_.min() < 0:
            fail(f"pgds agreement on {d}: non-finite or negative rates")
        means[str(d)] = M_.mean(0)
        print(f"pgds agreement on {d}: "
              f"{PGDS_AGREE['nburn'] + PGDS_AGREE['nsamples']} sweeps in "
              f"{time.perf_counter() - t0:.3f}s")
    scale = np.sqrt((Mu ** 2).mean())
    rel = float(np.sqrt(np.mean((means[str(dev)] - means["cpu"]) ** 2))
                / scale)
    fit = float(np.sqrt(np.mean((means[str(dev)] - Mu) ** 2)) / scale)
    limit = 2 * PGDS_SEED_SPREAD
    print(f"agreement card vs cpu (pgds 8x7x20, K=3): rel={rel:.4f} (limit "
          f"{limit:.4f}, twice the spread of two CPU seeds "
          f"{PGDS_SEED_SPREAD}); card vs truth {fit:.4f}")
    if not rel < limit:
        fail(f"pgds: card and CPU posteriors disagree (rel={rel:.4f})")
    rng = np.random.default_rng(5)
    P = rng.uniform(0.05, 0.9, (6, 5, 10))
    Yb = (rng.random(P.shape) < P).astype(float)
    Mb, _ = fit_pgds(Yb, 2, binary=True, nburn=50, nthin=1, nsamples=30,
                     seed=1, device=dev)
    if not np.isfinite(Mb).all() or Mb.min() < 0:
        fail("pgds binary mode on the card: non-finite or negative rates")
    m = Mb.mean(0)
    print(f"pgds binary mode on the card: 80 sweeps, rates finite; mean rate "
          f"{m[Yb > 0].mean():.4f} at ones, {m[Yb == 0].mean():.4f} at zeros")


def example_problem(seed=1, nembeds=3):
    """The Poisson example's data (seed 1, the first 3x3 curves held out)
    and its NMF warm start."""
    from functionalmf_tpu_torch.examples import poisson_tensor_filtering as E
    from functionalmf_tpu_torch.utils.nmf import tensor_nmf
    rng = np.random.default_rng(seed)
    W, V = E.create_piecewise_constant(rng)
    Mu = np.einsum("nk,mtk->nmt", W, V)
    Y = rng.poisson(Mu[..., None], size=Mu.shape + (1,)).astype(float)
    Y[:3, :3] = np.nan
    W0, V0 = tensor_nmf(Y, nembeds, rng=rng)
    return Y[..., 0], W0, V0


def poisson_example_phase():
    """The Poisson example through its main on the card at k=3, seed 1 and
    reduced counts: the 9-metric table finite, every Poisson-BTF draw
    positive, the non-EP kernels (and not the EP ones) launched once for
    the W update and once for each of the three seq rounds a sweep."""
    import os
    from functionalmf_tpu_torch.examples import poisson_tensor_filtering as E
    from functionalmf_tpu_torch.ops import fused_ll as F
    nburn, nthin, nsamples = EXAMPLE_SWEEPS
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)                 # it saves data/poisson_tensor_filtering
        try:
            F.reset_launch_counts()
            out = E.main(["3", "1", "--device", "cuda"], nburn=nburn,
                         nthin=nthin, nsamples=nsamples)
            launches = dict(F.launch_counts)
        finally:
            os.chdir(cwd)
    table, res, model = out["table"], out["results"], out["model"]
    if table.shape != (len(E.METRICS), len(E.MODEL_NAMES)) or \
            not np.isfinite(table).all():
        fail(f"poisson example: table {table.shape}, finite "
             f"{np.isfinite(table).all()}")
    mu = np.einsum("snk,smtk->snmt", res["W"], res["V"])
    if mu.min() < -1e-5 or not np.isfinite(mu).all():
        fail(f"poisson example: a Poisson-BTF draw is negative or not "
             f"finite (min {mu.min():.3e})")
    rounds = [(ph.starts, ph.size) for ph in model._phases]
    if rounds != [([0], 8), ([8], 8), ([16], 4)]:
        fail(f"poisson example: V rounds {rounds}, expected two seq rounds "
             "of 8 and a tail of 4")
    check_launches("poisson example", launches,
                   ("fused_row_ll", "fused_col_block_ll"))
    sweeps = nburn + nthin * nsamples
    if (launches["fused_row_ll"], launches["fused_col_block_ll"]) != \
            (sweeps, 3 * sweeps):
        fail(f"poisson example: launches {launches} in {sweeps} sweeps; "
             "expected 1 row and 3 column launches a sweep")
    print(f"poisson example 11x12x20 k=3 seed 1 ({nburn} + {nthin} x "
          f"{nsamples} sweeps an arm): launches {json.dumps(launches)} in "
          f"{sweeps} Poisson-BTF sweeps (rounds {rounds}); seconds "
          + json.dumps({k: round(v, 3) for k, v in out["seconds"].items()}))
    for name, col in zip(out["names"], table.T):
        print(f"poisson example {name}: " + " ".join(
            f"{m['name']}={v:.4f}" for m, v in zip(E.METRICS, col)))


def pgds_time_goes(tag, sampler, sweeps=5):
    """ms a sweep of each step of the PGDS sampler, a synchronise around
    each."""
    totals = {}
    with contextlib.ExitStack() as stack:
        for name, label in PGDS_STEPS:
            stack.enter_context(timed(sampler, name, label, totals, True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.run(sweeps)
        torch.cuda.synchronize()
        totals["sweep (timed)"] = time.perf_counter() - t0
    ms = {label: 1e3 * t / sweeps for label, t in totals.items()}
    print(f"phases {tag} (ms a sweep, {sweeps} sweeps, a synchronise around "
          f"each): " + json.dumps({k: round(v, 3) for k, v in ms.items()}))
    missing = {label for _, label in PGDS_STEPS} - set(ms)
    if missing:
        fail(f"phases {tag}: no time for {sorted(missing)}")
    return ms


# where a sweep's time goes. (attribute of the model, phase label):
MODEL_PHASES = (
    ("_update_nu2", "nu2 draw"),
    ("_pg_update", "PG draw"),
    ("_update_R", "R moves"),
    ("_update_sigma2", "prior: sigma2"),
    ("_update_tau2", "prior: Tau2"),
    ("_update_lam2", "prior: lam2"),
    ("_gaussian_update_W", "W update"),
    ("_gaussian_update_V", "V update"),
    ("_v_bands", "V: band assembly"),
    ("_update_W_gass", "W update"),
    ("_update_V_gass", "V update"),
    ("_update_W_ess", "W update"),
    ("_update_V_ess", "V update"),
    ("_interweave_scales", "scale moves"),
)
# (function of ops/banded.py, phase label)
BANDED_PHASES = (
    ("equilibrate_bands", "V: equilibrate + retile"),
    ("retile_bands", "V: equilibrate + retile"),
    ("_block_banded_cholesky_once", "V: factor scan"),
    ("block_banded_solve_lower", "V: solve scans"),
    ("block_banded_solve_upper", "V: solve scans"),
)
# the phases every model of a path must show: a renamed method or routine
# fails the run and cannot drop a column unnoticed
PRIOR_PHASES = {"prior: sigma2", "prior: Tau2", "prior: lam2"}
BANDED_SWEEP = PRIOR_PHASES | {"W update", "V update", "V: band assembly"} \
    | {label for _, label in BANDED_PHASES}
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


@contextlib.contextmanager
def timed(owner, name, label, totals, instance):
    """Wrap owner.name in a timer with a synchronise before and after."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[label] = totals.get(label, 0.0) + time.perf_counter() - t0
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        if instance:
            delattr(owner, name)      # the instance attribute hid the method
        else:
            setattr(owner, name, fn)


def run_sweeps(model, data, sweeps, **run_kw):
    """``data`` may be a function of no arguments that gives the data for
    this run (data a hook rewrites must continue from the model's state)."""
    model.run_gibbs(data() if callable(data) else data, nburn=sweeps - 1,
                    nthin=1, nsamples=1, verbose=False, **run_kw)
    torch.cuda.synchronize()


def where_time_goes(tag, model, data, expect, sweeps=10, warm=2, hook=None):
    """ms a sweep of each phase the model runs and of the sweep as timed.
    The timers make the sweep slower than an untimed one: the figures say
    where the time goes, not how fast the sweep is. Phases nest: the V
    update holds its "V: ..." parts."""
    from functionalmf_tpu_torch.ops import banded
    totals = {}
    run_kw = {}
    if hook is not None:        # a device-side hook, timed as "hook"
        def timed_hook(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = hook(*args)
            torch.cuda.synchronize()
            totals["hook"] = totals.get("hook", 0.0) + time.perf_counter() - t0
            return out
        run_kw = dict(traced_callback=timed_hook)
    run_sweeps(model, data, warm, **run_kw)
    totals.clear()
    with contextlib.ExitStack() as stack:
        for name, label in MODEL_PHASES:
            if hasattr(model, name):
                stack.enter_context(timed(model, name, label, totals, True))
        for name, label in BANDED_PHASES:
            stack.enter_context(timed(banded, name, label, totals, False))
        t0 = time.perf_counter()
        run_sweeps(model, data, sweeps, **run_kw)
        totals["sweep (timed)"] = time.perf_counter() - t0
    ms = {label: 1e3 * t / sweeps for label, t in totals.items()}
    print(f"phases {tag} (ms a sweep, {sweeps} sweeps, a synchronise around "
          f"each): " + json.dumps({k: round(v, 3) for k, v in ms.items()}))
    if not expect <= set(ms):
        fail(f"phases {tag}: no time for {sorted(expect - set(ms))}")
    return ms


def launch_counts_phase(tag, model, data, sweeps=3, warm=2, hook=None):
    """A model's sweep under torch.profiler (:func:`profile_sweeps`)."""
    run_kw = {} if hook is None else dict(traced_callback=hook)
    return profile_sweeps(
        tag, lambda n: run_sweeps(model, data, n, **run_kw), sweeps, warm)


def profile_sweeps(tag, run, sweeps, warm):
    """A sweep's device kernels, device time, wall time and host-side
    waits from torch.profiler over ``run(sweeps)``, after ``run(warm)``:
    syncs (stream, device and event synchronises), memcpy
    (cudaMemcpyAsync calls: the bool() and .cpu() reads wait in these)
    and item_reads (aten::_local_scalar_dense)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run(warm)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(sweeps)
        wall = time.perf_counter() - t0
    kernels = device_us = syncs = memcpy = items = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            if not ev.key.lower().startswith(("memcpy", "memset")):
                kernels += ev.count
            device_us += ev.self_device_time_total
        elif ev.key in SYNC_CALLS:
            syncs += ev.count
        elif ev.key == "cudaMemcpyAsync":
            memcpy += ev.count
        elif ev.key == "aten::_local_scalar_dense":
            items += ev.count
    out = dict(kernels=kernels / sweeps, device_ms=device_us / sweeps / 1e3,
               wall_ms=wall / sweeps * 1e3, device_busy=device_us / 1e6 / wall,
               syncs=syncs / sweeps, memcpy=memcpy / sweeps,
               item_reads=items / sweeps, sweeps=sweeps)
    print(f"profile {tag} (a sweep, torch.profiler over {sweeps} sweeps): "
          + json.dumps({k: round(v, 3) for k, v in out.items()}))
    if out["kernels"] <= 0:
        fail(f"profile {tag}: torch.profiler saw no device kernel")
    return out


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
    t_start = time.perf_counter()

    def stamp(phase):
        print(f"elapsed after {phase}: {time.perf_counter() - t_start:.1f}s")

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
    stamp("the build and the politics warm start")

    _, l1 = slice_run(dev, Y, Con, W0, V0, nchains=1, nburn=RECIPE_SWEEPS // 2,
                      nsamples=RECIPE_SWEEPS // 2)
    slice_run(dev, Y, Con, W0, V0, nchains=4, nburn=20, nsamples=20)
    stamp("the red-black recipe")
    # the politics app's default schedule first: its launches are the EP
    # kernels' record
    l_ep, s_ep, _ = politics_run("seq nchains=1", ["--nburn", "30"], 1, 30,
                                 pol[0])
    politics_run("redblack nchains=4",
                 ["--v-schedule", "redblack", "--nburn", "20"], 4, 20, pol[0])
    politics_run("joint nchains=1", ["--v-block-size", "0", "--nburn", "3"],
                 1, 3, pol[0])
    stamp("the politics app")
    shrink_model = shrink_phase(dev, Y, Con, W0, V0)
    flu_Y = flutrends_phase()
    stamp("shrink and the flu-trends app")
    gauss_model, gauss_Y = gaussian_phase(dev, nchains=1)
    gaussian_phase(dev, nchains=4)
    binom_model, binom_data = binomial_phase(dev)
    nb_model = negbinom_phase()
    stamp("the Gaussian, Binomial and NegBinom models")
    agreement_phase(dev, "redblack", ep=False)
    agreement_phase(dev, "redblack", ep=False, gass_method="shrink")
    agreement_phase(dev, "seq", ep=True)
    stamp("the constrained model's small agreement runs")
    for family in ("gaussian", "binomial", "negbinom"):
        family_agreement(dev, family)
    stamp("the families' small agreement runs")
    politics_agreement(dev, pol)
    stamp("the politics agreement")
    dose_model, dose_data, dose_hook = doseresponse_phase(dev)
    stamp("the dose-response app")
    doseresponse_agreement(dev)
    stamp("the dose-response agreement")
    rc_model = rc_recipe_phase(dev, Y, Con, W0, V0)
    with tempfile.TemporaryDirectory() as tmpdir:
        resume_phase(dev, Y, Con, W0, V0, tmpdir)
    ess_model, ess_Y = ess_phase(dev)
    stamp("Row_constraints, resume and ESS")
    t0 = time.perf_counter()
    pgds_pol = politics_pgds_phase(dev, pol)
    phase_seconds("politics PGDS arm and fit_pgds timed", t0)
    t0 = time.perf_counter()
    pgds_agreement(dev)
    phase_seconds("PGDS card vs CPU and binary mode", t0)
    t0 = time.perf_counter()
    poisson_example_phase()
    example = example_problem()
    phase_seconds("the Poisson example", t0)
    stamp("PGDS and the Poisson example")
    # where the time goes on the new paths, with the models of the phases
    # above (warmed); the flu-trends shape through a model of its own
    from functionalmf_tpu_torch import GaussianBayesianTensorFiltering
    flu_model = GaussianBayesianTensorFiltering(
        50, 1, 370, device=dev, nembeds=10, tf_order=2, sigma2_init=1,
        lam2_init=0.1, nu2_init=1, seed=42)
    gass_sweep = {"W update", "V update", "scale moves"}
    profiled = (
        ("gaussian 19x19x228 k=5", gauss_model, gauss_Y,
         BANDED_SWEEP | {"nu2 draw"}, None),
        ("flutrends 50x1x370 k=10", flu_model, flu_Y,
         BANDED_SWEEP | {"nu2 draw"}, None),
        ("binomial 19x19x228 k=5", binom_model, binom_data,
         BANDED_SWEEP | {"PG draw"}, None),
        ("negbinom 19x19x228 k=5", nb_model, pol[0],
         BANDED_SWEEP | {"PG draw", "R moves"}, None),
        ("shrink recipe 19x19x228 k=5", shrink_model, Y,
         PRIOR_PHASES | gass_sweep, None),
        # lam2 is fixed by the dose-response app: no lam2 phase
        ("doseresponse 98x50x9x6 k=5, device hook", dose_model, dose_data,
         {"prior: sigma2", "prior: Tau2", "hook"} | gass_sweep, dose_hook),
        ("row constraints recipe 19x19x228 k=5, device hook", rc_model, Y,
         PRIOR_PHASES | gass_sweep | {"hook"}, rc_hook),
        ("ess 19x19x228 k=5", ess_model, ess_Y,
         PRIOR_PHASES | {"W update", "V update"}, None))
    for tag, model, data, expect, hook in profiled:
        where_time_goes(tag, model, data, expect, hook=hook)
    from functionalmf_tpu_torch.models.pgds import PGDSSampler
    pgds_ex = PGDSSampler(example[0], 3, device=dev)
    pgds_ex.run(1)
    t0 = time.perf_counter()
    for tag, sampler in (("pgds 19x19x228 k=5", pgds_pol),
                         ("pgds 11x12x20 k=3", pgds_ex)):
        pgds_time_goes(tag, sampler)
    phase_seconds("PGDS phase times", t0)
    stamp("the phase times")
    # last: torch.profiler, which times the kernels, slows every later
    # launch of the process on the host; the recipe once more shows how much
    records = kernel_phase(dev, Y, W0, V0, pol, example)
    stamp("the kernel phase")
    # not the last two (the row-constraints recipe is the red-black recipe
    # plus a hook of a few launches; ESS has no launch of its own to count):
    # a profiler window costs about 9 s whatever it holds
    for tag, model, data, _, hook in profiled[:-2]:
        launch_counts_phase(tag, model, data, hook=hook)
    t0 = time.perf_counter()
    for tag, sampler in (("pgds 19x19x228 k=5", pgds_pol),
                         ("pgds 11x12x20 k=3", pgds_ex)):
        profile_sweeps(tag, lambda n, s=sampler: (s.run(n),
                                                  torch.cuda.synchronize()),
                       sweeps=2, warm=1)
    phase_seconds("PGDS launch profiles", t0)
    stamp("the launch profiles")
    print("red-black recipe again, after the profiled kernel phase:")
    slice_run(dev, Y, Con, W0, V0, nchains=1, nburn=20, nsamples=20)

    # launches and launches per sweep of each kernel's main path: the
    # bench.py recipe at nchains=1, politics seq (EP)
    launches = {**l1, **{k: v for k, v in l_ep.items() if k.endswith("_ep")}}
    sweeps = {k: (s_ep if k.endswith("_ep") else RECIPE_SWEEPS)
              for k in launches}
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
