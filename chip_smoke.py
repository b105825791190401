"""Drive the PyTorch/CUDA port on one NVIDIA GPU through its paths and check
them: the red-black constrained-Poisson recipe (grid and shrink GASS), the
GDELT politics benchmark with EP centring and its NegBinom and PGDS arms,
the conjugate and Polya-Gamma families (the flu-trends app, Gaussian and
Binomial models at the GDELT width), the black-box-likelihood paths (the
dose-response app with its U hook in both flavours, Row_constraints and a
device hook on the Poisson recipe, checkpoint/resume, ESS), PGDS and the
Poisson example, BNP-CovReg (the flu-trends app's --bnp arm) and the
device mesh.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of functionalmf_tpu_torch/csrc from source, and
     the native host library (native/fmf_host.cpp, host c++; the NMF's
     NNLS and PAV) into functionalmf_tpu_torch/_build/, timed;
  3. red-black slice: the bench.py data (seed 42) and red-black recipe on
     the card, run_gibbs at nchains=1 and nchains=4; both non-EP kernels
     must have launched in each run, every draw must be finite and
     feasible, and the results must carry the JAX package's keys and
     shapes; then the device mesh (functionalmf_tpu_torch/parallel), its
     ranks spawned from this process after the build: (a) NCCL, a rank a
     card (world size = the cards there are; (1, 1) on one card), chains
     over dp, the recipe at nchains=4 through make_mesh and shard_state /
     gather_state, 10 + 10 sweeps: the draws equal the unsharded run on
     the card bit for bit; (b) four gloo ranks sharing the card, mesh
     (dp=2, mp=2), bench.py's generator at 20x20x228 (mp=2 divides 20),
     the red-black recipe and the seq schedule with EP, and the Gaussian,
     Binomial and NegBinom models on the Gaussian and Binomial phases'
     data at 20x20x228 and the recipe's counts, 1 + 1 sweeps each: every
     rank launches both kernels of its GASS path at its local shape
     (R=20, C=4560; P=280 or 20, Tb=8; the counters each rank sends back;
     the families none), all ranks return the same draws, a family's W,
     V, nu2 (and R) equal the unsharded run's on the card bit for bit, a
     GASS path's W and V agree with it within rtol = atol = 1e-3 but for
     picks that flip (at most 1% of the values), also after 5 more timed
     sweeps, every recipe draw feasible; the counts that differ, the
     phase's seconds, the sweeps/s on the mesh beside the unsharded run's
     and the collectives a sweep; (c) first two probes on the card, a
     rank's block of sums against the whole tensor's (torch.sum,
     _fixed_sum, _window_sum; the Gaussian W Gram by @ and _fixed_sum; the
     families' sites, old and fixed forms) and
     the fused kernels on a rank's items alone against the same items
     inside the unsharded launch (torch.equal; the fixed sums and the
     kernels may not differ); then the same four ranks, (2, 2): the
     dose-response model as the app builds it at 98x50x9x6, k=5, from a
     warm start made of
     the data (no NMF), on {Y, X, U} with the app's device U hook
     rewriting Row_constraints and U collected (both updates read the
     whole data at global indices), and on {Y} (row and column slabs,
     local positions), then ESS at 20x20x228, k=5, nchains=4, each 1 + 1
     sweeps against the unsharded run on the card (dose-response: at most
     1% of W, V and U beyond 1e-3, every draw inside its curve and row
     constraints; ESS: W and V within 1e-5), then 5 timed sweeps; and the
     recipe at 20x20x228 cut after 3 sweeps and resumed from its
     checkpoint, equal to the uncut mesh run bit for bit and, after its
     2 + 4 sweeps, held to the unsharded run as the dose-response model
     is, and a profiled sweep that leaves one trace a rank; one line a
     part (seconds, sweeps/s on the mesh and unsharded, collectives a
     sweep, the gathers that hand the hook the global state, the branch
     each update took, the count beyond 1e-3);
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
     package's keys and shapes, nan_fallbacks == 0; the NegBinom arm
     launches the Polya-Gamma kernel (csrc/polyagamma.cu) once a sweep,
     counted from 0 over the run and in its run record, and its last draw
     is held to the plain version on the same inputs and noise, on the
     card, within 4 float32 eps of the terms' magnitudes (a lane within
     rounding of an acceptance threshold left out), a second launch bit
     for bit (ops/polyagamma_bench.py);
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
     kernels a sweep and none of the EP ones; the Gaussian, Binomial and
     NegBinom examples at seed 1 through their own functions, 16 chains
     of one model each (1000 + 1000, 1000 + 500, 1000 + 500 sweeps): the
     mean over the chains of the held-out RMSE and the 90% coverage
     (Gaussian, over the chains that left the noise mode) or the held-out
     MAE within four standard errors of the JAX package's at the same
     seed and counts (on the CPU; kept in tests/examples_anchors.json), no
     fused kernel launched;
     BNP-CovReg: the flu-trends
     app with --bnp on its synthetic 50x1x370 tensor at L=10, k=20, 200
     iterations (the app's 10000 cut; 20 stored), beside 10 + 10 BTF
     sweeps at k=5: every stored mu and var_diag finite, var_diag > 0,
     shapes (20, 50, 370), no Cholesky failure (fit_bnp_covreg raises on
     one), in-sample RMSE of the BNP mean below the data's standard
     deviation, coverage finite; tests/test_bnp_covreg.py's recovery
     problem (8x60, L=4, k=4, c=30, 600 iterations, burn-in 200, seed 1)
     on the card: err_obs < 0.5 sd, err_miss < 2 sd, median var_diag in
     (0.25 sd^2, 10 sd^2); the same on the CPU at seeds 1 and 2, the card's
     posterior mean of mu within twice their spread; 4000 batched GP
     conditional draws on the card at N=25 against the dense float64
     moments; each of these phases prints its seconds;
 10. where the time goes: ms a sweep of every phase of the new paths
     (nu2 or Polya-Gamma draw, R moves, priors, W update, V update split
     into band assembly, equilibrate + retile, factor scan, solve scans;
     the PGDS sampler's eight steps at 19x19x228, K=5 and 11x12x20, K=3;
     BNP-CovReg's six steps at 50x370, L=10, k=20, and its untimed rate),
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
     columns; a (2, 2) mesh rank's at 20x20x228: R=20, C=4560 with and
     without EP, a colour phase's P=280 and a seq round's P=20 at Tb=8),
     NaN y at held-out pairs; the EP variants with the politics path's own EP (the app's NMF
     warm start and ep_from_nmf sigma) and candidates around the warm
     start; rtol=1e-5 / atol=1e-3 (the sums run in another order); two
     launches on the same inputs must agree bit for bit; each kernel's
     device time (torch.profiler), the wrapper's host time, its bound on
     an H100 and its share of it; then the launches, device time and host
     waits a sweep of the new paths but the row-constraints recipe and
     ESS, of a PGDS sweep at both widths and of a BNP-CovReg iteration at
     flu width (torch.profiler); the Polya-Gamma kernel's device time,
     host time and bound by bytes on that last draw's inputs and on them
     tiled to the NegBinom benchmark cell's 128 chains with noise of its
     own, beside the plain version's time. Last, because
     torch.profiler slows every later launch of the process on the host.
After each group of phases a line gives the seconds elapsed so far. The
line before the last is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""
import contextlib
import json
import os
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


def bench_data(nrows=NROWS, ncols=NCOLS):
    """bench.py:138-150, seed 42 (its 19 actors unless ``nrows``,
    ``ncols`` say otherwise): Y, the positivity constraints, W0, V0 and
    the true rate."""
    from functionalmf_tpu_torch.examples import recipe
    (Y, W0, V0), Mu = recipe.make_data(np.random.default_rng(42),
                                       (nrows, ncols, NDEPTH, NEMBEDS))
    Con = np.concatenate([np.eye(NDEPTH), np.zeros((NDEPTH, 1))], axis=1)
    return Y, Con, W0, V0, Mu


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
    (``example`` = its data and NMF warm start) and a (2, 2) mesh rank's
    at 20x20x228 (phase (b)) included: agreement with
    its plain version, two launches bit-identical, device and host time,
    bound."""
    from functionalmf_tpu_torch.ops import fused_ll_bench as B
    mp = mesh_problem()
    try:
        records = B.run_cases(B.path_cases(dev, Y, W0, V0, pol)
                              + B.example_cases(dev, *example)
                              + B.mesh_cases(dev, mp["Y"], mp["W0"],
                                             mp["V0"], mp["ep"]))
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


# ----------------------------------------------------------------------
# the device mesh (parallel/mesh.py): ranks spawned from this process
# ----------------------------------------------------------------------
MESH_N = 20              # phase (b)'s actors: mp=2 divides 20 rows and columns
MESH_TIMED = 5           # sweeps timed on the mesh and unsharded
MESH_DEADLINE_S = 300.0
# what each path of phase (b) must launch on every rank, and at which local
# shape (2 chains x 10 rows; 2 chains x 10 columns x 14 blocks); the
# conjugate families launch no fused kernel
MESH_PATHS = {
    "redblack": {"fused_row_ll": "R=20, C=4560",
                 "fused_col_block_ll": "P=280, Tb=8"},
    "seq+EP": {"fused_row_ll_ep": "R=20, C=4560",
               "fused_col_block_ll_ep": "P=20, Tb=8"},
    "gaussian": {},
    "binomial": {},
    "negbinom": {},
}
# phase (b)'s conjugate-family paths: held to the unsharded run bit for bit
MESH_FAMILIES = ("gaussian", "binomial", "negbinom")


# Phase (b)'s hold on the draws. A sharded sweep computes the unsharded
# one up to the rounding of its sums over mp and of the ranks' smaller
# batched calls; a GASS pick is discrete, so a candidate
# that sits at the slice's edge can flip, and then its whole block (or
# row) moves. At most this share of W's and of V's values may lie beyond
# rtol = atol = 1e-3 of the unsharded run; a partitioning fault (a wrong
# slab, slice or reduction) moves nearly all of them.
MESH_FAR_MAX = 0.01


def mesh_far_share(got, want):
    return float((np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).mean())


def recipe_model(dev, shape, Con, W0, V0, nchains, schedule="redblack",
                 ep=None, mesh=None):
    """The bench.py recipe (red-black, blocks of 8, ngrid 100, interweave
    and factor_rebalance on), or its seq schedule with EP centres."""
    from functionalmf_tpu_torch import (
        ConstrainedNonconjugateBayesianTensorFiltering as Model)
    from functionalmf_tpu_torch.ops import fused_ll as F
    return Model(*shape, poisson_loglik, Con, device=dev, nembeds=NEMBEDS,
                 tf_order=2, sigma2_init=0.5, lam2_init=0.1, W_init=W0,
                 V_init=V0, gass_ngrid=NGRID, seed=0, nchains=nchains,
                 v_schedule="redblack" if schedule == "redblack" else "seq",
                 v_block_size=BLOCK, ep_approx=ep, mesh=mesh,
                 loglikelihood_cellfn=F.POISSON)


def _mesh_rank(rank, world, url, backend, out, job, args):
    try:
        from functionalmf_tpu_torch.parallel.mesh import init_distributed
        init_distributed(url, world, rank, backend=backend,
                         timeout_s=MESH_DEADLINE_S)
        out.put((rank, "ok", globals()[job](rank, world, *args)))
    except BaseException:                                   # noqa: BLE001
        import traceback
        out.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(job, world, backend, *args):
    """``job(rank, world, *args)`` on ``world`` spawned ranks of one
    process group (a file:// rendezvous in a temporary directory); their
    results in rank order. A rank that fails, or a group past its
    deadline, fails the run; every rank process is ended."""
    import queue
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as rdv:
        url = "file://" + rdv + "/rendezvous"
        procs = [ctx.Process(target=_mesh_rank, args=(
            r, world, url, backend, out, job, args)) for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, []
        stop = time.monotonic() + MESH_DEADLINE_S
        try:
            while len(results) + len(errors) < world:
                if time.monotonic() > stop:
                    fail(f"mesh {job}: ranks did not finish in "
                         f"{MESH_DEADLINE_S} s")
                try:
                    rank, status, val = out.get(timeout=1.0)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        fail(f"mesh {job}: a rank died, exit codes "
                             f"{[p.exitcode for p in procs]}")
                    continue
                (results.__setitem__(rank, val) if status == "ok"
                 else errors.append(f"rank {rank}: {val}"))
            if errors:
                fail(f"mesh {job}:\n" + "\n".join(errors))
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [results[r] for r in range(world)]


def _numpy_results(res):
    return {k: v for k, v in res.items() if isinstance(v, np.ndarray)}


def nccl_rank(rank, world, Y, Con, W0, V0, nburn, nsamples):
    """Phase (a) on one rank: NCCL, a card a rank, chains over dp."""
    import torch.distributed as dist
    from functionalmf_tpu_torch.parallel.mesh import (
        gather_state, make_mesh, shard_state, state_specs)
    mesh = make_mesh(world, 1, device_type="cuda")
    one = torch.ones(1, device=mesh.device)
    dist.all_reduce(one)
    if int(one.item()) != world:
        raise RuntimeError(f"NCCL all_reduce gave {one.item()}, not {world}")
    model = recipe_model(mesh.device, Y.shape, Con, W0, V0, nchains=4,
                         mesh=mesh)
    whole = model.state
    specs = model.state_partition_specs()
    local = shard_state(whole, mesh, specs)
    back = gather_state(local, mesh, state_specs(mesh, specs, whole))
    round_trip = all(torch.equal(local[k], model._state[k])
                     and torch.equal(back[k], whole[k]) for k in whole)
    res = model.run_gibbs(Y, nburn=nburn, nthin=1, nsamples=nsamples,
                          verbose=False)
    return dict(res=_numpy_results(res), round_trip=round_trip,
                device=str(mesh.device))


def mesh_nccl_phase(dev, Y, Con, W0, V0, nburn=10, nsamples=10):
    """(a): NCCL at world size = the cards there are, chains over dp, the
    bench.py recipe at 19x19x228, nchains=4: the draws equal the unsharded
    run on the card bit for bit."""
    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    outs = spawn_mesh("nccl_rank", world, "nccl", Y, Con, W0, V0, nburn,
                      nsamples)
    ref = recipe_model(dev, Y.shape, Con, W0, V0, nchains=4).run_gibbs(
        Y, nburn=nburn, nthin=1, nsamples=nsamples, verbose=False)
    for r, o in enumerate(outs):
        if not o["round_trip"]:
            fail(f"mesh nccl rank {r}: shard_state/gather_state did not give "
                 "the model's slices and the global state back")
        for key, want in _numpy_results(ref).items():
            if not np.array_equal(o["res"][key], want):
                fail(f"mesh nccl rank {r}: {key} differs from the unsharded "
                     "run on the card")
    print(f"mesh (a) nccl world={world} mesh=({world}, 1) 19x19x228 "
          f"nchains=4, {nburn} + {nsamples} sweeps: draws equal to the "
          f"unsharded run bit for bit on {[o['device'] for o in outs]}")
    phase_seconds("mesh (a) NCCL", t0)


def mesh_problem():
    """Phase (b)'s data: bench.py's generator at 20x20x228, EP centres at
    the true rate, sigma sqrt(rate) + 0.5 (wide enough not to hold the
    chain); the Gaussian phase's data at 20x20x228 (``Yg``) and a fixed
    heteroskedastic nu2 for it (``nu2_het``); the Binomial phase's data
    at 20x20x228 (``YN``)."""
    Y, Con, W0, V0, M = bench_data(MESH_N, MESH_N)
    nu2_het = np.random.default_rng(7).uniform(0.1, 0.4,
                                               (MESH_N, MESH_N, NDEPTH))
    return dict(Y=Y, Con=Con, W0=W0, V0=V0, ep=(M, np.sqrt(M) + 0.5),
                Yg=gaussian_data(MESH_N, MESH_N), nu2_het=nu2_het,
                YN=binomial_data(MESH_N, MESH_N)[:2])


def mesh_path_model(path, dev, prob, mesh=None):
    """(model, data) of a phase (b) path, nchains=4 at 20x20x228: the
    recipe's (``redblack``, ``seq+EP``) or a conjugate family's: the
    Gaussian model with scalar, per-row (``gaussian_row``) or fixed
    heteroskedastic (``gaussian_hetero``) nu2 on the Gaussian phase's data,
    the Binomial model on the Binomial phase's, NegBinom (the politics
    ``--nb`` arm's kwargs, R sampled) on the recipe's counts."""
    import functionalmf_tpu_torch as fmf
    common = dict(device=dev, nembeds=NEMBEDS, tf_order=2, sigma2_init=0.5,
                  lam2_init=0.1, seed=0, nchains=4, mesh=mesh)
    shape = (MESH_N, MESH_N, NDEPTH)
    if path.startswith("gaussian"):
        nu2 = {"gaussian": dict(nu2_init=1),
               "gaussian_row": dict(nu2_init=1, nu2_mode="row"),
               "gaussian_hetero": dict(nu2_true=prob["nu2_het"])}[path]
        return fmf.GaussianBayesianTensorFiltering(
            *shape, **nu2, **common), prob["Yg"]
    if path == "binomial":
        return fmf.BinomialBayesianTensorFiltering(*shape, **common), \
            prob["YN"]
    if path == "negbinom":
        return fmf.NegativeBinomialBayesianTensorFiltering(
            *shape, nu2_init=1, rdims=(0, 1, 2), **common), prob["Y"]
    Y = prob["Y"]
    return recipe_model(dev, Y.shape, prob["Con"], prob["W0"], prob["V0"],
                        nchains=4, schedule=path, mesh=mesh,
                        ep=prob["ep"] if path == "seq+EP" else None), Y


def gloo_rank(rank, world, prob):
    """Phase (b) on one rank of four sharing the card: the (2, 2) mesh, the
    red-black recipe, the seq schedule with EP and the conjugate families
    (MESH_PATHS), 1 + 1 sweeps each; the launches and local shapes of the
    fused kernels, then
    MESH_TIMED timed sweeps with every collective counted and timed."""
    from functionalmf_tpu_torch.models import constrained as C
    from functionalmf_tpu_torch.ops import fused_ll as F
    from functionalmf_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(2, 2, device_type="cuda")
    shapes = set()
    real_row, real_col = C.fused_row_ll_batched, C.fused_col_block_ll_batched

    def row(cands, bt, *a):
        ep_on = bool(a[-1]) if len(a) > 4 else False
        shapes.add(("fused_row_ll" + "_ep" * ep_on,
                    f"R={cands.shape[0]}, C={bt.shape[1]}"))
        return real_row(cands, bt, *a)

    def col(cands, *a):
        ep_on = bool(a[-1]) if len(a) > 6 else False
        shapes.add(("fused_col_block_ll" + "_ep" * ep_on,
                    f"P={cands.shape[0]}, Tb={cands.shape[2]}"))
        return real_col(cands, *a)

    C.fused_row_ll_batched, C.fused_col_block_ll_batched = row, col
    calls = {"all_gather": [0, 0.0], "all_reduce": [0, 0.0]}
    for name in calls:
        real = getattr(mesh, name)

        def timed(*a, _real=real, _c=calls[name], **kw):
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            _c[0] += 1
            _c[1] += time.perf_counter() - t0
            return out
        setattr(mesh, name, timed)
    out = {}
    for path in MESH_PATHS:
        model, Y = mesh_path_model(path, mesh.device, prob, mesh)
        shapes.clear()
        F.reset_launch_counts()
        res = model.run_gibbs(Y, nburn=1, nthin=1, nsamples=1,
                              verbose=False)
        torch.cuda.synchronize()
        launches = dict(F.launch_counts)
        seen = sorted(shapes)
        for c in calls.values():
            c[:] = [0, 0.0]
        t0 = time.perf_counter()
        timed = model.run_gibbs(Y, nburn=MESH_TIMED - 1, nthin=1, nsamples=1,
                                verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[path] = dict(
            res=_numpy_results(res), timed=_numpy_results(timed),
            launches=launches, shapes=seen,
            slack=(0.0 if path in MESH_FAMILIES
                   else model._worst_constraint_slack()), seconds=dt,
            collectives={k: (c[0] / MESH_TIMED, 1e3 * c[1] / MESH_TIMED)
                         for k, c in calls.items()})
    return out


def mesh_gloo_phase(dev):
    """(b): four ranks share the card in a gloo group, mesh (dp=2, mp=2),
    at 20x20x228, k=5, nchains=4: the red-black recipe and the seq schedule
    with EP centres on the GDELT-shaped recipe data (ngrid 100), and the
    conjugate families (``MESH_FAMILIES``: the Gaussian, Binomial and
    NegBinom models of ``mesh_path_model``), 1 + 1 sweeps each, then
    MESH_TIMED timed sweeps. Every rank launches both kernels of its GASS
    path at its local shape (the families none) and returns the same
    draws. A family's W, V and nu2 (and R) equal the unsharded run's on the
    card bit for bit after the 1 + 1 sweeps and after the timed ones; a
    GASS path's W and V agree within rtol = atol = 1e-3
    (tests/test_torch_mesh_runs.py) but for the picks that flip (at most
    MESH_FAR_MAX of the values), and every recipe draw is feasible.
    Prints the phase's seconds and each path's sweeps/s on the mesh beside
    the unsharded run's at the same width."""
    t0 = time.perf_counter()
    prob = mesh_problem()
    outs = spawn_mesh("gloo_rank", 4, "gloo", prob)
    t_ranks = time.perf_counter() - t0
    for schedule, want_shapes in MESH_PATHS.items():
        t_path = time.perf_counter()
        model, Y = mesh_path_model(schedule, dev, prob)
        ref = model.run_gibbs(Y, nburn=1, nthin=1, nsamples=1,
                              verbose=False)
        family = schedule in MESH_FAMILIES
        t1 = time.perf_counter()
        ref_timed = model.run_gibbs(Y, nburn=MESH_TIMED - 1, nthin=1,
                                    nsamples=1, verbose=False)
        torch.cuda.synchronize()
        unsharded_rate = MESH_TIMED / (time.perf_counter() - t1)
        tag = f"mesh (b) {schedule}"
        keys = ("W", "V") + tuple(k for k in ("nu2", "R")
                                  if family and k in ref)
        runs = (("res", "1 + 1", ref),
                ("timed", f"1 + 1 + {MESH_TIMED}", ref_timed))
        for r, o in enumerate(outs):
            o = o[schedule]
            check_launches(f"{tag} rank {r}", o["launches"], want_shapes)
            for name, shape in want_shapes.items():
                if (name, shape) not in o["shapes"]:
                    fail(f"{tag} rank {r}: {name} did not launch at the "
                         f"local shape {shape} (launched at {o['shapes']})")
            # after 1 + 1 sweeps, and after the MESH_TIMED sweeps that
            # follow them
            for run, when, want in runs:
                for key in keys:
                    got = o[run][key]
                    if not np.array_equal(got, outs[0][schedule][run][key]):
                        fail(f"{tag} rank {r}: its {key} differs from rank "
                             f"0's after {when} sweeps")
                    if family:
                        if not np.array_equal(got, want[key]):
                            fail(f"{tag} rank {r}: "
                                 f"{int((got != want[key]).sum())} of "
                                 f"{got.size} {key} values differ from the "
                                 f"unsharded run on the card after {when} "
                                 "sweeps (bit for bit expected)")
                        continue
                    far = mesh_far_share(got, want[key])
                    if far > MESH_FAR_MAX:
                        fail(f"{tag} rank {r}: {far:.2%} of {key} differs "
                             f"from the unsharded run on the card after "
                             f"{when} sweeps by more than rtol = atol = "
                             f"1e-3 (at most {MESH_FAR_MAX:.0%}: the GASS "
                             "picks that flip)")
            if family:
                continue
            tau = np.einsum("snk,smtk->snmt", o["res"]["W"], o["res"]["V"])
            if tau.min() < -1e-5 or o["slack"] < -1e-5:
                fail(f"{tag} rank {r}: infeasible draw (min tau "
                     f"{tau.min():.3e}, slack {o['slack']:.3e})")
        o0 = outs[0][schedule]
        print(f"{tag}: launches a rank {json.dumps(o0['launches'])}, local "
              f"shapes {o0['shapes']}")
        if family:
            print(f"{tag}: values that differ in any bit from the unsharded "
                  "run (gate: 0) "
                  + "; ".join(f"after {when} sweeps " + ", ".join(
                      f"{k} {int((o0[run][k] != want[k]).sum())} of "
                      f"{want[k].size}" for k in keys)
                      for run, when, want in runs))
        else:
            diffs = {k: (float(np.abs(o0["res"][k] - ref[k]).max()),
                         int(round(mesh_far_share(o0["res"][k], ref[k])
                                   * ref[k].size)), ref[k].size)
                     for k in ("W", "V", "sigma2", "lam2") if k in ref}
            print(f"{tag}: |mesh - unsharded| (max, values beyond 1e-3, "
                  f"values): {json.dumps(diffs)}")
            far_timed = {k: int(round(mesh_far_share(
                o0["timed"][k], ref_timed[k]) * ref_timed[k].size))
                for k in keys}
            print(f"{tag}: values beyond 1e-3 of the unsharded run (gate: "
                  f"at most {MESH_FAR_MAX:.0%}) after 1 + 1 sweeps "
                  + ", ".join(f"{k} {diffs[k][1]} of {diffs[k][2]}"
                              for k in keys)
                  + f"; after 1 + 1 + {MESH_TIMED} sweeps "
                  + ", ".join(f"{k} {far_timed[k]} of {ref_timed[k].size}"
                              for k in keys)
                  + "; max abs after them "
                  + json.dumps({k: float(np.abs(o0["timed"][k]
                                                - ref_timed[k]).max())
                                for k in keys}))
        mesh_rate = MESH_TIMED / max(x[schedule]["seconds"] for x in outs)
        print(f"{tag}: sweeps_per_sec mesh(2,2) {mesh_rate:.3f} unsharded "
              f"{unsharded_rate:.3f} (20x20x228, nchains=4); the unsharded "
              f"run and the checks {time.perf_counter() - t_path:.1f}s")
        print(f"{tag}: collectives a sweep a rank (calls, ms): "
              f"{json.dumps(o0['collectives'])}")
    print(f"mesh (b) ranks' part: {t_ranks:.1f}s")
    phase_seconds("mesh (b) gloo, four ranks on one card", t0)


# ----------------------------------------------------------------------
# phase (c): the black-box models and run_gibbs's options on the mesh
# ----------------------------------------------------------------------
MESH_C_RESUME = (2, 1, 4)       # nburn, draws of the cut run, of the whole
MESH_C_COUNTED = ("all_gather", "all_reduce", "broadcast", "barrier")


def dose_mesh_problem():
    """(c1, c2)'s data on the host: the app's simulation written and read
    back as CSV, the empirical-Bayes likelihood's grid (20 components),
    the row features, and a warm start built from the data alone (no NMF):
    every row's W the constant 1/k on its active embeddings, every column's
    V the column's mean curve clipped to [0.02, 0.98] and made
    non-increasing, so that every curve constraint holds; U0 the
    simulator's U clipped to [0, 1], so that W U^T lies in [0, 1]; EP from
    that start as the app builds it (sigma 3x the RMS error)."""
    from functionalmf_tpu_torch.apps.doseresponse import (
        empirical_bayes as eb, fit, sim)
    from functionalmf_tpu_torch.models.base import tril_mask
    from functionalmf_tpu_torch.utils.ep import ep_from_mf
    s = sim.simulate(**DOSE_SIM)
    with tempfile.TemporaryDirectory() as d:
        sim.write_csv(s, d)
        df = eb.read_csv_columns(f"{d}/data.csv")
        Y, lik, cells = eb.estimate_likelihood(
            df, nbins=20, tensor_outcomes=True, verbose=False,
            device="cpu")[:3]
        X, _ = fit.read_features(f"{d}/features.csv", cells)
    n, m, T, _ = Y.shape
    k = DOSE_SIM["k"]
    W0 = tril_mask(n, k) / k
    curve = np.clip(np.nanmean(Y, axis=(0, 3)), 0.02, 0.98)
    curve = np.minimum.accumulate(curve, axis=1)                 # (m, T)
    V0 = np.repeat(curve[:, :, None], k, axis=2)
    U0 = np.clip(s["U"], 0.0, 1.0)
    ep = ep_from_mf(Y, W0, V0, mode="multiplier", multiplier=3)
    return dict(Y=Y, X=X, warm=(W0, V0, U0, ep),
                grid=(lik.mean_grid, lik.mean_probs, lik.variance))


def dose_mesh_model(dev, dose, features, mesh=None):
    """The dose-response model as the app builds it (``fit.init_model``:
    its constraints, EP, Row_constraints from U, seq schedule), k=5,
    tf_order=2, from the problem's warm start; with ``features`` the
    {Y, X, U} pytree and the app's device U hook, else {Y}. Returns
    (model, data, hook)."""
    from functionalmf_tpu_torch.apps.doseresponse import fit
    from functionalmf_tpu_torch.apps.doseresponse.empirical_bayes import (
        GammaGridLikelihood)
    mean_grid, mean_probs, variance = dose["grid"]
    lik = GammaGridLikelihood(mean_grid, mean_probs, variance, device=dev)
    args = fit.parse_args(["--nembeds", str(DOSE_SIM["k"]), "--tf_order",
                           "2", "--device", str(dev)]
                          + ["--sample_features"] * features)
    W0, V0, U0, ep = dose["warm"]
    X = dose["X"] if features else None
    model, U0 = fit.init_model(dose["Y"], lik, args, X=X,
                               warm=(W0, V0, U0 if features else None, ep),
                               mesh=mesh)
    data = {"Y": dose["Y"]}
    if features:
        data.update(X=X, U=U0)
    return model, data, fit.make_traced_u_step(X, dev) if features else None


def ess_mesh_model(dev, mesh=None):
    """(c3): the ESS cell at 20x20x228, k=5, nchains=4 (19 rounded up so
    that mp=2 divides rows and columns), ``ess_loglik`` on Poisson counts
    of ``synthetic_mu``."""
    from functionalmf_tpu_torch import NonconjugateBayesianTensorFiltering
    Mu, rng = synthetic_mu(MESH_N, MESH_N)
    Y = rng.poisson(np.exp(np.clip(Mu, -3, 3))).astype(float)
    Y[rng.random((MESH_N, MESH_N)) < 0.1] = np.nan
    return NonconjugateBayesianTensorFiltering(
        MESH_N, MESH_N, NDEPTH, ess_loglik, device=dev, nembeds=NEMBEDS,
        tf_order=2, sigma2_init=0.5, lam2_init=0.1, seed=0, nchains=4,
        mesh=mesh), Y


MESH_C_PARTS = ("c1", "c2", "c3", "c4")


def mesh_c_part(part, dev, dose, prob, mesh=None):
    """(model, data, run_gibbs kwargs) of a part of phase (c)."""
    if part in ("c1", "c2"):
        model, data, hook = dose_mesh_model(dev, dose, part == "c1", mesh)
        return model, data, (dict(traced_callback=hook,
                                  collect_data_keys=("U",))
                             if part == "c1" else {})
    if part == "c3":
        return ess_mesh_model(dev, mesh) + ({},)
    return recipe_model(dev, prob["Y"].shape, prob["Con"], prob["W0"],
                        prob["V0"], nchains=4, mesh=mesh), prob["Y"], {}


def continued(part, model, data):
    """The data a further run of a part starts from: the U hook keeps U in
    the prepared data, which a run does not give back, so (c1) continues
    from the U of the state's Row_constraints, [U | 0; -U | -1]."""
    if part != "c1":
        return data
    p, k = data["U"].shape
    return dict(data, U=model.Row_constraints[:p, :k])


def _count_calls(mesh, calls):
    """Count and time every collective of ``mesh`` into ``calls``."""
    for name in MESH_C_COUNTED:
        real = getattr(mesh, name)

        def counted(*a, _real=real, _c=calls[name], **kw):
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            _c[0] += 1
            _c[1] += time.perf_counter() - t0
            return out
        setattr(mesh, name, counted)


def mesh_c_rank(rank, world, dev_type, dose, prob, ckdir, profdir):
    """Phase (c) on one rank of four sharing the card, mesh (2, 2): each
    part 1 + 1 sweeps (c3: the same; c4: the recipe's cut, resumed and
    whole runs, then a profiled sweep), then MESH_TIMED timed sweeps with
    every collective counted and timed, and the gathers of the hooks."""
    from functionalmf_tpu_torch.ops import fused_ll as F
    from functionalmf_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(2, 2, device_type=dev_type)
    calls = {name: [0, 0.0] for name in MESH_C_COUNTED}
    _count_calls(mesh, calls)
    sync = (torch.cuda.synchronize if dev_type == "cuda" else
            (lambda: None))
    out = {}
    for part in MESH_C_PARTS:
        t_part = time.perf_counter()
        model, data, kw = mesh_c_part(part, mesh.device, dose, prob, mesh)
        # the all-gathers that hand a hook the global state (the driver's
        # model.state, every sweep)
        before = calls["all_gather"][0]
        model.state
        hook_gathers = (calls["all_gather"][0] - before
                        if "traced_callback" in kw else 0)
        F.reset_launch_counts()
        if part == "c4":
            nburn, cut, whole = MESH_C_RESUME
            ck = f"{ckdir}/chain.npz"
            model.run_gibbs(data, nburn=nburn, nthin=1, nsamples=cut,
                            verbose=False, checkpoint_path=ck)
            again = mesh_c_part(part, mesh.device, dose, prob, mesh)[0]
            res = again.run_gibbs(data, nburn=nburn, nthin=1,
                                  nsamples=whole, verbose=False,
                                  checkpoint_path=ck, resume=True)
            model = mesh_c_part(part, mesh.device, dose, prob, mesh)[0]
            uncut = model.run_gibbs(data, nburn=nburn, nthin=1,
                                    nsamples=whole, verbose=False)
            out["c4 uncut"] = _numpy_results(uncut)
        else:
            res = model.run_gibbs(data, nburn=1, nthin=1, nsamples=1,
                                  verbose=False, **kw)
        sync()
        launches = dict(F.launch_counts)
        data = continued(part, model, data)
        for c in calls.values():
            c[:] = [0, 0.0]
        t0 = time.perf_counter()
        model.run_gibbs(data, nburn=MESH_TIMED - 1, nthin=1, nsamples=1,
                        verbose=False, **kw)
        sync()
        dt = time.perf_counter() - t0
        out[part] = dict(
            res=_numpy_results(res), seconds=dt, launches=launches,
            split=getattr(model, "_data_split", None),
            slack=(model._worst_constraint_slack()
                   if hasattr(model, "_worst_constraint_slack") else 0.0),
            collectives={k: (c[0] / MESH_TIMED, 1e3 * c[1] / MESH_TIMED)
                         for k, c in calls.items()},
            hook_gathers=hook_gathers,
            part_seconds=time.perf_counter() - t_part)
    # last: the profiler slows every later launch of this process
    model, data, _ = mesh_c_part("c4", mesh.device, dose, prob, mesh)
    model.run_gibbs(data, nburn=0, nthin=1, nsamples=1, verbose=False,
                    profile_dir=profdir)
    return out


def sum_invariance_probe(dev, draws=50):
    """Why the mesh's sums run in a fixed order: the sums of a (2, 2)
    rank's block against those of the whole tensor, for ``draws`` random
    tensors, at three shapes: the ESS cell's lam2 sums (nchains 4, 20
    columns, 683 penalty rows, k=5; over the last two axes; the rank's 2
    chains and 10 columns), the scale moves' full-tensor log-likelihood
    (nchains 4, 20 rows, 20 columns, 228 time points; over rows and time;
    2 chains, 10 columns) and the Gaussian nu2 draw's squared error (the
    same shape; over all but the chains; 2 chains): torch.sum (differs
    where a reduction orders its sums by its number of outputs),
    ``models/base.py:_fixed_sum`` and ``_window_sum``. Then the Gaussian
    W update's Gram, a row's sum over the 4560 cells of its weights times
    the products of V's entries (nchains 4, 20 rows, 25 products; the
    rank's 2 chains and 10 rows): a batched product (``@``) and
    ``_fixed_sum`` of the elementwise products. Then the conjugate
    families' sites (``family_sum_probe``). No form a model runs may
    differ: the fixed orders, the V update's Gram einsum and the PG draw's
    last-axis sum."""
    from functionalmf_tpu_torch.models.base import _fixed_sum, _window_sum
    g = torch.Generator(device=dev).manual_seed(0)
    h = MESH_N // 2
    cases = (("lam2", (4, MESH_N, 3 * NDEPTH - 1, NEMBEDS), (2, 3),
              lambda t: t[:2, :h]),
             ("full_ll", (4, MESH_N, MESH_N, NDEPTH), (1, 3),
              lambda t: t[:2, :, :h]),
             ("nu2", (4, MESH_N, MESH_N, NDEPTH), (1, 2, 3),
              lambda t: t[:2]))
    sums = {"torch.sum": lambda t, d: t.sum(d), "_fixed_sum": _fixed_sum,
            "_window_sum": _window_sum}
    differ = {f"{case} {name}": 0 for case, *_ in cases for name in sums}
    for case, shape, dims, block in cases:
        for _ in range(draws):
            x = torch.rand(shape, generator=g, device=dev) ** 3 * 100
            part = block(x).contiguous()
            for name, f in sums.items():
                ours = f(part, dims)
                whole = f(x, dims)[tuple(slice(0, n) for n in ours.shape)]
                differ[f"{case} {name}"] += int(not torch.equal(whole, ours))
    P, kk = MESH_N * NDEPTH, NEMBEDS * NEMBEDS
    grams = {"@": lambda w, vv: w @ vv,
             "_fixed_sum": lambda w, vv: _fixed_sum(
                 w[..., None] * vv[:, None], (2,))[:, :, 0]}
    differ.update({f"W Gram {name}": 0 for name in grams})
    for _ in range(draws):
        w = torch.rand((4, MESH_N, P), generator=g, device=dev)
        vv = torch.randn((4, P, kk), generator=g, device=dev)
        part = w[:2, :h].contiguous()
        for name, f in grams.items():
            differ[f"W Gram {name}"] += int(not torch.equal(
                f(w, vv)[:2, :h], f(part, vv[:2])))
    # the forms no model runs any more: reported, not gated
    replaced = {k for k in differ if k.endswith(("torch.sum", "@"))} \
        | set(FAMILY_SUMS_REPLACED)
    differ.update(family_sum_probe(
        dev, (4, MESH_N, MESH_N, NDEPTH, NEMBEDS), draws))
    print(f"mesh (c): sums of a rank's block against the whole tensor's, "
          f"{draws} random draws each at the lam2 shape (4, {MESH_N}, "
          f"{3 * NDEPTH - 1}, {NEMBEDS}), the full_ll and nu2 shape (4, "
          f"{MESH_N}, {MESH_N}, {NDEPTH}), the Gaussian W Gram's (4, "
          f"{MESH_N}, {P}) x (4, {P}, {kk}) and the families' sites "
          f"(family_sum_probe, nchains 4, {MESH_N}x{MESH_N}x{NDEPTH}, "
          f"k={NEMBEDS}): differ in {json.dumps(differ)}")
    if any(n for k, n in differ.items() if k not in replaced):
        fail("mesh (c): a sum the models run differs between a rank's block "
             "and the whole tensor")


# family_sum_probe's forms that the models no longer run (each site's fixed
# form took its place)
FAMILY_SUMS_REPLACED = ("W mean @", "V mean einsum", "Mu einsum",
                        "R sum torch.sum")


def family_sum_probe(dev, shape, draws):
    """The conjugate families' sums, of a (2, 2) rank's block against the
    same block of the whole call, for ``draws`` random tensors at ``shape``
    = (nchains, n, m, T, k): the W update's mean part over a row's cells
    (the rank's chains and rows; ``@``, then
    ``models/gaussian.py:w_likelihood_terms``), the V update's Gram and
    mean part over the rows (the rank's chains and columns; the Gram an
    ``einsum``, the mean part an ``einsum``, then ``v_mean_part``), the
    cells' mean W V^T (the rank's chains; ``einsum``, then ``cell_means``),
    NegBinom's R moves' sum of a chain's cells (``torch.sum``, then
    ``_window_sum``) and the Polya-Gamma draw's sum of its 16 terms along a
    contiguous last axis (``torch.sum``). Each site in the form the models
    use, beside the form it replaced where it changed.
    {site form: draws that differ}."""
    from functionalmf_tpu_torch.models.base import _window_sum
    from functionalmf_tpu_torch.models.gaussian import (
        cell_means, v_mean_part, w_likelihood_terms)
    nch, n, m, T, k = shape
    c, r, j = nch // 2, n // 2, m // 2
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*sh):
        return torch.randn(sh, generator=g, device=dev)

    def cases():
        w8, wy = rand(nch, n, m, T) ** 2, rand(nch, n, m, T)
        W, V = rand(nch, n, k), rand(nch, m, T, k)
        Vf, P = V.reshape(nch, -1, k), m * T
        yield ("W mean", (w8.reshape(nch, n, P), wy.reshape(nch, n, P), Vf),
               lambda w, y, v: (w[:c, :r], y[:c, :r], v[:c]),
               {"@": lambda w, y, v: y @ v,
                "_fixed_sum": lambda w, y, v: w_likelihood_terms(w, y, v)[1]})
        cols = lambda w, x: (w[:c, :, :j], x[:c])              # noqa: E731
        yield ("V Gram", (w8, W), cols,
               {"einsum": lambda w, x: torch.einsum("cijt,cia,cib->cjtab",
                                                    w, x, x)})
        yield ("V mean", (wy, W), cols,
               {"einsum": lambda y, x: torch.einsum("cijt,cia->cjta", y, x),
                "_fixed_sum": v_mean_part})
        yield ("Mu", (W, V), lambda a, b: (a[:c], b[:c]),
               {"einsum": lambda a, b: torch.einsum("cnk,cmtk->cnmt", a, b),
                "_fixed_sum": cell_means})
        agg = (1, 2, 3, 4)
        yield ("R sum", (wy[..., None] * 10,), lambda a: (a[:c],),
               {"torch.sum": lambda a: a.sum(agg, keepdim=True),
                "_window_sum": lambda a: _window_sum(a, agg)})
        yield ("PG sum", (rand(16, nch, n, m, T) ** 2,), lambda t: (t[:, :c],),
               {"torch.sum": lambda t: t.movedim(0, -1).contiguous().sum(-1)})
    differ = {}
    for _ in range(draws):
        for site, args, block, forms in cases():
            part = tuple(a.contiguous() for a in block(*args))
            for name, f in forms.items():
                ours = f(*part)
                whole = f(*args)[tuple(slice(0, s) for s in ours.shape)]
                key = f"{site} {name}"
                differ[key] = differ.get(key, 0) + int(
                    not torch.equal(whole, ours))
    return differ


def launch_invariance_probe(dev, plan=None):
    """Why the kernels' launch plan is a function of an item's shape alone:
    the fused kernels on a (2, 2) rank's items alone against the same
    items inside the unsharded run's launch, at phase (b)'s 20x20x228,
    k=5, 101 candidates, on its data: ``fused_row_ll_batched`` with and
    without EP, the rank's 20 rows (2 chains x 10 rows, its row slab of y)
    against the 80 of 4 chains x 20 rows; ``fused_col_block_ll_batched``
    with and without EP at the joint shape (Tb=228), the rank's 10 columns
    against 20 at nchains 1, and its 20 pairs against 80 at nchains 4.
    Returns {kernel: (items that differ, items compared)} by torch.equal of
    each item's 101 values. ``plan`` stands in for the wrappers' launch
    plan (the earlier, item-count plan as a control)."""
    from functionalmf_tpu_torch.ops import fused_ll as F
    prob = mesh_problem()
    g = torch.Generator(device=dev).manual_seed(11)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=dev)
    i32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                    device=dev)
    n, m, T = prob["Y"].shape
    k, G, C = NEMBEDS, NGRID + 1, m * T
    h = n // 2
    y = t(prob["Y"])
    ep = (t(prob["ep"][0]), t(prob["ep"][1]))
    V0, W0 = t(prob["V0"]), t(prob["W0"])
    jitter = lambda shape: torch.rand(shape, generator=g, device=dev) * .2 + .9
    bt = (V0.reshape(1, C, k) * jitter((4, C, k))).contiguous()
    rc = i32(np.repeat(np.arange(4), n))
    ri = i32(np.tile(np.arange(n), 4))
    cw = (W0[ri.long()][:, None, :] * jitter((4 * n, G, k))).contiguous()
    mine = torch.as_tensor([c * n + i for c in range(2) for i in range(h)],
                           device=dev)
    w4 = (W0[None] * jitter((4, n, k))).contiguous()
    real = F._launch_plan
    if plan is not None:
        F._launch_plan = plan
    differ = {}
    try:
        for ex, name in (((), "fused_row_ll"), (ep, "fused_row_ll_ep")):
            rows = lambda x: x.reshape(n, C)
            whole = F.fused_row_ll_batched(cw, bt, rows(y), rc, ri, F.POISSON,
                                           tuple(map(rows, ex)))[mine]
            part = F.fused_row_ll_batched(
                cw[mine].contiguous(), bt[:2].contiguous(),
                rows(y)[:h].contiguous(), rc[mine].contiguous(),
                ri[mine].contiguous(), F.POISSON,
                tuple(rows(e)[:h].contiguous() for e in ex))
            differ[name] = (int((whole != part).any(-1).sum()), len(mine))
        for nch in (1, 4):
            pc = i32(np.repeat(np.arange(nch), m))
            pj = i32(np.tile(np.arange(m), nch))
            pt = i32(np.zeros(nch * m))
            c3 = (V0[pj.long()][:, None] * jitter((nch * m, G, T, k))
                  ).contiguous()
            sel = torch.as_tensor([c * m + j for c in range(min(nch, 2))
                                   for j in range(m // 2)], device=dev)
            cols = lambda x: x[:, :m // 2].contiguous()
            for ex, name in (((), "fused_col_block_ll"),
                             (ep, "fused_col_block_ll_ep")):
                whole = F.fused_col_block_ll_batched(
                    c3, w4[:nch].contiguous(), y, pc, pj, pt, F.POISSON,
                    ex)[sel]
                part = F.fused_col_block_ll_batched(
                    c3[sel].contiguous(), w4[:min(nch, 2)].contiguous(),
                    cols(y), pc[sel].contiguous(), pj[sel].contiguous(),
                    pt[sel].contiguous(), F.POISSON, tuple(map(cols, ex)))
                differ[f"{name} joint nchains={nch}"] = (
                    int((whole != part).any(-1).sum()), len(sel))
    finally:
        F._launch_plan = real
    return differ


def mesh_blackbox_phase(dev):
    """(c): four ranks share the card in a gloo group, mesh (dp=2, mp=2):
    (c1) the dose-response model at 98x50x9x6, k=5, on {Y, X, U} with the
    app's device U hook rewriting Row_constraints, collecting U (both
    updates read the whole data at global indices: X and U are not indexed
    by column, U not by row); (c2) the same model on {Y} (row and column
    slabs, local positions); (c3) ESS at 20x20x228, k=5, nchains=4; each
    1 + 1 sweeps against the unsharded run on the card, then MESH_TIMED
    timed sweeps on both; (c4) the bench.py recipe (both fused kernels at
    a rank's local shapes) cut after 3 sweeps and resumed from its
    checkpoint, equal to the uncut mesh run bit for bit, and a profiled
    sweep that leaves one trace a rank. Gates: c1, c2 and c4 at most
    MESH_FAR_MAX of the W, V (and U) values beyond rtol = atol = 1e-3 of
    the unsharded run (c4: its 2 + 4 sweeps), every dose-response draw
    inside its curve and row constraints, c4's state feasible; c3 W and V
    within 1e-5. First the sum and launch-invariance probes. One line a
    part: seconds, sweeps/s on the mesh and unsharded, collectives a sweep
    a rank, the branch of each update, the values beyond 1e-3."""
    t0 = time.perf_counter()
    sum_invariance_probe(dev)
    from functionalmf_tpu_torch.ops.fused_ll_bench import items_launch_plan
    control = launch_invariance_probe(dev, items_launch_plan)
    differ = launch_invariance_probe(dev)
    print("mesh (c): the fused kernels on a (2, 2) rank's items alone "
          "against the same items inside the unsharded launch "
          f"({MESH_N}x{MESH_N}x{NDEPTH}, {NGRID + 1} candidates), items that "
          "differ of those compared: "
          f"{json.dumps(differ)}; under the earlier item-count plan: "
          f"{json.dumps(control)} ({time.perf_counter() - t0:.1f}s with the "
          "sum probe)")
    if any(d for d, _ in differ.values()):
        fail("mesh (c): a fused kernel sums an item differently inside a "
             "launch of another item count")
    dose, prob = dose_mesh_problem(), mesh_problem()
    with tempfile.TemporaryDirectory() as ckdir, \
            tempfile.TemporaryDirectory() as profdir:
        outs = spawn_mesh("mesh_c_rank", 4, "gloo", dev.type, dose, prob,
                          ckdir, profdir)
        traces = sorted(os.listdir(profdir))
    t_ranks = time.perf_counter() - t0
    want = ["trace.json"] + [f"trace.rank{r}.json" for r in (1, 2, 3)]
    if traces != want:
        fail(f"mesh (c4): the profiled sweep left {traces}, not {want}")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    splits = {"c1": {"W": "whole", "V": "whole"},
              "c2": {"W": "slab", "V": "slab"}, "c3": None,
              "c4": {"W": "slab", "V": "slab"}}
    for part in MESH_C_PARTS:
        model, data, kw = mesh_c_part(part, dev, dose, prob)
        tag = f"mesh (c) {part}"
        t1 = time.perf_counter()
        if part == "c4":
            nburn, _, whole = MESH_C_RESUME
            ref = model.run_gibbs(data, nburn=nburn, nthin=1,
                                  nsamples=whole, verbose=False)
        else:
            ref = model.run_gibbs(data, nburn=1, nthin=1, nsamples=1,
                                  verbose=False, **kw)
        data = continued(part, model, data)
        t2 = time.perf_counter()
        model.run_gibbs(data, nburn=MESH_TIMED - 1, nthin=1, nsamples=1,
                        verbose=False, **kw)
        sync()
        rate = MESH_TIMED / (time.perf_counter() - t2)
        keys = {"c1": ("W", "V", "U"), "c2": ("W", "V"), "c3": ("W", "V"),
                "c4": ("W", "V")}[part]
        for r, o in enumerate(outs):
            o = o[part]
            if o["split"] != splits[part]:
                fail(f"{tag} rank {r}: the updates took {o['split']}, "
                     f"expected {splits[part]}")
            for key in keys:
                if not np.array_equal(o["res"][key],
                                      outs[0][part]["res"][key]):
                    fail(f"{tag} rank {r}: its {key} differs from rank 0's")
            if part == "c4":
                for key, v in outs[r]["c4 uncut"].items():
                    if not np.array_equal(o["res"][key], v):
                        fail(f"{tag} rank {r}: {key} of the resumed run "
                             "differs from the uncut mesh run")
                check_launches(f"{tag} rank {r}", o["launches"],
                               ("fused_row_ll", "fused_col_block_ll"))
            elif any(o["launches"].values()):
                fail(f"{tag} rank {r}: a fused kernel launched "
                     f"({o['launches']}) on a path without a cell function")
            for key in keys:
                if part == "c3":
                    d = float(np.abs(o["res"][key] - ref[key]).max())
                    if not d <= 1e-5:
                        fail(f"{tag} rank {r}: {key} differs from the "
                             f"unsharded run by {d:.3e} (limit 1e-5)")
                    continue
                far = mesh_far_share(o["res"][key], ref[key])
                if far > MESH_FAR_MAX:
                    fail(f"{tag} rank {r}: {far:.2%} of {key} differs from "
                         "the unsharded run by more than rtol = atol = "
                         f"1e-3 (at most {MESH_FAR_MAX:.0%})")
            if part in ("c1", "c2") and r == 0:
                res = o["res"]      # the other ranks' equal rank 0's
                U = res["U"] if part == "c1" else None
                check_dose_draws(tag, res["W"], res["V"], U,
                                 dose["warm"][2], dose["warm"][:2])
            if o["slack"] < -1e-5:
                fail(f"{tag} rank {r}: final state infeasible (slack "
                     f"{o['slack']:.3e})")
        o0 = outs[0][part]
        diffs = {k: (float(np.abs(o0["res"][k] - ref[k]).max()),
                     int(round(mesh_far_share(o0["res"][k], ref[k])
                               * ref[k].size)), ref[k].size) for k in keys}
        mesh_rate = MESH_TIMED / max(o[part]["seconds"] for o in outs)
        print(f"{tag}: {max(o[part]['part_seconds'] for o in outs):.1f}s on "
              f"the ranks; sweeps_per_sec mesh(2,2) {mesh_rate:.3f} "
              f"unsharded {rate:.3f}; collectives a sweep a rank (calls, "
              f"ms) {json.dumps(o0['collectives'])}, of them all_gathers "
              f"for the hook {o0['hook_gathers']}; branch {o0['split']}; "
              f"|mesh - unsharded| (max, values beyond 1e-3, values) "
              f"{json.dumps(diffs)}; unsharded {t2 - t1:.1f}s")
        gate = ("within 1e-5" if part == "c3" else
                f"at most {MESH_FAR_MAX:.0%} beyond 1e-3")
        print(f"{tag}: values beyond 1e-3 of the unsharded run (gate: "
              f"{gate}): "
              + ", ".join(f"{k} {d[1]} of {d[2]}" for k, d in diffs.items()))
    print(f"mesh (c4): resumed run equal to the uncut mesh run bit for bit; "
          f"traces {traces}; ranks' part {t_ranks:.1f}s")
    phase_seconds("mesh (c) black-box models and run_gibbs options", t0)


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


def synthetic_mu(nrows=NROWS, ncols=NCOLS):
    """A smooth 19x19x228 mean tensor of rank 5 with entries of order 1
    (seed 42): the Gaussian phase's truth and the Binomial phase's logits
    (``nrows`` x ``ncols`` for the mesh phase)."""
    rng = np.random.default_rng(42)
    W = rng.normal(0, 1, size=(nrows, NEMBEDS))
    W[np.triu_indices(NEMBEDS, k=1)] = 0
    V = np.cumsum(rng.normal(0, 0.08, size=(ncols, NDEPTH, NEMBEDS)), axis=1) \
        + rng.normal(0, 0.5, size=(ncols, 1, NEMBEDS))
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


def gaussian_data(nrows=NROWS, ncols=NCOLS):
    """Two replicates of ``synthetic_mu`` with noise sd 0.5, 10% of the
    curves held out (NaN)."""
    Mu, rng = synthetic_mu(nrows, ncols)
    Y = Mu[..., None] + rng.normal(0, 0.5, size=Mu.shape + (2,))
    Y[rng.random((nrows, ncols)) < 0.1] = np.nan
    return Y


def gaussian_phase(dev, nchains, nburn=30, nsamples=20):
    from functionalmf_tpu_torch import GaussianBayesianTensorFiltering
    Y = gaussian_data()
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


def binomial_data(nrows=NROWS, ncols=NCOLS):
    """(Y, N, logits, held-out curves): binomial counts of
    ``synthetic_mu``'s logits, N in {5, 20, 80} (both PG branches), 10% of
    the curves held out (NaN)."""
    Mu, rng = synthetic_mu(nrows, ncols)
    N = rng.choice([5.0, 20.0, 80.0], size=Mu.shape)
    Y = rng.binomial(N.astype(int), 1 / (1 + np.exp(-Mu))).astype(float)
    hold = rng.random((nrows, ncols)) < 0.1
    Y[hold] = np.nan
    N[hold] = np.nan
    return Y, N, Mu, hold


def binomial_phase(dev, nburn=25, nsamples=15):
    from functionalmf_tpu_torch import BinomialBayesianTensorFiltering
    Y, N, Mu, hold = binomial_data()
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
    """NegBinom through the politics app's --nb arm, on the card. Returns
    the model and its Polya-Gamma run: the kernel's launches counted from
    0 over the app's run, the arm's sweeps, and the inputs, noise and
    answer of its last draw (:func:`pg_kernel_check`)."""
    from functionalmf_tpu_torch.apps.politics import benchmark
    from functionalmf_tpu_torch.models import binomial
    from functionalmf_tpu_torch.ops import polyagamma as PG
    last, pg0 = {}, binomial.polya_gamma

    def keep(gen, b, c, **kw):
        omega = pg0(gen, b, c, **kw)
        last.update(b=b.clone(), c=c.clone(), z=kw["z"].clone(),
                    noise=tuple(t.clone() for t in kw["gamma_noise"]),
                    got=omega.clone())
        return omega

    with tempfile.TemporaryDirectory() as empty:
        args = benchmark.parse_args(
            ["--no-pgds", "--nb", "--device", "cuda", "--data-dir", empty,
             "--nthin", "1", "--nburn", str(nburn), "--nsamples",
             str(nsamples)])
        PG.reset_launch_counts()
        binomial.polya_gamma = keep
        try:
            t0 = time.perf_counter()
            out = benchmark.run(args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            binomial.polya_gamma = pg0
    launches = dict(PG.launch_counts)
    res, model = out.nb_results, out.nb_model
    sweeps = model.last_run["sweeps"]
    in_record = model.last_run["counts"]["launches"]
    if (launches != {"polya_gamma": sweeps, "polya_gamma_g": 0}
            or in_record["polya_gamma"] != sweeps
            or in_record["polya_gamma_g"] != 0):
        fail(f"negbinom: Polya-Gamma kernel launches {launches}, in the run "
             f"record {in_record}; one a sweep of {sweeps} expected")
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
          + " ".join(f"{a}={b:.4f}" for a, b in row.items())
          + f"; polya_gamma kernel launches {launches['polya_gamma']} in "
          f"{sweeps} sweeps")
    return model, dict(launches=launches["polya_gamma"], sweeps=sweeps,
                       last=last)


def pg_kernel_check(pg_run):
    """The Polya-Gamma kernel's last draw of the NegBinom arm against the
    plain version on the same inputs and noise, on the card, and a second
    launch bit for bit (ops/polyagamma_bench.py:check_draw)."""
    from functionalmf_tpu_torch.ops import polyagamma_bench as PB
    d = pg_run["last"]
    try:
        chk = PB.check_draw(d["got"], d["b"], d["c"], d["z"], d["noise"])
    except AssertionError as exc:
        fail(f"negbinom: {exc}")
    pg_run["rounds"] = chk.pop("rounds")
    pg_run["check"] = chk
    if chk["ambiguous"] > chk["cells"] // 100:
        fail(f"negbinom: {chk['ambiguous']} of {chk['cells']} cells within "
             "rounding of an acceptance threshold")
    shape = "x".join(map(str, d["b"].shape))
    print(f"polya_gamma kernel (the NegBinom arm's last draw, {shape}): "
          f"{chk['err_eps']:.3f} float32 eps of the terms' magnitudes from "
          f"the plain version ({PB.TOL_EPS} allowed; max |err| "
          f"{chk['max_abs_err']:.3e}), {chk['ref_eps']:.3f} from float64; "
          f"{chk['ambiguous']} of {chk['cells']} cells left out as within "
          "rounding of a threshold; two launches bit for bit")


def pg_kernel_times(dev, pg_run, nchains=128, seed=11):
    """The Polya-Gamma kernel's times and bound
    (ops/polyagamma_bench.py:time_draw) on the NegBinom arm's last draw's
    inputs, then on its (b, c) tiled to ``nchains`` chains (the NegBinom
    benchmark cell's count) with noise drawn here. Returns a record per
    shape, the first the run's own."""
    from functionalmf_tpu_torch.ops import polyagamma_bench as PB
    from functionalmf_tpu_torch.ops.gamma import draw_gamma_mt_noise
    d = pg_run["last"]
    recs = []
    rec = PB.time_draw(d["b"], d["c"], d["z"], d["noise"],
                       rounds=pg_run["rounds"])
    recs.append(dict(rec, shape="x".join(map(str, d["b"].shape))))
    tile = (nchains,) + tuple(d["b"].shape[1:])
    b, c = (t.expand(tile).contiguous() for t in (d["b"], d["c"]))
    gen = torch.Generator(device=dev).manual_seed(seed)
    K = d["noise"][0].shape[1]
    noise = draw_gamma_mt_noise(gen, (K,) + tile, device=dev)
    z = torch.randn(tile, generator=gen, device=dev)
    rec = PB.time_draw(b, c, z, noise)
    recs.append(dict(rec, shape="x".join(map(str, tile))))
    del b, c, z, noise
    torch.cuda.empty_cache()
    for r in recs:
        print(f"kernel polya_gamma ({r['shape']}, {K} terms): "
              f"device_us={r['device_us']:.2f} host_us={r['host_us']:.2f} "
              f"bound_us={r['bound_us']:.3f} (bytes: {r['bytes']}) "
              f"pct_of_bound={r['pct_of_bound']:.1f} "
              f"event_ms={r['event_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"[{r['timing']}]")
    return recs


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
    (Mu[t] - Mu[t+1] >= -1e-2), W U^T in [0, 1]; U, W and V moved. A run
    without features (``Us`` None) has no U and no row constraints."""
    for name, x in (("W", Ws), ("V", Vs), ("U", Us)):
        if x is not None and not np.isfinite(x).all():
            fail(f"{tag}: non-finite draws in {name}")
    mu = np.einsum("snk,smtk->snmt", Ws, Vs)
    if mu.min() < -tol or mu.max() > 1 + tol:
        fail(f"{tag}: a draw leaves [0, 1] (Mu in [{mu.min():.6f}, "
             f"{mu.max():.6f}])")
    step = (mu[..., :-1] - mu[..., 1:]).min()
    if step < -1e-2 - tol:
        fail(f"{tag}: a draw violates the softened monotonicity "
             f"(min Mu[t] - Mu[t+1] = {step:.6f}, limit -0.01)")
    S = Ws.shape[0]
    rows = ""
    if Us is not None:
        wu = np.einsum("snk,spk->snp", Ws, Us)
        if wu.min() < -tol or wu.max() > 1 + tol:
            fail(f"{tag}: a draw violates the row constraints (W U^T in "
                 f"[{wu.min():.6f}, {wu.max():.6f}])")
        if Us.shape != (S,) + U0.shape:
            fail(f"{tag}: U draws have shape {Us.shape}, expected "
                 f"{(S,) + U0.shape}")
        rows = f", W U^T in [{wu.min():.5f}, {wu.max():.5f}]"
    moved = {}
    for name, x, x0 in (("U", Us, U0), ("W", Ws, warm_start[0]),
                        ("V", Vs, warm_start[1])):
        if x is None:
            continue
        d = np.abs(x - x0.astype(np.float32)).reshape(S, -1).max(axis=1)
        if not (d > 0).all():
            fail(f"{tag}: a collected {name} draw equals its start")
        moved[name] = float(np.abs(x - x0).mean() / np.abs(x0).mean())
    print(f"doseresponse {tag}: {S} draws finite and feasible: Mu in "
          f"[{mu.min():.5f}, {mu.max():.5f}], min step {step:.5f}{rows}; "
          "mean |draw - start| / mean |start|: "
          + ", ".join(f"{a} {b:.4f}" for a, b in moved.items()))


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
          f"(cold); peak device memory {peak:.3f} GiB; set-up (3 NMF fits "
          f"with the native NNLS, EP) {out['nmf_seconds']:.1f}s; "
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
    and the NMF arm's fit from the same generator."""
    from functionalmf_tpu_torch.examples import poisson_tensor_filtering as E
    from functionalmf_tpu_torch.utils.nmf import tensor_nmf
    rng = np.random.default_rng(seed)
    Y, _ = E.make_data(rng)
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


# the examples whose chains run the fused kernels, and their launches a
# sweep (row, column): the W update, and the V rounds (the Poisson
# example's two seq rounds and its tail; the recipe's red and black phases
# and its tail at T=60)
ANCHOR_LAUNCHES = {"poisson": (1, 3), "recipe": (1, 3)}


def examples_anchor_phase():
    """The examples and the production recipe on the card at one data seed
    and cut sweeps, several chains of one model each (the data, warm start,
    model, draws and metrics of the examples' own functions; the recipe at
    a cut shape): each gated metric's mean over the chains (for the
    Gaussian, over those that left the mode that reads the signal as noise)
    within four standard errors of the JAX package's at the same seed,
    counts and shape, from the JAX chains' spread
    (tests/examples_anchors.json holds the JAX numbers, from
    tests/examples_jax.py on the CPU). The Gaussian, Binomial and NegBinom
    launch no fused kernel (no cell function on these paths); the Poisson
    example's Poisson BTF arm and the recipe launch the non-EP kernels
    inside their chains, at ANCHOR_LAUNCHES a sweep, and no EP kernel."""
    from functionalmf_tpu_torch.examples import anchors
    from functionalmf_tpu_torch.ops import fused_ll as F
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "examples_anchors.json")) as f:
        cfg = json.load(f)["card"]
    seconds = {}
    for example in anchors.EXAMPLES:
        sweeps = tuple(cfg["sweeps"][example])
        shape = cfg["shape"].get(example)
        nsweeps = sweeps[0] + sweeps[1] * sweeps[2]
        tag = f"{example} example" if example != "recipe" else "recipe"
        F.reset_launch_counts()
        t0 = time.perf_counter()
        got = anchors.run(example, cfg["seed"], cfg["seed"], cfg["chains"],
                          sweeps, "cuda", shape=shape)
        seconds[example] = time.perf_counter() - t0
        launches = dict(F.launch_counts)
        if example in ANCHOR_LAUNCHES:
            check_launches(tag, launches, ("fused_row_ll",
                                           "fused_col_block_ll"))
            row, col = ANCHOR_LAUNCHES[example]
            if (launches["fused_row_ll"], launches["fused_col_block_ll"]) \
                    != (row * nsweeps, col * nsweeps):
                fail(f"{tag}: launches {launches} in {nsweeps} sweeps; "
                     f"expected {row} row and {col} column launches a sweep")
            print(f"launches {tag}: {json.dumps(launches)} in {nsweeps} "
                  f"sweeps of {cfg['chains']} chains, inside the chain")
        else:
            check_no_launches(tag, launches)
        if not all(np.isfinite(got[m]).all() for m in anchors.GATED[example]):
            fail(f"{tag}: non-finite metrics {got}")
        size = ("x".join(map(str, shape[:3])) + f" k={shape[3]}"
                if shape else "11x12x20 k=3")
        print(f"{tag} {size} seed {cfg['seed']}, {cfg['chains']} chains of "
              f"{sweeps} sweeps on the card, {got['seconds']:.1f} s "
              f"({seconds[example]:.1f} s with the set-up): " + " ".join(
                  f"{m} {json.dumps([round(v, 4) for v in got[m]])}"
                  for m in anchors.GATED[example])
              + (f" left the noise mode {sum(got['fitted'])}"
                 if "fitted" in got else ""))
        for g in anchors.compare(example, got, cfg["jax"][example]):
            print(f"{tag} {g['metric']}: port {g['port']:.4f} "
                  f"over {g['n']} chains, JAX {g['ref']:.4f} over "
                  f"{g['n_ref']} (the same seed and counts, CPU), "
                  f"difference {g['diff']:+.4f}, limit {g['limit']:.4f}")
            if not g["ok"]:
                fail(f"{tag}: {g['metric']} {g['port']:.4f} "
                     f"over {g['n']} chains is beyond {g['limit']:.4f} of "
                     f"the JAX package's {g['ref']:.4f}")
    kernel_gates = sum(seconds[e] for e in ANCHOR_LAUNCHES)
    print("examples anchor seconds " + json.dumps(
        {e: round(t, 1) for e, t in seconds.items()})
        + f"; the gates with the kernels in the chain together "
        f"{kernel_gates:.1f} s")


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


# ----------------------------------------------------------------------
# BNP-CovReg (apps/flutrends/bnp_covreg.py)
# ----------------------------------------------------------------------
# the --bnp arm at full flu width (p=50, N=370, L=10, k=20): only the
# iterations are cut, from the app's 10000 (stored every 10th)
BNP_NITER = 200
BNP_BTF_SWEEPS = 10            # the BTF arm beside it: burn-in = draws
# tests/test_bnp_covreg.py:66-91's recovery problem
BNP_TOY = dict(L=4, k=4, niter=600, store_every=10, nburn=200, c=30.0,
               chunk=50)
BNP_TOY_SD = 0.3
BNP_STEPS = (("_sample_invSig", "invSig"), ("_sample_hypers", "hypers"),
             ("_sample_theta", "theta"), ("_sample_psi", "psi"),
             ("_sample_xi", "xi"), ("_sample_zeta", "zeta"))


def bnp_app_phase():
    """The flu-trends app with --bnp on the card, on its synthetic
    50x1x370 tensor, beside a short BTF arm at k=5: finite draws of the
    expected shapes, var_diag > 0, in-sample RMSE of the BNP mean below the
    data's standard deviation, coverage finite. fit_bnp_covreg raises if
    a Cholesky factorisation failed (its count is read every chunk)."""
    from functionalmf_tpu_torch.apps.flutrends import benchmark
    n = BNP_BTF_SWEEPS
    with tempfile.TemporaryDirectory() as empty:      # the synthetic tensor
        args = benchmark.parse_args(
            ["--device", "cuda", "--data-dir", empty, "--nembeds", "5",
             "--nburn", str(n), "--nthin", "1", "--nsamples", str(n),
             "--bnp", "--bnp-niter", str(BNP_NITER)])
        t0 = time.perf_counter()
        table, fits = benchmark.run(args)
        dt = time.perf_counter() - t0
        Y = benchmark.load_data(empty, np.random.default_rng(args.seed))[0]
    out, row = fits["bnp_covreg"], table["bnp_covreg"]
    S = BNP_NITER // 10
    for name in ("mu", "var_diag"):
        if out[name].shape != (S, 50, 370):
            fail(f"bnp app: {name} of shape {out[name].shape}")
        if not np.isfinite(out[name]).all():
            fail(f"bnp app: non-finite {name}")
    if not out["var_diag"].min() > 0:
        fail(f"bnp app: var_diag min {out['var_diag'].min():.3e}")
    if out["state"]["zeta"].device.type != "cuda":
        fail("bnp app: the sampler did not run on the card")
    if not all(np.isfinite(v) for v in row.values()):
        fail(f"bnp app: non-finite report {row}")
    if not row["rmse_in"] < Y.std():
        fail(f"bnp app: in-sample RMSE {row['rmse_in']:.4f} is not below "
             f"the data's standard deviation {Y.std():.4f}")
    print(f"bnp app 50x1x370, L=10, k=20: {BNP_NITER} iterations (the "
          f"app's 10000 cut), {S} stored; app seconds {dt:.1f} (the BTF "
          f"arm's {2 * n} sweeps and the data included); Cholesky failures "
          f"0; Fox and Dunson (2015): "
          + " ".join(f"{a}={b:.4f}" for a, b in row.items())
          + f" (data sd {Y.std():.4f}); BTF k=5 rmse_in="
          f"{table[5]['rmse_in']:.4f}")


def bnp_toy_problem(seed=42, p=8, n=60):
    """tests/test_bnp_covreg.py:66-91's data (its rng fixture: seed 42)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, n)
    basis = np.stack([np.sin(2 * np.pi * x), np.cos(3 * np.pi * x)])
    mu_true = rng.normal(size=(p, 2)) @ basis
    y = mu_true + rng.normal(0, BNP_TOY_SD, size=(p, n))
    inds = np.ones((p, n), bool)
    inds[0, 10:25] = False
    inds[3, 40:55] = False
    return np.where(inds, y, np.nan), inds, mu_true


def bnp_recovery_and_agreement(dev):
    """The recovery problem on the card (seed 1): err_obs < 0.5 sd,
    err_miss < 2 sd, median var_diag in (0.25 sd^2, 10 sd^2); then on the
    CPU at seeds 1 and 2: the card's posterior mean of mu within twice the
    CPU seeds' spread (RMS over the cells)."""
    from functionalmf_tpu_torch.apps.flutrends.bnp_covreg import (
        fit_bnp_covreg)
    y, inds, mu_true = bnp_toy_problem()
    sd, means = BNP_TOY_SD, {}
    for d, seed in ((dev, 1), ("cpu", 1), ("cpu", 2)):
        t0 = time.perf_counter()
        out = fit_bnp_covreg(y, seed=seed, device=d, **BNP_TOY)
        dt = time.perf_counter() - t0
        means[(str(d), seed)] = out["mu"].mean(0)
        print(f"bnp toy 8x60 on {d}, seed {seed}: {BNP_TOY['niter']} "
              f"iterations in {dt:.3f}s ({BNP_TOY['niter'] / dt:.2f}/s)")
        if d == dev:
            mu = means[(str(d), seed)]
            err_obs = np.sqrt(np.mean((mu - mu_true)[inds] ** 2))
            err_miss = np.sqrt(np.mean((mu - mu_true)[~inds] ** 2))
            med = float(np.median(out["var_diag"].mean(0)))
            print(f"bnp recovery on the card: err_obs={err_obs:.4f} (< "
                  f"{0.5 * sd}), err_miss={err_miss:.4f} (< {2 * sd}), "
                  f"median var_diag={med:.4f} (in ({0.25 * sd ** 2:.4f}, "
                  f"{10 * sd ** 2:.4f}))")
            if not (err_obs < 0.5 * sd and err_miss < 2 * sd
                    and 0.25 * sd ** 2 < med < 10 * sd ** 2):
                fail("bnp recovery: the posterior misses the truth")
    card = means[(str(dev), 1)]
    spread = float(np.sqrt(np.mean((means[("cpu", 1)]
                                    - means[("cpu", 2)]) ** 2)))
    rel = float(np.sqrt(np.mean((card - means[("cpu", 1)]) ** 2)))
    print(f"agreement card vs cpu (bnp 8x60, seed 1): rms {rel:.4f} (limit "
          f"{2 * spread:.4f}, twice the spread of CPU seeds 1 and 2)")
    if not rel < 2 * spread:
        fail(f"bnp: card and CPU posteriors disagree ({rel:.4f})")


def bnp_matheron_moments(dev):
    """4000 batched GP conditional draws on the card at N=25 against the
    dense float64 moments (tests/test_bnp_covreg.py:45-63): means within
    5 standard errors + 1e-4, variances within 25% + 1e-5."""
    from functionalmf_tpu_torch.apps.flutrends.bnp_covreg import (
        _sample_gp_conditional, se_kernel)
    rng = np.random.default_rng(42)
    n, S = 25, 4000
    K = se_kernel(n, c=30.0, d=1.0, r=1e-4)
    A = np.abs(rng.normal(size=n)) + 0.5
    h = rng.normal(size=n)
    Sig = np.linalg.inv(np.linalg.inv(K) + np.diag(A))

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fails = torch.zeros((), dtype=torch.int64, device=dev)
    draws = _sample_gp_conditional(
        gen, t(A).expand(S, n), t(h).expand(S, n), t(K),
        t(np.linalg.cholesky(K)), fails=fails).double().cpu().numpy()
    z = np.abs(draws.mean(0) - Sig @ h) / np.sqrt(np.diag(Sig) / S)
    vrel = np.abs(draws.var(0) / np.diag(Sig) - 1)
    print(f"bnp Matheron draw on the card (N=25, {S} draws): largest mean "
          f"error {z.max():.2f} standard errors, largest variance error "
          f"{vrel.max():.4f}, Cholesky failures {int(fails)}")
    if int(fails) or not (np.all(np.abs(draws.mean(0) - Sig @ h)
                                 < 5 * np.sqrt(np.diag(Sig) / S) + 1e-4)
                          and np.all(np.abs(draws.var(0) - np.diag(Sig))
                                     <= 0.25 * np.diag(Sig) + 1e-5)):
        fail("bnp Matheron draw: moments off on the card")


class BNPChain:
    """The BNP sampler at flu width on the card, an iteration at a time,
    for the phase times and the launch profile."""

    def __init__(self, dev, Y):
        from functionalmf_tpu_torch._runtime import SweepRNG
        from functionalmf_tpu_torch.apps.flutrends import bnp_covreg as B
        self.B, self.L, self.k = B, 10, 20
        self.y, self.inds, self.K, self.cholK = B._prepare(
            Y[:, 0, :], None, 100.0, 1.0, 1e-5, dev)
        self.rng = SweepRNG(0, dev)
        self.fails = torch.zeros((), dtype=torch.int64, device=dev)
        self.hp = dict(a_sig=1.0, b_sig=0.1, a_phi=1.5, b_phi=1.5, a1=10.0,
                       a2=10.0)
        p, N = self.y.shape
        self.state = B._init_state(self.rng.at(SweepRNG.BNP, 0), p, N,
                                   self.L, self.k, 1.0, 0.1, 1.5, 1.5, 10.0,
                                   10.0, self.y)
        self.it = 0
        self.run(2)

    def run(self, n):
        from functionalmf_tpu_torch._runtime import SweepRNG
        for _ in range(n):
            self.it += 1
            self.state = self.B._gibbs_iter(
                self.rng.at(SweepRNG.BNP, self.it), self.state, self.y,
                self.inds, self.K, self.cholK, self.L, self.k, self.hp,
                psi_iters=5, fails=self.fails)
        torch.cuda.synchronize()


def bnp_time_goes(chain, iters=5):
    """ms an iteration of each of the six steps, a synchronise around
    each; the Cholesky failure count of the chain so far must be 0."""
    totals = {}
    with contextlib.ExitStack() as stack:
        for name, label in BNP_STEPS:
            stack.enter_context(timed(chain.B, name, label, totals, False))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain.run(iters)
        totals["iteration (timed)"] = time.perf_counter() - t0
    ms = {label: 1e3 * t / iters for label, t in totals.items()}
    print(f"phases bnp 50x370 L=10 k=20 (ms an iteration, {iters} "
          f"iterations, a synchronise around each): "
          + json.dumps({k: round(v, 3) for k, v in ms.items()}))
    missing = {label for _, label in BNP_STEPS} - set(ms)
    if missing:
        fail(f"phases bnp: no time for {sorted(missing)}")
    t0 = time.perf_counter()
    chain.run(2 * iters)
    dt = time.perf_counter() - t0
    print(f"bnp 50x370 untimed: {2 * iters} iterations in {dt:.3f}s, "
          f"iterations_per_sec={2 * iters / dt:.3f}")
    if int(chain.fails):
        fail(f"bnp: {int(chain.fails)} Cholesky factorisations failed")


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
    from functionalmf_tpu_torch.utils import native
    t0 = time.perf_counter()
    path = native.build()
    print(f"native build: {path.name} from native/fmf_host.cpp (host c++) in "
          f"{time.perf_counter() - t0:.1f}s")

    Y, Con, W0, V0, _ = bench_data()
    pol = politics_problem()
    stamp("the build and the politics warm start")

    _, l1 = slice_run(dev, Y, Con, W0, V0, nchains=1, nburn=RECIPE_SWEEPS // 2,
                      nsamples=RECIPE_SWEEPS // 2)
    slice_run(dev, Y, Con, W0, V0, nchains=4, nburn=20, nsamples=20)
    stamp("the red-black recipe")
    # the mesh: its ranks load the kernels built above
    mesh_nccl_phase(dev, Y, Con, W0, V0)
    mesh_gloo_phase(dev)
    mesh_blackbox_phase(dev)
    stamp("the mesh")
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
    nb_model, pg_run = negbinom_phase()
    pg_kernel_check(pg_run)
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
    t0 = time.perf_counter()
    examples_anchor_phase()
    phase_seconds("the examples and the recipe against the JAX package's",
                  t0)
    stamp("PGDS and the examples")
    t0 = time.perf_counter()
    bnp_app_phase()
    phase_seconds("BNP-CovReg through the flu-trends app", t0)
    t0 = time.perf_counter()
    bnp_recovery_and_agreement(dev)
    phase_seconds("BNP recovery and card vs CPU", t0)
    t0 = time.perf_counter()
    bnp_matheron_moments(dev)
    phase_seconds("BNP Matheron moments", t0)
    stamp("BNP-CovReg")
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
    t0 = time.perf_counter()
    from functionalmf_tpu_torch.apps.flutrends import benchmark as flu
    with tempfile.TemporaryDirectory() as empty:
        flu_train = flu.load_data(empty, np.random.default_rng(42))[1]
    bnp_chain = BNPChain(dev, flu_train)
    bnp_time_goes(bnp_chain)
    phase_seconds("BNP phase times", t0)
    stamp("the phase times")
    # last: torch.profiler, which times the kernels, slows every later
    # launch of the process on the host; the recipe once more shows how much
    records = kernel_phase(dev, Y, W0, V0, pol, example)
    pg_records = pg_kernel_times(dev, pg_run)
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
    t0 = time.perf_counter()
    profile_sweeps("bnp 50x370 L=10 k=20 (a sweep: an iteration)",
                   bnp_chain.run, sweeps=2, warm=1)
    phase_seconds("BNP launch profile", t0)
    stamp("the launch profiles")
    print("red-black recipe again, after the profiled kernel phase:")
    slice_run(dev, Y, Con, W0, V0, nchains=1, nburn=20, nsamples=20)
    stamp("the whole run")

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
    # the Polya-Gamma kernel's main path: the politics app's --nb arm
    pg, chk = pg_records[0], pg_run["check"]
    kernels.append(dict(
        name="polya_gamma", route="cuda",
        source="functionalmf_tpu_torch/csrc/polyagamma.cu",
        replaces="functionalmf_tpu/ops/polyagamma.py:81 (XLA elementwise "
                 "ops, no TPU kernel)",
        launches=pg_run["launches"], max_abs_err=chk["max_abs_err"],
        err_eps=chk["err_eps"], ms=pg["device_us"] / 1e3,
        plain_ms=pg["plain_ms"], bound_ms=pg["bound_us"] / 1e3,
        bound_by=pg["bound_by"], library_ms=None, shape=pg["shape"],
        device_us=pg["device_us"], bound_us=pg["bound_us"],
        host_us=pg["host_us"], event_ms=pg["event_ms"],
        launches_per_sweep=pg_run["launches"] / pg_run["sweeps"],
        device_us_by_shape={r["shape"]: r["device_us"] for r in pg_records},
        plain_ms_by_shape={r["shape"]: r["plain_ms"] for r in pg_records},
        bound_us_by_shape={r["shape"]: r["bound_us"] for r in pg_records}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
