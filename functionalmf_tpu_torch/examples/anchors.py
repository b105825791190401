"""The examples and the production recipe as chains to compare.

``run`` fits one model of ``nchains`` chains to an example's data drawn at
a data seed, from a model seed, through the example's own ``make_data``,
``init_model``, ``scored_draws`` and ``score``, and returns each chain's
metrics. With the data seed as the model seed and one chain it is the
example's own run: for ``poisson`` the Poisson example's Poisson BTF
arm, warm-started from the example's NMF (``warm_start``, from the data's
generator as the example's ``main`` draws it), and for ``recipe``
bench.py's red-black recipe on bench.py's generator
(``examples/recipe.py``) at ``--shape`` (19x19x228, k=5, by default).
``compare`` holds the mean of the chains' metrics to a reference's:
within ``k`` standard errors of the difference, from the reference's
chain-to-chain standard deviation on the same data.

    python -m functionalmf_tpu_torch.examples.anchors --example negbinom \\
        --data-seed 2 --model-seeds 1 2 3 [--chains C] [--device cuda] \\
        [--sweeps NBURN NTHIN NSAMPLES] [--jobs N] [--escape] \\
        [--shape NROWS NCOLS NDEPTH NEMBEDS]

prints one JSON line a model (each chain's metrics and the seconds). The
sweeps are the example's own unless cut. ``--jobs`` fits that many models
at once, a process each. ``--escape`` (Gaussian) instead runs NSAMPLES
sweeps with no burn-in and gives, for each chain, the first sweep whose
nu2 is below 20, where the truth's is 9 (NSAMPLES if none): how long a
chain stays in the mode that reads the signal as noise (Mu near 0, nu2
near the data's variance).
"""
import argparse
import concurrent.futures
import importlib
import json
import math
import multiprocessing
import os
import sys
import time

import numpy as np

EXAMPLES = ("gaussian", "binomial", "negbinom", "poisson", "recipe")
# The metrics the examples' anchors were quoted by: the held-out RMSE and
# the 90% coverage (Gaussian), the held-out MAE of P (Binomial) and of the
# mean R P / (1 - P) (NegBinom); the RMSE against the true rate and its
# 90% coverage (the Poisson example's table; the recipe), and the
# posterior means of log lam2 and log sigma2 (the recipe, at tf_order=2).
GATED = {"gaussian": ("rmse", "coverage"), "binomial": ("mae",),
         "negbinom": ("mae",), "poisson": ("rmse", "coverage"),
         "recipe": ("rmse", "coverage", "log_lam2", "log_sigma2")}
K = 4.0
# A Gaussian chain may sit for hundreds of sweeps in the mode that reads
# the signal as noise (Mu near 0, nu2 near the data's variance, where the
# truth's is 9) and reads a held-out RMSE of 6-24 there. Its chains are
# compared over those that left that mode before their first kept draw:
# every kept nu2 below ESCAPE_NU2.
ESCAPE_NU2 = 20.0


def example_module(example):
    name = example if example == "recipe" else f"{example}_tensor_filtering"
    return importlib.import_module(f"functionalmf_tpu_torch.examples.{name}")


def setup(example, data_seed, model_seed, nchains, device, shape=None):
    """(the model, its data, the truth the metrics read): the data drawn at
    ``data_seed``, then the warm start from the same generator where the
    example has one."""
    mod = example_module(example)
    rng = np.random.default_rng(data_seed)
    seed = data_seed if model_seed is None else model_seed
    if example == "recipe":
        (Y, W0, V0), truth = mod.make_data(rng, shape or mod.SHAPE)
        return mod.init_model(W0, V0, seed, nchains, device), Y, truth
    data, truth = mod.make_data(rng)
    model = mod.init_model(seed=seed, nchains=nchains, device=device)
    if example == "poisson":
        mod.warm_start(model, data, rng)
    return model, data, truth


def run(example, data_seed, model_seed=None, nchains=1, sweeps=None,
        device="cuda", escape=False, shape=None):
    """One model of ``nchains`` chains on the example's data at
    ``data_seed``: {metric: [one value a chain]} and the seconds the fit
    took; with ``escape``, {"escape": [first sweep with nu2 < 20]}."""
    mod = example_module(example)
    model, data, truth = setup(example, data_seed, model_seed, nchains,
                               device, shape)
    nburn, nthin, nsamples = sweeps or mod.SWEEPS
    if escape:
        nburn, nthin = 0, 1
    t0 = time.perf_counter()
    res = model.run_gibbs(data, nburn=nburn, nthin=nthin, nsamples=nsamples,
                          verbose=False)
    seconds = time.perf_counter() - t0
    if escape:
        low = np.asarray(res["nu2"]).reshape(nchains, nsamples, -1)[..., 0] \
            < ESCAPE_NU2
        return dict(escape=[int(np.argmax(r)) if r.any() else nsamples
                            for r in low], seconds=seconds)
    draws = mod.scored_draws(res)
    draws = [d.reshape((nchains, nsamples) + d.shape[1:]) for d in
             (draws if isinstance(draws, tuple) else (draws,))]
    chains = [mod.score(truth, *(d[c] for d in draws))
              for c in range(nchains)]
    out = {k: [float(c[k]) for c in chains] for k in chains[0]}
    if example == "gaussian":
        nu2 = np.asarray(res["nu2"]).reshape(nchains, nsamples, -1)[..., 0]
        out["fitted"] = [bool(r.max() < ESCAPE_NU2) for r in nu2]
    return dict(out, seconds=seconds)


def summary(example, chains):
    """{metric: {"centre", "sd", "n"}}: the mean and the standard deviation
    of each gated metric over the chains of ``chains`` ({metric: [one value
    a chain]}) that count (for the Gaussian, those that left the noise
    mode before their first kept draw; every chain otherwise)."""
    keep = chains.get("fitted", [True] * len(chains[GATED[example][0]]))
    out = {}
    for metric in GATED[example]:
        v = np.array([x for x, f in zip(chains[metric], keep) if f])
        out[metric] = dict(centre=float(v.mean()) if len(v) else math.nan,
                           sd=float(v.std(ddof=1)) if len(v) > 1 else math.nan,
                           n=len(v))
    return out


def compare(example, port, ref, k=K):
    """Each gated metric of ``port`` ({metric: [one value a chain]})
    against ``ref`` ({metric: {"centre", "sd", "n"}}: the reference's mean
    over its n chains that count and their standard deviation, from
    ``summary``): the means, their difference and the limit, k standard
    errors of the difference. It fails where fewer than two of the port's
    chains count."""
    got = summary(example, port)
    rows = []
    for metric in GATED[example]:
        p, r = got[metric], ref[metric]
        lim = k * r["sd"] * math.sqrt(1 / max(p["n"], 1) + 1 / r["n"])
        rows.append(dict(example=example, metric=metric, port=p["centre"],
                         n=p["n"], ref=r["centre"], n_ref=r["n"],
                         diff=p["centre"] - r["centre"], limit=lim,
                         ok=bool(p["n"] >= 2 and
                                 abs(p["centre"] - r["centre"]) <= lim)))
    return rows


def _job(threads, *args):
    import torch
    torch.set_num_threads(threads)
    return run(*args)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--example", choices=EXAMPLES, required=True)
    ap.add_argument("--data-seed", type=int, required=True)
    ap.add_argument("--model-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sweeps", type=int, nargs=3, default=None,
                    metavar=("NBURN", "NTHIN", "NSAMPLES"))
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--escape", action="store_true")
    ap.add_argument("--shape", type=int, nargs=4, default=None,
                    metavar=("NROWS", "NCOLS", "NDEPTH", "NEMBEDS"),
                    help="the recipe's shape")
    args = ap.parse_args(argv)
    jobs = [(args.example, args.data_seed, s, args.chains, args.sweeps,
             args.device, args.escape, args.shape) for s in args.model_seeds]
    if args.jobs == 1:
        results = (run(*j) for j in jobs)
    else:
        threads = max(1, len(os.sched_getaffinity(0)) // args.jobs)
        pool = concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"))
        results = pool.map(_job, [threads] * len(jobs), *zip(*jobs))
    for j, out in zip(jobs, results):
        print(json.dumps(dict(example=args.example, data_seed=args.data_seed,
                              model_seed=j[2], chains=args.chains,
                              sweeps=args.sweeps, device=args.device,
                              shape=args.shape, **out)),
              flush=True)
    if args.jobs > 1:
        pool.shutdown()


if __name__ == "__main__":
    sys.exit(main())
