"""The JAX package's examples and production recipe as chains to compare:
the counterpart of ``functionalmf_tpu_torch.examples.anchors.run`` on the
CPU.

The JAX examples (examples/) draw their data inside their ``__main__``
block, so ``make_data`` repeats that draw with the examples' own truth
functions, and the models are built with the examples' settings plus
``nchains``. ``poisson`` is the Poisson example's Poisson BTF arm: its
``init_model`` and ``setup_sampler``, after the NMF arm's fit from the
same generator, as its ``__main__`` runs them. ``recipe`` is bench.py's
red-black recipe (``_make_model`` with ``v_schedule="redblack"`` and the
cell function; ``fuse_cells=False``, the shipped path) on bench.py's
generator (bench.py:138-150) at ``--shape``, drawn at the data seed; the
Poisson example's likelihood and cell function are bench.py's. The tests
hold ``make_data`` and the warm starts equal to the port's.

    JAX_PLATFORMS=cpu python tests/examples_jax.py --example negbinom \\
        --data-seed 2 --model-seeds 1 2 3 [--chains C] \\
        [--sweeps NBURN NTHIN NSAMPLES] [--jobs N] [--escape] \\
        [--shape NROWS NCOLS NDEPTH NEMBEDS]

prints one JSON line a model, as the port's ``anchors`` does.

``agree`` is the body of tests/test_torch_examples_anchor*.py for the
Gaussian, Binomial and NegBinom: both packages on the CPU at one data
seed and the counts of tests/examples_anchors.json, the port's mean over
its chains within the rule of ``anchors.compare`` of the JAX package's.
``agree_with_record`` is the same for ``poisson`` and ``recipe``
(tests/test_torch_examples_anchor_poisson.py,
tests/test_torch_recipe_anchor.py), against the JAX chains' centre and
spread kept in that file (running the JAX chains live would double the
tests' time).
"""
import argparse
import concurrent.futures
import importlib.util
import json
import multiprocessing
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from functionalmf_tpu_torch.examples import anchors  # noqa: E402
SWEEPS = {"gaussian": (1000, 1, 1000), "binomial": (10000, 10, 1000),
          "negbinom": (10000, 1, 2000), "poisson": (5000, 5, 1000),
          "recipe": (300, 1, 300)}
RECIPE_SHAPE = (19, 19, 228, 5)
ANCHORS = os.path.join(REPO, "tests", "examples_anchors.json")


def anchors_data():
    """tests/examples_anchors.json: the JAX chains' spread at the tests'
    counts, and their centre and spread at the card's."""
    with open(ANCHORS) as f:
        return json.load(f)


def agree(example, seed):
    """Both packages at ``seed`` on the CPU, at the tests' counts and
    chains: each gated metric's rows of ``anchors.compare``."""
    data = anchors_data()
    cfg = data["cpu_test"]
    sweeps, chains = tuple(cfg["sweeps"][example]), cfg["chains"][example]
    port = anchors.run(example, seed, seed, chains, sweeps, device="cpu")
    ref = anchors.summary(example, run(example, seed, seed, chains, sweeps))
    for m, r in ref.items():
        r["sd"] = cfg["sd"][example][str(seed)][m]
    return anchors.compare(example, port, ref)


def agree_with_record(example, seed):
    """The port's chains at ``seed`` on the CPU, at the tests' counts,
    chains and shape, against the JAX chains' centre and spread recorded
    in tests/examples_anchors.json: each gated metric's rows of
    ``anchors.compare``."""
    cfg = anchors_data()["cpu_test"]
    sweeps, chains = tuple(cfg["sweeps"][example]), cfg["chains"][example]
    shape = cfg["shape"].get(example)
    port = anchors.run(example, seed, seed, chains, sweeps, device="cpu",
                       shape=shape)
    return anchors.compare(example, port, cfg["jax"][example][str(seed)])


def example_module(example):
    import jax
    jax.config.update("jax_platforms", "cpu")
    if example == "recipe":
        example = "poisson"     # bench.py's likelihood and cell function
    path = os.path.join(REPO, "examples", f"{example}_tensor_filtering.py")
    spec = importlib.util.spec_from_file_location(f"jax_{example}_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_data(example, seed, shape=None, rng=None):
    """The JAX example's data at ``seed``: (the model's data, the truth the
    metrics read); the recipe's data are (Y, W0, V0)."""
    from functionalmf_tpu.utils import ilogit
    mod = example_module(example)
    rng = np.random.default_rng(seed) if rng is None else rng
    if example == "recipe":
        # bench.py:138-150 at ``shape``
        nrows, ncols, ndepth, k = shape or RECIPE_SHAPE
        W = np.abs(rng.normal(1, 0.3, size=(nrows, k)))
        W[np.triu_indices(k, k=1)] = 0
        V = np.abs(rng.normal(1, 0.3, size=(ncols, ndepth, k)))
        Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
        hold = rng.random((nrows, ncols)) < 0.1
        Y[hold] = np.nan
        W0 = np.abs(rng.normal(1, 0.2, size=(nrows, k)))
        W0[np.triu_indices(k, k=1)] = 0
        V0 = np.abs(rng.normal(1, 0.2, size=(ncols, ndepth, k)))
        return (Y, W0, V0), np.einsum("nk,mtk->nmt", W, V)
    shape = (mod.nrows, mod.ncols, mod.ndepth)
    if example == "poisson":
        # the example's __main__: truth, counts, the [:3, :3] curves out
        W, V = mod.create_piecewise_constant(rng)
        Mu = np.einsum("nk,mtk->nmt", W, V)
        Y = rng.poisson(Mu[..., None], size=shape + (mod.nreplicates,)
                        ).astype(float)
        Y[:3, :3] = np.nan
        return Y, Mu
    if example == "negbinom":
        R, P, _, _ = mod.create_piecewise_constant(rng)
        Y = rng.poisson(rng.gamma(np.maximum(R[..., None], 1e-6),
                                  (P / (1 - P))[..., None],
                                  size=shape + (1,))).astype(float)
        Y[:3, :3] = np.nan
        return Y, R * P / (1 - P)
    W, V = mod.create_wiggly_with_jumps(rng)
    Mu = np.einsum("nk,mtk->nmt", W, V)
    if example == "gaussian":
        Y = rng.normal(Mu[..., None], np.sqrt(mod.nu2_truth),
                       size=shape + (1,))
        Y[:3, :3] = np.nan
        return Y, Mu
    N = np.full(shape, float(mod.nreplicates))
    Y = rng.binomial(mod.nreplicates, ilogit(Mu)).astype(float)
    Y[:3, :3] = np.nan
    N[np.isnan(Y)] = np.nan
    return (Y, N), ilogit(Mu)


def setup(example, data_seed, model_seed=None, nchains=1, shape=None):
    """The JAX model, its data and the truth the metrics read, as the
    port's ``anchors.setup`` makes them."""
    import functionalmf_tpu as pkg
    mod = example_module(example)
    rng = np.random.default_rng(data_seed)
    data, truth = make_data(example, data_seed, shape, rng)
    seed = data_seed if model_seed is None else model_seed
    if example == "poisson":
        model = mod.init_model(3, seed=seed, nchains=nchains)
        mod.tensor_nmf(data, 3, rng=rng)          # the NMF arm's fit
        mod.setup_sampler(model, data, rng=rng)
        return model, data, truth
    if example == "recipe":
        Y, W0, V0 = data
        n, m, T, k = W0.shape[0], V0.shape[0], V0.shape[1], W0.shape[1]
        Con = np.concatenate([np.eye(T), np.zeros((T, 1))], axis=1)
        model = pkg.ConstrainedNonconjugateBayesianTensorFiltering(
            n, m, T, mod.rowcol_loglikelihood, Con, nembeds=k, tf_order=2,
            sigma2_init=0.5, lam2_init=0.1, W_init=W0, V_init=V0,
            gass_ngrid=100, seed=seed, nchains=nchains,
            v_schedule="redblack", fuse_cells=False,
            loglikelihood_cellfn=mod.rowcol_cellfn)
        return model, Y, truth
    kw = dict(nembeds=mod.nembeds, tf_order=2, sigma2_init=0.5,
              lam2_init=0.1, nchains=nchains, seed=seed)
    shape = (mod.nrows, mod.ncols, mod.ndepth)
    if example == "gaussian":
        model = pkg.GaussianBayesianTensorFiltering(*shape, nu2_init=1, **kw)
    elif example == "binomial":
        model = pkg.BinomialBayesianTensorFiltering(*shape, **kw)
    else:
        model = pkg.NegativeBinomialBayesianTensorFiltering(
            *shape, rdims=(1, 2), **kw)
    return model, data, truth


def run(example, data_seed, model_seed=None, nchains=1, sweeps=None,
        escape=False, shape=None):
    """One JAX model of ``nchains`` chains on the example's data at
    ``data_seed``: {metric: [one value a chain]} and the seconds the fit
    took; with ``escape``, {"escape": [first sweep with nu2 < 20]}."""
    from functionalmf_tpu.utils import coverage_at, ilogit, mae, mse
    model, data, truth = setup(example, data_seed, model_seed, nchains,
                               shape)
    nburn, nthin, nsamples = sweeps or SWEEPS[example]
    if escape:
        nburn, nthin = 0, 1
    t0 = time.perf_counter()
    res = model.run_gibbs(data, nburn=nburn, nthin=nthin, nsamples=nsamples,
                          verbose=False)
    seconds = time.perf_counter() - t0
    if escape:
        low = np.asarray(res["nu2"]).reshape(nchains, nsamples, -1)[..., 0] \
            < anchors.ESCAPE_NU2
        return dict(escape=[int(np.argmax(r)) if r.any() else nsamples
                            for r in low], seconds=seconds)
    draws = np.einsum("znk,zmtk->znmt", res["W"], res["V"])
    if example in ("poisson", "recipe"):
        draws = draws.reshape((nchains, nsamples) + draws.shape[1:])
        out = dict(
            rmse=[float(np.sqrt(mse(truth, d.mean(0)))) for d in draws],
            coverage=[float(coverage_at(truth, d, 90)) for d in draws])
        if example == "recipe":
            for key in ("lam2", "sigma2"):
                v = np.log(np.asarray(res[key])[:, 0]).reshape(nchains, -1)
                out["log_" + key] = [float(c.mean()) for c in v]
        return dict(out, seconds=seconds)
    if example != "gaussian":
        P = ilogit(np.clip(draws, -10, 10))
        draws = P if example == "binomial" else \
            np.asarray(res["R"]) * P / (1 - P)
    draws = draws.reshape((nchains, nsamples) + draws.shape[1:])
    means = draws.mean(1)
    out = dict(
        mae=[float(mae(truth[:3, :3], m[:3, :3])) for m in means],
        rmse=[float(np.sqrt(mse(truth[:3, :3], m[:3, :3]))) for m in means],
        coverage=[float(coverage_at(truth, d, 90)) for d in draws])
    if example == "gaussian":
        nu2 = np.asarray(res["nu2"]).reshape(nchains, nsamples, -1)[..., 0]
        out["fitted"] = [bool(r.max() < anchors.ESCAPE_NU2) for r in nu2]
    return dict(out, seconds=seconds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--example", choices=tuple(SWEEPS), required=True)
    ap.add_argument("--data-seed", type=int, required=True)
    ap.add_argument("--model-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--sweeps", type=int, nargs=3, default=None,
                    metavar=("NBURN", "NTHIN", "NSAMPLES"))
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--escape", action="store_true")
    ap.add_argument("--shape", type=int, nargs=4, default=None,
                    metavar=("NROWS", "NCOLS", "NDEPTH", "NEMBEDS"),
                    help="the recipe's shape")
    args = ap.parse_args(argv)
    jobs = [(args.example, args.data_seed, s, args.chains, args.sweeps,
             args.escape, args.shape) for s in args.model_seeds]
    if args.jobs == 1:
        results = (run(*j) for j in jobs)
    else:
        pool = concurrent.futures.ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn"))
        results = pool.map(run, *zip(*jobs))
    for j, out in zip(jobs, results):
        print(json.dumps(dict(package="jax", example=args.example,
                              data_seed=args.data_seed, model_seed=j[2],
                              chains=args.chains, sweeps=args.sweeps,
                              shape=args.shape, **out)),
              flush=True)
    if args.jobs > 1:
        pool.shutdown()


if __name__ == "__main__":
    sys.exit(main())
