"""GDELT politics benchmark on the port (functionalmf_tpu/apps/politics/
benchmark.py; reference politics/benchmark.py:1-204).

Fits the constrained Poisson BTF to the 19x19x228 G20 "Intend to
Cooperate" monthly count tensor with 10% of nation pairs held out, and
reports in/out-of-sample RMSE / MAE / Poisson log-likelihood against the
empirical mean. The warm start is an NMF of the training tensor (or of a
precomputed PGDS posterior mean, ``--pgds-mu``); the EP centres come from
that NMF (``ep_from_nmf``). ``--nb`` also fits the NegBinom BTF arm
(global dispersion, logit link, Mu = R P / (1 - P)). The in-process PGDS
arm is not ported yet.

    python -m functionalmf_tpu_torch.apps.politics.benchmark --no-pgds \\
        --device cuda

Data: the benchmark arrays (cooperate.npy, cooperate_train.npy,
held_out.npy) from ``--data-dir`` when present; otherwise a synthetic
GDELT-shaped tensor, so the pipeline runs end to end.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering,
    NegativeBinomialBayesianTensorFiltering, POISSON)
from functionalmf_tpu_torch.utils.nmf import tensor_nmf

# The Poisson cell without its y-only term, 0 on NaN (politics/
# benchmark.py:41-46): the CellFn the CUDA kernels have compiled in.
rowcol_cellfn = POISSON


def rowcol_loglikelihood(Y, WV, W, V, row=None, col=None):
    # politics/benchmark.py:21-32
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


def ep_from_nmf(Y, W, V):
    # politics/benchmark.py:47-56: relative-error variance estimate
    if Y.ndim == 3:
        Y = Y[..., None]
    M = (W[:, None, None] * V[None]).sum(axis=-1, keepdims=True)
    with np.errstate(all="ignore"):
        estimate = np.nanmedian(np.nanmean(
            (Y - M) ** 2 / np.clip(M, 1e-8, None) ** 2, axis=-1))
    print("Estimated stdev: {}".format(estimate))
    return M[..., 0], np.ones(Y.shape[:-1]) * estimate


def load_data(data_dir, rng):
    paths = [os.path.join(data_dir, f)
             for f in ("cooperate.npy", "cooperate_train.npy", "held_out.npy")]
    if all(os.path.exists(p) for p in paths):
        Y = np.load(paths[0]).astype(float)
        Y_train = np.load(paths[1]).astype(float)
        to_hold = np.load(paths[2])
        print("Loaded GDELT tensors from {}".format(data_dir))
        return Y, Y_train, to_hold
    # synthesize GDELT-shaped counts (same holdout protocol,
    # politics/create_datasets.py:61-69)
    print("GDELT data not found in {}; synthesizing".format(data_dir))
    n, T, k = 19, 228, 5
    W = rng.gamma(1.5, 1, size=(n, k))
    V = np.abs(np.cumsum(rng.normal(0, 0.05, size=(n, T, k)), axis=1)
               + rng.gamma(1, 0.5, size=(n, 1, k)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
    indices = np.array([np.repeat(np.arange(n), n), np.tile(np.arange(n), n)]).T
    to_hold = indices[rng.choice(indices.shape[0], replace=False,
                                 size=int(np.ceil(n * n * 0.1)))]
    Y_train = Y.copy()
    for i, j in to_hold:
        Y_train[i, j] = np.nan
    return Y, Y_train, to_hold


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="GDELT politics benchmark")
    parser.add_argument("--data-dir", default=os.environ.get(
        "GDELT_DATA_DIR", os.path.join("data", "politics")))
    parser.add_argument("--device", default="cuda",
                        help="torch device of the Gibbs sampler, e.g. "
                             "'cuda' or 'cpu'")
    parser.add_argument("--nembeds", type=int, default=5)
    parser.add_argument("--nburn", type=int, default=10000)
    parser.add_argument("--nthin", type=int, default=10)
    parser.add_argument("--nsamples", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no-ep", action="store_true",
                        help="disable EP centering of the GASS proposal")
    parser.add_argument("--v-block-size", type=int, default=8,
                        help="time-block size for the V GASS updates; "
                             "0 = the reference's joint per-column update")
    parser.add_argument("--v-schedule", default="seq",
                        choices=["seq", "redblack"],
                        help="blocked-V schedule; redblack batches all "
                             "same-color time blocks into one GASS call")
    parser.add_argument("--outdir", default=None)
    parser.add_argument("--pgds-mu", default=None,
                        help="path to a precomputed PGDS posterior-mean rate "
                             "tensor (.npy); used as the NMF warm-start "
                             "target instead of refitting PGDS in-process")
    parser.add_argument("--no-pgds", action="store_true",
                        help="skip the PGDS arm; warm-start NMF from Y_train")
    parser.add_argument("--nchains", type=int, default=1,
                        help="chains for the BTF arm; results pool "
                             "chain-major and metrics.json records the "
                             "split-R-hat across chains")
    parser.add_argument("--nb", action="store_true",
                        help="also fit the NegBinom BTF arm (reference "
                             "politics/benchmark.py:139-158)")
    return parser.parse_args(argv)


@dataclasses.dataclass
class PoliticsRun:
    """What one run of the benchmark produced: the metrics table, the
    results dict of run_gibbs, the fitted model, its warm start (W0, V0)
    and the host-clock seconds of the NMF warm start and of the Gibbs
    sampler; with ``--nb`` the NegBinom arm's results and model too."""
    table: dict
    results: dict
    model: ConstrainedNonconjugateBayesianTensorFiltering
    warm_start: tuple
    nmf_seconds: float
    gibbs_seconds: float
    nsweeps: int
    nb_results: dict = None
    nb_model: NegativeBinomialBayesianTensorFiltering = None


def run(args):
    """The benchmark for parsed ``args``: data, warm start, EP, the
    constrained Poisson BTF, the report."""
    if not (args.no_pgds or args.pgds_mu):
        raise NotImplementedError(
            "the in-process PGDS arm is not ported yet (ROADMAP.md, Queue 1 "
            "item 13): pass --no-pgds or --pgds-mu")
    rng = np.random.default_rng(args.seed)
    Y, Y_train, to_hold = load_data(args.data_dir, rng)
    nrows, ncols, ndepth = Y.shape
    nembeds = args.nembeds

    if args.pgds_mu:
        nmf_target = np.load(args.pgds_mu)
        if nmf_target.shape != Y.shape:
            raise ValueError(f"--pgds-mu has shape {nmf_target.shape}, "
                             f"expected {Y.shape}")
    else:
        nmf_target = Y_train

    # constrained Poisson BTF with positivity constraints (benchmark.py:84-97)
    C_zero = np.concatenate([np.eye(ndepth), np.zeros((ndepth, 1))], axis=1)
    t0 = time.perf_counter()
    W0, V0 = tensor_nmf(nmf_target, nembeds, rng=rng)
    nmf_seconds = time.perf_counter() - t0
    print("NMF warm start: {:.3f} s".format(nmf_seconds))
    ep = None if args.no_ep else ep_from_nmf(Y_train, W0, V0)

    model = ConstrainedNonconjugateBayesianTensorFiltering(
        nrows, ncols, ndepth, rowcol_loglikelihood, C_zero,
        device=args.device, nembeds=nembeds, tf_order=2, sigma2_init=0.5,
        lam2_init=0.1, ep_approx=ep, W_init=W0, V_init=V0, seed=args.seed,
        v_block_size=args.v_block_size or None,
        v_schedule=args.v_schedule, nchains=args.nchains,
        loglikelihood_cellfn=rowcol_cellfn)

    print("Running Gibbs sampler")
    t0 = time.perf_counter()
    results = model.run_gibbs(Y_train, nburn=args.nburn, nthin=args.nthin,
                              nsamples=args.nsamples, print_freq=10,
                              verbose=True)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    gibbs_seconds = time.perf_counter() - t0
    nsweeps = args.nburn + args.nthin * args.nsamples
    print("Gibbs sampler: {} sweeps in {:.3f} s ({:.3f} sweeps/s)".format(
        nsweeps, gibbs_seconds, nsweeps / gibbs_seconds))
    Mu_hat = np.einsum("znk,zmtk->znmt", results["W"], results["V"])

    # evaluation (benchmark.py:163-204)
    from scipy.stats import poisson
    is_missing = np.isnan(Y)
    is_held_out = (~is_missing) & np.isnan(Y_train)
    is_in_sample = (~is_missing) & (~is_held_out)

    table = {}

    def report(name, mu):
        r_in = np.sqrt(np.mean((Y[None, is_in_sample] - mu[:, is_in_sample]) ** 2,
                               axis=-1)).mean()
        r_out = np.sqrt(np.mean((Y[None, is_held_out] - mu[:, is_held_out]) ** 2,
                                axis=-1)).mean()
        m_in = np.mean(np.abs(Y[None, is_in_sample] - mu[:, is_in_sample]),
                       axis=-1).mean()
        m_out = np.mean(np.abs(Y[None, is_held_out] - mu[:, is_held_out]),
                        axis=-1).mean()
        with np.errstate(all="ignore"):
            ll_in = poisson.logpmf(Y[None, is_in_sample],
                                   np.clip(mu[:, is_in_sample], 1e-8, None)
                                   ).mean(axis=-1).mean()
            ll_out = poisson.logpmf(Y[None, is_held_out],
                                    np.clip(mu[:, is_held_out], 1e-8, None)
                                    ).mean(axis=-1).mean()
        print(name)
        print("In-sample  RMSE: {:.2f}".format(r_in))
        print("Out-sample RMSE: {:.2f}".format(r_out))
        print("In-sample   MAE: {:.2f}".format(m_in))
        print("Out-sample  MAE: {:.2f}".format(m_out))
        print("In-sample    LL: {:.2f}".format(ll_in))
        print("Out-sample   LL: {:.2f}".format(ll_out))
        print()
        table[name] = dict(rmse_in=r_in, rmse_out=r_out, mae_in=m_in,
                           mae_out=m_out, ll_in=ll_in, ll_out=ll_out)

    Mu_emp = (np.ones_like(Y_train) * np.nanmean(Y_train, axis=-1)[..., None])[None]
    report("Empirical mean", Mu_emp)
    report("BTF", Mu_hat)

    nb_results = nb_model = None
    if args.nb:
        # the NB-BTF variant (politics/benchmark.py:139-158): global
        # dispersion (rdims=(0,1,2)), logit link, Mu = R P / (1 - P)
        nb_model = NegativeBinomialBayesianTensorFiltering(
            nrows, ncols, ndepth, device=args.device, nembeds=nembeds,
            tf_order=2, sigma2_init=0.5, lam2_init=0.1, nu2_init=1,
            rdims=(0, 1, 2), seed=args.seed)
        print("Running NB-BTF Gibbs sampler")
        nb_results = nb_model.run_gibbs(
            Y_train, nburn=args.nburn, nthin=args.nthin,
            nsamples=args.nsamples, print_freq=10, verbose=True)
        psi = np.clip(np.einsum("znk,zmtk->znmt", nb_results["W"],
                                nb_results["V"]), -10, 10)
        P = 1.0 / (1.0 + np.exp(-psi))
        Rs = nb_results["R"].reshape(nb_results["R"].shape[0], 1, 1, 1)
        report("NB-BTF", Rs * P / (1 - P))

    if results.get("rhat"):     # empty below 4 samples a chain
        table["BTF"]["rhat_max"] = float(results["rhat"]["max"])
        table["BTF"].update({f"rhat_{k}": float(v)
                             for k, v in results["rhat"].items()
                             if k != "max"})
        print("BTF split-R-hat:", results["rhat"])

    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        np.save(os.path.join(args.outdir, "btf_mu"), Mu_hat)
        with open(os.path.join(args.outdir, "metrics.json"), "w") as f:
            json.dump({k: {kk: float(vv) for kk, vv in v.items()}
                       for k, v in table.items()}, f, indent=2)
    return PoliticsRun(table=table, results=results, model=model,
                       warm_start=(W0, V0), nmf_seconds=nmf_seconds,
                       gibbs_seconds=gibbs_seconds, nsweeps=nsweeps,
                       nb_results=nb_results, nb_model=nb_model)


def main(argv=None):
    return run(parse_args(argv)).table


if __name__ == "__main__":
    main()
