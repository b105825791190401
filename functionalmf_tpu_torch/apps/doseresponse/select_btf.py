"""DIC-based hyperparameter selection over saved BTF runs.

Counterpart of functionalmf_tpu/apps/doseresponse/select_btf.py (reference
doseresponse/select_btf.py:1-90): a grid over (nembeds, tf_order, lam2,
seed) directories of saved posterior draws, scored by DIC under the
empirical-Bayes likelihood: numpy around the torch ``logpdf``, which runs
on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from functionalmf_tpu_torch._runtime import resolve_device
from functionalmf_tpu_torch.apps.doseresponse.empirical_bayes import (
    estimate_likelihood, read_csv_columns)


def mu_loglikelihood(Y, Mu, likelihood):
    """select_btf.py:9-14."""
    return float(np.nansum(likelihood.logpdf(
        np.asarray(Y, np.float32), np.asarray(Mu, np.float32)).cpu().numpy()))


def dic(Y, Mu, likelihood):
    """DIC = 2 avg(dev) - dev(avg) (select_btf.py:16-23)."""
    Mu_mean = Mu.mean(axis=0)
    D_mean = -2 * mu_loglikelihood(Y, Mu_mean, likelihood)
    mean_D = -2 * np.mean([mu_loglikelihood(Y, M, likelihood) for M in Mu])
    return 2 * mean_D - D_mean


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Select hyperparameters for BTF using DIC.")
    parser.add_argument("--data", default="data/cumc.csv")
    parser.add_argument("--basedir", default="doseresponse/data/")
    parser.add_argument("--seeds", nargs="+", type=int,
                        default=[1, 2, 3, 4, 5])
    parser.add_argument("--nembeds", nargs="+", type=int,
                        default=[3, 5, 8, 10, 15])
    parser.add_argument("--tf_order", nargs="+", type=int, default=[0, 1])
    parser.add_argument("--lam2", nargs="+", type=float,
                        default=[1e-3, 1e-2, 1e-1])
    parser.add_argument("--nbins", type=int, default=20)
    parser.add_argument("--nthin", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    df = read_csv_columns(args.data)
    print("Loading data and performing empirical Bayes likelihood estimate")
    Y_full, likelihood, *_ = estimate_likelihood(
        df, nbins=args.nbins, tensor_outcomes=True, device=device)

    results = np.full((len(args.seeds), len(args.nembeds),
                       len(args.tf_order), len(args.lam2)), np.nan)
    for sidx, seed in enumerate(args.seeds):
        for kidx, emb in enumerate(args.nembeds):
            for tidx, tf in enumerate(args.tf_order):
                for lidx, lam in enumerate(args.lam2):
                    curdir = os.path.join(
                        args.basedir,
                        "k{}_t{}_l{}_s{}".format(emb, tf, lam, seed))
                    if not os.path.exists(os.path.join(curdir, "btf.npy")):
                        continue
                    Y_train = np.load(os.path.join(curdir, "y.npy"))
                    Mu_hat = np.load(os.path.join(curdir, "btf.npy"))
                    if args.nthin > 1:
                        Mu_hat = Mu_hat[::args.nthin]
                    results[sidx, kidx, tidx, lidx] = dic(Y_train, Mu_hat,
                                                          likelihood)
                    print(seed, emb, tf, lam, results[sidx, kidx, tidx, lidx])

    with open(os.path.join(args.basedir, "selection_results.txt"), "w") as f:
        for sidx, seed in enumerate(args.seeds):
            flat = np.where(np.isnan(results[sidx]), np.inf, results[sidx])
            sel_k, sel_t, sel_l = np.unravel_index(flat.argmin(), flat.shape)
            print("Raw  seed: {} nembeds: {} tf_order: {} lam2: {}".format(
                seed, args.nembeds[sel_k], args.tf_order[sel_t],
                args.lam2[sel_l]), file=f)
    return results


if __name__ == "__main__":
    main()
