"""Results tables for the dose-response pipeline.

Counterpart of functionalmf_tpu/apps/doseresponse/results.py (reference
doseresponse/results.py:1-90): MAE, RMSE and NLL across models over
trials of several seeds, with an optional LaTeX table: numpy around the
torch ``logpdf``, which runs on the card unless ``--device cpu`` is
given."""
from __future__ import annotations

import argparse
import os

import numpy as np

from functionalmf_tpu_torch._runtime import resolve_device
from functionalmf_tpu_torch.apps.doseresponse.empirical_bayes import (
    estimate_likelihood, read_csv_columns)
from functionalmf_tpu_torch.utils.metrics import mae, mse

MODELS = [
    {"name": "NMF", "file": "nmf.npy", "preprocess": lambda x: x},
    {"name": "Logistic MF", "file": "logistic_mf.npy",
     "preprocess": lambda x: x},
    {"name": "BTF", "file": "btf.npy", "preprocess": lambda x: x.mean(axis=0)},
    {"name": "Monotone NMF", "file": "nmf_mono.npy",
     "preprocess": lambda x: x},
]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Results for BTF dose-response modeling.")
    parser.add_argument("seeds", nargs="+")
    parser.add_argument("--data", default="doseresponse/data/sim/data.csv")
    parser.add_argument("--outdir", default="doseresponse/data/sim/")
    parser.add_argument("--latex", action="store_true")
    parser.add_argument("--truth", help="optional true effects .npy")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    df = read_csv_columns(args.data)
    Y, likelihood, *_ = estimate_likelihood(df, tensor_outcomes=True,
                                            device=device)

    def nll_metric(Y_test, Mu_test, pred):
        return -float(np.nansum(likelihood.logpdf(
            np.asarray(Y_test, np.float32),
            np.asarray(pred, np.float32)).cpu().numpy()))

    metrics = [
        {"name": "MAE", "fun": lambda Y, Mu, p: mae(Y, p[..., None])},
        {"name": "RMSE",
         "fun": lambda Y, Mu, p: np.sqrt(mse(Y, p[..., None]))},
        {"name": "NLL", "fun": nll_metric},
    ]
    truth = None
    if args.truth is not None:
        truth = np.load(args.truth)
        metrics.append({"name": "MAE (truth)",
                        "fun": lambda Y, Mu, p: mae(Mu, p)})
        metrics.append({"name": "RMSE (truth)",
                        "fun": lambda Y, Mu, p: np.sqrt(mse(Mu, p))})

    nmodels, nmetrics, ntrials = len(MODELS), len(metrics), len(args.seeds)
    results = np.zeros((ntrials, nmetrics, nmodels))
    for trial, seed in enumerate(args.seeds):
        cur = os.path.join(args.outdir, "seed{}".format(seed))
        if os.path.exists(os.path.join(cur, "held_out.npy")):
            held_out = np.load(os.path.join(cur, "held_out.npy"))
        else:
            held_out = np.array(list(np.ndindex(Y.shape[:2]))).T
        Y_test = Y[held_out[0], held_out[1]]
        preds = [m["preprocess"](np.load(os.path.join(cur, m["file"])))
                 [held_out[0], held_out[1]] for m in MODELS]
        Mu_test = (truth[held_out[0], held_out[1]]
                   if truth is not None else None)
        for metidx, metric in enumerate(metrics):
            results[trial, metidx] = [metric["fun"](Y_test, Mu_test, p)
                                      for p in preds]

    print(("{:<20}" * (nmetrics + 1)).format(
        *(["Model"] + [m["name"] for m in metrics])))
    for i, model in enumerate(MODELS):
        row = "".join("{:<20}".format("{:.2f} +/- {:.2f}".format(r, s))
                      for r, s in zip(results[:, :, i].mean(axis=0),
                                      results[:, :, i].std(axis=0)
                                      / np.sqrt(ntrials)))
        print("{:<20}".format(model["name"]) + row)

    if args.latex:
        print("Latex table:")
        print("\\begin{tabular}{" + "l" + "c" * nmetrics + "}")
        print(" & ".join(["Model"] + [m["name"] for m in metrics]),
              " \\\\ \\hline")
        mean_results = results.mean(axis=0)
        best = [int(np.argmin(r)) for r in mean_results]
        for i, model in enumerate(MODELS):
            print(" & ".join(
                [model["name"]]
                + [("{:.2f}".format(r) if b != i
                    else "\\textbf{" + "{:.2f}".format(r) + "}")
                   for r, b in zip(mean_results[:, i], best)]), " \\\\")
        print("\\end{tabular}")
    return results


if __name__ == "__main__":
    main()
