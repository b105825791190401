"""Biomarker screening from posterior embeddings.

Counterpart of functionalmf_tpu/apps/doseresponse/feature_importance.py
(reference doseresponse/feature_importance.py): correlates the posterior
feature probabilities W U^T with the drug-response AUC (trapezoidal
integral of the curve) by a linear regression per (feature, drug). The
fits come back as a list of dicts, ranked tables are printed.
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

FIT_FIELDS = ("slope", "intercept", "r-value", "p-value", "stderr")


def feature_auc_screen(Ws, Vs, Us, feature_names, drug_names, ntop=10,
                       min_std=0.05, verbose=True):
    """One dict per (feature, drug) pair whose probabilities and AUCs both
    vary: ``feature``, ``drug`` and the linregress fields
    (feature_importance.py:39-63)."""
    from scipy.stats import linregress

    feature_probs = np.einsum("znk,zmk->znm", Ws, Us).mean(axis=0)
    auc_scores = np.trapezoid(
        np.einsum("znk,zmtk->znmt", Ws, Vs),
        dx=1 / (Vs.shape[-2] - 1), axis=-1).mean(axis=0)

    fits = []
    for fname, x in zip(feature_names, feature_probs.T):
        for dname, y in zip(drug_names, auc_scores.T):
            if x.std() < min_std or y.std() < min_std:
                continue
            fit = linregress(x, y)
            fits.append(dict(feature=fname, drug=dname,
                             **dict(zip(FIT_FIELDS, fit[:5]))))
    if verbose and fits:
        order = np.argsort([f["r-value"] for f in fits])

        def show(title, idx):
            print(title)
            for i in idx:
                f = fits[i]
                print("  {:<16}{:<16}".format(str(f["feature"]),
                                              str(f["drug"]))
                      + " ".join("{}={:.4g}".format(a, f[a])
                                 for a in FIT_FIELDS))
        show("Top {} resistant:".format(ntop), order[-ntop:][::-1])
        print()
        show("Top {} sensitive:".format(ntop), order[:ntop])
    return fits


def main(argv=None):
    parser = argparse.ArgumentParser(description="Feature importance screen.")
    parser.add_argument("--outdir", default="doseresponse/data/sim/")
    parser.add_argument("--features", required=True)
    parser.add_argument("--drugs")
    parser.add_argument("--ntop", type=int, default=10)
    args = parser.parse_args(argv)

    with open(args.features, newline="") as f:
        features = next(csv.reader(f))[1:]
    drugs = (np.load(os.path.join(args.outdir, "drugs.npy"))
             if args.drugs is None else np.load(args.drugs))
    Ws = np.load(os.path.join(args.outdir, "btf_w.npy"))
    Vs = np.load(os.path.join(args.outdir, "btf_v.npy"))
    Us = np.load(os.path.join(args.outdir, "btf_u.npy"))
    return feature_auc_screen(Ws, Vs, Us, features, drugs, ntop=args.ntop)


if __name__ == "__main__":
    main()
