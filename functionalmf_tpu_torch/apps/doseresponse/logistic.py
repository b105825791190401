"""Functional logistic matrix factorization baseline for dose-response.

Counterpart of functionalmf_tpu/apps/doseresponse/logistic.py (reference
doseresponse/logistic.py:1-190): E[Y_ijt] = ilogit(<w_i, v_j> conc_t +
a_i + b_j), every parameter fitted jointly by one bounded L-BFGS-B run
(scipy) on the host; the loss and its gradient come from
``torch.autograd`` in float64 on the device the caller names: the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import math
import os
from collections import defaultdict

import numpy as np
import torch

from functionalmf_tpu_torch._runtime import resolve_device
from functionalmf_tpu_torch.apps.doseresponse.empirical_bayes import (
    _unique, read_csv_columns)
from functionalmf_tpu_torch.utils.metrics import mse


def estimate_likelihood(df, verbose=False):
    """Control-normalised clipped mean tensor (reference logistic.py:6-40)
    from a dict of columns (``read_csv_columns``)."""
    cells = _unique(df["cell line"])
    drugs = _unique(df["drug"])
    concentrations = sorted(c for c in set(df["concentration"])
                            if not math.isnan(c))
    outcomes = defaultdict(list)
    controls = defaultdict(list)
    cell_idx = {c: i for i, c in enumerate(cells)}
    drug_idx = {d: i for i, d in enumerate(drugs)}
    conc_idx = {c: i for i, c in enumerate(concentrations)}
    for cell_name, drug_name, conc, outcome in zip(
            df["cell line"], df["drug"], df["concentration"], df["outcome"]):
        if math.isnan(conc):
            controls[(cell_idx[cell_name], drug_idx[drug_name])].append(
                outcome)
        else:
            outcomes[(cell_idx[cell_name], drug_idx[drug_name],
                      conc_idx[conc])].append(outcome)

    Y = np.full((len(cells), len(drugs), len(concentrations)), np.nan)
    for cell in range(len(cells)):
        for drug in range(len(drugs)):
            if (cell, drug) not in controls:
                continue
            mu = np.mean(controls[(cell, drug)])
            for t in range(len(concentrations)):
                obs = outcomes.get((cell, drug, t), [])
                if obs:
                    Y[cell, drug, t] = np.clip(np.mean(obs) / mu, 0, 1)
    return Y, cells, drugs, concentrations


def fit_logistic_factors(Y, nembeds, max_steps=100, concentrations=None,
                         verbose=False, tol=1e-4, regularizer=1e-4, rng=None,
                         *, device):
    """Fit E[Y_ijt] = ilogit(<w_i, v_j> conc_t + a_i + b_j) by one bounded
    L-BFGS-B run over all (n + m)(k + 1) parameters, box [-10, 10], the
    squared error over the observed cells plus ``regularizer`` times the
    mean squared parameter, evaluated with its gradient on ``device``
    (``"cuda"`` raises without a card). Returns (Mu, W, V, a, b)."""
    from scipy.optimize import minimize
    rng = np.random.default_rng() if rng is None else rng
    device = resolve_device(device)
    n, m, T = Y.shape
    k = int(nembeds)
    if concentrations is None:
        concentrations = np.arange(T)
    conc = torch.as_tensor(np.asarray(concentrations, dtype=float),
                           device=device)
    obs = torch.as_tensor(~np.isnan(Y), device=device)
    Yz = torch.as_tensor(np.where(np.isnan(Y), 0.0, Y), device=device)
    nparams = (n + m) * (k + 1)
    sizes = (n * k, m * k, n, m)

    def unpack(x):
        Wf, Vf, a, b = torch.split(x, sizes)
        return Wf.reshape(n, k), Vf.reshape(m, k), a, b

    def predict(x):
        W, V, a, b = unpack(x)
        z = ((W @ V.T)[:, :, None] * conc + a[:, None, None]
             + b[None, :, None])
        return torch.sigmoid(z)

    def value_and_grad(x_np):
        x = torch.tensor(x_np, dtype=torch.float64, device=device,
                         requires_grad=True)
        r = torch.where(obs, predict(x) - Yz, 0.0)
        loss = (r * r).sum() + regularizer * (x * x).mean()
        loss.backward()
        return float(loss.detach()), x.grad.cpu().numpy()

    x0 = np.concatenate([
        rng.normal(0, 0.1, size=n * k),
        rng.normal(0, 0.1, size=m * k),
        rng.normal(size=n),
        rng.normal(size=m),
    ])
    res = minimize(value_and_grad, x0, jac=True, method="L-BFGS-B",
                   bounds=[(-10, 10)] * nparams,
                   options={"maxiter": 200 * max_steps, "ftol": tol * 1e-6})
    if verbose:
        print(f"logistic MF: {res.nit} L-BFGS iters, loss {res.fun:.5f}")
    x = torch.as_tensor(res.x, device=device)
    W, V, a, b = (t.cpu().numpy() for t in unpack(x))
    with torch.no_grad():
        Mu = predict(x).cpu().numpy()
    return Mu, W, V, a, b


def select_nonempty(Y, nholdout, rng=None):
    """Holdout selection that leaves no row and no column empty
    (logistic.py:94-107)."""
    rng = np.random.default_rng() if rng is None else rng
    options = [idx for idx in np.ndindex(Y.shape[:2])
               if not np.all(np.isnan(Y[idx]))]

    def pick():
        sel = np.array([options[i] for i in
                        rng.choice(len(options), replace=False,
                                   size=nholdout)])
        Yc = Y.copy()
        Yc[sel[:, 0], sel[:, 1]] = np.nan
        bad = (np.any(np.all(np.isnan(Yc), axis=(1, 2)))
               | np.any(np.all(np.isnan(Yc), axis=(0, 2))))
        return sel, Yc, bad

    sel, Yc, bad = pick()
    while bad:
        sel, Yc, bad = pick()
    return sel, Yc


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Functional logistic MF for dose-response modeling.")
    parser.add_argument("--data", default="doseresponse/data/sim/data.csv")
    parser.add_argument("--outdir", default="doseresponse/data/sim/")
    parser.add_argument("--nembeds", nargs="+", type=int, default=[1, 3, 5, 8])
    parser.add_argument("--nfolds", type=int, default=5)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--nholdout", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    Y, cells, drugs, concentrations = estimate_likelihood(
        read_csv_columns(args.data))
    nrows, ncols, ndepth = Y.shape
    print("Y shape: {}".format(Y.shape))

    if args.nholdout > 0:
        held_out, Y = select_nonempty(Y, args.nholdout, rng=rng)

    print("Selecting nembeds via CV")
    folds = [((f * nrows // args.nfolds, (f + 1) * nrows // args.nfolds),
              (f * ncols // args.nfolds, (f + 1) * ncols // args.nfolds))
             for f in range(args.nfolds)]
    cv_results = np.zeros((args.nfolds, len(args.nembeds)))
    for fold_idx, fold in enumerate(folds):
        Y_cv = Y.copy()
        Y_cv[fold[0][0]:fold[0][1], fold[1][0]:fold[1][1]] = np.nan
        for k_idx, k in enumerate(args.nembeds):
            Mu_cv, *_ = fit_logistic_factors(Y_cv, k,
                                             concentrations=concentrations,
                                             rng=rng, device=device)
            cv_results[fold_idx, k_idx] = mse(
                Y[fold[0][0]:fold[0][1], fold[1][0]:fold[1][1]],
                Mu_cv[fold[0][0]:fold[0][1], fold[1][0]:fold[1][1]])
    best_k = args.nembeds[int(np.argmin(cv_results.mean(axis=0)))]
    print("Best K: {}".format(best_k))

    Mu_logistic, W, V, a, b = fit_logistic_factors(
        Y, best_k, concentrations=concentrations, rng=rng, device=device)

    os.makedirs(args.outdir, exist_ok=True)
    np.save(os.path.join(args.outdir, "y_logistic"), Y)
    np.save(os.path.join(args.outdir, "W_logistic"), W)
    np.save(os.path.join(args.outdir, "V_logistic"), V)
    np.save(os.path.join(args.outdir, "a_logistic"), a)
    np.save(os.path.join(args.outdir, "b_logistic"), b)
    np.save(os.path.join(args.outdir, "logistic_mf"), Mu_logistic)


if __name__ == "__main__":
    main()
