"""Dose-response data simulator (reference doseresponse/sim.py:1-124).

Counterpart of functionalmf_tpu/apps/doseresponse/sim.py: gamma
cell-count plates with ilogit effect curves and binary cell-line features,
written in the CSV schema fit.py reads. Both CSVs are written with the
standard ``csv`` module.

    python -m functionalmf_tpu_torch.apps.doseresponse.sim --outdir d
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from functionalmf_tpu_torch.utils.metrics import ilogit


def simulate(k=3, n=10, m=11, t=9, r=6, p=20, n_missing=2, p_missing=2,
             seed=42):
    """Returns dict with obs, effects, W, V, U, features, concentrations."""
    rng = np.random.default_rng(seed)
    W = rng.gamma(3, 1, size=(n, k))
    V = np.cumsum((rng.random(size=(m, t, 1))
                   <= np.linspace(0.05, 0.5, t)[None, :, None])
                  * rng.gamma(1, 0.15, size=(m, t, k)), axis=1)
    U = rng.normal(0, 1 / np.sqrt(k), size=(p, k))
    effects = ilogit(-(W[:, None, None] * V[None, :, :]).sum(axis=-1) + 3)

    means = rng.normal(1, 0.1, size=(n, m, t + 1, 1))
    scales = np.exp(rng.normal(-7, 1, size=means.shape))
    shapes = means / scales
    obs = rng.gamma(np.maximum(shapes, 1e-8), scales, size=(n, m, t + 1, r))
    obs[:, :, 1:] *= effects[..., None]

    concentrations = np.concatenate([[-10], np.linspace(-9.12, -5.3, t)])
    features = (rng.random(size=(n, p)) <= ilogit(W.dot(U.T))).astype(int)
    features = features[p_missing:]
    obs = obs[:-n_missing]

    return dict(obs=obs, effects=effects, W=W, V=V, U=U, features=features,
                concentrations=concentrations, n=n, m=m, t=t, r=r,
                n_missing=n_missing, p_missing=p_missing)


def write_csv(sim, outdir):
    os.makedirs(outdir, exist_ok=True)
    np.save(os.path.join(outdir, "obs"), sim["obs"])
    np.save(os.path.join(outdir, "truth"), sim["effects"])
    np.save(os.path.join(outdir, "w"), sim["W"])
    np.save(os.path.join(outdir, "v"), sim["V"])
    np.save(os.path.join(outdir, "u"), sim["U"])
    with open(os.path.join(outdir, "features.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([""] + ["Feature{}".format(i)
                                for i in range(sim["features"].shape[1])])
        for i, row in zip(range(sim["p_missing"], sim["n"]), sim["features"]):
            writer.writerow(["Tumor{}".format(i)] + [int(x) for x in row])
    with open(os.path.join(outdir, "data.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["cell line", "drug", "concentration", "outcome"])
        for i in range(sim["n"] - sim["n_missing"]):
            for j in range(sim["m"]):
                for t in range(sim["t"] + 1):
                    for r in range(sim["r"]):
                        writer.writerow([
                            "Tumor{}".format(i), "Drug{}".format(j),
                            "" if t == 0
                            else "{:.2f}".format(sim["concentrations"][t]),
                            sim["obs"][i, j, t, r]])


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generates simulated data for drug response modeling.")
    parser.add_argument("--k", type=int, default=3)
    parser.add_argument("--n", type=int, default=10)
    parser.add_argument("--m", type=int, default=11)
    parser.add_argument("--t", type=int, default=9)
    parser.add_argument("--r", type=int, default=6)
    parser.add_argument("--p", type=int, default=20)
    parser.add_argument("--n_missing", type=int, default=2)
    parser.add_argument("--p_missing", type=int, default=2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--outdir", default="doseresponse/data/sim")
    args = parser.parse_args(argv)
    sim = simulate(args.k, args.n, args.m, args.t, args.r, args.p,
                   args.n_missing, args.p_missing, args.seed)
    write_csv(sim, args.outdir)
    print("wrote {}".format(args.outdir))


if __name__ == "__main__":
    main()
