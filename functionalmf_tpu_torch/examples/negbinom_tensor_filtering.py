"""Negative-Binomial functional matrix factorization example on the port.

Counterpart of examples/negbinom_tensor_filtering.py: gamma-Poisson truth
with one dispersion a row, rdims=(1, 2), recovery of Mu = R P / (1 - P).
``FAST=1`` in the environment runs the short sweep counts.

    python -m functionalmf_tpu_torch.examples.negbinom_tensor_filtering \\
        [--seed 42] [--device cuda]
"""
import argparse
import os

import numpy as np

from functionalmf_tpu_torch import NegativeBinomialBayesianTensorFiltering
from functionalmf_tpu_torch.examples.gaussian_tensor_filtering import score
from functionalmf_tpu_torch.utils.metrics import ilogit

nrows, ncols, ndepth = 11, 12, 20
nembeds = 3
nreplicates = 1
SWEEPS = (10000, 1, 2000)    # nburn, nthin, nsamples
FAST_SWEEPS = (1000, 1, 500)


def init_model(tf_order=2, lam2=0.1, sigma2=0.5, seed=0, nchains=1,
               device="cuda"):
    return NegativeBinomialBayesianTensorFiltering(
        nrows, ncols, ndepth, device=device, nembeds=nembeds,
        tf_order=tf_order, sigma2_init=sigma2, lam2_init=lam2, rdims=(1, 2),
        seed=seed, nchains=nchains)


def create_piecewise_constant(rng, break_prob=0.2):
    W = rng.gamma(1, 1, size=(nrows, nembeds))
    if nrows > 1:
        W[np.triu_indices(nembeds, k=1)] = 0
    V = np.zeros((ncols, ndepth, nembeds))
    for j in range(ncols):
        V[j, -1] = rng.gamma(1, 1, size=nembeds)
        for k in range(ndepth - 2, -1, -1):
            V[j, k] = V[j, k + 1]
            if rng.random() < break_prob:
                V[j, k] += rng.gamma(1, 1, size=nembeds)
    Mu = np.einsum("nk,mzk->nmz", W, V)
    Variance = rng.gamma(1, scale=1, size=(nrows, 1, 1)) * Mu ** 2 + Mu
    P = 1 - Mu / Variance
    R = Mu * (1 - P) / P
    return R, P, Mu, Variance


def make_data(rng):
    """(the counts with the [:3, :3] curves held out, the truth's mean
    R P / (1 - P) the metrics read)."""
    R_true, P_true, _, _ = create_piecewise_constant(rng)
    Mu = R_true * P_true / (1 - P_true)
    Y = rng.poisson(rng.gamma(
        np.maximum(R_true[..., None], 1e-6),
        (P_true / (1 - P_true))[..., None],
        size=(nrows, ncols, ndepth, nreplicates))).astype(float)
    Y[:3, :3] = np.nan
    return Y, Mu


def scored_draws(results):
    """The draws of what the metrics read: the mean R P / (1 - P),
    (draws, n, m, T)."""
    Ps = ilogit(np.clip(np.einsum("znk,zmtk->znmt", results["W"],
                                  results["V"]), -10, 10))
    return results["R"] * Ps / (1 - Ps)


def main(argv=None, nburn=None, nthin=None, nsamples=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if nburn is None:
        nburn, nthin, nsamples = (FAST_SWEEPS if os.environ.get("FAST")
                                  else SWEEPS)
    rng = np.random.default_rng(args.seed)

    model = init_model(seed=args.seed, device=args.device)
    Y, Mu = make_data(rng)

    results = model.run_gibbs(Y, nburn=nburn, nthin=nthin,
                              nsamples=nsamples, print_freq=100, verbose=True)
    out = score(Mu, scored_draws(results))
    print("held-out MAE:  {:.4f}".format(out["mae"]))
    print("held-out RMSE: {:.4f}".format(out["rmse"]))
    print("90% coverage:  {:.1f}%".format(out["coverage"]))
    return out


if __name__ == "__main__":
    main()
