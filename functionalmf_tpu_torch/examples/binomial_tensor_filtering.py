"""Binomial functional matrix factorization example on the port.

Counterpart of examples/binomial_tensor_filtering.py (reference
examples/binomial_tensor_filtering.py:1-113): logistic link on the wiggly
truth, (Y, N) data with N = 10 trials a cell. ``FAST=1`` in the
environment runs the short sweep counts.

    python -m functionalmf_tpu_torch.examples.binomial_tensor_filtering \\
        [--seed 1] [--device cuda]
"""
import argparse
import os

import numpy as np

from functionalmf_tpu_torch import BinomialBayesianTensorFiltering
from functionalmf_tpu_torch.examples.gaussian_tensor_filtering import (
    create_wiggly_with_jumps, ncols, ndepth, nembeds, nrows, score)
from functionalmf_tpu_torch.utils.metrics import ilogit

nreplicates = 10
SWEEPS = (10000, 10, 1000)    # nburn, nthin, nsamples
FAST_SWEEPS = (1000, 1, 500)


def init_model(tf_order=2, lam2=0.1, sigma2=0.5, seed=0, nchains=1,
               device="cuda"):
    return BinomialBayesianTensorFiltering(
        nrows, ncols, ndepth, device=device, nembeds=nembeds,
        tf_order=tf_order, sigma2_init=sigma2, lam2_init=lam2, seed=seed,
        nchains=nchains)


def make_data(rng):
    """((Y, N) with the [:3, :3] curves held out, the truth P the metrics
    read)."""
    # the binomial variant's jumps are small: coefficient scale 0.1
    W_true, V_true = create_wiggly_with_jumps(rng, coef_scale=0.1)
    P = ilogit(np.einsum("nk,mtk->nmt", W_true, V_true))
    N = np.full((nrows, ncols, ndepth), nreplicates).astype(float)
    Y = rng.binomial(nreplicates, P).astype(float)
    Y[:3, :3] = np.nan
    N[np.isnan(Y)] = np.nan
    return (Y, N), P


def scored_draws(results):
    """The draws of what the metrics read: P, (draws, n, m, T)."""
    return ilogit(np.clip(np.einsum("znk,zmtk->znmt", results["W"],
                                    results["V"]), -10, 10))


def main(argv=None, nburn=None, nthin=None, nsamples=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if nburn is None:
        nburn, nthin, nsamples = (FAST_SWEEPS if os.environ.get("FAST")
                                  else SWEEPS)
    rng = np.random.default_rng(args.seed)

    model = init_model(seed=args.seed, device=args.device)
    data, P = make_data(rng)
    print("P ranges: [{},{}]".format(P.min(), P.max()))

    results = model.run_gibbs(data, nburn=nburn, nthin=nthin,
                              nsamples=nsamples, print_freq=50, verbose=True)
    out = score(P, scored_draws(results))
    print("held-out MAE(P):  {:.4f}".format(out["mae"]))
    print("held-out RMSE(P): {:.4f}".format(out["rmse"]))
    print("90% coverage(P):  {:.1f}%".format(out["coverage"]))
    return out


if __name__ == "__main__":
    main()
