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
    create_wiggly_with_jumps, ncols, ndepth, nembeds, nrows)
from functionalmf_tpu_torch.utils.metrics import (coverage_at, ilogit, mae,
                                                  mse)

nreplicates = 10


def init_model(tf_order=2, lam2=0.1, sigma2=0.5, seed=0, device="cuda"):
    return BinomialBayesianTensorFiltering(
        nrows, ncols, ndepth, device=device, nembeds=nembeds,
        tf_order=tf_order, sigma2_init=sigma2, lam2_init=lam2, seed=seed)


def main(argv=None, nburn=None, nthin=None, nsamples=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if nburn is None:
        nburn, nthin, nsamples = ((1000, 1, 500) if os.environ.get("FAST")
                                  else (10000, 10, 1000))
    rng = np.random.default_rng(args.seed)

    model = init_model(seed=args.seed, device=args.device)
    # the binomial variant's jumps are small: coefficient scale 0.1
    W_true, V_true = create_wiggly_with_jumps(rng, coef_scale=0.1)
    Mu = np.einsum("nk,mtk->nmt", W_true, V_true)
    print("Mean ranges: [{},{}]".format(Mu.min(), Mu.max()))

    N = np.full((nrows, ncols, ndepth), nreplicates).astype(float)
    Y = rng.binomial(nreplicates, ilogit(Mu)).astype(float)
    Y_missing = Y.copy()
    Y_missing[:3, :3] = np.nan
    N_missing = N.copy()
    N_missing[np.isnan(Y_missing)] = np.nan

    results = model.run_gibbs((Y_missing, N_missing), nburn=nburn,
                              nthin=nthin, nsamples=nsamples, print_freq=50,
                              verbose=True)
    P_hat = ilogit(np.clip(np.einsum("znk,zmtk->znmt", results["W"],
                                     results["V"]), -10, 10))
    P_true = ilogit(Mu)
    out = dict(mae=mae(P_true[:3, :3], P_hat.mean(0)[:3, :3]),
               rmse=np.sqrt(mse(P_true[:3, :3], P_hat.mean(0)[:3, :3])),
               coverage=coverage_at(P_true, P_hat, 90))
    print("held-out MAE(P):  {:.4f}".format(out["mae"]))
    print("held-out RMSE(P): {:.4f}".format(out["rmse"]))
    print("90% coverage(P):  {:.1f}%".format(out["coverage"]))
    return out


if __name__ == "__main__":
    main()
