"""Gaussian functional matrix factorization example on the port.

Counterpart of examples/gaussian_tensor_filtering.py (reference
examples/gaussian_tensor_filtering.py:1-107): synthetic wiggly-with-jumps
truth, an 11x12x20 tensor, the [:3, :3] block held out; run Gibbs, report
the held-out error and coverage.

    python -m functionalmf_tpu_torch.examples.gaussian_tensor_filtering \\
        [--seed 1] [--device cuda]
"""
import argparse

import numpy as np

from functionalmf_tpu_torch import GaussianBayesianTensorFiltering
from functionalmf_tpu_torch.utils.metrics import coverage_at, mae, mse

nrows, ncols, ndepth = 11, 12, 20
nembeds = 3
nreplicates = 1
nu2_truth = 9
SWEEPS = (1000, 1, 1000)    # nburn, nthin, nsamples


def init_model(tf_order=2, lam2=0.1, sigma2=0.5, nu2=1, seed=0, nchains=1,
               device="cuda"):
    return GaussianBayesianTensorFiltering(
        nrows, ncols, ndepth, device=device, nembeds=nembeds,
        tf_order=tf_order, sigma2_init=sigma2, lam2_init=lam2, nu2_init=nu2,
        seed=seed, nchains=nchains)


def create_wiggly_with_jumps(rng, break_prob=0.3, coef_scale=1.0):
    W = rng.normal(0, 1, size=(nrows, nembeds))
    if nrows > 1:
        W[np.triu_indices(nembeds, k=1)] = 0
    V = np.zeros((ncols, ndepth, nembeds))
    for j in range(ncols):
        x = rng.normal(0, 1, size=nembeds)
        coef = rng.normal(0, coef_scale)
        V[j, -1] = x
        for k in range(ndepth - 2, -1, -1):
            V[j, k] = V[j, k + 1]
            if rng.random() < break_prob:
                coef = rng.normal(0, coef_scale)
                x = rng.normal(0, 1, size=nembeds)
            V[j, k] += coef * x
    return W, V


def make_data(rng):
    """(the observations with the [:3, :3] curves held out, the truth Mu
    the metrics read)."""
    W_true, V_true = create_wiggly_with_jumps(rng)
    Mu = np.einsum("nk,mtk->nmt", W_true, V_true)
    Y = rng.normal(Mu[..., None], np.sqrt(nu2_truth),
                   size=(nrows, ncols, ndepth, nreplicates))
    Y[:3, :3] = np.nan
    return Y, Mu


def scored_draws(results):
    """The draws of what the metrics read: Mu, (draws, n, m, T)."""
    return np.einsum("znk,zmtk->znmt", results["W"], results["V"])


def score(truth, draws):
    """Held-out MAE and RMSE of the posterior mean, 90% coverage of the
    truth over the whole tensor (the Binomial and NegBinom examples score
    the same way)."""
    mean = draws.mean(0)
    return dict(mae=mae(truth[:3, :3], mean[:3, :3]),
                rmse=np.sqrt(mse(truth[:3, :3], mean[:3, :3])),
                coverage=coverage_at(truth, draws, 90))


def main(argv=None, nburn=SWEEPS[0], nthin=SWEEPS[1], nsamples=SWEEPS[2]):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)

    model = init_model(seed=args.seed, device=args.device)
    Y, Mu = make_data(rng)
    print("Mean ranges: [{},{}]".format(Mu.min(), Mu.max()))

    results = model.run_gibbs(Y, nburn=nburn, nthin=nthin,
                              nsamples=nsamples, print_freq=50, verbose=True)
    out = dict(score(Mu, scored_draws(results)),
               nu2=float(results["nu2"].mean()))
    print("held-out MAE:  {:.4f}".format(out["mae"]))
    print("held-out RMSE: {:.4f}".format(out["rmse"]))
    print("90% coverage:  {:.1f}%".format(out["coverage"]))
    print("nu2 estimate:  {:.3f} (truth {})".format(out["nu2"], nu2_truth))
    return out


if __name__ == "__main__":
    main()
