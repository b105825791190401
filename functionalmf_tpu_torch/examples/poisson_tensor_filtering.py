"""Constrained Poisson functional matrix factorization, the flagship
example, on the port.

Counterpart of examples/poisson_tensor_filtering.py: a piecewise-constant
nonnegative truth (11x12x20), the curves of the first 3x3 rows and columns
held out, and five kinds of model compared on nine metrics (held-out MAE,
RMSE and Poisson NLL, MAE and RMSE against the true rate, and the 50, 75,
90 and 95% coverage of it): NMF, PGDS at tau 0.25, 0.5 and 1, the
NegBinom BTF and the constrained Poisson BTF (positivity, optionally
monotone, through GASS; its candidates in the CUDA kernels on the card).
``FAST=1`` in the environment runs the short sweep counts. The table is
saved to data/poisson_tensor_filtering/seed<seed>-nembeds<nembeds>/
results.npy, which ``agg`` averages over seeds and widths.

    python -m functionalmf_tpu_torch.examples.poisson_tensor_filtering \\
        <nembeds> <seed> [--device cuda]
    python -m functionalmf_tpu_torch.examples.poisson_tensor_filtering agg
"""
import argparse
import os
import time

import numpy as np
import torch

from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering,
    NegativeBinomialBayesianTensorFiltering, POISSON)
from functionalmf_tpu_torch.pgds import fit_pgds
from functionalmf_tpu_torch.utils.metrics import (coverage_at, ilogit, mae,
                                                  mse)
from functionalmf_tpu_torch.utils.nmf import tensor_nmf

nrows, ncols, ndepth = 11, 12, 20
nreplicates = 1
OUT_ROOT = os.path.join("data", "poisson_tensor_filtering")
PGDS_TAUS = (0.25, 0.5, 1)


def rowcol_loglikelihood(Y, WV, W, V, row=None, col=None):
    """The Poisson log-likelihood of one row (or column) of curves."""
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


# the Poisson cell without its y-only term, 0 on NaN: the CellFn the CUDA
# kernels have compiled in
rowcol_cellfn = POISSON


def init_model(nembeds, tf_order=0, lam2=0.1, sigma2=0.5, monotone=False,
               seed=0, device="cuda", **kwargs):
    """Positivity [I | 0] on every curve; ``monotone`` adds
    v_t - v_{t+1} >= -0.01."""
    Constraints = np.concatenate([np.eye(ndepth), np.zeros((ndepth, 1))],
                                 axis=1)
    if monotone:
        C_mono = np.array([np.concatenate([np.zeros(i), [1, -1],
                                           np.zeros(ndepth - i - 2), [-1e-2]])
                           for i in range(ndepth - 1)])
        Constraints = np.concatenate([Constraints, C_mono], axis=0)
    return ConstrainedNonconjugateBayesianTensorFiltering(
        nrows, ncols, ndepth, rowcol_loglikelihood, Constraints,
        device=device, nembeds=nembeds, tf_order=tf_order,
        sigma2_init=sigma2, lam2_init=lam2, seed=seed,
        loglikelihood_cellfn=rowcol_cellfn, **kwargs)


def setup_sampler(model, Y, monotone=False, rng=None):
    """The NMF warm start, then the scales drawn again from their priors."""
    nmf_W, nmf_V = tensor_nmf(Y, model.nembeds, monotone=monotone, rng=rng)
    model.W = nmf_W
    model.V = nmf_V
    model._init_lam2()
    model._init_Tau2()
    model._init_sigma2()


def create_piecewise_constant(rng, break_prob=0.2, ndims=3):
    W = rng.gamma(1, 1, size=(nrows, ndims))
    if nrows > 1:
        W[np.triu_indices(ndims, k=1)] = 0
    V = np.zeros((ncols, ndepth, ndims))
    for j in range(ncols):
        V[j, -1] = rng.gamma(1, 1, size=ndims)
        for k in range(ndepth - 2, -1, -1):
            V[j, k] = V[j, k + 1]
            if rng.random() < break_prob:
                V[j, k] += rng.gamma(1, 1, size=ndims)
    return W, V


def _poisson_nll(Y, rate):
    from scipy.stats import poisson
    with np.errstate(all="ignore"):
        return -np.nansum(poisson.logpmf(Y, np.clip(rate, 1e-10, None)))


METRICS = [
    {"name": "MAE (held out)", "fun": lambda Y, Mu, pred, samples: mae(Y[:3, :3], pred[:3, :3, ..., None])},
    {"name": "RMSE (held out)", "fun": lambda Y, Mu, pred, samples: np.sqrt(mse(Y[:3, :3], pred[:3, :3, ..., None]))},
    {"name": "NLL (held out)", "fun": lambda Y, Mu, pred, samples: _poisson_nll(Y[:3, :3], pred[:3, :3, ..., None])},
    {"name": "MAE (true rate)", "fun": lambda Y, Mu, pred, samples: mae(Mu, pred)},
    {"name": "RMSE (true rate)", "fun": lambda Y, Mu, pred, samples: np.sqrt(mse(Mu, pred))},
    {"name": "50% Coverage", "fun": lambda Y, Mu, pred, samples: coverage_at(Mu, samples, 50)},
    {"name": "75% Coverage", "fun": lambda Y, Mu, pred, samples: coverage_at(Mu, samples, 75)},
    {"name": "90% Coverage", "fun": lambda Y, Mu, pred, samples: coverage_at(Mu, samples, 90)},
    {"name": "95% Coverage", "fun": lambda Y, Mu, pred, samples: coverage_at(Mu, samples, 95)},
]

MODEL_NAMES = (["NMF"] + [f"PGDS tau={t}" for t in PGDS_TAUS]
               + ["NB-BTF", "Poisson-BTF"])


def _outdir(seed, nembeds):
    return os.path.join(OUT_ROOT, "seed{}-nembeds{}".format(seed, nembeds))


def _print_table(names, metrics, res):
    print(("{:<18}" * (len(metrics) + 1)).format(
        *(["Model"] + [m["name"] for m in metrics])))
    for i, m in enumerate(names):
        print("{:<18}".format(m)
              + "".join("{:<18.2f}".format(r) for r in res[:, i]))


def agg_results(models, metrics, nembeds_options=(2, 3, 5, 10),
                seeds=(1, 2, 3, 4, 5)):
    """The mean table over seeds, for each width, of the saved runs."""
    out = {}
    for ne in nembeds_options:
        res = np.array([np.load(os.path.join(_outdir(seed, ne),
                                             "results.npy"))
                        for seed in seeds]).mean(axis=0)
        print("d={}".format(ne))
        _print_table(list(models), metrics, res)
        out[ne] = res
    return out


def main(argv=None, nburn=None, nthin=None, nsamples=None):
    """The comparison for one width and seed; returns the (9, 6) metrics
    table with the model names, each arm's seconds, and the Poisson BTF's
    model and results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", help="<nembeds> <seed>, or agg")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if "agg" in args.args:
        return agg_results(MODEL_NAMES, METRICS)
    nembeds = int(args.args[0]) if len(args.args) > 0 else 3
    seed = int(args.args[1]) if len(args.args) > 1 else 1
    if nburn is None:
        nburn, nthin, nsamples = ((1000, 2, 500) if os.environ.get("FAST")
                                  else (5000, 5, 1000))
    device = torch.device(args.device)

    rng = np.random.default_rng(seed)
    W_true, V_true = create_piecewise_constant(rng)
    Mu = np.einsum("nk,mtk->nmt", W_true, V_true)
    Y = rng.poisson(Mu[..., None], size=(nrows, ncols, ndepth, nreplicates)
                    ).astype(float)
    Y_missing = Y.copy()
    Y_missing[:3, :3] = np.nan

    print("Seed {} d={}".format(seed, nembeds))
    models, seconds = [], {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        return out

    W_nmf, V_nmf = timed("NMF", lambda: tensor_nmf(Y_missing, nembeds,
                                                   rng=rng))
    Mu_nmf = (W_nmf[:, None, None] * V_nmf[None]).sum(axis=-1)
    models.append({"name": "NMF", "fit": Mu_nmf, "samples": Mu_nmf[None]})

    for tau in PGDS_TAUS:
        name = f"PGDS tau={tau}"
        print(f"Fitting PGDS k={nembeds} tau={tau}")
        Mu_pgds, _ = timed(name, lambda: fit_pgds(
            Y_missing.sum(axis=-1), nembeds, nburn=nburn, nthin=nthin,
            nsamples=nsamples, tau=tau, nthreads=1, device=device))
        models.append({"name": name,
                       "fit": Mu_pgds.mean(axis=0) / Y_missing.shape[-1],
                       "samples": Mu_pgds})

    nb = NegativeBinomialBayesianTensorFiltering(
        nrows, ncols, ndepth, device=device, nembeds=nembeds, tf_order=0,
        sigma2_init=1, lam2_init=0.1, seed=seed)
    res = timed("NB-BTF", lambda: nb.run_gibbs(
        Y_missing, nburn=nburn, nthin=nthin, nsamples=nsamples,
        print_freq=1000, verbose=True))
    Ps = ilogit(np.clip(np.einsum("znk,zmtk->znmt", res["W"], res["V"]),
                        -10, 10))
    Mu_nb = res["R"] * Ps / (1 - Ps)
    models.append({"name": "NB-BTF", "fit": Mu_nb.mean(0), "samples": Mu_nb})

    model = init_model(nembeds, seed=seed, device=device)
    setup_sampler(model, Y_missing, rng=rng)
    results = timed("Poisson-BTF", lambda: model.run_gibbs(
        Y_missing, nburn=nburn, nthin=nthin, nsamples=nsamples,
        print_freq=1000, verbose=True))
    Mu_hat = np.einsum("znk,zmtk->znmt", results["W"], results["V"])
    models.append({"name": "Poisson-BTF", "fit": Mu_hat.mean(0),
                   "samples": Mu_hat})

    metric_results = np.zeros((len(METRICS), len(models)))
    for mi, m in enumerate(models):
        metric_results[:, mi] = [metric["fun"](Y, Mu, m["fit"], m["samples"])
                                 for metric in METRICS]
    _print_table([m["name"] for m in models], METRICS, metric_results)
    print("seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))

    outdir = _outdir(seed, nembeds)
    os.makedirs(outdir, exist_ok=True)
    np.save(os.path.join(outdir, "results"), metric_results)
    return dict(table=metric_results, names=[m["name"] for m in models],
                seconds=seconds, model=model, results=results)


if __name__ == "__main__":
    main()
