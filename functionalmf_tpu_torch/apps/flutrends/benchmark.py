"""Google Flu Trends benchmark on the port (functionalmf_tpu/apps/
flutrends/benchmark.py; reference flutrends/benchmark.py:1-163).

Gaussian BTF on log state-level flu counts (50 states x 1 x T weeks) with
held-out years, reported as in- and out-of-sample RMSE / MAE and the
coverage of the 95% posterior predictive bands.

    python -m functionalmf_tpu_torch.apps.flutrends.benchmark --device cuda

Data: ``flu_US_states.mat``, ``flu_US_states_train.mat`` and
``held_out_years.npy`` from ``--data-dir`` when present; else the raw
``flu_US.mat`` there, prepared by ``create_datasets.create``; otherwise a
synthetic tensor of the same form (50 x 1 x 370), so the pipeline runs end
to end. ``--bnp`` fits the BNP-CovReg comparison arm (Fox & Dunson 2015,
``bnp_covreg.fit_bnp_covreg``) on ``--device`` and reports its RMSE, MAE
and band coverage; without it, the arm's precomputed means are read from
``flu-states/bnpcovreg_mu_mean.csv`` under ``--data-dir`` when that file
is there.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from functionalmf_tpu_torch import GaussianBayesianTensorFiltering


def predictive_bands(Mu_hat, nu2s, rng, nsim=20, lo=2.5, hi=97.5):
    """Posterior predictive 95% bands per cell from N(Mu_draw, nu2_draw)
    (reference flutrends/benchmark.py:66-76).

    The simulation axis leads before it is merged with the draw axis: with
    it trailing, the reshape would scramble simulations into the time axis
    and spoil every per-cell percentile."""
    draws = Mu_hat[None] + rng.normal(
        0, np.sqrt(nu2s)[None], size=(nsim,) + Mu_hat.shape)
    draws = draws.reshape((-1,) + Mu_hat.shape[1:])
    return (np.percentile(draws, lo, axis=0),
            np.percentile(draws, hi, axis=0))


def coverage(Y, lo, hi, sel):
    """Percent of the cells ``sel`` of Y inside their band [lo, hi]."""
    return 100 - ((Y[sel] < lo[sel]) | (Y[sel] > hi[sel])).mean() * 100


def load_data(data_dir, rng):
    pre = os.path.join(data_dir, "flu_US_states.mat")
    if os.path.exists(pre):
        from scipy.io import loadmat
        Y = loadmat(pre)["data"].T[:, None]
        Yt = loadmat(os.path.join(
            data_dir, "flu_US_states_train.mat"))["data"].T[:, None]
        to_hold = np.load(os.path.join(data_dir, "held_out_years.npy"))
        return np.log(Y), np.log(Yt), to_hold
    raw = os.path.join(data_dir, "flu_US.mat")
    if os.path.exists(raw):
        from functionalmf_tpu_torch.apps.flutrends.create_datasets import (
            create)
        with tempfile.TemporaryDirectory() as tmp:
            data, train, to_hold = create(raw, tmp)
        return np.log(data.T[:, None]), np.log(train.T[:, None]), to_hold
    print("flu data not found in {}; synthesizing".format(data_dir))
    n, T = 50, 370
    base = (np.sin(np.linspace(0, 20, T))[None]
            * rng.normal(1, 0.3, size=(n, 1)) + 5)
    Y = np.exp(base + rng.normal(0, 0.3, size=(n, T)))[:, None]
    train = Y.copy()
    to_hold = np.array([[i, 52 * (i % 6), 52 * (i % 6) + 52]
                        for i in range(n)][:30])
    for i, j, k in to_hold:
        train[i, 0, j:k] = np.nan
    return np.log(Y), np.log(train), to_hold


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Google Flu Trends benchmark")
    parser.add_argument("--data-dir", default=os.environ.get(
        "FLU_DATA_DIR", os.path.join("data", "flutrends")))
    parser.add_argument("--device", default="cuda",
                        help="torch device of the Gibbs sampler, e.g. "
                             "'cuda' or 'cpu'")
    parser.add_argument("--nembeds", type=int, nargs="+", default=[5, 10])
    parser.add_argument("--nburn", type=int, default=100)
    parser.add_argument("--nthin", type=int, default=100)
    parser.add_argument("--nsamples", type=int, default=100)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--nu2-mode", default="scalar",
                        choices=["scalar", "row"],
                        help="'row' samples one observation variance per "
                             "state")
    parser.add_argument("--outdir", default=None)
    parser.add_argument("--bnp", action="store_true",
                        help="fit the BNP-CovReg baseline (Fox & Dunson "
                             "2015) on --device instead of reading "
                             "precomputed MATLAB CSVs")
    parser.add_argument("--bnp-niter", type=int, default=10000,
                        help="BNP-CovReg Gibbs iterations "
                             "(runstuff_varinds_flu_states.m:98)")
    parser.add_argument("--bnp-burn", type=int, default=0,
                        help="BNP-CovReg burn-in (the reference runner "
                             "stores from iteration 1)")
    return parser.parse_args(argv)


def run(args):
    """The benchmark for parsed ``args``. Returns (table, fits): the
    metrics per nembeds and, per nembeds, the results dict of run_gibbs
    with the fitted model; with ``--bnp`` also fits["bnp_covreg"], the
    return dict of ``fit_bnp_covreg``."""
    rng = np.random.default_rng(args.seed)
    Y, Y_train, to_hold = load_data(args.data_dir, rng)
    nrows, ncols, ndepth = Y.shape

    is_missing = np.isnan(Y)
    is_held_out = (~is_missing) & np.isnan(Y_train)
    is_in_sample = (~is_missing) & (~is_held_out)

    table, fits = {}, {}
    for nembeds in args.nembeds:
        model = GaussianBayesianTensorFiltering(
            nrows, ncols, ndepth, device=args.device, nembeds=nembeds,
            tf_order=2, sigma2_init=1, lam2_init=0.1, nu2_init=1,
            seed=args.seed, nu2_mode=args.nu2_mode)
        print("Running Gibbs sampler (k={})".format(nembeds))
        results = model.run_gibbs(Y_train, nburn=args.nburn,
                                  nthin=args.nthin, nsamples=args.nsamples,
                                  print_freq=50, verbose=True)
        fits[nembeds] = (results, model)
        Mu_hat = np.einsum("znk,zmtk->znmt", results["W"], results["V"])
        Mu_mean = Mu_hat.mean(axis=0)
        nu2s = results["nu2"]
        if nu2s.ndim == 2:                       # scalar mode: (S, 1)
            nu2s = nu2s[:, 0][:, None, None, None]
        # row mode: (S, nrows, 1, 1) broadcasts per state
        Y_lower, Y_upper = predictive_bands(Mu_hat, nu2s, rng)

        cov_in = coverage(Y, Y_lower, Y_upper, is_in_sample)
        cov_out = coverage(Y, Y_lower, Y_upper, is_held_out)
        r_in = np.sqrt(np.mean((Y[is_in_sample] - Mu_mean[is_in_sample]) ** 2))
        r_out = np.sqrt(np.mean((Y[is_held_out] - Mu_mean[is_held_out]) ** 2))
        m_in = np.mean(np.abs(Y[is_in_sample] - Mu_mean[is_in_sample]))
        m_out = np.mean(np.abs(Y[is_held_out] - Mu_mean[is_held_out]))

        print("k={}".format(nembeds))
        print("In-sample  coverage: {:.2f}%".format(cov_in))
        print("Out-sample coverage: {:.2f}%".format(cov_out))
        print("In-sample  RMSE: {:.2f}".format(r_in))
        print("Out-sample RMSE: {:.2f}".format(r_out))
        print("In-sample   MAE: {:.2f}".format(m_in))
        print("Out-sample  MAE: {:.2f}".format(m_out))
        table[nembeds] = dict(cov_in=cov_in, cov_out=cov_out, rmse_in=r_in,
                              rmse_out=r_out, mae_in=m_in, mae_out=m_out)

        if args.outdir:
            os.makedirs(args.outdir, exist_ok=True)
            for name, arr in (("mu_mean", Mu_mean), ("y_upper", Y_upper),
                              ("y_lower", Y_lower)):
                np.savetxt(os.path.join(
                    args.outdir, "btf{}_{}.csv".format(nembeds, name)),
                    arr[:, 0], delimiter=",")

    # Fox & Dunson comparison arm (reference flutrends/benchmark.py:146-152
    # reads MATLAB-produced CSVs; --bnp fits it, apps/flutrends/
    # bnp_covreg.py)
    bnp_mu = bnp_cov = None
    if args.bnp:
        from functionalmf_tpu_torch.apps.flutrends.bnp_covreg import (
            fit_bnp_covreg)
        print("Fitting BNP-CovReg (Fox & Dunson 2015), niter={}".format(
            args.bnp_niter))
        out = fit_bnp_covreg(Y_train[:, 0, :], niter=args.bnp_niter,
                             nburn=args.bnp_burn, seed=args.seed,
                             verbose=True, device=args.device)
        fits["bnp_covreg"] = out
        bnp_mu = out["mu"].mean(axis=0)[:, None]        # (nrows, 1, T)
        sd = np.sqrt(out["var_diag"])                   # (S, nrows, T)
        draws = out["mu"][None] + rng.normal(
            size=(20,) + out["mu"].shape) * sd[None]
        draws = draws.reshape((-1,) + out["mu"].shape[1:])[:, :, None]
        lo = np.percentile(draws, 2.5, axis=0)
        hi = np.percentile(draws, 97.5, axis=0)
        bnp_cov = dict(cov_in=coverage(Y, lo, hi, is_in_sample),
                       cov_out=coverage(Y, lo, hi, is_held_out))
        if args.outdir:
            os.makedirs(args.outdir, exist_ok=True)
            np.savetxt(os.path.join(args.outdir, "bnpcovreg_mu_mean.csv"),
                       bnp_mu[:, 0], delimiter=",")
    else:
        pre = os.path.join(args.data_dir, "flu-states",
                           "bnpcovreg_mu_mean.csv")
        if os.path.exists(pre):
            bnp_mu = np.loadtxt(pre, delimiter=",")[:, None]

    if bnp_mu is not None:
        r_in = np.sqrt(np.mean((Y[is_in_sample] - bnp_mu[is_in_sample]) ** 2))
        r_out = np.sqrt(np.mean((Y[is_held_out] - bnp_mu[is_held_out]) ** 2))
        m_in = np.mean(np.abs(Y[is_in_sample] - bnp_mu[is_in_sample]))
        m_out = np.mean(np.abs(Y[is_held_out] - bnp_mu[is_held_out]))
        print("Fox and Dunson (2015)")
        print("In-sample  RMSE: {:.2f}".format(r_in))
        print("Out-sample RMSE: {:.2f}".format(r_out))
        print("In-sample   MAE: {:.2f}".format(m_in))
        print("Out-sample  MAE: {:.2f}".format(m_out))
        table["bnp_covreg"] = dict(rmse_in=r_in, rmse_out=r_out,
                                   mae_in=m_in, mae_out=m_out)
        if bnp_cov is not None:
            print("In-sample  coverage: {:.2f}%".format(bnp_cov["cov_in"]))
            print("Out-sample coverage: {:.2f}%".format(bnp_cov["cov_out"]))
            table["bnp_covreg"].update(bnp_cov)
    return table, fits


def main(argv=None):
    return run(parse_args(argv))[0]


if __name__ == "__main__":
    main()
