"""Bayesian tensor filtering for dose-response modeling (CLI).

Counterpart of functionalmf_tpu/apps/doseresponse/fit.py (reference
doseresponse/fit.py:1-491): empirical-Bayes likelihood, NMF and monotone
NMF baselines, the constrained model with [0, 1] and softened-monotonicity
constraints and EP centring, optional binary row features with a U
embedding resampled by GASS in a per-sweep hook, holdout evaluation, the
PAV-projected posterior and the saved arrays.

    python -m functionalmf_tpu_torch.apps.doseresponse.fit \\
        --data d/data.csv --features d/features.csv --sample_features \\
        --outdir d/out [--device cpu]

The model has no cell function: its likelihood is the black-box
``loglikelihood(data, WV, W, V, row, col)`` over the data dict
``{"Y", "X", "U"}`` (models/constrained.py), plain PyTorch on the card.
The U step runs on the device by default (``make_traced_u_step``,
``run_gibbs``'s ``traced_callback``); ``--host-callback`` runs it as a
host hook (``make_u_step``). The CSVs are read with the standard ``csv``
module.
"""
from __future__ import annotations

import argparse
import csv
import math
import os
import time

import numpy as np
import torch

from functionalmf_tpu_torch import (
    ConstrainedNonconjugateBayesianTensorFiltering)
from functionalmf_tpu_torch._runtime import SweepRNG, resolve_device
from functionalmf_tpu_torch.apps.doseresponse.empirical_bayes import (
    estimate_likelihood, read_csv_columns)
from functionalmf_tpu_torch.samplers.gass import draw_gass_noise, gass_grid
from functionalmf_tpu_torch.utils.ep import ep_from_mf
from functionalmf_tpu_torch.utils.metrics import mae, mse
from functionalmf_tpu_torch.utils.nmf import tensor_nmf
from functionalmf_tpu_torch.utils.pav import factor_pav

U_NGRID = 64     # grid points of the U step's GASS (fit.py:94)


def read_features(filename, cells):
    """The binary row-feature CSV (first column: the cell line) as an
    (n, p) array aligned with ``cells``, NaN rows for cell lines without
    features; also the feature names."""
    with open(filename, newline="") as f:
        reader = csv.reader(f)
        names = next(reader)[1:]
        rows = {row[0]: [float(x) if x != "" else math.nan for x in row[1:]]
                for row in reader}
    print("Have dose-response and features: {}".format(
        sum(c in rows for c in cells)))
    X = np.array([rows.get(c, [math.nan] * len(names)) for c in cells],
                 dtype=float)
    return X, names


def make_loglikelihood(likelihood, with_features: bool):
    """loglikelihood(data, WV, W, V, row, col) for one item, closing over
    the empirical-Bayes mixture (reference fit.py:28-50). data =
    {'Y', ['X', 'U']}; row / col are 0-d index tensors."""

    def base(data, WV, W, V, row=None, col=None):
        Y = data["Y"]
        if row is not None:
            Y = Y[row]
        if col is not None:
            Y = Y[:, col]
        # Y: (..., T, R); WV: (..., T)
        return likelihood.logpdf(Y, WV).sum()
    if not with_features:
        return base

    def cross_entropy(x, WU):
        WU = torch.clamp(WU, 1e-6, 1 - 1e-6)
        nan = torch.isnan(x)
        x0 = torch.where(nan, 0.0, x)
        ce = x0 * torch.log(WU) + (1 - x0) * torch.log(1 - WU)
        return torch.where(nan, 0.0, ce).sum()

    def with_X(data, WV, W, V, row=None, col=None):
        z = base(data, WV, W, V, row=row, col=col)
        if row is not None:
            U = data["U"].float()
            z = z + cross_entropy(data["X"][row].float(),
                                  U[:, :W.shape[-1]] @ W)
        elif col is None:
            # the full-tensor call (logprob, the scale moves): the feature
            # term p(X | W U) depends on W, so every row counts here.
            # Column updates leave it out: it is constant in V.
            U = data["U"].float()
            z = z + cross_entropy(data["X"].float(),
                                  W @ U[:, :W.shape[-1]].T)
        return z

    return with_X


def _make_u_all(X, device):
    """GASS resampling of the feature embeddings U given W (reference
    fit.py:113-144): one batched update over the feature columns, under
    W u in [0, 1] for every row (A = [W; -W], c = [0; -1])."""
    Xn = np.asarray(X, dtype=np.float32)
    Xz = torch.as_tensor(np.where(np.isnan(Xn), 0.0, Xn), device=device)
    Xmask = torch.as_tensor((~np.isnan(Xn)).astype(np.float32),
                            device=device)
    XzT, XmT = Xz.T.contiguous(), Xmask.T.contiguous()        # (p, n)

    def u_all(gen, U, W):
        """U (p, k), W (n, k) -> the new U."""
        p, n = U.shape[0], W.shape[0]
        A = torch.cat([W, -W], dim=0)                         # (2n, k)
        c = torch.cat([torch.zeros(n, device=device),
                       -torch.ones(n, device=device)])

        def Af(Y):                                   # (p, G, k) -> (p, G, 2n)
            return Y @ A.T

        def loglik(cands):                           # (p, G, k) -> (p, G)
            wu = torch.clamp(cands @ W.T, 1e-6, 1 - 1e-6)     # (p, G, n)
            ce = (XzT[:, None] * torch.log(wu)
                  + (1 - XzT[:, None]) * torch.log(1 - wu))
            return (ce * XmT[:, None]).sum(-1)

        v = torch.randn(U.shape, generator=gen, device=device)
        log_u, gumbel = draw_gass_noise(gen, p, U_NGRID, device)
        return gass_grid(U, loglik, Af, c.expand(p, -1), v=v, log_u=log_u,
                         gumbel=gumbel)[0]
    return u_all


def row_constraints_of(U):
    """[U | 0; -U | -1]: W U^T in [0, 1] as rows [A | c], A w >= c."""
    zeros = U.new_zeros((U.shape[0], 1)) if isinstance(U, torch.Tensor) \
        else np.zeros((U.shape[0], 1))
    cat = torch.cat if isinstance(U, torch.Tensor) else np.concatenate
    return cat([cat([U, zeros], 1), cat([-U, zeros - 1.0], 1)], 0)


def make_u_step(args, X, device):
    """The U step as a host hook (``run_gibbs(callback=)``; the
    reference's contract): it reads W through the model's property,
    resamples U on the device, writes it back into the data dict and the
    model's Row_constraints and marks the data dirty. The draws are
    collected by ``run_gibbs`` (``collect_data_keys=("U",)``)."""
    u_all = _make_u_all(X, device)
    rng = SweepRNG(args.seed ^ 0xFEA7, device)

    def U_step(model, data, step):
        W = torch.as_tensor(np.asarray(model.W, np.float32), device=device)
        U = torch.as_tensor(np.asarray(data["U"], np.float32), device=device)
        U_new = u_all(rng.at(SweepRNG.HOOK, step), U, W).cpu().numpy()
        data["U"] = U_new
        model.mark_data_dirty()
        # refresh the row constraints so that W U stays in [0, 1]
        model.Row_constraints = row_constraints_of(U_new)

    return U_step


def make_traced_u_step(X, device):
    """The U step as the device-side hook (``run_gibbs(traced_callback=
    )``): it rewrites ``pdata["U"]`` and ``state["Row_constraints"]`` on
    the device and never waits for it. One chain (``init_model`` forces
    it with --sample_features)."""
    u_all = _make_u_all(X, device)

    def traced_u(state, pdata, gen, step):
        U_new = u_all(gen, pdata["U"].float(), state["W"][0])
        pdata = dict(pdata, U=U_new.to(pdata["U"].dtype))
        state = dict(state, Row_constraints=row_constraints_of(U_new)[None])
        return state, pdata

    return traced_u


def warm_start(Y, args, X=None):
    """The host fits a model starts from (reference fit.py:164-187): the
    monotone NMF under the 0.999 cap, with the row features when given,
    and the EP centring around it. Returns (W, V, U0, ep_approx); U0 is
    None without features. A function of the data, the features and the
    seed, not of the device or the hook flavour."""
    rng = np.random.default_rng(args.seed)
    U0 = None
    if X is not None:
        print("Initializing dose-response embeddings via NMF with row "
              "features")
        W, V, U0 = tensor_nmf(Y, args.nembeds, monotone=True, max_entry=0.999,
                              row_features=X, rng=rng)
    else:
        print("Initializing dose-response embeddings via NMF")
        W, V = tensor_nmf(Y, args.nembeds, monotone=True, max_entry=0.999,
                          rng=rng)
    Mu = (W[:, None, None] * V[None]).sum(axis=-1)
    if Mu.min() < 0 or Mu.max() > 1:
        raise ValueError("the NMF warm start leaves [0, 1]: Mu range "
                         "[{},{}]".format(Mu.min(), Mu.max()))
    return W, V, U0, ep_from_mf(Y, W, V, mode="multiplier", multiplier=3)


def init_model(Y, likelihood, args, X=None, warm=None, mesh=None):
    """Constraints, warm start and EP centring (reference fit.py:54-187).
    Returns (model, U0). ``warm`` is what ``warm_start`` returned for the
    same data, features and seed; it is computed here when not given.
    With ``mesh`` (``parallel/mesh.py``) the model runs on that rank's
    device and part of the mesh."""
    ndepth = Y.shape[2]
    C_zero = np.concatenate([np.eye(ndepth), np.zeros((ndepth, 1))], axis=1)
    C_mono = np.array([np.concatenate([np.zeros(i), [1, -1],
                                       np.zeros(ndepth - i - 2), [-1e-2]])
                       for i in range(ndepth - 1)])
    C_one = np.concatenate([np.eye(ndepth) * -1, np.full((ndepth, 1), -1)],
                           axis=1)
    C = np.concatenate([C_zero, C_one, C_mono], axis=0)

    W, V, U0, EP_approx = warm_start(Y, args, X) if warm is None else warm
    Row_constraints = None
    if X is not None and args.sample_features:
        Row_constraints = row_constraints_of(U0)
    loglikelihood = make_loglikelihood(likelihood, with_features=X is not None)

    fix_W = X is not None and not args.sample_features
    nchains = int(getattr(args, "nchains", 1))
    if nchains > 1 and args.sample_features:
        # the U step tracks one shared U; a U per chain would need a chain
        # axis through the likelihood's data
        print("WARNING: --sample_features forces nchains=1")
        nchains = 1
    model = ConstrainedNonconjugateBayesianTensorFiltering(
        Y.shape[0], Y.shape[1], Y.shape[2],
        loglikelihood, C,
        nembeds=args.nembeds, tf_order=args.tf_order,
        lam2_true=args.lam2, ep_approx=EP_approx,
        W_true=W if fix_W else None,
        Row_constraints=Row_constraints,
        nchains=nchains,
        seed=args.seed,
        device=args.device if mesh is None else mesh.device,
        mesh=mesh)
    model.W = W
    model.V = V
    return model, U0


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Bayesian tensor filtering for dose-response modeling.")
    parser.add_argument("--data", default="doseresponse/data/sim/data.csv")
    parser.add_argument("--outdir", default="doseresponse/data/sim/")
    parser.add_argument("--nembeds", type=int, default=5)
    parser.add_argument("--tf_order", type=int, default=2)
    parser.add_argument("--lam2", type=float, default=1e-1)
    parser.add_argument("--nbins", type=int, default=20)
    parser.add_argument("--nsamples", type=int, default=5000)
    parser.add_argument("--nburn", type=int, default=5000)
    parser.add_argument("--nthin", type=int, default=1)
    parser.add_argument("--nchains", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--nholdout", type=int, default=0)
    parser.add_argument("--features", help="optional binary row-feature CSV")
    parser.add_argument("--sample_features", action="store_true")
    parser.add_argument("--host-callback", action="store_true",
                        help="run the U step as a per-sweep host callback "
                             "(the reference's contract) instead of the "
                             "device-side hook")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    return parser.parse_args(argv)


def run(args, fits=None):
    """The whole pipeline; returns a dict with the model, the results, the
    saved arrays and the timings (``main`` discards it). ``fits`` is the
    ``"fits"`` entry of an earlier run on the same data, features, seed
    and holdout: its host fits (the NMF baselines, the warm start, EP) are
    reused, as a second run on another device would repeat them exactly."""
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    df = read_csv_columns(args.data)

    print("Loading data and performing empirical Bayes likelihood estimate")
    Y, likelihood, cells, drugs, concentrations, control_obs = \
        estimate_likelihood(df, nbins=args.nbins, tensor_outcomes=True,
                            device=device)

    os.makedirs(args.outdir, exist_ok=True)
    np.save(os.path.join(args.outdir, "cells"), cells)
    np.save(os.path.join(args.outdir, "drugs"), drugs)

    nrows, ncols, ndepth, nreplicates = Y.shape
    present = np.any(np.any(~np.isnan(Y), axis=-1), axis=-1).sum()
    print("Shape: {}x{}x{}x{}. Curves present: {}/{}".format(
        nrows, ncols, ndepth, nreplicates, present, nrows * ncols))

    # holdout (fit.py:282-302)
    Y_full = Y
    held_out = None
    if args.nholdout > 0:
        from functionalmf_tpu_torch.utils.metrics import random_holdouts
        selected = random_holdouts(Y, args.nholdout, rng=rng)
        held_out = selected.T
        Y = Y.copy()
        Y[held_out[0], held_out[1]] = np.nan

    # features (fit.py:64-99)
    X = None
    if args.features is not None:
        X, _ = read_features(args.features, cells)

    # NMF baselines (fit.py:309-319)
    t0 = time.perf_counter()
    if fits is None:
        print("Fitting NMF")
        W_nmf, V_nmf = tensor_nmf(Y, args.nembeds, max_entry=0.999, rng=rng)
        print("Fitting Monotone NMF")
        W_nmf_proj, V_nmf_proj = tensor_nmf(Y, args.nembeds, monotone=True,
                                            max_entry=0.999, rng=rng)
        print("Initializing model")
        fits = dict(nmf=(W_nmf, V_nmf), nmf_mono=(W_nmf_proj, V_nmf_proj),
                    warm=warm_start(Y, args, X))
    Mu_nmf, Mu_nmf_proj = ((W_[:, None, None] * V_[None]).sum(axis=-1)
                           for W_, V_ in (fits["nmf"], fits["nmf_mono"]))
    model, U0 = init_model(Y, likelihood, args, X=X, warm=fits["warm"])
    start = (model.W.copy(), model.V.copy())
    nmf_seconds = time.perf_counter() - t0

    data = {"Y": Y}
    callback, traced_cb, cdk = None, None, ()
    if X is not None:
        data["X"] = X
        data["U"] = U0
        if args.sample_features:
            cdk = ("U",)
            if args.host_callback:
                callback = make_u_step(args, X, device)
            else:
                traced_cb = make_traced_u_step(X, device)

    print("Running Gibbs sampler. burn={} thin={} samples={}".format(
        args.nburn, args.nthin, args.nsamples))
    t0 = time.perf_counter()
    results = model.run_gibbs(data, nburn=args.nburn, nthin=args.nthin,
                              nsamples=args.nsamples, print_freq=100,
                              callback=callback, traced_callback=traced_cb,
                              collect_data_keys=cdk)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gibbs_seconds = time.perf_counter() - t0
    U_samples = results.pop("U", None)
    Ws, Vs = results["W"], results["V"]

    # convergence across chains (the reference parses --nchains and never
    # uses it, fit.py:237)
    if model.nchains > 1:
        from functionalmf_tpu_torch.utils.diagnostics import split_rhat
        C, S = model.nchains, args.nsamples
        rng_r = np.random.default_rng(0)
        rhats = []
        for arr in (Ws, Vs):
            flat = arr.reshape(C, S, -1)
            idx = rng_r.choice(flat.shape[-1], size=min(64, flat.shape[-1]),
                               replace=False)
            rhats.extend(split_rhat(flat[:, :, j]) for j in idx)
        print("split-R-hat over {} chains: max {:.4f} median {:.4f}".format(
            C, float(np.max(rhats)), float(np.median(rhats))))

    Mu_hat = np.einsum("znk,zmtk->znmt", Ws, Vs)
    Mu_hat_mean = Mu_hat.mean(axis=0)

    # PAV-projected posterior (fit.py:365-374)
    Vs_proj = np.array([[factor_pav(W_i, V_ij) for V_ij in V_i]
                        for W_i, V_i in zip(Ws, Vs)])
    Mu_hat_proj = np.einsum("znk,zmtk->znmt", Ws, Vs_proj)

    report = {
        "mae_in": {"NMF": mae(Mu_nmf[..., None], Y),
                   "Monotone NMF": mae(Mu_nmf_proj[..., None], Y),
                   "Posterior mean": mae(Mu_hat_mean[..., None], Y)},
        "rmse_in": {"NMF": np.sqrt(mse(Mu_nmf[..., None], Y)),
                    "Monotone NMF": np.sqrt(mse(Mu_nmf_proj[..., None], Y)),
                    "Posterior mean": np.sqrt(mse(Mu_hat_mean[..., None],
                                                  Y))}}
    for title, key in (("MAE", "mae_in"), ("RMSE", "rmse_in")):
        print("{} on in-sample observations:".format(title))
        for name, val in report[key].items():
            print("{:<16}{}".format(name + ":", val))

    if args.nholdout > 0:
        ho = (held_out[0], held_out[1])
        preds = (("NMF", Mu_nmf), ("Monotone NMF", Mu_nmf_proj),
                 ("Posterior mean", Mu_hat_mean))
        report["mae_out"] = {name: mae(p[ho][:, :, None], Y_full[ho])
                             for name, p in preds}
        report["rmse_out"] = {name: np.sqrt(mse(p[ho][:, :, None],
                                                Y_full[ho]))
                              for name, p in preds}
        for title, key in (("MAE", "mae_out"), ("RMSE", "rmse_out")):
            print("{} on held out observations:".format(title))
            for name, val in report[key].items():
                print("{:<16}{}".format(name + ":", val))

    print("Saving results to file")
    np.save(os.path.join(args.outdir, "y"), Y)
    np.save(os.path.join(args.outdir, "nmf"), Mu_nmf)
    np.save(os.path.join(args.outdir, "nmf_mono"), Mu_nmf_proj)
    np.save(os.path.join(args.outdir, "btf"), Mu_hat)
    np.save(os.path.join(args.outdir, "btf_w"), Ws)
    np.save(os.path.join(args.outdir, "btf_v"), Vs)
    np.save(os.path.join(args.outdir, "btf_mono"), Mu_hat_proj)
    if model.Sigma_ep is not None:
        np.save(os.path.join(args.outdir, "btf_ep_sigma"),
                np.asarray(model.Sigma_ep))
    if U_samples is not None:
        np.save(os.path.join(args.outdir, "btf_u"), U_samples)
    if args.nholdout > 0:
        np.save(os.path.join(args.outdir, "held_out"), held_out)
    return dict(model=model, results=results, U_samples=U_samples, U0=U0,
                data=data, Y=Y, X=X, likelihood=likelihood, report=report,
                warm_start=start, fits=fits, nmf_seconds=nmf_seconds,
                gibbs_seconds=gibbs_seconds,
                nsweeps=args.nburn + args.nthin * args.nsamples)


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
