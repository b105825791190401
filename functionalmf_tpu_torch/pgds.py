"""PGDS baseline (Schein et al. 2016, Poisson-Gamma Dynamical Systems) on
the port: the comparison arm and NMF warm-start source of the politics app
and the Poisson example.

Counterpart of functionalmf_tpu/pgds.py. ``fit_pgds`` keeps the reference
wrapper's signature and return shapes, plus ``device`` (the card unless the
caller asks for the CPU). The sampler is models/pgds.py; ``backend="apf"``
runs the optional external `apf` package instead, where it is installed.

    from functionalmf_tpu_torch.pgds import fit_pgds
    Mu, (W, V, U) = fit_pgds(Y, 5, nburn=1000, nthin=10, nsamples=100)
"""
from __future__ import annotations

import numpy as np

__all__ = ["fit_pgds", "get_matrices"]


def fit_pgds(Y, nembeds,
             gam=10,            # total mass of the gamma process weights
             tau=1.0,           # concentration parameter
             eps=0.1,           # noninformative gamma prior
             stationary=False,  # global vs local shrinkage
             binary=False,
             nthreads=3,        # apf backend only
             time_mode=2,       # tensor mode smoothed in time
             nburn=5000, nthin=10, nsamples=500,
             seed=42, verbose=0, backend="native", device="cuda"):
    """Fit PGDS to a 3-tensor: (Mu draws (S, N, M, T), (W, V, U) factor
    draws), the time factor U with delta folded in."""
    if backend == "apf":
        return _fit_pgds_apf(Y, nembeds, gam, tau, eps, stationary, binary,
                             nthreads, time_mode, nburn, nthin, nsamples,
                             seed, verbose)

    from functionalmf_tpu_torch.models.pgds import pgds_gibbs

    Y = np.asarray(Y, float)
    if Y.ndim != 3:
        raise ValueError("fit_pgds expects a 3-tensor")
    Yt = np.moveaxis(Y, time_mode, -1)        # time last for the sampler
    draws = pgds_gibbs(Yt, nembeds, gam=gam, tau=tau, eps=eps,
                       stationary=stationary, binary=binary,
                       nburn=nburn, nthin=nthin, nsamples=nsamples,
                       seed=seed, verbose=verbose, device=device)
    # rate = delta_t * sum_k a b theta; absorb delta into the time factor
    U = draws["Theta"] * draws["delta"][..., None]        # (S, T, K)
    W, V = draws["A"], draws["B"]
    Mu = np.einsum("sik,sjk,stk->sijt", W, V, U)
    Mu = np.moveaxis(Mu, -1, time_mode + 1)   # +1: leading sample axis
    return Mu, (W, V, U)


def _fit_pgds_apf(Y, nembeds, gam, tau, eps, stationary, binary, nthreads,
                  time_mode, nburn, nthin, nsamples, seed, verbose):
    try:
        from apf.models.pgds import PGDS
    except ImportError as e:
        raise ImportError(
            "backend='apf' requires the optional `apf` package "
            "(github.com/aschein/apf); the default backend='native' "
            "needs nothing") from e

    mask = np.isnan(Y).astype(int)
    data = np.ma.array(Y, mask=mask)
    data_shp = data.shape
    nrows, ncols, ndepth = Y.shape[:3]

    model = PGDS(data_shp=data_shp, core_shp=(nembeds,), time_mode=time_mode,
                 stationary=stationary, gam=gam, tau=tau, eps=eps,
                 binary=binary, seed=seed, n_threads=nthreads)
    Mu = np.zeros((nsamples, nrows, ncols, ndepth))
    W = np.zeros((nsamples, nrows, nembeds))
    V = np.zeros((nsamples, ncols, nembeds))
    U = np.zeros((nsamples, ndepth, nembeds))
    for step in range(nsamples + 1):
        model.fit(data,
                  n_itns=nthin if step > 0 else nburn,
                  initialize=step == 0,
                  verbose=verbose,
                  impute_after=0,
                  schedule={}, fix_state={}, init_state={})
        if step > 0:
            state = dict(model.get_state())
            W[step - 1], V[step - 1], U[step - 1] = [
                z.T for z in get_matrices(state, data_shp)]
            Mu[step - 1] = model.reconstruct()
    return Mu, (W, V, U)


def get_matrices(state, data_shp):
    """Per-mode factor matrices from an apf state dict."""
    mtx_MKD = state["mtx_MKD"]
    for mode, D in enumerate(data_shp):
        yield mtx_MKD[mode][:, :D]
