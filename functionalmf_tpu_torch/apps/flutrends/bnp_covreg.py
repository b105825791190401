"""Bayesian nonparametric covariance regression (Fox & Dunson, JMLR 2015)
on the port: the comparison arm of the flu-trends benchmark.

Counterpart of functionalmf_tpu/apps/flutrends/bnp_covreg.py (reference
flutrends/BNP_covreg_varinds.m:1-616, driven by
runstuff_varinds_flu_states.m:1-204). The model is

    y_n = Theta zeta(x_n) eta_n + eps_n,   eps_n ~ N(0, diag(1/invSig))
    eta_n = psi(x_n) + xi_n,               xi_n  ~ N(0, I_k)

with every dictionary function zeta_{l,k}(.) and latent-mean function
psi_k(.) a GP over the grid (squared-exponential kernel), Theta (p x L)
under the multiplicative-gamma-process shrinkage prior (phi, delta), and
missing observations masked. The predictive mean is Theta zeta_n psi_n,
the predictive variance diag(Theta zeta_n zeta_n' Theta') + 1/invSig.

Every GP conditional N(Sig h, Sig), Sig = (inv(K) + diag(A))^{-1}, is
drawn by the pathwise (Matheron) rule through B = S K S + I, S = sqrt(A),
which never forms inv(K) (condition about 1e5): the kernel's Cholesky is
taken once in float64 on the host and cast, and the sampler runs in
float32 with TF32 off. B has every eigenvalue >= 1.

Layout on the card. A GP update's B depends only on the step's A, and
within the zeta and psi steps A does not depend on the running state
(eta and w are fixed through the zeta scan; A_k through the psi scan). So
each step factors all of its B matrices in one batched ``cholesky_ex``
before its scan, and draws all of the scan's noise (permutations and
normals) in one call each; inside the scan only arithmetic on the state
and two triangular solves a GP update are left. Cholesky failures are
counted on the device (``fails``) and read once per ``chunk`` of
iterations by ``fit_bnp_covreg``, which raises if any occurred. The
gamma draws (invSig, phi, delta) come from ``ops/gamma.py:gamma_mt``,
whose shapes do not depend on the state, so each step takes them in one
call too. Each iteration draws from ``SweepRNG`` keyed by
(seed, ``SweepRNG.BNP``, iteration), so a run cut into chunks draws what
an uncut run draws.

The draw sites are ``_draw_scan_noise``, ``_normals`` and ``_gammas``,
one call each per draw in a fixed order.
"""
from __future__ import annotations

import numpy as np
import torch

from functionalmf_tpu_torch._runtime import (SweepRNG, require_full_f32,
                                             resolve_device)
from functionalmf_tpu_torch.ops.gamma import gamma_mt
from functionalmf_tpu_torch.ops.mvn import _cho_solve, _solve_lt

__all__ = ["se_kernel", "fit_bnp_covreg"]


def se_kernel(N, c=100.0, d=1.0, r=1e-5):
    """Squared-exponential GP kernel on the grid x = (1..N)/N
    (runstuff_varinds_flu_states.m:70-81), float64 on the host."""
    x = (np.arange(1, N + 1) / N)[:, None]
    K = d * np.exp(-c * (x - x.T) ** 2)
    return K + r * np.eye(N)


# ----------------------------------------------------------------------
# draw sites
# ----------------------------------------------------------------------
def _normals(gen, shape, like):
    return torch.randn(tuple(shape), generator=gen, dtype=like.dtype,
                       device=like.device)


def _gammas(gen, shape):
    """Gamma(shape, 1) draws, one for each entry of the tensor ``shape``."""
    return gamma_mt(gen, shape)


def _draw_scan_noise(gen, nrows, k, N, like):
    """The noise of a GP scan of nrows x k steps: a random order of the k
    components for each row (nrows, k), then each step's two N-vectors of
    normals, the prior draw's e0 and the observation noise's z, each
    (nrows * k, N), in scan order."""
    perms = torch.argsort(torch.rand((nrows, k), generator=gen,
                                     dtype=like.dtype, device=like.device),
                          dim=1)
    e0 = _normals(gen, (nrows * k, N), like)
    z = _normals(gen, (nrows * k, N), like)
    return perms, e0, z


# ----------------------------------------------------------------------
# the GP conditional draw
# ----------------------------------------------------------------------
def _count_failures(fails, info):
    if fails is not None:
        fails.add_((info != 0).sum())


def _gp_factor(A, K, fails=None):
    """For A (..., N) >= 0: S = sqrt(A), 1/S where A > 0 (0 elsewhere) and
    the lower Cholesky factor of B = S K S + I, batched over A's leading
    axes."""
    S = torch.sqrt(A)
    B = S[..., :, None] * K * S[..., None, :]
    B.diagonal(dim1=-2, dim2=-1).add_(1.0)
    F, info = torch.linalg.cholesky_ex(B)
    _count_failures(fails, info)
    tiny = torch.finfo(A.dtype).tiny
    invS = torch.where(A > 0, 1.0 / S.clamp(min=tiny), 0.0)
    return S, invS, F


def _sample_gp_conditional(gen, A, h, K, cholK, fails=None):
    """Draw from N(Sig h, Sig), Sig = (inv(K) + diag(A))^{-1}, A >= 0,
    batched over the leading axes of A and h.

    Pathwise form: f = f0 + K S B^{-1} (h/S - S f0 - z),
    B = S K S + I, S = sqrt(A), f0 = cholK e0 ~ N(0, K), z ~ N(0, I)
    (e0, then z, from ``gen``); entries with A = 0 carry h = 0 in every
    caller, so h/S := 0 there. Replaces the MATLAB's chol(invK + diag(A))
    information form (BNP_covreg_varinds.m:341-346) without ever forming
    inv(K). The scans below apply the same formula a step, with B
    factored and S f0 + z formed for all their steps before the scan."""
    e0 = _normals(gen, A.shape, A)
    z = _normals(gen, A.shape, A)
    S, invS, F = _gp_factor(A, K, fails)
    f0 = e0 @ cholK.T
    return f0 + (S * _cho_solve(F, h * invS - S * f0 - z)) @ K  # K = K^T


# ----------------------------------------------------------------------
# the six Gibbs steps
# ----------------------------------------------------------------------
def _sample_zeta(gen, state, y, inds, K, cholK, L, k, fails=None):
    """Sequential per-(l, k) GP updates of the dictionary functions with
    residual bookkeeping (BNP_covreg_varinds.m:245-353); the k components
    of each row l in a random order (:324)."""
    theta, zeta, invSig = state["theta"], state["zeta"], state["invSig"]
    eta = state["psi"] + state["xi"]                     # (k, N)
    N = y.shape[1]
    w = theta.square().T @ (invSig[:, None] * inds)     # (L, N)
    Ti = (theta * invSig[:, None]).T[:, :, None] * inds  # (L, p, N)
    hy = (Ti * y).sum(1)                                 # (L, N)

    perms, e0, z = _draw_scan_noise(gen, L, k, N, y)
    rows = torch.arange(L, device=y.device)[:, None]
    etaP = eta[perms]                                    # (L, k, N)
    S, invS, F = _gp_factor((etaP.square() * w[:, None]).reshape(L * k, N),
                            K, fails)
    f0 = e0 @ cholK.T
    Sf0z = S * f0 + z

    mu_tot = torch.einsum("pl,lkn,kn->pn", theta, zeta, eta)
    zP = zeta[rows, perms]                               # (L, k, N)
    for ll in range(L):
        th = theta[:, ll]
        for j in range(k):
            i = ll * k + j
            e = etaP[ll, j]
            mu_tot.addr_(th, e * zP[ll, j], alpha=-1.0)
            h = e * (hy[ll] - (Ti[ll] * mu_tot).sum(0))
            sol = _cho_solve(F[i], h * invS[i] - Sf0z[i])
            torch.addmv(f0[i], K, S[i] * sol, out=zP[ll, j])
            mu_tot.addr_(th, e * zP[ll, j])
    zeta = zeta.clone()
    zeta[rows, perms] = zP
    return zeta


def _sample_psi(gen, state, y, inds, K, cholK, k, niters, fails=None):
    """Latent-mean GP updates marginalising xi, sequential over the
    components, ``niters`` passes each in a random order
    (BNP_covreg_varinds.m:357-416)."""
    theta, zeta, psi, invSig = (state["theta"], state["zeta"],
                                state["psi"], state["invSig"])
    N = y.shape[1]
    # Omega_n = Theta zeta_n with missing rows zeroed (varinds masking)
    Omega = torch.einsum("pl,lkn->kpn", theta, zeta) * inds   # (k, p, N)
    d = torch.where(inds > 0, 1.0 / invSig[:, None], 1.0)     # (p, N)
    M = torch.einsum("kpn,kqn->npq", Omega, Omega) + torch.diag_embed(d.T)
    FM, info = torch.linalg.cholesky_ex(M)                    # (N, p, p)
    _count_failures(fails, info)
    # OI[k2, p2, n] = [Omega_n' M_n^{-1}]_{k2, p2}
    X = torch.linalg.solve_triangular(FM, Omega.permute(2, 1, 0),
                                      upper=False)
    OI = torch.linalg.solve_triangular(FM.mT, X, upper=True).permute(2, 1, 0)
    A = (OI * Omega).sum(1)                                   # (k, N)
    hy = (OI * y).sum(1)                                      # (k, N)
    S, invS, F = _gp_factor(A, K, fails)

    perms, e0, z = _draw_scan_noise(gen, niters, k, N, y)
    f0 = e0 @ cholK.T

    mu_tot = torch.einsum("kpn,kn->pn", Omega, psi)
    psi = psi.clone()
    for it in range(niters):
        order = perms[it]
        OmP, OIP, hyP = Omega[order], OI[order], hy[order]
        SP, invSP, FP = S[order], invS[order], F[order]
        psiP = psi[order]
        Sf0z = SP * f0[it * k:(it + 1) * k] + z[it * k:(it + 1) * k]
        for j in range(k):
            i = it * k + j
            mu_tot.addcmul_(OmP[j], psiP[j], value=-1.0)
            h = hyP[j] - (OIP[j] * mu_tot).sum(0)
            sol = _cho_solve(FP[j], h * invSP[j] - Sf0z[j])
            torch.addmv(f0[i], K, SP[j] * sol, out=psiP[j])
            mu_tot.addcmul_(OmP[j], psiP[j])
        psi[order] = psiP
    return psi


def _sample_xi(gen, state, y, inds, fails=None):
    """Latent factor draws, one k-dim Gaussian per time point
    (BNP_covreg_varinds.m:419-443), batched over the N points."""
    theta, zeta, psi, invSig = (state["theta"], state["zeta"],
                                state["psi"], state["invSig"])
    k, N = psi.shape
    Z = torch.einsum("pl,lkn->npk", theta, zeta)           # (N, p, k)
    iS = (invSig[:, None] * inds).T                        # (N, p)
    yt = (y - torch.einsum("npk,kn->pn", Z, psi)).T        # (N, p)
    ZtS = Z.mT * iS[:, None, :]                            # (N, k, p)
    G = ZtS @ Z
    G.diagonal(dim1=-2, dim2=-1).add_(1.0)
    F, info = torch.linalg.cholesky_ex(G)
    _count_failures(fails, info)
    m = _cho_solve(F, (ZtS @ yt[..., None])[..., 0])
    return (m + _solve_lt(F, _normals(gen, (N, k), y))).T  # (k, N)


def _sample_theta(gen, state, y, inds, fails=None):
    """Weightings-matrix rows under the MGP prior
    (BNP_covreg_varinds.m:446-466), batched over the p rows."""
    zeta, invSig, phi = state["zeta"], state["invSig"], state["phi"]
    tau = torch.cumprod(state["delta"], 0)
    eta = state["psi"] + state["xi"]
    p, L = phi.shape
    et = torch.einsum("lkn,kn->nl", zeta, eta)             # (N, L)
    etp = inds[:, :, None] * et                            # (p, N, L)
    P = invSig[:, None, None] * (etp.mT @ etp) + torch.diag_embed(phi * tau)
    F, info = torch.linalg.cholesky_ex(P)
    _count_failures(fails, info)
    m = invSig[:, None] * _cho_solve(F, (etp.mT @ y[:, :, None])[..., 0])
    return m + _solve_lt(F, _normals(gen, (p, L), y))


def _sample_invSig(gen, state, y, inds, a_sig, b_sig):
    """Per-coordinate noise precisions (BNP_covreg_varinds.m:469-488)."""
    theta, zeta = state["theta"], state["zeta"]
    eta = state["psi"] + state["xi"]
    resid = (y - torch.einsum("pl,lkn,kn->pn", theta, zeta, eta)) * inds
    shape = a_sig + 0.5 * inds.sum(1)
    rate = b_sig + 0.5 * resid.square().sum(1)
    return _gammas(gen, shape) / rate


def _sample_hypers(gen, state, a_phi, b_phi, a1, a2, ninner=50):
    """MGP shrinkage hyperparameters phi, delta
    (BNP_covreg_varinds.m:491-518): ``ninner`` passes, each phi and then
    delta_1 .. delta_L in turn. The gamma draws' shapes do not depend on
    the state: all of them are taken before the loop."""
    theta, phi, delta = state["theta"], state["phi"], state["delta"]
    p, L = theta.shape
    a = torch.full((L,), a2, dtype=theta.dtype, device=theta.device)
    a[0] = a1
    g_phi = _gammas(gen, torch.full((ninner, p, L), a_phi + 0.5,
                                    dtype=theta.dtype, device=theta.device))
    hh = torch.arange(L, dtype=theta.dtype, device=theta.device)
    g_delta = _gammas(gen, (a + 0.5 * p * (L - hh)).expand(ninner, L))
    th2 = theta.square()
    delta = delta.clone()
    for i in range(ninner):
        tau = torch.cumprod(delta, 0)
        phi = g_phi[i] / (0.5 * tau * th2 + b_phi)
        spt = (phi * th2).sum(0)                          # (L,)
        for h in range(L):
            # rate = 1 + 1/2 sum_{l >= h} spt_l prod_{j <= l, j != h} delta_j
            s = torch.dot(torch.cumprod(delta, 0)[h:], spt[h:])
            dh = delta[h]
            torch.div(g_delta[i, h] * dh, torch.add(dh, s, alpha=0.5),
                      out=delta[h])
    return phi, delta


def _gibbs_iter(gen, state, y, inds, K, cholK, L, k, hp, psi_iters,
                latent_mean=True, fails=None):
    """One full Gibbs sweep in the MATLAB's update order
    (BNP_covreg_varinds.m:139-190)."""
    state = dict(state)
    state["invSig"] = _sample_invSig(gen, state, y, inds, hp["a_sig"],
                                     hp["b_sig"])
    state["phi"], state["delta"] = _sample_hypers(
        gen, state, hp["a_phi"], hp["b_phi"], hp["a1"], hp["a2"])
    state["theta"] = _sample_theta(gen, state, y, inds, fails)
    if latent_mean:
        state["psi"] = _sample_psi(gen, state, y, inds, K, cholK, k,
                                   psi_iters, fails)
    state["xi"] = _sample_xi(gen, state, y, inds, fails)
    state["zeta"] = _sample_zeta(gen, state, y, inds, K, cholK, L, k, fails)
    return state


def _mu_and_vardiag(state):
    theta, zeta, invSig = state["theta"], state["zeta"], state["invSig"]
    tz = torch.einsum("pl,lkn->pkn", theta, zeta)
    mu = torch.einsum("pkn,kn->pn", tz, state["psi"])
    vdiag = tz.square().sum(1) + 1.0 / invSig[:, None]
    return mu, vdiag


# ----------------------------------------------------------------------
# the fit
# ----------------------------------------------------------------------
def _check_dtype(dtype):
    if dtype is not torch.float32 and (isinstance(dtype, torch.dtype)
                                       or np.dtype(dtype) != np.float32):
        raise ValueError(f"fit_bnp_covreg computes in float32 only; got "
                         f"dtype={dtype!r}")


def _prepare(y, inds, c, d, r, device):
    """The masked data, the mask and the kernel and its float64 Cholesky
    factor, cast once, as float32 tensors on ``device``."""
    y = np.asarray(y, np.float64)
    if inds is None:
        inds = ~np.isnan(y)
    inds = np.asarray(inds, bool)
    y = np.where(inds, y, 0.0)
    K = se_kernel(y.shape[1], c=c, d=d, r=r)
    cholK = np.linalg.cholesky(K)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return t(y), t(inds), t(K), t(cholK)


def _init_state(gen, p, N, L, k, a_sig, b_sig, a_phi, b_phi, a1, a2, like):
    """A draw from the prior (BNP_covreg_varinds.m:66-97), zeta and psi
    at 0."""
    opts = dict(dtype=like.dtype, device=like.device)
    a = torch.full((L,), a2, **opts)
    a[0] = a1
    delta = _gammas(gen, a)
    tau = torch.cumprod(delta, 0)
    phi = _gammas(gen, torch.full((p, L), a_phi, **opts)) / b_phi
    theta = _normals(gen, (p, L), like) / torch.sqrt(phi * tau)
    xi = _normals(gen, (k, N), like)
    invSig = _gammas(gen, torch.full((p,), a_sig, **opts)) / b_sig
    return dict(theta=theta, zeta=torch.zeros((L, k, N), **opts),
                psi=torch.zeros((k, N), **opts), xi=xi, phi=phi, delta=delta,
                invSig=invSig)


def fit_bnp_covreg(y, inds=None, L=10, k=20, niter=10000, store_every=10,
                   nburn=0, c=100.0, d=1.0, r=1e-5, a_sig=1.0, b_sig=0.1,
                   a_phi=1.5, b_phi=1.5, a1=10.0, a2=10.0, seed=0,
                   latent_mean=True, chunk=50, dtype=torch.float32,
                   verbose=False, device="cuda"):
    """Run the BNP-CovReg Gibbs sampler on ``device``; returns posterior
    mu / var-diag draws. Defaults are the flu runner's settings
    (runstuff_varinds_flu_states.m:83-104: L=10, k=20, Niter=10000,
    storeEvery=10, saveMin=1 i.e. no burn-in).

    y: (p, N) data, NaN where missing (or pass an explicit inds mask).
    ``chunk`` is the number of iterations between host reads (the
    Cholesky failure count, and mu / var-diag when a draw is stored).
    Returns {'mu': (S, p, N), 'var_diag': (S, p, N), 'state': dict of
    tensors on ``device``}.
    """
    _check_dtype(dtype)
    if store_every % chunk != 0 and chunk % store_every != 0:
        raise ValueError("chunk must divide or be divisible by store_every")
    chunk = min(chunk, store_every)
    dev = resolve_device(device)
    require_full_f32()
    yd, indsd, Kd, cholKd = _prepare(y, inds, c, d, r, dev)
    p, N = yd.shape
    hp = dict(a_sig=a_sig, b_sig=b_sig, a_phi=a_phi, b_phi=b_phi, a1=a1,
              a2=a2)
    rng = SweepRNG(seed, dev)
    fails = torch.zeros((), dtype=torch.int64, device=dev)

    # the prior draw, one zeta pass, then a first psi pass of 50 inner
    # iterations (BNP_covreg_varinds.m:95-97, 372-376)
    gen = rng.at(SweepRNG.BNP, 0)
    state = _init_state(gen, p, N, L, k, a_sig, b_sig, a_phi, b_phi, a1, a2,
                        yd)
    state["zeta"] = _sample_zeta(gen, state, yd, indsd, Kd, cholKd, L, k,
                                 fails)
    if latent_mean:
        state["psi"] = _sample_psi(gen, state, yd, indsd, Kd, cholKd, k, 50,
                                   fails)

    mus, vds = [], []
    for i in range(niter // chunk):
        for j in range(chunk):
            state = _gibbs_iter(rng.at(SweepRNG.BNP, i * chunk + j + 1),
                                state, yd, indsd, Kd, cholKd, L, k, hp,
                                psi_iters=5, latent_mean=latent_mean,
                                fails=fails)
        it = (i + 1) * chunk
        nfail = int(fails)
        if nfail:
            raise RuntimeError(f"BNP-CovReg: {nfail} Cholesky factorisations "
                               f"failed by iteration {it}")
        if it > nburn and it % store_every == 0:
            mu, vd = (x.cpu().numpy() for x in _mu_and_vardiag(state))
            if not (np.isfinite(mu).all() and np.isfinite(vd).all()):
                raise RuntimeError(f"BNP-CovReg: non-finite mu or var_diag "
                                   f"at iteration {it}")
            mus.append(mu)
            vds.append(vd)
        if verbose and it % max(store_every * 10, chunk) == 0:
            print(f"  bnp-covreg iter {it}/{niter}", flush=True)
    return {"mu": np.stack(mus), "var_diag": np.stack(vds), "state": state}
