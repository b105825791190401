"""Poisson-Gamma Dynamical Systems (PGDS): the Gibbs sampler on the port.

Counterpart of functionalmf_tpu/models/pgds.py (Schein, Wallach & Zhou,
NeurIPS 2016), the comparison baseline and NMF warm-start source of the
politics app and the Poisson example. Model (3-tensor Y[i, j, t], time
last, K components):

    y_ijt ~ Pois(delta_t * sum_k a_ik b_jk theta_tk)      observed cells
    a_:k ~ Dir(eps 1_N),  b_:k ~ Dir(eps 1_M)             (columns sum 1)
    theta_1k ~ Gam(tau nu_k, tau)
    theta_tk ~ Gam(tau (Pi theta_{t-1})_k, tau)
    Pi columns: pi_:k ~ Dir(nu_1 nu_k, ..., xi nu_k [diag], ..., nu_K nu_k)
    delta_t ~ Gam(eps, eps) per step (stationary: one shared delta)
    nu_k ~ Gam(gam/K, beta), xi ~ Gam(eps, beta), beta ~ Gam(eps, eps)

A sweep (``PGDSSampler.sweep``), one method a step:

  0. ``_impute``: missing cells ~ Pois(current rate); in binary mode the
     latent counts of the ones from the zero-truncated Poisson;
  1. ``_allocate``: y_ijt split over k (multinomial);
  2. ``_factors``: the Dirichlet columns of A and B;
  3. ``_backward``: t = T-1 .. 1, l_tk ~ CRT(m_tk, tau (Pi theta_{t-1})_k),
     m_tk = y_tk + (splits arriving from t+1), each l_tk split over the
     source components, and the future-evidence rate rho;
  4. ``_forward``: theta_tk ~ Gam(m_tk + tau (Pi theta_{t-1})_k,
     tau + delta_t + rho_tk), with the new theta_{t-1};
  5. ``_pi``: the Dirichlet columns of Pi;
  6. ``_delta``: per step or shared;
  7. ``_hyper``: (nu, xi) by random-walk MH in log space, beta conjugate.

The two time scans are sequential, so the sweep is plain PyTorch with a
Python loop over time, and as little as possible inside it: everything
that depends only on the sweep's starting state (the CRT rates and exact
terms, the split fractions, the rho recursion) is computed for every step
before the backward loop, and the loop keeps the chain m_t, the CRT tail,
the K-step binomial split and the counts passed back. A sweep reads
nothing back to the host. Its draws come from ``SweepRNG`` keyed by
(seed, ``SweepRNG.PGDS``, sweep), so a run cut into collection chunks draws
what an uncut run draws.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from functionalmf_tpu_torch._runtime import (SweepRNG, require_full_f32,
                                             resolve_device)
from functionalmf_tpu_torch.ops.crt import (binomial_chain, crt_finish,
                                            crt_prepare, draw_crt_noise,
                                            multinomial_split,
                                            split_fractions)
from functionalmf_tpu_torch.ops.gamma import dirichlet

__all__ = ["pgds_gibbs", "PGDSSampler"]


def _ztp(u, lam, y, max_n: int = 64):
    """Zero-truncated Poisson draws where y > 0, else 0, by inverting the
    cdf with uniforms ``u`` over n = 1 .. max_n; ceil(lam) beyond."""
    lam = lam.clamp(min=1e-6)
    loglam = torch.log(lam)
    logp1 = loglam - lam - torch.log1p(-torch.exp(-lam))
    n = torch.arange(1, max_n, dtype=lam.dtype, device=lam.device)
    steps = loglam[..., None] - torch.log(n + 1.0)            # n -> n + 1
    logp = torch.cat([logp1[..., None],
                      logp1[..., None] + steps.cumsum(-1)], -1)
    cdf = torch.exp(logp).cumsum(-1)
    below = (cdf < u[..., None]).sum(-1).to(lam.dtype)    # first n: u <= cdf
    out = torch.where(below < max_n, below + 1.0, torch.ceil(lam))
    return torch.where(y > 0, out, 0.0)


def _log_dir(p, a):
    return (torch.lgamma(a.sum(-1)) - torch.lgamma(a).sum(-1)
            + ((a - 1.0) * torch.log(p.clamp(min=1e-30))).sum(-1))


def _pi_alpha(nu, xi):
    """Dirichlet concentration for Pi's columns: nu_k1 nu_k2, xi nu_k2 on
    the diagonal."""
    A = nu[:, None] * nu[None, :]
    A.diagonal().copy_(xi * nu)
    return A


def _hyper_logpost(nu, xi, theta1, Pi, tau, gam, eps, beta):
    K = nu.shape[0]
    lp = ((gam / K - 1.0) * torch.log(nu) - beta * nu).sum()
    lp = lp + (eps - 1.0) * torch.log(xi) - beta * xi
    a = tau * nu
    lp = lp + (a * math.log(tau) - torch.lgamma(a)
               + (a - 1.0) * torch.log(theta1.clamp(min=1e-30))
               - tau * theta1).sum()
    return lp + _log_dir(Pi.T, _pi_alpha(nu, xi).T).sum()


def _mh_nu_xi(nu, xi, z, u, logpost):
    """Random-walk MH on (log nu, log xi): step j proposes nu exp(z[j, :K]),
    xi exp(z[j, K]) and accepts when log u[j] < the change of ``logpost``
    plus the log Jacobian. Returns (nu, xi)."""
    K = nu.shape[0]
    target = lambda a, b: logpost(a, b) + torch.log(a).sum() + torch.log(b)
    lp = target(nu, xi)
    for j in range(z.shape[0]):
        nu_p, xi_p = nu * torch.exp(z[j, :K]), xi * torch.exp(z[j, K])
        lp_p = target(nu_p, xi_p)
        acc = torch.log(u[j]) < lp_p - lp
        nu = torch.where(acc, nu_p, nu)
        xi = torch.where(acc, xi_p, xi)
        lp = torch.where(acc, lp_p, lp)
    return nu, xi


def _rho_recursion(Pi, delta, tau):
    """rho_{T-1} = 0, rho_{t-1} = tau Pi^T log1p((delta_t + rho_t) / tau):
    the future-evidence rates of the backward pass, (T, K)."""
    T, K = delta.shape[0], Pi.shape[0]
    rho = torch.zeros((T, K), dtype=Pi.dtype, device=Pi.device)
    tPiT = tau * Pi.T
    dtau = delta / tau
    for t in range(T - 1, 0, -1):
        x = torch.add(dtau[t], rho[t], alpha=1.0 / tau).log1p_()
        torch.mv(tPiT, x, out=rho[t - 1])
    return rho


class PGDSSampler:
    """The PGDS Gibbs chain on ``device``: data, hyper-parameters, state
    and the sweep counter. ``run(nsweeps)`` advances it."""

    def __init__(self, Y, nembeds, *, gam=10.0, tau=1.0, eps=0.1,
                 stationary=False, binary=False, n_mh=3, mh_step=0.08,
                 seed=42, device="cuda"):
        Y = np.asarray(Y, np.float32)
        if Y.ndim != 3:
            raise ValueError("PGDS expects a 3-tensor with time last")
        self.device = resolve_device(device)
        require_full_f32()
        N, M, T = Y.shape
        K = self.K = int(nembeds)
        mask = np.isfinite(Y)
        Y0 = np.where(mask, np.nan_to_num(Y), 0.0).astype(np.float32)
        self.gam, self.tau, self.eps = float(gam), float(tau), float(eps)
        self.stationary, self.binary = bool(stationary), bool(binary)
        self.n_mh, self.mh_step = int(n_mh), float(mh_step)
        self.any_missing = not mask.all()
        t = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                      device=self.device)
        self.Y, self.mask = t(Y0), torch.as_tensor(mask, device=self.device)
        self._rng = SweepRNG(seed, self.device)
        self.step = 0
        theta = torch._standard_gamma(
            torch.ones((T, K), device=self.device),
            generator=self._rng.at(SweepRNG.INIT, 0))
        self.state = dict(
            A=torch.full((N, K), 1.0 / N, device=self.device),
            B=torch.full((M, K), 1.0 / M, device=self.device),
            Theta=theta,
            Pi=torch.full((K, K), 1.0 / K, device=self.device),
            delta=torch.full((T,), max(Y0.sum() / max(mask.sum(), 1.0), 0.1),
                             device=self.device),
            nu=torch.ones((K,), device=self.device),
            xi=t(1.0), beta=t(1.0))

    def run(self, nsweeps):
        for _ in range(nsweeps):
            self.state = self.sweep(self.state,
                                    self._rng.at(SweepRNG.PGDS, self.step))
            self.step += 1
        return self.state

    def sweep(self, s, gen):
        Yc = self._impute(s, gen)
        A_cnt, B_cnt, Y_tk = self._allocate(s, Yc, gen)
        A, B = self._factors(A_cnt, B_cnt, gen)
        m, rho, H = self._backward(s, Y_tk, gen)
        Theta = self._forward(s, m, rho, gen)
        Pi = self._pi(s, H, gen)
        delta = self._delta(Theta, Y_tk, gen)
        nu, xi, beta = self._hyper(s, Theta, Pi, gen)
        return dict(A=A, B=B, Theta=Theta, Pi=Pi, delta=delta, nu=nu, xi=xi,
                    beta=beta)

    def rate(self, s):
        return torch.einsum("ik,jk,tk->ijt", s["A"], s["B"],
                            s["Theta"] * s["delta"][:, None])

    # -- 0. missing cells and binary latents --------------------------------
    def _impute(self, s, gen):
        if not (self.any_missing or self.binary):
            return self.Y
        lam = self.rate(s)
        Yobs = self.Y
        if self.binary:
            u = torch.rand(lam.shape, generator=gen, device=self.device)
            Yobs = _ztp(u, lam, self.Y)
        if not self.any_missing:
            return Yobs
        Ymiss = torch.poisson(lam.clamp(min=1e-10), generator=gen)
        return torch.where(self.mask, Yobs, Ymiss)

    # -- 1. allocation --------------------------------------------------------
    def _allocate(self, s, Yc, gen):
        A, B, Theta = s["A"], s["B"], s["Theta"]
        R = A[:, None, None, :] * B[None, :, None, :] * Theta
        P = R / R.sum(-1, keepdim=True).clamp(min=1e-30)
        C = multinomial_split(gen, Yc, P)                       # (N,M,T,K)
        return C.sum((1, 2)), C.sum((0, 2)), C.sum((0, 1))

    # -- 2. factor columns ------------------------------------------------------
    def _factors(self, A_cnt, B_cnt, gen):
        A = dirichlet(gen, self.eps + A_cnt.T).T.clamp(min=1e-20)
        B = dirichlet(gen, self.eps + B_cnt.T).T.clamp(min=1e-20)
        return A, B

    # -- 3. backward pass -----------------------------------------------------
    def _backward(self, s, Y_tk, gen):
        Pi, Theta, delta, tau = s["Pi"], s["Theta"], s["delta"], self.tau
        T, K = Theta.shape
        # every step's rate and split weights from the sweep's start
        th_prev = Theta[:-1]                                # theta_{t-1}
        w = Pi[None] * th_prev[:, None, :]                  # (T-1, K, K)
        wp = w / w.sum(-1, keepdim=True).clamp(min=1e-30)
        frac = split_fractions(wp)                          # (K, T-1, K)
        u, z = draw_crt_noise(gen, (T - 1, K), device=self.device)
        prep = crt_prepare(tau * (th_prev @ Pi.T), u)
        rho = _rho_recursion(Pi, delta, tau)
        # the sequential chain, t = T-1 .. 1
        m = torch.empty_like(Y_tk)
        H = torch.zeros((K, K), device=self.device)
        lp = torch.zeros((K,), device=self.device)
        for t in range(T - 1, 0, -1):
            i = t - 1
            m_t = torch.add(Y_tk[t], lp, out=m[t])
            l_t = crt_finish(gen, m_t, [x[i] for x in prep], z[i])
            h = binomial_chain(gen, l_t, frac[:, i])         # (K, K)
            H.add_(h)
            lp = h.sum(0)
        torch.add(Y_tk[0], lp, out=m[0])
        return m, rho, H

    # -- 4. forward pass ------------------------------------------------------
    def _forward(self, s, m, rho, gen):
        Pi, delta, tau = s["Pi"], s["delta"], self.tau
        rt = tau + delta[:, None] + rho
        Theta = torch.empty_like(m)
        shape = m[0] + tau * s["nu"]
        for t in range(m.shape[0]):
            if t:
                shape = torch.addmv(m[t], Pi, Theta[t - 1], alpha=tau)
            g = torch._standard_gamma(shape.clamp_(min=1e-6), generator=gen)
            torch.div(g, rt[t], out=Theta[t]).clamp_(min=1e-20)
        return Theta

    # -- 5. transition matrix ---------------------------------------------------
    def _pi(self, s, H, gen):
        alpha = _pi_alpha(s["nu"], s["xi"])
        return dirichlet(gen, (alpha + H).T).T.clamp(min=1e-20)

    # -- 6. delta ---------------------------------------------------------------
    def _delta(self, Theta, Y_tk, gen):
        ts, yt, eps = Theta.sum(-1), Y_tk.sum(-1), self.eps
        if self.stationary:
            d = torch._standard_gamma((eps + yt.sum()).reshape(1),
                                      generator=gen) / (eps + ts.sum())
            delta = d.expand(Theta.shape[0])
        else:
            delta = torch._standard_gamma(eps + yt, generator=gen) / (eps + ts)
        return delta.clamp(min=1e-10)

    # -- 7. hyper-parameters ------------------------------------------------------
    def _hyper(self, s, Theta, Pi, gen):
        K, eps, gam = self.K, self.eps, self.gam
        z = torch.randn((self.n_mh, K + 1), generator=gen,
                        device=self.device) * self.mh_step
        u = torch.rand((self.n_mh,), generator=gen, device=self.device)
        th1, beta = Theta[0], s["beta"]
        nu, xi = _mh_nu_xi(s["nu"], s["xi"], z, u, lambda a, b: _hyper_logpost(
            a, b, th1, Pi, self.tau, gam, eps, beta))
        g = torch._standard_gamma(torch.full((1,), eps + gam + eps,
                                             device=self.device),
                                  generator=gen)[0]
        return nu, xi, g / (eps + nu.sum() + xi)


def pgds_gibbs(Y, nembeds, *, gam=10.0, tau=1.0, eps=0.1,
               stationary=False, binary=False,
               nburn=5000, nthin=10, nsamples=500, seed=42,
               verbose=0, n_mh=3, mh_step=0.08, chunk_sweeps=500,
               device="cuda"):
    """Run the PGDS Gibbs sampler on a 3-tensor (time = last axis): at
    least one burn-in sweep, then ``nsamples`` draws ``nthin`` sweeps apart.
    Returns numpy draws A (S,N,K), B (S,M,K), Theta (S,T,K), delta (S,T).
    The draws are copied to the host every ``chunk_sweeps`` sweeps."""
    sampler = PGDSSampler(Y, nembeds, gam=gam, tau=tau, eps=eps,
                          stationary=stationary, binary=binary, n_mh=n_mh,
                          mh_step=mh_step, seed=seed, device=device)
    nthin = max(int(nthin), 1)
    nburn = max(int(nburn), 1)
    chunk = max(int(chunk_sweeps), nthin)
    for done in range(0, nburn, chunk):
        sampler.run(min(chunk, nburn - done))
        if verbose:
            print("PGDS: burn {}/{}".format(min(done + chunk, nburn), nburn))
    names = ("A", "B", "Theta", "delta")
    acc = {name: [] for name in names}
    pending = []
    for i in range(nsamples):
        s = sampler.run(nthin)
        pending.append([s[name] for name in names])
        if len(pending) * nthin >= chunk or i == nsamples - 1:
            for name, parts in zip(names, zip(*pending)):
                acc[name].append(torch.stack(parts).cpu().numpy())
            pending = []
            if verbose:
                print("PGDS: collected {}/{} draws".format(i + 1, nsamples))
    return {name: (np.concatenate(parts) if parts else
                   np.zeros((0,) + tuple(sampler.state[name].shape),
                            np.float32))
            for name, parts in acc.items()}
