"""Binomial / Bernoulli Bayesian Tensor Filtering by Polya-Gamma
augmentation.

Counterpart of functionalmf_tpu/models/binomial.py. One vectorised
``polya_gamma`` call draws the latent omega of every cell of every chain,
and the pseudo-data kappa = Y - N/2 (factor.py:439, 444) feeds the batched
Gaussian W and V updates as (weight, weighted target) pairs, without a
division by nu2 = 1 / omega. Under a mesh the PG draw is taken at the
global shape on every rank of an mp line (models/gaussian.py).
"""
from __future__ import annotations

import numpy as np
import torch

from functionalmf_tpu_torch.models.gaussian import (
    GaussianBayesianTensorFiltering)
from functionalmf_tpu_torch.ops.gamma import draw_gamma_mt_noise
from functionalmf_tpu_torch.ops.polyagamma import polya_gamma
from functionalmf_tpu_torch.utils import telemetry

__all__ = ["BinomialBayesianTensorFiltering"]


class BinomialBayesianTensorFiltering(GaussianBayesianTensorFiltering):
    """Polya-Gamma augmented binomial BTF (factor.py:425-460). Data is a
    pair (Y, N) of 3-tensors."""

    def __init__(self, nrows, ncols, ndepth, pg_seed=42, pg_num_terms=16,
                 **kwargs):
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.pg_num_terms = int(pg_num_terms)
        self.pg_seed = pg_seed  # parity kwarg; draws come from the model seed
        # nu2 is the (n, m, T) latent variance 1 / omega of every chain
        # (factor.py:433-435), resampled every sweep; inf where omega is 0
        self._put("nu2", self._chain_full(
            (self.nrows, self.ncols, self.ndepth), 0.0))
        self.sample_nu2 = True

    # ------------------------------------------------------------------
    def prepare_data(self, data):
        Y, N = data
        Y = np.asarray(Y, dtype=np.float32)
        N = np.asarray(N, dtype=np.float32)
        assert Y.ndim == 3 and N.shape == Y.shape, \
            "Binomial data must be a (Y, N) pair of 3-tensors."
        mask = (~np.isnan(Y)) & (~np.isnan(N))
        return {"Y": self._t(np.where(mask, Y, 0.0)),
                "N": self._t(np.where(mask, N, 0.0)),
                "mask": self._t(mask)}

    # ------------------------------------------------------------------
    def _pg_update(self, state, Y, N, mask, gen, g=None, z=None):
        """omega ~ PG(N, psi), psi = <w_i, v_jt> (factor.py:447-460).

        Y, N: (n, m, T) or (nchains, n, m, T). Returns (state with nu2 =
        1 / omega, w8 = omega, wy = kappa = Y - N/2), so that the Gaussian
        updates see weight omega and weighted target omega * kappa / omega.
        ``g`` and ``z`` inject ``polya_gamma``'s noise.
        """
        Mu = self._whole_mu(state)
        # polya_gamma's draws, for every chain: the gamma sampler's, then
        # the normals
        p, gnoise = self._part, None
        full = (self.nchains,) + tuple(Mu.shape[1:])
        if g is None:
            x, u, ub = draw_gamma_mt_noise(gen, (self.pg_num_terms,) + full,
                                           device=self.device)
            gnoise = (p.take(x, "..c"), p.take(u, "..c"), p.take(ub, ".c"))
        if z is None:
            z = p.take(torch.randn(full, generator=gen, device=self.device),
                       "c")
        omega = polya_gamma(gen, (N * mask).expand_as(Mu), Mu,
                            num_terms=self.pg_num_terms, g=g, z=z,
                            gamma_noise=gnoise)
        pos = omega > 0
        nu2 = torch.where(pos, 1.0 / torch.where(pos, omega, 1.0), torch.inf)
        w8 = omega * mask
        wy = ((Y - N / 2.0) * mask).expand_as(Mu)
        # every cell on every rank of an mp line; the state keeps the rows
        return dict(state, nu2=p.take(nu2, ".r")), w8, wy

    def _pg_sweep(self, state, pdata, gen, Y, N):
        """The PG draw, then the base order with the Gaussian updates at
        the drawn weights. The draw is a phase of the run record of its
        own, before ``prior``."""
        with telemetry.phase("pg_draw"):
            state, w8, wy = self._pg_update(state, Y, N, pdata["mask"], gen)

        def update_W(st, pd, gn):
            return self._gaussian_update_W(st, w8, wy, gn)

        def update_V(st, pd, gn):
            return self._gaussian_update_V(st, w8, wy, gn)

        return self._prior_sweep(state, pdata, gen, update_W, update_V)

    def _make_sweep(self):
        def sweep(state, pdata, gen):
            return self._pg_sweep(state, pdata, gen, pdata["Y"], pdata["N"])
        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        """Binomial log-likelihood at the given parameters."""
        from scipy.special import gammaln
        W = np.asarray(params.get("W", self.W))
        V = np.asarray(params.get("V", self.V))
        Y, N = data
        Y = np.asarray(Y, dtype=np.float64)
        N = np.asarray(N, dtype=np.float64)
        Mu = np.clip(np.einsum("nk,mtk->nmt", W, V), -30, 30)
        p = 1.0 / (1.0 + np.exp(-Mu))
        ll = (gammaln(N + 1) - gammaln(Y + 1) - gammaln(N - Y + 1)
              + Y * np.log(np.clip(p, 1e-12, 1))
              + (N - Y) * np.log(np.clip(1 - p, 1e-12, 1)))
        return float(np.nansum(ll))
