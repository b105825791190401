"""Negative-Binomial Bayesian Tensor Filtering.

Counterpart of functionalmf_tpu/models/negbinom.py: the negative binomial
as a Polya-Gamma augmented binomial with pseudo-count N = sum_reps(Y + R).
The dispersion R is sampled by ``nmetropolis`` vectorised random-walk
Metropolis-Hastings steps on log R, aggregated over ``rdims``, under a
log-normal prior (factor.py:513-554); every cell's accept/reject decision
of a step is one masked tensor operation.

Under a mesh the R moves run on the whole tensor on every rank of an mp
line (models/gaussian.py), R replicated over mp as in the JAX package.
A move sums a chain's cells in an order fixed by their number alone
(``_window_sum``): a reduction over a rank's chains orders its sums by
their number on the card.

Kept from the reference: the clip of the acceptance log-ratio to
[-10, 1] (factor.py:542) and the R > 1 acceptance gate (factor.py:547),
as ``accept_clip`` and ``r_min``. N always derives from the current R.
"""
from __future__ import annotations

import numpy as np
import torch

from functionalmf_tpu_torch.models.base import _window_sum
from functionalmf_tpu_torch.models.binomial import (
    BinomialBayesianTensorFiltering)
from functionalmf_tpu_torch.parallel.mesh import DP_AXIS

__all__ = ["NegativeBinomialBayesianTensorFiltering"]


class NegativeBinomialBayesianTensorFiltering(BinomialBayesianTensorFiltering):
    """NB BTF (factor.py:463-563). Data is Y (n, m, t[, r]) counts."""

    _collect_keys = ("W", "V", "sigma2", "lam2", "Tau2", "nu2", "R")

    def __init__(self, nrows, ncols, ndepth,
                 R_true=None, R_init=None,
                 nmetropolis=30, rpropstdev=0.1, rstdev=1.0,
                 rdims=(0, 1, 2), accept_clip=(-10.0, 1.0), r_min=1.0,
                 **kwargs):
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.nmetropolis = int(nmetropolis)
        self.rpropstdev = float(rpropstdev)
        self.rstdev = float(rstdev)
        self.accept_clip = accept_clip
        self.r_min = float(r_min)
        rdims = tuple(sorted(rdims)) if rdims is not None else ()
        self.rdims = rdims
        # aggregation axes of the (nchains, n, m, t, r) likelihood tensor:
        # the replicates always (factor.py:486), and the user's rdims
        self._agg_axes = tuple(d + 1 for d in rdims) + (4,)
        self._R_shape = tuple(1 if i in rdims else c
                              for i, c in enumerate([nrows, ncols, ndepth]))

        gen = self._next_init_gen()     # taken whether or not R is drawn
        self.sample_R = R_true is None
        given = R_true if R_true is not None else R_init
        if given is not None:
            self._put("R", self._chain_broadcast(given, self._R_shape))
        else:
            # R = exp(N(0, rstdev)) + 1 (factor.py:560-563)
            z = torch.randn((self.nchains,) + self._R_shape, generator=gen,
                            device=self.device)
            self._put("R", torch.exp(z * self.rstdev) + 1.0)

    R = property(lambda s: s._get_var("R"), lambda s, v: s._set_var("R", v))

    def state_partition_specs(self):
        specs = super().state_partition_specs()
        # R aggregates over rdims (axes may be size 1); replicated over mp
        specs["R"] = (DP_AXIS,)
        return specs

    # ------------------------------------------------------------------
    def prepare_data(self, data):
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        Y = np.asarray(data, dtype=np.float32)
        assert Y.ndim in (3, 4), "Observations must be 3- or 4-tensor."
        if Y.ndim == 3:
            Y = Y[..., None]
        repmask = ~np.isnan(Y)
        return {"Yrep": self._t(np.where(repmask, Y, 0.0)),
                "repmask": self._t(repmask),
                "mask": self._t(repmask.any(axis=-1))}

    # ------------------------------------------------------------------
    def draw_R_noise(self, gen):
        """(z, u): the proposals' normals and the acceptance uniforms of
        one R update, (nmetropolis, nchains) + R's shape each, drawn from
        ``gen`` in this order (every chain's, under a mesh too)."""
        shape = (self.nmetropolis, self.nchains) + self._R_shape
        z = torch.randn(shape, generator=gen, device=self.device)
        u = torch.rand(shape, generator=gen, device=self.device)
        return z, u

    def _update_R(self, state, pdata, gen, noise=None):
        """Vectorised random-walk Metropolis on log R (factor.py:513-554).
        ``noise`` injects ``draw_R_noise``'s pair."""
        Y, rm = pdata["Yrep"], pdata["repmask"]
        lo, hi = self.accept_clip
        z, u = (self._part.take(t, ".c")
                for t in (self.draw_R_noise(gen) if noise is None else noise))
        # success probability from the current embeddings (factor.py:519),
        # over every cell on every rank of an mp line
        Mu = self._whole_mu(state)
        P = torch.sigmoid(torch.clamp(Mu, -10, 10))[..., None]
        log1mP = torch.log1p(-P)
        logR = torch.log(state["R"])
        inv_2s2 = 0.5 / (self.rstdev * self.rstdev)
        for i in range(self.nmetropolis):
            cand = logR + z[i] * self.rpropstdev
            Rc = torch.exp(cand)[..., None]       # (nch,) + R_shape + (1,)
            R0 = torch.exp(logR)[..., None]
            # log-normal prior ratio: the normalisers cancel
            ap = (logR * logR - cand * cand) * inv_2s2
            al = (torch.lgamma(Y + Rc) - torch.lgamma(Rc)
                  - torch.lgamma(Y + R0) + torch.lgamma(R0)
                  + (Rc - R0) * log1mP) * rm
            al = _window_sum(al, self._agg_axes).reshape(logR.shape)
            prob = torch.exp(torch.clamp(ap + al, lo, hi))
            accept = (u[i] <= prob) & (torch.exp(cand) > self.r_min)
            logR = torch.where(accept, cand, logR)
        return dict(state, R=torch.exp(logR))

    def _make_sweep(self):
        def sweep(state, pdata, gen):
            if self.sample_R:
                state = self._update_R(state, pdata, gen)
            # the binomial reduction: successes summed over replicates,
            # N = sum_reps(Y + R) (factor.py:507-511, 553)
            rm = pdata["repmask"]
            Ysum = (pdata["Yrep"] * rm).sum(-1)
            N = ((pdata["Yrep"] + state["R"][..., None]) * rm).sum(-1)
            return self._pg_sweep(state, pdata, gen, Ysum, N)
        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        """Negative-binomial log-likelihood at the given parameters."""
        from scipy.special import gammaln
        W = np.asarray(params.get("W", self.W))
        V = np.asarray(params.get("V", self.V))
        R = np.asarray(params.get("R", self.R))
        Y = np.asarray(data, dtype=np.float64)
        if Y.ndim == 3:
            Y = Y[..., None]
        Mu = np.clip(np.einsum("nk,mtk->nmt", W, V), -10, 10)
        P = 1.0 / (1.0 + np.exp(-Mu))
        Rb = np.broadcast_to(R, Mu.shape)[..., None]
        Pb = P[..., None]
        ll = (gammaln(Y + Rb) - gammaln(Rb) - gammaln(Y + 1)
              + Rb * np.log1p(-Pb) + Y * np.log(np.clip(Pb, 1e-12, 1)))
        return float(np.nansum(ll))
