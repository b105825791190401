"""Unconstrained black-box-likelihood BTF by elliptical slice sampling.

Counterpart of functionalmf_tpu/models/nonconjugate.py (reference
functionalmf/factor.py:567-612): joint ESS updates of W and of V under
the trend-filtering prior, with a user-supplied

    loglikelihood(W, V, data) -> 0-d tensor

for ONE chain (W (n, k), V (m, T, k), ``data`` the prepared pytree on the
model's device). The model calls it a chain at a time (``_lifted``; the
JAX package vmaps it); plain PyTorch on the card, as the JAX path is
plain XLA. The
ellipse runs in the natural (masked) array shapes, and the V prior draws
come from one batched dense Cholesky.

Under a device mesh the chains run over dp and W's rows and V's columns
over mp, every draw taken for every chain at its global shape. The
user's function is one opaque whole-tensor function, so an update
all-gathers W and V (and, for V's prior draw, Tau2) over mp, runs one
joint ESS step over the global arrays on every rank of an mp line with
the same noise, broadcasts the line's first rank's result (so that the
line agrees even where ranks round differently) and keeps this rank's
slice. The ESS loop ends on a host read and holds no collective.
"""
from __future__ import annotations

import numpy as np
import torch

from functionalmf_tpu_torch._runtime import tree_map
from functionalmf_tpu_torch.models.base import BayesianTensorFiltering
from functionalmf_tpu_torch.parallel.mesh import MP_AXIS
from functionalmf_tpu_torch.samplers.ess import (draw_ess_noise,
                                                 elliptical_slice_batched)

__all__ = ["NonconjugateBayesianTensorFiltering"]


class NonconjugateBayesianTensorFiltering(BayesianTensorFiltering):
    """ESS-based BTF with loglikelihood(W, V, data) (factor.py:567-607).
    It runs on the card (``device="cuda"``, the default) unless the caller
    passes ``device="cpu"``; without a card the default raises."""

    def __init__(self, nrows, ncols, ndepth, loglikelihood,
                 ess_max_iters=100, **kwargs):
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.loglikelihood = loglikelihood
        self.ess_max_iters = int(ess_max_iters)

    def prepare_data(self, data):
        dt = self.data_dtype or self.dtype

        def leaf(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            return torch.as_tensor(np.asarray(x, dtype=np.float32),
                                   device=self.device).to(dt)
        return tree_map(leaf, data)

    def _lifted(self, data):
        """(W (nch, n, k), V (nch, m, T, k)) -> (nch,): the user's function
        a chain at a time. A call over every chain at once would order the
        whole-tensor sums by the number of chains it holds (on the card),
        and a rank of a mesh holds some of them: this way a chain's value
        is the same however the chains are spread."""
        user_ll = self.loglikelihood
        return lambda W, V: torch.stack([user_ll(W[c], V[c], data)
                                         for c in range(W.shape[0])])

    # ------------------------------------------------------------------
    def _ess_noise(self, gen):
        """draw_ess_noise for every chain, this rank's part of it."""
        log_u, u_phi, u = draw_ess_noise(gen, self.nchains,
                                         self.ess_max_iters, self.device)
        take = self._part.take
        return take(log_u, "c"), take(u_phi, "c"), take(u, ".c")

    def _ess(self, x, prior, loglik, gen):
        """One joint ESS step of the global ``x`` (this rank's chains),
        the line's first rank's result on every rank of an mp line."""
        x, _ = elliptical_slice_batched(x, prior, loglik, gen,
                                        max_iters=self.ess_max_iters,
                                        noise=self._ess_noise(gen))
        return x if self.mesh is None else self.mesh.broadcast(x, MP_AXIS)

    def _update_W_ess(self, state, data, gen):
        """factor.py:572-582: a prior draw from N(0, sigma2 I) on the
        lower-triangular support, then one joint ESS step over all of W."""
        p, mask = self._part, self._wmask
        W, V = p.all_rows(state["W"]), p.all_cols(state["V"])
        z = p.take(torch.randn(
            (self.nchains, self.nrows, self.nembeds), generator=gen,
            device=self.device), "c")
        prior = z * torch.sqrt(state["sigma2"])[:, None, None] * mask
        ll = self._lifted(data)
        x = self._ess(W, prior, lambda Wf: ll(Wf * mask, V), gen)
        return dict(state, W=p.take(x * mask, ".r"))

    def _update_V_ess(self, state, data, gen):
        """factor.py:584-590: a prior draw from the block trend-filtering
        precision (batched over columns), then one joint ESS step over V."""
        p = self._part
        nch, m, k, T = p.nc, self.ncols, self.nembeds, self.ndepth
        draw = self._sample_v_prior(gen, state["lam2"],
                                    p.all_cols(state["Tau2"]), dims="c")
        prior = draw.reshape(nch, m, k, T).transpose(-1, -2)   # (nch,m,T,k)
        W, V = p.all_rows(state["W"]), p.all_cols(state["V"])
        ll = self._lifted(data)
        x = self._ess(V, prior, lambda Vf: ll(W, Vf), gen)
        return dict(state, V=p.take(x, ".m").contiguous())

    def _make_sweep(self):
        def sweep(state, pdata, gen):
            return self._prior_sweep(state, pdata, gen,
                                     self._update_W_ess, self._update_V_ess)
        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        W = torch.as_tensor(np.asarray(params.get("W", self.W), np.float32),
                            device=self.device)
        V = torch.as_tensor(np.asarray(params.get("V", self.V), np.float32),
                            device=self.device)
        return float(self.loglikelihood(W, V, self.prepare_data(data)))
