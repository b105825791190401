"""Gaussian Bayesian Tensor Filtering: the conditionally conjugate model.

Counterpart of functionalmf_tpu/models/gaussian.py. The W update is one
batched (chains, rows, k, k) Cholesky; the V update factors the
block-banded posterior precision of every (chain, column) at once
(ops/banded.py). Missing data and the lower-triangular identification of
W are fixed-shape masks. The Polya-Gamma models (binomial.py,
negbinom.py) reuse both updates with their own weights.

The observation variance ``nu2`` is, per chain, a sampled scalar (state
shape (nchains,)), a sampled variance per row with ``nu2_mode="row"``
((nchains, n, 1, 1)), or a fixed heteroskedastic (n, m, T) tensor given
as ``nu2_true`` ((nchains, n, m, T)).

The V draw comes from a slightly regularised conditional (a relative
jitter of 1e-4 on the equilibrated system, ops/banded.py), as in the JAX
package.

Under a device mesh (``mesh=``, models/base.py) the chains run over dp
and W's rows and V's columns over mp; every draw is taken at its global
shape and each rank keeps its part. ``nu2`` is sharded as W's rows
(``state_partition_specs``), as in the JAX package. The data stays whole
on every rank. The steps that read every cell, the nu2 draw (and in the
Polya-Gamma models the PG draw and NegBinom's R moves), run on the whole
tensor on every rank of an mp line, from W and V all-gathered over mp:
they draw and sum what the unsharded run does, and need no other
collective. The W update is row-local (V all-gathered), the V update's
banded factorisation column-local (W all-gathered); its repair counts
are summed over mp (``_Part.cols_sum``). The W update's Gram and mean
part, the V update's mean part, the cells' mean W V^T and the nu2 draw's
sums run in a fixed order (``_fixed_sum``): a batched product or a
reduction orders its sums by the number of rows, columns or chains it
holds (on the card, and on the CPU at small shapes), and a rank holds a
part of them. ``chip_smoke.py:family_sum_probe`` names each such site;
the V update's Gram (an einsum) was found to keep its bits.
"""
from __future__ import annotations

import numpy as np
import torch

from functionalmf_tpu_torch.models.base import (BayesianTensorFiltering,
                                                _fixed_sum)
from functionalmf_tpu_torch.ops.banded import (
    build_v_bands, retiled_noise_shape, sample_mvn_block_banded_retiled)
from functionalmf_tpu_torch.ops.mvn import sample_mvn_from_precision
from functionalmf_tpu_torch.ops.penalty import penalty_half_bandwidth
from functionalmf_tpu_torch.parallel.mesh import DP_AXIS, MP_AXIS
from functionalmf_tpu_torch.samplers.conjugate import standard_gamma

__all__ = ["GaussianBayesianTensorFiltering"]

# time steps a super-block of the retiled V factorisation
_V_SUPERBLOCK = 8


def w_likelihood_terms(w8, wy, Vf):
    """The W update's likelihood terms: every row's Gram sum_p w8[p] V_p
    V_p^T (nch, n, k, k) and mean part sum_p wy[p] V_p (nch, n, k) over
    its P cells; w8, wy (nch, n, P), Vf (nch, P, k). Summed in a fixed
    order (``_fixed_sum``, both in one call), so a row's values have the
    same bits whatever the number of chains and rows in the call (a batched
    product orders its sums by them)."""
    nch, n, k = w8.shape[0], w8.shape[1], Vf.shape[-1]
    VV = (Vf[:, :, :, None] * Vf[:, :, None, :]).reshape(nch, -1, k * k)
    terms = torch.cat([w8[..., None] * VV[:, None],
                       wy[..., None] * Vf[:, None]], -1)
    s = _fixed_sum(terms, (2,))[:, :, 0]
    return s[..., :k * k].reshape(nch, n, k, k), s[..., k * k:]


def v_mean_part(wy, W):
    """The V update's mean part sum_i wy[i] W_i (nch, m, T, k) over the n
    rows; wy (nch, n, m, T), W (nch, n, k). Summed in a fixed order, as
    ``w_likelihood_terms``."""
    return _fixed_sum(W[:, :, None, None] * wy[..., None], (1,))[:, 0]


def cell_means(W, V):
    """W V^T over every cell, (nch, n, m, T), summed over k in a fixed
    order, as ``w_likelihood_terms``; W (nch, n, k), V (nch, m, T, k)."""
    return _fixed_sum(W[:, :, None, None] * V[:, None], (4,))[..., 0]


class GaussianBayesianTensorFiltering(BayesianTensorFiltering):
    """Conjugate Gaussian BTF (reference factor.py:286-423). It runs on
    the card (``device="cuda"``, the default) unless the caller passes
    ``device="cpu"``; without a card the default raises."""

    _collect_keys = ("W", "V", "sigma2", "lam2", "Tau2", "nu2")

    def __init__(self, nrows, ncols, ndepth,
                 nu2_init=None, nu2_true=None,
                 nu2_a=0.1, nu2_b=0.1,
                 nu2_mode="scalar", **kwargs):
        """nu2_mode: 'scalar' (one shared sampled observation variance) or
        'row' (one sampled variance per row)."""
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.nu2_a = nu2_a
        self.nu2_b = nu2_b
        assert nu2_mode in ("scalar", "row"), nu2_mode
        self.nu2_mode = nu2_mode
        row_shape = (self.nrows, 1, 1)

        def nu2_state(value):
            v = np.asarray(value, dtype=np.float32)
            if v.ndim == 0:
                if self.nu2_mode == "row":
                    return self._chain_broadcast(np.full(row_shape, v),
                                                 row_shape)
                return self._chain_full((), value)
            assert v.shape == (self.nrows, self.ncols, self.ndepth)
            return self._chain_broadcast(v, v.shape)

        # the init generator is taken whether or not nu2 is drawn, so the
        # subclasses' init draws come from the same streams either way
        gen = self._next_init_gen()
        if nu2_true is not None:
            self._put("nu2", nu2_state(nu2_true))
            self.sample_nu2 = False
        else:
            self.sample_nu2 = True
            if nu2_init is not None:
                assert np.ndim(nu2_init) == 0, (
                    "heteroskedastic nu2 must be fixed (nu2_true); sampled "
                    "nu2 is scalar or per-row (nu2_mode)")
                self._put("nu2", nu2_state(nu2_init))
            else:
                # nu2 = 1 / IG-prior draw (factor.py:418-419)
                shape = row_shape if self.nu2_mode == "row" else ()
                g = standard_gamma(gen, nu2_a, (self.nchains,) + shape,
                                   device=self.device)
                self._put("nu2", 1.0 / (g / nu2_b))

    nu2 = property(lambda s: s._get_var("nu2"),
                   lambda s, v: s._set_var("nu2", v))

    def state_partition_specs(self):
        specs = super().state_partition_specs()
        # nu2 is (C,), (C, n, 1, 1) or (C, n, m, T): rows align with W's
        # mp sharding (feasible_spec trims the spec to the array's ndim)
        specs["nu2"] = (DP_AXIS, MP_AXIS)
        return specs

    # ------------------------------------------------------------------
    # data: NaN-masked sufficient statistics over replicates, computed
    # once (factor.py:323-330)
    # ------------------------------------------------------------------
    def prepare_data(self, data):
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        Y = np.asarray(data, dtype=np.float32)
        assert Y.ndim in (3, 4), "Observations must be 3- or 4-tensor."
        if Y.ndim == 3:
            Y = Y[..., None]
        obs = ~np.isnan(Y)
        Yz = np.where(obs, Y, 0.0)
        return {"counts": self._t(obs.sum(axis=-1)),
                "ysum": self._t(Yz.sum(axis=-1)),
                "ysqsum": self._t((Yz * Yz).sum(axis=-1))}

    def _nu2_cells(self, nu2):
        """nu2 against (nchains, n, m, T) cells: the scalar state (nchains,)
        gets its cell axes, the other two shapes broadcast as they are
        (every row of them, all-gathered over mp where rows are split)."""
        return (nu2[:, None, None, None] if nu2.dim() == 1
                else self._part.all_rows(nu2))

    def _whole_mu(self, state):
        """W V^T over every cell: (nchains, n, m, T), W and V all-gathered
        over mp where they are split."""
        p = self._part
        return cell_means(p.all_rows(state["W"]), p.all_cols(state["V"]))

    # ------------------------------------------------------------------
    # batched conjugate updates, shared with the Polya-Gamma subclasses
    # ------------------------------------------------------------------
    def _gaussian_update_W(self, state, w8, wy, gen, z=None):
        """Every row's ridge posterior of every chain in one batched
        Cholesky (factor.py:313-362).

        w8 (nchains, n, m, T): the cells' precision weights (counts / nu2
        here, omega in the Polya-Gamma models), every row; wy = w8 *
        target, so that mu_part = X^T wy. ``z`` (nchains, n, k) injects
        the normal draw. Under a mesh: this rank's rows against V
        all-gathered over mp.
        """
        p = self._part
        nch, n, k = p.nc, p.nr, self.nembeds
        w8, wy = p.take(w8, ".r"), p.take(wy, ".r")
        Vf = p.all_cols(state["V"]).reshape(nch, -1, k)        # (nch, P, k)
        Q_lik, mu_part = w_likelihood_terms(w8.reshape(nch, n, -1),
                                            wy.reshape(nch, n, -1), Vf)
        mask = self._wmask_rows
        eye = torch.eye(k, device=self.device)
        Q = (Q_lik * mask[:, :, None] * mask[:, None, :]
             + eye / state["sigma2"][:, None, None, None])
        mu_part = mu_part * mask
        if z is None:
            z = p.take(torch.randn((self.nchains, self.nrows, k),
                                   generator=gen, device=self.device), "cr")
        Wnew = sample_mvn_from_precision(gen, Q, mu_part=mu_part,
                                         equilibrate=True, z=z,
                                         **self.linalg_opts)
        return dict(state, W=Wnew * mask)

    def _v_bands(self, state, w8, wy):
        """The V update's block-banded precision (nchains, m, T, p+1, k, k)
        and mean part (nchains, m, T, k): G[j, t] = sum_i w8[i, j, t] W_i
        W_i^T on the diagonal blocks, the prior Gram DtLD on the bands.
        Under a mesh: this rank's columns, W all-gathered over mp."""
        p = self._part
        w8, wy = p.take(w8, "..m"), p.take(wy, "..m")
        W = p.all_rows(state["W"]) * self._wmask
        G = torch.einsum("cijt,cia,cib->cjtab", w8, W, W)
        DtLD = self._v_prior_dtld(state["lam2"], state["Tau2"])
        bands = build_v_bands(DtLD, G, penalty_half_bandwidth(self.tf_order))
        return bands, v_mean_part(wy, W)

    def _gaussian_update_V(self, state, w8, wy, gen, z=None):
        """Every column's GLS posterior of every chain through the
        block-banded Cholesky (factor.py:364-409): O(T p^2 k^3) a column
        where a dense factorisation costs (kT)^3. ``z`` (nchains, m, T, k)
        injects the normal draw.

        Pivot repairs are never silent: the jitter-rung repairs of a chain
        add to its ``pivot_repairs``, and the Gershgorin shifts (a
        materially perturbed conditional) also to its ``nan_fallbacks``.
        """
        bands, mu_part = self._v_bands(state, w8, wy)
        zt = None
        if z is None:      # the retiled normals, for every chain
            T, p1, k = bands.shape[-4], bands.shape[-3], bands.shape[-1]
            zt = self._part.take(torch.randn(
                (self.nchains, self.ncols)
                + retiled_noise_shape(T, p1, k, _V_SUPERBLOCK),
                generator=gen, device=self.device), "cm")
        Vnew, repaired, gersh = sample_mvn_block_banded_retiled(
            gen, bands, mu_part=mu_part, B=_V_SUPERBLOCK, equilibrate=True,
            return_repairs=True, z=z, z_tiled=zt)
        p = self._part
        return dict(state, V=Vnew,
                    pivot_repairs=state["pivot_repairs"]
                    + p.cols_sum(repaired, (-1,)),
                    nan_fallbacks=state["nan_fallbacks"]
                    + p.cols_sum(gersh, (-1,)))

    def _update_nu2(self, state, pdata, gen, gamma=None):
        """The observation noise's inverse-gamma update (factor.py:411-416),
        a shared scalar or one per row. ``gamma`` injects the standard
        Gamma(nu2_a + nobs / 2, 1) draw, (nchains,) or (nchains, n).
        Over every cell on every rank; a rank keeps its rows."""
        Mu = self._whole_mu(state)
        cellerr = (pdata["ysqsum"] - 2.0 * Mu * pdata["ysum"]
                   + pdata["counts"] * Mu * Mu)
        # a chain's sums in a fixed order (_fixed_sum)
        if self.nu2_mode == "row":
            sqerr = _fixed_sum(cellerr, (2, 3))[:, :, 0, 0]  # (nch, n)
            nobs = pdata["counts"].sum((1, 2)).expand(self.nchains, -1)
        else:
            sqerr = _fixed_sum(cellerr, (1, 2, 3)).reshape(-1)   # (nch,)
            nobs = pdata["counts"].sum().expand(self.nchains)
        if gamma is None:           # for every chain
            gamma = self._part.take(
                standard_gamma(gen, self.nu2_a + nobs / 2.0), "c")
        nu2 = 1.0 / (gamma / (self.nu2_b + sqerr / 2.0))
        if self.nu2_mode == "row":
            nu2 = self._part.take(nu2[:, :, None, None], ".r")
        return dict(state, nu2=nu2)

    # ------------------------------------------------------------------
    def _make_sweep(self):
        def weights(state, pdata):
            nu2 = self._nu2_cells(state["nu2"])
            return pdata["counts"] / nu2, pdata["ysum"] / nu2

        def update_W(state, pdata, gen):
            return self._gaussian_update_W(state, *weights(state, pdata), gen)

        def update_V(state, pdata, gen):
            return self._gaussian_update_V(state, *weights(state, pdata), gen)

        def sweep(state, pdata, gen):
            # nu2 first, then the base order (factor.py:306-311)
            if self.sample_nu2:
                state = self._update_nu2(state, pdata, gen)
            return self._prior_sweep(state, pdata, gen, update_W, update_V)

        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        """Gaussian log-likelihood of the data at the given parameters
        (one parameter set: chain 0 of a model with several chains)."""
        W = np.asarray(params.get("W", self.W))
        V = np.asarray(params.get("V", self.V))
        nu2 = np.asarray(params.get("nu2", self.nu2), dtype=np.float64)
        # per-chain ndims: W 2, V 3, nu2 0 or 3
        if W.ndim == 3:
            W = W[0]
        if V.ndim == 4:
            V = V[0]
        if nu2.ndim in (1, 4):
            nu2 = nu2[0] if nu2.shape[0] == self.nchains \
                else nu2.reshape(-1)[0]
        Y = np.asarray(data, dtype=np.float64)
        if Y.ndim == 3:
            Y = Y[..., None]
        Mu = np.einsum("nk,mtk->nmt", W, V)[..., None]
        nu2b = np.broadcast_to(nu2.reshape(nu2.shape + (1,) * (4 - nu2.ndim))
                               if nu2.ndim else nu2, Y.shape)
        obs = ~np.isnan(Y)
        resid2 = (Y - Mu) ** 2
        return float(np.sum(-0.5 * resid2[obs] / nu2b[obs]
                            - 0.5 * np.log(2 * np.pi * nu2b[obs])))
