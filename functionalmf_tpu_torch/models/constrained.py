"""Constrained black-box-likelihood BTF, the cellfn recipes.

Counterpart of functionalmf_tpu/models/constrained.py with a cell
log-likelihood (``loglikelihood_cellfn``): linear constraints
``A tau >= c`` on every curve, GASS with the grid method, the W update
over rows, the blocked V update and the exact scale moves
(``interweave``, ``factor_rebalance``). The V update runs any of the
JAX package's schedules:

* ``v_schedule="redblack"``: the two-colour schedule, every same-colour
  block of every column in one GASS round (2 rounds, 3 with a ragged
  tail);
* ``v_schedule="seq"``: the time blocks one after another
  (``_update_V_gass``, ceil(T / v_block_size) rounds);
* ``v_block_size=None`` (or ``>= T``, any schedule but red-black): the
  joint update of the whole curve, one round.

A round is one batched GASS update over every (chain, column, block) of
its blocks, given the rest. With ``ep_approx=(Mu_ep, Sigma_ep)`` the
proposals are EP-centred (constrained.py:431-446, 633-681, 853-906): the
W rows draw from the GLS Gaussian, the V blocks from the coupled
(size*k) block precision ``kron(DtLD_blk, I_k) + diag_t(G)`` in t-major
packing, and the likelihood divides the EP factor out again.

Every GASS candidate log-likelihood goes through the fused functions of
``ops/fused_ll.py``, with the EP extras when EP is on: on the card, the
W update is one launch of the row kernel over all (chain, row) pairs,
and each V round is one launch of the column-block kernel over all of
its (chain, column, block) pairs. That is the computation of the JAX
package's inline einsum (constrained.py:955-970), which is
``fused_col_block_ll`` for one pair. ``fuse_cells`` is accepted for
signature parity and changes nothing.

Not ported yet (NotImplementedError): a model without a cellfn,
explicit ``loglikelihood_cells``/``loglikelihood_block``,
``gass_method="shrink"`` and ``Row_constraints``.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from functionalmf_tpu_torch.models.base import BayesianTensorFiltering
from functionalmf_tpu_torch.ops.fused_ll import (
    KERNEL_CELLS, as_cellfn, fused_col_block_ll_batched,
    fused_row_ll_batched)
from functionalmf_tpu_torch.ops.mvn import (
    _cho_solve, _solve_lt, cholesky_psd, sample_mvn_from_precision)
from functionalmf_tpu_torch.samplers.gass import draw_gass_noise, gass
from functionalmf_tpu_torch.samplers.horseshoe import resample_lam2
from functionalmf_tpu_torch.samplers.slice1d import shrink_slice_1d

__all__ = ["ConstrainedNonconjugateBayesianTensorFiltering",
           "collapsed_scale_dims", "ep_block_precision"]

_LATER = "not ported yet (ROADMAP.md, Queue 1 item 8)"
_LOG_LAM2_MIN = float(np.log(1e-5))


def collapsed_scale_dims(w_len, ncols, ndepth, nembeds):
    """(dW_free, dV_free) of the collapsed scale-split moves, as the
    reference has them (functionalmf_tpu/models/constrained.py:1082-1083).
    dV_free counts ncols*ndepth*nembeds, while the conjugate lam2 update
    uses nD*ncols*nembeds (samplers/horseshoe.lam2_shape): a known fault
    of the reference, ported as it is (ROADMAP.md, Queue 3 item 1)."""
    return float(w_len), float(ncols * ndepth * nembeds)


def ep_block_precision(DtLD_blk, G_blk):
    """The coupled (size*k) precision of an EP-centred V block,
    kron(DtLD_blk, I_k) + diag_t(G), t-major: Q[(t, a), (s, c)] =
    DtLD_blk[t, s] 1{a = c} + G[t, a, c] 1{t = s} (constrained.py:
    659-668, 889-896). DtLD_blk: (..., size, size); G_blk: (..., size, k,
    k). Returns (..., size*k, size*k)."""
    size, k = G_blk.shape[-3], G_blk.shape[-1]
    dev = G_blk.device
    Q = (torch.einsum("...ts,ac->...tasc", DtLD_blk,
                      torch.eye(k, device=dev))
         + torch.einsum("...tac,ts->...tasc", G_blk,
                        torch.eye(size, device=dev)))
    return Q.reshape(Q.shape[:-4] + (size * k, size * k))


@dataclasses.dataclass
class _Phase:
    """Host-built constants of one round of the blocked V update: its
    blocks, all of one size, update together given the rest."""
    starts: list
    size: int
    tidx: torch.Tensor       # (nblk, size) time indices of the blocks
    t_mask: torch.Tensor     # (T,) 0 inside the phase's blocks
    CA_blk: torch.Tensor     # (nblk, Jb, size) constraint rows in-block
    CA_out: torch.Tensor     # (nblk, Jb, T) the same rows out of block
    CC_pad: torch.Tensor     # (nblk, Jb) offsets; padded rows 0 >= -1
    pair_chain: torch.Tensor  # (P,) int32, P = nchains * ncols * nblk
    pair_col: torch.Tensor
    pair_t0: torch.Tensor


class ConstrainedNonconjugateBayesianTensorFiltering(BayesianTensorFiltering):
    """Constrained nonconjugate BTF (reference factor.py:894-1017) with a
    cellfn. It runs on the card (``device="cuda"``, the default) unless
    the caller passes ``device="cpu"``; without a card the default
    raises."""

    def __init__(self, nrows, ncols, ndepth, loglikelihood, Constraints,
                 ep_approx=None,
                 nthreads=None,
                 gass_ngrid=100,
                 gass_w_repeats=1,
                 gass_v_repeats=1,
                 gass_method="grid",
                 Row_constraints=None,
                 multiprocessing=None,
                 sharedprefix=None,
                 worker_init=None,
                 v_block_size=8,
                 v_schedule="seq",
                 loglikelihood_cells=None,
                 loglikelihood_block=None,
                 loglikelihood_cellfn=None,
                 fuse_cells=False,
                 interweave=True,
                 factor_rebalance=True,
                 **kwargs):
        if loglikelihood_cellfn is None:
            raise NotImplementedError(
                "the port runs the cellfn recipe only: pass "
                f"loglikelihood_cellfn (other likelihoods are {_LATER})")
        if loglikelihood_cells is not None or loglikelihood_block is not None:
            raise NotImplementedError(
                f"explicit loglikelihood_cells/_block are {_LATER}")
        if Row_constraints is not None:
            raise NotImplementedError(f"Row_constraints are {_LATER}")
        if gass_method not in ("grid", "shrink"):
            raise ValueError(f"unknown gass_method {gass_method!r}")
        if gass_method == "shrink":
            raise NotImplementedError(f"gass_method='shrink' is {_LATER}")
        if v_schedule not in ("seq", "redblack"):
            raise ValueError(f"unknown v_schedule {v_schedule!r}")
        super().__init__(nrows, ncols, ndepth, **kwargs)
        self.loglikelihood = loglikelihood
        self.loglikelihood_cellfn = as_cellfn(loglikelihood_cellfn)
        if (self.device.type == "cuda"
                and self.loglikelihood_cellfn.name not in KERNEL_CELLS):
            raise ValueError(
                f"cell function {self.loglikelihood_cellfn.name!r} has no "
                "CUDA kernel specialisation; on a CUDA device pass a CellFn "
                f"named one of {sorted(KERNEL_CELLS)} (e.g. "
                "functionalmf_tpu_torch.ops.fused_ll.POISSON)")
        self.fuse_cells = bool(fuse_cells)   # parity only: always fused
        self.interweave = bool(interweave)
        self.factor_rebalance = bool(factor_rebalance)
        self.gass_ngrid = int(gass_ngrid)
        self.gass_w_repeats = max(1, int(gass_w_repeats))
        self.gass_v_repeats = max(1, int(gass_v_repeats))
        self.gass_method = gass_method
        self.v_schedule = v_schedule
        self.v_block_size = None if v_block_size is None else int(v_block_size)

        Constraints = np.asarray(Constraints, dtype=np.float32)
        if v_schedule == "redblack":
            self._check_redblack(Constraints)

        self._CA_np = Constraints[:, :-1]                      # (J, T)
        self._CC_np = Constraints[:, -1]                       # (J,)
        self.Constraints_A = self._t(self._CA_np)
        self.Constraints_C = self._t(self._CC_np)
        self.nconstraints = int(Constraints.shape[0])
        self._c_rows = self.Constraints_C.repeat(self.ncols)   # (m*J,)

        nch, n = self.nchains, self.nrows
        self._row_chain = torch.arange(
            nch, dtype=torch.int32, device=self.device).repeat_interleave(n)
        self._row_idx = torch.arange(
            n, dtype=torch.int32, device=self.device).repeat(nch)
        T = self.ndepth
        bs = self.v_block_size or T
        if v_schedule == "redblack":
            nb_full, rem = divmod(T, bs)
            self._phases = [self._build_phase([b * bs for b in blocks], bs)
                            for blocks in (range(0, nb_full, 2),
                                           range(1, nb_full, 2)) if blocks]
            if rem:   # ragged tail block, one extra single-block round
                self._phases.append(self._build_phase([nb_full * bs], rem))
        else:         # sequential blocks; one block of T is the joint update
            self._phases = [self._build_phase([s0], min(bs, T - s0))
                            for s0 in range(0, T, bs)]
        self._init_ep(ep_approx)

    # ------------------------------------------------------------------
    def _check_redblack(self, Constraints):
        """The red-black schedule is exact Gibbs only when same-colour
        blocks are conditionally independent (constrained.py:247-272)."""
        bs = self.v_block_size
        if bs is None or bs >= self.ndepth:
            raise ValueError("redblack needs a finite v_block_size < T")
        supp = np.abs(self.Delta_np) > 0
        extents = [np.nonzero(r)[0] for r in supp if r.any()]
        delta_ext = max(int(e.max() - e.min()) for e in extents)
        if delta_ext > bs:
            raise ValueError(
                f"prior bandwidth {delta_ext} > v_block_size {bs}: "
                "non-adjacent blocks would couple through the prior")
        csupp = np.abs(Constraints[:, :-1]) > 0
        cext = [np.nonzero(r)[0] for r in csupp if r.any()]
        cons_w = max((int(e.max() - e.min()) + 1 for e in cext), default=0)
        if cons_w > bs + 1:
            raise ValueError(
                f"a constraint row spans {cons_w} time points > "
                f"v_block_size + 1 = {bs + 1}: it could couple two "
                "same-color blocks")

    def _init_ep(self, ep_approx):
        """EP centring (constrained.py:294-315): float32 host copies, the
        overconfidence warning, and the device tensors the updates read:
        ``_ep`` = (mu, sig) as the kernels' extras, (n, m, T) each (empty
        without EP), and the masked precisions Sinv2 and Mu0 * Sinv2."""
        self._ep = ()
        if ep_approx is None:
            self.Mu_ep = self.Sigma_ep = None
            return
        shape = (self.nrows, self.ncols, self.ndepth)
        self.Mu_ep = np.asarray(ep_approx[0], np.float32)
        self.Sigma_ep = np.asarray(ep_approx[1], np.float32)
        if self.Mu_ep.shape != shape or self.Sigma_ep.shape != shape:
            raise ValueError(f"ep_approx must be two {shape} arrays, got "
                             f"{self.Mu_ep.shape} and {self.Sigma_ep.shape}")
        # An overconfident EP traps the chain: the subtracted EP logpdf
        # grows quadratically with distance from Mu_ep, so once an
        # excursion leaves the EP bulk, every candidate nearer the centre
        # falls below the slice.
        mu_np = np.asarray(ep_approx[0], np.float64)
        sig_np = np.asarray(ep_approx[1], np.float64)
        spread = np.nanstd(mu_np)
        if np.nanmedian(sig_np) < 0.5 * spread:
            warnings.warn(
                "Sigma_ep is small relative to the spread of Mu_ep "
                f"(median {np.nanmedian(sig_np):.3g} vs std {spread:.3g}); "
                "overconfident EP approximations can trap the GASS chain "
                "— consider ep_from_mf(mode='multiplier', multiplier>=3).")
        mu, sig = self._t(self.Mu_ep), self._t(self.Sigma_ep)
        self._ep = (mu, sig)
        nan = torch.isnan(mu)
        self._ep_sinv2 = torch.where(nan, 0.0, 1.0 / (sig * sig))
        self._ep_mu_sinv2 = torch.where(nan, 0.0, mu) * self._ep_sinv2

    # ------------------------------------------------------------------
    def _build_phase(self, starts, size):
        T, m, nch = self.ndepth, self.ncols, self.nchains
        nblk = len(starts)
        t_mask = np.ones(T, np.float32)
        for s in starts:
            t_mask[s:s + size] = 0.0
        rels = [np.nonzero(np.abs(self._CA_np[:, s:s + size]).sum(1) > 0)[0]
                for s in starts]
        Jb = max(1, max(len(r) for r in rels))
        CA_blk = np.zeros((nblk, Jb, size), np.float32)
        CA_out = np.zeros((nblk, Jb, T), np.float32)
        CC_pad = np.full((nblk, Jb), -1.0, np.float32)
        for b, (s, rel) in enumerate(zip(starts, rels)):
            if len(rel) == 0:
                continue
            CA_blk[b, :len(rel)] = self._CA_np[rel][:, s:s + size]
            co = self._CA_np[rel].copy()
            co[:, s:s + size] = 0.0
            CA_out[b, :len(rel)] = co
            CC_pad[b, :len(rel)] = self._CC_np[rel]
        tidx = np.asarray(starts)[:, None] + np.arange(size)[None]
        cc, jj, bb = np.meshgrid(np.arange(nch), np.arange(m),
                                 np.arange(nblk), indexing="ij")
        i32 = dict(dtype=torch.int32, device=self.device)
        return _Phase(
            starts=list(starts), size=size,
            tidx=torch.as_tensor(tidx, dtype=torch.long, device=self.device),
            t_mask=self._t(t_mask), CA_blk=self._t(CA_blk),
            CA_out=self._t(CA_out), CC_pad=self._t(CC_pad),
            pair_chain=torch.as_tensor(cc.reshape(-1), **i32),
            pair_col=torch.as_tensor(jj.reshape(-1), **i32),
            pair_t0=torch.as_tensor(np.asarray(starts)[bb.reshape(-1)], **i32))

    def prepare_data(self, data):
        """A single (n, m, T) or (n, m, T, 1) tensor, as float32 on the
        model's device."""
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        y = np.asarray(data, dtype=np.float32)
        if y.ndim == 4 and y.shape[-1] == 1:
            y = y[..., 0]
        want = (self.nrows, self.ncols, self.ndepth)
        if y.shape != want:
            raise ValueError(f"data must be one {want} (or {want + (1,)}) "
                             f"tensor, got shape {y.shape}")
        return torch.as_tensor(y, device=self.device)

    # ------------------------------------------------------------------
    # W update: batched GASS over (chain, row)
    # ------------------------------------------------------------------
    def _update_W_gass(self, state, y, gen):
        nch, n, m, T, k = (self.nchains, self.nrows, self.ncols, self.ndepth,
                           self.nembeds)
        B = nch * n
        V = state["V"]
        # constraints from the opposite embedding, shared by the rows of a
        # chain up to the row's dim mask: A[(col, j), a] = sum_t CA[j, t]
        # V[col, t, a]
        A_base = torch.einsum("jt,cmta->cmja", self.Constraints_A, V).reshape(
            nch, m * self.nconstraints, k)
        c = self._c_rows.expand(B, -1)
        dmask = self._wmask.expand(nch, n, k).reshape(B, k)

        L, mu_all = self._w_proposal(V, state["sigma2"])
        v_all = sample_mvn_from_precision(gen, L, chol_factor=True)
        v_all = v_all.reshape(B, k) * dmask
        log_u, gumbel = draw_gass_noise(gen, B, self.gass_ngrid, self.device)

        def Af(Y):                           # (B, G, k) -> (B, G, m*J)
            G = Y.shape[1]
            Yc = (Y * dmask[:, None]).reshape(nch, n * G, k)
            return torch.einsum("cgk,cjk->cgj", Yc, A_base).reshape(B, G, -1)

        bt = V.reshape(nch, m * T, k)
        y2 = y.reshape(n, m * T)
        extras = tuple(e.reshape(n, m * T) for e in self._ep)
        cellfn = self.loglikelihood_cellfn

        def loglik(cands):                   # (B, G, k) -> (B, G)
            w = (cands * dmask[:, None]).contiguous()
            return fused_row_ll_batched(w, bt, y2, self._row_chain,
                                        self._row_idx, cellfn, extras)

        x_new, _ = gass(state["W"].reshape(B, k), loglik, Af, c, v=v_all,
                        log_u=log_u, gumbel=gumbel, dim_mask=dmask,
                        mu=None if mu_all is None else mu_all.reshape(B, k))
        return dict(state, W=x_new.reshape(nch, n, k) * self._wmask)

    def _w_proposal(self, V, sigma2):
        """The W rows' proposal Gaussian (constrained.py:428-450): the
        Cholesky factor L of its precision Q and its mean, (nch, n, k)
        (None without EP, where Q = I / sigma2). With EP, the GLS
        Gaussian: Q = sum_x Sinv2[i, x] V[x] V[x]^T on the row's active
        dims + I / sigma2, mean Q^-1 sum_x (Mu0 Sinv2)[i, x] V[x]."""
        nch, n, k = self.nchains, self.nrows, self.nembeds
        eye = torch.eye(k, device=self.device)
        prior = eye / sigma2[:, None, None, None]            # (nch, 1, k, k)
        if not self._ep:
            # sample_mvn_from_precision(**linalg_opts) in the JAX package:
            # the jitter ladder only under force_psd
            opts = self.linalg_opts
            return cholesky_psd(prior.expand(nch, n, k, k),
                                eps=opts["force_psd_eps"],
                                attempts=opts["force_psd_attempts"]
                                if opts["force_psd"] else 0), None
        mask = self._wmask
        Vf = V.reshape(nch, -1, k)
        s2 = self._ep_sinv2.reshape(n, -1)
        Q = (torch.einsum("ix,cxa,cxb->ciab", s2, Vf, Vf)
             * mask[:, :, None] * mask[:, None, :] + prior)
        mu_part = torch.einsum("ix,cxa->cia", self._ep_mu_sinv2.reshape(n, -1),
                               Vf) * mask
        L = self._chol(Q)
        return L, _cho_solve(L, mu_part)

    def _chol(self, Q):
        """cholesky_psd with the model's jitter ladder, whatever
        force_psd says, as the JAX package's EP proposal and V blocks
        (constrained.py:443, 673, 689, 901, 911)."""
        return cholesky_psd(Q, eps=self.linalg_opts["force_psd_eps"],
                            attempts=self.linalg_opts["force_psd_attempts"])

    # ------------------------------------------------------------------
    # V update: blocked GASS over (chain, column, block), one round per
    # phase (red-black colours, sequential blocks, or the joint block)
    # ------------------------------------------------------------------
    def _blocks_loglik(self, W, y, ph, cands):
        """Candidate log-likelihoods of every pair of phase ``ph``.
        W: (nch, n, k) masked; cands: (P, G, size, k). Returns (P, G)."""
        return fused_col_block_ll_batched(
            cands.contiguous(), W, y, ph.pair_chain, ph.pair_col, ph.pair_t0,
            self.loglikelihood_cellfn, self._ep)

    def _v_ep_terms(self, W):
        """The EP Gram and moment of every (column, t) given W
        (constrained.py:633-640): G (nch, m, T, k, k) and mu_part
        (nch, m, T, k); (None, None) without EP."""
        if not self._ep:
            return None, None
        G = torch.einsum("ijt,cia,cib->cjtab", self._ep_sinv2, W, W)
        mu_part = torch.einsum("ijt,cia->cjta", self._ep_mu_sinv2, W)
        return G, mu_part

    def _block_gaussian(self, DtLD, G, mu_part, X_out, tidx, z):
        """The conditional Gaussian of each block given the coordinates
        outside it (X_out, zero inside the blocks): its mean and a draw of
        its zero-mean part from the standard normal z, both (nch, m, nblk,
        size*k) in t-major packing. Without EP the precision is
        kron(I_k, DtLD_blk): one (size, size) factor with k right-hand
        sides. With EP it is the coupled ep_block_precision."""
        DtLD_blk = DtLD[:, :, tidx[:, :, None], tidx[:, None, :]]
        DtLD_rows = DtLD[:, :, tidx, :]                  # (nch,m,nblk,sz,T)
        rhs_tk = -torch.einsum("cmbts,cmsk->cmbtk", DtLD_rows, X_out)
        lead = rhs_tk.shape[:3]
        if G is not None:
            Qbb = ep_block_precision(DtLD_blk, G[:, :, tidx])
            rhs = (rhs_tk + mu_part[:, :, tidx]).reshape(lead + (-1,))
            d = torch.diagonal(Qbb, dim1=-2, dim2=-1)
            dinv = torch.rsqrt(torch.where(d > 0, d, torch.ones_like(d)))
            L = self._chol(Qbb * dinv[..., :, None] * dinv[..., None, :])
            mu_b = _cho_solve(L, rhs * dinv) * dinv
            v_b = _solve_lt(L, z.reshape(lead + (-1,))) * dinv
            return mu_b, v_b
        d = torch.diagonal(DtLD_blk, dim1=-2, dim2=-1)
        dinv = torch.rsqrt(torch.where(d > 0, d, torch.ones_like(d)))
        Qe = DtLD_blk * dinv[..., :, None] * dinv[..., None, :]
        L = self._chol(Qe)
        Lt = L.mT
        yv = torch.linalg.solve_triangular(L, rhs_tk * dinv[..., None],
                                           upper=False)
        mu_b = torch.linalg.solve_triangular(Lt, yv, upper=True) \
            * dinv[..., None]
        v_b = torch.linalg.solve_triangular(Lt, z, upper=True) \
            * dinv[..., None]
        return mu_b.reshape(lead + (-1,)), v_b.reshape(lead + (-1,))

    def _phase_update(self, X, W, DtLD, G, mu_part, y, ph, gen):
        nch, n, m, k = self.nchains, self.nrows, self.ncols, self.nembeds
        nblk, size = len(ph.starts), ph.size
        D = size * k
        B = nch * m * nblk
        X_out = X * ph.t_mask[:, None]
        tidx = ph.tidx

        z = torch.randn((nch, m, nblk, size, k), generator=gen,
                        device=self.device)
        mu_b, v_b = self._block_gaussian(DtLD, G, mu_part, X_out, tidx, z)
        mu_b, v_b = mu_b.reshape(B, D), v_b.reshape(B, D)

        # constraints restricted to each block; frozen coordinates fold
        # into the offsets
        tau_out = torch.einsum("cmtk,cnk->cmnt", X_out, W)
        frozen = torch.einsum("cmnt,bjt->cmbnj", tau_out, ph.CA_out)
        c_all = (ph.CC_pad[:, None, :] - frozen).reshape(B, -1)

        def A_op(Yb):                        # (B, G, D) -> (B, G, n*Jb)
            G = Yb.shape[1]
            Y6 = Yb.reshape(nch, m, nblk, G, size, k)
            M = torch.einsum("bjt,cmbgtk->cmbgjk", ph.CA_blk, Y6)
            return torch.einsum("cnk,cmbgjk->cmbgnj", W, M).reshape(B, G, -1)

        def loglik(cands):                   # (B, G, D) -> (B, G)
            G = cands.shape[1]
            return self._blocks_loglik(W, y, ph,
                                       cands.reshape(B, G, size, k))

        log_u, gumbel = draw_gass_noise(gen, B, self.gass_ngrid, self.device)
        Xb_cur = X[:, :, tidx, :].reshape(B, D)
        Xb_new, _ = gass(Xb_cur, loglik, A_op, c_all, v=v_b, log_u=log_u,
                         gumbel=gumbel, mu=mu_b)
        X = X.clone()
        X[:, :, tidx, :] = Xb_new.reshape(nch, m, nblk, size, k)
        return X

    def _update_V_gass(self, state, y, gen):
        W = (state["W"] * self._wmask).contiguous()
        DtLD = self._v_prior_dtld(state["lam2"], state["Tau2"])
        G, mu_part = self._v_ep_terms(W)
        X = state["V"]
        for ph in self._phases:
            X = self._phase_update(X, W, DtLD, G, mu_part, y, ph, gen)
        return dict(state, V=X)

    # ------------------------------------------------------------------
    # exact scale moves (ASIS re-draws of lam2 / sigma2, collapsed
    # global and per-factor W <-> V rebalance)
    # ------------------------------------------------------------------
    def _scale_bounds(self, vals, cs):
        """Feasible interval (s_lo, s_hi) of a global rescale tau -> s tau
        over the last axis: s*v >= c for every constraint value v."""
        ratio = cs / torch.where(vals == 0, 1.0, vals)
        s_lo = torch.where(vals > 0, ratio, -torch.inf).amax(-1)
        s_hi = torch.where(vals < 0, ratio, torch.inf).amin(-1)
        s_lo = torch.clamp(s_lo, min=1e-6) * (1.0 + 1e-6)
        s_hi = torch.clamp(s_hi, max=1e6) * (1.0 - 1e-6)
        return s_lo, s_hi

    def _interweave_scales(self, state, y, gen):
        """functionalmf_tpu/models/constrained.py:1020-1338, every chain
        at once (per-chain scalars are (nchains,) tensors)."""
        nch, k = self.nchains, self.nembeds
        dev = self.device
        W = state["W"] * self._wmask
        V = state["V"]
        tau = torch.einsum("cnk,cmtk->cnmt", W, V)
        zeros = torch.zeros(nch, device=dev)
        c4 = (slice(None), None, None, None)

        if self.sample_W and self.sample_V:
            inv_tau2 = 1.0 / torch.clamp(state["Tau2"], self.stability,
                                         1.0 / self.stability)
            deltas = self._deltas(V)                      # (nch, m, nD, k)
            dq = deltas * deltas * inv_tau2[..., None]
            Qbar = torch.clamp(dq.sum((1, 2, 3)), min=1e-20)
            W2 = (W * W).sum((1, 2))
            dW_free, dV_free = collapsed_scale_dims(
                self._w_len, self.ncols, self.ndepth, k)
            a_s, b_s = self.sigma2_a, self.sigma2_b
            inv_la = 1.0 / torch.clamp(state["lam2_a"], min=1e-20)
            inv_s2 = 1.0 / torch.clamp(state["sigma2"], min=1e-20)
            inv_l2 = 1.0 / torch.clamp(state["lam2"], min=1e-20)

            def w_term(x, W2_rest, w2):
                if self.sample_sigma2:
                    return -(a_s + dW_free / 2.0) * torch.log(
                        b_s + (W2_rest + torch.exp(-2.0 * x) * w2) / 2.0)
                return -0.5 * torch.exp(-2.0 * x) * w2 * inv_s2

            def v_term(x, Q_rest, q):
                if self.sample_lam2:
                    return -(0.5 + dV_free / 2.0) * torch.log(
                        inv_la + (Q_rest + torch.exp(2.0 * x) * q) / 2.0)
                return -0.5 * torch.exp(2.0 * x) * q * inv_l2

            def logdens_c(x):
                return ((dV_free - dW_free) * x + w_term(x, 0.0, W2)
                        + v_term(x, 0.0, Qbar))

            x_c, _ = shrink_slice_1d(zeros, logdens_c, -6.0, 6.0, gen)
            c_w, c_v = torch.exp(-x_c), torch.exp(x_c)
            W = W * c_w[c4[:3]]
            V = V * c_v[c4]
            state = dict(state, W=state["W"] * c_w[c4[:3]], V=V)
            Qbar_cur = torch.exp(2.0 * x_c) * Qbar

            if self.factor_rebalance and k > 1:
                w2k = (W * W).sum(1)                              # (nch, k)
                qk = torch.clamp(dq.sum((1, 2))
                                 * torch.exp(2.0 * x_c)[:, None], min=1e-20)
                dwk = self._wmask_np.sum(axis=0)
                dvk = float(self.ncols * self.ndepth)
                eye_k = torch.eye(k, device=dev)
                for kk in range(k):
                    W2_rest = w2k.sum(-1) - w2k[:, kk]
                    Q_rest = qk.sum(-1) - qk[:, kk]
                    w2_kk, q_kk = w2k[:, kk], qk[:, kk]
                    jac = float(dvk - float(dwk[kk]))

                    def logdens_f(x, W2_rest=W2_rest, Q_rest=Q_rest,
                                  w2_kk=w2_kk, q_kk=q_kk, jac=jac):
                        return (jac * x + w_term(x, W2_rest, w2_kk)
                                + v_term(x, Q_rest, q_kk))

                    x_f, _ = shrink_slice_1d(zeros, logdens_f, -6.0, 6.0, gen)
                    f_w, f_v = torch.exp(-x_f), torch.exp(x_f)
                    onehot = eye_k[kk]
                    fw_k = 1.0 + (f_w[:, None] - 1.0) * onehot    # (nch, k)
                    fv_k = 1.0 + (f_v[:, None] - 1.0) * onehot
                    W = W * fw_k[:, None, :]
                    V = V * fv_k[:, None, None, :]
                    w2k = w2k * fw_k * fw_k
                    qk = qk * fv_k * fv_k
                    state = dict(state, W=state["W"] * fw_k[:, None, :], V=V)
                Qbar_cur = qk.sum(-1)

            # redraw the collapsed scales at the new split
            if self.sample_sigma2:
                state = self._update_sigma2(state, gen)
            if self.sample_lam2:
                lam2_new, lam2_a_new = resample_lam2(
                    gen, Qbar_cur, state["lam2_a"], self.nD, self.ncols,
                    self.nembeds)
                state = dict(state, lam2=lam2_new, lam2_a=lam2_a_new)

        # all offsets 0: the feasible set is a cone, invariant under s > 0
        cone = bool((self._CC_np == 0.0).all())
        if cone:
            Av = cs_curve = None
        else:
            Av = torch.einsum("jt,cnmt->cnmj", self.Constraints_A,
                              tau).reshape(nch, -1)
            cs_curve = self.Constraints_C.repeat(
                self.nrows * self.ncols).expand(nch, -1)
        cellfn = self.loglikelihood_cellfn

        def full_ll(tau_s):
            return cellfn(y[None], tau_s).sum((1, 2, 3))

        if self.sample_lam2 and self.sample_V:
            x0 = torch.log(torch.clamp(state["lam2"], min=1e-20))
            if cone:
                lo_s, hi_s = x0 - 12.0, x0 + 12.0
            else:
                s_lo, s_hi = self._scale_bounds(Av, cs_curve)
                lo_s = torch.maximum(x0 + 2.0 * torch.log(s_lo), x0 - 12.0)
                hi_s = torch.minimum(x0 + 2.0 * torch.log(s_hi), x0 + 12.0)
            lo = torch.minimum(torch.clamp(lo_s, min=_LOG_LAM2_MIN), x0)
            hi = torch.maximum(hi_s, x0)
            inv_a = 1.0 / torch.clamp(state["lam2_a"], min=1e-20)

            def logdens(x):
                s = torch.exp(0.5 * (x - x0))
                return -0.5 * x - torch.exp(-x) * inv_a + full_ll(s[c4] * tau)

            x_new, _ = shrink_slice_1d(x0, logdens, lo, hi, gen)
            s = torch.exp(0.5 * (x_new - x0))
            V = V * s[c4]
            tau = tau * s[c4]
            if Av is not None:
                Av = Av * s[:, None]
            state = dict(state, lam2=torch.exp(x_new), V=V)

        if self.sample_sigma2 and self.sample_W:
            x0 = torch.log(torch.clamp(state["sigma2"], min=1e-20))
            if cone:
                lo, hi = x0 - 12.0, x0 + 12.0
            else:
                s_lo, s_hi = self._scale_bounds(Av, cs_curve)
                lo = torch.maximum(x0 + 2.0 * torch.log(s_lo), x0 - 12.0)
                hi = torch.minimum(x0 + 2.0 * torch.log(s_hi), x0 + 12.0)
            lo = torch.minimum(lo, x0)
            hi = torch.maximum(hi, x0)
            a, b = self.sigma2_a, self.sigma2_b

            def logdens(x):
                s = torch.exp(0.5 * (x - x0))
                return -a * x - b * torch.exp(-x) + full_ll(s[c4] * tau)

            x_new, _ = shrink_slice_1d(x0, logdens, lo, hi, gen)
            s = torch.exp(0.5 * (x_new - x0))
            state = dict(state, sigma2=torch.exp(x_new),
                         W=state["W"] * s[c4[:3]])
        return state

    # ------------------------------------------------------------------
    def _make_sweep(self):
        rW, rV = self.gass_w_repeats, self.gass_v_repeats

        def update_W(state, y, gen):
            for _ in range(rW):
                state = self._update_W_gass(state, y, gen)
            return state

        def update_V(state, y, gen):
            for _ in range(rV):
                state = self._update_V_gass(state, y, gen)
            return state

        def sweep(state, y, gen):
            state = self._prior_sweep(state, y, gen, update_W, update_V)
            if self.interweave:
                state = self._interweave_scales(state, y, gen)
            return state
        return sweep

    # ------------------------------------------------------------------
    def logprob(self, data, **params):
        W = torch.as_tensor(np.asarray(params.get("W", self.W), np.float32),
                            device=self.device)
        V = torch.as_tensor(np.asarray(params.get("V", self.V), np.float32),
                            device=self.device)
        tau = torch.einsum("nk,mtk->nmt", W, V)
        return float(self.loglikelihood(self.prepare_data(data), tau, W, V,
                                        row=None, col=None))

    def check_constraints(self, atol=1e-5):
        """Every curve constraint A tau >= c holds, across all chains."""
        return self._worst_constraint_slack() >= -atol

    def _worst_constraint_slack(self):
        """min over chains, cells and constraints of A tau - c."""
        W = np.asarray(self.W)
        V = np.asarray(self.V)
        if W.ndim == 2:
            W, V = W[None], V[None]
        tau = np.einsum("cnk,cmtk->cnmt", W, V)
        vals = np.einsum("jt,cnmt->cnmj", self._CA_np, tau)
        return float((vals - self._CC_np).min())

    def run_gibbs(self, data, *args, **kwargs):
        """Refuse to sample from an infeasible start: GASS is a valid
        kernel only from a feasible point."""
        worst = self._worst_constraint_slack()
        if worst < -1e-5:
            raise ValueError(
                "Initial state violates the constraints (worst margin "
                f"A@tau - c = {worst:.3e}). GASS requires a feasible "
                "starting point. Pass feasible W_init/V_init, e.g. a "
                "nonnegative warm start.")
        return super().run_gibbs(data, *args, **kwargs)
