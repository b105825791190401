"""The port's negative-binomial sweep held to the benchmark's plain
reference (``portbench/reference/negbinom.py``: float64, nothing of the
program), step by step under injected noise, at 6x5x24, k=3, 4 chains:
the Metropolis moves on R, the Polya-Gamma draw, the W draw and the V
draw. Also: the sweep's phases of the run record tile it, and the draws do
not depend on the record."""
import math

import numpy as np
import pytest
import torch

from functionalmf_tpu_torch import NegativeBinomialBayesianTensorFiltering
from functionalmf_tpu_torch.ops.gamma import draw_gamma_mt_noise
from functionalmf_tpu_torch.ops.polyagamma import polya_gamma
from portbench.reference import negbinom as ref
from portbench.reference.scale_moves import tf_penalty

N, M, T, K, C = 6, 5, 24, 3, 4
EPS32 = float(np.finfo(np.float32).eps)
KW = dict(nembeds=K, tf_order=2, sigma2_init=0.5, lam2_init=0.1, nu2_init=1,
          rdims=(0, 1, 2), nchains=C, device="cpu")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    W = np.abs(rng.normal(1, 0.3, (N, K)))
    V = np.abs(rng.normal(1, 0.3, (M, T, K)))
    Y = rng.poisson(np.einsum("nk,mtk->nmt", W, V)).astype(float)
    Y[rng.random((N, M)) < 0.2] = np.nan
    Y[0, 0, :3] = [60.0, 80.0, 0.0]          # the normal branch and b = R
    return Y


def _model(seed=7):
    return NegativeBinomialBayesianTensorFiltering(N, M, T, seed=seed, **KW)


def _y4(Y):
    return torch.as_tensor(Y, dtype=torch.float64)[..., None]


def test_r_moves_match_the_reference():
    """Each move from the program's R before it: the program's sum of the
    likelihood ratio within 16 float32 eps of the sum of its terms'
    magnitudes (lgamma's and the sum's rounding), and every decision,
    taken from that sum, outside the rounding of its comparison is the
    reference's; an accepted move leaves exp(log R + z s) to within its
    rounding."""
    from functionalmf_tpu_torch.models import negbinom
    Y = _data()
    model = _model()
    pd = model.prepare_data(Y)
    st = dict(model._state)
    st["W"] = st["W"] * 0.3                  # P away from 0 and 1
    st["R"] = st["R"] + 1.0
    z, u = model.draw_R_noise(torch.Generator().manual_seed(11))
    sums, ws0 = [], negbinom._window_sum

    def window_sum(x, dims):
        out = ws0(x, dims)
        sums.append(out.reshape(st["R"].shape))
        return out
    negbinom._window_sum = window_sum
    try:
        full = model._update_R(st, pd, None, noise=(z, u))["R"]
    finally:
        negbinom._window_sum = ws0
    al = torch.stack(sums)
    path = []
    for i in range(model.nmetropolis + 1):
        ui = u.clone()
        ui[i:] = math.inf                    # the later moves reject
        path.append(model._update_R(st, pd, None, noise=(z, ui))["R"])
    path = torch.stack(path)
    torch.testing.assert_close(path[-1], full, rtol=0, atol=0)
    moved_any = ties = 0
    for c in range(C):
        got = ref.r_moves(
            _y4(Y), path[:, c], z[:, c], u[:, c],
            ref.log1m_sigmoid(st["W"][c], st["V"][c]), al_prog=al[:, c],
            rpropstdev=model.rpropstdev, rstdev=model.rstdev,
            clip=model.accept_clip, r_min=model.r_min)
        assert ((al[:, c].double() - got["al"]).abs()
                <= 16 * EPS32 * got["mag"]).all()
        moved = path[1:, c] != path[:-1, c]
        assert not ((moved != got["accept"]) & ~got["tie"]).any()
        assert got["ok"].all()
        moved_any += int(moved.sum())
        ties += int(got["tie"].sum())
    assert 0 < moved_any < C * model.nmetropolis     # both decisions seen
    assert ties == 0


def test_pg_draw_matches_the_reference():
    """omega from the program's noise: within 64 float32 eps of the sum
    of its terms' magnitudes (the 16-term sum in float32, the tail mean's
    cancellation against it, Marsaglia-Tsang's cube and logs), both
    branches and b = 0."""
    Y = _data()
    model = _model()
    R = torch.full((1, 1, 1), 2.5)
    b, _ = ref.nb_counts(_y4(Y), R.double())
    b = b.float()
    c = torch.as_tensor(np.random.default_rng(1).normal(0, 2, b.shape),
                        dtype=torch.float32)
    c[0, 0, 3] = 0.0                                    # psi = 0
    gen = torch.Generator().manual_seed(3)
    noise = draw_gamma_mt_noise(gen, (16,) + tuple(b.shape))
    zn = torch.randn(b.shape, generator=gen)
    got = polya_gamma(None, b, c, num_terms=model.pg_num_terms, z=zn,
                      gamma_noise=noise)
    x, u, ub = (t.reshape(t.shape[:-3] + (-1,)) for t in noise)
    want, scale, amb = ref.pg_draw(b.reshape(-1), c.reshape(-1), x, u, ub,
                                   zn.reshape(-1), num_terms=16)
    gap = (got.reshape(-1).double() - want).abs() / scale.clamp_min(1e-300)
    assert gap[~amb].max() <= 64 * EPS32
    assert int(amb.sum()) <= 2
    big = b.reshape(-1) >= 50
    assert big.any() and (b == 0).any()
    assert (got.reshape(-1)[b.reshape(-1) == 0] == 0).all()


def _pg_weights(model, Y, R):
    """A chain-batched (omega, kappa) of the NB reduction at R."""
    b, kappa = ref.nb_counts(_y4(Y), R.double())
    psi = torch.einsum("cik,cjtk->cijt", model._state["W"].double(),
                       model._state["V"].double())
    omega = ref.pg_mean(b, psi)                  # any positive weights
    return omega.float(), kappa.float().expand_as(omega).contiguous()


def test_w_draw_matches_the_reference():
    """Each row's k x k posterior and its draw from the program's normals:
    the precision within 8 eps of its terms' magnitudes, the draw within
    64 eps of |noise part| + |mean part| (a well-conditioned k x k
    system, factored in float32)."""
    Y = _data()
    model = _model()
    w8, wy = _pg_weights(model, Y, torch.full((1, 1, 1), 2.0))
    st = model._state
    z = torch.randn((C, N, K), generator=torch.Generator().manual_seed(5))
    got = model._gaussian_update_W(st, w8, wy, None, z=z)["W"]
    wmask = torch.as_tensor(np.tril(np.ones((N, K))), dtype=torch.float64)
    for c in range(C):
        want, _, _, scale = ref.w_draw(w8[c], wy[c], st["V"][c],
                                       st["sigma2"][c], wmask, z[c])
        assert ref.rel_gap(got[c], want, scale, (-1,)).max() <= 64 * EPS32


def test_v_draw_matches_the_reference():
    """Each column's posterior as one dense (T k, T k) system, drawn from
    Q + 1e-4 diag(Q) with the program's normals. The program factors the
    equilibrated system in float32, whose error grows with its condition
    number: the draw is held to 1 eps x that number of |noise part| +
    |mean part|, and the bands to 8 eps of their terms' magnitudes. At
    this size the jitter keeps the number under 4.0e4 (model seeds 7-30),
    so the draw's limit is at most 4.8e-3; the draws read at most 0.148
    eps x the number there (5.6e-4), and a draw from other normals reads
    about 1."""
    from functionalmf_tpu_torch.models import gaussian
    Y = _data()
    model = _model()
    w8, wy = _pg_weights(model, Y, torch.full((1, 1, 1), 2.0))
    st = model._state
    z = torch.randn((C, M, T, K), generator=torch.Generator().manual_seed(6))
    kept = {}
    v0 = gaussian.sample_mvn_block_banded_retiled

    def banded(gen, bands, **kw):
        kept["bands"] = bands
        return v0(gen, bands, **kw)
    gaussian.sample_mvn_block_banded_retiled = banded
    try:
        got = model._gaussian_update_V(st, w8, wy, None, z=z)["V"]
    finally:
        gaussian.sample_mvn_block_banded_retiled = v0
    Delta = torch.as_tensor(tf_penalty(T, 2))
    for c in range(C):
        want, Q, Qmag, scale = ref.v_draw(
            w8[c], wy[c], st["W"][c] * torch.as_tensor(
                np.tril(np.ones((N, K))), dtype=torch.float32),
            st["lam2"][c], st["Tau2"][c], Delta, z[c], model.stability)
        assert ref.rel_gap(ref.bands_dense(kept["bands"][c].double()), Q,
                           Qmag, (-2, -1)).max() <= 8 * EPS32
        d = torch.diagonal(Q, dim1=-2, dim2=-1)
        Qe = Q / torch.sqrt(d[..., :, None] * d[..., None, :])
        Qe = Qe + ref.V_JITTER * torch.eye(T * K, dtype=Qe.dtype)
        cond = torch.linalg.cond(Qe)
        assert cond.max() <= 5e4
        gap = ref.rel_gap(got[c], want, scale, (-2, -1))
        assert (gap <= EPS32 * cond).all(), (gap, cond)


def test_negbinom_phases_tile_the_sweep_and_the_draws_ignore_the_record():
    Y = _data()
    on, off = _model(), _model()
    off.trace_runs = False
    run = dict(nburn=2, nthin=1, nsamples=2, verbose=False)
    a, b = on.run_gibbs(Y, **run), off.run_gibbs(Y, **run)
    for key in ("W", "V", "R", "nu2", "sigma2", "lam2", "Tau2"):
        np.testing.assert_array_equal(a[key], b[key])
    ms = on.last_run["stream_ms"]
    phases = ("r_moves", "pg_draw", "prior", "w_update", "v_update", "hook")
    assert set(phases) | {"sweep", "v_bands", "banded_sample"} == set(ms)
    assert sum(ms[p] for p in phases) == pytest.approx(ms["sweep"],
                                                       rel=1e-9)
    assert ms["v_bands"] + ms["banded_sample"] <= ms["v_update"]
