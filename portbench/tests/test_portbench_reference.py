"""The plain reference against its formulas."""
import math

import numpy as np
import pytest
import torch
from scipy import stats
from scipy.special import logsumexp

from portbench.reference import (checks, gamma_mixture, gass_step, poisson,
                                 scale_moves)


def test_poisson_cells_and_items():
    y = torch.tensor([3.0, float("nan"), 0.0, 7.0], dtype=torch.float64)
    tau = torch.tensor([2.0, 5.0, 0.5, -1.0], dtype=torch.float64)
    want = [3 * math.log(2) - 2, 0.0, -0.5, 7 * math.log(1e-8) - 1e-8]
    assert poisson.cell_terms(y, tau).tolist() == pytest.approx(want)
    g = torch.Generator().manual_seed(0)
    cands = torch.rand((2, 3, 2), generator=g)
    bt = torch.rand((2, 4, 2), generator=g)
    yy = torch.tensor([[1.0, 2.0, float("nan"), 0.0], [4.0, 1.0, 1.0, 2.0]])
    ll, scale = poisson.row_ll(cands, bt, yy)
    for s in range(2):
        for gg in range(3):
            tot = 0.0
            for c in range(4):
                if math.isnan(yy[s, c]):
                    continue
                r = float(cands[s, gg].double() @ bt[s, c].double())
                tot += float(yy[s, c]) * math.log(r) - r
            assert ll[s, gg].item() == pytest.approx(tot, rel=1e-12)
    assert (scale >= ll.abs()).all()


def test_poisson_column_block_matches_row_form():
    g = torch.Generator().manual_seed(1)
    cands = torch.rand((2, 3, 4, 2), generator=g)
    w = torch.rand((2, 5, 2), generator=g)
    yb = torch.poisson(torch.full((2, 4, 5), 3.0), generator=g)
    yb[0, 3] = float("nan")                       # outside [0, T)
    mu = torch.rand((2, 4, 5), generator=g) + 0.5
    sig = torch.rand((2, 4, 5), generator=g) + 0.5
    ll, _ = poisson.col_ll(cands, w, yb, (mu, sig))
    tau = torch.einsum("sgtk,snk->sgtn", cands.double(), w.double())
    ep = stats.norm.logpdf(tau.numpy(), mu[:, None].double().numpy(),
                           sig[:, None].double().numpy())
    y = yb[:, None].double().numpy()
    cell = np.where(np.isnan(y), 0.0, np.nan_to_num(y) * np.log(tau.numpy())
                    - tau.numpy())
    assert ll.numpy() == pytest.approx((cell - ep).sum((2, 3)), rel=1e-12)


def test_gamma_mixture_against_scipy():
    grid = np.array([0.8, 1.0, 1.3])
    probs = np.array([0.2, 0.5, 0.3])
    var = 0.01
    mix = gamma_mixture.Mixture(grid, probs, var, device="cpu")
    y = torch.tensor([[0.9, 1.1, float("nan")], [0.5, 0.45, 0.55]],
                     dtype=torch.float64)
    e = torch.tensor([1.0, 0.5], dtype=torch.float64)
    got = mix.cell_logpdf(y, e).numpy()
    for i in range(2):
        yi = y[i][~torch.isnan(y[i])].numpy()
        comps = [math.log(p) + stats.gamma.logpdf(
            yi, a=m ** 2 / var, scale=var / m * float(e[i])).sum()
            for m, p in zip(grid, probs)]
        assert got[i] == pytest.approx(logsumexp(comps), rel=1e-10)


def test_gamma_items_sum_cells_less_ep():
    grid, probs, var = np.array([0.9, 1.1]), np.array([0.5, 0.5]), 0.02
    mix = gamma_mixture.Mixture(grid, probs, var, device="cpu")
    g = torch.Generator().manual_seed(2)
    S, G, m, T, R, k = 2, 3, 2, 4, 3, 2
    cands = torch.rand((S, G, k), generator=g)
    V = torch.rand((S, m, T, k), generator=g) * 0.5
    y = torch.rand((S, m, T, R), generator=g, dtype=torch.float64) + 0.2
    mu = torch.rand((S, m, T), dtype=torch.float64, generator=g)
    sig = torch.full((S, m, T), 0.3, dtype=torch.float64)
    ll, _ = gamma_mixture.w_items_ll(mix, cands, V, y, (mu, sig))
    tau = torch.einsum("sgk,smtk->sgmt", cands.double(), V.double())
    cell = mix.cell_logpdf(y[:, None], tau)
    ep = torch.tensor(stats.norm.logpdf(tau.numpy(), mu[:, None].numpy(),
                                        sig[:, None].numpy()))
    assert ll.numpy() == pytest.approx((cell - ep).sum((2, 3)).numpy(),
                                       rel=1e-12)
    # the V form rebuilds the curve around the block
    X = torch.rand((S, T, k), generator=g)
    W = torch.rand((S, m, k), generator=g)
    cb = torch.rand((S, G, 2, k), generator=g)
    llv, _ = gamma_mixture.v_items_ll(mix, cb, X, 1, W, y, (mu, sig))
    Vg = X[:, None].repeat(1, G, 1, 1).double()
    Vg[:, :, 1:3] = cb.double()
    tau = torch.einsum("sgtk,snk->sgnt", Vg, W.double())
    cell = mix.cell_logpdf(y[:, None], tau)
    ep = torch.tensor(stats.norm.logpdf(tau.numpy(), mu[:, None].numpy(),
                                        sig[:, None].numpy()))
    assert llv.numpy() == pytest.approx((cell - ep).sum((2, 3)).numpy(),
                                        rel=1e-12)


def test_draw_checks():
    W = np.ones((6, 2, 1))
    V = np.ones((6, 3, 4, 1))
    V[4, 0, 2, 0] = -0.25
    A, c = np.eye(4), np.zeros(4)
    assert checks.constraint_violation(W, V, A, c) == pytest.approx(0.25)
    V[5, 0, 0, 0] = np.nan
    assert checks.constraint_violation(W, V, A, c) == float("inf")
    g = checks.item_gaps(torch.tensor([[1.0, float("nan")]]),
                         torch.tensor([[1.5, 0.0]], dtype=torch.float64),
                         torch.tensor([[4.0, 1.0]], dtype=torch.float64))
    assert g.tolist() == [float("inf")]
    x = torch.tensor([1 + 2.0 ** -12, 1 + 2.0 ** -10, -3 - 2.0 ** -11])
    assert checks.tf32(x).tolist() == [1.0, 1 + 2.0 ** -10, -3.0]
    assert checks.bf16(x).tolist() == [1.0, 1.0, -3.0]


def _ellipse(S=4, G=9, D=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    x, v, mu = (torch.randn((S, D), generator=g, dtype=torch.float64)
                for _ in range(3))
    lo = -torch.rand(S, generator=g, dtype=torch.float64)
    hi = torch.rand(S, generator=g, dtype=torch.float64)
    th = lo[:, None] + (hi - lo)[:, None] * torch.linspace(
        0, 1, G, dtype=torch.float64)
    pts = ((x - mu)[:, None] * torch.cos(th)[..., None]
           + v[:, None] * torch.sin(th)[..., None] + mu[:, None])
    return x, v, mu, pts, hi - lo


def test_gass_step_ellipse_gaps():
    x, v, mu, pts, span = _ellipse()
    gap, got_span, ok = gass_step.ellipse_gaps(x, v, mu, None, pts)
    assert ok.all() and float(gap.max()) < 1e-12
    assert torch.allclose(got_span, span)
    bent = pts.clone()
    bent[1, 4] += 1e-3 * bent[1, 4].norm()
    assert float(gass_step.ellipse_gaps(x, v, mu, None, bent)[0][1]) > 1e-4
    low = gass_step.lowp_candidates(x.float(), v.float(), mu.float(), None,
                                    pts, checks.bf16)
    assert float(gass_step.ellipse_gaps(x, v, mu, None, low)[0].max()) > 1e-4


def test_gass_step_moves():
    """Candidates 0 and 2 lie above the slice; 2 has the larger score."""
    x, v, mu, pts, span = _ellipse(S=1, G=3)
    ll = torch.tensor([[1.0, -5.0, 2.0, 0.0]], dtype=torch.float64)
    tie = torch.zeros_like(ll)
    log_u = torch.tensor([-0.5], dtype=torch.float64)
    gumbel = torch.tensor([[0.3, 9.0, 1.0]], dtype=torch.float64)
    margin = torch.ones((1, 3), dtype=torch.float64) * 5
    cands = torch.cat([pts, x[:, None]], 1)

    def bad(x_new, ll=ll, tie=tie, margin=margin):
        return bool(gass_step.unexplained_moves(
            ll, tie, margin, torch.ones_like(margin), span, log_u, gumbel,
            x, cands, x_new)[0])

    assert not bad(pts[:, 2])
    assert bad(pts[:, 0]) and bad(pts[:, 1]) and bad(x)
    # candidate 2 out of the constraints: 0 is the move
    out = margin.clone()
    out[0, 2] = -5
    assert not bad(pts[:, 0], margin=out) and bad(pts[:, 2], margin=out)
    # candidate 2 within rounding of the slice: either may be the move
    near = ll.clone()
    near[0, 2] = -0.5 + 1e-9
    assert not bad(pts[:, 2], ll=near, tie=tie + 1e-6)
    assert not bad(pts[:, 0], ll=near, tie=tie + 1e-6)


def test_tf_penalty_is_the_anchored_difference_operators():
    P = scale_moves.tf_penalty(6, 2)
    D = np.diff(np.eye(6), axis=0)
    assert np.array_equal(P, np.concatenate(
        [np.eye(1, 6), D, D.T @ D, D @ D.T @ D]))
    assert scale_moves.packed_w_len(19, 5) == 85


def _slice_call(x0, logdens, lo, hi, e, u):
    """A shrinking slice move as the port runs it, in float32."""
    y = logdens(x0) - e
    L, R, xs, lds = lo.clone(), hi.clone(), [x0], [logdens(x0)]
    ok = torch.zeros_like(x0, dtype=torch.bool)
    for i in range(u.shape[0]):
        xp = L + (R - L) * u[i]
        ld = logdens(xp)
        xs.append(xp)
        lds.append(ld)
        ok = ld >= y
        left = xp < x0
        L = torch.where(ok | left, xp, L)
        R = torch.where(ok | ~left, xp, R)
    return dict(x0=x0, lo=lo, hi=hi, e=e, u=u, xs=torch.stack(xs),
                lds=torch.stack(lds), x_new=torch.where(ok, xs[-1], x0))


def test_slice_judge():
    g = torch.Generator().manual_seed(3)
    S = 64
    x0 = torch.zeros(S)
    lo, hi = torch.full((S,), -6.0), torch.full((S,), 6.0)
    e = torch.empty(S).exponential_(generator=g)
    u = torch.rand((16, S), generator=g)

    def dens(x):
        t = (-0.5 * x * x, 2.0 * x)
        return sum(t), sum(v.abs() for v in t)

    call = _slice_call(x0, lambda x: dens(x)[0], lo, hi, e, u)
    j = scale_moves.Judge()
    j.slice_move(call, dens, x0.double(), lo.double(), hi.double())
    assert j.wrong == 0 and j.scale_gap < 1e-6 and j.state_gap < 1e-6
    for wrong in (lambda x: dens(x)[0] + x,       # the move's own fault
                  lambda x: dens(x)[0] - 3.0):    # its densities' fault
        call = _slice_call(x0, wrong, lo, hi, e, u)
        j = scale_moves.Judge()
        j.slice_move(call, dens, x0.double(), lo.double(), hi.double())
        assert j.wrong > 0 or j.scale_gap > 1e-3
