"""Plain reference of one GASS step (generalised analytic slice sampling,
the grid method), to judge a step the program took.

A step of an item moves its point x on the ellipse
``x(theta) = (x - mu) cos(theta) + v sin(theta) + mu`` through x, with the
proposal draw v and the centre mu: it lays ``G`` evenly spaced angles over
the feasible arc, keeps the candidates that meet the constraints and lie
above the slice ``ll(x) + log_u``, and moves to the one of them with the
largest Gumbel score (it stays where there is none).

Given what the program was handed (x, v, mu, log_u, the Gumbel scores),
the candidates it evaluated and where it went, the reference

* fits each candidate to the ellipse (two coordinates by least squares in
  float64) and reads how far the candidates lie off it and off an evenly
  spaced grid of angles (``ellipse_gaps``);
* decides the step itself, from its own log-likelihoods and constraint
  values, and says whether the program's move agrees, where a candidate's
  standing within rounding of the slice or of a constraint may go either
  way (``unexplained_moves``).

Plain torch; nothing of the program is imported.
"""
import math

import torch

F64 = torch.float64


def _end_angles(B, gram, rel):
    """The angles of the first and last of the candidates ``rel`` (S, G,
    D, less the centre) on the ellipse of basis B (S, D, 2): each fitted by
    least squares, the sequence unwrapped step by step. (S, 2)."""
    ab = torch.linalg.solve(gram, B.mT @ rel.mT)         # (S, 2, G)
    th = torch.atan2(ab[:, 1], ab[:, 0])
    d = torch.remainder(torch.diff(th, dim=-1) + math.pi,
                        2 * math.pi) - math.pi
    return torch.stack([th[:, 0], th[:, 0] + d.sum(-1)], -1)


def ellipse_gaps(x, v, mu, mask, pts):
    """Each item's widest departure of its candidates from the ellipse at
    evenly spaced angles; x, v, mu, mask (S, D) (mu, mask may be None),
    pts (S, G, D). The first and last candidates' angles are fitted (two
    coordinates by least squares, in float64); each candidate is compared
    with the ellipse's point at its place on the grid between them.
    Returns (gap (S,), span (S,), solvable (S,)): gap the largest distance
    over the sum of the norms of x - mu, v and mu; span the arc's length
    (negative: an empty arc); solvable False where x - mu and v are all
    but parallel, whose candidates have no angle of their own to float32's
    rounding (gap 0, span 0)."""
    x, v, pts = x.to(F64), v.to(F64), pts.to(F64)
    mu = torch.zeros_like(x) if mu is None else mu.to(F64)
    if mask is not None:
        v = v * mask.to(F64)
    x0 = x - mu
    B = torch.stack([x0, v], -1)                        # (S, D, 2)
    gram = B.mT @ B                                      # (S, 2, 2)
    det = gram[:, 0, 0] * gram[:, 1, 1] - gram[:, 0, 1] ** 2
    # the angles of an ellipse whose axes are all but parallel are not
    # determined to float32's rounding: such an item (sin < 0.1 between x
    # - mu and v, or one active coordinate) is left out
    solvable = det > 1e-2 * gram[:, 0, 0] * gram[:, 1, 1]
    eye = torch.eye(2, dtype=F64, device=x.device)
    g_safe = torch.where(solvable[:, None, None], gram, eye)
    th = _end_angles(B, g_safe, pts.to(F64) - mu[:, None])
    G = pts.shape[1]
    lin = torch.arange(G, dtype=F64, device=x.device) / max(G - 1, 1)
    grid = th[:, :1] + (th[:, 1:] - th[:, :1]) * lin     # (S, G)
    want = (x0[:, None] * torch.cos(grid)[..., None]
            + v[:, None] * torch.sin(grid)[..., None] + mu[:, None])
    if mask is not None:
        want = want * mask.to(F64)[:, None]
    size = (x0.norm(dim=-1) + v.norm(dim=-1) + mu.norm(dim=-1))[:, None]
    gap = ((pts - want).norm(dim=-1)
           / torch.clamp(size, min=1e-30)).amax(-1)
    zero = torch.zeros_like(gap)
    return (torch.where(solvable, gap, zero),
            torch.where(solvable, th[:, 1] - th[:, 0], zero), solvable)


def lowp_candidates(x, v, mu, mask, pts, lowp):
    """The control's candidates: the ellipse's points on the grid of
    angles that the program's first and last candidates span, computed
    from x, v, mu and the angles' cosines and sines rounded by ``lowp`` (a
    function of a float32 tensor), in float32."""
    x, v = x.float(), v.float()
    mu = torch.zeros_like(x) if mu is None else mu.float()
    if mask is not None:
        v = v * mask.float()
    B = torch.stack([x - mu, v], -1).to(F64)
    gram = B.mT @ B
    eye = torch.eye(2, dtype=F64, device=x.device)
    g_safe = torch.where((torch.linalg.det(gram) > 0)[:, None, None], gram,
                         eye)
    th = _end_angles(B, g_safe, pts.to(F64) - mu[:, None].to(F64)).float()
    G = pts.shape[1]
    lin = torch.arange(G, dtype=torch.float32, device=x.device) / max(
        G - 1, 1)
    grid = th[:, :1] + (th[:, 1:] - th[:, :1]) * lin
    c, s = lowp(torch.cos(grid)), lowp(torch.sin(grid))
    out = (lowp(x - mu)[:, None] * c[..., None]
           + lowp(v)[:, None] * s[..., None] + lowp(mu)[:, None])
    if mask is not None:
        out = out * mask.float()[:, None]
    return out


def unexplained_moves(ll_ref, tol, feas_margin, feas_tol, span, log_u,
                      gumbel, x, cands, x_new):
    """Per item, True where the program's move is not one the reference
    could have made.

    ll_ref, tol (S, G + 1): the reference's log-likelihood of each
    candidate and of x (last), and the width within which its comparison
    with the slice may go either way (:func:`tie_widths`); feas_margin,
    feas_tol (S, G): each candidate's smallest constraint slack and the
    rounding it may carry;
    span (S,): the fitted arc's length (an empty arc keeps every
    candidate out); log_u (S,), gumbel (S, G); x (S, D), cands (S, G, D)
    the candidates evaluated, x_new (S, D) where the program went."""
    G = gumbel.shape[-1]
    h = ll_ref[:, G] + log_u.to(F64)
    ll = ll_ref[:, :G]
    htol = tol[:, :G] + tol[:, G:]
    above = ll >= h[:, None]
    above_tie = (ll - h[:, None]).abs() <= htol
    feas = feas_margin >= 0
    feas_tie = feas_margin.abs() <= feas_tol
    arc = (span >= 0)[:, None]
    ok = above & feas & arc & torch.isfinite(ll)
    may = (above | above_tie) & (feas | feas_tie) & arc & torch.isfinite(ll)
    must = ok & ~above_tie & ~feas_tie
    # where the program went: a candidate (any that equals x_new) or x
    hit = (cands[:, :G] == x_new[:, None]).all(-1)                 # (S, G)
    stay = (x_new == x).all(-1)
    gum = gumbel.to(F64)
    # a candidate p is a possible move if the reference may take it and
    # every candidate with a larger score is one it may leave out
    beats = gum[:, None, :] > gum[:, :, None]                      # (S, p, g)
    blocked = (beats & must[:, None, :]).any(-1)                   # (S, p)
    cand_ok = (hit & may & ~blocked).any(-1)
    stay_ok = stay & ~must.any(-1)
    return ~(cand_ok | stay_ok)


FEAS_RTOL = 1e-6      # a constraint value's rounding, of its magnitudes
TIE_RTOL = 2.4e-7     # float32's rounding of a sum (2 eps), of its size


def tie_widths(prog, ref):
    """How far from the slice a candidate's comparison may go either way:
    twice the program's own rounding of the answer (|prog - ref|) and a
    float32 rounding of the comparison's sum. (S, G + 1) float64."""
    ref = ref.to(F64)
    d = (prog.to(F64) - ref).abs()
    d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    return 2.0 * d + TIE_RTOL * (ref.abs() + 1.0)


def margins_w(cands, V, A, c):
    """W rows' candidates (S, G, k) against the constraints of every
    column's curve, tau = w V_j^T, A tau >= c; V (m, T, k), A (J, T), c
    (J,). Returns (S, G): the smallest constraint value over its
    rounding (FEAS_RTOL of the magnitudes of its terms): below -1 out,
    above 1 in, between within rounding."""
    f = dict(dtype=F64)
    cands, V, A, c = (t.to(**f) for t in (cands, V, A, c))
    tau = torch.einsum("sgk,mtk->sgmt", cands, V)
    mag = torch.einsum("sgk,mtk->sgmt", cands.abs(), V.abs())
    val = torch.einsum("jt,sgmt->sgmj", A, tau) - c
    tol = FEAS_RTOL * (torch.einsum("jt,sgmt->sgmj", A.abs(), mag)
                       + c.abs()) + 1e-30
    return (val / tol).amin((-2, -1))


def margins_v(cands, Wm, V, starts, size, A, c):
    """V blocks' candidates (S, G, size * k) of the items of one chain's
    round, ordered (column, block), against the constraints that touch
    each block, the rest of the column's curve as V (m, T, k) holds it;
    Wm (n, k) the chain's masked W. Returns (S, G) as :func:`margins_w`."""
    f = dict(dtype=F64)
    cands, Wm, V, A, c = (t.to(**f) for t in (cands, Wm, V, A, c))
    S, G = cands.shape[:2]
    m, T, k = V.shape
    nblk = len(starts)
    cands = cands.reshape(m, nblk, G, size, k)
    out = torch.empty((m, nblk, G), dtype=F64, device=cands.device)
    for b, t0 in enumerate(starts):
        blk = torch.zeros(T, dtype=torch.bool, device=A.device)
        blk[t0:t0 + size] = True
        rel = (A[:, blk] != 0).any(1)
        cols = (A[rel] != 0).any(0) | blk
        curve = V[:, None].expand(m, G, T, k).clone()
        curve[:, :, t0:t0 + size] = cands[:, b]
        curve = curve[:, :, cols]
        Ab = A[rel][:, cols]
        tau = torch.einsum("nk,mgtk->mgnt", Wm, curve)
        mag = torch.einsum("nk,mgtk->mgnt", Wm.abs(), curve.abs())
        val = torch.einsum("jt,mgnt->mgnj", Ab, tau) - c[rel]
        tol = FEAS_RTOL * (torch.einsum("jt,mgnt->mgnj", Ab.abs(), mag)
                           + c[rel].abs()) + 1e-30
        out[:, b] = (val / tol).amin((-2, -1))
    return out.reshape(S, G)
