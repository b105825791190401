"""Plain reference of the negative-binomial BTF sweep's conjugate steps
(Tansey, Tosh & Blei 2021, factor.py:463-563, the binomial reduction
factor.py:425-460 and the Gaussian updates factor.py:313-409): the
Metropolis moves on the dispersion R, the Polya-Gamma draw of omega, the
W rows' and the V columns' Gaussian posteriors and their draws.

Each function takes one chain's state as the program left it before the
step and the program's own noise, and works out in float64 what the step
should give:

* ``r_moves``: each random-walk move on log R from the program's R before
  it (factor.py:513-554): the proposal log R + z s, the log-normal prior
  ratio, the likelihood ratio summed over the cells R is shared by (with
  the sum of its terms' magnitudes, what bounds its rounding), the clip of
  the log ratio to [-10, 1] (factor.py:542), the R > 1 gate
  (factor.py:547) and the decision u <= exp(clipped ratio), taken from the
  program's own sums of the ratio where they are given (the caller holds
  those to the reference's); a decision within the rounding of its
  comparison counts neither way.
* ``pg_draw``: omega ~ PG(b, c) from the program's noise: for each of the
  ``num_terms`` terms a Gamma(b, 1) draw by fixed-round Marsaglia-Tsang
  (the program's normals and uniforms, the mean where no round accepts,
  the boost below 1), the truncated sum of Polson, Scott & Windle (2013,
  eq. 3) with the exact mean of the dropped tail, E PG(b, c) = b / (2c)
  tanh(c / 2); and the moment-matched normal (the program's normal) where
  b >= 50. A cell whose acceptance test lies within rounding of a round's
  threshold is ambiguous and left out.
* ``w_draw``: each row's Gaussian posterior, Q = sum_p omega_p V_p V_p^T
  + I / sigma2 over its active coordinates, mean part sum_p kappa_p V_p,
  drawn as L^-T z + Q^-1 mu_part with L L^T = Q.
* ``v_draw``: each column's posterior as one dense (T k, T k) system: the
  likelihood Gram sum_i omega_ijt W_i W_i^T on the diagonal blocks and
  the trend-filtering prior kron(Delta^T diag(w_j) Delta, I_k), w_j =
  1 / (lam2 Tau2_j) clipped to [stability, 1 / stability], drawn from the
  program's normals.

The program's departures from factor.py, followed here: the W and V
draws factor the Jacobi-equilibrated system D Q D (exact: the draw
L^-T z + Q^-1 mu is the same for any positive diagonal D), and the V draw adds
a relative jitter of 1e-4 to the equilibrated system, i.e. draws from
Q + 1e-4 diag(Q) (``V_JITTER``).

Everything is plain torch in float64 with TF32 off; nothing of the
program is imported. With ``lowp`` (the control) the step's inputs, and
the factor of a Gaussian draw, are rounded by it and the step is computed
in float32.
"""
import math

import torch

F64 = torch.float64
EPS32 = 2.0 ** -23          # float32's machine epsilon
V_JITTER = 1e-4
_TWO_PI_SQ = 2.0 * math.pi ** 2


def _full_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(lowp, *xs):
    """The inputs in float64, or (the control) rounded by ``lowp`` in
    float32."""
    _full_precision()
    if lowp is None:
        return tuple(x.to(F64) for x in xs)
    return tuple(lowp(x.float()) for x in xs)


def rel_gap(prog, ref, mag, dims):
    """max |prog - ref| over ``dims`` / max ``mag`` over them (what bounds
    ref's size and the program's rounding); a non-finite gap reads
    infinity."""
    d = (prog.to(F64) - ref.to(F64)).abs().amax(dims)
    g = d / mag.to(F64).amax(dims).clamp_min(1e-300)
    return torch.where(torch.isfinite(g), g, torch.full_like(g, math.inf))


# ----------------------------------------------------------------------
# (a) the R moves
# ----------------------------------------------------------------------
def log1m_sigmoid(W, V, lowp=None):
    """log(1 - P), P = sigmoid(clip(W V^T, -10, 10)) (factor.py:519):
    (n, m, T); W (n, k), V (m, T, k)."""
    W, V = _inputs(lowp, W, V)
    mu = torch.einsum("ik,jtk->ijt", W, V).clamp(-10.0, 10.0)
    return torch.log1p(-torch.sigmoid(mu))


def r_moves(Y, R, z, u, log1mP, *, rpropstdev, rstdev, clip, r_min,
            al_prog=None, lowp=None):
    """Each of the moves one chain's R made, from the program's R before
    the move.

    Y (n, m, T, r) with NaN where missing; R (M + 1,) + R's shape: the
    program's R before move 0, ..., after the last move (its shape (n|1,
    m|1, T|1) broadcasts over the cells, a 1 where the moves aggregate);
    z, u (M,) + R's shape: the program's proposal normals and acceptance
    uniforms; log1mP (n, m, T) from ``log1m_sigmoid``; ``al_prog`` (M,) +
    R's shape: the program's sums of the likelihood ratio, or None.

    Returns a dict, each (M,) + R's shape:

    * ``al``: the log-likelihood ratio of each proposal, summed over the
      cells R is shared by; ``mag``: the sum of its terms' magnitudes;
    * ``accept``: the decision u <= exp(clip(prior ratio + ratio)) with the
      R > r_min gate, from ``al_prog`` where it is given (else ``al``);
      ``tie``: that decision lies within the rounding of its comparison
      (the prior ratio, the clip, exp, the proposal's log R);
    * ``ok``: where the program moved, R after the move is exp(log R + z
      s) within the program's rounding.
    """
    f = F64 if lowp is None else torch.float32
    Y, R, z, u, log1mP = _inputs(lowp, Y, R, z, u, log1mP)
    obs = ~torch.isnan(Y)
    Y0 = torch.where(obs, Y, torch.zeros_like(Y))
    obs = obs.to(f)
    agg = tuple(d for d in range(3) if R.shape[1 + d] == 1) + (3,)
    lo, hi = clip
    inv = 0.5 / (rstdev * rstdev)
    l1p = log1mP[..., None]
    out = {key: [] for key in ("al", "mag", "accept", "tie", "ok")}
    for i in range(z.shape[0]):
        logR = torch.log(R[i])
        cand = logR + z[i] * rpropstdev
        Rc, R0 = torch.exp(cand)[..., None], R[i][..., None]
        terms = (torch.lgamma(Y0 + Rc), -torch.lgamma(Rc),
                 -torch.lgamma(Y0 + R0), torch.lgamma(R0),
                 (Rc - R0) * l1p)
        al = (sum(terms) * obs).sum(agg, keepdim=True)[..., 0]
        mag = (sum(t.to(F64).abs() for t in terms) * obs.to(F64)).sum(
            agg, keepdim=True)[..., 0]
        ap = (logR * logR - cand * cand) * inv
        al_dec = al if al_prog is None else al_prog[i].to(al.dtype)
        x = torch.clamp(ap + al_dec, lo, hi)
        acc = (torch.log(u[i]) <= x) & (cand > math.log(r_min))
        # the rounding of the comparison: the proposal's log R (the
        # program's log of its R, then + z s), the prior ratio, the sum,
        # the clip and exp
        c64, l64 = cand.to(F64), logR.to(F64)
        dcand = 4.0 * EPS32 * (l64.abs() + (z[i].to(F64) * rpropstdev)
                               .abs() + 1.0)
        tie = 8.0 * EPS32 * ((l64 ** 2 + c64 ** 2) * inv + al_dec.to(F64)
                             .abs() + 1.0) + 4.0 * dcand * c64.abs() * inv
        tie = ((torch.log(u[i].to(F64)) - x.to(F64)).abs() <= tie) | (
            (c64 - math.log(r_min)).abs() <= dcand)
        moved = R[i + 1] != R[i]
        gap = (R[i + 1].to(F64) - torch.exp(c64)).abs() / torch.exp(c64)
        for key, v in (("al", al), ("mag", mag), ("accept", acc),
                       ("tie", tie),
                       ("ok", ~moved | (gap <= dcand + 8.0 * EPS32))):
            out[key].append(v)
    return {key: torch.stack(v) for key, v in out.items()}


# ----------------------------------------------------------------------
# (b) the Polya-Gamma draw
# ----------------------------------------------------------------------
def mt_gamma(a, x, u, ub):
    """Fixed-round Marsaglia-Tsang Gamma(a, 1) draws from the program's
    noise: a (...), x and u (rounds, ...), ub (...). Returns (g,
    ambiguous): the first round whose test passes gives d v (the mean
    a_eff where none does), a < 1 boosted by ub^(1/a); ``ambiguous`` where
    a test up to the one taken lies within rounding of its threshold."""
    small = a < 1.0
    a_eff = torch.where(small, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    c = torch.rsqrt(9.0 * d)
    out = torch.full_like(a, math.nan)
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    amb = torch.zeros_like(done)
    for r in range(x.shape[0]):
        cx = c * x[r]
        v = (1.0 + cx) ** 3
        pos = v > 0
        logv = torch.log(torch.where(pos, v, torch.ones_like(v)))
        rhs = 0.5 * x[r] * x[r] + d - d * v + d * logv
        lu = torch.log(u[r])
        ok = pos & (lu < rhs)
        # the program's rounding of the test (float32: c, v's cube, the
        # sum and the logs), in float64
        rel = (1.0 + cx.abs()) / (1.0 + cx).abs().clamp_min(1e-30)
        tol = 16.0 * EPS32 * (0.5 * x[r] * x[r]
                              + d * (1.0 + v.abs() + logv.abs())
                              + 3.0 * d * rel * (v.abs() + 1.0)
                              + lu.abs() + 1.0)
        near = ((lu - rhs).abs().to(F64) <= tol.to(F64)) | (
            (1.0 + cx).abs() <= 4.0 * EPS32 * (1.0 + cx.abs()))
        amb = amb | (near & ~done)
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
    out = torch.where(done, out, a_eff)
    boost = torch.exp(torch.log(ub) / a.clamp_min(1e-12))
    out = torch.where(small, out * boost, out)
    return torch.where(a > 0, out, torch.zeros_like(out)), amb & (a > 0)


def pg_mean(b, c):
    """E PG(b, c) = b / (2c) tanh(c / 2), b / 4 at c = 0."""
    h = 0.5 * c
    small = h.abs() < 1e-4
    safe = torch.where(small, torch.ones_like(h), h)
    ratio = torch.where(small, 1.0 - h * h / 3.0, torch.tanh(safe) / safe)
    return 0.25 * b * ratio


def pg_var(b, c):
    """Var PG(b, c) = b / (4 c^3) (sinh c - c) sech^2(c / 2), b / 24 at
    c = 0."""
    small = c.abs() < 1e-2
    safe = torch.where(small, torch.ones_like(c), c)
    c2 = c * c
    series = (1.0 + c2 / 20.0 + c2 * c2 / 840.0) / 24.0
    direct = (torch.sinh(safe) - safe) / (4.0 * safe ** 3)
    return b * torch.where(small, series, direct) / torch.cosh(0.5 * c) ** 2


def pg_draw(b, c, x, u, ub, z, num_terms=16, normal_above=50.0, lowp=None):
    """omega ~ PG(b, c) for S cells from the program's noise: b, c, z (S,);
    x, u (rounds, num_terms, S); ub (num_terms, S). Returns (omega, scale,
    ambiguous), each (S,): ``scale`` bounds omega's size and the program's
    rounding (the sum of its terms' magnitudes)."""
    b, c, x, u, ub, z = _inputs(lowp, b, c, x, u, ub, z)
    if x.shape[1] != num_terms:
        raise ValueError(f"{x.shape[1]} terms of noise, the configuration "
                         f"draws {num_terms}")
    pos = b > 0
    big = b >= normal_above
    one = torch.ones_like(b)
    b_safe = torch.where(pos & ~big, b, one)
    ks = (torch.arange(num_terms, dtype=b.dtype, device=b.device)
          + 0.5) ** 2
    denom = ks[:, None] + (c / (2.0 * math.pi))[None] ** 2
    g, amb = mt_gamma(b_safe.expand(num_terms, -1), x, u, ub)
    terms = g / denom / _TWO_PI_SQ
    trunc = terms.sum(0)
    mean_full = pg_mean(b, c)
    mean_trunc = b_safe * (1.0 / denom).sum(0) / _TWO_PI_SQ
    tail = torch.clamp(mean_full - mean_trunc, min=0.0)
    sd = torch.sqrt(torch.clamp(pg_var(b, c), min=0.0))
    normal = torch.clamp(mean_full + z * sd, min=1e-12)
    omega = torch.where(pos, torch.where(big, normal, trunc + tail),
                        torch.zeros_like(b))
    scale = torch.where(big, mean_full.abs() + (z * sd).abs(),
                        trunc.abs() + mean_full.abs() + mean_trunc.abs())
    scale = torch.where(pos, scale, torch.zeros_like(scale))
    ambiguous = amb.any(0) & pos & ~big
    return omega.to(F64), scale.to(F64), ambiguous


# ----------------------------------------------------------------------
# (c) the W rows and (d) the V columns
# ----------------------------------------------------------------------
def nb_counts(Y, R):
    """The binomial reduction (factor.py:507-511): b = sum over the
    replicates of Y + R (0 where every replicate is missing) and kappa =
    Ysum - b / 2; Y (n, m, T, r) with NaN, R broadcasting against (n, m,
    T). Returns (b, kappa) (n, m, T) in float64."""
    Y, R = Y.to(F64), R.to(F64)
    obs = ~torch.isnan(Y)
    Y0 = torch.where(obs, Y, torch.zeros_like(Y))
    ysum = Y0.sum(-1)
    b = ((Y0 + R[..., None]) * obs).sum(-1)
    return b, ysum - 0.5 * b


def _gauss_draw(Q, mu, z, lowp=None):
    """L^-T z + Q^-1 mu, L L^T = Q: (draw, |noise part| + |mean part|).
    With ``lowp`` (the control) the factor is rounded by it: a solve in
    that precision multiplies by the factor's entries so rounded."""
    L = torch.linalg.cholesky(Q)
    if lowp is not None:
        L = lowp(L)
    noise = torch.linalg.solve_triangular(L.mT, z[..., None], upper=True)
    y = torch.linalg.solve_triangular(L, mu[..., None], upper=False)
    mean = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return (noise + mean)[..., 0], (noise.abs() + mean.abs())[..., 0]


def w_draw(omega, kappa, V, sigma2, wmask, z, lowp=None):
    """One chain's W draw: omega, kappa (n, m, T); V (m, T, k); sigma2
    (); wmask (n, k) the active coordinates; z (n, k). Returns (W (n, k),
    Q (n, k, k), Qmag (n, k, k), scale (n, k)): the draw, the posterior
    precision, what bounds Q's rounding, and what bounds the draw's."""
    omega, kappa, V, sigma2, z = _inputs(lowp, omega, kappa, V, sigma2, z)
    wmask = wmask.to(V.dtype)
    k = V.shape[-1]
    eye = torch.eye(k, dtype=V.dtype, device=V.device)
    mm = wmask[:, :, None] * wmask[:, None, :]
    Q = torch.einsum("ijt,jta,jtb->iab", omega, V, V) * mm + eye / sigma2
    Qmag = (torch.einsum("ijt,jta,jtb->iab", omega.abs(), V.abs(), V.abs())
            * mm + eye / sigma2.abs())
    mu = torch.einsum("ijt,jta->ia", kappa, V) * wmask
    x, scale = _gauss_draw(Q, mu, z, lowp)
    return x * wmask, Q, Qmag, scale


def v_precision(omega, W, lam2, Tau2, Delta, stability):
    """Each column's posterior precision as a dense (m, T k, T k) system in
    time-major order (row t k + a): the likelihood Gram on the diagonal
    blocks and kron(Delta^T diag(w_j) Delta, I_k). omega (n, m, T); W (n,
    k); lam2 (); Tau2 (m, nD); Delta (nD, T). Returns (Q, Qmag)."""
    m, T = omega.shape[1:]
    k = W.shape[-1]
    w = torch.clamp(1.0 / torch.clamp(lam2 * Tau2, stability,
                                      1.0 / stability),
                    stability, 1.0 / stability)
    eye = torch.eye(k, dtype=W.dtype, device=W.device)
    G = torch.einsum("ijt,ia,ib->jtab", omega, W, W)
    Gmag = torch.einsum("ijt,ia,ib->jtab", omega.abs(), W.abs(), W.abs())
    prior = torch.einsum("dt,jd,ds->jts", Delta, w, Delta)
    pmag = torch.einsum("dt,jd,ds->jts", Delta.abs(), w, Delta.abs())

    def dense(blocks, band):
        Q = torch.einsum("jts,ab->jtasb", band, eye)
        idx = torch.arange(T, device=W.device)
        Q[:, idx, :, idx, :] += blocks.permute(1, 0, 2, 3)
        return Q.reshape(m, T * k, T * k)
    return dense(G, prior), dense(Gmag, pmag)


def v_draw(omega, kappa, W, lam2, Tau2, Delta, z, stability, lowp=None):
    """One chain's V draw: omega, kappa (n, m, T); W (n, k) as the W
    update left it; lam2 (); Tau2 (m, nD); Delta (nD, T); z (m, T, k) the
    program's normals in time-major order. Returns (V (m, T, k), Q, Qmag,
    scale (m, T, k)): the draw from Q + V_JITTER diag(Q), the precision
    before the jitter, what bounds its rounding and the draw's."""
    omega, kappa, W, lam2, Tau2, z = _inputs(lowp, omega, kappa, W, lam2,
                                             Tau2, z)
    Delta = Delta.to(W.dtype)
    m, T = omega.shape[1:]
    k = W.shape[-1]
    Q, Qmag = v_precision(omega, W, lam2, Tau2, Delta, stability)
    Qj = Q + torch.diag_embed(V_JITTER * torch.diagonal(Q, dim1=-2,
                                                        dim2=-1))
    mu = torch.einsum("ijt,ia->jta", kappa, W).reshape(m, T * k)
    x, scale = _gauss_draw(Qj, mu, z.reshape(m, T * k), lowp)
    return x.reshape(m, T, k), Q, Qmag, scale.reshape(m, T, k)


def bands_dense(bands):
    """The dense (..., T k, T k) matrix of block-banded bands (..., T, p +
    1, k, k), band d of row t holding block (t, t - d)."""
    *batch, T, p1, k, _ = bands.shape
    Q = bands.new_zeros(tuple(batch) + (T, k, T, k))
    for t in range(T):
        for d in range(min(p1 - 1, t) + 1):
            blk = bands[..., t, d, :, :]
            Q[..., t, :, t - d, :] = blk
            if d:
                Q[..., t - d, :, t, :] = blk.mT
    return Q.reshape(tuple(batch) + (T * k, T * k))
