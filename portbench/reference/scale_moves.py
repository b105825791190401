"""Plain reference of the constrained model's scale moves, to follow and
judge the moves the program made in one sweep of one chain.

The moves (Tansey, Tosh & Blei 2021, the exact ASIS re-draws): a
collapsed rebalance ``(W, V) -> (W e^-x, V e^x)``, one per factor, a
Gibbs re-draw of sigma2 and of lam2 at the new split, then slice moves of
log lam2 (V and tau rescaled) and of log sigma2 (W and tau rescaled), each
a shrinking slice sampler of 16 steps on a bracket. The reference starts
from the chain's state as the scale moves received it, works out each
move's log density in float64 at the points the program evaluated, and
judges:

* each log density against the program's (``scale_gap``: |program -
  reference| / (the sum of the magnitudes of its terms + 1));
* each step's accept or reject against the reference's density, where a
  point within rounding of the slice may go either way, the bracket each
  step shrinks and the point the move ends at (``wrong``);
* the brackets, the re-draw's argument and the state the moves leave
  (``state_gap``, relative).

It follows the program's accepted points (judged as above) and takes the
two Gibbs re-draws as the program drew them: their noise is the
program's. Plain torch; nothing of the program is imported.
"""
import numpy as np
import torch

F64 = torch.float64
SLICE_STEPS = 16
TIE_RTOL = 2.4e-7     # float32's rounding of a sum (2 eps), of its size
LOG_LAM2_MIN = float(np.log(1e-5))


def tf_penalty(T, order):
    """The trend-filtering operator of the prior: an anchor row e_0 over
    the difference operators of orders 0..order on a chain of T points
    (D, D^T D, D D^T D, ...), (nD, T)."""
    D = np.zeros((T - 1, T))
    D[np.arange(T - 1), np.arange(T - 1)] = -1.0
    D[np.arange(T - 1), np.arange(1, T)] = 1.0
    rows = [np.eye(1, T)]
    op = D
    rows.append(op)
    for i in range(order):
        op = D.T @ op if i % 2 == 0 else D @ op
        rows.append(op)
    return np.concatenate(rows, axis=0)


def packed_w_len(n, k):
    """Free coordinates of a lower-triangular (n, k) W."""
    if n >= k:
        return (k * k - k) // 2 + k + (n - k) * k
    return (n * n - n) // 2 + n


def _rel(a, b, mag=None):
    """Largest |a - b| over the largest |b| (or ``mag``, what bounds b's
    rounding), per chain, of (S, ...)."""
    S = a.shape[0]
    d = (a - b).abs().reshape(S, -1).amax(-1)
    ref = b.abs() if mag is None else mag
    return d / torch.clamp(ref.reshape(S, -1).amax(-1), min=1e-30)


def _scale_bounds(vals, cs):
    ratio = cs / torch.where(vals == 0, torch.ones_like(vals), vals)
    s_lo = torch.where(vals > 0, ratio, -torch.inf).amax(-1)
    s_hi = torch.where(vals < 0, ratio, torch.inf).amin(-1)
    return (torch.clamp(s_lo, min=1e-6) * (1.0 + 1e-6),
            torch.clamp(s_hi, max=1e6) * (1.0 - 1e-6))


class Judge:
    """Accumulates the three numbers over the moves it is shown."""

    def __init__(self, record=False):
        self.scale_gap = 0.0
        self.state_gap = 0.0
        self.wrong = 0
        self.compared = 0
        # the control's run keeps its densities instead of judging
        self.densities = [] if record else None

    def gap(self, value):
        if self.densities is None:
            self.state_gap = max(self.state_gap, float(value.max()))

    def slice_move(self, call, logdens, x0, lo, hi):
        """Judge one slice move; ``logdens(x (E, S)) -> (ld, scale)``,
        x0, lo, hi the reference's start and bracket (S,). Returns the
        point the program went to, in x0's dtype (S,)."""
        dt = x0.dtype
        if self.densities is not None:
            self.densities.append(logdens(call["xs"].to(dt))[0])
            return call["x_new"].to(dt)
        self.gap((call["x0"] - x0).abs() / (1.0 + x0.abs()))
        self.gap((call["lo"] - lo).abs() / (1.0 + lo.abs()))
        self.gap((call["hi"] - hi).abs() / (1.0 + hi.abs()))
        xs, lds = call["xs"], call["lds"]                   # (17, S)
        ld_ref, sc = logdens(xs.to(dt))
        g = (lds.to(dt) - ld_ref).abs() / (sc + 1.0)
        g = torch.where(torch.isfinite(g), g, torch.full_like(g, np.inf))
        self.scale_gap = max(self.scale_gap, float(g.max()))
        self.compared += g.numel()
        d = (lds.to(dt) - ld_ref).abs()
        width = 2.0 * torch.where(torch.isfinite(d), d, 0.0) \
            + TIE_RTOL * (ld_ref.abs() + 1.0)
        e, u = call["e"], call["u"]
        y_p = lds[0] - e                       # the program's own slice
        y_r = ld_ref[0] - e.to(dt)
        x0p = call["x0"]
        L, R = call["lo"].to(dt), call["hi"].to(dt)
        ok_p = torch.zeros_like(x0p, dtype=torch.bool)
        for i in range(SLICE_STEPS):
            xp = xs[i + 1]
            xr = L + (R - L) * u[i].to(dt)
            self.gap((xp.to(dt) - xr).abs() / (L.abs() + R.abs() + 1.0))
            ok_p = lds[i + 1] >= y_p
            ok_r = ld_ref[i + 1] >= y_r
            # within the program's own rounding of the two densities (and
            # of the slice's sum) the comparison may go either way
            tie = ((ld_ref[i + 1] - y_r).abs()
                   <= width[i + 1] + width[0] + TIE_RTOL * y_r.abs())
            self.wrong += int(((ok_p != ok_r) & ~tie).sum())
            left = xp < x0p
            L = torch.where(ok_p | left, xp.to(dt), L)
            R = torch.where(ok_p | ~left, xp.to(dt), R)
        went = torch.where(ok_p, xs[SLICE_STEPS], x0p)
        self.wrong += int((went != call["x_new"]).sum())
        return call["x_new"].to(dt)


def replay(entry, calls, redraws, after, const, full_ll, judge):
    """Follow one sweep's scale moves of S chains and judge them.

    entry: W (S, n, k) as the moves got it, V (S, m, T, k), lam2, lam2_a,
    sigma2 (S,), Tau2 (S, m, nD), float64. calls: the slice moves in the
    program's order, each dict(x0, lo, hi, e (S,), u (16, S), xs, lds (17,
    S): the points evaluated, x0 first, and the program's densities,
    x_new (S,)). redraws: the program's Gibbs re-draws inside the moves,
    dict(sigma2, lam2_arg, lam2, lam2_a) of (S,) (absent where not drawn).
    after: the state at the sweep's end, dict(W, V, lam2, sigma2). const:
    wmask (n, k), delta (nD, T), stability, sigma2_a, sigma2_b,
    sample_sigma2, sample_lam2, factor_rebalance, A (J, T), c (J,).
    full_ll(tau, mag (S, n, m, T), s (S,)) -> (ll, scale) of the
    likelihood at s tau, mag the sum of the magnitudes of tau's products.
    Computes in entry's dtype; returns the state it leaves, dict(W, V,
    lam2, sigma2), and compares it with ``after`` unless that is None."""
    k = entry["W"].shape[-1]
    m, T = entry["V"].shape[1:3]
    wmask = const["wmask"]
    expected = (1 + (k if const["factor_rebalance"] and k > 1 else 0)
                + int(const["sample_lam2"]) + int(const["sample_sigma2"]))
    if len(calls) != expected:
        raise ValueError(f"{len(calls)} slice moves, the schedule makes "
                         f"{expected}")
    drawn = ((["sigma2"] if const["sample_sigma2"] else [])
             + (["lam2_arg", "lam2", "lam2_a"] if const["sample_lam2"]
                else []))
    if any(key not in redraws for key in drawn):
        raise ValueError("a Gibbs re-draw of the moves was not seen")
    calls = iter(calls)
    W_all = entry["W"].clone()
    W = W_all * wmask
    V = entry["V"].clone()
    tau = torch.einsum("snk,smtk->snmt", W, V)
    mag = torch.einsum("snk,smtk->snmt", W.abs(), V.abs())
    stab = const["stability"]
    inv_tau2 = 1.0 / torch.clamp(entry["Tau2"], stab, 1.0 / stab)
    deltas = torch.einsum("dt,smtk->smdk", const["delta"], V)
    dq = deltas * deltas * inv_tau2[..., None]
    # what bounds dq's rounding: a difference of V's taps cancels, so its
    # rounding is of the taps' magnitudes, not of the difference
    dq_mag = (2.0 * deltas.abs() * inv_tau2[..., None] * torch.einsum(
        "dt,smtk->smdk", const["delta"].abs(), V.abs()))
    Qbar = torch.clamp(dq.sum((1, 2, 3)), min=1e-20)
    W2 = (W * W).sum((1, 2))
    dW, dV = float(packed_w_len(W.shape[1], k)), float(m * T * k)
    a_s, b_s = const["sigma2_a"], const["sigma2_b"]
    inv_la = 1.0 / torch.clamp(entry["lam2_a"], min=1e-20)
    inv_s2 = 1.0 / torch.clamp(entry["sigma2"], min=1e-20)
    inv_l2 = 1.0 / torch.clamp(entry["lam2"], min=1e-20)

    def w_term(x, rest, w2):
        """The W prior's term and its slope in W2."""
        u = rest + torch.exp(-2.0 * x) * w2
        if const["sample_sigma2"]:
            arg = b_s + u / 2.0
            return -(a_s + dW / 2.0) * torch.log(arg), \
                (a_s + dW / 2.0) / (2.0 * arg)
        return -0.5 * torch.exp(-2.0 * x) * w2 * inv_s2, 0.5 * inv_s2 + 0.0 * x

    def v_term(x, rest, q):
        """The V prior's term and its slope in Qbar."""
        u = rest + torch.exp(2.0 * x) * q
        if const["sample_lam2"]:
            arg = inv_la + u / 2.0
            return -(0.5 + dV / 2.0) * torch.log(arg), \
                (0.5 + dV / 2.0) / (2.0 * arg)
        return -0.5 * torch.exp(2.0 * x) * q * inv_l2, 0.5 * inv_l2 + 0.0 * x

    def rebalance(jac, W2_rest, w2, Q_rest, q, Q_rest_mag, q_mag):
        def logdens(x):
            wt, ws = w_term(x, W2_rest, w2)
            vt, vs = v_term(x, Q_rest, q)
            terms = (jac * x, wt, vt)
            scale = (sum(t.abs() for t in terms)
                     + ws * (W2_rest + torch.exp(-2.0 * x) * w2)
                     + vs * (Q_rest_mag + torch.exp(2.0 * x) * q_mag))
            return sum(terms), scale
        return logdens

    S = W.shape[0]
    six = torch.full((S,), 6.0, dtype=W.dtype, device=W.device)
    zero = torch.zeros_like(six)
    Qbar_mag = dq_mag.sum((1, 2, 3))
    x_c = judge.slice_move(next(calls), rebalance(dV - dW, 0.0, W2, 0.0,
                                                  Qbar, 0.0, Qbar_mag),
                           zero, -six, six)
    c4 = (slice(None), None, None, None)
    W, V, W_all = (W * torch.exp(-x_c)[c4[:3]], V * torch.exp(x_c)[c4],
                   W_all * torch.exp(-x_c)[c4[:3]])
    Qbar_cur = torch.exp(2.0 * x_c) * Qbar
    Qbar_cur_mag = torch.exp(2.0 * x_c) * Qbar_mag
    if const["factor_rebalance"] and k > 1:
        w2k = (W * W).sum(1)
        qk = torch.clamp(dq.sum((1, 2)) * torch.exp(2.0 * x_c)[:, None],
                         min=1e-20)
        qk_mag = dq_mag.sum((1, 2)) * torch.exp(2.0 * x_c)[:, None]
        dwk = wmask.sum(0)
        for kk in range(k):
            x_f = judge.slice_move(next(calls), rebalance(
                float(m * T) - float(dwk[kk]), w2k.sum(-1) - w2k[:, kk],
                w2k[:, kk], qk.sum(-1) - qk[:, kk], qk[:, kk],
                qk_mag.sum(-1) - qk_mag[:, kk], qk_mag[:, kk]),
                zero, -six, six)
            fw = torch.ones_like(w2k)
            fw[:, kk] = torch.exp(-x_f)
            fv = torch.ones_like(w2k)
            fv[:, kk] = torch.exp(x_f)
            W, V, W_all = W * fw[:, None], V * fv[:, None, None], \
                W_all * fw[:, None]
            w2k, qk, qk_mag = w2k * fw * fw, qk * fv * fv, qk_mag * fv * fv
        Qbar_cur, Qbar_cur_mag = qk.sum(-1), qk_mag.sum(-1)
    sigma2, lam2, lam2_a = entry["sigma2"], entry["lam2"], entry["lam2_a"]
    if const["sample_sigma2"]:
        sigma2 = redraws["sigma2"]
    if const["sample_lam2"]:
        judge.gap(_rel(redraws["lam2_arg"][:, None], Qbar_cur[:, None],
                       (Qbar_cur + Qbar_cur_mag)[:, None]))
        lam2, lam2_a = redraws["lam2"], redraws["lam2_a"]

    A, c = const["A"], const["c"]
    cone = bool((c == 0).all())
    Av = None if cone else torch.einsum("jt,snmt->snmj", A, tau).reshape(
        S, -1)
    cs = None if cone else c.repeat(tau.shape[1] * m).expand(S, -1)

    def likelihood_move(x0, prior):
        def logdens(x):
            lds, scs = [], []
            for row in x:
                ll, sc = full_ll(tau, mag, torch.exp(0.5 * (row - x0)))
                p, psc = prior(row)
                lds.append(p + ll)
                scs.append(psc + sc)
            return torch.stack(lds), torch.stack(scs)
        return logdens

    if const["sample_lam2"]:
        x0 = torch.log(torch.clamp(lam2, min=1e-20))
        if cone:
            lo_s, hi_s = x0 - 12.0, x0 + 12.0
        else:
            s_lo, s_hi = _scale_bounds(Av, cs)
            lo_s = torch.maximum(x0 + 2.0 * torch.log(s_lo), x0 - 12.0)
            hi_s = torch.minimum(x0 + 2.0 * torch.log(s_hi), x0 + 12.0)
        lo = torch.minimum(torch.clamp(lo_s, min=LOG_LAM2_MIN), x0)
        hi = torch.maximum(hi_s, x0)
        inv_a = 1.0 / torch.clamp(lam2_a, min=1e-20)

        def prior_l(x):
            t = (-0.5 * x, -torch.exp(-x) * inv_a)
            return sum(t), sum(v.abs() for v in t)

        x_new = judge.slice_move(next(calls), likelihood_move(x0, prior_l),
                                 x0, lo, hi)
        s = torch.exp(0.5 * (x_new - x0))
        V, tau, mag = V * s[c4], tau * s[c4], mag * s[c4]
        Av = None if Av is None else Av * s[:, None]
        lam2 = torch.exp(x_new)

    if const["sample_sigma2"]:
        x0 = torch.log(torch.clamp(sigma2, min=1e-20))
        if Av is None:
            lo, hi = x0 - 12.0, x0 + 12.0
        else:
            s_lo, s_hi = _scale_bounds(Av, cs)
            lo = torch.maximum(x0 + 2.0 * torch.log(s_lo), x0 - 12.0)
            hi = torch.minimum(x0 + 2.0 * torch.log(s_hi), x0 + 12.0)
        lo, hi = torch.minimum(lo, x0), torch.maximum(hi, x0)

        def prior_s(x):
            t = (-a_s * x, -b_s * torch.exp(-x))
            return sum(t), sum(v.abs() for v in t)

        x_new = judge.slice_move(next(calls), likelihood_move(x0, prior_s),
                                 x0, lo, hi)
        W_all = W_all * torch.exp(0.5 * (x_new - x0))[c4[:3]]
        sigma2 = torch.exp(x_new)

    left = dict(W=W_all, V=V, lam2=lam2, sigma2=sigma2)
    if after is not None:
        for key, val in left.items():
            judge.gap(_rel(val.reshape(S, -1), after[key].reshape(S, -1)))
    return left
