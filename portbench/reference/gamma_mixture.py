"""Plain reference of the dose-response model's black-box likelihood: the
empirical-Bayes Gamma mixture (reference doseresponse/empirical_bayes.py:
15-31) summed over an item's cells, less the EP log-density.

A cell of effect e with replicates y_r mixes Gamma(shape_g, scale_g e)
over the grid components g, where shape_g = mean_g^2 / variance and
scale_g = variance / mean_g:

    log sum_g p_g prod_r Gamma(y_r; shape_g, scale_g e),

NaN replicates left out, scale clamped at 1e-12 and y at 1e-12. The grid
constants are worked out here from (mean_grid, mean_probs, variance), which
the benchmark made. Plain torch in the dtype the caller names; nothing of
the program is imported.
"""
import torch

from portbench.reference.poisson import ep_scale, ep_terms


class Mixture:
    def __init__(self, mean_grid, mean_probs, variance, device,
                 dtype=torch.float64):
        f64 = dict(dtype=torch.float64, device=device)
        mg = torch.as_tensor(mean_grid, **f64)
        probs = torch.as_tensor(mean_probs, **f64)
        shape = mg ** 2 / variance
        self.dtype = dtype
        self.shape = shape.to(dtype)
        self.scale = (variance / mg).to(dtype)
        self.lgamma = torch.lgamma(shape).to(dtype)
        self.log_probs = torch.log(probs).to(dtype)

    def cell_logpdf(self, y, effect):
        """y (..., R), effect (...) -> (...)."""
        y, effect = y.to(self.dtype), effect.to(self.dtype)
        yg = y[..., None]                                   # (..., R, 1)
        scale = torch.clamp(self.scale * effect[..., None, None], min=1e-12)
        nan = torch.isnan(yg)
        ys = torch.clamp(torch.where(nan, torch.ones_like(yg), yg), min=1e-12)
        comp = ((self.shape - 1.0) * torch.log(ys) - ys / scale
                - self.lgamma - self.shape * torch.log(scale))
        comp = torch.where(nan, torch.zeros_like(comp), comp).sum(-2)
        return torch.logsumexp(comp + self.log_probs, dim=-1)

    def cell_scale(self, y, effect, mag):
        """What bounds a cell's rounding: over the components, the largest
        sum of the magnitudes of the replicates' terms and the weight's log,
        and the largest change that the effect's own rounding (at most eps
        x ``mag``) makes, sum_r (y_r / (scale_g e^2) + shape_g / e) x mag,
        with the scale clamped as the likelihood clamps it (a candidate
        off the constraints can have e <= 0) and e = scale / scale_g."""
        y, effect, mag = (x.to(torch.float64) for x in (y, effect, mag))
        yg = y[..., None]
        unit = self.scale.double()
        scale = torch.clamp(unit * effect[..., None, None], min=1e-12)
        e = scale / unit
        shape = self.shape.double()
        nan = torch.isnan(yg)
        ys = torch.clamp(torch.where(nan, torch.ones_like(yg), yg), min=1e-12)
        terms = ((shape - 1.0).abs() * torch.log(ys).abs() + ys / scale
                 + self.lgamma.double().abs()
                 + shape * torch.log(scale).abs())
        slope = ys / (scale * e) + shape / e
        zero = torch.zeros_like(terms)
        terms = torch.where(nan, zero, terms).sum(-2)
        slope = torch.where(nan, zero, slope).sum(-2)
        return (terms + self.log_probs.double().abs()
                + slope * mag[..., None]).amax(-1)


def _cells(mix, y, tau, mag, ep):
    """(terms, scale) of every cell; ``mag`` the sum of the magnitudes of
    tau's k products."""
    t = mix.cell_logpdf(y, tau)
    s = mix.cell_scale(y, tau, mag)
    if ep is not None:
        ep = tuple(e.to(mix.dtype) for e in ep)
        t = t - ep_terms(tau, *ep)
        s = s + ep_scale(tau.double(), *(e.double() for e in ep), mag)
    return t, s


def _inputs(mix, lowp, *xs):
    if lowp is None:
        return tuple(x.to(mix.dtype) for x in xs)
    return tuple(lowp(x.float()).to(mix.dtype) for x in xs)


def w_items_ll(mix, cands, V, y, ep, lowp=None):
    """W update items: cands (S, G, k) masked, V (S, m, T, k) each item's
    chain's, y (S, m, T, R) its row, ep (mu, sig) each (S, m, T). Returns
    (ll (S, G), scale (S, G)): the sum over the row's cells and the sum of
    what bounds their rounding (float64); with ``lowp`` (the control) the
    products' inputs rounded by it, in ``mix``'s dtype."""
    f64 = torch.float64
    mag = torch.einsum("sgk,smtk->sgmt", cands.to(f64).abs(),
                       V.to(f64).abs())
    c_, V_ = _inputs(mix, lowp, cands, V)
    tau = torch.einsum("sgk,smtk->sgmt", c_, V_)
    t, s = _cells(mix, y[:, None], tau, mag, tuple(e[:, None] for e in ep))
    return t.sum((2, 3)), s.sum((2, 3))


def v_items_ll(mix, cands, X, s0, W, y, ep, lowp=None):
    """V update items of blocks that start at s0 (one int): cands (S, G,
    size, k), X (S, T, k) each item's column curve, W (S, n, k) its chain's
    masked W, y (S, n, T, R) its column, ep each (S, n, T). The whole
    curve, the block replaced by each candidate. Returns (ll (S, G), scale
    (S, G))."""
    S, G, size, _ = cands.shape
    Vg = X.to(torch.float64)[:, None].repeat(1, G, 1, 1)
    Vg[:, :, s0:s0 + size] = cands.to(torch.float64)
    mag = torch.einsum("sgtk,snk->sgnt", Vg.abs(), W.to(torch.float64).abs())
    Vg_, W_ = _inputs(mix, lowp, Vg, W)
    tau = torch.einsum("sgtk,snk->sgnt", Vg_, W_)
    t, s = _cells(mix, y[:, None], tau, mag, tuple(e[:, None] for e in ep))
    return t.sum((2, 3)), s.sum((2, 3))


def full_ll(mix, y, tau, mag):
    """The full-tensor likelihood of the scale moves: y (n, m, T, R), tau
    and mag (S, n, m, T). Returns (ll (S,), scale (S,))."""
    return (mix.cell_logpdf(y, tau).sum((1, 2, 3)).to(torch.float64),
            mix.cell_scale(y, tau, mag).sum((1, 2, 3)))
