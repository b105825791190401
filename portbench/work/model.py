"""The frozen work model: what a GASS candidate log-likelihood needs, in
operations and bytes, and the H100's published peaks.

The fused kernels' part is a copy of ``ops/fused_ll_bench.py:work`` taken
from a launch's shapes and index arrays and the benchmark's own data, so
that a later change to the program cannot move the yardstick. The Gamma
mixture's per-cell count follows the formula of
``GammaGridLikelihood.logpdf``. Every count is of the work the inputs need,
whatever computes it.
"""
import numpy as np

# Published H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, FP32
# FLOP/s outside the tensor cores, and special-function (MUFU) ops/s at 16
# a clock an SM, 132 SMs, the 1.98 GHz boost clock. They assume 700 W.
H100 = dict(bytes_per_s=3.35e12, fp32_per_s=67e12,
            sfu_per_s=132 * 16 * 1.98e9)

# FP32 operations a (candidate, cell) pair besides the k-term dot (2k):
# the Poisson cell (clamp, y*log(rate) - rate, the sum) and the EP term
# ((tau - mu) / sig, its square, the constant, the difference)
POISSON_FLOPS, EP_FLOPS = 4, 4


def _bound(flops, sfu, nbytes):
    times = dict(bytes=nbytes / H100["bytes_per_s"],
                 operations=flops / H100["fp32_per_s"],
                 special_function=sfu / H100["sfu_per_s"])
    side = max(times, key=times.get)
    return times[side] * 1e6, side


def row_launch_work(G, k, row_idx, row_chain, y, ep=False):
    """The row kernel at one launch: G candidates of k for each item r,
    whose cells are the row ``row_idx[r]`` of ``y`` (n, C) (NaN =
    missing). Returns dict(flops, sfu, bytes, bound_us, bound_by)."""
    row_idx = np.asarray(row_idx)
    present = ~np.isnan(y)                                   # (n, C)
    n_y = int(present[row_idx].sum())
    n_act = present.shape[1] * len(row_idx) if ep else n_y
    n_ep = n_act if ep else 0
    flops = G * (n_act * 2 * k + n_y * POISSON_FLOPS + n_ep * EP_FLOPS)
    sfu = G * n_y
    R, C = len(row_idx), y.shape[1]
    nbytes = 4 * (R * G * k + R * G)                         # cands, out
    nbytes += 4 * len(np.unique(row_chain)) * C * k          # bt
    nbytes += 4 * 2 * R                                      # indices
    per_cell = 3 if ep else 1
    nbytes += 4 * per_cell * len(np.unique(row_idx)) * C
    us, side = _bound(flops, sfu, nbytes)
    return dict(flops=flops, sfu=sfu, bytes=nbytes, bound_us=us,
                bound_by=side)


def col_launch_work(G, Tb, k, pair_chain, pair_col, pair_t0, y, ep=False):
    """The column-block kernel at one launch: G candidates of Tb x k for
    each pair p, whose cells are y[:, pair_col[p], pair_t0[p] + t] of y
    (n, m, T) inside [0, T)."""
    pair_col, pair_t0 = np.asarray(pair_col), np.asarray(pair_t0)
    n, m, T = y.shape
    tt = pair_t0[:, None] + np.arange(Tb)[None]
    inside = (tt >= 0) & (tt < T)
    present = ~np.isnan(y)                                   # (n, m, T)
    cnt = present.sum(0)                                     # (m, T)
    cells = cnt[pair_col[:, None], np.clip(tt, 0, T - 1)]    # (P, Tb)
    n_y = int((cells * inside).sum())
    n_in = int(inside.sum()) * n
    n_act = n_in if ep else n_y
    n_ep = n_in if ep else 0
    flops = G * (n_act * 2 * k + n_y * POISSON_FLOPS + n_ep * EP_FLOPS)
    sfu = G * n_y
    P = len(pair_col)
    nbytes = 4 * (P * G * Tb * k + P * G)
    nbytes += 4 * len(np.unique(pair_chain)) * n * k
    nbytes += 4 * 3 * P
    per_cell = 3 if ep else 1
    nbytes += 4 * per_cell * n_in
    us, side = _bound(flops, sfu, nbytes)
    return dict(flops=flops, sfu=sfu, bytes=nbytes, bound_us=us,
                bound_by=side)


def poisson_cell_flops(k, ep=False):
    """FP32 operations of one (candidate, present cell) pair."""
    return 2 * k + POISSON_FLOPS + (EP_FLOPS if ep else 0)


def gamma_mixture_cell_flops(k, replicates, components, ep=False):
    """Operations of one (candidate, cell) pair of the Gamma-mixture
    likelihood, each special function one operation: the k-term dot (2k);
    per component the scale (clamp, multiply) and its log (3); per
    (replicate, component) log y, (shape - 1) log y, y / scale,
    shape log scale, three subtractions and the sum over replicates (8);
    the log-sum-exp with the log weights (add, max, subtract, exp, sum per
    component; log and add per cell); the EP term (5: difference, divide,
    square, scale, subtract, its log sigma counted once a cell) and the
    cell's share of the item's sum (1)."""
    R, Gm = replicates, components
    return (2 * k + 3 * Gm + 8 * R * Gm + 5 * Gm + 2 + (6 if ep else 0)
            + 1)


def gass_sweep_flops(nchains, ngrid, cell_flops_total):
    """A sweep's grid work: the W update and the V update each evaluate
    every present cell once a candidate, for ngrid + 1 candidates (the
    grid and the current point) of every chain. ``cell_flops_total`` is
    the sum over the tensor's cells of one pair's operations."""
    return 2 * nchains * (ngrid + 1) * cell_flops_total
