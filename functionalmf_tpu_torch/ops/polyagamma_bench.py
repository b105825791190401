"""Check and time the Polya-Gamma kernel (csrc/polyagamma.cu) against the
plain version, on a card.

The yardstick is :func:`reference64`: the same draw from the same noise in
float64, which also gives each cell's rounding scale (the sum of its
terms' magnitudes: what bounds omega's size and a float32 version's
rounding) and the lanes whose acceptance test lies within rounding of its
threshold (there a float32 test may take another round than float64 and
the draws differ by a whole gamma; they are left out of a comparison, as
the benchmark's ``pg_gap`` leaves them out). :func:`check_draw` holds a
kernel draw to the plain version on the same inputs within ``TOL_EPS``
float32 eps of that scale and a second launch to the first bit for bit;
:func:`time_draw` measures the kernel's device time (torch.profiler, or
CUDA events around a CUDA graph, ``fused_ll_bench.device_us``), the
wrapper's host time, CUDA events around a call of each version, and the
H100's bound by the bytes the draw needs (:func:`needed_bytes`).
``chip_smoke.py`` runs both on the negative-binomial politics model's own
draw; ``tests/test_torch_polyagamma_kernel.py`` uses the yardstick.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from functionalmf_tpu_torch.ops import fused_ll_bench as FB
from functionalmf_tpu_torch.ops.polyagamma import (polya_gamma,
                                                   polya_gamma_plain)

__all__ = ["TOL_EPS", "EPS32", "reference64", "gap_eps", "needed_bytes",
           "check_draw", "time_draw"]

EPS32 = float(np.finfo(np.float32).eps)
TOL_EPS = 4.0          # kernel against plain, in float32 eps of the scale
F64 = torch.float64
_TWO_PI_SQ = 2.0 * math.pi ** 2


def _pg_mean64(b, c):
    h = 0.5 * c
    small = h.abs() < 1e-4
    safe = torch.where(small, 1.0, h)
    return 0.25 * b * torch.where(small, 1.0 - h * h / 3.0,
                                  torch.tanh(safe) / safe)


def _pg_var64(b, c):
    small = c.abs() < 1e-2
    safe = torch.where(small, 1.0, c)
    c2 = c * c
    v = torch.where(small, (1.0 + c2 / 20.0 + c2 * c2 / 840.0) / 24.0,
                    (torch.sinh(safe) - safe) / (4.0 * safe ** 3))
    return (b * v / torch.cosh(0.5 * c) ** 2).clamp_min(0.0)


def _mt64(a, x, u, ub):
    """Fixed-round Marsaglia-Tsang in float64 on given noise: a (K, S) > 0,
    x, u (R, K, S), ub (K, S). Returns (g, near, rounds): the draws, where
    a test up to the one taken lies within float32 rounding of its
    threshold, and the rounds each lane runs (all R where none accepts)."""
    small = a < 1.0
    a_eff = torch.where(small, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    cm = torch.rsqrt(9.0 * d)
    g = a_eff.clone()
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    near = torch.zeros_like(done)
    rounds = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    for r in range(x.shape[0]):
        xr, lu = x[r], torch.log(u[r])
        cx = cm * xr
        v = (1.0 + cx) ** 3
        logv = torch.log(torch.where(v > 0, v, 1.0))
        rhs = 0.5 * xr * xr + d - d * v + d * logv
        ok = (v > 0) & (lu < rhs)
        # float32's rounding of the test: c, the cube, the sum, the logs
        rel = (1.0 + cx.abs()) / (1.0 + cx).abs().clamp_min(1e-30)
        tol = 16.0 * EPS32 * (0.5 * xr * xr
                              + d * (1.0 + v.abs() + logv.abs())
                              + 3.0 * d * rel * (v.abs() + 1.0)
                              + lu.abs() + 1.0)
        close = ((lu - rhs).abs() <= tol) | (
            (1.0 + cx).abs() <= 4.0 * EPS32 * (1.0 + cx.abs()))
        near |= close & ~done
        rounds += (~done).int()
        g = torch.where(ok & ~done, d * v, g)
        done |= ok
    boost = torch.exp(torch.log(ub) / a)
    return torch.where(small, g * boost, g), near, rounds


def reference64(b, c, z, noise=None, g=None, normal_above=50.0,
                chunk=1 << 20):
    """The draw of ``polya_gamma`` in float64 from the noise it was given:
    b, c, z at one shape; ``noise`` (x, u, ub) at (rounds, K) + shape and
    (K,) + shape, or ``g`` at (K,) + shape. Returns flat (S,) tensors on
    the inputs' device: (omega, scale, ambiguous, rounds): the sum of the
    terms' magnitudes (the normal branch's two parts at b >=
    ``normal_above``, 0 at b <= 0), the lanes within rounding of a
    threshold, and the Marsaglia-Tsang rounds a cell's terms run (0 for a
    cell without gamma work). Cells go ``chunk`` at a time."""
    b, c, z = (t.reshape(-1) for t in torch.broadcast_tensors(
        *(torch.as_tensor(t) for t in (b, c, z))))
    S = b.numel()
    if g is not None:
        K = g.shape[0]
        g = g.reshape(K, S)
    else:
        x, u, ub = noise
        R, K = x.shape[:2]
        x, u, ub = x.reshape(R, K, S), u.reshape(R, K, S), ub.reshape(K, S)
    ks = (torch.arange(K, dtype=F64, device=b.device) + 0.5)[:, None] ** 2
    outs = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(S, s0 + chunk))
        bb, cc, zz = (t[sl].to(F64) for t in (b, c, z))
        pos = bb > 0
        big = bb >= normal_above
        gam = pos & ~big
        b_safe = torch.where(gam, bb, 1.0)
        denom = ks + (cc / (2.0 * math.pi))[None] ** 2
        if g is not None:
            gk = g[:, sl].to(F64)
            near = torch.zeros(gk.shape, dtype=torch.bool, device=b.device)
            rounds = torch.zeros(gk.shape, dtype=torch.int32,
                                 device=b.device)
        else:
            gk, near, rounds = _mt64(
                b_safe.expand(K, -1), x[:, :, sl].to(F64),
                u[:, :, sl].to(F64), ub[:, sl].to(F64))
        terms = gk / denom / _TWO_PI_SQ
        mean_full = _pg_mean64(bb, cc)
        mean_trunc = b_safe * (1.0 / denom).sum(0) / _TWO_PI_SQ
        sd_z = zz * _pg_var64(bb, cc).sqrt()
        gamma_draw = terms.sum(0) + (mean_full - mean_trunc).clamp_min(0.0)
        omega = torch.where(pos, torch.where(
            big, (mean_full + sd_z).clamp_min(1e-12), gamma_draw), 0.0)
        scale = torch.where(big, mean_full.abs() + sd_z.abs(),
                            terms.abs().sum(0) + mean_full.abs()
                            + mean_trunc.abs())
        outs.append((omega, torch.where(pos, scale, 0.0),
                     near.any(0) & gam,
                     torch.where(gam, rounds.sum(0), 0)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def gap_eps(got, want, scale, ambiguous):
    """max |got - want| / scale over the lanes not ``ambiguous``, in
    float32 eps (a cell of scale 0, b <= 0, must match exactly)."""
    d = (got.reshape(-1).to(F64) - want.reshape(-1).to(F64)).abs()
    gap = d / scale.clamp_min(1e-300)
    keep = ~ambiguous
    return float(gap[keep].max()) / EPS32 if bool(keep.any()) else 0.0


def needed_bytes(b, rounds, normal_above=50.0, terms=16):
    """What a launch on the noise must move at least: b and c read and
    omega written at every cell, z read at every normal-branch cell, x and
    u of each round a lane runs (``rounds``, summed over a cell's terms,
    from :func:`reference64`) and ub of every term of a cell with 0 < b <
    1."""
    b = b.reshape(-1)
    big = int((b >= normal_above).sum())
    boosted = int(((b > 0) & (b < 1)).sum())
    return 12 * b.numel() + 4 * big + 8 * int(rounds.sum()) \
        + 4 * terms * boosted


def check_draw(got, b, c, z, noise=None, g=None, normal_above=50.0):
    """``got``, the kernel's draw on these inputs (the noise ``noise`` =
    (x, u, ub), or given gammas ``g``), against the plain version on the
    same inputs and device, and a second kernel launch against ``got`` bit
    for bit. Raises AssertionError past ``TOL_EPS``. Returns dict(err_eps,
    max_abs_err, ambiguous, ref_eps (the kernel against float64), cells,
    rounds (:func:`reference64`'s, a tensor))."""
    K = noise[0].shape[1] if g is None else g.shape[0]
    kw = dict(num_terms=K, normal_approx_above=normal_above, z=z, g=g,
              gamma_noise=noise)
    again = polya_gamma(None, b, c, **kw)
    plain = polya_gamma_plain(None, b, c, **kw)
    torch.cuda.synchronize()
    if not torch.equal(again, got):
        raise AssertionError("polya_gamma: two kernel launches on the same "
                             "inputs differ")
    want, scale, amb, rounds = reference64(b, c, z, noise, g, normal_above)
    err = gap_eps(got, plain, scale, amb)
    d = (got.reshape(-1).to(F64) - plain.reshape(-1).to(F64)).abs()
    if not err <= TOL_EPS:
        raise AssertionError(
            f"polya_gamma: kernel against plain {err:.2f} float32 eps of "
            f"the terms' magnitudes, {TOL_EPS} allowed")
    return dict(err_eps=err, max_abs_err=float(d[~amb].max()),
                ambiguous=int(amb.sum()), ref_eps=gap_eps(got, want, scale,
                                                          amb),
                cells=b.numel(), rounds=rounds)


def time_draw(b, c, z, noise, normal_above=50.0, rounds=None):
    """The kernel's device time per launch on the noise, the wrapper's
    host time, CUDA events around a call of the kernel and of the plain
    version, and the H100's bound by :func:`needed_bytes` (``rounds`` from
    :func:`reference64`, computed here when not given)."""
    K = noise[0].shape[1]
    kw = dict(num_terms=K, normal_approx_above=normal_above, z=z,
              gamma_noise=noise)

    def launch():
        return polya_gamma(None, b, c, **kw)

    host = FB.host_us(launch)
    ev = FB.event_ms(launch)
    plain = FB.event_ms(lambda: polya_gamma_plain(None, b, c, **kw), reps=5,
                        warm=1)
    dev_us, how = FB.device_us(launch, pattern="polya_gamma_kernel")
    if rounds is None:
        rounds = reference64(b, c, z, noise, None, normal_above)[3]
    nbytes = needed_bytes(b, rounds, normal_above, K)
    bound = nbytes / FB.H100["bytes_per_s"] * 1e6
    return dict(device_us=dev_us, timing=how, host_us=host, event_ms=ev,
                plain_ms=plain, bytes=nbytes, bound_us=bound,
                bound_by="bytes", pct_of_bound=100.0 * bound / dev_us)
