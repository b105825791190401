"""Polya-Gamma sampler: plain PyTorch, and one CUDA kernel on the card.

Counterpart of functionalmf_tpu/ops/polyagamma.py:38-132. Truncated
sum-of-gammas representation with an exact tail-mean correction: PG(b, c)
is an infinite convolution (Polson, Scott & Windle 2013, eq. 3)

    omega = (1 / (2 pi^2)) sum_{k>=1} g_k / ((k - 1/2)^2 + c^2 / (4 pi^2)),
    g_k ~ Gamma(b, 1) independent.

The first ``num_terms`` terms are drawn and the expected value of the
discarded tail is added, in closed form from E[PG(b, c)] = b / (2c)
tanh(c / 2). So the mean is exact for every (b, c) and the variance is
short by the tail's, which decays like sum_{k>K} k^-4. The shapes do not
depend on the data and the gamma draw is one batched call.

Routing: CPU tensors take the plain version, ``polya_gamma_plain``. CUDA
float32 tensors launch the kernel of ``csrc/polyagamma.cu`` (one thread a
cell: the Marsaglia-Tsang rounds, the terms' sum and the tail mean in
registers, on the same noise, drawn here in the same order), or raise;
there is no fallback on the card. A tensor of another dtype, tensors on
two devices or a device of another type raise. Every kernel launch adds
one to ``launch_counts``.
"""
from __future__ import annotations

import math

import torch

from functionalmf_tpu_torch.ops.gamma import draw_gamma_mt_noise, gamma_mt

__all__ = ["polya_gamma", "polya_gamma_plain", "pg_mean", "pg_var",
           "launch_counts", "reset_launch_counts"]

_TWO_PI_SQ = 2.0 * math.pi ** 2

# kernel launches: the Marsaglia-Tsang rounds on the noise, and the
# variant that reads given gamma draws
launch_counts = {"polya_gamma": 0, "polya_gamma_g": 0}
_ROUNDS = 6       # the Marsaglia-Tsang rounds gamma_mt runs on given noise


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def _tanh_half_over(c):
    """tanh(c/2) / c with the c -> 0 limit (1/2); a series on |c/2| <
    0.05, where the direct ratio loses accuracy in float32."""
    x = 0.5 * c
    x2 = x * x
    small = x.abs() < 0.05
    safe = torch.where(small, 1.0, x)
    ratio = torch.where(small, 1.0 - x2 / 3.0 + 2.0 * x2 * x2 / 15.0,
                        torch.tanh(safe) / safe)
    return 0.5 * ratio


def pg_mean(b, c):
    """E[PG(b, c)] = b / (2 c) tanh(c / 2), with the c -> 0 limit b/4."""
    return 0.5 * b * _tanh_half_over(torch.as_tensor(c))


def pg_var(b, c):
    """Var[PG(b, c)] = b / (4 c^3) (sinh(c) - c) sech^2(c / 2).

    sinh(c) - c cancels for small |c|: in float32 the direct form loses
    every significant bit below |c| ~ 0.01 and can come out negative,
    which would put sqrt(<0) = NaN into the normal branch of
    ``polya_gamma``. So the series (sinh c - c) / c^3 = (1/6)(1 + c^2/20
    + c^4/840 + ...) serves |c| < 0.5 (truncation error below 3e-7
    relative there), and the result is clamped at 0.
    """
    c = torch.as_tensor(c)
    c2 = c * c
    small = c.abs() < 0.5
    safe = torch.where(small, 1.0, c)
    series = (1.0 + c2 / 20.0 + c2 * c2 / 840.0) / 24.0
    direct = (torch.sinh(safe) - safe) / (4.0 * safe ** 3)
    v = torch.where(small, series, direct) / torch.cosh(c / 2.0) ** 2
    return torch.clamp(b * v, min=0.0)


def polya_gamma(gen, b, c, num_terms: int = 16, use_mt: bool = True,
                normal_approx_above: float = 50.0, g=None, z=None,
                gamma_noise=None):
    """Draw omega ~ PG(b, c), elementwise over broadcast(b, c).

    b: any nonnegative real (b = 0 gives exactly 0, used for missing
    cells); c: any real. Cells with b >= ``normal_approx_above`` take the
    moment-matched normal instead (PG(b, c) is a sum of b PG(1, c)
    variables; ``math.inf`` forces the gamma sum everywhere). ``use_mt``
    picks the fixed-round Marsaglia-Tsang gamma sampler (ops/gamma.py)
    over ``torch._standard_gamma``.

    From ``gen`` the gammas are drawn first, then the normals. ``g``
    ((num_terms,) + shape, Gamma(b_safe, 1) draws, b_safe = b where 0 < b
    < normal_approx_above, else 1) and ``z`` (shape) inject them;
    ``gamma_noise`` injects the Marsaglia-Tsang sampler's own draws
    (``ops/gamma.py:draw_gamma_mt_noise`` at (num_terms,) + shape).

    Tensor arguments are float32, on the CPU (the plain version) or on one
    CUDA device (the kernel); numbers and arrays join them there.
    """
    noise = tuple(gamma_noise) if gamma_noise is not None else ()
    given = {nm: t for nm, t in (("b", b), ("c", c), ("g", g), ("z", z),
                                 *zip(("x", "u", "ub"), noise))
             if torch.is_tensor(t)}
    if _on_card(given):
        return _polya_gamma_card(gen, b, c, num_terms, use_mt,
                                 normal_approx_above, g, z, noise)
    return polya_gamma_plain(gen, b, c, num_terms, use_mt,
                             normal_approx_above, g, z, gamma_noise)


def polya_gamma_plain(gen, b, c, num_terms: int = 16, use_mt: bool = True,
                      normal_approx_above: float = 50.0, g=None, z=None,
                      gamma_noise=None):
    """``polya_gamma`` in plain PyTorch, on any device: the CPU's path,
    and on a card the yardstick the kernel is compared and timed with."""
    b = torch.as_tensor(b, dtype=torch.float32)
    c = torch.as_tensor(c, dtype=torch.float32, device=b.device)
    b, c = torch.broadcast_tensors(b, c)
    shape = tuple(b.shape)

    pos = b > 0
    big = b >= normal_approx_above
    b_safe = torch.where(pos & ~big, b, 1.0)  # no gamma work for big b

    ks = (torch.arange(num_terms, dtype=b.dtype, device=b.device)
          + 0.5) ** 2
    denom = ks.reshape((num_terms,) + (1,) * len(shape)) \
        + (c / (2.0 * math.pi)) ** 2

    if g is None:
        if use_mt:
            g = gamma_mt(gen, b_safe, shape=(num_terms,) + shape,
                         noise=gamma_noise)
        else:
            g = torch._standard_gamma(
                b_safe.expand((num_terms,) + shape).contiguous(),
                generator=gen)
    # the terms summed along a contiguous last axis: an element's sum is
    # then the same whatever the batch's shape (a mesh rank's chains)
    trunc = (g / denom).movedim(0, -1).contiguous().sum(-1) / _TWO_PI_SQ

    mean_full = pg_mean(b, c)
    mean_trunc = (b_safe * (1.0 / denom).movedim(0, -1).contiguous().sum(-1)
                  / _TWO_PI_SQ)
    tail = torch.clamp(mean_full - mean_trunc, min=0.0)
    gamma_draw = trunc + tail

    if z is None:
        z = torch.randn(shape, generator=gen, dtype=b.dtype, device=b.device)
    normal_draw = torch.clamp(mean_full + z * torch.sqrt(pg_var(b, c)),
                              min=1e-12)
    return torch.where(pos, torch.where(big, normal_draw, gamma_draw), 0.0)


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------
def _on_card(tensors):
    """False for CPU tensors (or none), True for CUDA tensors; TypeError
    for a tensor that is not float32, ValueError for two devices or a
    device of another type."""
    devs = {t.device for t in tensors.values()}
    for nm, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"polya_gamma: {nm} must be float32, got "
                            f"{t.dtype}")
    if len(devs) > 1:
        raise ValueError("polya_gamma: tensors on several devices: "
                         + ", ".join(f"{nm} on {t.device}"
                                     for nm, t in tensors.items()))
    if not devs or next(iter(devs)).type == "cpu":
        return False
    if next(iter(devs)).type != "cuda":
        raise ValueError(f"no polya_gamma path for device {devs.pop()}")
    return True


def _cells(t, lead, shape, name):
    """``t`` at (lead) + shape, contiguous, or ValueError."""
    want = tuple(lead) + tuple(shape)
    if tuple(t.shape) != want:
        raise ValueError(f"polya_gamma: {name} has shape {tuple(t.shape)}, "
                         f"expected {want}")
    return t.contiguous()


def _polya_gamma_card(gen, b, c, num_terms, use_mt, normal_above, g, z,
                      noise):
    """``polya_gamma`` on a CUDA device: the noise drawn as the plain
    version draws it (gammas, then normals, from ``gen``), then one
    launch of ``fmf_polya_gamma``."""
    dev = next(t.device for t in (b, c, g, z, *noise) if torch.is_tensor(t))
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)
    b, c = torch.broadcast_tensors(b, c)
    shape = tuple(b.shape)
    K = int(num_terms)
    if g is None and use_mt and not noise:
        noise = draw_gamma_mt_noise(gen, (K,) + shape, device=dev)
    elif g is None and not use_mt:
        b_safe = torch.where((b > 0) & (b < normal_above), b, 1.0)
        g = torch._standard_gamma(b_safe.expand((K,) + shape).contiguous(),
                                  generator=gen)
    if z is None:
        z = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    z = z.expand(shape).contiguous()
    if g is not None:
        g = _cells(g, (K,), shape, "g")
        x = u = ub = None
        rounds, name = 0, "polya_gamma_g"
    else:
        x, u, ub = noise
        rounds, name = _ROUNDS, "polya_gamma"
        x = _cells(x, (rounds, K), shape, "gamma_noise x")
        u = _cells(u, (rounds, K), shape, "gamma_noise u")
        ub = _cells(ub, (K,), shape, "gamma_noise ub")
    b, c = b.contiguous(), c.contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    from functionalmf_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fmf_polya_gamma(
            b.data_ptr(), c.data_ptr(), z.data_ptr(), ptr(x), ptr(u),
            ptr(ub), ptr(g), out.data_ptr(), out.numel(), K, rounds,
            float(normal_above), stream)
    if code != 0:
        msg = lib.fmf_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
    launch_counts[name] += 1
    return out
