"""What the numbers of ``correct`` share: a draw's constraint
violation, an answer's gap, and the roundings that the control puts in the
program's place.

* ``constraint_violation``: the largest amount by which a draw's curve
  ``tau = W V^T`` breaks a constraint ``A tau >= c``; a non-finite draw
  reads infinity.
* ``item_gaps``: the widest gap between the program's candidate
  log-likelihood and the reference's, as a share of what bounds its
  rounding (plus 1, so that an item of no cells reads its absolute gap).
* ``tf32``, ``bf16``: a float32 tensor rounded to the nearest TF32
  (10-bit mantissa: a TF32 matrix product's inputs) or bfloat16 value,
  kept in float32.
"""
import numpy as np
import torch


def constraint_violation(W, V, A, c, device="cpu", block=64):
    """max over draws, rows, columns and constraints of c - A tau (at
    least 0), in float64 on ``device``. W (S, n, k), V (S, m, T, k), A
    (J, T), c (J,)."""
    f64 = dict(dtype=torch.float64, device=device)
    A, c = torch.as_tensor(A, **f64), torch.as_tensor(c, **f64)
    worst = 0.0
    for s in range(0, W.shape[0], block):
        w = torch.as_tensor(W[s:s + block], **f64)
        v = torch.as_tensor(V[s:s + block], **f64)
        if not (torch.isfinite(w).all() and torch.isfinite(v).all()):
            return float("inf")
        tau = torch.einsum("snk,smtk->snmt", w, v)
        worst = max(worst, float((c - tau @ A.T).max()))
    return max(worst, 0.0)


def item_gaps(prog, ref, scale):
    """Each item's widest gap over its candidates: |prog - ref| / (scale +
    1), prog (S, G) in the program's dtype, ref and scale float64; a
    non-finite answer reads infinity."""
    g = (prog.to(torch.float64) - ref).abs() / (scale + 1.0)
    g = torch.where(torch.isfinite(g), g, torch.full_like(g, np.inf))
    return g.amax(-1)


def tf32(x):
    """x (float32) rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def bf16(x):
    return x.to(torch.bfloat16).float()


LOWP = {"tf32": tf32, "bf16": bf16}
