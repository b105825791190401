"""Batched Gaussian draws in precision form.

Counterpart of functionalmf_tpu/ops/mvn.py:41-149. ``torch.linalg``'s
Cholesky and triangular solves do the factorisations, as XLA did them
outside any Pallas kernel in the JAX package.

The jitter ladder of ``cholesky_psd`` factors once with
``cholesky_ex``; only when some batch member failed (one host sync per
call) does it re-factor with growing diagonal jitter, and then only the
failed members take the new factor.
"""
from __future__ import annotations

import torch

__all__ = ["cholesky_psd", "_solve_lt", "_cho_solve",
           "sample_mvn_from_precision"]


def cholesky_psd(Q, eps: float = 1e-6, attempts: int = 4):
    """Lower Cholesky factor of symmetric Q (..., D, D), adding
    eps * 100^a to the diagonal for the smallest a in {none, 0, ...,
    attempts-1} that factors. Members that never factor come back with a
    NaN lower triangle, as the JAX package's do, so callers see NaNs
    downstream."""
    Q = 0.5 * (Q + Q.mT)       # jnp.linalg.cholesky symmetrises its input
    L, info = torch.linalg.cholesky_ex(Q)
    bad = (info != 0) | ~torch.isfinite(L).all(dim=(-2, -1))
    if attempts > 0 and bool(bad.any()):
        eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
        for a in range(attempts):
            Lr, info_r = torch.linalg.cholesky_ex(Q + (eps * 100.0 ** a) * eye)
            L = torch.where(bad[..., None, None], Lr, L)
            bad = bad & ((info_r != 0)
                         | ~torch.isfinite(Lr).all(dim=(-2, -1)))
    return torch.where(bad[..., None, None], torch.nan, L).tril()


def _solve_lt(L, z):
    """Solve L^T x = z for lower-triangular L (batched)."""
    x = torch.linalg.solve_triangular(L.mT, z[..., None], upper=True)
    return x[..., 0]


def _cho_solve(L, b):
    """Solve (L L^T) x = b (batched)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def sample_mvn_from_precision(gen, Q, mu=None, mu_part=None,
                              chol_factor: bool = False,
                              force_psd: bool = True,
                              force_psd_eps: float = 1e-6,
                              force_psd_attempts: int = 4,
                              equilibrate: bool = False, z=None):
    """theta ~ N(Q^-1 mu_part (or mu), Q^-1) for a (..., D, D) precision
    stack: x = L^-T z (+ the mean term), L L^T = Q.

    ``z`` (..., D) injects the standard-normal draw; otherwise it comes
    from ``gen``. ``equilibrate`` factors D Q D, D = diag(Q)^-1/2, and
    returns D x' (exact; keeps float32 factorisations well scaled).
    """
    if equilibrate and not chol_factor:
        d = torch.diagonal(Q, dim1=-2, dim2=-1)
        dinv = torch.rsqrt(torch.where(d > 0, d, torch.ones_like(d)))
        Qe = Q * dinv[..., :, None] * dinv[..., None, :]
        mp = None if mu_part is None else mu_part * dinv
        mq = None if mu is None else mu / dinv
        x = sample_mvn_from_precision(
            gen, Qe, mu=mq, mu_part=mp, force_psd=force_psd,
            force_psd_eps=force_psd_eps,
            force_psd_attempts=force_psd_attempts, z=z)
        return x * dinv
    if chol_factor:
        L = Q
    else:
        L = cholesky_psd(Q, eps=force_psd_eps,
                         attempts=force_psd_attempts if force_psd else 0)
    if z is None:
        z = torch.randn(L.shape[:-1], generator=gen, dtype=L.dtype,
                        device=L.device)
    x = _solve_lt(L, z)
    if mu_part is not None:
        x = x + _cho_solve(L, mu_part)
    elif mu is not None:
        x = x + mu
    return x
