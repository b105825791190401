"""Batched Gaussian draws in precision and covariance form.

Counterpart of functionalmf_tpu/ops/mvn.py. ``torch.linalg``'s
Cholesky and triangular solves do the factorisations, as XLA did them
outside any Pallas kernel in the JAX package.

The jitter ladder of ``cholesky_psd`` factors once with
``cholesky_ex``; only when some batch member failed (one host sync per
call) does it re-factor with growing diagonal jitter, and then only the
failed members take the new factor.
"""
from __future__ import annotations

import torch

from functionalmf_tpu_torch.utils import telemetry

__all__ = ["cholesky_psd", "_solve_lt", "_cho_solve",
           "sample_mvn_from_precision", "sample_mvn_from_covariance",
           "sample_mvn"]


def cholesky_psd(Q, eps: float = 1e-6, attempts: int = 4):
    """Lower Cholesky factor of symmetric Q (..., D, D), adding
    eps * 100^a to the diagonal for the smallest a in {none, 0, ...,
    attempts-1} that factors. Members that never factor come back with a
    NaN lower triangle, as the JAX package's do, so callers see NaNs
    downstream."""
    Q = 0.5 * (Q + Q.mT)       # jnp.linalg.cholesky symmetrises its input
    L, info = torch.linalg.cholesky_ex(Q)
    bad = (info != 0) | ~torch.isfinite(L).all(dim=(-2, -1))
    if attempts > 0:
        telemetry.count("sync:cholesky_psd")
        if bool(bad.any()):
            telemetry.count("cholesky_retries")
            eye = torch.eye(Q.shape[-1], dtype=Q.dtype, device=Q.device)
            for a in range(attempts):
                Lr, info_r = torch.linalg.cholesky_ex(
                    Q + (eps * 100.0 ** a) * eye)
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


def sample_mvn_from_covariance(gen, S, mu=None, mu_part=None,
                               chol_factor: bool = False,
                               force_psd: bool = True,
                               force_psd_eps: float = 1e-6,
                               force_psd_attempts: int = 4, z=None):
    """theta ~ N(mu (or S mu_part), S) for a (..., D, D) covariance
    stack: x = L z (+ the mean term), L L^T = S. ``chol_factor`` means S
    is already that factor; ``z`` (..., D) injects the standard-normal
    draw."""
    if chol_factor:
        L = S
        S_full = L @ L.mT
    else:
        L = cholesky_psd(S, eps=force_psd_eps,
                         attempts=force_psd_attempts if force_psd else 0)
        S_full = S
    if z is None:
        z = torch.randn(L.shape[:-1], generator=gen, dtype=L.dtype,
                        device=L.device)
    x = torch.einsum("...ij,...j->...i", L, z)
    if mu_part is not None:
        x = x + torch.einsum("...ij,...j->...i", S_full, mu_part)
    elif mu is not None:
        x = x + mu
    return x


def sample_mvn(gen, Q, mu=None, mu_part=None, precision: bool = False,
               chol_factor: bool = False, **kwargs):
    """Dispatch on ``precision``. A scalar or vector Q is promoted to
    Q * I, its dimension taken from mu or mu_part."""
    Q = torch.as_tensor(Q)
    if not chol_factor and Q.dim() <= 1:
        ref = mu if mu is not None else mu_part
        if ref is None:
            raise ValueError(
                "scalar/vector Q requires mu or mu_part for the dimension")
        ref = torch.as_tensor(ref)
        Q = torch.eye(ref.shape[-1], dtype=torch.float32,
                      device=ref.device) * Q.to(torch.float32).to(ref.device)
    fn = sample_mvn_from_precision if precision else \
        sample_mvn_from_covariance
    return fn(gen, Q, mu=mu, mu_part=mu_part, chol_factor=chol_factor,
              **kwargs)
