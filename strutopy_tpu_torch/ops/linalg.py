"""Positive-definite repair and Cholesky helpers (twin of
``strutopy_tpu/ops/linalg.py:46-87, 229-244``).

The reference repairs a non-PD matrix with a ladder: plain Cholesky,
then the diagonal-dominance repair ``make_pd``, then that plus a 1e-5
jitter.  ``torch.linalg.cholesky_ex`` reports a failed factorization in
``info`` and may leave finite garbage in the factor, so every rung is
chosen by ``info == 0`` (and a finite factor, which is what the JAX
ladder tests: JAX fills a failed factor with NaN).

All products here are true float32: the package's entry points turn TF32
off while they run (``utils/precision.py``), the counterpart of the JAX
package's ``Precision.HIGH``.

The JAX package's ``blocked_cholesky``, ``tri_lower_inverse`` and
``_ns_inverse`` are not ported: they rebuild the factorization from
matrix products because the TPU compiler lowers a Cholesky to a slow
sequential loop.  The SPD factor is unique, so ``torch.linalg`` gives the
same result to float32 rounding.
"""

from __future__ import annotations

import torch


def make_pd(M: torch.Tensor) -> torch.Tensor:
    """Force diagonal dominance on a (..., P, P) matrix (reference
    make_pd): each diagonal entry becomes the sum of the absolute
    off-diagonal entries of its row whenever it is smaller."""
    dvec = torch.diagonal(M, dim1=-2, dim2=-1)
    mag = torch.sum(torch.abs(M), dim=-1) - torch.abs(dvec)
    new_d = torch.maximum(dvec, mag)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M * (1.0 - eye) + new_d[..., :, None] * eye


def cholesky_checked(M: torch.Tensor):
    """(lower factor, ok) of a (..., P, P) matrix, with ok = info == 0
    and every entry finite."""
    L, info = torch.linalg.cholesky_ex(M)
    ok = (info == 0) & torch.isfinite(L).flatten(-2).all(-1)
    return L, ok


def chol_pd(H: torch.Tensor, jitter: float = 1e-5) -> torch.Tensor:
    """Cholesky of one (P, P) matrix with the reference's 3-rung ladder."""
    L1, ok1 = cholesky_checked(H)
    if bool(ok1):
        return L1
    H2 = make_pd(H)
    L2, ok2 = cholesky_checked(H2)
    if bool(ok2):
        return L2
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    L3, ok3 = cholesky_checked(H2 + jitter * eye)
    # the JAX ladder returns the NaN-filled rung-3 factor when every
    # rung fails; keep that so a non-PD sigma shows up as a NaN bound
    return L3 if bool(ok3) else torch.full_like(L3, float("nan"))


def cho_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse from a lower Cholesky factor, ``(L Lᵀ)⁻¹``, batched over
    leading axes.  This is the reference's optimize_nu: nu is the inverse
    of the (repaired) Hessian."""
    return torch.cholesky_inverse(L)


def precompute_sigma(sigma: torch.Tensor, jitter: float = 1e-5):
    """Per-EM-iteration sigma factorization.

    Returns ``(siginv, sigmaentropy)``: the true inverse of sigma
    (symmetrized) and ``sum(log(diag(chol(sigma))))``.
    """
    L = chol_pd(sigma, jitter=jitter)
    sigmaentropy = torch.sum(torch.log(torch.diagonal(L)))
    siginv = cho_inverse(L)
    # symmetrize; LAPACK hands back column-major strides, and the stage
    # kernels take row-major contiguous input
    siginv = (0.5 * (siginv + siginv.T)).contiguous()
    return siginv, sigmaentropy
