"""Exact (dense) regularized CCA — test oracle.

Port of ``repro/core/exact.py``: solves the paper's eq. (1)-(2) by
whitening + SVD,

    maximize Tr(Xaᵀ AᵀB Xb)
    s.t. Xaᵀ (AᵀA + λa I) Xa = n I,   Xbᵀ (BᵀB + λb I) Xb = n I.

Cost O(n·d² + d³): test scale only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .linalg import inv_sqrt_psd, sym, topk_svd


class CCASolution(NamedTuple):
    Xa: torch.Tensor  # (da, k)
    Xb: torch.Tensor  # (db, k)
    rho: torch.Tensor  # (k,) canonical correlations


def center(M: torch.Tensor) -> torch.Tensor:
    return M - M.mean(dim=0, keepdim=True)


def exact_cca(A: torch.Tensor, B: torch.Tensor, k: int, lam_a: float = 0.0,
              lam_b: float = 0.0, *, do_center: bool = False) -> CCASolution:
    n = A.shape[0]
    if do_center:
        A, B = center(A), center(B)
    da, db = A.shape[1], B.shape[1]
    Ca = sym(A.T @ A) + lam_a * torch.eye(da, dtype=A.dtype, device=A.device)
    Cb = sym(B.T @ B) + lam_b * torch.eye(db, dtype=B.dtype, device=B.device)
    Wa, Wb = inv_sqrt_psd(Ca), inv_sqrt_psd(Cb)
    U, S, V = topk_svd(Wa @ (A.T @ B) @ Wb, k)
    sqn = math.sqrt(n)
    return CCASolution(Xa=sqn * (Wa @ U), Xb=sqn * (Wb @ V), rho=S)


def cca_objective(A: torch.Tensor, B: torch.Tensor, Xa: torch.Tensor,
                  Xb: torch.Tensor) -> torch.Tensor:
    """(1/n) Tr(Xaᵀ AᵀB Xb) — the quantity in paper Fig. 2a / Table 2b."""
    return torch.trace((A @ Xa).T @ (B @ Xb)) / A.shape[0]


def feasibility_errors(A: torch.Tensor, B: torch.Tensor, Xa: torch.Tensor,
                       Xb: torch.Tensor, lam_a: float = 0.0,
                       lam_b: float = 0.0) -> dict[str, torch.Tensor]:
    """Constraint residuals: (regularized) identity covariance and a
    diagonal cross-covariance."""
    n = A.shape[0]
    Ia = Xa.T @ (A.T @ (A @ Xa)) + lam_a * (Xa.T @ Xa)
    Ib = Xb.T @ (B.T @ (B @ Xb)) + lam_b * (Xb.T @ Xb)
    C = Xa.T @ (A.T @ (B @ Xb)) / n
    eye = torch.eye(Xa.shape[1], dtype=Xa.dtype, device=Xa.device)
    offdiag = C - torch.diag(torch.diagonal(C))
    return {
        "cov_a": torch.max(torch.abs(Ia / n - eye)),
        "cov_b": torch.max(torch.abs(Ib / n - eye)),
        "crosscov_offdiag": torch.max(torch.abs(offdiag)),
    }
