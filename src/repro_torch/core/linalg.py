"""Matmul-friendly linear algebra helpers used across the CCA core.

Port of ``repro/core/linalg.py``.  Everything is dense products plus
small (k̃ × k̃) factorizations; the large products here (``Yᵀ Y``,
``Y @ V``) are plain matrix products outside any data-pass kernel, so
they go to ``torch.matmul``.
"""

from __future__ import annotations

import torch


def sym(M: torch.Tensor) -> torch.Tensor:
    """Symmetrize (guards eigh/cholesky against matmul round-off skew)."""
    return 0.5 * (M + M.T)


def chol_psd(M: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of a (nearly) PSD matrix with optional
    diagonal jitter."""
    if jitter:
        M = M + jitter * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.linalg.cholesky(sym(M))


def tri_solve_right(Y: torch.Tensor, L: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """``Y @ inv(L)`` (or ``Y @ inv(L).T``) for lower-triangular L,
    without forming an inverse."""
    if not trans:
        return torch.linalg.solve_triangular(L, Y, upper=False, left=False)
    return torch.linalg.solve_triangular(L.T, Y, upper=True, left=False)


def _gram(M: torch.Tensor) -> torch.Tensor:
    return M.T @ M


def cholesky_qr(Y: torch.Tensor, jitter: float = 0.0, *,
                gram=_gram) -> tuple[torch.Tensor, torch.Tensor]:
    """One round of CholeskyQR: Q = Y L⁻ᵀ with L = chol(YᵀY); returns
    (Q, R) with R = Lᵀ, so Q R = Y and QᵀQ = I.  ``gram(Y)`` forms YᵀY
    (the sharded fit sums it over the ranks that hold Y's rows).

    The reference's code computes Y L⁻¹ (its docstring says Y L⁻ᵀ), which
    satisfies neither and only removes the first-order error of a Q with
    YᵀY ≈ I; the port computes what the docstring says.
    """
    L = chol_psd(sym(gram(Y)), jitter)
    return tri_solve_right(Y, L, trans=True), L.T


def eigh_whiten(Y: torch.Tensor, G: torch.Tensor, rel_eps: float = 1e-12) -> torch.Tensor:
    """Q = Y · V · w^{-1/2} from the eigendecomposition of the Gram G —
    a first orthonormalization round, in G's precision (at least f32)."""
    dt = torch.promote_types(G.dtype, torch.float32)
    w, V = torch.linalg.eigh(sym(G).to(dt))
    w = torch.clamp(w, min=rel_eps * torch.max(w))
    Q = Y.to(dt) @ V
    return Q.mul_(1.0 / torch.sqrt(w))  # in place: Q is a fresh (d, k̃) product


def orth(Y: torch.Tensor, *, gram=_gram) -> torch.Tensor:
    """Paper's ``orth``: an eigh-whitened first round plus one CholeskyQR
    cleanup round.  ``gram(M)`` forms MᵀM for both rounds (as in
    :func:`cholesky_qr`).

    Two departures from the reference, which breaks at Europarl width:
    power iteration squares κ(Y), and on the planted data κ(Y) reaches
    ~6e6 there.  The reference's f32 round then returns a Q with
    ‖QᵀQ − I‖ ~ 1e6, and its final-pass Cholesky fails.

    - The whitening round runs in float64.  Its error grows like u·κ²:
      ~0.02 in f64 at κ = 6e6, hopeless in f32.
    - The cleanup is a true CholeskyQR (see :func:`cholesky_qr`), which
      takes that 0.02 down to ~6e-7 in f32.

    Where the reference works, the two span the same range
    (tests/test_torch_linalg.py).  The result is row-major
    (``solve_triangular`` with ``left=False`` gives a column-major one),
    the layout the data-pass kernels take.
    """
    Y64 = Y.to(torch.float64)
    Q = eigh_whiten(Y64, gram(Y64)).to(torch.float32)
    del Y64  # 8.6 GB at Europarl width
    Q, _ = cholesky_qr(Q, 0.0, gram=gram)
    return Q.to(Y.dtype).contiguous()


def inv_sqrt_psd(M: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Symmetric inverse square root via eigh (small matrices only)."""
    w, V = torch.linalg.eigh(sym(M))
    w = torch.clamp(w, min=0.0) + eps
    return (V * (1.0 / torch.sqrt(w))) @ V.T


def topk_svd(F: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k SVD of a small dense matrix (paper line 22): (U, S, V)."""
    U, S, Vh = torch.linalg.svd(F, full_matrices=False)
    return U[:, :k], S[:k], Vh[:k, :].T
