"""Plain PyTorch versions of every kernel of the port.

Port of ``repro/kernels/ref.py``.  Each wrapper in this package takes
its plain version here for a CPU tensor; ``chip_smoke.py`` holds each
CUDA kernel against the same function on the card.  All products run
in f32, as the kernels do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .plan import ROWS_KSEG, rows_segments
from .rand import omega_tile

f32 = torch.float32


def proj_stage_ref(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = x · q in f32 (``_proj_stage_kernel``)."""
    return x.to(f32) @ q.to(f32)


def proj_stage_seeded_ref(x: torch.Tensor, seed, kt: int) -> torch.Tensor:
    """P = x · Ω(seed) in f32 (``_proj_stage_seeded_kernel``), Ω made by
    the plain generator (``rand.omega_tile``, the plain ``omega_fill``)
    on x's device in f32 and rounded once to x's dtype."""
    omega = omega_tile(seed, x.shape[1], kt, device=x.device)
    return proj_stage_ref(x, omega.to(x.dtype))


def powerpass_sweep_ref(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """ΔY = aᵀ · p in f32 (``_powerpass_sweep_kernel``)."""
    return a.to(f32).T @ p.to(f32)


def gram_sweep_ref(p: torch.Tensor) -> torch.Tensor:
    """C = pᵀ · p in f32 (``_gram_sweep_kernel``)."""
    p = p.to(f32)
    return p.T @ p


def matmul_nn_ref(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """O = x · q in f32 (``_mm_nn_kernel``)."""
    return x.to(f32) @ q.to(f32)


def project_rows_ref(x: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """O = x · X in f32 by the serving form's reduction (``project_rows``,
    ``csrc/gemm_rows.cu``): K cut into segments of :data:`~.plan.ROWS_KSEG`
    rows, one product per segment (torch's order inside it), the partials
    combined by :func:`segment_tree`."""
    x, X = x.to(f32), X.to(f32)
    (M, K), N = x.shape, X.shape[1]
    S = rows_segments(K)
    pad = S * ROWS_KSEG - K  # zero terms: each adds an exact 0 to its segment
    if pad:
        x, X = F.pad(x, (0, pad)), F.pad(X, (0, 0, 0, pad))
    parts = torch.bmm(x.reshape(M, S, ROWS_KSEG).transpose(0, 1), X.reshape(S, ROWS_KSEG, N))
    return segment_tree(parts)


def segment_tree(parts: torch.Tensor) -> torch.Tensor:
    """The serving form's tree over the S partials ``parts[0 .. S)``: padded
    with zeros to the least power of two P ≥ S, then added in pairs level by
    level (2m and 2m + 1 into m) until one is left.  Its shape depends on S
    only."""
    S = parts.shape[0]
    P = 1 << (S - 1).bit_length()
    if P > S:
        parts = torch.cat([parts, parts.new_zeros((P - S, *parts.shape[1:]))])
    while parts.shape[0] > 1:
        parts = parts[0::2] + parts[1::2]
    return parts[0]


def matmul_tn_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """O = xᵀ · y in f32 (``_mm_tn_kernel``)."""
    return x.to(f32).T @ y.to(f32)


def projgram_ref(x: torch.Tensor, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, PᵀP) with P = x · q in f32 (``_projgram_kernel``)."""
    p = proj_stage_ref(x, q)
    return p, gram_sweep_ref(p)


def projgram_seeded_ref(x: torch.Tensor, seed, kt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, PᵀP) with P = x · Ω(seed) (``_projgram_seeded_kernel``)."""
    p = proj_stage_seeded_ref(x, seed, kt)
    return p, gram_sweep_ref(p)


def power_project_accumulate_ref(a: torch.Tensor, b: torch.Tensor,
                                 q: torch.Tensor) -> torch.Tensor:
    """ΔY = aᵀ (b · q) in f32 (``_powerpass_kernel``)."""
    return powerpass_sweep_ref(a, proj_stage_ref(b, q))


def power_project_accumulate_seeded_ref(a: torch.Tensor, b: torch.Tensor, seed,
                                        kt: int) -> torch.Tensor:
    """ΔY = aᵀ (b · Ω(seed)) in f32 (``_powerpass_seeded_kernel``)."""
    return powerpass_sweep_ref(a, proj_stage_seeded_ref(b, seed, kt))


def power_pass_ref(a, b, Qa, Qb):
    """One chunk of the range-finder pass: (ΔYa, ΔYb)."""
    pb = proj_stage_ref(b, Qb)
    pa = proj_stage_ref(a, Qa)
    return powerpass_sweep_ref(a, pb), powerpass_sweep_ref(b, pa)


def final_pass_ref(a, b, Qa, Qb):
    """One chunk of the final pass: (ΔCa, ΔCb, ΔF)."""
    pa = proj_stage_ref(a, Qa)
    pb = proj_stage_ref(b, Qb)
    return gram_sweep_ref(pa), gram_sweep_ref(pb), matmul_tn_ref(pa, pb)
