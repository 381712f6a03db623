"""Plain PyTorch versions of every kernel of the port.

Port of ``repro/kernels/ref.py``.  Each wrapper in this package takes
its plain version here for a CPU tensor; ``chip_smoke.py`` holds each
CUDA kernel against the same function on the card.  All products run
in f32, as the kernels do.
"""

from __future__ import annotations

import torch

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
