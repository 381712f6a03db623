"""The staged power-pass products: stage P = X·Q, then sweep ΔY = AᵀP.

Port of the staged schedule of ``repro/kernels/powerpass.py``, the one
the reference's own schedule rule picks at Europarl width:

- :func:`proj_stage` — P = X·Q in f32, the port of ``_proj_stage_kernel``;
- :func:`powerpass_sweep` — ΔY = Aᵀ·P, the port of
  ``_powerpass_sweep_kernel``;
- :func:`power_project_accumulate` — stage then sweep, as ``_staged_call``;
- :func:`proj_stage_seeded` — P = X·Ω(seed), the port of
  ``_proj_stage_seeded_kernel``: Ω is made on the card in K-slabs of
  4096 rows, each contracted as it is made, so no (d, k̃) Ω exists;
- :func:`power_project_accumulate_seeded` — seeded stage then sweep.

The TPU kernels bucket ΔY's rows to fit VMEM and keep P padded to 128
between the phases.  Here each phase is one CUDA launch over an
(output tiles) grid that contracts its whole K range inside a block, and
P is the exact (n, k̃) f32 tensor: nothing is padded.
"""

from __future__ import annotations

import torch

from . import ref
from .matmul import gemm_nn, gemm_nn_seeded, gemm_tn, on_cpu


def proj_stage(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = x·q in f32.  x: (n, d), q: (d, k̃) → (n, k̃)."""
    if on_cpu(x, q):
        return ref.proj_stage_ref(x, q)
    return gemm_nn("proj_stage", x, q)


def powerpass_sweep(a: torch.Tensor, p: torch.Tensor, *,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """ΔY = aᵀ·p in f32.  a: (n, da), p: (n, k̃) → (da, k̃).

    With ``out`` (a (da, k̃) f32 accumulator) the kernel adds ΔY into
    ``out`` in place, after the full contraction — the same rounding as
    ``out + ΔY`` — and returns ``out``.  At Europarl width that saves a
    4.3 GB ΔY temporary per view and chunk.
    """
    if on_cpu(a, p, *(() if out is None else (out,))):
        dY = ref.powerpass_sweep_ref(a, p)
        return dY if out is None else out.add_(dY)
    return gemm_tn("powerpass_sweep", a, p, out)


def power_project_accumulate(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor, *,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """ΔY = aᵀ(b·q): stage P = b·q once, then sweep (2 launches)."""
    return powerpass_sweep(a, proj_stage(b, q), out=out)


def proj_stage_seeded(x: torch.Tensor, seed, kt: int) -> torch.Tensor:
    """P = x·Ω(seed) in f32.  x: (n, d), seed: the view's two uint32
    words → (n, k̃).  On the card, bitwise ``proj_stage(x,
    omega_fill(seed, d, kt))``: the slabs continue each element's FMA
    chain, so its order is the materialized product's.  One entry-point
    launch issues 2·⌈d / ``matmul.SEEDED_SLAB``⌉ CUDA launches."""
    if on_cpu(x):
        return ref.proj_stage_seeded_ref(x, seed, kt)
    return gemm_nn_seeded("proj_stage_seeded", x, seed, kt)


def power_project_accumulate_seeded(a: torch.Tensor, b: torch.Tensor, seed, kt: int, *,
                                    out: torch.Tensor | None = None) -> torch.Tensor:
    """ΔY = aᵀ(b·Ω(seed)): seeded stage, then sweep (2 launches)."""
    return powerpass_sweep(a, proj_stage_seeded(b, seed, kt), out=out)
