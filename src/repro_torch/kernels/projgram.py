"""The staged final-pass products: stage P = X·Q, then C = PᵀP.

Port of the staged schedule of ``repro/kernels/projgram.py``:

- :func:`gram_sweep` — C = Pᵀ·P in f32, the port of ``_gram_sweep_kernel``
  (the TN kernel with both operands P);
- :func:`projgram` — stage then Gram, returning (P, C), as
  ``_staged_gram_call``; P is kept because the cross term F needs it;
- :func:`projgram_seeded` — the same with the seeded stage.
"""

from __future__ import annotations

import torch

from . import ref
from .matmul import gemm_tn, on_cpu
from .powerpass import proj_stage, proj_stage_seeded


def gram_sweep(p: torch.Tensor) -> torch.Tensor:
    """C = pᵀ·p in f32.  p: (n, k̃) → (k̃, k̃)."""
    if on_cpu(p):
        return ref.gram_sweep_ref(p)
    return gemm_tn("gram_sweep", p, p)


def projgram(x: torch.Tensor, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, C) = (x·q, (x·q)ᵀ(x·q)) in f32 (2 launches)."""
    p = proj_stage(x, q)
    return p, gram_sweep(p)


def projgram_seeded(x: torch.Tensor, seed, kt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, C) with P = x·Ω(seed) (2 launches)."""
    p = proj_stage_seeded(x, seed, kt)
    return p, gram_sweep(p)
