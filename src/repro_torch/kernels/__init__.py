"""Hand-written CUDA kernels of the port, with their plain versions.

Twelve entry points, one launch counter per operand form, over the CUDA
kernels in ``csrc/gemm_f32.cu``, ``csrc/gemm_bf16.cu``,
``csrc/recompute_f32.cu`` (on the tiles of ``csrc/gemm_ring.cuh`` and
``csrc/gemm_bf16.cuh``), ``csrc/gemm_rows.cu`` and ``csrc/rand.cuh``:

===============================  ============================================
entry point                      replaces (JAX package)
===============================  ============================================
proj_stage                       kernels/powerpass.py ``_proj_stage_kernel``
powerpass_sweep                  kernels/powerpass.py ``_powerpass_sweep_kernel``
gram_sweep                       kernels/projgram.py ``_gram_sweep_kernel``
matmul_tn                        kernels/matmul.py ``_mm_tn_kernel``
matmul_nn                        kernels/matmul.py ``_mm_nn_kernel``
project_rows (serving)           serve/projector.py's XLA ``x @ X`` (no
                                 Pallas kernel): split-K, its bits fixed by K
omega_fill                       kernels/rand.py ``normal_tile``
proj_stage_seeded                kernels/powerpass.py ``_proj_stage_seeded_kernel``
projgram (recompute)             kernels/projgram.py ``_projgram_kernel``
projgram_seeded (recompute)      kernels/projgram.py ``_projgram_seeded_kernel``
power_project_accumulate         kernels/powerpass.py ``_powerpass_kernel``
(recompute)
power_project_accumulate_seeded  kernels/powerpass.py ``_powerpass_seeded_kernel``
(recompute)
===============================  ============================================

Under the staged schedule the fused entry points launch the staged pair
and count there; :mod:`.plan` and the ``choose_*_schedule`` rules decide.
Every entry point but ``project_rows`` (f32: serving casts to f32) also
takes bf16 operands (f32 accumulation and output), counted as e.g.
``proj_stage[bf16]`` or ``powerpass_sweep[bf16,f32]``; the seeded ones and ``omega_fill`` then
make Ω in f32 and round it once to bf16 (``proj_stage_seeded[bf16]``,
``omega_fill[bf16]``).  :data:`.matmul.FORMS` lists every form.
"""

from .matmul import matmul_nn, matmul_tn, project_rows
from .ops import (chunk_cost, final_pass_chunk, final_pass_chunk_seeded, launch_counts,
                  power_pass_chunk, power_pass_chunk_seeded, reset_launch_counts)
from .powerpass import (choose_powerpass_schedule, power_project_accumulate,
                        power_project_accumulate_seeded, powerpass_sweep, proj_stage,
                        proj_stage_seeded)
from .projgram import choose_projgram_schedule, gram_sweep, projgram, projgram_seeded
from .rand import dense_omega, omega_fill, omega_seeds

__all__ = [
    "choose_powerpass_schedule",
    "choose_projgram_schedule",
    "chunk_cost",
    "dense_omega",
    "final_pass_chunk",
    "final_pass_chunk_seeded",
    "gram_sweep",
    "launch_counts",
    "matmul_nn",
    "matmul_tn",
    "omega_fill",
    "omega_seeds",
    "power_pass_chunk",
    "power_pass_chunk_seeded",
    "power_project_accumulate",
    "power_project_accumulate_seeded",
    "powerpass_sweep",
    "proj_stage",
    "proj_stage_seeded",
    "project_rows",
    "projgram",
    "projgram_seeded",
    "reset_launch_counts",
]
