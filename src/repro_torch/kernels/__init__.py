"""Hand-written CUDA kernels of the port, with their plain versions.

Six entry points, one launch counter each, over the CUDA kernels in
``csrc/gemm_f32.cu`` and ``csrc/rand.cuh``:

==================  ===================================================
entry point         replaces (JAX package)
==================  ===================================================
proj_stage          kernels/powerpass.py ``_proj_stage_kernel``
powerpass_sweep     kernels/powerpass.py ``_powerpass_sweep_kernel``
gram_sweep          kernels/projgram.py ``_gram_sweep_kernel``
matmul_tn           kernels/matmul.py ``_mm_tn_kernel``
omega_fill          kernels/rand.py ``normal_tile``
proj_stage_seeded   kernels/powerpass.py ``_proj_stage_seeded_kernel``
==================  ===================================================
"""

from .matmul import matmul_tn
from .ops import (final_pass_chunk, final_pass_chunk_seeded, launch_counts, power_pass_chunk,
                  power_pass_chunk_seeded, reset_launch_counts)
from .powerpass import (power_project_accumulate, power_project_accumulate_seeded,
                        powerpass_sweep, proj_stage, proj_stage_seeded)
from .projgram import gram_sweep, projgram_seeded
from .rand import dense_omega, omega_fill, omega_seeds

__all__ = [
    "dense_omega",
    "final_pass_chunk",
    "final_pass_chunk_seeded",
    "gram_sweep",
    "launch_counts",
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
    "projgram_seeded",
    "reset_launch_counts",
]
