"""Hand-written CUDA kernels of the port, with their plain versions.

Four entry points, one launch counter each, over two CUDA kernels in
``csrc/gemm_f32.cu``:

================  =====================================================
entry point       replaces (JAX package)
================  =====================================================
proj_stage        kernels/powerpass.py ``_proj_stage_kernel``
powerpass_sweep   kernels/powerpass.py ``_powerpass_sweep_kernel``
gram_sweep        kernels/projgram.py ``_gram_sweep_kernel``
matmul_tn         kernels/matmul.py ``_mm_tn_kernel``
================  =====================================================
"""

from .matmul import matmul_tn
from .ops import final_pass_chunk, launch_counts, power_pass_chunk, reset_launch_counts
from .powerpass import power_project_accumulate, powerpass_sweep, proj_stage
from .projgram import gram_sweep

__all__ = [
    "final_pass_chunk",
    "gram_sweep",
    "launch_counts",
    "matmul_tn",
    "power_pass_chunk",
    "power_project_accumulate",
    "powerpass_sweep",
    "proj_stage",
    "reset_launch_counts",
]
