"""Per-chunk data-pass updates, the units the pass engine calls under
``engine="kernels"``.

Port of ``repro/kernels/ops.py`` for the staged schedule: a power chunk
is 2 stage + 2 sweep launches (4, as ``ops.py:68-71`` of the reference
counts them) and a final chunk is 2 stage + 2 Gram + 1 TN launch for
F = PaᵀPb (5).  The seeded variants (``ops.py:100-140``) count the same,
with the seeded stage in place of the stage.  :func:`launch_counts`
reads the per-entry-point launch counters, :func:`reset_launch_counts`
zeroes them.
"""

from __future__ import annotations

from . import build
from .matmul import matmul_tn
from .powerpass import power_project_accumulate, power_project_accumulate_seeded
from .projgram import projgram, projgram_seeded


def power_pass_chunk(a, b, Qa, Qb, *, out=None):
    """ΔYa = Aᵀ(B Qb), ΔYb = Bᵀ(A Qa) for one row chunk.

    ``out = (Ya, Yb)`` accumulates both into f32 accumulators in place
    (see :func:`repro_torch.kernels.powerpass.powerpass_sweep`) and
    returns them.
    """
    out_a, out_b = (None, None) if out is None else out
    dYa = power_project_accumulate(a, b, Qb, out=out_a)
    dYb = power_project_accumulate(b, a, Qa, out=out_b)
    return dYa, dYb


def final_pass_chunk(a, b, Qa, Qb):
    """ΔCa = PaᵀPa, ΔCb = PbᵀPb, ΔF = PaᵀPb with P = X·Q, for one chunk."""
    pa, Ca = projgram(a, Qa)
    pb, Cb = projgram(b, Qb)
    return Ca, Cb, matmul_tn(pa, pb)


def power_pass_chunk_seeded(a, b, seed_a, seed_b, *, kt: int, out=None):
    """:func:`power_pass_chunk` against Ω(seed_a), Ω(seed_b) made on the
    card slab by slab: ΔYa = Aᵀ(B Ω(seed_b)), ΔYb = Bᵀ(A Ω(seed_a)).  No
    (d, k̃) tensor is made."""
    out_a, out_b = (None, None) if out is None else out
    dYa = power_project_accumulate_seeded(a, b, seed_b, kt, out=out_a)
    dYb = power_project_accumulate_seeded(b, a, seed_a, kt, out=out_b)
    return dYa, dYb


def final_pass_chunk_seeded(a, b, seed_a, seed_b, *, kt: int):
    """:func:`final_pass_chunk` against Ω(seed_a), Ω(seed_b) (the q = 0
    direct sketch)."""
    pa, Ca = projgram_seeded(a, seed_a, kt)
    pb, Cb = projgram_seeded(b, seed_b, kt)
    return Ca, Cb, matmul_tn(pa, pb)


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    build.reset_launches()

