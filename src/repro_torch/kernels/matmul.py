"""The f32 GEMM launchers, the plain products ``matmul_nn`` and
``matmul_tn``, and the schedule crossover.

``matmul_tn`` (O = Xᵀ·Y) is the port of ``repro/kernels/matmul.py``
``_mm_tn_kernel`` as ``pallas_matmul(transpose_lhs=True)`` launches it;
on the main path it computes the final pass's cross term F = PaᵀPb.
``matmul_nn`` (O = X·Q) is the port of ``_mm_nn_kernel``, the plain
``pallas_matmul``; the sharded fit's unfused collective
(``ops.project``) runs it.  The TPU kernel blocks (i, j, k) with a VMEM
accumulator carried across the k steps; on Hopper the same function is
``gemm_nn_f32``, which contracts each 128 × 128 output tile's whole K
range in one block (one ascending FMA chain per element), so
``matmul_nn`` is bitwise ``powerpass.proj_stage`` on the same operands
and counts its launches under its own name.  It is bound by f32
operations (2·M·K·N FLOPs against 4·(MK + KN + MN) bytes).
:func:`gemm_nn`, :func:`gemm_nn_seeded`, :func:`gemm_tn` and
:func:`recompute` are the checked launchers every GEMM entry point of the
package goes through (kernel sources: ``csrc/gemm_f32.cu``,
``csrc/recompute_f32.cu``).  :func:`pick_schedule` is the port of the
reference's crossover rule, at the H100's balance point.

A wrapper takes its plain version (:mod:`.ref`) only when its tensors
lie on the CPU.  For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build, ref
from .plan import SEEDED_SLAB, TILE

_MAX_GRID_Y = 65535  # column tiles ride gridDim.y

#: The H100's f32 balance point: 67 TFLOP/s on the CUDA cores ÷ 3.35 TB/s
#: of HBM ≈ 20 FLOP per byte (the reference's 240 is a TPU's).  The f32
#: products run on the CUDA cores because TF32 would break parity.
ROOFLINE_FLOPS_PER_BYTE = 67e12 / 3.35e12


def pick_schedule(costs: dict, *, roofline: float = ROOFLINE_FLOPS_PER_BYTE) -> str:
    """The cheaper schedule of ``costs`` (name → (FLOPs, bytes) of the
    launches it issues), charged max(FLOPs / roofline, bytes); ties go
    to the first name in sorted order, as in the reference."""
    def t(c) -> float:
        flops, nbytes = c
        return max(float(flops) / roofline, float(nbytes))

    return min(sorted(costs), key=lambda k: t(costs[k]))


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every one lies
    on one CUDA device; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _check(entry: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{entry}: the CUDA kernel takes float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{entry}: expected 2-D operands, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{entry}: operands must be contiguous (row-major)")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _grid_ok(entry: str, M: int, N: int) -> None:
    if M == 0 or N == 0:
        raise ValueError(f"{entry}: empty output ({M}, {N})")
    if -(-N // TILE) > _MAX_GRID_Y:
        raise ValueError(f"{entry}: {N} output columns exceed the launch grid")


def gemm_nn(entry: str, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = x·q on the card: x (M, K), q (K, N) → (M, N) f32."""
    _check(entry, x, q)
    (M, K), (K2, N) = x.shape, q.shape
    if K != K2:
        raise ValueError(f"{entry}: contraction mismatch {K} vs {K2}")
    _grid_ok(entry, M, N)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    build.launch(entry, "gemm_nn_f32", x.data_ptr(), q.data_ptr(),
                 out.data_ptr(), M, N, K, _stream(x))
    return out


def gemm_nn_seeded(entry: str, x: torch.Tensor, seed, kt: int) -> torch.Tensor:
    """P = x·Ω(seed) on the card: x (M, K) → (M, kt) f32, Ω made in
    K-slabs of :data:`SEEDED_SLAB` rows into a scratch allocated here
    (one C call, 2·⌈K / SEEDED_SLAB⌉ CUDA launches)."""
    _check(entry, x)
    M, K = x.shape
    if K == 0:
        raise ValueError(f"{entry}: empty contraction")
    _grid_ok(entry, M, kt)
    out = torch.empty((M, kt), dtype=torch.float32, device=x.device)
    slab = torch.empty((min(K, SEEDED_SLAB), kt), dtype=torch.float32, device=x.device)
    build.launch(entry, "proj_stage_seeded_f32", x.data_ptr(), seed[0] & 0xFFFFFFFF,
                 seed[1] & 0xFFFFFFFF, out.data_ptr(), slab.data_ptr(), SEEDED_SLAB, M, kt, K,
                 _stream(x))
    return out


def gemm_tn(entry: str, x: torch.Tensor, y: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """O = xᵀ·y on the card: x (K, M), y (K, N) → (M, N) f32.  With
    ``out`` the full contraction is added into ``out`` in place."""
    _check(entry, x, y)
    (K, M), (K2, N) = x.shape, y.shape
    if K != K2:
        raise ValueError(f"{entry}: row mismatch {K} vs {K2}")
    _grid_ok(entry, M, N)
    accumulate = out is not None
    if accumulate:
        _check(entry, out)
        if tuple(out.shape) != (M, N) or out.device != x.device:
            raise ValueError(f"{entry}: out must be ({M}, {N}) on {x.device}, got "
                             f"{tuple(out.shape)} on {out.device}")
    else:
        out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    build.launch(entry, "gemm_tn_f32", x.data_ptr(), y.data_ptr(),
                 out.data_ptr(), M, N, K, int(accumulate), _stream(x))
    return out


def recompute(entry: str, x: torch.Tensor, q, kt: int, p: torch.Tensor, a2: torch.Tensor,
              y: torch.Tensor, r0: int, r1: int, *, accumulate: bool = False) -> None:
    """One fused recompute launch on the card: P = x·q (q a (d, kt)
    tensor, or a seed whose Ω is made in slabs), then rows [r0, r1) of y
    (+)= a2[:, r0:r1]ᵀ·P.  ``p`` (n, kt) receives P; a2 is (n, ·) and y
    (·, kt), both row-major.  A seeded call issues 2·⌈d / SEEDED_SLAB⌉
    CUDA launches, the last of them the fused one."""
    n, d = x.shape
    m2, lda2 = r1 - r0, a2.shape[1]
    a2_ptr, y_ptr = a2.data_ptr() + 4 * r0, y.data_ptr() + 4 * r0 * kt
    if isinstance(q, torch.Tensor):
        build.launch(entry, "recompute_f32", x.data_ptr(), q.data_ptr(), p.data_ptr(), a2_ptr,
                     y_ptr, n, kt, d, m2, lda2, int(accumulate), _stream(x))
        return
    slab = torch.empty((min(d, SEEDED_SLAB), kt), dtype=torch.float32, device=x.device)
    build.launch(entry, "recompute_seeded_f32", x.data_ptr(), q[0] & 0xFFFFFFFF,
                 q[1] & 0xFFFFFFFF, p.data_ptr(), slab.data_ptr(), SEEDED_SLAB, a2_ptr, y_ptr,
                 n, kt, d, m2, lda2, int(accumulate), _stream(x))


def matmul_tn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """O = xᵀ·y: x (K, M), y (K, N) → (M, N) f32, contracting the
    streamed row dimension without forming xᵀ."""
    if on_cpu(x, y):
        return ref.matmul_tn_ref(x, y)
    return gemm_tn("matmul_tn", x, y)


def matmul_nn(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """O = x·q: x (M, K), q (K, N) → (M, N) f32."""
    if on_cpu(x, q):
        return ref.matmul_nn_ref(x, q)
    return gemm_nn("matmul_nn", x, q)
