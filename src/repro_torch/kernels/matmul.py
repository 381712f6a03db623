"""The two f32 GEMM launchers, and the TN product ``matmul_tn``.

``matmul_tn`` (O = Xᵀ·Y) is the port of ``repro/kernels/matmul.py``
``_mm_tn_kernel`` as ``pallas_matmul(transpose_lhs=True)`` launches it;
on the main path it computes the final pass's cross term F = PaᵀPb.
:func:`gemm_nn`, :func:`gemm_nn_seeded` and :func:`gemm_tn` are the
checked launchers every GEMM entry point of the package goes through
(kernel source: ``csrc/gemm_f32.cu``).

A wrapper takes its plain version (:mod:`.ref`) only when its tensors
lie on the CPU.  For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import build, ref

_MAX_GRID_Y = 65535  # column tiles ride gridDim.y
_TILE = 128
#: Ω rows per slab of the seeded stage: 34 MB at k̃ = 2060, inside the
#: H100's 50 MB L2.  A multiple of the kernel's contraction step (16), so
#: slab edges keep each element's FMA chain (the C side checks).
SEEDED_SLAB = 4096


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
    if -(-N // _TILE) > _MAX_GRID_Y:
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


def matmul_tn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """O = xᵀ·y: x (K, M), y (K, N) → (M, N) f32, contracting the
    streamed row dimension without forming xᵀ."""
    if on_cpu(x, y):
        return ref.matmul_tn_ref(x, y)
    return gemm_tn("matmul_tn", x, y)
