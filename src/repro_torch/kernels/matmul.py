"""The GEMM launchers, their operand forms, the plain products
``matmul_nn`` and ``matmul_tn``, and the schedule crossover.

``matmul_tn`` (O = Xᵀ·Y) is the port of ``repro/kernels/matmul.py``
``_mm_tn_kernel`` as ``pallas_matmul(transpose_lhs=True)`` launches it;
on the main path it computes the final pass's cross term F = PaᵀPb.
``matmul_nn`` (O = X·Q) is the port of ``_mm_nn_kernel``, the plain
``pallas_matmul``; the sharded fit's unfused collective
(``ops.project``) runs it.  The TPU kernel blocks (i, j, k) with a VMEM
accumulator carried across the k steps; on Hopper the same function is
``gemm_nn_f32``, which contracts each output tile's whole K range in one
block (one ascending FMA chain per element, on the tile
:func:`~.plan.f32_tile` picks), so
``matmul_nn`` is bitwise ``powerpass.proj_stage`` on the same operands
and counts its launches under its own name.  It is bound by f32
operations (2·M·K·N FLOPs against 4·(MK + KN + MN) bytes).
:func:`gemm_nn`, :func:`gemm_nn_seeded`, :func:`gemm_tn` and
:func:`recompute` are the launchers every GEMM entry point of the package
goes through (kernel sources: ``csrc/gemm_f32.cu``, ``csrc/gemm_bf16.cu``,
``csrc/recompute_f32.cu``), each with the :class:`Form` that
:func:`form` resolves from the entry point and its operands' dtypes
(:data:`FORMS`).  :func:`pick_schedule` is the port of the reference's
crossover rule, at the H100's balance point.

A wrapper takes its plain version (:mod:`.ref`) only when its tensors
lie on the CPU.  For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build, plan, ref
from .plan import SEEDED_SLAB

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


f32, bf16 = torch.float32, torch.bfloat16
_NN = {(f32, f32): "gemm_nn_f32", (bf16, bf16): "gemm_nn_bf16"}
#: The operand forms the CUDA kernels take: entry point → {operand dtypes,
#: in the entry point's argument order → C function}.  A seeded entry
#: point makes Ω in its data's dtype; ``omega_fill``'s one dtype is its
#: output's.  The bf16 forms
#: multiply exact bf16 products and sum them in f32 into an f32 output, as
#: the reference's kernels do on bf16 operands; a bf16 A against an f32 P
#: is the reference's promotion of the mixed product (``csrc/gemm_bf16.cu``).
#: Anything else raises :class:`TypeError` on the card.
FORMS = {
    "proj_stage": _NN,
    "matmul_nn": _NN,
    "powerpass_sweep": {(f32, f32): "gemm_tn_f32", (bf16, bf16): "gemm_tn_bf16",
                        (bf16, f32): "gemm_tn_bf16_f32"},
    "matmul_tn": {(f32, f32): "gemm_tn_f32", (bf16, bf16): "gemm_tn_bf16"},
    "gram_sweep": {(f32,): "gemm_tn_f32", (bf16,): "gemm_tn_bf16"},
    "proj_stage_seeded": {(f32,): "proj_stage_seeded_f32", (bf16,): "proj_stage_seeded_bf16"},
    "projgram": {(f32, f32): "recompute_f32", (bf16, bf16): "projgram_bf16"},
    "projgram_seeded": {(f32,): "recompute_seeded_f32", (bf16,): "projgram_seeded_bf16"},
    "power_project_accumulate": {(f32, f32, f32): "recompute_f32",
                                 (bf16, bf16, bf16): "power_recompute_bf16"},
    "power_project_accumulate_seeded": {(f32, f32): "recompute_seeded_f32",
                                        (bf16, bf16): "power_recompute_seeded_bf16"},
    "omega_fill": {(f32,): "omega_fill_f32", (bf16,): "omega_fill_bf16"},
}
_SHORT = {f32: "f32", bf16: "bf16"}
#: The C functions that run the f32 ring tile (``csrc/gemm_ring.cuh``) for
#: their first product (the fused ones: phase 1): each takes the tile
#: :func:`~.plan.f32_tile` picks for that product's output and the copy widths
#: :func:`~.plan.copies` allows its operands — the fused ``recompute_f32``
#: only the copy widths, as it always runs :data:`~.plan.FUSED_F32_TILE`.
RING = frozenset({"gemm_nn_f32", "gemm_tn_f32", "gemm_tn_bf16_f32", "proj_stage_seeded_f32",
                  "recompute_f32", "recompute_seeded_f32"})
#: The C functions that run the bf16 tensor-core tile (``csrc/gemm_bf16.cuh``):
#: each takes the copy width of its two bf16 operands (:func:`~.plan.copy_bytes`).
WGMMA = frozenset({"gemm_nn_bf16", "gemm_tn_bf16", "proj_stage_seeded_bf16", "projgram_bf16",
                   "power_recompute_bf16", "projgram_seeded_bf16",
                   "power_recompute_seeded_bf16"})
#: The fused recompute kernels: phase 2 (Y (+)= A2ᵀ·P) runs the ring tile,
#: and each takes the copy widths :func:`~.plan.copies` allows A2 and P
#: after its phase 1 arguments.
FUSED = frozenset({"recompute_f32", "recompute_seeded_f32", "projgram_bf16",
                   "power_recompute_bf16", "projgram_seeded_bf16",
                   "power_recompute_seeded_bf16"})


class Form(NamedTuple):
    """One operand form of an entry point: the C function that computes
    it, and the name its launches are counted under — the entry point's
    for f32 operands, else e.g. ``proj_stage[bf16]`` or
    ``powerpass_sweep[bf16,f32]`` (the operands' dtypes, each once)."""

    fn: str
    label: str


def cuda_form(entry: str, *dtypes: torch.dtype) -> Form:
    """The :class:`Form` of ``entry`` on operands of ``dtypes``; raises
    :class:`TypeError` for a form no kernel takes."""
    fn = FORMS[entry].get(tuple(dtypes))
    if fn is None:
        raise TypeError(f"{entry}: no CUDA kernel takes operands of dtypes "
                        f"{[str(d) for d in dtypes]}; the forms are "
                        f"{[[str(d) for d in k] for k in FORMS[entry]]}")
    names = list(dict.fromkeys(_SHORT[d] for d in dtypes))
    return Form(fn, entry if names == ["f32"] else f"{entry}[{','.join(names)}]")


def form(entry: str, *tensors: torch.Tensor) -> Form:
    """:func:`cuda_form` of ``entry`` on these operands, which must be 2-D
    and contiguous (row-major)."""
    for t in tensors:
        if t.dim() != 2:
            raise ValueError(f"{entry}: expected 2-D operands, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{entry}: operands must be contiguous (row-major)")
    return cuda_form(entry, *(t.dtype for t in tensors))


def _check_out(label: str, out: torch.Tensor, shape, device) -> None:
    """An f32 accumulator the kernel adds into."""
    if out.dtype != f32:
        raise TypeError(f"{label}: the accumulator must be float32, got {out.dtype}")
    if tuple(out.shape) != tuple(shape) or out.device != device or not out.is_contiguous():
        raise ValueError(f"{label}: out must be a contiguous {tuple(shape)} on {device}, got "
                         f"{tuple(out.shape)} on {out.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _grid_ok(entry: str, M: int, N: int) -> None:
    """A launch grid has an output to cover (the C launchers bound its size)."""
    if M == 0 or N == 0:
        raise ValueError(f"{entry}: empty output ({M}, {N})")


def _ring(fn: str, M: int, N: int, a: tuple[int, int, int], b: tuple[int, int, int]) -> tuple:
    """The ring tile's extra arguments for C function ``fn`` on an M × N
    output — the tile (but for ``recompute_f32``) and the copy widths of A
    and B, each ``(address, row stride, itemsize)`` — or none for another
    kernel."""
    if fn not in RING:
        return ()
    vec = plan.copies(a, b)
    return (vec,) if fn == "recompute_f32" else (plan.f32_tile(M, N), vec)


def _widths(fn: str, a: tuple[int, int, int], b: tuple[int, int, int]) -> tuple:
    """The bf16 tile's two extra arguments for C function ``fn`` — the copy
    widths in bytes of its operands A and B, each ``(address, row stride,
    itemsize)`` — or none for another kernel."""
    if fn not in WGMMA:
        return ()
    return plan.copy_bytes(*a), plan.copy_bytes(*b)


def _phase2(fn: str, a2: tuple[int, int, int], p: tuple[int, int, int]) -> tuple:
    """A fused kernel's last extra argument for C function ``fn`` — the copy
    widths of phase 2's A2 and P, each ``(address, row stride, itemsize)``
    — or none for another kernel."""
    if fn not in FUSED:
        return ()
    return (plan.copies(a2, p),)


def _operand(t: torch.Tensor, row_stride: int) -> tuple[int, int, int]:
    return t.data_ptr(), row_stride, t.element_size()


def gemm_nn(f: Form, x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """P = x·q on the card: x (M, K), q (K, N) → (M, N) f32, by the C
    function of form ``f`` (from :func:`form`)."""
    (M, K), (K2, N) = x.shape, q.shape
    if K != K2:
        raise ValueError(f"{f.label}: contraction mismatch {K} vs {K2}")
    _grid_ok(f.label, M, N)
    out = torch.empty((M, N), dtype=f32, device=x.device)
    a, b = _operand(x, K), _operand(q, N)
    build.launch(f.label, f.fn, x.data_ptr(), q.data_ptr(), out.data_ptr(), M, N, K,
                 *_ring(f.fn, M, N, a, b), *_widths(f.fn, a, b), _stream(x))
    return out


def gemm_nn_seeded(f: Form, x: torch.Tensor, seed, kt: int) -> torch.Tensor:
    """P = x·Ω(seed) on the card: x (M, K) → (M, kt) f32, Ω made in
    K-slabs of :data:`SEEDED_SLAB` rows, in x's dtype, into a scratch
    allocated here (one C call, 2·⌈K / SEEDED_SLAB⌉ CUDA launches)."""
    M, K = x.shape
    if K == 0:
        raise ValueError(f"{f.label}: empty contraction")
    _grid_ok(f.label, M, kt)
    out = torch.empty((M, kt), dtype=f32, device=x.device)
    slab = torch.empty((min(K, SEEDED_SLAB), kt), dtype=x.dtype, device=x.device)
    a, b = _operand(x, K), _operand(slab, kt)
    build.launch(f.label, f.fn, x.data_ptr(), seed[0] & 0xFFFFFFFF, seed[1] & 0xFFFFFFFF,
                 out.data_ptr(), slab.data_ptr(), SEEDED_SLAB, M, kt, K,
                 *_ring(f.fn, M, kt, a, b), *_widths(f.fn, a, b), _stream(x))
    return out


def gemm_tn(f: Form, x: torch.Tensor, y: torch.Tensor,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """O = xᵀ·y on the card: x (K, M), y (K, N) → (M, N) f32.  With
    ``out`` (f32) the full contraction is added into ``out`` in place."""
    (K, M), (K2, N) = x.shape, y.shape
    if K != K2:
        raise ValueError(f"{f.label}: row mismatch {K} vs {K2}")
    _grid_ok(f.label, M, N)
    accumulate = out is not None
    if accumulate:
        _check_out(f.label, out, (M, N), x.device)
    else:
        out = torch.empty((M, N), dtype=f32, device=x.device)
    a, b = _operand(x, M), _operand(y, N)
    build.launch(f.label, f.fn, x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K,
                 int(accumulate), *_ring(f.fn, M, N, a, b), *_widths(f.fn, a, b), _stream(x))
    return out


def recompute(f: Form, x: torch.Tensor, q, kt: int, p: torch.Tensor, a2: torch.Tensor,
              y: torch.Tensor, r0: int, r1: int, *, accumulate: bool = False) -> None:
    """One fused recompute launch on the card: P = x·q (q a (d, kt)
    tensor, or a seed whose Ω is made in slabs of x's dtype), then rows
    [r0, r1) of y (+)= a2[:, r0:r1]ᵀ·P.  ``p`` (n, kt) f32 receives P; a2
    is (n, ·) and y (·, kt) f32, both row-major.  A seeded call issues
    2·⌈d / SEEDED_SLAB⌉ CUDA launches, the last of them the fused one."""
    n, d = x.shape
    m2, lda2 = r1 - r0, a2.shape[1]
    a2_ptr, y_ptr = a2.data_ptr() + a2.element_size() * r0, y.data_ptr() + 4 * r0 * kt
    phase2 = _phase2(f.fn, (a2_ptr, lda2, a2.element_size()), _operand(p, kt))
    if isinstance(q, torch.Tensor):
        a, b = _operand(x, d), _operand(q, kt)
        build.launch(f.label, f.fn, x.data_ptr(), q.data_ptr(), p.data_ptr(), a2_ptr, y_ptr,
                     n, kt, d, m2, lda2, int(accumulate), *_ring(f.fn, n, kt, a, b),
                     *_widths(f.fn, a, b), *phase2, _stream(x))
        return
    slab = torch.empty((min(d, SEEDED_SLAB), kt), dtype=x.dtype, device=x.device)
    a, b = _operand(x, d), _operand(slab, kt)
    build.launch(f.label, f.fn, x.data_ptr(), q[0] & 0xFFFFFFFF, q[1] & 0xFFFFFFFF,
                 p.data_ptr(), slab.data_ptr(), SEEDED_SLAB, a2_ptr, y_ptr, n, kt, d, m2, lda2,
                 int(accumulate), *_ring(f.fn, n, kt, a, b), *_widths(f.fn, a, b), *phase2,
                 _stream(x))


def matmul_tn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """O = xᵀ·y: x (K, M), y (K, N) → (M, N) f32, contracting the
    streamed row dimension without forming xᵀ.  f32 or bf16 operands."""
    if on_cpu(x, y):
        return ref.matmul_tn_ref(x, y)
    return gemm_tn(form("matmul_tn", x, y), x, y)


def matmul_nn(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """O = x·q: x (M, K), q (K, N) → (M, N) f32.  f32 or bf16 operands."""
    if on_cpu(x, q):
        return ref.matmul_nn_ref(x, q)
    return gemm_nn(form("matmul_nn", x, q), x, q)
