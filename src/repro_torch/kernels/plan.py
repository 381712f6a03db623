"""Launch plans: what each CUDA launch of the port does.

Port of ``repro/kernels/plan.py`` ``KernelPlan`` in the role it plays for
the schedule rule and the cost model.  A :class:`LaunchPlan` records one
CUDA launch: the kernel, its grid and block, its shared memory, the
FLOPs it does (and how many of them on the tensor cores), and the bytes
it moves, reckoned as each input read once and each output written once,
at 4 bytes per f32 and 2 per bf16 element.  A ``plan_*`` function
returns the launches one call of the entry point of that name issues, in
order; each takes the operands' ``dtype`` (a seeded plan's Ω slabs are of
the same dtype), as the reference's plans do.

Plans come from the port's own tiles, never from the TPU's
``VMEM_BLOCK_ELEMS``.  Every f32 launch runs a tile of :data:`F32_TILES`
with its ring in :func:`ring_smem` of dynamic shared memory
(``csrc/gemm_ring.cuh``): a staged product (``gemm_nn_f32``,
``gemm_tn_f32``, ``gemm_tn_bf16_f32``) the tile :func:`f32_tile` picks
for its output, the fused f32 recompute kernel :data:`FUSED_F32_TILE` in
both phases, on a cooperative grid of that tile's blocks per SM on every
SM, or fewer blocks when it has fewer tiles.  The bf16 tensor-core
products, staged or fused, run ``csrc/gemm_bf16.cuh``'s wgmma tile
(128 × 128, :data:`TILE`, two
warpgroups, one block per SM, a ring in :data:`SMEM_BYTES_BF16` of
dynamic shared memory: :data:`BF16_THREADS`, :data:`BF16_BLOCKS_PER_SM`),
whose block also runs the fused bf16 kernels' f32 phase 2 on the ring's
128 × 128 tile.  :data:`TILE` also sets the buckets' column padding.
Only the buckets of the recompute schedule share a number with the
reference, and for a reason of their own (:data:`ONE_BUCKET_ELEMS`).
"""

from __future__ import annotations

import dataclasses

import torch

F32, BF16 = torch.float32, torch.bfloat16
TILE = 128  # gemm_bf16.cuh: output rows and columns per block (BM = BN)
#: The bf16 tensor-core tile (``csrc/gemm_bf16.cuh``): two warpgroups of
#: 64 × 128 outputs per block, one block per SM (≈ 230 registers a
#: thread); a ring of BF16_STAGES stages, each BF16_BK contraction steps of
#: A (128 × 64) and B (64 × 128) in bf16, plus 1 KB to align its 128-byte
#: swizzle atoms.  The fused bf16 kernels run on this block too (their
#: f32 phase 2 reuses the ring's shared memory).
BF16_THREADS, BF16_BLOCKS_PER_SM = 256, 1
BF16_BK, BF16_STAGES, BF16_ALIGN = 64, 6, 1024
SMEM_BYTES_BF16 = BF16_STAGES * 2 * (2 * TILE * BF16_BK) + BF16_ALIGN
#: The H100's f32 rate on the CUDA cores over its dense bf16 tensor-core
#: rate (67 / 989 TFLOP/s, data sheet): what one tensor-core FLOP costs in
#: the schedule rule's f32 units (:func:`weighted_cost`).
TENSOR_CORE_WEIGHT = 67 / 989
FILL_BLOCK = (64, 4)  # rand.cuh omega_fill: columns × rows per block
#: The f32 tile shapes, staged and fused (``csrc/gemm_ring.cuh`` Tile0,
#: Tile1, in this order): (rows, columns, threads, blocks per SM).  Eight
#: warps per SM either way, 8 × 8 outputs per thread; the launch pins the
#: blocks per SM (it asks for enough shared memory that no more fit).
F32_TILES = ((128, 128, 256, 1), (128, 64, 128, 2))
#: The tile of the fused f32 recompute kernel, both phases: 128 × 128 at one
#: block per SM, whatever :func:`f32_tile` would pick.  The 128 × 64 tile's
#: CONTINUE instances spilled 8 bytes at 255 registers with both phases
#: inlined into one kernel (CUDA 12.8, sm_90a), and at the shapes the
#: schedule rule recomputes the two tiles tie (8192 × 970: 3.88 waves either
#: way) or this one wins, so only this one is compiled.
FUSED_F32_TILE = 0
SMS = 132  # H100 SXM
RING_BK = 32  # contraction steps per stage of the ring (a K tail pads to its runs of 16)
RING_STAGES = 4
#: The H100's shared memory per SM and the part of it reserved per block:
#: what the launch's pin is computed from (the C side asks the card).
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024
#: Ω rows per slab of the seeded kernels: 34 MB at k̃ = 2060 in f32 (17 MB
#: in bf16), inside the H100's 50 MB L2.  A multiple of every tile's
#: staging depth (32 in f32, the ring's, whose runs are 16; 64 in bf16,
#: whose unit is 16), so slab edges keep each element's chain (the C side
#: checks).
SEEDED_SLAB = 4096

#: The largest accumulator bucket — rows × k̃p of ΔY (da × k̃p) or of
#: C (k̃p × k̃p), k̃p = k̃ rounded up to the 128-column tile — that one
#: fused recompute launch covers: 2^20 f32 elements, 4 MiB.
#:
#: The launch (``csrc/recompute_f32.cu``) keeps the chunk's P, n × k̃p,
#: in the 50 MB L2 between its two phases.  At the stream's chunk of 8192
#: rows that is 32 MiB at k̃p = 1024, which leaves ~18 MB for what phase 2
#: streams beside it: the accumulator bucket it writes and the operand
#: panels it reads.  Holding the bucket to 4 MiB keeps the two from
#: evicting P.  For C the bound reads k̃p ≤ 1024, the same condition as
#: P ≤ 32 MiB at 8192 rows, so the recompute shapes are exactly those
#: whose P fits L2 beside its Gram.  The reference's VMEM budget is the
#: same 2^20 elements, so the one-bucket shapes of the two packages agree
#: (``tests/test_torch_recompute.py`` pins them).
ONE_BUCKET_ELEMS = 1 << 20

SCHEDULES = ("recompute", "staged")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One CUDA launch."""

    kernel: str
    grid: tuple[int, ...]
    block: tuple[int, ...]
    smem_bytes: int
    flops: int
    bytes: int
    tc_flops: int = 0  # of ``flops``, those on the tensor cores (bf16 products)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded(x: int) -> int:
    """``x`` rounded up to the tile."""
    return cdiv(x, TILE) * TILE


def tile_waves(M: int, N: int, tile: int) -> tuple[int, int]:
    """(tiles, waves) of an M × N output on ``F32_TILES[tile]``: the
    waves are ⌈tiles ÷ resident blocks⌉."""
    bm, bn, _, per_sm = F32_TILES[tile]
    tiles = cdiv(M, bm) * cdiv(N, bn)
    return tiles, cdiv(tiles, per_sm * SMS)


def idle_share(M: int, N: int, tile: int) -> float:
    """The share of the output slots that ``tile``'s waves leave idle on an
    M × N output: 1 − M·N ÷ (waves × resident blocks × BM·BN), the edge
    tiles' unused columns and the last wave's empty blocks together."""
    bm, bn, _, per_sm = F32_TILES[tile]
    return 1 - M * N / (tile_waves(M, N, tile)[1] * per_sm * SMS * bm * bn)


def f32_tile(M: int, N: int) -> int:
    """The index in :data:`F32_TILES` of the tile for an M × N output of a
    staged f32 product (and of a seeded call's slabs): each launch is
    modelled as ⌈tiles ÷ resident blocks⌉ waves × one tile's time, a
    tile's time as its outputs × its
    blocks per SM (the SM's FFMA rate shared among them), and the cheapest
    wins; a tie goes to the larger tile, which stages fewer bytes per FMA.
    The chains do not depend on the tile, so neither do the bits.

    At the main path's outputs (8192 × 2060 and 4096 × 2060, 2^19 × 2060,
    8192 × 970) the tile it picks leaves at most 10 % of the slots idle; at
    2060 × 2060 (``gram_sweep``, ``matmul_tn``), which is just over two
    waves' worth for either shape, at most 35 %.  Today's single 128 × 128
    tile at two blocks per SM left 22 %, 35 %, 5 %, 8 % and 51 %."""
    def cost(i):
        bm, bn, _, per_sm = F32_TILES[i]
        return tile_waves(M, N, i)[1] * per_sm * bm * bn, -bm * bn

    return min(range(len(F32_TILES)), key=cost)


def ring_smem(tile: int, a_itemsize: int = 4) -> int:
    """The dynamic shared memory a launch on ``tile`` asks for: its ring of
    :data:`RING_STAGES` stages, or more, so that no more than its blocks
    per SM fit (``csrc/gemm_ring.cuh`` ``prepare``)."""
    bm, bn, _, per_sm = F32_TILES[tile]
    ring = RING_STAGES * RING_BK * (bm * a_itemsize + bn * 4)
    return max(ring, SMEM_PER_SM // (per_sm + 1) - SMEM_RESERVED + 16)


def copy_bytes(ptr: int, row_stride: int, itemsize: int) -> int:
    """The widest copy, in bytes, that the bf16 tile may stage a row-major
    operand at address ``ptr`` with ``row_stride`` elements per row with:
    16, 8 or 4 (``cp.async``) where base and row stride are aligned to it,
    else one element at a time (through a register).  A bf16 Q or P row is
    8-byte aligned at k̃ = 2060, 4-byte at 970 and 2-byte at 67 or 3; a
    Europarl row of X takes 16."""
    for width in (16, 8, 4):
        if ptr % width == 0 and row_stride * itemsize % width == 0:
            return width
    return itemsize


def vector_copies(ptr: int, row_stride: int, itemsize: int) -> bool:
    """Whether a row-major operand at address ``ptr`` with ``row_stride``
    elements per row can be staged 16 bytes per copy: a 16-byte aligned
    base and row stride.  Else the kernel copies 4 bytes (an f32 element)
    at a time, or a bf16 element through a register."""
    return copy_bytes(ptr, row_stride, itemsize) == 16


def copies(a: tuple[int, int, int], b: tuple[int, int, int]) -> int:
    """The ``vec`` argument of a staged f32 launch: bit 0 for A, bit 1 for B,
    each ``(address, row stride, itemsize)``, set where
    :func:`vector_copies` allows 16-byte copies."""
    return int(vector_copies(*a)) | 2 * int(vector_copies(*b))


def bucket_rows(kt: int) -> int:
    """Accumulator rows one recompute launch covers at sketch width k̃."""
    return max(TILE, ONE_BUCKET_ELEMS // padded(kt) // TILE * TILE)


def buckets(rows: int, kt: int) -> list[tuple[int, int]]:
    """The [r0, r1) row ranges of an accumulator of ``rows`` rows, one per
    recompute launch."""
    step = bucket_rows(kt)
    return [(r0, min(r0 + step, rows)) for r0 in range(0, rows, step)]


def check_schedule(schedule: str) -> str:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; expected one of {SCHEDULES}")
    return schedule


def cost(plans) -> tuple[int, int]:
    """(FLOPs, bytes) of a sequence of launches."""
    return sum(p.flops for p in plans), sum(p.bytes for p in plans)


def weighted_cost(plans) -> tuple[float, int]:
    """(FLOPs at the CUDA cores' f32 rate, bytes) of a sequence of
    launches, each tensor-core FLOP weighted by :data:`TENSOR_CORE_WEIGHT`:
    what :func:`~.matmul.pick_schedule` charges at its f32 balance point,
    so a tensor-core phase meets its own (≈ 295 FLOP/B).  f32 plans have
    no tensor-core FLOPs, and this is :func:`cost`."""
    flops = sum(p.flops - p.tc_flops + TENSOR_CORE_WEIGHT * p.tc_flops for p in plans)
    return flops, sum(p.bytes for p in plans)


def itemsize(dtype: torch.dtype) -> int:
    if dtype not in (F32, BF16):
        raise TypeError(f"the kernels take float32 or bfloat16 operands, not {dtype}")
    return 4 if dtype == F32 else 2


# --------------------------------------------------------------------------
# single launches
# --------------------------------------------------------------------------


def gemm_nn(M: int, N: int, K: int, *, cont: bool = False, dtype=F32) -> LaunchPlan:
    """P (M×N, f32) = X (M×K)·Q (K×N), both of ``dtype`` (bf16: on the
    tensor cores); ``cont`` continues P's chains (reads P)."""
    flops = 2 * M * N * K
    if dtype == BF16:
        return LaunchPlan("gemm_nn_bf16", (cdiv(N, TILE), cdiv(M, TILE)), (BF16_THREADS,),
                          SMEM_BYTES_BF16, flops,
                          2 * (M * K + K * N) + 4 * M * N * (2 if cont else 1),
                          tc_flops=flops)
    itemsize(dtype)
    return _ring_plan("gemm_nn_f32", M, N, 4, flops,
                      4 * (M * K + K * N + M * N * (2 if cont else 1)))


def _ring_plan(kernel: str, M: int, N: int, a_itemsize: int, flops: int,
               nbytes: int) -> LaunchPlan:
    """A staged f32 launch on the tile :func:`f32_tile` picks: grid (column
    tiles, row tiles)."""
    tile = f32_tile(M, N)
    bm, bn, threads, _ = F32_TILES[tile]
    return LaunchPlan(kernel, (cdiv(N, bn), cdiv(M, bm)), (threads,),
                      ring_smem(tile, a_itemsize), flops, nbytes)


def gemm_tn(M: int, N: int, K: int, *, accumulate: bool = False, dtype=F32,
            p_dtype=None) -> LaunchPlan:
    """O (M×N, f32) (+)= Xᵀ·Y with X (K×M) of ``dtype`` and Y (K×N) of
    ``p_dtype`` (default ``dtype``): bf16 × bf16 on the tensor cores, bf16
    × f32 on the CUDA cores with X widened."""
    p_dtype = dtype if p_dtype is None else p_dtype
    flops = 2 * M * N * K
    nbytes = itemsize(dtype) * K * M + itemsize(p_dtype) * K * N + 4 * M * N * (
        2 if accumulate else 1)
    if dtype == BF16 and p_dtype == BF16:
        return LaunchPlan("gemm_tn_bf16", (cdiv(N, TILE), cdiv(M, TILE)), (BF16_THREADS,),
                          SMEM_BYTES_BF16, flops, nbytes, tc_flops=flops)
    if p_dtype != F32:
        raise TypeError(f"no TN kernel takes {dtype} X with {p_dtype} Y")
    kernel = "gemm_tn_f32" if dtype == F32 else "gemm_tn_bf16_f32"
    return _ring_plan(kernel, M, N, itemsize(dtype), flops, nbytes)


def omega_fill(rows: int, cols: int, dtype=F32) -> LaunchPlan:
    """Rows × cols of Ω in ``dtype``, written once; its work is integer,
    not FLOPs."""
    return LaunchPlan("omega_fill" if dtype == F32 else "omega_fill_bf16",
                      (cdiv(rows, FILL_BLOCK[1]), cdiv(cols, FILL_BLOCK[0])),
                      FILL_BLOCK, 0, 0, itemsize(dtype) * rows * cols)


def recompute(n: int, kt: int, k1: int, m2: int, nbytes: int,
              kernel: str = "recompute_f32") -> LaunchPlan:
    """One fused launch: P (n×k̃) over k1 contraction columns, then an
    m2-row accumulator bucket.  ``nbytes`` depends on which operands are
    the entry point's inputs and outputs.  The f32 kernel runs both phases
    on :data:`FUSED_F32_TILE`; its cooperative grid is that tile's blocks
    per SM on every SM, at most one block per tile of the larger phase.
    The bf16 kernels (``projgram_bf16``, ``power_recompute_bf16``) run the
    projection on the tensor cores and the accumulation on the CUDA cores,
    on the bf16 tile's block: one per SM, its ring's dynamic shared
    memory."""
    proj = 2 * n * k1 * kt
    if kernel == "recompute_f32":
        bm, bn, threads, per_sm = F32_TILES[FUSED_F32_TILE]
        tiles = max(cdiv(n, bm), cdiv(m2, bm)) * cdiv(kt, bn)
        return LaunchPlan(kernel, (min(per_sm * SMS, tiles),), (threads,),
                          ring_smem(FUSED_F32_TILE), proj + 2 * n * m2 * kt, nbytes)
    tiles = max(cdiv(n, TILE), cdiv(m2, TILE)) * cdiv(kt, TILE)
    return LaunchPlan(kernel, (min(BF16_BLOCKS_PER_SM * SMS, tiles),), (BF16_THREADS,),
                      SMEM_BYTES_BF16, proj + 2 * n * m2 * kt, nbytes, tc_flops=proj)


def _per_bucket(rows: int, kt: int, one_bucket) -> tuple[LaunchPlan, ...]:
    """The launches of one call per recompute bucket, ``one_bucket(r0, r1)``
    planned once per distinct bucket height (all but the last are equal):
    a seeded power pass at Europarl width issues ~350,000 launches."""
    made: dict[int, tuple[LaunchPlan, ...]] = {}
    out: list[LaunchPlan] = []
    for r0, r1 in buckets(rows, kt):
        if r1 - r0 not in made:
            made[r1 - r0] = one_bucket(r0, r1)
        out.extend(made[r1 - r0])
    return tuple(out)


def _seeded(n: int, d: int, kt: int, last, dtype=F32) -> tuple[LaunchPlan, ...]:
    """The slab launches of a seeded call on operands of ``dtype``:
    omega_fill then the NN launch per slab, ``last(k1, cont)`` contracting
    the last slab."""
    out = []
    for k0 in range(0, d, SEEDED_SLAB):
        ks = min(SEEDED_SLAB, d - k0)
        out.append(omega_fill(ks, kt, dtype))
        out.append(gemm_nn(n, kt, ks, cont=k0 > 0, dtype=dtype) if k0 + ks < d
                   else last(ks, k0 > 0))
    return tuple(out)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def plan_proj_stage(n: int, d: int, kt: int, *, dtype=F32) -> tuple[LaunchPlan, ...]:
    return (gemm_nn(n, kt, d, dtype=dtype),)


def plan_proj_stage_seeded(n: int, d: int, kt: int, *, dtype=F32) -> tuple[LaunchPlan, ...]:
    """The seeded stage on X of ``dtype``, Ω made in slabs of ``dtype``."""
    return _seeded(n, d, kt, lambda ks, cont: gemm_nn(n, kt, ks, cont=cont, dtype=dtype),
                   dtype)


def plan_powerpass_sweep(n: int, da: int, kt: int, *, accumulate: bool = False, dtype=F32,
                         p_dtype=None) -> tuple[LaunchPlan, ...]:
    """ΔY = Aᵀ·P with A of ``dtype`` and P of ``p_dtype`` (default
    ``dtype``)."""
    return (gemm_tn(da, kt, n, accumulate=accumulate, dtype=dtype, p_dtype=p_dtype),)


def plan_gram_sweep(n: int, kt: int, *, dtype=F32) -> tuple[LaunchPlan, ...]:
    return (gemm_tn(kt, kt, n, dtype=dtype),)


def plan_matmul_nn(M: int, K: int, N: int, *, dtype=F32) -> tuple[LaunchPlan, ...]:
    """O (M×N) = X (M×K)·Q (K×N): the NN kernel, as :func:`plan_proj_stage`."""
    return (gemm_nn(M, N, K, dtype=dtype),)


def plan_matmul_tn(K: int, M: int, N: int, *, dtype=F32) -> tuple[LaunchPlan, ...]:
    return (gemm_tn(M, N, K, dtype=dtype),)


def plan_omega_fill(rows: int, kt: int) -> tuple[LaunchPlan, ...]:
    return (omega_fill(rows, kt),)


def plan_projgram(n: int, d: int, kt: int, *, dtype=F32) -> tuple[LaunchPlan, ...]:
    """One launch per C bucket: X and Q (of ``dtype``) read, P and the
    bucket's rows of C (f32) written."""
    w = itemsize(dtype)
    kernel = "recompute_f32" if dtype == F32 else "projgram_bf16"
    return _per_bucket(kt, kt, lambda r0, r1: (recompute(
        n, kt, d, r1 - r0, w * (n * d + d * kt) + 4 * (n * kt + (r1 - r0) * kt), kernel),))


def plan_projgram_seeded(n: int, d: int, kt: int, *, dtype=F32) -> tuple[LaunchPlan, ...]:
    """Per C bucket, the slabs of a seeded call on X of ``dtype``; the
    last slab's fused launch reads X's window, the slab and P, and writes
    P and the rows of C."""
    w = itemsize(dtype)
    kernel = "recompute_f32" if dtype == F32 else "projgram_bf16"

    def last(r0, r1):
        return lambda ks, cont: recompute(
            n, kt, ks, r1 - r0,
            w * (n * ks + ks * kt) + 4 * (n * kt * (2 if cont else 1) + (r1 - r0) * kt),
            kernel)
    return _per_bucket(kt, kt, lambda r0, r1: _seeded(n, d, kt, last(r0, r1), dtype))


def plan_power_project_accumulate(n: int, da: int, db: int, kt: int, *,
                                  accumulate: bool = False,
                                  dtype=F32) -> tuple[LaunchPlan, ...]:
    """One launch per ΔY bucket: B, Q and the bucket's columns of A (of
    ``dtype``) read, its rows of ΔY written (and read, when
    accumulating).  P is the launch's own scratch, neither input nor
    output."""
    y, w = 2 if accumulate else 1, itemsize(dtype)
    kernel = "recompute_f32" if dtype == F32 else "power_recompute_bf16"
    return _per_bucket(da, kt, lambda r0, r1: (recompute(
        n, kt, db, r1 - r0,
        w * (n * db + db * kt + n * (r1 - r0)) + 4 * y * (r1 - r0) * kt, kernel),))


def plan_power_project_accumulate_seeded(n: int, da: int, db: int, kt: int, *,
                                         accumulate: bool = False,
                                         dtype=F32) -> tuple[LaunchPlan, ...]:
    """Per ΔY bucket, the slabs of a seeded call on A and B of ``dtype``;
    the last slab's fused launch reads B's window, the slab, P (when it
    continues) and the bucket's columns of A, and writes its rows of ΔY."""
    y, w = 2 if accumulate else 1, itemsize(dtype)
    kernel = "recompute_f32" if dtype == F32 else "power_recompute_bf16"

    def last(r0, r1):
        m2 = r1 - r0
        return lambda ks, cont: recompute(
            n, kt, ks, m2,
            w * (n * ks + ks * kt + n * m2) + 4 * ((n * kt if cont else 0) + y * m2 * kt),
            kernel)
    return _per_bucket(da, kt, lambda r0, r1: _seeded(n, db, kt, last(r0, r1), dtype))


def plan_projgram_staged(n: int, d: int, kt: int, *, seeded: bool = False,
                         dtype=F32) -> tuple[LaunchPlan, ...]:
    """The stage on X and Q of ``dtype``, then the Gram of the f32 P."""
    stage = (plan_proj_stage_seeded if seeded else plan_proj_stage)(n, d, kt, dtype=dtype)
    return stage + plan_gram_sweep(n, kt)


def plan_powerpass_staged(n: int, da: int, db: int, kt: int, *, accumulate: bool = False,
                          seeded: bool = False, dtype=F32) -> tuple[LaunchPlan, ...]:
    """The stage on B and Q of ``dtype``, then the sweep of A (of
    ``dtype``) against the f32 P."""
    stage = (plan_proj_stage_seeded if seeded else plan_proj_stage)(n, db, kt, dtype=dtype)
    return stage + plan_powerpass_sweep(n, da, kt, accumulate=accumulate, dtype=dtype,
                                        p_dtype=F32)
