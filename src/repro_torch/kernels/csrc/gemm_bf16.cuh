// The bf16-operand tiles of the port: bf16 X and Q (or A and P), f32
// accumulation, f32 output — what the reference's Pallas kernels compute on
// bf16 operands (`preferred_element_type=jnp.float32`).  Three tiles serve
// the ten bf16 forms (seven unseeded, three seeded):
//
//   tile 1  Y (M×N) = X (M×K) · Q (K×N), both bf16, on the tensor cores
//           (wgmma_tile<false, ·>): proj_stage, matmul_nn, the seeded
//           stage's slabs (gemm_bf16.cu), and phase 1 of the fused
//           recompute kernels, seeded or not (recompute_f32.cu);
//   tile 2  Y (M×N) (+)= Aᵀ · P with A (K×M) and P (K×N) both bf16, K the
//           row axis, on the tensor cores (wgmma_tile<true, ·>):
//           powerpass_sweep(bf16 P), matmul_tn, gram_sweep (A = P);
//   tile 3  Y (+)= Aᵀ · P with A bf16 and P f32, on the CUDA cores, A
//           widened to f32 exactly (so this is the reference's promotion of
//           the mixed product): gemm_ring.cuh's TN tile with A staged as
//           bf16 and widened as it is read, in powerpass_sweep(f32 P) and in
//           phase 2 of the fused power recompute (recompute_f32.cu).
//
// Tiles 1 and 2 are one function, on Hopper's warpgroup tensor-core path
// (wgmma, sm_90a only).  The old mma.sync tile stays compiled as a witness
// (gemm_bf16_mma.cuh), launched by no entry point.
//
// The unit, which every bitwise contract of the port rests on.  Each 16-deep
// k step (STEP) of an output element is one tensor-core product started from
// zero — a `wgmma.mma_async m64n64k16.f32.bf16.bf16` issued with scale-d = 0
// (bf16 × bf16 products are exact; the 16 are summed inside the tensor core)
// into a scratch fragment — then added into the f32 accumulator with one
// IEEE add (__fadd_rn): acc = acc + Σ_{k in step}, steps in ascending k,
// masked terms past K zero.  Starting each step from zero keeps the tensor
// cores' internal accumulation to 16 terms.  No split-K, no atomics: two
// launches on the same inputs give equal bits, and every bf16 × bf16 entry
// point runs this one function, so matmul_nn ≡ proj_stage, matmul_tn ≡
// powerpass_sweep(bf16 P), gram_sweep(P) ≡ matmul_tn(P, P) and staged ≡
// recompute hold bitwise.  A last stage runs only the steps K needs.  Modes:
// OVERWRITE; ACCUMULATE, one add into Y after the whole chain; CONTINUE, the
// chains start from Y.  (The old mma.sync tile's m16n8k16 from zero gives
// the same bits at the main path's shapes: chip_smoke.py's witness.)
//
// Continued chains (CONTINUE).  The seeded forms contract Ω slab by slab:
// each slab is one launch over a column window of X, and every slab after
// the first loads each accumulator element from Y where the epilogue stored
// it and goes on adding one product per step.  The chain is the one launch
// over the whole K would form, bit for bit, when slab edges fall on BK
// boundaries (the C entries check slab_rows % BK == 0; SEEDED_SLAB = 4096),
// so seeded ≡ the materialized bf16 product on the same bf16 Ω.
//
// Where the time goes, and the design.  A k16 step is 32 tensor-core FLOPs
// per output element: at 989 TFLOP/s an SM retires ≈ 128 element-steps a
// clock, and its FP32 pipes retire 128 FADDs a clock, so the add pass keeps
// the FP32 pipes and the issue slots as busy as the tensor cores.  The tile
// therefore overlaps the adds with the asynchronous products:
//
//   * Two consumer warpgroups per 256-thread block, each 64 rows × 128
//     columns of the 128 × 128 output tile (plan.TILE; phase 2 of the fused
//     bf16 kernels runs gemm_ring.cuh's Tile0 on the same block).  A step
//     is two halves, columns 0-63 and 64-127, each one m64n64k16 into a
//     32-float scratch fragment (s0, s1): a warpgroup issues half u, adds
//     half u − 1 (already finished) while u runs, then waits for u
//     (wait_group 0).  ptxas keeps a product in flight only so: a
//     fragment that the adds read must not
//     be written by another product before the next wait to 0 (it waits
//     after every issue otherwise, C7514), and no branch may stand between
//     an issue and its wait, so the loop runs whole stages and a short last
//     stage runs after it, one product at a time.  Accumulators (lo, hi) and
//     scratch are 128 registers; 207-247 a thread in all, no spills (two
//     64-float scratch fragments spilled), one block per SM (MIN_BLOCKS).
//   * Operands straight from shared memory through wgmma descriptors, no
//     ldmatrix, in the 128-byte-swizzled layout the descriptors name
//     (chunk c of a 128-byte row r at chunk c ^ (r % 8), atoms of 8 rows
//     1024-byte aligned):
//       - X of tile 1 is K-major: a stage is [128 rows][64 k], one 128-byte
//         row per output row; a step advances the descriptor 32 bytes;
//       - Q and P (B) are N-major, through the B-transpose bit, and A of
//         tile 2 is M-major, through the A-transpose bit: a stage is two
//         64-column panels of [64 k][64 columns]; a step advances 16 rows.
//   * A ring of STAGES = 6 stages of BK = 64 (32 KB each), filled with
//     cp.async AHEAD = 4 stages ahead: one __syncthreads() a stage, and the
//     slot it refills is stage s − 2's, whose products are done (stage
//     s − 1's last may still run across the barrier).
//   * Loads.  A bf16 row of Q or P is 4,120 bytes at k̃ = 2060 (8-byte
//     aligned), 1,940 at k̃ = 970 (4-byte), odd at k̃ = 67 or 3 (2-byte);
//     TMA needs 16-byte strides, so each operand is copied at the widest
//     width its base and row stride allow (plan.copy_bytes: cp.async of 16,
//     8 or 4 bytes, or element by element through registers at 2), the
//     interior unmasked, edges and the K tail zero-filled.  X rows (2^18 or
//     2^19 elements) and every seeded window take 16 bytes.
//
// What bounds it: the tensor cores at the main path's shapes (~1,650 FLOP
// per byte of operands, above the balance point of 295), and next to them
// the add pass's issue slots.  A 128 × 128 tile refills 32 KB of shared
// memory per 2·128·128·64 FLOPs: at the tensor-core rate that is ≈ 15 TB/s
// from L2 over the card, more than L2 delivers, so the tile cannot reach
// the bound.  Measured (PERF.md): ≈ 260 TFLOP/s at the main path's shapes;
// with its copies taken out ≈ 330, with its adds taken out ≈ 12 % faster;
// four products in flight instead of one gained nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mode.cuh"

namespace gemm_bf16 {

using gemm_mode::ACCUMULATE;
using gemm_mode::bf16_bits;
using gemm_mode::CONTINUE;
using gemm_mode::OVERWRITE;

constexpr int BM = 128;       // output rows per tile: two warpgroups of 64
constexpr int BN = 128;       // output columns per tile
constexpr int BK = 64;        // contraction depth per ring stage
constexpr int STEP = 16;      // the unit: one wgmma k16 from zero, one IEEE add
constexpr int STAGES = 6;     // stages in the ring
constexpr int AHEAD = STAGES - 2;  // stages in flight ahead of the one computing
constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int MIN_BLOCKS = 1; // blocks per SM
constexpr int ALIGN = 1024;   // a swizzle atom: 8 rows of 128 bytes
constexpr int OPERAND_BYTES = BM * BK * 2;  // one operand's stage: 128 × 64 or 64 × 128
constexpr int STAGE_BYTES = 2 * OPERAND_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + ALIGN;  // the ring, and room to align it
static_assert(BM == BN && BK * 2 == 128, "a K-major stage row is one 128-byte swizzle row");
static_assert(BK % STEP == 0, "a stage is whole steps");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The ring's shared address: the dynamic shared memory rounded up to ALIGN.
__device__ __forceinline__ uint32_t ring_base(const void* smem) {
  return (smem_addr(smem) + (ALIGN - 1)) & ~(uint32_t)(ALIGN - 1);
}

// Byte offset of element (r, c) of a K-major stage, [BM rows][BK].
__device__ __forceinline__ uint32_t kmajor_offset(int r, int c) {
  return (uint32_t)(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2);
}

// Byte offset of element (k, c) of an MN-major stage, [BK rows][128
// columns] as two panels of 64 columns.
__device__ __forceinline__ uint32_t mnmajor_offset(int k, int c) {
  return (uint32_t)((c >> 6) * (BK * 128) + k * 128 + ((((c >> 3) ^ k) & 7) << 4) + (c & 7) * 2);
}

// W bytes (4, 8 or 16) to shared memory, the first `bytes` of them from
// global memory and the rest zero.
template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, uint32_t bytes) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(W), "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed copy groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand's stage: rows × columns of a row-major bf16 matrix from `src`
// (the stage's first element, row stride ld) to shared address `dst`, W
// bytes per copy (2: through a register), K-major ([BM][BK]) or MN-major
// ([BK][BN] panels).  MASKED: rows past `rleft` and columns past `cleft`
// read as zero (`base` stands in for their source address).  A thread's
// copies lie in one column, STRIDE rows apart: its first row and column are
// computed once, and each further copy is an add (the swizzle repeats every
// 8 rows).
template <bool KMAJOR, int W, bool MASKED>
__device__ __forceinline__ void copy_stage(uint32_t dst, const bf16_bits* src, int ld,
                                           int rleft, int cleft, const bf16_bits* base) {
  constexpr int E = W / 2;                          // elements per copy
  constexpr int PER_ROW = (KMAJOR ? BK : BN) / E;   // copies per row
  constexpr int STRIDE = THREADS / PER_ROW;         // rows between a thread's copies
  constexpr int PER_THREAD = (KMAJOR ? BM : BK) / STRIDE;
  static_assert(THREADS % PER_ROW == 0, "whole rows per pass");
  // the thread's index, read anew in every stage: the compiler would keep
  // each width's offsets in registers across the loop otherwise (spills)
  unsigned tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  const int r0 = (int)(tid / PER_ROW), c = (int)(tid % PER_ROW) * E;
  const bf16_bits* from = src + (r0 * ld + c);
  auto offset = [&](int r) { return dst + (KMAJOR ? kmajor_offset(r, c) : mnmajor_offset(r, c)); };
  const uint32_t to0 = offset(r0);
  if constexpr (W == 2) {
    // eight loads in flight, then their stores
    constexpr int GROUP = 8;
    static_assert(PER_THREAD % GROUP == 0, "whole groups");
#pragma unroll
    for (int g = 0; g < PER_THREAD; g += GROUP) {
      unsigned short v[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const int r = r0 + (g + i) * STRIDE;
        v[i] = r < rleft && c < cleft ? from[(g + i) * STRIDE * ld] : (unsigned short)0;
      }
#pragma unroll
      for (int i = 0; i < GROUP; ++i)
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(offset(r0 + (g + i) * STRIDE)),
                     "h"(v[i])
                     : "memory");
    }
  } else {
#pragma unroll
    for (int it = 0; it < PER_THREAD; ++it) {
      const int r = r0 + it * STRIDE;
      const uint32_t to = STRIDE % 8 == 0 ? to0 + (uint32_t)(it * STRIDE * 128) : offset(r);
      const bf16_bits* p = from + it * STRIDE * ld;
      if constexpr (MASKED) {
        const int left = r < rleft ? cleft - c : 0;
        const uint32_t bytes = left <= 0 ? 0u : left >= E ? (uint32_t)W : (uint32_t)(2 * left);
        cp_async<W>(to, bytes ? p : base, bytes);
      } else {
        cp_async<W>(to, p, (uint32_t)W);
      }
    }
  }
}

// copy_stage at the run-time width `w`; `full`: nothing to mask.
template <bool KMAJOR>
__device__ __forceinline__ void copy_operand(int w, bool full, uint32_t dst,
                                             const bf16_bits* src, int ld, int rleft, int cleft,
                                             const bf16_bits* base) {
  switch (w) {
    case 16:
      if (full) copy_stage<KMAJOR, 16, false>(dst, src, ld, rleft, cleft, base);
      else copy_stage<KMAJOR, 16, true>(dst, src, ld, rleft, cleft, base);
      break;
    case 8:
      if (full) copy_stage<KMAJOR, 8, false>(dst, src, ld, rleft, cleft, base);
      else copy_stage<KMAJOR, 8, true>(dst, src, ld, rleft, cleft, base);
      break;
    case 4:
      if (full) copy_stage<KMAJOR, 4, false>(dst, src, ld, rleft, cleft, base);
      else copy_stage<KMAJOR, 4, true>(dst, src, ld, rleft, cleft, base);
      break;
    default:
      copy_stage<KMAJOR, 2, true>(dst, src, ld, rleft, cleft, base);
  }
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

// d = A·B for half a step — its 64 columns of the tile — from zero
// (scale-d = 0); TRANS_A: A is M-major; B is N-major.  Asynchronous: d is
// written when the warpgroup waits for the half's group.
template <int TRANS_A>
__device__ __forceinline__ void wgmma_half(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(0), "n"(TRANS_A));
}

// Keeps the compiler from moving reads or writes of a fragment across the
// wgmma instructions that write it.
__device__ __forceinline__ void fence_fragment(float (&f)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(f[i])::"memory");
}

__device__ __forceinline__ void add_into(float (&acc)[32], const float (&f)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], f[i]);
}

// Half a step: issue its product into `fresh`, add the previous half's
// (`done`, finished) into its accumulators `acc` while it runs, then wait
// for it.  The fences keep the compiler from moving the adds across the
// wgmma instructions.
template <int TRANS_A>
__device__ __forceinline__ void half_step(float (&fresh)[32], float (&done)[32],
                                          float (&acc)[32], uint64_t da, uint64_t db) {
  fence_fragment(fresh);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_half<TRANS_A>(fresh, da, db);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_fragment(done);
  add_into(acc, done);
  fence_fragment(acc);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_fragment(fresh);
}

// Half a step whose product is added at once: the short last stage's.
template <int TRANS_A>
__device__ __forceinline__ void half_step_now(float (&f)[32], float (&acc)[32], uint64_t da,
                                              uint64_t db) {
  fence_fragment(f);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_half<TRANS_A>(f, da, db);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_fragment(f);
  add_into(acc, f);
}

// The tile at (m0, n0) of Y (+)= op(A) · B, Y row-major f32 with row stride N.
//   TN = false: A is X (M × K) with row stride lda ≥ K — tile 1;
//   TN = true:  A is (K × M) with row stride lda ≥ M — tile 2, Aᵀ·B.
// B is (K × N) with row stride N.  wa, wb: the copy width of A and B in
// bytes (16, 8, 4 or 2; the launcher has checked them).  `ring`: the
// ALIGN-aligned shared address of SMEM_BYTES − ALIGN bytes.  Every thread of
// the block calls it with the same tile; it ends on a __syncthreads(), so
// the block may start the next tile on the same ring at once.
template <bool TN, int MODE>
__device__ __forceinline__ void wgmma_tile(const bf16_bits* __restrict__ A,
                                           const bf16_bits* __restrict__ B,
                                           float* __restrict__ Y, int64_t M, int64_t N,
                                           int64_t K, int64_t lda, int wa, int wb, int64_t m0,
                                           int64_t n0, uint32_t ring) {
  static_assert(MODE == OVERWRITE || MODE == ACCUMULATE || MODE == CONTINUE, "a tile mode");
  const int mleft = (int)(M - m0 < BM ? M - m0 : BM);
  const int nleft = (int)(N - n0 < BN ? N - n0 : BN);
  const int ld = (int)lda, ldb = (int)N;  // the launcher bounds both
  const int stages = (int)((K + BK - 1) / BK);
  const int full = (int)(K / BK);  // stages all of whose steps K needs

  // the accumulator fragments: element i of `lo` (of `hi`) is row `row0`
  // (+ 8 for i % 4 ≥ 2), column `col0` + 8·(i / 4) + i % 2 (+ 64) of the tile
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int row0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = (lane & 3) * 2;
  float lo[32], hi[32], s0[32], s1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    lo[i] = hi[i] = s0[i] = 0.0f;
    s1[i] = -0.0f;  // x + (−0) = x for every x: the first stage's "previous half"
    if constexpr (MODE == CONTINUE) {  // the chains go on from Y
      const int r = row0 + ((i >> 1) & 1) * 8, c = col0 + (i >> 2) * 8 + (i & 1);
      if (r < mleft && c < nleft) lo[i] = Y[(m0 + r) * N + n0 + c];
      if (r < mleft && c + 64 < nleft) hi[i] = Y[(m0 + r) * N + n0 + c + 64];
    }
  }

  // Copies of stage `s` into its ring slot.
  auto load = [&](int s) {
    const int64_t k0 = (int64_t)s * BK;
    const int kleft = (int)(K - k0 < BK ? K - k0 : BK);
    const uint32_t sa = ring + (uint32_t)((s % STAGES) * STAGE_BYTES);
    if constexpr (TN)
      copy_operand<false>(wa, kleft == BK && mleft == BM, sa, A + k0 * lda + m0, ld, kleft,
                          mleft, A);
    else
      copy_operand<true>(wa, kleft == BK && mleft == BM, sa, A + m0 * lda + k0, ld, mleft,
                         kleft, A);
    copy_operand<false>(wb, kleft == BK && nleft == BN, sa + OPERAND_BYTES, B + k0 * N + n0,
                        ldb, kleft, nleft, B);
  };

  // descriptors of slot 0: this warpgroup's 64 rows of A (both layouts put
  // them 8 KB apart), B's first 64 columns (its second panel is PANEL
  // further); the stride between 8-row groups is 1024 bytes
  constexpr uint32_t PANEL = BK * 128;  // an MN-major panel of 64 columns
  const uint64_t da0 = descriptor(ring + (uint32_t)wg * 8192u, TN ? PANEL : 16u, 1024u);
  const uint64_t db0 = descriptor(ring + (uint32_t)OPERAND_BYTES, PANEL, 1024u);
  constexpr uint64_t A_STEP = TN ? (STEP * 128) >> 4 : (STEP * 2) >> 4;  // one step, in 16 B
  constexpr uint64_t B_STEP = (STEP * 128) >> 4;
  constexpr uint64_t B_HALF = PANEL >> 4;
  constexpr int TRANS_A = TN ? 1 : 0;

  // Iterations before 0 only fill the ring: one copy group per stage, empty
  // past the end, so the wait counts uniformly.  The loop runs the stages
  // all of whose steps K needs; a short last stage runs after it.
#pragma unroll 1
  for (int j = -AHEAD; j < full; ++j) {
    cp_wait<AHEAD - 1>();  // this thread's copies of stage j have landed,
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma;
    __syncthreads();       // everyone's have, and stage j − 2's products are done
    if (j + AHEAD < stages) load(j + AHEAD);
    cp_commit();
    if (j < 0) continue;
    const uint64_t slot = (uint64_t)((j % STAGES) * STAGE_BYTES) >> 4;
    const uint64_t da = da0 + slot, db = db0 + slot;
    // Each step is two halves, columns 0-63 into s0 then 64-127 into s1;
    // each half is added while the next one runs.  The previous step's
    // second half (in s1: the previous stage's last, or −0 before the
    // first) is added while this step's first half runs.
#pragma unroll
    for (int t = 0; t < BK / STEP; ++t) {
      half_step<TRANS_A>(s0, s1, hi, da + t * A_STEP, db + t * B_STEP);
      half_step<TRANS_A>(s1, s0, lo, da + t * A_STEP, db + t * B_STEP + B_HALF);
    }
  }
  add_into(hi, s1);  // the last full stage's last half (−0 if none)
  if (full < stages) {  // the short last stage, its steps one at a time
    cp_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint64_t slot = (uint64_t)((full % STAGES) * STAGE_BYTES) >> 4;
    const uint64_t da = da0 + slot, db = db0 + slot;
    const int n = (int)((K - (int64_t)full * BK + STEP - 1) / STEP);
#pragma unroll
    for (int t = 0; t < BK / STEP; ++t) {
      if (t >= n) break;
      half_step_now<TRANS_A>(s0, lo, da + t * A_STEP, db + t * B_STEP);
      half_step_now<TRANS_A>(s1, hi, da + t * A_STEP, db + t * B_STEP + B_HALF);
    }
  }
  cp_wait<0>();

  // ---- epilogue: one add into Y when accumulating
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    // element i & 31 of lo (i < 32) or hi: the same layout, 64 columns on
    const int r = row0 + ((i >> 1) & 1) * 8;
    const int c = col0 + ((i & 31) >> 2) * 8 + (i & 1) + (i >> 5) * 64;
    const float v = i < 32 ? lo[i & 31] : hi[i & 31];
    if (r < mleft && c < nleft) {
      float* y = Y + (m0 + r) * N + n0 + c;
      *y = MODE == ACCUMULATE ? __fadd_rn(*y, v) : v;
    }
  }
  __syncthreads();
}

// One tile per block: grid (⌈N / BN⌉, ⌈M / BM⌉), the column tiles fastest,
// so the blocks that share a row panel of A run together and read it from L2.
template <bool TN, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wgmma_kernel(const bf16_bits* __restrict__ A, const bf16_bits* __restrict__ B,
             float* __restrict__ Y, int64_t M, int64_t N, int64_t K, int64_t lda, int wa,
             int wb) {
  extern __shared__ unsigned char wgmma_smem[];
  wgmma_tile<TN, MODE>(A, B, Y, M, N, K, lda, wa, wb, (int64_t)blockIdx.y * BM,
                       (int64_t)blockIdx.x * BN, ring_base(wgmma_smem));
}

// Copies of width w bytes need a w-aligned base and row stride.
inline bool copies_ok(const void* p, long long ld, int w) {
  return (w == 2 || w == 4 || w == 8 || w == 16) && reinterpret_cast<uintptr_t>(p) % w == 0 &&
         (ld * 2) % w == 0;
}

// The checks every launch of the tile makes: sizes the grid and 32-bit stage
// offsets hold, copy widths the operands allow.  A is (M × K) or, TN, (K × M)
// with row stride lda; B is (K × N).
template <bool TN>
int check_operands(const void* a, const void* b, long long M, long long N, long long K,
                   long long lda, int wa, int wb) {
  if (M <= 0 || N <= 0 || K < 0 || K > (1LL << 30) || (M + BM - 1) / BM > 65535 ||
      (N + BN - 1) / BN > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if ((TN ? (long long)BK : (long long)BM) * lda >= (1LL << 31) || (long long)BK * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (!copies_ok(a, lda, wa) || !copies_ok(b, N, wb)) return (int)cudaErrorMisalignedAddress;
  return 0;
}

// Y (+)= op(A)·B on the tile: one launch, one tile per block.
template <bool TN, int MODE>
int launch(const void* a, const void* b, void* y, long long M, long long N, long long K,
           long long lda, int wa, int wb, cudaStream_t stream) {
  const int rc = check_operands<TN>(a, b, M, N, K, lda, wa, wb);
  if (rc != 0) return rc;
  const auto kern = wgmma_kernel<TN, MODE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  kern<<<grid, THREADS, SMEM_BYTES, stream>>>((const bf16_bits*)a, (const bf16_bits*)b,
                                              (float*)y, M, N, K, lda, wa, wb);
  return (int)cudaGetLastError();
}

}  // namespace gemm_bf16
