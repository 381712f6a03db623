// The f32 output tile of the port on Hopper (sm_90a): its operands staged
// through an asynchronous ring of shared-memory stages.  One device function,
// ring_tile, in two forms:
//
//   NN  Y (M×N) = X (M×K) · B (K×N)          gemm_nn_f32: proj_stage, matmul_nn,
//                                             the seeded stage's slabs, every
//                                             slab but the last of a seeded
//                                             recompute; phase 1 of the fused
//                                             f32 recompute (recompute_f32.cu)
//   TN  Y (M×N) (+)= Aᵀ · B, A (K×M)          gemm_tn_f32: powerpass_sweep,
//                                             gram_sweep, matmul_tn; phase 2 of
//                                             every fused recompute, f32 or
//                                             bf16; with A bf16 (TA =
//                                             bf16_bits), "tile 3":
//                                             powerpass_sweep[bf16,f32] and
//                                             phase 2 of the fused bf16 power
//                                             recompute
//
// ring_kernel runs one tile per block: the staged products.  The fused
// recompute kernels call ring_tile from persistent loops over their tiles;
// each call ends with no copy in flight and a barrier, so the block may start
// the next tile's prologue on the same slots at once.
//
// What bounds it on this card: f32 operations.  At the main path's shapes
// a product does hundreds of FLOPs per byte of operands, far above the card's
// f32 balance point (67 TFLOP/s ÷ 3.35 TB/s ≈ 20), and the reference is f32
// end to end, so the tensor cores (TF32 at best) are out.  The CUDA cores
// issue one warp instruction per clock per scheduler, so every instruction
// that is not an FFMA takes a slot from one.  The design therefore spends its
// effort on keeping the FFMA pipes fed:
//
//   * The ring.  STAGES = 4 stages of BK = 32 contraction steps in dynamic
//     shared memory, filled with cp.async; one __syncthreads() per stage, so
//     the copies of stages s + 1 … s + 3 are in flight while stage s
//     computes.  A stage computes as two unrolled runs of RUN = 16 steps (the
//     code of one run, looped), and a short last stage runs only the runs
//     it needs.
//   * Copies without per-element work.  16-byte cp.async.cg where the base
//     pointer and the row stride allow it (the launcher checks, plan.copies
//     decides), else 4-byte cp.async.ca into the same layout (a bf16 A that
//     is not 16-byte aligned goes through registers: cp.async has no 2-byte
//     form).  Interior tiles copy unmasked; edge tiles and the K tail zero-fill
//     with cp.async's source size.  Offsets inside a stage are 32-bit.
//       - TN: A (K×M) and B (K×N) are both k-major, so each stage is BK
//         straight row copies into [BK][BM] and [BK][BN].
//       - NN: X is k-contiguous.  Its stage is copied 16 bytes at a time into
//         [BM][BK] (eight k-quads, one 128-byte line of X, per row), quad q of
//         row r at slot q ^ ((r >> 2) % 8).  A thread reads its 8 rows a
//         k-quad at a time (8 LDS.128 per 4 steps, as many as the k-major
//         layout needs), and the XOR makes the 2 or 4 row groups of a warp
//         hit distinct banks.  (The other two ways to transpose, 4-byte
//         copies scattered into [BK][BM] or a register-staged transposing
//         store, take 8× the copies or registers the 8 × 8 tile lacks.)
//     A bf16 A (tile 3) is staged as bf16, halving its bytes, and widened
//     (exactly: `bits << 16`) as its fragments are read.
//   * Coherent reads (COHERENT, phase 2 of the fused kernels).  Phase 2 reads
//     P, which other blocks wrote in phase 1 of the same launch (projgram's
//     A is P too).  The grid barrier makes their stores visible in L2, not in
//     this SM's L1: a line of P that the SM cached before the barrier stays
//     stale there.  A seeded call's last slab does cache such lines: phase 1
//     in CONTINUE mode reads its own P tile with plain loads, and at k̃ = 970
//     a P row (3,880 bytes) is only 8-byte aligned, so a 128-byte line of it
//     holds a neighbouring tile's elements.  So a COHERENT tile reads
//     nothing through L1 by construction: its 16-byte copies are
//     cp.async.cg (L2 only), and its element copies, whose one cp.async form
//     (.ca) may hit L1, are ld.global.cg into registers — all of a thread's
//     loads of a stage in flight together, then their st.shared.  A bitwise
//     test cannot show a race absent; this is why none can occur.
//   * Tiles sized to the card's waves.  Two shapes, Tile0 = 128 × 128 with
//     256 threads and one block per SM, Tile1 = 128 × 64 with 128 threads
//     and two per SM: eight warps per SM either way, 8 × 8 outputs per
//     thread.  plan.f32_tile picks one per staged launch (⌈tiles ÷ resident
//     blocks⌉ waves × one tile's work) and passes its index; nothing is
//     decided here.  The fused f32 kernel runs Tile0 (plan.FUSED_F32_TILE).
//     At k̃ = 2060, Tile1's 33 column tiles fill 8192 rows in exactly 8 waves
//     of 264 blocks.
//     The launch pins the blocks per SM: it asks for enough shared memory
//     that no more than MIN_BLOCKS fit, so the plan's waves are the card's.
//   * Registers.  __launch_bounds__(THREADS, MIN_BLOCKS) leaves up to 255 a
//     thread: 64 accumulators, a 8 × 4 A fragment and 8 B values, with room
//     for the compiler to load the next ones during the FFMAs; ptxas reports
//     no spill in any instance (chip_smoke.py's build phase prints it).  An
//     8 × 16 thread tile would read fewer shared-memory floats per FMA (at
//     8 × 8 the SM's shared-memory path to the registers, 128 B a clock, is
//     as busy as its FFMA pipes), but it spilled at 255 registers and ran
//     the f32 products 7-14 % slower (PERF.md).
//
// The arithmetic, which every bitwise contract of the port rests on: each
// output element is one chain `acc = fmaf(a, b, acc)` in ascending k, from
// 0.0f (CONTINUE: from the element's value in Y); ACCUMULATE adds the
// finished chain into Y once, in the epilogue.  No split-K, no atomics, no
// TF32.  A masked K tail runs to the end of its run of 16 steps, its terms
// past K zero on both operands: each adds 0·0 = +0 to the chain, which is
// exact except that a chain standing at −0 becomes +0.  So the number of
// padded terms is part of the bits, and RUN stays 16, the depth every f32
// chain of the port has been padded to since its first tile: the recorded
// digests of the fits rest on it.  The chain does not depend on the tile's
// shape, the ring's depth or the order of the tiles, so the staged kernels
// and the fused ones (recompute ≡ staged, seeded ≡ materialized: chip_smoke.py
// holds them bitwise) give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mode.cuh"

namespace gemm_ring {

using gemm_mode::ACCUMULATE;
using gemm_mode::bf16_bits;
using gemm_mode::CONTINUE;
using gemm_mode::OVERWRITE;

constexpr int BK = 32;     // contraction steps per stage
constexpr int STAGES = 4;  // stages in the ring
constexpr int QUADS = BK / 4;        // k-quads per NN A row
// Steps per unrolled run of the compute loop, and the boundary a masked K tail
// pads to: 16, or the padded terms, and with them the bits, would change (see
// above).  The last stage runs only the runs it needs.
constexpr int RUN = 16;
static_assert(BK % RUN == 0, "a stage is whole runs");

// An output tile: BM × BN per block of (BM / 8)·(BN / 8) threads, each 8 × 8
// outputs as two 4-row halves BM / 2 apart by two 4-column halves BN / 2
// apart; MIN_BLOCKS blocks per SM.
template <int BM_, int BN_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int TX = BN / 8;  // thread columns
  static constexpr int THREADS = (BM / 8) * TX;
  static_assert(BM % 64 == 0, "both row halves of a thread share its NN swizzle");
  static_assert(BN % 32 == 0, "a warp's B reads stay in one stage row");
};
// The compiled set; plan.py F32_TILES lists the same shapes in this order.
using Tile0 = Tile<128, 128, 1>;
using Tile1 = Tile<128, 64, 2>;

// One stage of each operand, and the ring: A as [BM][BK] (NN, swizzled) or
// [BK][BM] (TN), B as [BK][BN].
template <class T, typename TA>
struct Ring {
  static constexpr int A_BYTES = T::BM * BK * (int)sizeof(TA);
  static constexpr int B_BYTES = BK * T::BN * 4;
  static constexpr int BYTES = STAGES * (A_BYTES + B_BYTES);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory, the first `bytes` of them from global memory and
// the rest zero.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// One element from global memory through L2 only (ld.global.cg), never from
// this SM's L1.
__device__ __forceinline__ float load_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];\n" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned short load_cg(const unsigned short* p) {
  unsigned short v;
  asm volatile("ld.global.cg.u16 %0, [%1];\n" : "=h"(v) : "l"(p) : "memory");
  return v;
}

// 4 bytes to shared memory, from global memory when `bytes` is 4, else zero.
__device__ __forceinline__ void copy4(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t clamp_bytes(int elems_left, int per_chunk, int size) {
  return (uint32_t)(size * (elems_left < 0 ? 0 : elems_left < per_chunk ? elems_left : per_chunk));
}

// A stage of BK rows × COLS elements of a row-major matrix: rows k0.. from
// `src` (the stage's first element, row stride ld) into [BK][COLS] at shared
// address `dst`, 16 bytes per copy.  MASKED: rows past `kleft` and columns
// past `cleft` read as zero (`base` stands in for their source address).
template <int COLS, int THREADS, bool MASKED, typename TE>
__device__ __forceinline__ void copy_rows16(uint32_t dst, const TE* src, int ld, int cleft,
                                            int kleft, const TE* base) {
  constexpr int PER = 16 / (int)sizeof(TE);  // elements per copy
  constexpr int PER_ROW = COLS / PER;
  constexpr int CHUNKS = BK * PER_ROW;
#pragma unroll
  for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    if (CHUNKS % THREADS != 0 && e >= CHUNKS) break;
    const int kk = e / PER_ROW, c = (e % PER_ROW) * PER;
    const uint32_t to = dst + (uint32_t)((kk * COLS + c) * (int)sizeof(TE));
    if (MASKED) {
      const uint32_t bytes = kk < kleft ? clamp_bytes(cleft - c, PER, (int)sizeof(TE)) : 0u;
      copy16(to, bytes ? src + (kk * ld + c) : base, bytes);
    } else {
      copy16(to, src + (kk * ld + c), 16u);
    }
  }
}

// The same stage one element per copy: 4-byte cp.async for f32; a bf16
// element (2 bytes, which cp.async cannot copy) through a register.
// COHERENT: every element through a register by load_cg, the thread's loads
// all issued before its first store.
template <int COLS, int THREADS, bool COHERENT, typename TE>
__device__ __forceinline__ void copy_rows_elems(uint32_t dst, const TE* src, int ld, int cleft,
                                                int kleft, const TE* base) {
  constexpr int ELEMS = BK * COLS;
  constexpr int PER = (ELEMS + THREADS - 1) / THREADS;  // elements per thread
  if constexpr (COHERENT) {
    TE v[PER];
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int kk = e / COLS, c = e % COLS;
      const bool in = (ELEMS % THREADS == 0 || e < ELEMS) && kk < kleft && c < cleft;
      v[it] = in ? load_cg(src + (kk * ld + c)) : (TE)0;
    }
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int e = threadIdx.x + it * THREADS;
      if (ELEMS % THREADS != 0 && e >= ELEMS) break;
      const uint32_t to = dst + (uint32_t)(e * (int)sizeof(TE));
      if constexpr (sizeof(TE) == 4)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(to), "f"(v[it]) : "memory");
      else
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(to), "h"(v[it]) : "memory");
    }
  } else {
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int e = threadIdx.x + it * THREADS;
      if (ELEMS % THREADS != 0 && e >= ELEMS) break;
      const int kk = e / COLS, c = e % COLS;
      const bool in = kk < kleft && c < cleft;
      const uint32_t to = dst + (uint32_t)(e * (int)sizeof(TE));
      if constexpr (sizeof(TE) == 4) {
        copy4(to, in ? src + (kk * ld + c) : base, in ? 4u : 0u);
      } else {
        const unsigned short v = in ? src[kk * ld + c] : (unsigned short)0;
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(to), "h"(v) : "memory");
      }
    }
  }
}

// Shared byte offset of element (r, k) of an NN A stage: [BM][BK], k-quad q
// of row r at quad slot q ^ ((r >> 2) % QUADS).
__device__ __forceinline__ int nn_offset(int r, int k) {
  return 4 * (r * BK + ((((k >> 2) ^ (r >> 2)) & (QUADS - 1)) << 2) + (k & 3));
}

// An NN A stage: rows m0.. of X (row stride ld), columns k0..k0 + BK, from
// `src` = &X[m0][k0]; 16 bytes (a k-quad) per copy.  MASKED: rows past
// `rleft` and columns past `kleft` read as zero.
template <int BM, int THREADS, bool MASKED>
__device__ __forceinline__ void copy_nn16(uint32_t dst, const float* src, int ld, int rleft,
                                          int kleft, const float* base) {
  constexpr int CHUNKS = BM * BK / 4;
#pragma unroll
  for (int it = 0; it < (CHUNKS + THREADS - 1) / THREADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    if (CHUNKS % THREADS != 0 && e >= CHUNKS) break;
    const int r = e / QUADS, k = (e % QUADS) * 4;
    const uint32_t to = dst + (uint32_t)nn_offset(r, k);
    if (MASKED) {
      const uint32_t bytes = r < rleft ? clamp_bytes(kleft - k, 4, 4) : 0u;
      copy16(to, bytes ? src + (r * ld + k) : base, bytes);
    } else {
      copy16(to, src + (r * ld + k), 16u);
    }
  }
}

// The same stage one element per copy (4-byte cp.async), always masked.
template <int BM, int THREADS>
__device__ __forceinline__ void copy_nn4(uint32_t dst, const float* src, int ld, int rleft,
                                         int kleft, const float* base) {
  constexpr int ELEMS = BM * BK;
#pragma unroll
  for (int it = 0; it < (ELEMS + THREADS - 1) / THREADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    if (ELEMS % THREADS != 0 && e >= ELEMS) break;
    const int r = e / BK, k = e % BK;
    const bool in = r < rleft && k < kleft;
    copy4(dst + (uint32_t)nn_offset(r, k), in ? src + (r * ld + k) : base, in ? 4u : 0u);
  }
}

// A bf16 pair word's two elements widened to f32 (exact).
__device__ __forceinline__ float widen_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float widen_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The A fragment of steps 4g .. 4g + 3: a[i][s] is row i of this thread
// (ty·4 + i, or BM/2 + ty·4 + i − 4) at step 4g + s.
template <class T, bool A_KMAJOR, typename TA>
__device__ __forceinline__ void load_a(const TA* As, int g, int ty, float (&a)[8][4]) {
  if constexpr (!A_KMAJOR) {
    // (r >> 2) % QUADS == ty % QUADS for all 8 rows
    const int slot = ((g ^ ty) & (QUADS - 1)) << 2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i < 4 ? ty * 4 + i : T::BM / 2 + ty * 4 + (i - 4);
      const float4 v = *reinterpret_cast<const float4*>(As + r * BK + slot);
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
  } else if constexpr (sizeof(TA) == 4) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const TA* row = As + (4 * g + s) * T::BM;
      const float4 v0 = *reinterpret_cast<const float4*>(row + ty * 4);
      const float4 v1 = *reinterpret_cast<const float4*>(row + T::BM / 2 + ty * 4);
      a[0][s] = v0.x;
      a[1][s] = v0.y;
      a[2][s] = v0.z;
      a[3][s] = v0.w;
      a[4][s] = v1.x;
      a[5][s] = v1.y;
      a[6][s] = v1.z;
      a[7][s] = v1.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const TA* row = As + (4 * g + s) * T::BM;
      const uint2 w0 = *reinterpret_cast<const uint2*>(row + ty * 4);
      const uint2 w1 = *reinterpret_cast<const uint2*>(row + T::BM / 2 + ty * 4);
      a[0][s] = widen_lo(w0.x);
      a[1][s] = widen_hi(w0.x);
      a[2][s] = widen_lo(w0.y);
      a[3][s] = widen_hi(w0.y);
      a[4][s] = widen_lo(w1.x);
      a[5][s] = widen_hi(w1.x);
      a[6][s] = widen_lo(w1.y);
      a[7][s] = widen_hi(w1.y);
    }
  }
}

// Steps kb .. kb + RUN − 1 of a stage on the thread's 8 × 8 accumulators, in
// ascending k.
template <class T, bool A_KMAJOR, typename TA>
__device__ __forceinline__ void compute(const TA* As, const float* Bs, int kb, int tx, int ty,
                                        float (&acc)[8][8]) {
#pragma unroll
  for (int g = kb / 4; g < kb / 4 + RUN / 4; ++g) {
    float a[8][4];
    load_a<T, A_KMAJOR>(As, g, ty, a);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float* row = Bs + (4 * g + s) * T::BN;
      const float4 b0 = *reinterpret_cast<const float4*>(row + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(row + T::BN / 2 + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][s], b[j], acc[i][j]);
    }
  }
}

// The tile at (m0, n0) of
//   NN (A_KMAJOR = false): Y = A·B, A (M×K) f32 with row stride lda;
//   TN (A_KMAJOR = true):  Y (+)= Aᵀ·B, A (K×M) f32 or bf16 with row stride lda;
// B (K×N) and Y (M×N) with row stride N.  `vec` bit 0: A's stages are copied
// 16 bytes at a time, bit 1: B's (the launcher has checked that they may be).
// COHERENT: A and B are read through L2 only (see the header).  `ring_smem`:
// the ring, Ring<T, TA>::BYTES of 16-byte aligned shared memory.  Every
// thread of the block calls it with the same tile; it returns with none of
// the block's copies in flight, after a __syncthreads().
template <bool A_KMAJOR, int MODE, typename TA, class T, bool COHERENT = false>
__device__ __forceinline__ void ring_tile(const TA* __restrict__ A, const float* __restrict__ B,
                                          float* __restrict__ Y, int64_t M, int64_t N,
                                          int64_t K, int64_t lda, int vec, int64_t m0,
                                          int64_t n0, unsigned char* ring_smem) {
  static_assert(A_KMAJOR || sizeof(TA) == 4, "the NN form takes an f32 A");
  static_assert(A_KMAJOR || !COHERENT, "the NN form's element copies of A go through L1");
  static_assert(MODE == OVERWRITE || MODE == ACCUMULATE || MODE == CONTINUE, "a tile mode");
  using R = Ring<T, TA>;

  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const int mleft = (int)(M - m0 < T::BM ? M - m0 : T::BM);
  const int nleft = (int)(N - n0 < T::BN ? N - n0 : T::BN);
  const bool interior = mleft == T::BM && nleft == T::BN;
  const int ld = (int)lda, ldb = (int)N;  // the launcher bounds both
  const int steps = (int)((K + BK - 1) / BK);
  const uint32_t ring = smem_addr(ring_smem);

  // Copies of step `step` into ring slot `slot`.
  auto load = [&](int step, int slot) {
    const int64_t k0 = (int64_t)step * BK;
    const int kleft = (int)(K - k0 < BK ? K - k0 : BK);
    const bool full = interior && kleft == BK;
    const uint32_t sa = ring + (uint32_t)(slot * R::A_BYTES);
    const uint32_t sb = ring + (uint32_t)(STAGES * R::A_BYTES + slot * R::B_BYTES);
    const TA* a = A_KMAJOR ? A + k0 * lda + m0 : A + m0 * lda + k0;
    if constexpr (A_KMAJOR) {
      if (!(vec & 1))
        copy_rows_elems<T::BM, T::THREADS, COHERENT>(sa, a, ld, mleft, kleft, A);
      else if (full)
        copy_rows16<T::BM, T::THREADS, false>(sa, a, ld, mleft, kleft, A);
      else
        copy_rows16<T::BM, T::THREADS, true>(sa, a, ld, mleft, kleft, A);
    } else {
      if (!(vec & 1))
        copy_nn4<T::BM, T::THREADS>(sa, a, ld, mleft, kleft, A);
      else if (full)
        copy_nn16<T::BM, T::THREADS, false>(sa, a, ld, mleft, kleft, A);
      else
        copy_nn16<T::BM, T::THREADS, true>(sa, a, ld, mleft, kleft, A);
    }
    const float* b = B + k0 * N + n0;
    if (!(vec & 2))
      copy_rows_elems<T::BN, T::THREADS, COHERENT>(sb, b, ldb, nleft, kleft, B);
    else if (full)
      copy_rows16<T::BN, T::THREADS, false>(sb, b, ldb, nleft, kleft, B);
    else
      copy_rows16<T::BN, T::THREADS, true>(sb, b, ldb, nleft, kleft, B);
  };

  // The first STAGES − 1 steps go in flight before anything else; one group
  // per step, empty past the end, so the wait below counts uniformly.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  if constexpr (MODE == CONTINUE) {  // the chains go on from Y, read while the ring fills
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i < 4 ? ty * 4 + i : T::BM / 2 + ty * 4 + (i - 4);
      if (r >= mleft) continue;
      const float* yrow = Y + (m0 + r) * N + n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j < 4 ? tx * 4 + j : T::BN / 2 + tx * 4 + (j - 4);
        if (c < nleft) acc[i][j] = yrow[c];
      }
    }
  }

  int slot = 0;               // the slot step `step` lands in
  int fill = STAGES - 1;      // the slot step `step + STAGES − 1` goes to
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    wait_pending<STAGES - 2>();  // this thread's copies of `step` have landed
    __syncthreads();             // everyone's have, and everyone is done with `fill`
    if (step + STAGES - 1 < steps) load(step + STAGES - 1, fill);
    commit();
    const TA* As = reinterpret_cast<const TA*>(ring_smem + slot * R::A_BYTES);
    const float* Bs = reinterpret_cast<const float*>(ring_smem + STAGES * R::A_BYTES +
                                                     slot * R::B_BYTES);
    // the runs of RUN steps this stage holds: all but in a short last stage
    const int64_t kleft = K - (int64_t)step * BK;
    const int runs = kleft >= BK ? BK / RUN : (int)((kleft + RUN - 1) / RUN);
#pragma unroll 1
    for (int run = 0; run < runs; ++run) compute<T, A_KMAJOR>(As, Bs, run * RUN, tx, ty, acc);
    slot = slot == STAGES - 1 ? 0 : slot + 1;
    fill = fill == STAGES - 1 ? 0 : fill + 1;
  }
  wait_pending<0>();

  // ---- epilogue: one add into Y after the full contraction (ACCUMULATE) ----
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i < 4 ? ty * 4 + i : T::BM / 2 + ty * 4 + (i - 4);
    if (r >= mleft) continue;
    float* yrow = Y + (m0 + r) * N + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? tx * 4 + j : T::BN / 2 + tx * 4 + (j - 4);
      if (c < nleft) yrow[c] = MODE == ACCUMULATE ? yrow[c] + acc[i][j] : acc[i][j];
    }
  }
  __syncthreads();  // every thread is done with the ring
}

// One tile per block: grid (⌈N / BN⌉, ⌈M / BM⌉), the column tiles fastest,
// so the blocks that share a row panel of A run together.
template <bool A_KMAJOR, int MODE, typename TA, class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
ring_kernel(const TA* __restrict__ A, const float* __restrict__ B, float* __restrict__ Y,
            int64_t M, int64_t N, int64_t K, int64_t lda, int vec) {
  extern __shared__ __align__(16) unsigned char ring_smem[];
  ring_tile<A_KMAJOR, MODE, TA, T>(A, B, Y, M, N, K, lda, vec, (int64_t)blockIdx.y * T::BM,
                                   (int64_t)blockIdx.x * T::BN, ring_smem);
}

// The dynamic shared memory a launch on tile T asks for: its ring (A of
// type TA), or more, so that at most T::MIN_BLOCKS blocks fit an SM.
template <class T, typename TA>
cudaError_t pinned_smem(int* smem) {
  int dev = 0, per_sm = 0, reserved = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int pin = per_sm / (T::MIN_BLOCKS + 1) - reserved + 16;
  *smem = pin > Ring<T, TA>::BYTES ? pin : Ring<T, TA>::BYTES;
  return *smem > optin ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// `kern`'s attributes set to allow `smem` bytes of dynamic shared memory, all
// of the SM's carveout for shared memory.
inline cudaError_t allow_smem(const void* kern, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

// The dynamic shared memory a launch of the kernel asks for, with the
// kernel's attributes set to allow it.
template <bool A_KMAJOR, int MODE, typename TA, class T>
cudaError_t prepare(int* smem) {
  const cudaError_t err = pinned_smem<T, TA>(smem);
  if (err != cudaSuccess) return err;
  return allow_smem((const void*)ring_kernel<A_KMAJOR, MODE, TA, T>, *smem);
}

// 16-byte copies of a matrix need a 16-byte aligned base and row stride.
inline bool rows16(const void* p, long long ld, int size) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * size) % 16 == 0;
}

// The checks every tile of a launch on T needs: sizes, 32-bit offsets inside
// a stage (rows × stride of A's stage, BK × N of B's), and 16-byte copies
// (`vec`) only where the operands allow them.  A is (M × K) or, A_KMAJOR,
// (K × M) with row stride lda; B is (K × N).
template <bool A_KMAJOR, typename TA, class T>
int check_operands(const void* a, const void* b, long long M, long long N, long long K,
                   long long lda, int vec) {
  if (M <= 0 || N <= 0 || K < 0 || K > (1LL << 30) || (N + T::BN - 1) / T::BN > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if ((A_KMAJOR ? (long long)BK : (long long)T::BM) * lda >= (1LL << 31) ||
      (long long)BK * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (((vec & 1) && !rows16(a, lda, (int)sizeof(TA))) || ((vec & 2) && !rows16(b, N, 4)))
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

template <bool A_KMAJOR, int MODE, typename TA, class T>
int launch_tile(const void* a, const void* b, void* y, long long M, long long N, long long K,
                long long lda, int vec, cudaStream_t stream) {
  const int rc = check_operands<A_KMAJOR, TA, T>(a, b, M, N, K, lda, vec);
  if (rc != 0) return rc;
  const long long tiles_m = (M + T::BM - 1) / T::BM, tiles_n = (N + T::BN - 1) / T::BN;
  if (tiles_m > 65535) return (int)cudaErrorInvalidValue;
  int smem = 0;
  const cudaError_t err = prepare<A_KMAJOR, MODE, TA, T>(&smem);
  if (err != cudaSuccess) return (int)err;
  ring_kernel<A_KMAJOR, MODE, TA, T><<<dim3((unsigned)tiles_n, (unsigned)tiles_m), T::THREADS,
                                       smem, stream>>>(
      (const TA*)a, (const float*)b, (float*)y, M, N, K, lda, vec);
  return (int)cudaGetLastError();
}

// Y (+)= op(A)·B on tile `tile` of the compiled set (plan.f32_tile's index).
template <bool A_KMAJOR, int MODE, typename TA = float>
int launch(int tile, const void* a, const void* b, void* y, long long M, long long N,
           long long K, long long lda, int vec, cudaStream_t stream) {
  switch (tile) {
    case 0:
      return launch_tile<A_KMAJOR, MODE, TA, Tile0>(a, b, y, M, N, K, lda, vec, stream);
    case 1:
      return launch_tile<A_KMAJOR, MODE, TA, Tile1>(a, b, y, M, N, K, lda, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gemm_ring
