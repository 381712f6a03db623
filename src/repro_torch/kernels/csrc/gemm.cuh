// The f32 output tile of the fused recompute kernels (recompute_f32.cu): one
// 128 × 128 tile per 256-thread block, staged through one shared-memory stage
// 16 deep in the contraction.  The staged products (gemm_nn_f32, gemm_tn_f32
// and the bf16-A form of the TN product, "tile 3") run gemm_ring.cuh's
// pipelined kernel instead; this tile stays only for the fused kernels, whose
// cooperative launch sizes its grid from this tile's occupancy, until they
// move onto the ring too.  The two compute the same FMA chains, so the fused
// kernels' staged ≡ recompute checks hold gemm_ring.cuh's kernels bitwise
// against this tile.
//
// The A operand may also be bf16 (TA = bf16_bits, phase 2 of the fused bf16
// power kernels): each element is widened to f32 as it is staged, which is
// exact, and the FMA chains are the f32 ones.
//
// The design:
//
//   * a 128×128 output tile per 256-thread block, staged through shared
//     memory 16 deep in the contraction, so each operand element loaded
//     from device memory feeds 128 FMAs;
//   * an 8×8 register micro-tile per thread (64 FMAs per 16 shared-memory
//     floats read), split as two 4-wide halves 64 apart so the float4
//     shared-memory reads of a warp are conflict-free;
//   * the A tile of the NN case is transposed into shared memory with a
//     4-float row pad, which keeps its stores to 2-way bank conflicts.
//
// The arithmetic, which the bitwise contracts rest on: each output element
// is one FMA chain `acc = fmaf(a, b, acc)` in ascending k, from 0.0f (or,
// in CONTINUE mode, from the element's current value), taken BK terms per
// step; masked loads past K are zero-filled.  No split-K, no atomics: two
// launches on the same inputs give bitwise equal outputs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm_f32 {

// A bf16 element as its raw 16 bits: the high half of the f32 it widens to.
using bf16_bits = uint16_t;

constexpr int BM = 128;      // output rows per tile
constexpr int BN = 128;      // output columns per tile
constexpr int BK = 16;       // contraction depth staged per step
constexpr int THREADS = 256; // 16 × 16 threads, 8 × 8 outputs each
constexpr int APAD = 4;      // row pad of the A tile (keeps float4 alignment)

// What a tile does with Y.
enum Mode : int {
  OVERWRITE = 0,   // Y = Σ
  ACCUMULATE = 1,  // Y = Y + Σ, one add after the full contraction
  CONTINUE = 2,    // Σ starts from Y: the FMA chain goes on where it stopped
  RUNTIME = -1,    // as a template argument: the mode is the `mode` argument
};
// The fused kernels fix phase 2's mode at compile time and read phase 1's at
// run time (OVERWRITE, or CONTINUE for the last slab of a seeded call).

// A block's shared-memory staging: 16,640 bytes.
struct Tiles {
  float As[BK][BM + APAD];
  float Bs[BK][BN];
};

// A load of an operand; COHERENT reads through L2 only (ld.global.cg),
// for data that other blocks wrote earlier in the same launch.
template <bool COHERENT>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (COHERENT) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// A bf16 element widened to f32 (exact: the low 16 bits are zero).
template <bool COHERENT>
__device__ __forceinline__ float load(const bf16_bits* p) {
  unsigned short bits;
  if constexpr (COHERENT) {
    bits = __ldcg(p);
  } else {
    bits = *p;
  }
  return __uint_as_float((uint32_t)bits << 16);
}

// The tile at (m0, n0) of Y[m, n] (+)= Σ_k op(A)[m, k] · B[k, n], all
// row-major f32 (A f32 or, widened as it is staged, bf16).
//   A_KMAJOR = false: A is (M, K) with row stride lda ≥ K — the NN product
//                     X·Q, or X[:, k0:k0+K]·Q with lda = X's width.
//   A_KMAJOR = true:  A is (K, M) with row stride lda ≥ M — the TN product
//                     Xᵀ·Y, or X[:, c0:c0+M]ᵀ·Y with lda = X's width.
// B is (K, N) and Y is (M, N), both with row stride N.  The Mode is MODE,
// or `mode_arg` when MODE is RUNTIME.  Every thread of the block calls it
// with the same tile; it ends on a __syncthreads(), so the block may
// start the next tile on the same staging at once.
template <bool A_KMAJOR, int MODE, bool COHERENT = false, typename TA = float>
__device__ __forceinline__ void gemm_tile(const TA* __restrict__ A,
                                          const float* __restrict__ B,
                                          float* __restrict__ Y, int64_t M, int64_t N,
                                          int64_t K, int64_t lda, int mode_arg,
                                          int64_t m0, int64_t n0, Tiles& sm) {
  const int mode = MODE == RUNTIME ? mode_arg : MODE;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output column group
  const int ty = tid / 16;  // output row group

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      acc[i][j] = (mode == CONTINUE && gm < M && gn < N) ? Y[gm * N + gn] : 0.0f;
    }
  }

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    // ---- stage the A tile (BM × BK) as As[k][m] ----
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      int kk, mm;
      if (A_KMAJOR) {  // neighbouring threads on neighbouring m
        kk = e / BM;
        mm = e % BM;
      } else {         // neighbouring threads on neighbouring k
        mm = e / BK;
        kk = e % BK;
      }
      const int64_t gm = m0 + mm, gk = k0 + kk;
      float v = 0.0f;
      if (gm < M && gk < K)
        v = load<COHERENT>(A_KMAJOR ? A + gk * lda + gm : A + gm * lda + gk);
      sm.As[kk][mm] = v;
    }
    // ---- stage the B tile (BK × BN) as Bs[k][n] ----
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BN, nn = e % BN;
      const int64_t gk = k0 + kk, gn = n0 + nn;
      sm.Bs[kk][nn] = (gk < K && gn < N) ? load<COHERENT>(B + gk * N + gn) : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- epilogue: one add into the accumulator, after the full contraction
  // (the same rounding as `Y + ΔY` formed separately) ----
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn >= N) continue;
      float* y = Y + gm * N + gn;
      *y = mode == ACCUMULATE ? *y + acc[i][j] : acc[i][j];
    }
  }
}

}  // namespace gemm_f32
