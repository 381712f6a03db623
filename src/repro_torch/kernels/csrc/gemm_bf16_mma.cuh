// The bf16 tensor-core tile of PRs 17-19, kept only as a witness: no entry
// point of the package launches it.  gemm_bf16.cu's `gemm_bf16_mma_witness`
// runs it so that chip_smoke.py can set its outputs beside the wgmma tile's
// (gemm_bf16.cuh), element by element, and time it in the same call.
//
// The design it had: a 128 × 128 output tile per 256-thread block, 8 warps
// of 64 × 32, each warp 4 × 4 mma.sync.m16n8k16 (bf16 in, f32 out) per
// 16-deep k step; operands staged 32 deep in shared memory (rows padded by
// 16 bytes) and read with ldmatrix (.trans for the k-major operands), one
// stage of register prefetch.  Each 16-deep step is one mma from zero,
// added into the f32 accumulator with one IEEE add, as the wgmma tile's.
// Whether a wgmma k16 product from zero has the bits of an mma.sync
// m16n8k16 from zero is what the witness shows; no contract rests on it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mode.cuh"

namespace gemm_bf16_mma {

using gemm_mode::ACCUMULATE;
using gemm_mode::bf16_bits;
using gemm_mode::CONTINUE;
using gemm_mode::OVERWRITE;

constexpr int BM = 128;      // output rows per tile
constexpr int BN = 128;      // output columns per tile
constexpr int BK = 32;       // contraction depth staged per step (two mma steps)
constexpr int THREADS = 256; // 8 warps: 2 (rows) × 4 (columns) of 64 × 32
constexpr int PAD = 8;       // row pad in elements (16 bytes)
constexpr int A_MK_LD = BK + PAD;  // NN: the A tile as As[m][k]
constexpr int A_KM_LD = BM + PAD;  // TN: the A tile as As[k][m]
constexpr int B_LD = BN + PAD;     // the B tile as Bs[k][n]
constexpr int CHUNKS = BM * BK / 8 / THREADS;  // 8-element loads per thread and operand
static_assert(BM * BK == BK * BN, "both operand tiles hold the same number of chunks");
static_assert(BM * A_MK_LD >= BK * A_KM_LD, "the A staging holds either layout");

// A block's shared-memory staging: 18,944 bytes.
struct Tiles {
  bf16_bits A[BM * A_MK_LD];
  bf16_bits B[BK * B_LD];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Elements [col, col + 8) of row `row` of a (rows × cols) row-major bf16
// matrix with row stride ld, packed two to a word (element 0 in the low
// half); zeros past the matrix.
__device__ __forceinline__ uint4 load_chunk(const bf16_bits* __restrict__ base, int64_t ld,
                                            int64_t row, int64_t col, int64_t rows,
                                            int64_t cols) {
  if (row >= rows || col >= cols) return make_uint4(0u, 0u, 0u, 0u);
  const bf16_bits* p = base + row * ld + col;
  if (col + 8 <= cols) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    if ((addr & 15) == 0) return *reinterpret_cast<const uint4*>(p);
    if ((addr & 7) == 0) {
      const uint2 lo = reinterpret_cast<const uint2*>(p)[0];
      const uint2 hi = reinterpret_cast<const uint2*>(p)[1];
      return make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    if ((addr & 3) == 0) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = col + 2 * i < cols ? (uint32_t)p[2 * i] : 0u;
    const uint32_t hi = col + 2 * i + 1 < cols ? (uint32_t)p[2 * i + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One stage's global loads into registers: this thread's chunks of the A
// tile (rows m0.., columns k0.. of X; or rows k0.., columns m0.. of a
// k-major A) and of the B tile (rows k0.., columns n0..).
template <bool A_KMAJOR>
__device__ __forceinline__ void fetch(const bf16_bits* __restrict__ A,
                                      const bf16_bits* __restrict__ B, int64_t M, int64_t N,
                                      int64_t K, int64_t lda, int64_t m0, int64_t n0,
                                      int64_t k0, uint4 (&ra)[CHUNKS], uint4 (&rb)[CHUNKS]) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    ra[i] = A_KMAJOR ? load_chunk(A, lda, k0 + (e >> 4), m0 + (e & 15) * 8, K, M)
                     : load_chunk(A, lda, m0 + (e >> 2), k0 + (e & 3) * 8, M, K);
    rb[i] = load_chunk(B, N, k0 + (e >> 4), n0 + (e & 15) * 8, K, N);
  }
}

template <bool A_KMAJOR>
__device__ __forceinline__ void stash(const uint4 (&ra)[CHUNKS], const uint4 (&rb)[CHUNKS],
                                      Tiles& sm) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    bf16_bits* a = A_KMAJOR ? &sm.A[(e >> 4) * A_KM_LD + (e & 15) * 8]
                            : &sm.A[(e >> 2) * A_MK_LD + (e & 3) * 8];
    *reinterpret_cast<uint4*>(a) = ra[i];
    *reinterpret_cast<uint4*>(&sm.B[(e >> 4) * B_LD + (e & 15) * 8]) = rb[i];
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d = a · b for one 16 × 8 × 16 step, from zero.
__device__ __forceinline__ void mma_step(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  const float z = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z), "f"(z),
        "f"(z), "f"(z));
}

// The tile at (m0, n0) of Y (+)= op(A) · B, Y row-major f32 with row stride N.
//   A_KMAJOR = false: A is X (M × K) with row stride lda ≥ K — tile 1;
//   A_KMAJOR = true:  A is (K × M) with row stride lda ≥ M — tile 2, Aᵀ·B.
// B is (K × N) with row stride N.  MODE is OVERWRITE, ACCUMULATE (one add
// into Y after the full contraction) or CONTINUE (the chains start from Y:
// the seeded slabs after the first).  Every thread of the block calls it
// with the same tile; it ends on a __syncthreads(), so the block may start
// the next tile on the same staging at once.
template <bool A_KMAJOR, int MODE>
__device__ __forceinline__ void mma_tile(const bf16_bits* __restrict__ A,
                                         const bf16_bits* __restrict__ B,
                                         float* __restrict__ Y, int64_t M, int64_t N,
                                         int64_t K, int64_t lda, int64_t m0, int64_t n0,
                                         Tiles& sm) {
  static_assert(MODE == OVERWRITE || MODE == ACCUMULATE || MODE == CONTINUE, "a tile mode");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64;  // the warp's rows within the tile
  const int wn = (warp & 3) * 32;   // and columns
  // element r of fragment (i, j) is row g + 8·(r / 2), column 2·(lane % 4)
  // + r % 2 of that 16 × 8 tile
  const int g = lane >> 2, c2 = (lane & 3) * 2;

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment element]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t gm = m0 + wm + i * 16 + g + (r >> 1) * 8;
        const int64_t gn = n0 + wn + j * 8 + c2 + (r & 1);
        acc[i][j][r] = (MODE == CONTINUE && gm < M && gn < N) ? Y[gm * N + gn] : 0.0f;
      }

  uint4 ra[CHUNKS], rb[CHUNKS];
  fetch<A_KMAJOR>(A, B, M, N, K, lda, m0, n0, 0, ra, rb);
  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    stash<A_KMAJOR>(ra, rb, sm);
    __syncthreads();
    if (k0 + BK < K) fetch<A_KMAJOR>(A, B, M, N, K, lda, m0, n0, k0 + BK, ra, rb);

#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mb = wm + i * 16;
        if (A_KMAJOR)  // matrices (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
          ldmatrix_x4_trans(af[i], smem_addr(&sm.A[(ks + (lane & 7) + ((lane >> 4) << 3)) * A_KM_LD
                                                   + mb + (((lane >> 3) & 1) << 3)]));
        else           // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
          ldmatrix_x4(af[i], smem_addr(&sm.A[(mb + (lane & 15)) * A_MK_LD + ks
                                             + ((lane >> 4) << 3)]));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // two n8 tiles per load: (k 0-7, n 0-7), (k 8-15, n 0-7), ...
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(&sm.B[(ks + (lane & 15)) * B_LD + wn + j * 16
                                             + ((lane >> 4) << 3)]));
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float d[4];
          mma_step(d, af[i], bf[j][0], bf[j][1]);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = __fadd_rn(acc[i][j][r], d[r]);
        }
    }
    __syncthreads();
  }

  // ---- epilogue: the fragment layout of the loads above; one add into Y
  // when accumulating
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t gm = m0 + wm + i * 16 + g + (r >> 1) * 8;
        const int64_t gn = n0 + wn + j * 8 + c2 + (r & 1);
        if (gm < M && gn < N) {
          float* y = Y + gm * N + gn;
          *y = MODE == ACCUMULATE ? __fadd_rn(*y, acc[i][j][r]) : acc[i][j][r];
        }
      }
}

// One tile per block: grid (⌈N / BN⌉, ⌈M / BM⌉), the column tiles fastest,
// so the blocks that share a row panel of A run together and read it from L2.
template <bool A_KMAJOR, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
mma_kernel(const bf16_bits* __restrict__ A, const bf16_bits* __restrict__ B,
           float* __restrict__ Y, int64_t M, int64_t N, int64_t K, int64_t lda) {
  __shared__ __align__(16) Tiles sm;
  mma_tile<A_KMAJOR, MODE>(A, B, Y, M, N, K, lda, (int64_t)blockIdx.y * BM,
                           (int64_t)blockIdx.x * BN, sm);
}

template <bool A_KMAJOR, int MODE>
int launch_mma(const void* a, const void* b, void* y, long long M, long long N, long long K,
               long long lda, cudaStream_t stream) {
  const long long tiles_m = (M + BM - 1) / BM;
  if (tiles_m > 65535) return (int)cudaErrorInvalidConfiguration;  // gridDim.y
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)tiles_m);
  mma_kernel<A_KMAJOR, MODE><<<grid, THREADS, 0, stream>>>(
      (const bf16_bits*)a, (const bf16_bits*)b, (float*)y, M, N, K, lda);
  return (int)cudaGetLastError();
}

}  // namespace gemm_bf16_mma
