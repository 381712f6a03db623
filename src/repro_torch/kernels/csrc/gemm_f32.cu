// Full-f32 tiled GEMMs for the data passes of RandomizedCCA on Hopper (sm_90a).
//
// Two kernels, one template: every product of the staged data pass is
// either NN (P = X·Q) or TN (O = Xᵀ·Y, contracting the streamed row
// dimension without forming Xᵀ).  Five Python entry points launch them:
//
//   gemm_nn_f32  ← proj_stage       replaces src/repro/kernels/powerpass.py
//                                     _proj_stage_kernel  (P = X·Q, f32)
//   proj_stage_seeded_f32           replaces src/repro/kernels/powerpass.py
//                ← proj_stage_seeded  _proj_stage_seeded_kernel  (P = X·Ω(seed))
//   gemm_tn_f32  ← powerpass_sweep  replaces src/repro/kernels/powerpass.py
//                                     _powerpass_sweep_kernel  (ΔY = Aᵀ·P)
//                ← gram_sweep       replaces src/repro/kernels/projgram.py
//                                     _gram_sweep_kernel  (C = Pᵀ·P)
//                ← matmul_tn        replaces src/repro/kernels/matmul.py
//                                     _mm_tn_kernel  (F = Paᵀ·Pb)
//
// One TN kernel serves three entry points because the three Pallas
// kernels are one contraction (matmul.py says so of the Gram itself).
//
// The seeded stage makes Ω(seed) in K-slabs of `slab_rows` rows (the
// wrapper's SEEDED_SLAB = 4096 in matmul.py: 34 MB at k̃ = 2060, so a slab
// stays in the 50 MB L2) with omega_fill
// (rand.cuh) into a scratch the wrapper allocates, and contracts each slab
// with the NN kernel over a column window of X (leading dimension d, no
// copy).  Every slab after the first CONTINUES: it loads P into the
// register accumulator before its first FMA, so each element's FMA chain
// is exactly the materialized proj_stage's (slab edges are multiples of
// BK, so no masked zero term falls inside the contraction).  Hence
// proj_stage_seeded(x, seed) == proj_stage(x, omega_fill(seed)) bitwise.
// Making each Ω tile inside every GEMM block instead would make each
// element 8192/128 = 64 times per chunk, ~2.7× the GEMM's own work; one
// slab pass makes it once, ~1 % of the GEMM.  One call issues
// 2·⌈d / slab_rows⌉ launches (256 at d = 2^19).
//
// What bounds them on this card: arithmetic.  At the main path's shapes
// (8192 rows, d = 2^19, k̃ = 2060) each P = X·Q and each ΔY = Aᵀ·P is
// 1.77e13 FLOP against 21.5 GB of operands: ~820 FLOP per byte, far
// above the card's f32 balance point (67 TFLOP/s ÷ 3.35 TB/s ≈ 20).
// The reference is f32 end to end and parity is held near 1e-5 relative,
// so the tensor cores (TF32 at best) are out and the ceiling is the
// CUDA cores' f32 FMA rate.  The design therefore spends its effort on
// FMA density, not on bytes:
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
// Ragged edges are masked (zero-filled loads, guarded stores); nothing
// is padded in device memory.  There is no split-K and no atomicAdd:
// each output element is contracted by one thread, in ascending k, in
// one block, so two launches on the same inputs give bitwise equal
// outputs.  The kernels allocate nothing; the Python wrappers allocate
// outputs and check device, dtype, shape and contiguity.
//
// C interface (loaded with ctypes): pointers and the stream as void*,
// sizes as long long, each entry returns cudaGetLastError() after its
// launch, so a refused launch surfaces as a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rand.cuh"

namespace {

constexpr int BM = 128;      // output rows per block
constexpr int BN = 128;      // output columns per block
constexpr int BK = 16;       // contraction depth staged per step
constexpr int THREADS = 256; // 16 × 16 threads, 8 × 8 outputs each
constexpr int APAD = 4;      // row pad of the A tile (keeps float4 alignment)

// What the kernel does with Y.
enum Mode : int {
  OVERWRITE = 0,   // Y = Σ
  ACCUMULATE = 1,  // Y = Y + Σ, one add after the full contraction
  CONTINUE = 2,    // Σ starts from Y: the FMA chain goes on where it stopped
  RUNTIME = -1,    // as a template argument: the mode is the `mode` argument
};
// The TN launches fix the mode at compile time, the NN launches read it at
// run time: the register allocation ptxas finds is better that way for
// each.  With a fixed mode the TN kernels spill 0 and 8 bytes (24 bytes
// more with a runtime mode, and slower); the NN kernel spilled 68 bytes
// and its continue instance 252, and both ran slower (PERF.md).

// Y[m, n] (+)= Σ_k op(A)[m, k] · B[k, n], all row-major f32.
//   A_KMAJOR = false: A is (M, K) with row stride lda ≥ K — the NN product
//                     X·Q, or X[:, k0:k0+K]·Q with lda = X's width.
//   A_KMAJOR = true:  A is (K, M) with row stride lda ≥ M — the TN product Xᵀ·Y.
// B is (K, N) in both cases; Y is (M, N).  The Mode is MODE, or `mode`
// when MODE is RUNTIME.
template <bool A_KMAJOR, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ Y, int64_t M, int64_t N, int64_t K,
                int64_t lda, int mode_arg) {
  const int mode = MODE == RUNTIME ? mode_arg : MODE;
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output column group
  const int ty = tid / 16;  // output row group
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int64_t n0 = (int64_t)blockIdx.y * BN;

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
      if (gm < M && gk < K) v = A_KMAJOR ? A[gk * lda + gm] : A[gm * lda + gk];
      As[kk][mm] = v;
    }
    // ---- stage the B tile (BK × BN) as Bs[k][n] ----
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e / BN, nn = e % BN;
      const int64_t gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? B[gk * N + gn] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
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

template <bool A_KMAJOR, int MODE>
int launch(const void* a, const void* b, void* y, long long M, long long N,
           long long K, long long lda, int mode, void* stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  gemm_f32_kernel<A_KMAJOR, MODE><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)y, M, N, K, lda, mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// P (M×N) = X (M×K) · Q (K×N).
int gemm_nn_f32(const void* x, const void* q, void* p, long long M,
                long long N, long long K, void* stream) {
  return launch<false, RUNTIME>(x, q, p, M, N, K, K, OVERWRITE, stream);
}

// P (M×N) = X (M×K) · Ω(seed) with Ω (K×N) made slab by slab into
// `slab` (≥ min(K, slab_rows) × N floats): omega_fill, then the NN
// kernel over X's column window, continuing P's FMA chains.  slab_rows
// must be a positive multiple of BK, so that slab edges fall on BK steps.
int proj_stage_seeded_f32(const void* x, unsigned s0, unsigned s1, void* p,
                          void* slab, long long slab_rows, long long M, long long N,
                          long long K, void* stream) {
  if (slab_rows <= 0 || slab_rows % BK != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  for (long long k0 = 0; k0 < K; k0 += slab_rows) {
    const long long ks = K - k0 < slab_rows ? K - k0 : slab_rows;
    cudaError_t err = rand_f32::launch_omega_fill((float*)slab, ks, N, (uint32_t)k0,
                                                  K, N, s0, s1, st);
    if (err != cudaSuccess) return (int)err;
    const float* window = (const float*)x + k0;  // X[:, k0 : k0 + ks], row stride K
    const int rc = launch<false, RUNTIME>(window, slab, p, M, N, ks, K,
                                          k0 == 0 ? OVERWRITE : CONTINUE, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

// out (rows×cols) = Ω(seed)[r0 : r0 + rows, 0 : cols], 0 outside (d, kt).
int omega_fill_f32(void* out, long long rows, long long cols, unsigned r0,
                   long long d, long long kt, unsigned s0, unsigned s1, void* stream) {
  return (int)rand_f32::launch_omega_fill((float*)out, rows, cols, r0, d, kt, s0, s1,
                                          (cudaStream_t)stream);
}

// O (M×N) (+)= Xᵀ · Y with X (K×M), Y (K×N); accumulate != 0 adds the
// full contraction into O's current values in the epilogue.
int gemm_tn_f32(const void* x, const void* y, void* o, long long M,
                long long N, long long K, int accumulate, void* stream) {
  return accumulate ? launch<true, ACCUMULATE>(x, y, o, M, N, K, M, ACCUMULATE, stream)
                    : launch<true, OVERWRITE>(x, y, o, M, N, K, M, OVERWRITE, stream);
}

const char* gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
