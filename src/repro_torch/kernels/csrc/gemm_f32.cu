// Full-f32 GEMMs for the data passes of RandomizedCCA on Hopper (sm_90a).
//
// Two kernels, one template (gemm_ring.cuh): every product of the staged
// data pass is either NN (P = X·Q) or TN (O = Xᵀ·Y, contracting the streamed
// row dimension without forming Xᵀ).  Five Python entry points launch them:
//
//   gemm_nn_f32  ← proj_stage       replaces src/repro/kernels/powerpass.py
//                                     _proj_stage_kernel  (P = X·Q, f32)
//                ← matmul_nn        replaces src/repro/kernels/matmul.py
//                                     _mm_nn_kernel  (O = X·Q)
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
// Each launch is one output tile per block through a 4-stage cp.async ring
// (gemm_ring.cuh: the design, what bounds it, and its FMA chains; the fused
// recompute kernels run the same tile in both phases).  Every entry takes `tile`,
// the index of the tile shape plan.f32_tile picked for the output's waves,
// and `vec`, which operands plan.copies found 16-byte aligned (bit 0: the
// A operand, bit 1: B); the launch refuses a tile it does not have and a
// 16-byte copy its pointers do not allow.
//
// The seeded stage makes Ω(seed) in K-slabs of `slab_rows` rows (the
// wrapper's SEEDED_SLAB = 4096 in plan.py: 34 MB at k̃ = 2060, so a slab
// stays in the 50 MB L2) with omega_fill (rand.cuh) into a scratch the
// wrapper allocates, and contracts each slab with the NN kernel over a
// column window of X (leading dimension d, no copy).  Every slab after the
// first CONTINUES: it loads P into the register accumulator before its first
// FMA, so each element's FMA chain is exactly the materialized proj_stage's
// (slab edges are multiples of the ring's BK, so no masked zero term falls
// inside the contraction).  Hence proj_stage_seeded(x, seed) ==
// proj_stage(x, omega_fill(seed)) bitwise.  Making each Ω tile inside every
// GEMM block instead would make each element 8192/128 = 64 times per chunk,
// ~2.7× the GEMM's own work; one slab pass makes it once, ~1 % of the GEMM.
// One call issues 2·⌈d / slab_rows⌉ launches (256 at d = 2^19).
//
// The Python wrappers allocate outputs and check device, dtype, shape and
// contiguity; the kernels allocate nothing.
//
// C interface (loaded with ctypes): pointers and the stream as void*,
// sizes as long long, each entry returns cudaGetLastError() after its
// launch, so a refused launch surfaces as a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_ring.cuh"
#include "rand.cuh"

using gemm_mode::ACCUMULATE;
using gemm_mode::CONTINUE;
using gemm_mode::OVERWRITE;

namespace {

int blocks_per_sm(int tn, int tile, int* out) {
  int smem = 0;
  cudaError_t err = cudaErrorInvalidValue;
  const void* kern = nullptr;
  if (tn == 0 && tile == 0) {
    err = gemm_ring::prepare<false, OVERWRITE, float, gemm_ring::Tile0>(&smem);
    kern = (const void*)gemm_ring::ring_kernel<false, OVERWRITE, float, gemm_ring::Tile0>;
  } else if (tn == 0 && tile == 1) {
    err = gemm_ring::prepare<false, OVERWRITE, float, gemm_ring::Tile1>(&smem);
    kern = (const void*)gemm_ring::ring_kernel<false, OVERWRITE, float, gemm_ring::Tile1>;
  } else if (tn == 1 && tile == 0) {
    err = gemm_ring::prepare<true, OVERWRITE, float, gemm_ring::Tile0>(&smem);
    kern = (const void*)gemm_ring::ring_kernel<true, OVERWRITE, float, gemm_ring::Tile0>;
  } else if (tn == 1 && tile == 1) {
    err = gemm_ring::prepare<true, OVERWRITE, float, gemm_ring::Tile1>(&smem);
    kern = (const void*)gemm_ring::ring_kernel<true, OVERWRITE, float, gemm_ring::Tile1>;
  }
  if (err != cudaSuccess) return (int)err;
  const int threads = tile == 0 ? gemm_ring::Tile0::THREADS : gemm_ring::Tile1::THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, threads, smem);
}

}  // namespace

extern "C" {

// P (M×N) = X (M×K) · Q (K×N).
int gemm_nn_f32(const void* x, const void* q, void* p, long long M, long long N,
                long long K, int tile, int vec, void* stream) {
  return gemm_ring::launch<false, OVERWRITE>(tile, x, q, p, M, N, K, K, vec,
                                             (cudaStream_t)stream);
}

// P (M×N) = X (M×K) · Ω(seed) with Ω (K×N) made slab by slab into
// `slab` (≥ min(K, slab_rows) × N floats): omega_fill, then the NN
// kernel over X's column window, continuing P's FMA chains.  slab_rows
// must be a positive multiple of the ring's BK, so that slab edges fall on
// staging steps; `vec` bit 0 holds for every window when it holds for X.
int proj_stage_seeded_f32(const void* x, unsigned s0, unsigned s1, void* p,
                          void* slab, long long slab_rows, long long M, long long N,
                          long long K, int tile, int vec, void* stream) {
  if (slab_rows <= 0 || slab_rows % gemm_ring::BK != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  for (long long k0 = 0; k0 < K; k0 += slab_rows) {
    const long long ks = K - k0 < slab_rows ? K - k0 : slab_rows;
    cudaError_t err = rand_f32::launch_omega_fill((float*)slab, ks, N, (uint32_t)k0,
                                                  K, N, s0, s1, st);
    if (err != cudaSuccess) return (int)err;
    const float* window = (const float*)x + k0;  // X[:, k0 : k0 + ks], row stride K
    const int rc =
        k0 == 0 ? gemm_ring::launch<false, OVERWRITE>(tile, window, slab, p, M, N, ks, K, vec, st)
                : gemm_ring::launch<false, CONTINUE>(tile, window, slab, p, M, N, ks, K, vec, st);
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
int gemm_tn_f32(const void* x, const void* y, void* o, long long M, long long N,
                long long K, int accumulate, int tile, int vec, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return accumulate ? gemm_ring::launch<true, ACCUMULATE>(tile, x, y, o, M, N, K, M, vec, st)
                    : gemm_ring::launch<true, OVERWRITE>(tile, x, y, o, M, N, K, M, vec, st);
}

// *out = the blocks of the f32 NN (tn = 0) or TN (tn = 1) kernel on tile
// `tile` that one SM keeps resident (the occupancy API): the plan's design
// value, checked on the card.
int gemm_f32_blocks_per_sm(int tn, int tile, void* out) {
  return blocks_per_sm(tn, tile, (int*)out);
}

const char* gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
