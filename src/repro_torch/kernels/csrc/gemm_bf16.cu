// The bf16-operand forms of the staged products on Hopper (sm_90a): bf16 X
// and Q (or A and P), exact products summed in f32, f32 output.  Five C
// entries over the tiles of gemm_bf16.cuh (tiles 1 and 2: the wgmma tile)
// and the generator of rand.cuh, launched by eight Python forms:
//
//   gemm_nn_bf16      tile 1  ← proj_stage[bf16]   replaces src/repro/kernels/powerpass.py
//                                                    _proj_stage_kernel  (P = X·Q)
//                             ← matmul_nn[bf16]    replaces src/repro/kernels/matmul.py
//                                                    _mm_nn_kernel  (O = X·Q)
//   gemm_tn_bf16      tile 2  ← powerpass_sweep[bf16]  replaces src/repro/kernels/powerpass.py
//                                                    _powerpass_sweep_kernel  (ΔY = Aᵀ·P)
//                             ← matmul_tn[bf16]    replaces src/repro/kernels/matmul.py
//                                                    _mm_tn_kernel  (O = Xᵀ·P)
//                             ← gram_sweep[bf16]   replaces src/repro/kernels/projgram.py
//                                                    _gram_sweep_kernel  (C = Pᵀ·P)
//   gemm_tn_bf16_f32  tile 3  ← powerpass_sweep[bf16,f32]  (ΔY = Aᵀ·P, A bf16, P f32):
//                               gemm_tn_f32's ring kernel (gemm_ring.cuh) with A
//                               staged as bf16 and widened as it is read
//   proj_stage_seeded_bf16    ← proj_stage_seeded[bf16]  replaces
//                     tile 1       src/repro/kernels/powerpass.py
//                                  _proj_stage_seeded_kernel at q_dtype=bfloat16
//                                  (P = X·bf16(Ω(seed)))
//   omega_fill_bf16           ← rand.omega_fill(dtype=bfloat16), counted as
//                                  omega_fill[bf16]: src/repro/kernels/rand.py
//                                  normal_tile cast once to bf16
//
// The seeded stage makes bf16 Ω(seed) in K-slabs of `slab_rows` rows
// (SEEDED_SLAB = 4096: 17 MB at k̃ = 2060) with omega_fill (bf16) into a
// scratch the wrapper allocates, and contracts each slab with tile 1 over a
// column window of X; every slab after the first CONTINUES P's chains
// (gemm_bf16.cuh), so proj_stage_seeded[bf16](x, seed) ≡
// proj_stage[bf16](x, omega_fill(seed, bf16)) bitwise.  It is bound by the
// tensor cores as proj_stage[bf16] is, plus the generator's int32 work
// (rand.cuh); one call issues 2·⌈K / slab_rows⌉ launches.
//
// The sharded fit's collectives (core/rcca_dist.py) call the bf16 × bf16
// forms; a one-rank model axis calls the fused chunk updates, whose staged
// power pass is proj_stage[bf16] then powerpass_sweep[bf16,f32] (P stays
// f32, as the reference keeps it).  The fused recompute kernels' bf16 forms
// are in recompute_f32.cu, on tiles 1 and 3.
//
// Every launch of tiles 1 and 2 takes the copy widths of its two bf16
// operands in bytes (`wa`, `wb`: 16, 8, 4 or 2, plan.copy_bytes) and is
// refused (cudaErrorMisalignedAddress) where the operand does not allow them.
// Two more entries serve chip_smoke.py only: the old mma.sync tile as a
// witness (gemm_bf16_mma.cuh), and the blocks per SM of the tile's kernels.
//
// C interface (loaded with ctypes): pointers and the stream as void*, sizes
// as long long; each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"
#include "gemm_bf16_mma.cuh"
#include "gemm_ring.cuh"
#include "rand.cuh"

using gemm_mode::ACCUMULATE;
using gemm_mode::bf16_bits;
using gemm_mode::CONTINUE;
using gemm_mode::OVERWRITE;

extern "C" {

// P (M×N, f32) = X (M×K, bf16) · Q (K×N, bf16).
int gemm_nn_bf16(const void* x, const void* q, void* p, long long M, long long N,
                 long long K, int wa, int wb, void* stream) {
  return gemm_bf16::launch<false, OVERWRITE>(x, q, p, M, N, K, K, wa, wb,
                                             (cudaStream_t)stream);
}

// O (M×N, f32) (+)= Xᵀ · Y with X (K×M) and Y (K×N) both bf16; accumulate
// != 0 adds the full contraction into O's current values in the epilogue.
int gemm_tn_bf16(const void* x, const void* y, void* o, long long M, long long N,
                 long long K, int accumulate, int wa, int wb, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return accumulate ? gemm_bf16::launch<true, ACCUMULATE>(x, y, o, M, N, K, M, wa, wb, st)
                    : gemm_bf16::launch<true, OVERWRITE>(x, y, o, M, N, K, M, wa, wb, st);
}

// O (M×N, f32) (+)= Xᵀ · Y with X (K×M) bf16 and Y (K×N) f32: the f32 TN
// kernel with X staged as bf16 and widened as its fragments are read, on tile
// `tile`, 16-byte copies where `vec` allows (as gemm_tn_f32).
int gemm_tn_bf16_f32(const void* x, const void* y, void* o, long long M, long long N,
                     long long K, int accumulate, int tile, int vec, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return accumulate
      ? gemm_ring::launch<true, ACCUMULATE, bf16_bits>(tile, x, y, o, M, N, K, M, vec, st)
      : gemm_ring::launch<true, OVERWRITE, bf16_bits>(tile, x, y, o, M, N, K, M, vec, st);
}

// P (M×N, f32) = X (M×K, bf16) · bf16(Ω(seed)) with Ω (K×N) made slab by
// slab into `slab` (≥ min(K, slab_rows) × N bf16): omega_fill (bf16), then
// tile 1 over X's column window, continuing P's chains.  slab_rows must be a
// positive multiple of gemm_bf16::BK, so that slab edges fall on stage edges
// (and X's windows keep X's copy width).
int proj_stage_seeded_bf16(const void* x, unsigned s0, unsigned s1, void* p, void* slab,
                           long long slab_rows, long long M, long long N, long long K,
                           int wa, int wb, void* stream) {
  if (slab_rows <= 0 || slab_rows % gemm_bf16::BK != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  for (long long k0 = 0; k0 < K; k0 += slab_rows) {
    const long long ks = K - k0 < slab_rows ? K - k0 : slab_rows;
    const cudaError_t err = rand_f32::launch_omega_fill((bf16_bits*)slab, ks, N,
                                                        (uint32_t)k0, K, N, s0, s1, st);
    if (err != cudaSuccess) return (int)err;
    const bf16_bits* window = (const bf16_bits*)x + k0;  // X[:, k0 : k0 + ks], stride K
    const int rc = k0 == 0
        ? gemm_bf16::launch<false, OVERWRITE>(window, slab, p, M, N, ks, K, wa, wb, st)
        : gemm_bf16::launch<false, CONTINUE>(window, slab, p, M, N, ks, K, wa, wb, st);
    if (rc != 0) return rc;
  }
  return 0;
}

// out (rows×cols, bf16) = bf16(Ω(seed)[r0 : r0 + rows, 0 : cols]), 0 outside
// (d, kt).
int omega_fill_bf16(void* out, long long rows, long long cols, unsigned r0, long long d,
                    long long kt, unsigned s0, unsigned s1, void* stream) {
  return (int)rand_f32::launch_omega_fill((bf16_bits*)out, rows, cols, r0, d, kt, s0, s1,
                                          (cudaStream_t)stream);
}

// The old mma.sync tile (gemm_bf16_mma.cuh), which no entry point launches:
// Y (M×N, f32) = X·Q (tn = 0, X M×K) or Xᵀ·Q (tn != 0, X K×M), Q (K×N),
// all row-major with packed rows.
int gemm_bf16_mma_witness(const void* x, const void* q, void* y, long long M, long long N,
                          long long K, int tn, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return tn ? gemm_bf16_mma::launch_mma<true, OVERWRITE>(x, q, y, M, N, K, M, st)
            : gemm_bf16_mma::launch_mma<false, OVERWRITE>(x, q, y, M, N, K, K, st);
}

// The blocks of the wgmma tile's NN (tn = 0) or TN kernel that one SM keeps
// resident at the tile's dynamic shared memory, by the occupancy API.
int gemm_bf16_blocks_per_sm(int tn, int* out) {
  const void* kern = tn ? (const void*)gemm_bf16::wgmma_kernel<true, OVERWRITE>
                        : (const void*)gemm_bf16::wgmma_kernel<false, OVERWRITE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         gemm_bf16::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, gemm_bf16::THREADS,
                                                        gemm_bf16::SMEM_BYTES);
  return (int)err;
}

const char* gemm_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
