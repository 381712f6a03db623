// The bf16-operand forms of the staged products on Hopper (sm_90a): bf16 X
// and Q (or A and P), exact products summed in f32, f32 output.  Three C
// entries over the tiles of gemm_bf16.cuh, launched by six Python forms:
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
//   gemm_tn_bf16_f32  tile 3  ← powerpass_sweep[bf16,f32]  (ΔY = Aᵀ·P, A bf16, P f32)
//
// The sharded fit's collectives (core/rcca_dist.py) call the bf16 × bf16
// forms; a one-rank model axis calls the fused chunk updates, whose staged
// power pass is proj_stage[bf16] then powerpass_sweep[bf16,f32] (P stays
// f32, as the reference keeps it).  The fused recompute kernels' bf16 forms
// are in recompute_f32.cu, on tiles 1 and 3.
//
// C interface (loaded with ctypes): pointers and the stream as void*, sizes
// as long long; each entry returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"

using gemm_bf16::launch_mma;
using gemm_f32::ACCUMULATE;
using gemm_f32::bf16_bits;
using gemm_f32::launch_gemm;
using gemm_f32::OVERWRITE;

extern "C" {

// P (M×N, f32) = X (M×K, bf16) · Q (K×N, bf16).
int gemm_nn_bf16(const void* x, const void* q, void* p, long long M, long long N,
                 long long K, void* stream) {
  return launch_mma<false, OVERWRITE>(x, q, p, M, N, K, K, (cudaStream_t)stream);
}

// O (M×N, f32) (+)= Xᵀ · Y with X (K×M) and Y (K×N) both bf16; accumulate
// != 0 adds the full contraction into O's current values in the epilogue.
int gemm_tn_bf16(const void* x, const void* y, void* o, long long M, long long N,
                 long long K, int accumulate, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return accumulate ? launch_mma<true, ACCUMULATE>(x, y, o, M, N, K, M, st)
                    : launch_mma<true, OVERWRITE>(x, y, o, M, N, K, M, st);
}

// O (M×N, f32) (+)= Xᵀ · Y with X (K×M) bf16 and Y (K×N) f32: the f32 tile
// with X widened as it is staged.
int gemm_tn_bf16_f32(const void* x, const void* y, void* o, long long M, long long N,
                     long long K, int accumulate, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return accumulate
      ? launch_gemm<true, ACCUMULATE, bf16_bits>(x, y, o, M, N, K, M, ACCUMULATE, st)
      : launch_gemm<true, OVERWRITE, bf16_bits>(x, y, o, M, N, K, M, OVERWRITE, st);
}

const char* gemm_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
