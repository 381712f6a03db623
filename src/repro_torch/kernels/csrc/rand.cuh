// Counter-based Gaussian sketch Ω(seed) on Hopper: the device function and
// the kernel that writes a slab of it.
//
//   normal_elem     replaces src/repro/kernels/rand.py normal_tile (with
//                   threefry2x32 and _f12), which the three seeded Pallas
//                   kernels inline
//   omega_fill      writes rows [r0, r0 + rows) × columns [0, cols) of Ω,
//                   0 outside the logical (d, k̃): the materialized oracle
//                   on the card (dense_omega) and the seeded stage's slabs;
//                   in f32, or in bf16 (the reference's `.astype(q_dtype)`
//                   of the f32 tile inside its seeded kernels)
//
// Ω[i, j] = √(−2·log(2 − f0)) · cos(2π·(f1 − 1)), where (b0, b1) =
// Threefry-2x32-20(key = seed, counter = (i, j)) and f = bitcast((b >> 9) |
// 0x3F800000) ∈ [1, 2).  The bits are the reference's bitwise.  The f32
// steps use CUDA's precise logf (1 ulp) and cosf (2 ulp), IEEE sqrtf, and
// explicitly rounded __fsub_rn / __fmul_rn, so nvcc cannot contract a
// multiply and an add into an FMA and change a bit.  Never --use_fast_math
// and never __logf / __cosf: the seeded path's bitwise contract is held
// against this same function, and its tolerance against the host's libm.
//
// What bounds it: integer operations.  One element is ~85 int32 operations
// (20 rounds of add, funnel-shift rotate and xor, 5 key injections) plus
// one logf, cosf and sqrtf; it reads nothing and writes 4 bytes (2 in bf16).  The
// int32 pipe runs at half the f32 issue rate, so the bound is the int32
// operations over 64 lanes per SM per clock.  The kernel is one element
// per thread, neighbouring threads on neighbouring columns (coalesced
// stores).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rand_f32 {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds: encrypt counter (c0, c1) under key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i % 2) ? 17 : 13, r1 = (i % 2) ? 29 : 15;
    const int r2 = (i % 2) ? 16 : 26, r3 = (i % 2) ? 24 : 6;
    x0 += x1; x1 = rotl(x1, r0) ^ x0;
    x0 += x1; x1 = rotl(x1, r1) ^ x0;
    x0 += x1; x1 = rotl(x1, r2) ^ x0;
    x0 += x1; x1 = rotl(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

// uint32 bits → f32 in [1, 2) by exponent patching.
__device__ __forceinline__ float f12(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u);
}

// Ω(seed)[row, col], with the reference's arithmetic step for step.
__device__ __forceinline__ float normal_elem(uint32_t s0, uint32_t s1, uint32_t row,
                                             uint32_t col) {
  uint32_t b0, b1;
  threefry2x32(s0, s1, row, col, b0, b1);
  const float f0 = f12(b0);
  const float u1 = __fsub_rn(f12(b1), 1.0f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(__fsub_rn(2.0f, f0))));
  return __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u1)));
}

constexpr int FILL_COLS = 64;  // columns per block: 256 B of coalesced stores
constexpr int FILL_ROWS = 4;   // rows per block: 256 threads

// out[i, j] = Ω(seed)[r0 + i, j] for i < rows, j < cols (row-major, leading
// dimension cols); 0 where r0 + i ≥ d or j ≥ kt.
__global__ void __launch_bounds__(FILL_COLS * FILL_ROWS)
omega_fill_kernel(float* __restrict__ out, int64_t rows, int64_t cols, uint32_t r0,
                  int64_t d, int64_t kt, uint32_t s0, uint32_t s1) {
  const int64_t i = (int64_t)blockIdx.x * FILL_ROWS + threadIdx.y;
  const int64_t j = (int64_t)blockIdx.y * FILL_COLS + threadIdx.x;
  if (i >= rows || j >= cols) return;
  const uint32_t row = r0 + (uint32_t)i;  // global row, uint32 as the reference
  const bool inside = (int64_t)row < d && j < kt;
  out[i * cols + j] = inside ? normal_elem(s0, s1, row, (uint32_t)j) : 0.0f;
}

// The same in bf16 (out holds the raw 16 bits): each element rounded once
// from the f32 one, to nearest even — what torch's `.to(torch.bfloat16)` and
// jnp's `.astype(jnp.bfloat16)` of the f32 Ω give, so the bf16 Ω is bitwise
// omega_fill's f32 Ω cast on the card.  A kernel of its own, so that the
// f32 kernel's code is the one it always was.
__global__ void __launch_bounds__(FILL_COLS * FILL_ROWS)
omega_fill_bf16_kernel(uint16_t* __restrict__ out, int64_t rows, int64_t cols, uint32_t r0,
                       int64_t d, int64_t kt, uint32_t s0, uint32_t s1) {
  const int64_t i = (int64_t)blockIdx.x * FILL_ROWS + threadIdx.y;
  const int64_t j = (int64_t)blockIdx.y * FILL_COLS + threadIdx.x;
  if (i >= rows || j >= cols) return;
  const uint32_t row = r0 + (uint32_t)i;
  const bool inside = (int64_t)row < d && j < kt;
  const float v = inside ? normal_elem(s0, s1, row, (uint32_t)j) : 0.0f;
  out[i * cols + j] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

inline dim3 omega_fill_grid(int64_t rows, int64_t cols) {
  return dim3((unsigned)((rows + FILL_ROWS - 1) / FILL_ROWS),
              (unsigned)((cols + FILL_COLS - 1) / FILL_COLS));
}

inline cudaError_t launch_omega_fill(float* out, int64_t rows, int64_t cols, uint32_t r0,
                                     int64_t d, int64_t kt, uint32_t s0, uint32_t s1,
                                     cudaStream_t stream) {
  omega_fill_kernel<<<omega_fill_grid(rows, cols), dim3(FILL_COLS, FILL_ROWS), 0, stream>>>(
      out, rows, cols, r0, d, kt, s0, s1);
  return cudaGetLastError();
}

inline cudaError_t launch_omega_fill(uint16_t* out, int64_t rows, int64_t cols, uint32_t r0,
                                     int64_t d, int64_t kt, uint32_t s0, uint32_t s1,
                                     cudaStream_t stream) {
  omega_fill_bf16_kernel<<<omega_fill_grid(rows, cols), dim3(FILL_COLS, FILL_ROWS), 0,
                           stream>>>(out, rows, cols, r0, d, kt, s0, s1);
  return cudaGetLastError();
}

}  // namespace rand_f32
