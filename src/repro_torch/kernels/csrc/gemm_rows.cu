// The serving form of O = x·X on Hopper (sm_90a): a split-K f32 product
// whose bits depend on K alone.
//
//   gemm_rows_f32 ← project_rows     the port's own serving kernel: O = x·X
//                                      on the serving path (serve/projector.py
//                                      project, hence the BatchedProjector,
//                                      CorpusIndex.from_store and the drift
//                                      monitor).  The JAX package serves with
//                                      XLA's x @ X (src/repro/serve/
//                                      projector.py:50), no Pallas kernel.
//
// The reduction contract, which every bitwise claim of serving rests on:
//
//   * K is cut into segments of KSEG rows of X, a power of two fixed here
//     and never chosen per launch: segment s holds k in
//     [s·KSEG, min((s + 1)·KSEG, K)), and there are S = ⌈K / KSEG⌉ of them.
//   * Segment s's partial of element (i, j) is one chain
//     `acc = fmaf(x[i][k], X[k][j], acc)` in ascending k from 0.0f over that
//     segment's terms and no others (a short last stage runs only its steps).
//   * The S partials are combined by one fixed tree: padded with +0.0f to
//     P, the least power of two ≥ S, and added in pairs level by level
//     (partials 2m and 2m + 1 into m) until one is left.  Its shape depends
//     on S only.  kernels/ref.py project_rows_ref follows the same segments
//     and the same tree in torch ops.
//   * No atomics on values, and no order that depends on M, the grid, the
//     tile, the slice of rows a launch covers, or the other rows.
//
// Hence O[i][j] is a function of x[i], X and K alone: row i's embedding has
// the same bits in a launch of 1, 32, 512 or 8192 rows.  matmul_nn
// (gemm_nn_f32, one chain over the whole K) stays as it is, bitwise
// proj_stage, for the sharded fit's unfused collective.
//
// What bounds it on this card.  At the serving shapes (K = 2^19, N = 60,
// M ≤ 512) X is 126 MB: at M ≤ 32 the launch is bound by the bytes of X and
// x (0.038 ms at M = 1), at M = 512 by f32 operations (32.2 GFLOP, 0.48 ms
// at 67 TFLOP/s).  gemm_nn_f32 gives such an output one 128 × 128 tile, so
// one block on one of the 132 SMs carries the whole contraction (54 ms).
// The design:
//
//   * The grid spreads K.  A segment kernel's block computes one segment's
//     partials of a BM × BN output tile: grid (row tiles, S, column tiles),
//     the row tiles fastest, so that the blocks sharing a segment of X run
//     together and X comes from HBM about once per launch.  At K = 2^19
//     that is 512 blocks already at M = 1.
//   * Two tiles, one arithmetic.  Tile0 is 16 × 64 (a thread: 1 row × 4
//     columns; 5 blocks per SM, so M ≤ 16 runs in one wave), Tile1 64 × 64
//     (a thread: 4 rows × 4 columns, 16 independent chains; 3 blocks per
//     SM).  plan.rows_tile takes Tile0 while one of its row tiles holds all
//     M rows, Tile1 beyond: at M = 1 a warp of Tile1 spends 16 FFMAs a step
//     where one row needs 4, at M = 32 Tile0 reads shared memory twice as
//     often per FFMA (scripts/rows_tiles.py times both tiles).
//     Each chain is the contract's on either tile, so are the bits.
//   * The ring.  STAGES = 4 stages of BK = 32 steps in dynamic shared memory
//     (40 KB on Tile0, 64 KB on Tile1), filled with gemm_ring.cuh's copies:
//     x into [BM][BK] with its k-quad swizzle, X into [BK][BN], 16 bytes a
//     copy where plan.copies allows it, else 4; rows past M, columns past N
//     and steps past the segment zero-filled.  Per 4 steps a thread reads
//     one 16-byte k-quad of each of its rows and one 16-byte quad of X per
//     step: on Tile1 3 shared-memory wavefronts a warp per 16 FFMAs, so the
//     FFMA pipes, not shared memory, set the pace.  A warp whose rows all
//     lie past M skips the arithmetic (it still copies).
//   * The tree kernel.  One thread per output element of the slice reads its
//     S partials (coalesced across the warp: the scratch is [S][rows][N]),
//     32 at a time into registers, reduces each aligned run of 32 by the
//     full binary tree there, and combines the runs' values with a binary
//     counter (a small stack) — the same padded tree, padding runs included.
//   * Slices of rows.  The wrapper's scratch holds S × rows × N partials,
//     rows = plan.rows_slice (the whole launch at the serving shapes); a
//     larger M runs slice by slice, both kernels per slice, in one C call.
//
// No TF32, wgmma or mma on f32 operands (the f32 precision rule):
// chip_smoke.py checks the SASS for HGMMA and HMMA.
//
// C interface (loaded with ctypes): pointers and the stream as void*, sizes
// as long long; the entry returns the first non-zero cudaGetLastError()
// after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_ring.cuh"

namespace gemm_rows {

constexpr int KSEG = 1024;  // rows of X per segment: the contract's one constant
constexpr int BN = 64;      // columns of X per segment block
constexpr int THREADS = 256;
constexpr int BK = gemm_ring::BK;  // steps per stage (32)
constexpr int STAGES = 4;
constexpr int QUADS = gemm_ring::QUADS;
constexpr int B_BYTES = BK * BN * 4;
constexpr int TREE_THREADS = 256;
constexpr int RUN = 32;  // partials a tree thread holds in registers at once
static_assert((KSEG & (KSEG - 1)) == 0 && KSEG % BK == 0, "a segment is whole stages");
static_assert(THREADS == 8 * 32 && BN == 16 * 4, "8 warps, 16 column quads a row group");
static_assert((RUN & (RUN - 1)) == 0, "a run is a subtree of the padded tree");

// A segment block's tile: TM rows × 4 columns a thread, two row groups a
// warp, so BM = 16·TM rows by BN columns; its ring; MIN_BLOCKS per SM.
// plan.py ROWS_TILES lists the same shapes in this order.
template <int TM_, int MIN_BLOCKS_>
struct Tile {
  static_assert(TM_ == 1 || TM_ == 4, "a thread's rows share one swizzle key");
  static constexpr int TM = TM_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int BM = 16 * TM;
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int SMEM = STAGES * (A_BYTES + B_BYTES);
};
using Tile0 = Tile<1, 5>;  // 16 × 64: a handful of rows (the projector's buckets)
using Tile1 = Tile<4, 3>;  // 64 × 64

// The shared float offset of k-quad g of row i of the thread's TM rows
// (gemm_ring.cuh's swizzle: quad q of row r at slot q ^ ((r >> 2) % QUADS);
// r >> 2 is (TM·ty) >> 2 for each of the thread's rows).
template <class T>
__device__ __forceinline__ int quad_at(int ty, int i, int g) {
  return (T::TM * ty + i) * BK + (((g ^ ((T::TM * ty) >> 2)) & (QUADS - 1)) << 2);
}

// A full stage: BK steps in ascending k on the thread's TM × 4 chains.
template <class T>
__device__ __forceinline__ void stage(const float* As, const float* Bs, int tx, int ty,
                                      float (&acc)[T::TM][4]) {
#pragma unroll
  for (int g = 0; g < QUADS; ++g) {
    float a[T::TM][4];
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(As + quad_at<T>(ty, i, g));
      a[i][0] = v.x;
      a[i][1] = v.y;
      a[i][2] = v.z;
      a[i][3] = v.w;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 b4 = *reinterpret_cast<const float4*>(Bs + (4 * g + s) * BN + 4 * tx);
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][s], b[j], acc[i][j]);
    }
  }
}

// A segment's short last stage: its first `steps` steps only.
template <class T>
__device__ __forceinline__ void steps_of(const float* As, const float* Bs, int steps, int tx,
                                         int ty, float (&acc)[T::TM][4]) {
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    const float4 b4 = *reinterpret_cast<const float4*>(Bs + k * BN + 4 * tx);
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const float a = As[quad_at<T>(ty, i, k >> 2) + (k & 3)];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
    }
  }
}

// part[s][r][c] = segment s's partial of O[r][c] for the M rows of x (row
// stride K) this launch covers: grid (⌈M / BM⌉, S, ⌈N / BN⌉).
template <class T>
__global__ void __launch_bounds__(THREADS, T::MIN_BLOCKS)
segment_kernel(const float* __restrict__ x, const float* __restrict__ X,
               float* __restrict__ part, int64_t M, int64_t N, int64_t K, int vec) {
  constexpr int BM = T::BM, TM = T::TM, A_BYTES = T::A_BYTES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t m0 = (int64_t)blockIdx.x * BM, n0 = (int64_t)blockIdx.z * BN;
  const int64_t s = blockIdx.y, k0 = s * KSEG;
  const int klen = (int)(K - k0 < KSEG ? K - k0 : KSEG);
  const int mleft = (int)(M - m0 < BM ? M - m0 : BM);
  const int nleft = (int)(N - n0 < BN ? N - n0 : BN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = 2 * warp + lane / 16;  // rows TM·ty .. TM·ty + TM − 1
  const int tx = lane % 16;             // columns 4·tx .. 4·tx + 3
  const bool live = 2 * TM * warp < mleft;  // the warp has a row of x
  const int steps = (klen + BK - 1) / BK;
  const int ld = (int)K, ldb = (int)N;  // the launcher bounds both
  const float* xs = x + m0 * K + k0;
  const float* Xs = X + k0 * N + n0;
  const uint32_t ring = gemm_ring::smem_addr(smem);

  auto load = [&](int step, int slot) {
    const int kk = step * BK;
    const int kleft = klen - kk < BK ? klen - kk : BK;
    const uint32_t sa = ring + (uint32_t)(slot * A_BYTES);
    const uint32_t sb = ring + (uint32_t)(STAGES * A_BYTES + slot * B_BYTES);
    const float* a = xs + kk;
    const float* b = Xs + (int64_t)kk * N;
    if (!(vec & 1))
      gemm_ring::copy_nn4<BM, THREADS>(sa, a, ld, mleft, kleft, x);
    else if (mleft == BM && kleft == BK)
      gemm_ring::copy_nn16<BM, THREADS, false>(sa, a, ld, mleft, kleft, x);
    else
      gemm_ring::copy_nn16<BM, THREADS, true>(sa, a, ld, mleft, kleft, x);
    if (!(vec & 2))
      gemm_ring::copy_rows_elems<BN, THREADS, false>(sb, b, ldb, nleft, kleft, X);
    else if (nleft == BN && kleft == BK)
      gemm_ring::copy_rows16<BN, THREADS, false>(sb, b, ldb, nleft, kleft, X);
    else
      gemm_ring::copy_rows16<BN, THREADS, true>(sb, b, ldb, nleft, kleft, X);
  };

  // one group per step, empty past the end, so the wait below counts uniformly
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) load(i, i);
    gemm_ring::commit();
  }
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  int slot = 0, fill = STAGES - 1;
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    gemm_ring::wait_pending<STAGES - 2>();  // this thread's copies of `step` have landed
    __syncthreads();                        // everyone's have; `fill` is free
    if (step + STAGES - 1 < steps) load(step + STAGES - 1, fill);
    gemm_ring::commit();
    if (live) {
      const float* As = reinterpret_cast<const float*>(smem + slot * A_BYTES);
      const float* Bs = reinterpret_cast<const float*>(smem + STAGES * A_BYTES + slot * B_BYTES);
      const int left = klen - step * BK;
      if (left >= BK)
        stage<T>(As, Bs, tx, ty, acc);
      else
        steps_of<T>(As, Bs, left, tx, ty, acc);
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
    fill = fill == STAGES - 1 ? 0 : fill + 1;
  }
  gemm_ring::wait_pending<0>();

  float* out = part + (s * M + m0) * N + n0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = TM * ty + i;
    if (r >= mleft) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tx + j;
      if (c < nleft) out[(int64_t)r * N + c] = acc[i][j];
    }
  }
}

// out[e] = the padded tree over part[0 .. S)[e], e < elems (one thread each).
__global__ void __launch_bounds__(TREE_THREADS)
tree_kernel(const float* __restrict__ part, float* __restrict__ out, int64_t S, int64_t elems) {
  const int64_t e = (int64_t)blockIdx.x * TREE_THREADS + threadIdx.x;
  if (e >= elems) return;
  int64_t P = 1;
  while (P < S) P <<= 1;
  float stack[24];  // one entry per set bit of the runs' counter: ≤ log2(2^16 / RUN) + 1
  int top = 0;
  // the aligned runs of RUN slots of the padded tree, zero runs included
  for (int64_t r0 = 0, n = 0; r0 < P; r0 += RUN, ++n) {
    float v[RUN];
#pragma unroll
    for (int i = 0; i < RUN; ++i) v[i] = r0 + i < S ? part[(r0 + i) * elems + e] : 0.0f;
    // the run's subtree, level by level; when P < RUN the tree is node 0 at
    // width P, and the wider levels are not taken
#pragma unroll
    for (int w = 1; w < RUN; w <<= 1) {
      if (w >= P) break;
#pragma unroll
      for (int m = 0; m < RUN; m += 2 * w) v[m] = v[m] + v[m + w];
    }
    // the runs' level: a binary counter merges equal subtrees as they close
    float t = v[0];
    for (int64_t c = n; c & 1; c >>= 1) t = stack[--top] + t;
    stack[top++] = t;
  }
  out[e] = stack[0];
}

template <class T>
int launch(const void* x, const void* X, void* out, void* part, long long M, long long N,
           long long K, long long slice_rows, int vec, cudaStream_t st) {
  const long long S = (K + KSEG - 1) / KSEG;
  if (M <= 0 || N <= 0 || K <= 0 || S > 65535 || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (slice_rows <= 0 || (slice_rows < M && slice_rows % T::BM != 0) ||
      (slice_rows + T::BM - 1) / T::BM > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)T::BM * K >= (1LL << 31) || (long long)BK * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;  // 32-bit offsets inside a stage
  if (((vec & 1) && !gemm_ring::rows16(x, K, 4)) || ((vec & 2) && !gemm_ring::rows16(X, N, 4)))
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = gemm_ring::allow_smem((const void*)segment_kernel<T>, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  for (long long m0 = 0; m0 < M; m0 += slice_rows) {
    const long long ms = M - m0 < slice_rows ? M - m0 : slice_rows;
    segment_kernel<T><<<dim3((unsigned)((ms + T::BM - 1) / T::BM), (unsigned)S,
                             (unsigned)((N + BN - 1) / BN)),
                        THREADS, T::SMEM, st>>>((const float*)x + m0 * K, (const float*)X,
                                                (float*)part, ms, N, K, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long elems = ms * N;
    tree_kernel<<<(unsigned)((elems + TREE_THREADS - 1) / TREE_THREADS), TREE_THREADS, 0, st>>>(
        (const float*)part, (float*)out + m0 * N, S, elems);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

template <class T>
int occupancy(int* out) {
  const cudaError_t err = gemm_ring::allow_smem((const void*)segment_kernel<T>, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, segment_kernel<T>, THREADS,
                                                            T::SMEM);
}

}  // namespace gemm_rows

extern "C" {

// O (M×N) = x (M×K) · X (K×N) by the reduction contract above, the
// segments on tile `tile` (plan.rows_tile's index); `part` is scratch of
// S × slice_rows × N floats, S = ⌈K / KSEG⌉; x is contracted slice_rows
// rows at a time (a positive multiple of the tile's rows, or ≥ M).  `vec`
// bit 0: x's rows may be copied 16 bytes at a time, bit 1: X's
// (plan.copies).
int gemm_rows_f32(const void* x, const void* X, void* out, void* part, long long M,
                  long long N, long long K, long long slice_rows, int tile, int vec,
                  void* stream) {
  switch (tile) {
    case 0:
      return gemm_rows::launch<gemm_rows::Tile0>(x, X, out, part, M, N, K, slice_rows, vec,
                                                 (cudaStream_t)stream);
    case 1:
      return gemm_rows::launch<gemm_rows::Tile1>(x, X, out, part, M, N, K, slice_rows, vec,
                                                 (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// *out = tile `tile`'s segment blocks per SM (the occupancy API), at its
// ring's shared memory: the design's MIN_BLOCKS, checked on the card.
int gemm_rows_blocks_per_sm(int tile, void* out) {
  switch (tile) {
    case 0:
      return gemm_rows::occupancy<gemm_rows::Tile0>((int*)out);
    case 1:
      return gemm_rows::occupancy<gemm_rows::Tile1>((int*)out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* gemm_rows_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
