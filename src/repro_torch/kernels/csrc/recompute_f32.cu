// The recompute schedule of the data passes on Hopper (sm_90a): the
// projection P = X·Q and its accumulation in ONE launch.
//
//   recompute_f32         ← projgram        replaces src/repro/kernels/projgram.py
//                                             _projgram_kernel  (P, C = PᵀP)
//                         ← power_project_accumulate
//                                           replaces src/repro/kernels/powerpass.py
//                                             _powerpass_kernel  (ΔY = Aᵀ(B·Q))
//   recompute_seeded_f32  ← projgram_seeded replaces src/repro/kernels/projgram.py
//                                             _projgram_seeded_kernel
//                         ← power_project_accumulate_seeded
//                                           replaces src/repro/kernels/powerpass.py
//                                             _powerpass_seeded_kernel
//   projgram_bf16         ← projgram[bf16]  the bf16-operand form of _projgram_kernel
//   power_recompute_bf16  ← power_project_accumulate[bf16]
//                                           the bf16-operand form of _powerpass_kernel
//   projgram_seeded_bf16  ← projgram_seeded[bf16]
//                                           _projgram_seeded_kernel at q_dtype=bfloat16
//   power_recompute_seeded_bf16
//                         ← power_project_accumulate_seeded[bf16]
//                                           _powerpass_seeded_kernel at q_dtype=bfloat16
//
// The bf16 forms take bf16 X and Q (and A), keep P and the accumulators in
// f32, and run phase 1 on the tensor cores (tile 1 of gemm_bf16.cuh, the
// wgmma tile of the staged proj_stage[bf16]) and phase 2 on the f32 ring's
// Tile0 (A widened for the power form, as powerpass_sweep[bf16,f32]); each
// is bitwise its staged pair.  Their seeded forms make Ω in bf16 slabs as the f32 ones
// do in f32 (below), the slabs before the last contracted by tile 1, the
// last by the fused launch, whose phase 1 continues P's chains
// (gemm_bf16.cuh CONTINUE).  The wgmma tile sets their block: 256 threads
// (two warpgroups; Tile0 has as many), one block per SM, and the tile's ring
// in dynamic shared memory (gemm_bf16::SMEM_BYTES, 197,632 bytes), which
// phase 2's ring reuses (131,072 bytes with an f32 A, 98,304 with a bf16
// one); the cooperative launch sizes its grid from the occupancy API at that
// shared memory.
//
// What the TPU kernels keep out of device memory: P.  They hold a
// (256 × k̃p) P tile in VMEM scratch over the contraction and fold it into
// the VMEM-resident output bucket on the last step.  On Hopper one P row at
// k̃p = 1024 is 4 KB, so the rows a C or ΔY tile needs (all of the chunk's)
// do not fit the 227 KB of shared memory a block may use, and blocks run in
// no order, so nothing can carry from one block to the next.
//
// Design: one persistent cooperative launch (cudaLaunchCooperativeKernel,
// at most as many blocks as can be resident at once, sized from the
// occupancy API at the ring's pinned shared memory, so MIN_BLOCKS per SM).
// Both f32 phases run gemm_ring.cuh's ring_tile, the staged kernels' own
// tile, on Tile0 (128 × 128, one block per SM: plan.FUSED_F32_TILE), each
// phase with its own copy widths (plan.copies).  Not Tile1: with both
// phases inlined, ptxas spilled 8 bytes in its CONTINUE instances at 255
// registers, and at the shapes the schedule rule recomputes the two tiles
// tie (8192 × 970: 3.88 waves either way) or Tile0 wins:
//   phase 1  the blocks sweep P's tiles, each projected once with
//            gemm_nn_f32's FMA chains, into an (n × k̃) buffer;
//   barrier  grid-wide (cooperative_groups::grid_group::sync);
//   phase 2  the blocks sweep the tiles of the accumulator's bucket
//            (rows [r0, r0 + m2) of C or ΔY) with gemm_tn_f32's chains,
//            reading P through L2 only (ring_tile's COHERENT: other blocks
//            wrote it, and this SM's L1 may hold stale lines of it).
// The chunk's P (8192 × 1024 × 4 B = 32 MiB at k̃ = 970) fits the 50 MB L2
// between the phases: the Hopper counterpart of "P never makes an HBM round
// trip", and the one-bucket condition of the schedule rule (plan.py
// ONE_BUCKET_ELEMS).  The other two designs: C-tile owners that recompute
// their own P slabs project every P element once per C tile column, ~16×
// the projection at k̃p = 1024; thread-block clusters with distributed
// shared memory hold at most 8 × 227 KB of P, 456 rows at k̃p = 1024, so a
// C tile would have to be handed from cluster to cluster in row order.  The
// persistent launch is the simple one that projects each P element once.
//
// Bitwise contract: staged ≡ recompute.  Both phases run the staged
// kernels' tile (gemm_ring.cuh), so each P element is gemm_nn_f32's chain
// (ascending d from 0.0f) and each C or ΔY element is gemm_tn_f32's
// (ascending rows from 0.0f); with `accumulate` the tile adds into Y once
// after the chain, as powerpass_sweep(out=) does.  No atomics anywhere.
//
// Buckets.  A recompute at a shape of several buckets (the wrapper's loop,
// one launch per bucket) projects P again for every bucket, as the TPU
// kernel re-accumulates P per bucket: the schedule rule charges that and
// stages such shapes unless told otherwise.
//
// Seeded variants: Ω(seed) is made once per chunk (per bucket) in K-slabs
// of `slab_rows` rows by omega_fill (rand.cuh), as proj_stage_seeded makes
// it; every slab but the last is contracted by the staged NN launch
// (gemm_ring.cuh) continuing P's chains, and the last by the fused launch,
// whose phase 1 continues them, all on one tile.  So the result is bitwise
// the materialized recompute on omega_fill(seed), and one call issues
// 2·⌈d / slab_rows⌉ launches.
//
// What bounds it: f32 operations, as gemm_ring.cuh says of the tile (the
// bf16 forms' phase 1: the tensor cores); phase 2 adds 2·n·m2·k̃ FLOPs to
// phase 1's 2·n·d·k̃ (≈ 0.2 % at k̃ = 970, d = 2^19), but runs only
// ⌈m2/BM⌉·⌈k̃/BN⌉ tiles (64 at k̃ = 970) on a grid of 132 blocks, so it costs
// about one tile's contraction over the chunk.
//
// C interface (loaded with ctypes): pointers and the stream as void*,
// sizes as long long; each entry returns the first CUDA error of its
// launches (0 when all were accepted).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"
#include "gemm_ring.cuh"
#include "mode.cuh"
#include "rand.cuh"

namespace {

using gemm_mode::ACCUMULATE;
using gemm_mode::bf16_bits;
using gemm_mode::CONTINUE;
using gemm_mode::OVERWRITE;
using gemm_ring::ring_tile;
using gemm_ring::Tile0;
namespace cg = cooperative_groups;

using FusedTile = Tile0;  // the fused kernels' ring tile (plan.FUSED_F32_TILE)

// One tile of a fused kernel's f32 phase: ring_tile compiled as a function
// of its own, so that each phase is the staged kernel's own code.  Inlined
// into the kernel beside the other phase, ptxas allocated the two together
// and the f32 projection ran 1.2 % slower than the staged NN kernel (226.1
// against 223.3 ms at 8192 × 2^19 → 970 on an H100 at 700 W; PERF.md); as a
// call, 222.0-223.2 ms.
template <bool A_KMAJOR, int MODE, typename TA, bool COHERENT>
__device__ __noinline__ void fused_tile(const TA* A, const float* B, float* Y, int64_t M,
                                        int64_t N, int64_t K, int64_t lda, int vec, int64_t m0,
                                        int64_t n0, unsigned char* smem) {
  ring_tile<A_KMAJOR, MODE, TA, FusedTile, COHERENT>(A, B, Y, M, N, K, lda, vec, m0, n0, smem);
}

// Phase 1: P (n × kt) = X·Q over k1 columns of X (row stride ldx), in MODE1
// (OVERWRITE, or CONTINUE for the last slab of a seeded call), copied as
// `vec1` allows (bit 0 X, bit 1 Q).  Barrier.  Phase 2: Y (m2 × kt) (+)=
// A2ᵀ·P, A2 (n × m2) with row stride lda2, in MODE2 (OVERWRITE or
// ACCUMULATE), copied as `vec2` allows (bit 0 A2, bit 1 P), every operand
// through L2 only.  Both phases on the ring's Tile0, each block's tiles
// `gridDim.x` apart, the column tiles fastest (the staged kernels' order).
template <int MODE1, int MODE2>
__global__ void __launch_bounds__(FusedTile::THREADS, FusedTile::MIN_BLOCKS)
recompute_f32_kernel(const float* __restrict__ X, const float* __restrict__ Q, float* P,
                     const float* A2, float* __restrict__ Y, int64_t n, int64_t kt,
                     int64_t k1, int64_t ldx, int64_t m2, int64_t lda2, int vec1, int vec2) {
  extern __shared__ __align__(16) unsigned char recompute_smem[];
  constexpr int BM = FusedTile::BM, BN = FusedTile::BN;
  const int64_t tiles_n = (kt + BN - 1) / BN;
  const int64_t tiles1 = (n + BM - 1) / BM * tiles_n;
  for (int64_t t = blockIdx.x; t < tiles1; t += gridDim.x)
    fused_tile<false, MODE1, float, false>(X, Q, P, n, kt, k1, ldx, vec1, t / tiles_n * BM,
                                           t % tiles_n * BN, recompute_smem);
  cg::this_grid().sync();  // every P tile written and visible in L2
  const int64_t tiles2 = (m2 + BM - 1) / BM * tiles_n;
  for (int64_t t = blockIdx.x; t < tiles2; t += gridDim.x)
    fused_tile<true, MODE2, float, true>(A2, P, Y, m2, kt, n, lda2, vec2, t / tiles_n * BM,
                                         t % tiles_n * BN, recompute_smem);
}

// A cooperative launch of `kern` (`threads` a block, `smem` bytes of dynamic
// shared memory) over at most as many blocks as can be resident at once, by
// the occupancy API, and no more than `tiles`.
int launch_cooperative(const void* kern, int threads, int64_t tiles, void** args, int smem,
                       cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = gemm_ring::allow_smem(kern, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int64_t resident = (int64_t)per_sm * sms;
  const dim3 grid((unsigned)(tiles < resident ? tiles : resident));
  err = cudaLaunchCooperativeKernel(kern, grid, dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The larger of the two phases' tile counts on BM × BN tiles.
template <int BM, int BN>
int64_t phase_tiles(int64_t n, int64_t kt, int64_t m2) {
  const int64_t tiles_n = (kt + BN - 1) / BN;
  const int64_t t1 = (n + BM - 1) / BM * tiles_n, t2 = (m2 + BM - 1) / BM * tiles_n;
  return t1 > t2 ? t1 : t2;
}

// The blocks of the fused f32 kernels that one SM keeps resident at the
// ring's pinned shared memory (the fewest of the four mode instances).
cudaError_t fused_f32_blocks_per_sm(int* out) {
  const void* kerns[] = {(const void*)recompute_f32_kernel<OVERWRITE, OVERWRITE>,
                         (const void*)recompute_f32_kernel<OVERWRITE, ACCUMULATE>,
                         (const void*)recompute_f32_kernel<CONTINUE, OVERWRITE>,
                         (const void*)recompute_f32_kernel<CONTINUE, ACCUMULATE>};
  int smem = 0;
  cudaError_t err = gemm_ring::pinned_smem<FusedTile, float>(&smem);
  *out = 1 << 30;
  for (const void* kern : kerns) {
    int got = 0;
    if (err == cudaSuccess) err = gemm_ring::allow_smem(kern, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, kern, FusedTile::THREADS, smem);
    if (got < *out) *out = got;
  }
  return err;
}

template <int MODE1, int MODE2>
int launch_recompute(const float* x, const float* q, float* p, const float* a2, float* y,
                     int64_t n, int64_t kt, int64_t k1, int64_t ldx, int64_t m2, int64_t lda2,
                     int vec1, int vec2, cudaStream_t stream) {
  int rc = gemm_ring::check_operands<false, float, FusedTile>(x, q, n, kt, k1, ldx, vec1);
  if (rc == 0) rc = gemm_ring::check_operands<true, float, FusedTile>(a2, p, m2, kt, n, lda2, vec2);
  if (rc != 0) return rc;
  int smem = 0;
  const cudaError_t err = gemm_ring::pinned_smem<FusedTile, float>(&smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&x, &q, &p, &a2, &y, &n, &kt, &k1, &ldx, &m2, &lda2, &vec1, &vec2};
  const int64_t tiles = phase_tiles<FusedTile::BM, FusedTile::BN>(n, kt, m2);
  return launch_cooperative((const void*)recompute_f32_kernel<MODE1, MODE2>,
                            FusedTile::THREADS, tiles, args, smem, stream);
}

// One fused f32 launch: phase 1 in mode1 (OVERWRITE or CONTINUE) over k1
// columns of X (row stride ldx), phase 2 accumulating into Y or not.
int recompute(const float* x, const float* q, float* p, const float* a2, float* y, int64_t n,
              int64_t kt, int64_t k1, int64_t ldx, int mode1, int64_t m2, int64_t lda2,
              int accumulate, int vec1, int vec2, cudaStream_t st) {
  if (mode1 == CONTINUE)
    return accumulate ? launch_recompute<CONTINUE, ACCUMULATE>(x, q, p, a2, y, n, kt, k1, ldx,
                                                               m2, lda2, vec1, vec2, st)
                      : launch_recompute<CONTINUE, OVERWRITE>(x, q, p, a2, y, n, kt, k1, ldx,
                                                              m2, lda2, vec1, vec2, st);
  return accumulate ? launch_recompute<OVERWRITE, ACCUMULATE>(x, q, p, a2, y, n, kt, k1, ldx,
                                                              m2, lda2, vec1, vec2, st)
                    : launch_recompute<OVERWRITE, OVERWRITE>(x, q, p, a2, y, n, kt, k1, ldx, m2,
                                                             lda2, vec1, vec2, st);
}

// The bf16 forms.  Phase 1: P (n × kt, f32) = X·Q over k1 columns of X (n ×
// ·, row stride ldx) with Q (k1 × kt), both bf16, copied wx and wq bytes at
// a time: tile 1 of gemm_bf16.cuh — proj_stage[bf16]'s wgmma tile — in
// MODE1 (OVERWRITE, or CONTINUE for the last slab of a seeded call).
// Barrier.  Phase 2 as above (fused_tile, on the ring's Tile0): Y (m2 × kt)
// (+)= A2ᵀ·P, A2 bf16 (power_project_accumulate[bf16]: tile 3,
// powerpass_sweep[bf16,f32]'s) or f32 (projgram[bf16]: A2 = P,
// gram_sweep's), copied as `vec2` allows, through L2 only, its ring in the
// wgmma ring's shared memory.  So each is bitwise its staged pair, as in
// f32.  Phase 2's copies refill the slots that
// phase 1's wgmma read through the async proxy: phase 1's last wait_group 0,
// the tile's closing __syncthreads() and the grid barrier come before them.
static_assert(gemm_bf16::THREADS == FusedTile::THREADS, "both phases run on one block");
static_assert(gemm_bf16::SMEM_BYTES >= gemm_ring::Ring<FusedTile, float>::BYTES &&
                  gemm_bf16::SMEM_BYTES >= gemm_ring::Ring<FusedTile, bf16_bits>::BYTES,
              "phase 2's ring fits the wgmma ring's shared memory");
static_assert(gemm_bf16::BM == FusedTile::BM && gemm_bf16::BN == FusedTile::BN,
              "the two phases' tiles are counted alike");

template <int MODE1, int MODE2, typename TA2>
__global__ void __launch_bounds__(gemm_bf16::THREADS, gemm_bf16::MIN_BLOCKS)
recompute_bf16_kernel(const bf16_bits* __restrict__ X, const bf16_bits* __restrict__ Q,
                      float* P, const TA2* A2, float* __restrict__ Y, int64_t n, int64_t kt,
                      int64_t k1, int64_t ldx, int64_t m2, int64_t lda2, int wx, int wq,
                      int vec2) {
  extern __shared__ __align__(16) unsigned char recompute_smem[];
  const int64_t tiles_n = (kt + gemm_bf16::BN - 1) / gemm_bf16::BN;
  const int64_t tiles_m1 = (n + gemm_bf16::BM - 1) / gemm_bf16::BM;
  const uint32_t ring = gemm_bf16::ring_base(recompute_smem);
  for (int64_t t = blockIdx.x; t < tiles_m1 * tiles_n; t += gridDim.x)
    gemm_bf16::wgmma_tile<false, MODE1>(X, Q, P, n, kt, k1, ldx, wx, wq,
                                        (t % tiles_m1) * gemm_bf16::BM,
                                        (t / tiles_m1) * gemm_bf16::BN, ring);
  cg::this_grid().sync();  // every P tile written and visible in L2
  constexpr int BM = FusedTile::BM, BN = FusedTile::BN;  // gemm_bf16's, so tiles_n holds
  const int64_t tiles2 = (m2 + BM - 1) / BM * tiles_n;
  for (int64_t t = blockIdx.x; t < tiles2; t += gridDim.x)
    fused_tile<true, MODE2, TA2, true>(A2, P, Y, m2, kt, n, lda2, vec2, t / tiles_n * BM,
                                       t % tiles_n * BN, recompute_smem);
}

template <int MODE1, int MODE2, typename TA2>
int launch_recompute_bf16(const void* x, const void* q, void* p, const void* a2, void* y,
                          int64_t n, int64_t kt, int64_t k1, int64_t ldx, int64_t m2,
                          int64_t lda2, int wx, int wq, int vec2, cudaStream_t stream) {
  int rc = gemm_bf16::check_operands<false>(x, q, n, kt, k1, ldx, wx, wq);
  if (rc == 0) rc = gemm_ring::check_operands<true, TA2, FusedTile>(a2, p, m2, kt, n, lda2, vec2);
  if (rc != 0) return rc;
  const bf16_bits* X = (const bf16_bits*)x;
  const bf16_bits* Q = (const bf16_bits*)q;
  float* P = (float*)p;
  const TA2* A2 = (const TA2*)a2;
  float* Y = (float*)y;
  void* args[] = {&X, &Q, &P, &A2, &Y, &n, &kt, &k1, &ldx, &m2, &lda2, &wx, &wq, &vec2};
  return launch_cooperative((const void*)recompute_bf16_kernel<MODE1, MODE2, TA2>,
                            gemm_bf16::THREADS,
                            phase_tiles<gemm_bf16::BM, gemm_bf16::BN>(n, kt, m2), args,
                            gemm_bf16::SMEM_BYTES, stream);
}

template <int MODE1, typename TA2>
int recompute_bf16_mode2(const void* x, const void* q, void* p, const void* a2, void* y,
                         int64_t n, int64_t kt, int64_t k1, int64_t ldx, int64_t m2,
                         int64_t lda2, int accumulate, int wx, int wq, int vec2,
                         cudaStream_t stream) {
  return accumulate
      ? launch_recompute_bf16<MODE1, ACCUMULATE, TA2>(x, q, p, a2, y, n, kt, k1, ldx, m2,
                                                       lda2, wx, wq, vec2, stream)
      : launch_recompute_bf16<MODE1, OVERWRITE, TA2>(x, q, p, a2, y, n, kt, k1, ldx, m2,
                                                      lda2, wx, wq, vec2, stream);
}

// One fused bf16 launch: phase 1 in mode1 (OVERWRITE or CONTINUE) over k1
// columns of X (row stride ldx), phase 2 accumulating into Y or not.
template <typename TA2>
int recompute_bf16(const void* x, const void* q, void* p, const void* a2, void* y,
                   int64_t n, int64_t kt, int64_t k1, int64_t ldx, int mode1, int64_t m2,
                   int64_t lda2, int accumulate, int wx, int wq, int vec2,
                   cudaStream_t stream) {
  return mode1 == CONTINUE
      ? recompute_bf16_mode2<CONTINUE, TA2>(x, q, p, a2, y, n, kt, k1, ldx, m2, lda2,
                                            accumulate, wx, wq, vec2, stream)
      : recompute_bf16_mode2<OVERWRITE, TA2>(x, q, p, a2, y, n, kt, k1, ldx, m2, lda2,
                                             accumulate, wx, wq, vec2, stream);
}

// The seeded bf16 forms: bf16 Ω(seed) (d × kt) made slab by slab into
// `slab` (≥ min(d, slab_rows) × kt bf16) by omega_fill (bf16); every slab but
// the last contracted by tile 1 (continuing P's chains after the first), the
// last by the fused launch, whose phase 1 continues them.
template <typename TA2>
int recompute_seeded_bf16(const void* x, unsigned s0, unsigned s1, void* p, void* slab,
                          long long slab_rows, const void* a2, void* y, long long n,
                          long long kt, long long d, long long m2, long long lda2,
                          int accumulate, int wx, int wq, int vec2, cudaStream_t st) {
  if (slab_rows <= 0 || slab_rows % gemm_bf16::BK != 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  for (long long k0 = 0; k0 < d; k0 += slab_rows) {
    const long long ks = d - k0 < slab_rows ? d - k0 : slab_rows;
    const cudaError_t err = rand_f32::launch_omega_fill((bf16_bits*)slab, ks, kt,
                                                        (uint32_t)k0, d, kt, s0, s1, st);
    if (err != cudaSuccess) return (int)err;
    const bf16_bits* window = (const bf16_bits*)x + k0;  // X[:, k0 : k0 + ks], row stride d
    const int mode1 = k0 == 0 ? OVERWRITE : CONTINUE;
    int rc;
    if (k0 + ks < d)
      rc = mode1 == OVERWRITE
          ? gemm_bf16::launch<false, OVERWRITE>(window, slab, p, n, kt, ks, d, wx, wq, st)
          : gemm_bf16::launch<false, CONTINUE>(window, slab, p, n, kt, ks, d, wx, wq, st);
    else
      rc = recompute_bf16<TA2>(window, slab, p, a2, y, n, kt, ks, d, mode1, m2, lda2,
                               accumulate, wx, wq, vec2, st);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// P (n×kt) = X (n×d) · Q (d×kt), then Y (m2×kt) (+)= A2ᵀ·P with A2 the
// (n × m2) window of a row-major array of row stride lda2: one launch, X
// and Q copied as `vec` allows (bit 0 X, bit 1 Q), A2 and P as `vec2`
// allows (bit 0 A2, bit 1 P).  projgram passes A2 = P[:, r0:], Y = C[r0:];
// power_project_accumulate passes A2 = A[:, r0:], Y = ΔY[r0:], and P is its
// scratch.
int recompute_f32(const void* x, const void* q, void* p, const void* a2, void* y,
                  long long n, long long kt, long long d, long long m2, long long lda2,
                  int accumulate, int vec, int vec2, void* stream) {
  return recompute((const float*)x, (const float*)q, (float*)p, (const float*)a2,
                   (float*)y, n, kt, d, d, OVERWRITE, m2, lda2, accumulate, vec, vec2,
                   (cudaStream_t)stream);
}

// recompute_f32 with Q = Ω(seed) (d×kt) made slab by slab into `slab`
// (≥ min(d, slab_rows) × kt floats).  slab_rows must be a positive
// multiple of the ring's BK, so that slab edges fall on staging steps.
// Every slab but the last is contracted by gemm_nn_f32's ring kernel on tile
// `tile` (plan.f32_tile's pick for P), the last by the fused launch (on
// Tile0), X's window and the slab copied as `vec` allows (it holds for every
// window when it holds for X).
int recompute_seeded_f32(const void* x, unsigned s0, unsigned s1, void* p, void* slab,
                         long long slab_rows, const void* a2, void* y, long long n,
                         long long kt, long long d, long long m2, long long lda2,
                         int accumulate, int tile, int vec, int vec2, void* stream) {
  if (slab_rows <= 0 || slab_rows % gemm_ring::BK != 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  for (long long k0 = 0; k0 < d; k0 += slab_rows) {
    const long long ks = d - k0 < slab_rows ? d - k0 : slab_rows;
    const cudaError_t err = rand_f32::launch_omega_fill((float*)slab, ks, kt, (uint32_t)k0,
                                                        d, kt, s0, s1, st);
    if (err != cudaSuccess) return (int)err;
    const float* window = (const float*)x + k0;  // X[:, k0 : k0 + ks], row stride d
    const int mode1 = k0 == 0 ? OVERWRITE : CONTINUE;
    int rc;
    if (k0 + ks < d)
      rc = mode1 == OVERWRITE
          ? gemm_ring::launch<false, OVERWRITE>(tile, window, slab, p, n, kt, ks, d, vec, st)
          : gemm_ring::launch<false, CONTINUE>(tile, window, slab, p, n, kt, ks, d, vec, st);
    else
      rc = recompute(window, (const float*)slab, (float*)p, (const float*)a2, (float*)y, n,
                     kt, ks, d, mode1, m2, lda2, accumulate, vec, vec2, st);
    if (rc != 0) return rc;
  }
  return 0;
}

// recompute_f32 on bf16 X and Q (P, C f32): P = X·Q on the tensor cores,
// then rows of C (+)= Pᵀ·P on the ring's Tile0.  a2 is P's window (f32).
int projgram_bf16(const void* x, const void* q, void* p, const void* a2, void* y,
                  long long n, long long kt, long long d, long long m2, long long lda2,
                  int accumulate, int wx, int wq, int vec2, void* stream) {
  return recompute_bf16<float>(x, q, p, a2, y, n, kt, d, d, OVERWRITE, m2, lda2,
                               accumulate, wx, wq, vec2, (cudaStream_t)stream);
}

// recompute_f32 on bf16 B (as x), Q and A (as a2): P = B·Q on the tensor
// cores into the f32 scratch p, then rows of ΔY (+)= Aᵀ·P with A widened.
int power_recompute_bf16(const void* x, const void* q, void* p, const void* a2, void* y,
                         long long n, long long kt, long long d, long long m2,
                         long long lda2, int accumulate, int wx, int wq, int vec2,
                         void* stream) {
  return recompute_bf16<bf16_bits>(x, q, p, a2, y, n, kt, d, d, OVERWRITE, m2, lda2,
                                   accumulate, wx, wq, vec2, (cudaStream_t)stream);
}

// projgram_bf16 with Q = bf16(Ω(seed)) made slab by slab into `slab` (≥
// min(d, slab_rows) × kt bf16).  slab_rows must be a positive multiple of
// gemm_bf16::BK, so that slab edges fall on BK steps.
int projgram_seeded_bf16(const void* x, unsigned s0, unsigned s1, void* p, void* slab,
                         long long slab_rows, const void* a2, void* y, long long n,
                         long long kt, long long d, long long m2, long long lda2,
                         int accumulate, int wx, int wq, int vec2, void* stream) {
  return recompute_seeded_bf16<float>(x, s0, s1, p, slab, slab_rows, a2, y, n, kt, d, m2,
                                      lda2, accumulate, wx, wq, vec2, (cudaStream_t)stream);
}

// power_recompute_bf16 with Q = bf16(Ω(seed)), made as projgram_seeded_bf16
// makes it.
int power_recompute_seeded_bf16(const void* x, unsigned s0, unsigned s1, void* p,
                                void* slab, long long slab_rows, const void* a2, void* y,
                                long long n, long long kt, long long d, long long m2,
                                long long lda2, int accumulate, int wx, int wq, int vec2,
                                void* stream) {
  return recompute_seeded_bf16<bf16_bits>(x, s0, s1, p, slab, slab_rows, a2, y, n, kt, d,
                                          m2, lda2, accumulate, wx, wq, vec2,
                                          (cudaStream_t)stream);
}

// The blocks of the fused f32 kernels that one SM keeps resident at the
// ring's pinned shared memory, by the occupancy API: the cooperative grid's
// blocks per SM.
int recompute_f32_blocks_per_sm(int* out) { return (int)fused_f32_blocks_per_sm(out); }

// The blocks of the fused bf16 kernel (power != 0: the power form, else
// projgram's) that one SM keeps resident at the wgmma tile's dynamic shared
// memory, by the occupancy API: the cooperative grid's blocks per SM.
int recompute_bf16_blocks_per_sm(int power, int* out) {
  const void* kern = power
      ? (const void*)recompute_bf16_kernel<OVERWRITE, OVERWRITE, bf16_bits>
      : (const void*)recompute_bf16_kernel<OVERWRITE, OVERWRITE, float>;
  cudaError_t err = gemm_ring::allow_smem(kern, gemm_bf16::SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, gemm_bf16::THREADS,
                                                        gemm_bf16::SMEM_BYTES);
  return (int)err;
}

const char* recompute_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
