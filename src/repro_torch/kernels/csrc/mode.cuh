// What every GEMM tile of the port shares: what a tile does with its output
// Y, and the raw form of a bf16 element.  The f32 ring tile (gemm_ring.cuh),
// the bf16 wgmma tile (gemm_bf16.cuh) and the old mma.sync tile
// (gemm_bf16_mma.cuh) take their modes from here.

#pragma once

#include <stdint.h>

namespace gemm_mode {

// A bf16 element as its raw 16 bits: the high half of the f32 it widens to.
using bf16_bits = uint16_t;

// What a tile does with Y.  Each is a compile-time template argument of the
// tile that runs it.
enum Mode : int {
  OVERWRITE = 0,   // Y = Σ
  ACCUMULATE = 1,  // Y = Y + Σ, one add after the full contraction
  CONTINUE = 2,    // Σ starts from Y: the chain goes on where it stopped
};

}  // namespace gemm_mode
