// Gomoku device helper for the hybrid descend kernel (hybrid.cu). It
// replaces the Gomoku flat-board step that the JAX package traces into its
// Pallas descend kernel (alphazero_tpu/games/gomoku.py GomokuFlatOps.step
// :191-200); the plain PyTorch version is GomokuFlatOps.step in
// alphazero_tpu_torch/games/gomoku.py, and the two agree exactly.
//
// A board of up to W * 64 cells is W 64-bit words a side, `mine` (+1, the
// player to move) and `theirs` (-1): bit i % 64 of word i / 64 is flat cell
// i (row-major, r * size + c). The descend kernels instantiate W = 8 (up to
// 512 cells: edges up to 22) and W = 12 (up to 768 cells: edges 23 to 27);
// a larger board stays in the descent's leaf row instead (hybrid.cu,
// GomokuRowGame), where the same step is one stone written.
// The step needs no geometry, so one instance serves every edge it holds:
// it sets the move's bit in `mine` (an occupied cell is overwritten, as in
// the reference), clears it in `theirs` and swaps the sides. The words are
// indexed only by compile-time constants (unrolled loops), so they stay in
// registers: 2 * W 64-bit registers for the board.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// GomokuFlatOps.step on W-word bitboards: +1 at cell a (< 64 * W), then
// sign-flip.
template <int W>
__device__ __forceinline__ void gomoku_step(uint64_t (&mine)[W], uint64_t (&theirs)[W], int a) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint64_t bit = (a >> 6) == k ? 1ull << (a & 63) : 0ull;
    const uint64_t placed = mine[k] | bit;
    mine[k] = theirs[k] & ~bit;  // sign flip: the opponent now moves
    theirs[k] = placed;
  }
}

}  // namespace
