// Othello device helpers for the hybrid descend kernel (hybrid.cu). They
// replace the Othello flat-board step that the JAX package traces into its
// Pallas descend kernel (alphazero_tpu/games/othello.py OthelloFlatOps.step
// :228-265); the plain PyTorch version is flat_step in
// alphazero_tpu_torch/games/othello.py, and the two agree exactly.
//
// A board is two 64-bit bitboards: `mine` (+1, the player to move) and
// `theirs` (-1), bit r*8 + c for row r and column c, the flat board's own
// cell order.
//
// The step walks the 8 rays out from the move cell with explicit row and
// column bounds (no shifted masks, so no file wrap to mask off): along a
// ray, opponent discs extend the chain, an own disc flips the chain and
// ends the ray, an empty cell or the board's edge ends it without flips.
// A register-only walk of at most 56 cells: the descend kernel that calls
// it once per edge stays bound by its dependent loads of the best planes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOthSize = 8;
constexpr int kOthCells = kOthSize * kOthSize;
constexpr int kOthPass = kOthCells;  // action 64

// OthelloFlatOps.step on bitboards: place a +1 disc at action a (< 64),
// flipping every run of -1 discs that a +1 disc closes; the move cell
// becomes +1 even when it was occupied; a >= 64 passes. Then sign-flip.
__device__ __forceinline__ void othello_step(uint64_t& mine, uint64_t& theirs, int a) {
  if (a < kOthPass) {
    constexpr int kDr[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
    constexpr int kDc[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
    const int r0 = a / kOthSize;
    const int c0 = a - r0 * kOthSize;
    uint64_t flips = 0;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      uint64_t chain = 0;
      int r = r0 + kDr[d];
      int c = c0 + kDc[d];
      while (r >= 0 && r < kOthSize && c >= 0 && c < kOthSize) {
        const uint64_t bit = 1ull << (r * kOthSize + c);
        if (theirs & bit) {
          chain |= bit;
        } else {
          if (mine & bit) flips |= chain;
          break;
        }
        r += kDr[d];
        c += kDc[d];
      }
    }
    const uint64_t set = flips | (1ull << a);
    mine |= set;
    theirs &= ~set;
  }
  const uint64_t t = mine;  // sign flip: the opponent now moves
  mine = theirs;
  theirs = t;
}

}  // namespace
