// Hex device helper for the hybrid descend kernel (hybrid.cu). It replaces
// the Hex flat-board step that the JAX package traces into its Pallas
// descend kernel (alphazero_tpu/games/hex.py HexFlatOps.step :214-232);
// the plain PyTorch version is flat_step in alphazero_tpu_torch/games/
// hex.py, and the two agree exactly.
//
// A board is the canonical 7x7 board (+1 = the player to move, who joins
// row 0 to row 6) as two 64-bit bitboards, `mine` and `theirs`, bit r*7 + c
// for row r and column c. The canonical step places, negates AND
// transposes (hex.py :90-101). The JAX flat ops carry a parity lane and
// place at T^p(a) instead, because a 49-lane permutation has no Mosaic
// layout; here the transpose is a handful of register operations, so the
// board stays canonical and the action is used as it is.
//
// The transpose maps bit 7r + c to bit 7c + r: a cell on the diagonal
// d = c - r moves by 6d bits (up for d < 0, down for d > 0), so it is
// the main diagonal kept plus 12 masked shifts.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHexSize = 7;
constexpr int kHexCells = kHexSize * kHexSize;

// The cells (r, c) with c - r == d, as bits r*7 + c.
__host__ __device__ constexpr uint64_t hex_diagonal(int d) {
  uint64_t m = 0;
  for (int r = 0; r < kHexSize; ++r) {
    const int c = r + d;
    if (c >= 0 && c < kHexSize) m |= 1ull << (r * kHexSize + c);
  }
  return m;
}

// The transposed 7x7 bitboard: bit 7r + c -> bit 7c + r.
__device__ __forceinline__ uint64_t hex_transpose(uint64_t x) {
  uint64_t t = x & hex_diagonal(0);
#pragma unroll
  for (int d = 1; d < kHexSize; ++d) {
    t |= (x & hex_diagonal(d)) << (6 * d);
    t |= (x & hex_diagonal(-d)) >> (6 * d);
  }
  return t;
}

// HexFlatOps.step on canonical bitboards: +1 at cell a (< 49; an occupied
// cell is overwritten), then negate (swap the sides) and transpose both.
__device__ __forceinline__ void hex_step(uint64_t& mine, uint64_t& theirs, int a) {
  const uint64_t bit = 1ull << a;
  const uint64_t placed = mine | bit;
  mine = hex_transpose(theirs & ~bit);
  theirs = hex_transpose(placed);
}

}  // namespace
