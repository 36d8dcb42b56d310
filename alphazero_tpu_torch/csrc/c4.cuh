// Connect-Four and PUCT device helpers shared by the search kernels
// (hybrid.cu, fused.cu). They replace the Connect-Four FlatOps that the JAX
// package traces into its Pallas kernels (alphazero_tpu/games/
// connect_four.py FlatOps.step :201, valid :219, terminal :233) and the
// per-node PUCT argmax and top-2 of their refreshes (mcts/hybrid.py
// _refresh :120 and _refresh2 :170, mcts/fused.py refresh_best :220 and its
// K>1 branch :258).
//
// A board is two 64-bit bitboards: `mine` (+1, the player to move) and
// `theirs` (-1), bit r*7 + c for row r (5 = top) and column c, row-major
// with no guard column.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxA = 8;          // the A<=8 refresh (Connect-Four: A=7)
constexpr int kRows = 6;
constexpr int kCols = 7;
constexpr int kCells = kRows * kCols;
constexpr float kPuctEps = 1e-6f;       // alphazero_tpu.config.PUCT_EPS
constexpr float kInvalidP = -1e30f;     // mcts/tree.py INVALID_P
constexpr float kIllegal = -1e30f * 0.5f;  // INVALID_P * 0.5
constexpr float kNegInf = -1e30f;

// Cells whose column is in [lo, hi], every row.
constexpr uint64_t c4_columns(int lo, int hi) {
  uint64_t m = 0;
  for (int r = 0; r < kRows; ++r)
    for (int c = lo; c <= hi; ++c) m |= 1ull << (r * kCols + c);
  return m;
}
constexpr uint64_t kStartLeft = c4_columns(0, kCols - 4);   // a window can run right
constexpr uint64_t kStartRight = c4_columns(3, kCols - 1);  // ... or down-left

// Flat f32[42] board (+1 / -1 / 0) -> bitboards.
__device__ __forceinline__ void c4_load(const float* board, uint64_t& mine, uint64_t& theirs) {
  mine = 0;
  theirs = 0;
  for (int i = 0; i < kCells; ++i) {
    const float v = board[i];
    if (v > 0.5f) mine |= 1ull << i;
    if (v < -0.5f) theirs |= 1ull << i;
  }
}

// Connect-Four FlatOps.step on bitboards: drop +1 in column a (clamped to
// the top cell when the column is full, overwriting it), then sign-flip.
__device__ __forceinline__ void c4_step(uint64_t& mine, uint64_t& theirs, int a) {
  uint64_t col = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) col |= 1ull << (r * kCols + a);
  int h = __popcll((mine | theirs) & col);
  int r = h < kRows - 1 ? h : kRows - 1;
  uint64_t bit = 1ull << (r * kCols + a);
  mine |= bit;
  theirs &= ~bit;
  uint64_t t = mine;  // sign flip: the opponent now moves
  mine = theirs;
  theirs = t;
}

// FlatOps.valid: the top cell of column a is empty.
__device__ __forceinline__ bool c4_valid(uint64_t mine, uint64_t theirs, int a) {
  return (((mine | theirs) >> ((kRows - 1) * kCols + a)) & 1ull) == 0;
}

// Four in a row anywhere in x: the 69 windows of the win-line matrix as
// shifted ANDs. Bit i + 1 of a row-major board with no guard column is the
// next row's first cell when i is in the last column, so the horizontal
// and the down-right diagonal windows may only start in columns 0..3, the
// down-left diagonal only in columns 3..6; vertical windows cannot wrap.
__device__ __forceinline__ bool c4_four(uint64_t x) {
  const uint64_t h = x & (x >> 1) & (x >> 2) & (x >> 3) & kStartLeft;
  const uint64_t v = x & (x >> kCols) & (x >> (2 * kCols)) & (x >> (3 * kCols));
  const uint64_t d = x & (x >> (kCols + 1)) & (x >> (2 * kCols + 2)) &
                     (x >> (3 * kCols + 3)) & kStartLeft;
  const uint64_t e = x & (x >> (kCols - 1)) & (x >> (2 * kCols - 2)) &
                     (x >> (3 * kCols - 3)) & kStartRight;
  return (h | v | d | e) != 0;
}

// FlatOps.terminal: done = win | lose | full, value = win - (lose & !win),
// from the player to move's side. Both sides are tested: a clamped step can
// overwrite a cell, and a root board is arbitrary.
__device__ __forceinline__ void c4_terminal(uint64_t mine, uint64_t theirs,
                                            bool* done, float* value) {
  const bool win = c4_four(mine);
  const bool lose = c4_four(theirs);
  const uint64_t top = ((mine | theirs) >> ((kRows - 1) * kCols)) & ((1ull << kCols) - 1);
  const bool full = top == (1ull << kCols) - 1;
  *done = win || lose || full;
  *value = (win ? 1.f : 0.f) - ((lose && !win) ? 1.f : 0.f);
}

// The PUCT score of one edge, in the reference's operation order:
// q + ((cpuct*p)*sq)/(1 + n) with q = w / max(n, 1) and sq = sqrt(sum n +
// EPS); an illegal edge (p = INVALID_P) scores -1e30.
__device__ __forceinline__ float puct_score(float n, float w, float p, float sq, float cpuct) {
  const float q = __fdiv_rn(w, fmaxf(n, 1.f));
  const float u = __fdiv_rn(__fmul_rn(__fmul_rn(cpuct, p), sq), __fadd_rn(1.f, n));
  return p <= kIllegal ? kNegInf : __fadd_rn(q, u);
}

// First-max PUCT argmax over the A edges of one node (values in registers).
__device__ __forceinline__ void refresh_node(const float (&n)[kMaxA],
                                             const float (&w)[kMaxA],
                                             const float (&p)[kMaxA],
                                             const float (&code)[kMaxA],
                                             int A, float cpuct,
                                             float* best_a, float* best_code) {
  float total = 0.f;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) {
    if (a < A) total = __fadd_rn(total, n[a]);  // integers: exact in any order
  }
  const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
  float best = 0.f, ba = 0.f, bc = 0.f;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) {
    if (a < A) {
      const float s = puct_score(n[a], w[a], p[a], sq, cpuct);
      if (a == 0 || s > best) {
        best = s;
        ba = (float)a;
        bc = code[a];
      }
    }
  }
  *best_a = ba;
  *best_code = bc;
}

// The running top-2 of the PUCT scores of one node's edges, pushed in
// action order with strict comparisons: best is the first maximum, second
// the first maximum of the others (the dense branch's exclude-and-re-reduce
// gives the same), -1e30 while there is none.
struct Top2 {
  float best, second, best_a, best_code, sec_a, sec_code;
};

__device__ __forceinline__ void top2_push(Top2& t, int a, float s, float code) {
  if (a == 0) {
    t = Top2{s, kNegInf, 0.f, code, -1.f, -1.f};
  } else if (s > t.best) {
    t.second = t.best;
    t.sec_a = t.best_a;
    t.sec_code = t.best_code;
    t.best = s;
    t.best_a = (float)a;
    t.best_code = code;
  } else if (s > t.second) {
    t.second = s;
    t.sec_a = (float)a;
    t.sec_code = code;
  }
}

}  // namespace
