// Hybrid-engine search kernels for Hopper (sm_90a): descend, merge, refresh.
//
// Replace the Pallas kernels of alphazero_tpu/mcts/hybrid.py:
//   az_descend, az_descend_othello, az_descend_gomoku, az_descend_hex
//               <- descend_kernel (hybrid.py:242-356), one instance per game
//                  of descend_kernel<Game>: the Connect-Four step
//                  (FlatOps.step, games/connect_four.py:201-217) from c4.cuh,
//                  the Othello step (OthelloFlatOps.step, games/othello.py
//                  :228-265) from othello.cuh, the Gomoku step of every edge
//                  up to 16 (GomokuFlatOps.step, games/gomoku.py:191-200)
//                  from gomoku.cuh, the canonical Hex step (HexFlatOps.step,
//                  games/hex.py:214-232, without its parity lane) from
//                  hex.cuh;
//   az_merge    <- merge_kernel (hybrid.py:363-422) with the A<=8 PUCT
//                  refresh (_refresh, hybrid.py:120-149);
//   az_merge_dense
//               <- the same merge with _refresh's dense branch for larger
//                  action spaces (hybrid.py:150-168; Othello A=65);
//   az_refresh, az_refresh_dense
//               <- the same two refreshes alone, which seed the first
//                  best-action planes of a search (hybrid.py:815);
//   az_descend_round, az_descend_round_othello, az_descend_round_gomoku,
//   az_descend_round_hex
//               <- descend_round_kernel (hybrid.py:437-577), K7a: a round's
//                  K descents per game, one instance per game as above;
//   az_merge_round, az_merge_round_dense
//               <- merge_round_kernel (hybrid.py:579-657) with _refresh2's
//                  unrolled and dense top-2 branches (hybrid.py:170-235),
//                  K7b;
//   az_refresh2, az_refresh2_dense
//               <- _refresh2 alone, which seeds a round search's first
//                  top-2 planes (hybrid.py:874).
// The plain PyTorch versions are descend/merge/refresh in
// alphazero_tpu_torch/mcts/hybrid.py; the two must agree bit for bit.
//
// Tree layout (per game b): stat planes n/w/p/code f32[B, A, C] (node c of
// action a at b*A*C + a*C + c), node planes done/tval f32[B, C], the best-
// action planes besta/bestc f32[B, C] that the refresh leaves for the next
// descent. Child codes: -1 unexpanded, >= 0 a child slot, -2-s a terminal
// child at slot s.
//
// Path record between the kernels: patha[b, c] = action+1 where node c lies
// on the descent path (0 elsewhere), psgn[b, c] = its root-parity sign, and
// meta[b, 8] = (exp, term, psign, v_term, cut, exp_node, exp_action, 0).
// The merge takes meta2[b, 8] = (mval, exp_ok, link_code, cdone, ctval,
// exp_node, exp_action, 0) and the lockstep slot s.
//
// What bounds them on an H100, and what the design does about it:
// * descend is latency-bound pointer chasing: each step is one dependent
//   load of besta/bestc at the current node. One thread per game walks its
//   path with real indexing (the TPU kernel's one-hot lane reductions are
//   layout, not semantics) and carries the board in registers as bitboards
//   of Game::kWords 64-bit words a side (one for Connect-Four, Othello and
//   Hex; four for Gomoku, up to 256 cells), so a Connect-Four step is a
//   popcount and two bit ops, an Othello step a register-only walk of the 8
//   rays, a Gomoku step two bit ops per word and a Hex step two 7x7
//   transposes of 12 masked shifts each. Small blocks (32 games) spread the games
//   over the SMs: 4096 games fill all 132 SMs, the 1024 of the Othello,
//   Gomoku and Hex full presets only 32 of them (launch geometry is later
//   work). Each thread reads and writes its own board row, cell by cell: a
//   warp's accesses are L floats apart, uncoalesced, which costs little at
//   42-64 cells and more at Gomoku 15's 225 (a shared-memory transpose of
//   the block's rows is later work).
// * merge is bandwidth-bound: it must read the four [B, A, C] planes
//   (46 MB at B=4096, C=101, A=7; 108 MB at B=1024, C=101, A=65) to
//   refresh every node's PUCT argmax; at A=81 and A=225 (Gomoku 9 and 15)
//   they are 134 MB and 373 MB at B=1024. One thread per (game, node) reads its
//   A-strided column with neighbouring threads on neighbouring nodes
//   (coalesced) and writes back only the cells that change (install row,
//   path edge, one link). For A <= 8 the column sits in registers and the
//   first-max argmax runs from there. Larger A would not fit (4 x 65
//   floats a thread spill past the 255-register limit), so the dense
//   variant streams the column twice: the first pass sums n, the second
//   re-reads n, w, p, code (the block's columns are still in L1/L2) and
//   keeps a running first-max. Refreshing only the path nodes and the new
//   slot would cut the traffic to a few KB; that is a later change.
//
// K>1 rounds (parallel_sims = K): the refresh leaves the runner-up too,
// seca/secc [B, C] (-1 where no legal runner-up exists). A round's K
// descents run one after another in ONE thread per game, each from a copy
// of the root board kept in registers, so a descent sees the in-round
// counters of the descents before it: two bytes per node and game (takes
// of the best action and of the runner-up) in shared memory, node-major
// with the block's 32 games innermost (6.5 KB at C=101; above 48 KB the
// launch opts in, up to C=3632), zeroed once per launch. The records are
// K-major: bd[K, B, L], patha/psgn[K, B, C], meta[K, B, 8] with dup in lane
// 7. Its bound is the same dependent-load chain as the K=1 descend, K times
// as long, for K times the path bytes. The round merge keeps one thread per
// (game, node) column: it gathers, once, what the K records add to the
// column (at most K path edges, one install, K links), then rewrites every
// cell as x * keep + (the additions summed in k order), the JAX kernel's
// arithmetic term by term, storing only cells whose bits change. Its top-2
// scan pushes the edges in action order with strict comparisons, which
// gives the dense branch's exclude-and-re-reduce result. Bytes: the four
// planes once (plus, for A > 8, a second read of the column from L1/L2 for
// the scan) and K small records.
//
// Arithmetic is bit-exact with the reference: build with --fmad=false (no
// a*b+c contraction), default -prec-div/-prec-sqrt, never --use_fast_math;
// the PUCT score is written with explicit round-to-nearest intrinsics in the
// reference's operation order q + ((cpuct*p)*sqrt(sum n + EPS))/(1 + n),
// q = w / max(n, 1), and ties keep the first maximum (strict >), which is
// the dense branch's smallest action among the exact maxima.

#include <cstdint>
#include <cuda_runtime.h>

#include "c4.cuh"       // c4_step, refresh_node and the constants
#include "gomoku.cuh"   // gomoku_step
#include "hex.cuh"      // hex_step
#include "othello.cuh"  // othello_step

namespace {

constexpr int kDescendThreads = 32;
constexpr int kMergeThreads = 256;
constexpr int kMaxRoundK = 16;    // descents per round (kernels.MAX_ROUND_K)
constexpr int kMaxSharedBytes = 232448;   // a block's dynamic shared memory on sm_90

// The games descend_kernel is instantiated for: the 64-bit words of a
// side's bitboard, the board cells (0: the `cells` argument, at run time)
// and the step.
struct ConnectFourGame {
  static constexpr int kWords = 1;
  static constexpr int kBoardCells = kCells;
  static __device__ __forceinline__ void step(uint64_t (&mine)[1], uint64_t (&theirs)[1], int a) {
    c4_step(mine[0], theirs[0], a);
  }
};

struct OthelloGame {
  static constexpr int kWords = 1;
  static constexpr int kBoardCells = kOthCells;
  static __device__ __forceinline__ void step(uint64_t (&mine)[1], uint64_t (&theirs)[1], int a) {
    othello_step(mine[0], theirs[0], a);
  }
};

struct GomokuGame {  // any edge up to 16: the cells come at run time
  static constexpr int kWords = kGomokuWords;
  static constexpr int kBoardCells = 0;
  static __device__ __forceinline__ void step(uint64_t (&mine)[kWords], uint64_t (&theirs)[kWords],
                                              int a) {
    gomoku_step(mine, theirs, a);
  }
};

struct HexGame {
  static constexpr int kWords = 1;
  static constexpr int kBoardCells = kHexCells;
  static __device__ __forceinline__ void step(uint64_t (&mine)[1], uint64_t (&theirs)[1], int a) {
    hex_step(mine[0], theirs[0], a);
  }
};

// Flat f32[L] board (+1 / -1 / 0) -> bitboards: cell 64k + j is bit j of
// word k (word indices are compile-time constants: registers, not stack).
template <int W>
__device__ __forceinline__ void load_board(const float* board, int L, uint64_t (&mine)[W],
                                           uint64_t (&theirs)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint64_t m = 0, t = 0;
    for (int j = 0; j < 64 && 64 * k + j < L; ++j) {
      const float v = board[64 * k + j];
      if (v > 0.5f) m |= 1ull << j;
      if (v < -0.5f) t |= 1ull << j;
    }
    mine[k] = m;
    theirs[k] = t;
  }
}

// Bitboards -> flat f32[L] board, +0 in empty cells.
template <int W>
__device__ __forceinline__ void store_board(float* out, int L, const uint64_t (&mine)[W],
                                            const uint64_t (&theirs)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    for (int j = 0; j < 64 && 64 * k + j < L; ++j) {
      out[64 * k + j] = ((mine[k] >> j) & 1ull) ? 1.f : (((theirs[k] >> j) & 1ull) ? -1.f : 0.f);
    }
  }
}

template <class Game>
__global__ void descend_kernel(const float* __restrict__ besta,
                               const float* __restrict__ bestc,
                               const float* __restrict__ done,
                               const float* __restrict__ tval,
                               const float* __restrict__ boards,
                               float* __restrict__ bd,
                               float* __restrict__ patha,
                               float* __restrict__ psgn,
                               float* __restrict__ meta,
                               int B, int C, int max_depth, int cells) {
  constexpr int W = Game::kWords;
  const int L = Game::kBoardCells > 0 ? Game::kBoardCells : cells;
  const int b0 = blockIdx.x * blockDim.x;
  const int games = min((int)blockDim.x, B - b0);
  // zero this block's rows of the path record, cooperatively (coalesced)
  for (int i = threadIdx.x; i < games * C; i += blockDim.x) {
    patha[(size_t)b0 * C + i] = 0.f;
    psgn[(size_t)b0 * C + i] = 0.f;
  }
  __syncthreads();
  const int b = b0 + threadIdx.x;
  if (b >= B) return;

  uint64_t mine[W], theirs[W];
  load_board(boards + (size_t)b * L, L, mine, theirs);

  const size_t row = (size_t)b * C;
  int node = 0, depth = 0, leaf = -1;
  float psign = 1.f;
  float exp = 0.f, term = 0.f, cut = 0.f, exp_node = 0.f, exp_action = 0.f;
  bool act = done[row] < 0.5f;  // a terminal root is not descended
  while (act) {
    const float af = besta[row + node];
    const float code = bestc[row + node];
    patha[row + node] = af + 1.f;
    psgn[row + node] = psign;
    Game::step(mine, theirs, (int)af);

    const bool cterm = code < -1.5f;
    const bool unexp = !cterm && code < -0.5f;
    const float child = cterm ? -2.f - code : code;
    const bool live = !unexp && !cterm;
    const bool cutoff = live && depth + 1 >= max_depth;
    const bool go = live && !cutoff;
    if (unexp) {
      exp = 1.f;
      exp_node = (float)node;
      exp_action = af;
    }
    if (cterm) term = 1.f;
    if (cutoff) cut = 1.f;
    if (cterm || cutoff) leaf = (int)child;
    if (go) node = (int)child;
    depth += 1;
    psign = -psign;
    act = go;
  }

  store_board(bd + (size_t)b * L, L, mine, theirs);
  float* m = meta + (size_t)b * 8;
  m[0] = exp;
  m[1] = term;
  m[2] = psign;
  m[3] = leaf >= 0 ? tval[row + leaf] : 0.f;
  m[4] = cut;
  m[5] = exp_node;
  m[6] = exp_action;
  m[7] = 0.f;
}

__global__ void merge_kernel(float* __restrict__ n, float* __restrict__ w,
                             float* __restrict__ p, float* __restrict__ code,
                             float* __restrict__ done, float* __restrict__ tval,
                             const float* __restrict__ pm,
                             const float* __restrict__ patha,
                             const float* __restrict__ psgn,
                             const float* __restrict__ meta2,
                             float* __restrict__ besta,
                             float* __restrict__ bestc,
                             int B, int A, int C, int slot, float cpuct) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * C) return;
  const int b = (int)(idx / C);
  const int c = (int)(idx - (size_t)b * C);

  const float* m2 = meta2 + (size_t)b * 8;
  const float mval = m2[0];
  const bool exp_ok = m2[1] > 0.5f;
  const float link_code = m2[2];
  const bool install = exp_ok && c == slot;
  const bool link_here = exp_ok && c == (int)m2[5];
  const int link_a = (int)m2[6];
  const float on_path = patha[idx];  // action+1, or 0 off the path
  const float sign = psgn[idx];

  float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
  const size_t base = (size_t)b * A * C + c;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) {
    if (a < A) {
      const size_t off = base + (size_t)a * C;
      float n_ = n[off], w_ = w[off], p_ = p[off], c_ = code[off];
      if (install) {  // fresh row at the lockstep slot
        n_ = 0.f;
        w_ = 0.f;
        p_ = pm[(size_t)b * A + a];
        c_ = -1.f;
        n[off] = n_;
        w[off] = w_;
        p[off] = p_;
        code[off] = c_;
      }
      if (on_path == (float)(a + 1)) {  // backup along the path
        n_ = __fadd_rn(n_, 1.f);
        w_ = __fadd_rn(w_, __fmul_rn(mval, sign));
        n[off] = n_;
        w[off] = w_;
      }
      if (link_here && a == link_a) {  // parent -> new child
        c_ = link_code;
        code[off] = c_;
      }
      nv[a] = n_;
      wv[a] = w_;
      pv[a] = p_;
      cv[a] = c_;
    } else {
      nv[a] = wv[a] = pv[a] = cv[a] = 0.f;
    }
  }
  if (install) {
    done[idx] = m2[3];
    tval[idx] = m2[4];
  }
  refresh_node(nv, wv, pv, cv, A, cpuct, besta + idx, bestc + idx);
}

__global__ void refresh_kernel(const float* __restrict__ n,
                               const float* __restrict__ w,
                               const float* __restrict__ p,
                               const float* __restrict__ code,
                               float* __restrict__ besta,
                               float* __restrict__ bestc,
                               int B, int A, int C, float cpuct) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * C) return;
  const int b = (int)(idx / C);
  const int c = (int)(idx - (size_t)b * C);
  float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
  const size_t base = (size_t)b * A * C + c;
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) {
    if (a < A) {
      const size_t off = base + (size_t)a * C;
      nv[a] = n[off];
      wv[a] = w[off];
      pv[a] = p[off];
      cv[a] = code[off];
    } else {
      nv[a] = wv[a] = pv[a] = cv[a] = 0.f;
    }
  }
  refresh_node(nv, wv, pv, cv, A, cpuct, besta + idx, bestc + idx);
}

// The dense refresh of one node: the first-max PUCT argmax over the A edges
// of its A-strided column (stride C from `base`), streamed from memory in
// two passes, the visit sum first. Any A.
__device__ __forceinline__ void dense_refresh_node(const float* n, const float* w,
                                                   const float* p, const float* code,
                                                   size_t base, int A, int C, float cpuct,
                                                   float* best_a, float* best_code) {
  float total = 0.f;
  for (int a = 0; a < A; ++a) {
    total = __fadd_rn(total, n[base + (size_t)a * C]);  // integers: exact in any order
  }
  const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
  float best = 0.f, ba = 0.f, bc = 0.f;
  for (int a = 0; a < A; ++a) {
    const size_t off = base + (size_t)a * C;
    const float s = puct_score(n[off], w[off], p[off], sq, cpuct);
    if (a == 0 || s > best) {
      best = s;
      ba = (float)a;
      bc = code[off];
    }
  }
  *best_a = ba;
  *best_code = bc;
}

// merge_kernel for any A: the same install, backup and link, written to the
// column in place, then the dense refresh of the column.
__global__ void merge_dense_kernel(float* __restrict__ n, float* __restrict__ w,
                                   float* __restrict__ p, float* __restrict__ code,
                                   float* __restrict__ done, float* __restrict__ tval,
                                   const float* __restrict__ pm,
                                   const float* __restrict__ patha,
                                   const float* __restrict__ psgn,
                                   const float* __restrict__ meta2,
                                   float* __restrict__ besta,
                                   float* __restrict__ bestc,
                                   int B, int A, int C, int slot, float cpuct) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * C) return;
  const int b = (int)(idx / C);
  const int c = (int)(idx - (size_t)b * C);

  const float* m2 = meta2 + (size_t)b * 8;
  const bool exp_ok = m2[1] > 0.5f;
  const size_t base = (size_t)b * A * C + c;
  if (exp_ok && c == slot) {  // fresh row at the lockstep slot
    for (int a = 0; a < A; ++a) {
      const size_t off = base + (size_t)a * C;
      n[off] = 0.f;
      w[off] = 0.f;
      p[off] = pm[(size_t)b * A + a];
      code[off] = -1.f;
    }
    done[idx] = m2[3];
    tval[idx] = m2[4];
  }
  const float on_path = patha[idx];  // action+1, or 0 off the path
  if (on_path > 0.5f) {  // backup along the path
    const size_t off = base + (size_t)((int)on_path - 1) * C;
    n[off] = __fadd_rn(n[off], 1.f);
    w[off] = __fadd_rn(w[off], __fmul_rn(m2[0], psgn[idx]));
  }
  if (exp_ok && c == (int)m2[5]) {  // parent -> new child
    code[base + (size_t)((int)m2[6]) * C] = m2[2];
  }
  dense_refresh_node(n, w, p, code, base, A, C, cpuct, besta + idx, bestc + idx);
}

__global__ void refresh_dense_kernel(const float* __restrict__ n,
                                     const float* __restrict__ w,
                                     const float* __restrict__ p,
                                     const float* __restrict__ code,
                                     float* __restrict__ besta,
                                     float* __restrict__ bestc,
                                     int B, int A, int C, float cpuct) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * C) return;
  const int b = (int)(idx / C);
  const int c = (int)(idx - (size_t)b * C);
  dense_refresh_node(n, w, p, code, (size_t)b * A * C + c, A, C, cpuct, besta + idx,
                     bestc + idx);
}

// ---------------------------------------------------------------------------
// K>1 leaf-parallel rounds (descend_round_kernel, merge_round_kernel and
// _refresh2 of alphazero_tpu/mcts/hybrid.py)
// ---------------------------------------------------------------------------

// One round's K descents per game, one thread per game. The thread keeps
// its root board in registers and walks its K descents one after another,
// each from a copy of the root; the in-round counters of every node (how
// often this round took its best action, and its runner-up) are bytes in
// shared memory, node-major with the block's games innermost, zeroed once
// per launch. Outputs are K-major: bd[k, b, :], patha/psgn[k, b, :],
// meta[k, b, :] = (exp, term, psign, v_term, cut, exp_node, exp_action,
// dup).
template <class Game>
__global__ void descend_round_kernel(const float* __restrict__ besta,
                                     const float* __restrict__ bestc,
                                     const float* __restrict__ seca,
                                     const float* __restrict__ secc,
                                     const float* __restrict__ done,
                                     const float* __restrict__ tval,
                                     const float* __restrict__ boards,
                                     float* __restrict__ bd,
                                     float* __restrict__ patha,
                                     float* __restrict__ psgn,
                                     float* __restrict__ meta,
                                     int B, int C, int K, int max_depth, int cells) {
  constexpr int W = Game::kWords;
  const int L = Game::kBoardCells > 0 ? Game::kBoardCells : cells;
  const int T = blockDim.x;
  extern __shared__ unsigned char round_counts[];
  unsigned char* taken_best = round_counts;              // [C][T]
  unsigned char* taken_second = round_counts + (size_t)C * T;
  const int b0 = blockIdx.x * T;
  const int games = min(T, B - b0);
  // zero the counters and this block's rows of the K path records
  for (int i = threadIdx.x; i < 2 * C * T; i += T) round_counts[i] = 0;
  for (int k = 0; k < K; ++k) {
    const size_t first = ((size_t)k * B + b0) * C;
    for (int i = threadIdx.x; i < games * C; i += T) {
      patha[first + i] = 0.f;
      psgn[first + i] = 0.f;
    }
  }
  __syncthreads();
  const int b = b0 + threadIdx.x;
  if (b >= B) return;

  uint64_t root_mine[W], root_theirs[W];
  load_board(boards + (size_t)b * L, L, root_mine, root_theirs);
  const size_t row = (size_t)b * C;
  const bool root_live = done[row] < 0.5f;  // a terminal root is not descended
  for (int k = 0; k < K; ++k) {
    uint64_t mine[W], theirs[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      mine[j] = root_mine[j];
      theirs[j] = root_theirs[j];
    }
    const size_t prow = ((size_t)k * B + b) * C;
    int node = 0, depth = 0, leaf = -1;
    float psign = 1.f;
    float exp = 0.f, term = 0.f, cut = 0.f, dup = 0.f, exp_node = 0.f, exp_action = 0.f;
    bool act = root_live;
    while (act) {
      // the runner-up when there is one and this round took it less often
      // than the best action here
      unsigned char* cnt_best = taken_best + (size_t)node * T + threadIdx.x;
      unsigned char* cnt_second = taken_second + (size_t)node * T + threadIdx.x;
      const float a2 = seca[row + node];
      const bool use2 = a2 > -0.5f && *cnt_second < *cnt_best;
      const float af = use2 ? a2 : besta[row + node];
      const float code = use2 ? secc[row + node] : bestc[row + node];
      unsigned char* taken = use2 ? cnt_second : cnt_best;
      const bool again = *taken > 0;  // read before this descent's take
      *taken += 1;
      patha[prow + node] = af + 1.f;
      psgn[prow + node] = psign;
      Game::step(mine, theirs, (int)af);

      const bool cterm = code < -1.5f;
      const bool unexp = !cterm && code < -0.5f;
      const float child = cterm ? -2.f - code : code;
      const bool live = !unexp && !cterm;
      const bool cutoff = live && depth + 1 >= max_depth;
      const bool go = live && !cutoff;
      if (unexp) {
        exp = 1.f;
        exp_node = (float)node;
        exp_action = af;
        if (again) dup = 1.f;  // another descent of this round claimed this edge
      }
      if (cterm) term = 1.f;
      if (cutoff) cut = 1.f;
      if (cterm || cutoff) leaf = (int)child;
      if (go) node = (int)child;
      depth += 1;
      psign = -psign;
      act = go;
    }
    store_board(bd + ((size_t)k * B + b) * L, L, mine, theirs);
    float* m = meta + ((size_t)k * B + b) * 8;
    m[0] = exp;
    m[1] = term;
    m[2] = psign;
    m[3] = leaf >= 0 ? tval[row + leaf] : 0.f;
    m[4] = cut;
    m[5] = exp_node;
    m[6] = exp_action;
    m[7] = dup;
  }
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

// Store a node's top-2 at idx: sec_a = -1 where no legal runner-up exists;
// there the dense branch also stores sec_code = -1 and the unrolled one the
// code its scan left (_refresh2, hybrid.py:208 and :233-234).
__device__ __forceinline__ void top2_store(Top2 t, bool dense, size_t idx, float* besta,
                                           float* bestc, float* seca, float* secc) {
  if (!(t.second > -1e29f)) {
    t.sec_a = -1.f;
    if (dense) t.sec_code = -1.f;
  }
  besta[idx] = t.best_a;
  bestc[idx] = t.best_code;
  seca[idx] = t.sec_a;
  secc[idx] = t.sec_code;
}

// The top-2 of one node from its A-strided column in memory (stride C from
// `base`), the visit sum first: any A.
__device__ __forceinline__ Top2 dense_top2(const float* n, const float* w, const float* p,
                                           const float* code, size_t base, int A, int C,
                                           float cpuct) {
  float total = 0.f;
  for (int a = 0; a < A; ++a) total = __fadd_rn(total, n[base + (size_t)a * C]);  // exact
  const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
  Top2 t{};
  for (int a = 0; a < A; ++a) {
    const size_t off = base + (size_t)a * C;
    top2_push(t, a, puct_score(n[off], w[off], p[off], sq, cpuct), code[off]);
  }
  return t;
}

__device__ __forceinline__ void store_if_changed(float* at, float old, float v) {
  if (__float_as_uint(old) != __float_as_uint(v)) *at = v;
}

// What one round's K path records do to the column of node c of game b,
// gathered once per column in k order: the JAX merge_round_kernel's
// per-descent terms, of which only these are not zero.
struct RoundColumn {
  float keep;                // prod_k (1 - installed_k): 0 where a descent installs
  int inst;                  // that descent, or -1
  int npath, nlink;
  int path_a[kMaxRoundK];    // the edge each path through this node took ...
  float path_v[kMaxRoundK];  // ... and what it backs up, mval * psgn
  int link_a[kMaxRoundK];    // the edges of this node a descent expanded ...
  float link_v[kMaxRoundK];  // ... and link_code + 1
};

// Gather the column's terms and merge its done/tval cells:
// done = done * (1 - sum_k installed_k) + sum_k installed_k * cdone_k.
__device__ __forceinline__ RoundColumn round_column(float* done, float* tval, const float* patha,
                                                    const float* psgn, const float* meta2, int b,
                                                    int c, int B, int C, int K, int slot0) {
  RoundColumn col;
  col.keep = 1.f;
  col.inst = -1;
  col.npath = col.nlink = 0;
  float nm_all = 0.f, dn = 0.f, dt = 0.f;
  const size_t idx = (size_t)b * C + c;
  for (int k = 0; k < K; ++k) {
    const float* m2 = meta2 + ((size_t)k * B + b) * 8;
    const float inst = m2[1];  // exp * (1 - dup) * (slot < C)
    const float nm = __fmul_rn(inst, c == slot0 + k ? 1.f : 0.f);
    col.keep = __fmul_rn(col.keep, __fsub_rn(1.f, nm));
    dn = __fadd_rn(dn, __fmul_rn(nm, m2[3]));
    dt = __fadd_rn(dt, __fmul_rn(nm, m2[4]));
    nm_all = __fadd_rn(nm_all, nm);
    if (nm != 0.f) col.inst = k;
    const size_t kidx = (size_t)k * B * C + idx;
    const float pa = patha[kidx];  // action+1, or 0 off the path
    if (pa > 0.5f) {
      col.path_a[col.npath] = (int)pa - 1;
      col.path_v[col.npath] = __fmul_rn(m2[0], __fmul_rn(psgn[kidx], 1.f));
      ++col.npath;
    }
    if (inst != 0.f && (int)m2[5] == c) {  // parent -> new child
      col.link_a[col.nlink] = (int)m2[6];
      col.link_v[col.nlink] = __fmul_rn(__fadd_rn(m2[2], 1.f), inst);
      ++col.nlink;
    }
  }
  const float old_done = done[idx], old_tval = tval[idx];
  const float not_new = __fsub_rn(1.f, nm_all);
  store_if_changed(done + idx, old_done, __fadd_rn(__fmul_rn(old_done, not_new), dn));
  store_if_changed(tval + idx, old_tval, __fadd_rn(__fmul_rn(old_tval, not_new), dt));
  return col;
}

// One cell (action a) of the column: x * keep + (the terms' sum in k order).
__device__ __forceinline__ void round_cell(const RoundColumn& col, int a, const float* pm_row,
                                           float& n, float& w, float& p, float& code) {
  float n_add = 0.f, w_add = 0.f;
  for (int j = 0; j < col.npath; ++j) {
    if (col.path_a[j] == a) {
      n_add = __fadd_rn(n_add, 1.f);
      w_add = __fadd_rn(w_add, col.path_v[j]);
    }
  }
  const float p_inst = col.inst >= 0 ? __fadd_rn(0.f, pm_row[a]) : 0.f;
  float code_delta = col.inst >= 0 ? -1.f : 0.f;
  for (int j = 0; j < col.nlink; ++j) {
    if (col.link_a[j] == a) code_delta = __fadd_rn(code_delta, col.link_v[j]);
  }
  n = __fadd_rn(__fmul_rn(n, col.keep), n_add);
  w = __fadd_rn(__fmul_rn(w, col.keep), w_add);
  p = __fadd_rn(__fmul_rn(p, col.keep), p_inst);
  code = __fadd_rn(__fmul_rn(code, col.keep), code_delta);
}

// Merge and refresh one column, in place: one thread per (game, node).
// Reads every cell of the column, writes those whose bits change. A <= 8
// keeps the column in registers; larger A (dense) re-reads it for the
// top-2 scan.
template <bool kDense>
__device__ __forceinline__ void merge_round_column(float* n, float* w, float* p, float* code,
                                                   float* done, float* tval, const float* pm,
                                                   const float* patha, const float* psgn,
                                                   const float* meta2, float* besta, float* bestc,
                                                   float* seca, float* secc, int B, int A, int C,
                                                   int K, int slot0, float cpuct) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * C) return;
  const int b = (int)(idx / C);
  const int c = (int)(idx - (size_t)b * C);
  const RoundColumn col = round_column(done, tval, patha, psgn, meta2, b, c, B, C, K, slot0);
  const float* pm_row = col.inst >= 0 ? pm + ((size_t)col.inst * B + b) * A : nullptr;
  const size_t base = (size_t)b * A * C + c;
  Top2 t{};
  if (kDense) {
    for (int a = 0; a < A; ++a) {
      const size_t off = base + (size_t)a * C;
      const float n0 = n[off], w0 = w[off], p0 = p[off], c0 = code[off];
      float n_ = n0, w_ = w0, p_ = p0, c_ = c0;
      round_cell(col, a, pm_row, n_, w_, p_, c_);
      store_if_changed(n + off, n0, n_);
      store_if_changed(w + off, w0, w_);
      store_if_changed(p + off, p0, p_);
      store_if_changed(code + off, c0, c_);
    }
    t = dense_top2(n, w, p, code, base, A, C, cpuct);
  } else {
    float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
    float total = 0.f;
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      if (a < A) {
        const size_t off = base + (size_t)a * C;
        const float n0 = n[off], w0 = w[off], p0 = p[off], c0 = code[off];
        nv[a] = n0;
        wv[a] = w0;
        pv[a] = p0;
        cv[a] = c0;
        round_cell(col, a, pm_row, nv[a], wv[a], pv[a], cv[a]);
        store_if_changed(n + off, n0, nv[a]);
        store_if_changed(w + off, w0, wv[a]);
        store_if_changed(p + off, p0, pv[a]);
        store_if_changed(code + off, c0, cv[a]);
        total = __fadd_rn(total, nv[a]);  // integers: exact in any order
      }
    }
    const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      if (a < A) top2_push(t, a, puct_score(nv[a], wv[a], pv[a], sq, cpuct), cv[a]);
    }
  }
  top2_store(t, kDense, idx, besta, bestc, seca, secc);
}

__global__ void merge_round_kernel(float* __restrict__ n, float* __restrict__ w,
                                   float* __restrict__ p, float* __restrict__ code,
                                   float* __restrict__ done, float* __restrict__ tval,
                                   const float* __restrict__ pm, const float* __restrict__ patha,
                                   const float* __restrict__ psgn,
                                   const float* __restrict__ meta2, float* __restrict__ besta,
                                   float* __restrict__ bestc, float* __restrict__ seca,
                                   float* __restrict__ secc, int B, int A, int C, int K,
                                   int slot0, float cpuct) {
  merge_round_column<false>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, seca,
                            secc, B, A, C, K, slot0, cpuct);
}

__global__ void merge_round_dense_kernel(float* __restrict__ n, float* __restrict__ w,
                                         float* __restrict__ p, float* __restrict__ code,
                                         float* __restrict__ done, float* __restrict__ tval,
                                         const float* __restrict__ pm,
                                         const float* __restrict__ patha,
                                         const float* __restrict__ psgn,
                                         const float* __restrict__ meta2,
                                         float* __restrict__ besta, float* __restrict__ bestc,
                                         float* __restrict__ seca, float* __restrict__ secc,
                                         int B, int A, int C, int K, int slot0, float cpuct) {
  merge_round_column<true>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, seca,
                           secc, B, A, C, K, slot0, cpuct);
}

// The top-2 refresh alone, which seeds a round search's first planes
// (_refresh2 at hybrid.py:874): A <= 8 from registers, or dense.
template <bool kDense>
__global__ void refresh2_kernel(const float* __restrict__ n, const float* __restrict__ w,
                                const float* __restrict__ p, const float* __restrict__ code,
                                float* __restrict__ besta, float* __restrict__ bestc,
                                float* __restrict__ seca, float* __restrict__ secc, int B, int A,
                                int C, float cpuct) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * C) return;
  const int b = (int)(idx / C);
  const int c = (int)(idx - (size_t)b * C);
  const size_t base = (size_t)b * A * C + c;
  Top2 t{};
  if (kDense) {
    t = dense_top2(n, w, p, code, base, A, C, cpuct);
  } else {
    float nv[kMaxA], total = 0.f;
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      nv[a] = a < A ? n[base + (size_t)a * C] : 0.f;
      total = __fadd_rn(total, nv[a]);
    }
    const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      if (a < A) {
        const size_t off = base + (size_t)a * C;
        top2_push(t, a, puct_score(nv[a], w[off], p[off], sq, cpuct), code[off]);
      }
    }
  }
  top2_store(t, kDense, idx, besta, bestc, seca, secc);
}

unsigned int blocks_for(size_t items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

template <class Game>
int launch_descend(const float* besta, const float* bestc, const float* done,
                   const float* tval, const float* boards, float* bd, float* patha,
                   float* psgn, float* meta, int B, int C, int max_depth, int cells,
                   void* stream) {
  descend_kernel<Game><<<blocks_for(B, kDescendThreads), kDescendThreads, 0,
                         (cudaStream_t)stream>>>(
      besta, bestc, done, tval, boards, bd, patha, psgn, meta, B, C, max_depth, cells);
  return (int)cudaGetLastError();
}

// The K descents of a round: two byte counters per node and game of the
// block in dynamic shared memory (above 48 KB only after opting in).
template <class Game>
int launch_descend_round(const float* besta, const float* bestc, const float* seca,
                         const float* secc, const float* done, const float* tval,
                         const float* boards, float* bd, float* patha, float* psgn, float* meta,
                         int B, int C, int K, int max_depth, int cells, void* stream) {
  const size_t smem = 2 * (size_t)C * kDescendThreads;
  if (K < 1 || K > 255 || smem > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        descend_round_kernel<Game>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  descend_round_kernel<Game><<<blocks_for(B, kDescendThreads), kDescendThreads, smem,
                               (cudaStream_t)stream>>>(
      besta, bestc, seca, secc, done, tval, boards, bd, patha, psgn, meta, B, C, K, max_depth,
      cells);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The descend entries: boards f32[B, cells], cells being the game's own
// (42, 64, 49) or, for Gomoku, its edge squared (at most 256).
int az_descend(const float* besta, const float* bestc, const float* done,
               const float* tval, const float* boards, float* bd, float* patha,
               float* psgn, float* meta, int B, int C, int max_depth, int cells,
               void* stream) {
  return launch_descend<ConnectFourGame>(besta, bestc, done, tval, boards, bd, patha, psgn,
                                         meta, B, C, max_depth, cells, stream);
}

int az_descend_othello(const float* besta, const float* bestc, const float* done,
                       const float* tval, const float* boards, float* bd,
                       float* patha, float* psgn, float* meta, int B, int C,
                       int max_depth, int cells, void* stream) {
  return launch_descend<OthelloGame>(besta, bestc, done, tval, boards, bd, patha, psgn, meta,
                                     B, C, max_depth, cells, stream);
}

int az_descend_gomoku(const float* besta, const float* bestc, const float* done,
                      const float* tval, const float* boards, float* bd,
                      float* patha, float* psgn, float* meta, int B, int C,
                      int max_depth, int cells, void* stream) {
  return launch_descend<GomokuGame>(besta, bestc, done, tval, boards, bd, patha, psgn, meta,
                                    B, C, max_depth, cells, stream);
}

int az_descend_hex(const float* besta, const float* bestc, const float* done,
                   const float* tval, const float* boards, float* bd, float* patha,
                   float* psgn, float* meta, int B, int C, int max_depth, int cells,
                   void* stream) {
  return launch_descend<HexGame>(besta, bestc, done, tval, boards, bd, patha, psgn, meta, B, C,
                                 max_depth, cells, stream);
}

int az_merge(float* n, float* w, float* p, float* code, float* done,
             float* tval, const float* pm, const float* patha,
             const float* psgn, const float* meta2, float* besta,
             float* bestc, int B, int A, int C, int slot, float cpuct,
             void* stream) {
  merge_kernel<<<blocks_for((size_t)B * C, kMergeThreads), kMergeThreads, 0,
                 (cudaStream_t)stream>>>(n, w, p, code, done, tval, pm, patha,
                                         psgn, meta2, besta, bestc, B, A, C,
                                         slot, cpuct);
  return (int)cudaGetLastError();
}

int az_merge_dense(float* n, float* w, float* p, float* code, float* done,
                   float* tval, const float* pm, const float* patha,
                   const float* psgn, const float* meta2, float* besta,
                   float* bestc, int B, int A, int C, int slot, float cpuct,
                   void* stream) {
  merge_dense_kernel<<<blocks_for((size_t)B * C, kMergeThreads), kMergeThreads, 0,
                       (cudaStream_t)stream>>>(n, w, p, code, done, tval, pm,
                                               patha, psgn, meta2, besta, bestc,
                                               B, A, C, slot, cpuct);
  return (int)cudaGetLastError();
}

int az_refresh(const float* n, const float* w, const float* p,
               const float* code, float* besta, float* bestc, int B, int A,
               int C, float cpuct, void* stream) {
  refresh_kernel<<<blocks_for((size_t)B * C, kMergeThreads), kMergeThreads, 0,
                   (cudaStream_t)stream>>>(n, w, p, code, besta, bestc, B, A,
                                           C, cpuct);
  return (int)cudaGetLastError();
}

int az_refresh_dense(const float* n, const float* w, const float* p,
                     const float* code, float* besta, float* bestc, int B,
                     int A, int C, float cpuct, void* stream) {
  refresh_dense_kernel<<<blocks_for((size_t)B * C, kMergeThreads), kMergeThreads, 0,
                         (cudaStream_t)stream>>>(n, w, p, code, besta, bestc, B,
                                                 A, C, cpuct);
  return (int)cudaGetLastError();
}

// The round entries: K descents per game (1 <= K <= 255, C <= 3632 nodes),
// outputs K-major.
int az_descend_round(const float* besta, const float* bestc, const float* seca,
                     const float* secc, const float* done, const float* tval,
                     const float* boards, float* bd, float* patha, float* psgn, float* meta,
                     int B, int C, int K, int max_depth, int cells, void* stream) {
  return launch_descend_round<ConnectFourGame>(besta, bestc, seca, secc, done, tval, boards, bd,
                                               patha, psgn, meta, B, C, K, max_depth, cells,
                                               stream);
}

int az_descend_round_othello(const float* besta, const float* bestc, const float* seca,
                             const float* secc, const float* done, const float* tval,
                             const float* boards, float* bd, float* patha, float* psgn,
                             float* meta, int B, int C, int K, int max_depth, int cells,
                             void* stream) {
  return launch_descend_round<OthelloGame>(besta, bestc, seca, secc, done, tval, boards, bd,
                                           patha, psgn, meta, B, C, K, max_depth, cells, stream);
}

int az_descend_round_gomoku(const float* besta, const float* bestc, const float* seca,
                            const float* secc, const float* done, const float* tval,
                            const float* boards, float* bd, float* patha, float* psgn,
                            float* meta, int B, int C, int K, int max_depth, int cells,
                            void* stream) {
  return launch_descend_round<GomokuGame>(besta, bestc, seca, secc, done, tval, boards, bd,
                                          patha, psgn, meta, B, C, K, max_depth, cells, stream);
}

int az_descend_round_hex(const float* besta, const float* bestc, const float* seca,
                         const float* secc, const float* done, const float* tval,
                         const float* boards, float* bd, float* patha, float* psgn, float* meta,
                         int B, int C, int K, int max_depth, int cells, void* stream) {
  return launch_descend_round<HexGame>(besta, bestc, seca, secc, done, tval, boards, bd, patha,
                                       psgn, meta, B, C, K, max_depth, cells, stream);
}

// The round merges: pm f32[K, B, A], patha/psgn f32[K, B, C], meta2
// f32[K, B, 8]; descent k installs at slot slot0 + k. 1 <= K <= 16.
int az_merge_round(float* n, float* w, float* p, float* code, float* done, float* tval,
                   const float* pm, const float* patha, const float* psgn, const float* meta2,
                   float* besta, float* bestc, float* seca, float* secc, int B, int A, int C,
                   int K, int slot0, float cpuct, void* stream) {
  if (K < 1 || K > kMaxRoundK || A > kMaxA) return (int)cudaErrorInvalidValue;
  merge_round_kernel<<<blocks_for((size_t)B * C, kMergeThreads), kMergeThreads, 0,
                       (cudaStream_t)stream>>>(n, w, p, code, done, tval, pm, patha, psgn,
                                               meta2, besta, bestc, seca, secc, B, A, C, K,
                                               slot0, cpuct);
  return (int)cudaGetLastError();
}

int az_merge_round_dense(float* n, float* w, float* p, float* code, float* done, float* tval,
                         const float* pm, const float* patha, const float* psgn,
                         const float* meta2, float* besta, float* bestc, float* seca,
                         float* secc, int B, int A, int C, int K, int slot0, float cpuct,
                         void* stream) {
  if (K < 1 || K > kMaxRoundK) return (int)cudaErrorInvalidValue;
  merge_round_dense_kernel<<<blocks_for((size_t)B * C, kMergeThreads), kMergeThreads, 0,
                             (cudaStream_t)stream>>>(n, w, p, code, done, tval, pm, patha, psgn,
                                                     meta2, besta, bestc, seca, secc, B, A, C,
                                                     K, slot0, cpuct);
  return (int)cudaGetLastError();
}

int az_refresh2(const float* n, const float* w, const float* p, const float* code, float* besta,
                float* bestc, float* seca, float* secc, int B, int A, int C, float cpuct,
                void* stream) {
  if (A > kMaxA) return (int)cudaErrorInvalidValue;
  refresh2_kernel<false><<<blocks_for((size_t)B * C, kMergeThreads), kMergeThreads, 0,
                           (cudaStream_t)stream>>>(n, w, p, code, besta, bestc, seca, secc, B, A,
                                                   C, cpuct);
  return (int)cudaGetLastError();
}

int az_refresh2_dense(const float* n, const float* w, const float* p, const float* code,
                      float* besta, float* bestc, float* seca, float* secc, int B, int A, int C,
                      float cpuct, void* stream) {
  refresh2_kernel<true><<<blocks_for((size_t)B * C, kMergeThreads), kMergeThreads, 0,
                          (cudaStream_t)stream>>>(n, w, p, code, besta, bestc, seca, secc, B, A,
                                                  C, cpuct);
  return (int)cudaGetLastError();
}

}  // extern "C"
