// Hybrid-engine search kernels for Hopper (sm_90a): descend, merge, refresh.
//
// Replace the Pallas kernels of alphazero_tpu/mcts/hybrid.py:
//   az_descend, az_descend_othello, az_descend_gomoku, az_descend_hex
//               <- descend_kernel (hybrid.py:242-356), one instance per game
//                  of descend_kernel<Game>: the Connect-Four step
//                  (FlatOps.step, games/connect_four.py:201-217) from c4.cuh,
//                  the Othello step (OthelloFlatOps.step, games/othello.py
//                  :228-265) from othello.cuh, the Gomoku step of every edge
//                  (GomokuFlatOps.step, games/gomoku.py:191-200) from
//                  gomoku.cuh, the canonical Hex step (HexFlatOps.step,
//                  games/hex.py:214-232, without its parity lane) from
//                  hex.cuh;
//   az_merge    <- merge_kernel (hybrid.py:363-422) with the A<=8 PUCT
//                  refresh (_refresh, hybrid.py:120-149), which refreshes
//                  only the columns the merge writes;
//   az_merge_dense
//               <- the same merge with _refresh's dense branch for larger
//                  action spaces (hybrid.py:150-168; Othello A=65), which
//                  refreshes only the columns the merge writes;
//   az_refresh  <- the A<=8 refresh's seed of a fresh search (_refresh,
//                  hybrid.py:120-149, at hybrid.py:815 on the planes of
//                  hybrid.py:800-815): only the roots' column is computed,
//                  every other node's row is the empty node's constant;
//   az_refresh_dense
//               <- the dense refresh's seed of a fresh search (hybrid.py:815),
//                  the same kernel for larger action spaces;
//   az_descend_round, az_descend_round_othello, az_descend_round_gomoku,
//   az_descend_round_hex
//               <- descend_round_kernel (hybrid.py:437-577), K7a: a round's
//                  K descents per game, one instance per game as above;
//   az_merge_round, az_merge_round_dense
//               <- merge_round_kernel (hybrid.py:579-657) with _refresh2's
//                  unrolled and dense top-2 branches (hybrid.py:170-235),
//                  K7b, each refreshing only the columns the K records
//                  write;
//   az_refresh2 <- the A<=8 _refresh2's seed of a fresh round search
//                  (hybrid.py:874), designed as az_refresh;
//   az_refresh2_dense
//               <- the dense _refresh2's seed of a fresh round search
//                  (hybrid.py:874), the same kernel for larger action spaces.
// The plain PyTorch versions are descend/merge/refresh in
// alphazero_tpu_torch/mcts/hybrid.py; the two must agree bit for bit.
//
// Tree layout (per game b): stat planes n/w/p/code f32[B, A, C] (node c of
// action a at b*A*C + a*C + c), node planes done/tval f32[B, C], the best-
// action planes besta/bestc f32[B, C] that the refresh keeps current for the
// next descent, in place. Child codes: -1 unexpanded, >= 0 a child slot,
// -2-s a terminal child at slot s.
//
// Path record between the kernels: patha[b, c] = action+1 where node c lies
// on the descent path (0 elsewhere), psgn[b, c] = its root-parity sign, and
// meta[b, 8] = (exp, term, psign, v_term, cut, exp_node, exp_action, 0).
// The merge takes meta2[b, 8] = (mval, exp_ok, link_code, cdone, ctval,
// exp_node, exp_action, 0) and the lockstep slot s.
//
// What bounds them on an H100, and what the design does about it:
// * descend is latency-bound pointer chasing: each step is one dependent
//   load of besta/bestc at the current node. One warp walks one game
//   (4 games a block, so the 1024 games of the Othello, Gomoku and Hex full
//   presets spread over all 132 SMs, and Connect-Four's 4096 fill them in
//   one wave) with real indexing (the TPU kernel's one-hot lane reductions
//   are layout, not semantics), and carries the board in registers as
//   bitboards of 64-bit words a side: every lane the whole board (one word
//   for Connect-Four, Othello and Hex; eight for Gomoku up to 512 cells,
//   twelve up to 768), so a Connect-Four step is a popcount and two bit
//   ops, an Othello step a register-only walk of the 8 rays, a Gomoku step
//   two bit ops per word and a Hex step two 7x7 transposes of 12 masked
//   shifts each. A Gomoku board above 768 cells stays in the leaf row
//   (RowBoard): the warp copies the root's row there, lane 0 writes each
//   step's stone, and an odd path flips the row's signs at the end, so no
//   register grows with the board. The board row comes in coalesced: lane
//   l loads cells l, l + 32, ..., all in flight with the root's cells, and
//   a ballot of each 32-cell chunk gives 32 bits of a side at once; it
//   goes out the same way. The walk is warp-uniform: every lane loads the
//   same cell (one transaction) and steps its own copy of the board, so no
//   branch of a step diverges, and the next node's loads are issued before
//   the step. What is left is the chain itself: a trip for the row and the
//   root, one per edge of the path, one for the stores, and the launch.
// * merge (A <= 8) works only on the columns the merge writes (the path
//   nodes, the install slot, the expanded parent: ~2.6 of C=101 a game on
//   the Connect-Four ResNet path), where the JAX kernel refreshes every
//   node of the four [B, A, C] planes (46 MB at B=4096, C=101, A=7): a
//   node's argmax is a function of its own column, so every other node's
//   besta/bestc, left by the search's seed refresh or an earlier merge, is
//   already right. That is its precondition: on entry the best planes are
//   the refresh of the entry planes. One warp per game finds the touched
//   columns with ballots over its patha row and lane l merges the l-th of
//   them alone, as the earlier thread per (game, node) did: the column's
//   28 cells loaded together (an install slot's not at all: it is written
//   anew), the first-max argmax from registers, only the cells that change
//   written (install row, path edge, one link).
// * merge_dense (A > 8; replaces the same merge_kernel with _refresh's
//   dense branch) works only on the columns the merge writes, under
//   merge's precondition. The JAX kernel rewrites whole planes because a
//   TPU block works on whole [Bb, A, C] tiles; that is layout, not
//   semantics. One warp per game scans its patha row 32
//   nodes at a time (the next chunk's loads in flight) and finds with a
//   ballot the path nodes, the install slot and the expanded parent; for
//   each, lane l takes actions l, l + 32, ...: it loads its cells of the
//   four planes together (one trip to memory), applies the install, backup
//   and link terms of merge_kernel, and keeps them in registers (J = 4, 8,
//   16 or 24 a lane by A, up to A = 768; above, the streamed instance J = 0
//   walks the column in chunks of 32 x 16 actions, in increasing order,
//   after a first pass that sums the column's counts, and carries each
//   lane's first maximum across the chunks). The visit sum is a
//   butterfly of shuffles (integer counts below 2^24: exact in any order),
//   the argmax a butterfly on (score descending, action ascending), the
//   sequential strict-> scan's order, and the winning lane hands over the
//   child code. No other column is read: about 2-5 columns a game instead
//   of C. What bounds it now is the layout: a column is A-strided by C
//   floats, so each lane's load is its own 32-byte sector for 4 useful
//   bytes (~8x the useful bytes), and those scattered sectors, not their
//   latency, set its time (it grows with A at a fixed number of columns);
//   a node-major [B, C, A] layout would make a column contiguous.
// * The seeds (az_refresh, az_refresh2 and their dense entries) run once a
//   search, on the fresh planes _init_planes leaves: the roots' priors in
//   p[:, :, 0], n = w = p = 0 and code = -1 everywhere else. That is their
//   precondition, at every A. Every column c >= 1 is then the empty node,
//   whose A edges all score +0: its refresh is the constant (besta, bestc,
//   seca, secc) = (0, -1, 1, -1), or (0, -1, -1, -1) at A = 1, which has
//   no runner-up. The roots' column has n = w = 0 and code = -1 as well,
//   so its refresh is a function of the priors alone. The reference
//   refreshes every node of the [B, A, C] planes (in XLA at the seed; in
//   whole TPU tiles in the merge kernels): layout, not semantics. Reading
//   the four planes made the earlier
//   thread-per-node seeds move 4·B·A·C floats (46 MB at B=4096, A=7; 372
//   MB at B=1024, A=225). One warp per game now loads the game's A priors
//   (lane l: actions l, l + 32, ..., all in flight; one a lane at A <= 8),
//   scores and reduces them as merge_dense does, and writes the game's
//   best rows lane-strided. What bounds it is B·A scattered 32-byte
//   sectors (each prior is its own sector in [B, A, C]) plus the rows'
//   stores and the launch.
// * The untouched cells need no write because a search's planes never hold
//   -0: counts, backups and priors start at +0 and x + y is -0 only when
//   both are, so the reference's x * 1 + 0 on an untouched cell is x.
// K>1 rounds (parallel_sims = K): the refresh leaves the runner-up too,
// seca/secc [B, C] (-1 where no legal runner-up exists). A round's K
// descents run one after another in ONE warp per game, as descend walks
// its one, each from a register copy of the root board (loaded once, with
// the root's four best cells), so a descent sees the in-round counters of
// the descents before it: two bytes per node and game (takes of the best
// action and of the runner-up) in the warp's slice of shared memory, [2][C]
// (C <= 29056 at 4 games a block; above 48 KB the launch opts in), zeroed
// by the warp; for K > 255 or more nodes, two 32-bit counters in a global
// scratch [B][2][C] that the caller allocates and the warp zeroes as it
// zeroes the shared ones (32 bits: no K that a search takes wraps them, and
// the few a descent touches stay in L1 and L2). Every
// lane reads them; lane 0 alone adds a take, after a __syncwarp, and a
// __syncwarp ends each descent. A step's four best cells
// travel together. The records are K-major: bd[K, B, L], patha/psgn[K, B,
// C], meta[K, B, 8] with dup in lane 7. Its bound is the same dependent-load
// chain as the K=1 descend, K times as long, for K times the path bytes.
// The A <= 8 round merge is merge's
// design for K records: one warp per game stages the K meta2 records in
// shared memory (above K = 16 it reads them where they lie in meta2, one
// broadcast load each), merges every node's done/tval cells (two coalesced
// rows: the reference rewrites them all) and finds the columns any record
// writes;
// lane l merges the l-th of them alone: it sums what each of the K records
// does to each cell (a path edge, an install, a link) in k order, then
// rewrites the cell as x * keep + (that sum), the JAX kernel's arithmetic
// term by term, storing only cells whose bits change. Its top-2 scan
// pushes the edges in action order with strict comparisons, which gives
// the dense branch's exclude-and-re-reduce result (all but the runner-up
// code where there is no legal runner-up, see top2_store). Its
// precondition is merge's, for the four top-2 planes. The dense round
// merge is merge_dense's design for K records: one
// warp per game stages the K meta2 records in shared memory, merges every
// node's done/tval cells (two coalesced rows: the reference rewrites them
// all) and finds the columns any record writes; for each, lanes 0..K-1
// gather the K descents' terms into shared memory and the warp merges the
// column cell by cell as above, then reduces a top-2: each lane pushes its
// own actions in order, the lanes' pairs merge in a butterfly under the
// same order, and the owners of the two winners hand over their codes.
// Above A = 768 or K = 16 the streamed instance reads the records where
// they lie, stages a column's terms 16 descents at a time, and walks the
// column in chunks of 32 x 8 actions, each cell's terms summed in k order
// across the record chunks. Its precondition is the same, for the four
// top-2 planes.
//
// Warp intrinsics run on the CPU emulator of tests/cuda_emu (a barrier and
// an exchange slot per lane of each warp), so the reductions are held bit
// for bit against the plain full refresh there too.
//
// Arithmetic is bit-exact with the reference: build with --fmad=false (no
// a*b+c contraction), default -prec-div/-prec-sqrt, never --use_fast_math;
// the PUCT score is written with explicit round-to-nearest intrinsics in the
// reference's operation order q + ((cpuct*p)*sqrt(sum n + EPS))/(1 + n),
// q = w / max(n, 1), and ties keep the first maximum (strict >), which is
// the dense branch's smallest action among the exact maxima.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "c4.cuh"       // c4_step, refresh_node, Top2 and the constants
#include "gomoku.cuh"   // gomoku_step
#include "hex.cuh"      // hex_step
#include "othello.cuh"  // othello_step

namespace {

constexpr int kDescendWarps = 4;             // games (warps) per block of a descend
constexpr int kDescendThreads = 32 * kDescendWarps;
constexpr int kMaxRoundK = 16;    // records a round merge stages at once (kernels.MAX_ROUND_K)
constexpr int kMaxSharedBytes = 232448;   // a block's dynamic shared memory on sm_90
// the round descend's byte counters: K <= 255, and 4 games' [2][C] bytes in
// shared memory (kernels.ROUND_MAX_NODES); past either, 32-bit counters in a
// global scratch
constexpr int kMaxByteK = 255;
constexpr int kMaxByteNodes = kMaxSharedBytes / (2 * kDescendWarps);
constexpr unsigned kFullMask = 0xffffffffu;

// Flat f32[L] board (+1 / -1 / 0) -> bitboards, by the calling warp: lane l
// loads cells l, l + 32, ... (each load instruction one coalesced run of
// the row, all of them in flight together), and a ballot of each 32-cell
// chunk gives 32 bits of `mine` and of `theirs` at once, on every lane.
// Cell 64k + j is bit j of word k; word indices are compile-time
// constants, so the words stay in registers. The chunk test is the same on
// every lane (L is), so every lane meets every ballot.
template <int W>
__device__ __forceinline__ void warp_load_board(const float* board, int L, int lane,
                                                uint64_t (&mine)[W], uint64_t (&theirs)[W]) {
  float v[2 * W];
#pragma unroll
  for (int j = 0; j < 2 * W; ++j) v[j] = 32 * j + lane < L ? board[32 * j + lane] : 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint64_t m = 0, t = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (32 * (2 * k + h) < L) {
        m |= (uint64_t)__ballot_sync(kFullMask, v[2 * k + h] > 0.5f) << (32 * h);
        t |= (uint64_t)__ballot_sync(kFullMask, v[2 * k + h] < -0.5f) << (32 * h);
      }
    }
    mine[k] = m;
    theirs[k] = t;
  }
}

// Bitboards -> flat f32[L] board, +0 in empty cells, by the calling warp:
// lane l writes cells l, l + 32, ... (coalesced).
template <int W>
__device__ __forceinline__ void warp_store_board(float* out, int L, int lane,
                                                 const uint64_t (&mine)[W],
                                                 const uint64_t (&theirs)[W]) {
#pragma unroll
  for (int j = 0; j < 2 * W; ++j) {
    const int bit = 32 * (j & 1) + lane;
    if (32 * j + lane < L) {
      out[32 * j + lane] = ((mine[j >> 1] >> bit) & 1ull)
                               ? 1.f
                               : (((theirs[j >> 1] >> bit) & 1ull) ? -1.f : 0.f);
    }
  }
}

// The board a descent steps, by the calling warp, in one of two forms,
// each with board_load (the root's row into the root's board), board_begin
// (a descent's board from the root's; its leaf row is `out`) and
// board_store (the leaf board into `out`, +0 in empty cells):
// * WordBoard<W>: every lane holds the whole board as W 64-bit words a side
//   (cell 64k + j is bit j of word k) and steps its own copy;
// * RowBoard: a board too wide for the registers stays in the
//   leaf row: the root's row is copied there (coalesced), each step's stone
//   is written there by lane 0 as seen by the root's player to move (+1 for
//   that player's stones, -1 for the other's), and at the end an odd path
//   flips the row's signs (coalesced) to the leaf's player to move.
template <int W>
struct WordBoard {
  uint64_t mine[W], theirs[W];
};

template <int W>
__device__ __forceinline__ void board_load(WordBoard<W>& root, const float* row, int L, int lane) {
  warp_load_board(row, L, lane, root.mine, root.theirs);
}
template <int W>
__device__ __forceinline__ void board_begin(WordBoard<W>& board, const WordBoard<W>& root, float*,
                                            int, int) {
  board = root;
}
template <int W>
__device__ __forceinline__ void board_store(const WordBoard<W>& board, float* out, int L,
                                            int lane) {
  warp_store_board(out, L, lane, board.mine, board.theirs);
}

struct RowBoard {
  const float* root;  // the root's row
  float* out;         // the descent's leaf row
  float sign;         // the next stone as the root's player sees it: +1 after an even path
};

__device__ __forceinline__ void board_load(RowBoard& root, const float* row, int, int) {
  root.root = row;
  root.out = nullptr;
  root.sign = 1.f;
}
__device__ __forceinline__ void board_begin(RowBoard& board, const RowBoard& root, float* out,
                                            int L, int lane) {
  for (int c = lane; c < L; c += 32) {
    const float v = root.root[c];
    out[c] = v > 0.5f ? 1.f : (v < -0.5f ? -1.f : 0.f);
  }
  __syncwarp();  // every lane's cells before lane 0's stones
  board.root = root.root;
  board.out = out;
  board.sign = 1.f;
}
__device__ __forceinline__ void board_store(const RowBoard& board, float* out, int L, int lane) {
  __syncwarp();  // lane 0's stones before the row is read
  if (board.sign < 0.f) {  // an odd path: the leaf's player to move is the root's opponent
    for (int c = lane; c < L; c += 32) {
      const float v = out[c];
      if (v != 0.f) out[c] = -v;
    }
  }
}

// The games descend_kernel is instantiated for: the board's form, the board
// cells (0: the `cells` argument, at run time) and the step on that form
// (the calling lane's part of it).
struct ConnectFourGame {
  static constexpr int kBoardCells = kCells;
  using Board = WordBoard<1>;
  static __device__ __forceinline__ void step(Board& d, int a, int) {
    c4_step(d.mine[0], d.theirs[0], a);
  }
};

struct OthelloGame {
  static constexpr int kBoardCells = kOthCells;
  using Board = WordBoard<1>;
  static __device__ __forceinline__ void step(Board& d, int a, int) {
    othello_step(d.mine[0], d.theirs[0], a);
  }
};

// Gomoku boards of up to 64 * W cells, any edge: the cells come at run time.
// Instantiated for W = 8 (up to 512 cells, edges up to 22) and W = 12 (up to
// 768 cells, edges 23 to 27, which only those boards take): on the H100 a
// 4-word instance descends Gomoku 15 in the same time, the path's loads
// and not the words' bit operations setting it.
template <int W>
struct GomokuGame {
  static constexpr int kBoardCells = 0;
  using Board = WordBoard<W>;
  static __device__ __forceinline__ void step(Board& d, int a, int) {
    gomoku_step(d.mine, d.theirs, a);
  }
};

// Gomoku boards above 768 cells (edges 28 and up): the board stays in the
// leaf row (RowBoard). The step is GomokuFlatOps.step seen from the root's
// player: the mover's stone, +1 or -1 by the path's parity, overwrites the
// cell.
struct GomokuRowGame {
  static constexpr int kBoardCells = 0;
  using Board = RowBoard;
  static __device__ __forceinline__ void step(Board& d, int a, int lane) {
    if (lane == 0) d.out[a] = d.sign;
    d.sign = -d.sign;
  }
};

struct HexGame {
  static constexpr int kBoardCells = kHexCells;
  using Board = WordBoard<1>;
  static __device__ __forceinline__ void step(Board& d, int a, int) {
    hex_step(d.mine[0], d.theirs[0], a);
  }
};

// The end of one descent, by the calling warp: the leaf board (lanes
// strided over its cells) and the 8 meta floats (lanes 0-7) = (exp, term,
// psign, v_term, cut, exp_node, exp_action, dup).
template <class Board>
__device__ __forceinline__ void warp_store_leaf(float* bd, float* m, int L, int lane,
                                                const Board& board, float exp, float term,
                                                float psign, float v_term, float cut,
                                                float exp_node, float exp_action, float dup) {
  board_store(board, bd, L, lane);
  if (lane < 8) {
    m[lane] = lane == 0 ? exp
            : lane == 1 ? term
            : lane == 2 ? psign
            : lane == 3 ? v_term
            : lane == 4 ? cut
            : lane == 5 ? exp_node
            : lane == 6 ? exp_action
                        : dup;
  }
}

// One descent per game, one warp per game. The warp zeroes its game's
// patha/psgn row (coalesced), loads the root board (by ballots, or into the
// leaf row: the board's form), and then walks the path
// uniformly: every lane loads the same besta/bestc cell (one transaction)
// and applies its part of the game's step (a bitboard lane its own copy
// of the bitboards, so the step's branches, the Othello rays, never
// diverge). Lane 0 writes the path cells, after a __syncwarp that orders
// them behind the other lanes' zeros. The next node's loads are issued
// before the step, so the step's instructions overlap their trip.
template <class Game>
__global__ void __launch_bounds__(kDescendThreads)
    descend_kernel(const float* __restrict__ besta, const float* __restrict__ bestc,
                   const float* __restrict__ done, const float* __restrict__ tval,
                   const float* __restrict__ boards, float* __restrict__ bd,
                   float* __restrict__ patha, float* __restrict__ psgn,
                   float* __restrict__ meta, int B, int C, int max_depth, int cells) {
  const int L = Game::kBoardCells > 0 ? Game::kBoardCells : cells;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kDescendWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const size_t row = (size_t)b * C;
  // the root's cells travel with the board's
  bool act = done[row] < 0.5f;  // a terminal root is not descended
  float af = besta[row], code = bestc[row];
  typename Game::Board board;
  {
    typename Game::Board root;
    board_load(root, boards + (size_t)b * L, L, lane);
    board_begin(board, root, bd + (size_t)b * L, L, lane);
  }
  for (int c = lane; c < C; c += 32) {
    patha[row + c] = 0.f;
    psgn[row + c] = 0.f;
  }
  __syncwarp();  // every lane's zeros before lane 0's path cells

  int node = 0, depth = 0, leaf = -1;
  float psign = 1.f;
  float exp = 0.f, term = 0.f, cut = 0.f, exp_node = 0.f, exp_action = 0.f;
  while (act) {
    if (lane == 0) {
      patha[row + node] = af + 1.f;
      psgn[row + node] = psign;
    }
    const bool cterm = code < -1.5f;
    const bool unexp = !cterm && code < -0.5f;
    const float child = cterm ? -2.f - code : code;
    const bool live = !unexp && !cterm;
    const bool cutoff = live && depth + 1 >= max_depth;
    const bool go = live && !cutoff;
    float next_af = 0.f, next_code = 0.f;
    if (go) {
      next_af = besta[row + (int)child];
      next_code = bestc[row + (int)child];
    }
    Game::step(board, (int)af, lane);
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
    af = next_af;
    code = next_code;
    act = go;
  }

  const float v_term = leaf >= 0 ? tval[row + leaf] : 0.f;
  warp_store_leaf(bd + (size_t)b * L, meta + (size_t)b * 8, L, lane, board, exp, term,
                  psign, v_term, cut, exp_node, exp_action, 0.f);
}

// ---------------------------------------------------------------------------
// The dense merges (A > 8): one warp per game, one touched column at a time
// ---------------------------------------------------------------------------

constexpr int kMergeWarps = 4;              // games (warps) per block of a dense merge
constexpr int kMergeWarpThreads = 32 * kMergeWarps;
constexpr int kMaxDenseA = 32 * 24;         // the widest instance that keeps a column in registers
constexpr int kStream = 0;                  // the J of the streamed instances, for any A: ...
constexpr int kStreamJ = 16;                // ... chunks of 32 * kStreamJ actions (K=1 merge) ...
constexpr int kStreamSmallJ = 8;            // ... or 32 * 8 (the round merge, beside its k-ordered
                                            // sums; the seeds, which spill at 16)
constexpr float kNoEdge = -3.0e38f;         // a lane's empty slot: below every score, -1e30 too
constexpr float kNoAction = 1.0e9f;

// The visit sum of a column over the warp's lanes: the counts are integers
// below 2^24, so the butterfly's sum is exact, as any order's.
__device__ __forceinline__ float warp_visit_sum(float total) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total = __fadd_rn(total, __shfl_xor_sync(kFullMask, total, o));
  return total;
}

// Two floats of another lane in one 64-bit shuffle: (x, y) of lane
// `lane ^ o` (xor) or of lane `src`.
__device__ __forceinline__ unsigned long long pack2(float x, float y) {
  return (unsigned long long)__float_as_uint(x) << 32 | __float_as_uint(y);
}
__device__ __forceinline__ void unpack2(unsigned long long v, float& x, float& y) {
  x = __uint_as_float((unsigned)(v >> 32));
  y = __uint_as_float((unsigned)v);
}
__device__ __forceinline__ void shfl_xor2(float& x, float& y, int o) {
  unpack2(__shfl_xor_sync(kFullMask, pack2(x, y), o), x, y);
}
__device__ __forceinline__ void shfl2(float& x, float& y, int src) {
  unpack2(__shfl_sync(kFullMask, pack2(x, y), src), x, y);
}

// The first-max order of the edges: a higher score first, on equal scores
// the smaller action. The sequential scan with strict > keeps the first of
// this order, so a reduction in it, in any grouping, gives the scan's edge.
__device__ __forceinline__ bool precedes(float s1, float a1, float s2, float a2) {
  return s1 > s2 || (s1 == s2 && a1 < a2);
}

// The first edge of the warp's column in that order, from each lane's own
// first (score s, action a; kNoEdge where the lane holds no action), by a
// butterfly: every lane ends with the column's (s, a).
__device__ __forceinline__ void warp_first_max(float& s, float& a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float os = s, oa = a;
    shfl_xor2(os, oa, o);
    if (precedes(os, oa, s, a)) {
      s = os;
      a = oa;
    }
  }
}

// The first two edges of the warp's column in that order, from each lane's
// own two (t.best/best_a, t.second/sec_a), by a butterfly merging two
// ordered pairs at each level: every lane ends with the column's two. Codes
// are not carried; see warp_code.
__device__ __forceinline__ void warp_top2(Top2& t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float b = t.best, ba = t.best_a, s2 = t.second, sa = t.sec_a;
    shfl_xor2(b, ba, o);
    shfl_xor2(s2, sa, o);
    if (precedes(b, ba, t.best, t.best_a)) {   // the other pair's first leads
      if (precedes(t.best, t.best_a, s2, sa)) {
        t.second = t.best;
        t.sec_a = t.best_a;
      } else {
        t.second = s2;
        t.sec_a = sa;
      }
      t.best = b;
      t.best_a = ba;
    } else if (precedes(b, ba, t.second, t.sec_a)) {
      t.second = b;
      t.sec_a = ba;
    }
  }
}

// The child code of action `a` (the same on every lane), from the lane that
// holds it: lane a % 32, whose own first or second edge it is (`mine` is
// that lane's code of `a` when a is its first, else of its second).
__device__ __forceinline__ float warp_code(float mine, float a) {
  return __shfl_sync(kFullMask, mine, (int)a & 31);
}

// A lane's running top-2 of its own actions, pushed in increasing order with
// strict comparisons, from kNoEdge: its first two in the first-max order.
__device__ __forceinline__ void lane_top2_push(Top2& t, float a, float s, float code) {
  if (s > t.best) {
    t.second = t.best;
    t.sec_a = t.best_a;
    t.sec_code = t.best_code;
    t.best = s;
    t.best_a = a;
    t.best_code = code;
  } else if (s > t.second) {
    t.second = s;
    t.sec_a = a;
    t.sec_code = code;
  }
}

// What the K=1 merge does to one column: the fresh row at the lockstep slot,
// the path edge's backup, the parent -> child link.
struct ColumnEdits {
  bool install;
  int path_a;     // the path's edge here, or -1
  float path_v;   // mval * psgn
  int link_a;     // the expanded edge here, or -1
  float link_code;
};

// The merge of one column of game b and its refresh, by the calling warp:
// lane l owns actions l, l + 32, ...; the first J of them are loaded
// together (all in flight at once: one trip to memory, not J) and stay in
// registers between the write and the scan (A <= 32 J). The arithmetic is
// merge_kernel's, cell by cell.
template <int J>
__device__ __forceinline__ void merge_column_warp(float* n, float* w, float* p, float* code,
                                                  const float* pm_row, size_t base, int A, int C,
                                                  const ColumnEdits& e, float cpuct, int lane,
                                                  float* best_a, float* best_code) {
  // the column's cells as the merge leaves them: a fresh row at the
  // lockstep slot (no read), else the stored cells
  auto load = [&](int a, float& n_, float& w_, float& p_, float& c_) {
    const size_t off = base + (size_t)a * C;
    n_ = e.install ? 0.f : n[off];
    w_ = e.install ? 0.f : w[off];
    p_ = e.install ? pm_row[a] : p[off];
    c_ = e.install ? -1.f : code[off];
  };
  float total = 0.f;
  auto edit = [&](int a, float& n_, float& w_, float& p_, float& c_) {
    const size_t off = base + (size_t)a * C;
    if (e.install) {
      n[off] = n_;
      w[off] = w_;
      p[off] = p_;
      code[off] = c_;
    }
    if (a == e.path_a) {  // backup along the path
      n_ = __fadd_rn(n_, 1.f);
      w_ = __fadd_rn(w_, e.path_v);
      n[off] = n_;
      w[off] = w_;
    }
    if (a == e.link_a) {  // parent -> new child
      c_ = e.link_code;
      code[off] = c_;
    }
    total = __fadd_rn(total, n_);
  };
  float nv[J], wv[J], pv[J], cv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < A) load(lane + 32 * j, nv[j], wv[j], pv[j], cv[j]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < A) edit(lane + 32 * j, nv[j], wv[j], pv[j], cv[j]);
  }
  const float sq = __fsqrt_rn(__fadd_rn(warp_visit_sum(total), kPuctEps));
  float best = kNoEdge, ba = kNoAction, bc = 0.f;
  auto scan = [&](int a, float n_, float w_, float p_, float c_) {
    const float sc = puct_score(n_, w_, p_, sq, cpuct);
    if (sc > best) {
      best = sc;
      ba = (float)a;
      bc = c_;
    }
  };
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < A) scan(lane + 32 * j, nv[j], wv[j], pv[j], cv[j]);
  }
  warp_first_max(best, ba);
  const float c_best = warp_code(bc, ba);
  if (lane == 0) {
    *best_a = ba;
    *best_code = c_best;
  }
}

// merge_column_warp for any A (the instance J = kStream): the lanes walk the
// column in chunks of 32 * kStreamJ actions, in increasing order, so their
// registers do not grow with A. The visit sum comes first: the counts are
// integers, so the sum after the merge is the entry counts' (none at an
// install slot, which is written anew) plus the path edge's backup, exact
// in any order. Then each chunk is loaded together, merged and written as
// merge_column_warp does it, and scored: a lane keeps its first maximum
// over the chunks (strict >, its actions in increasing order), so an equal
// score in a later chunk never displaces an earlier action, and the warp
// reduces once, in the first-max order.
__device__ __forceinline__ void merge_column_stream(float* n, float* w, float* p, float* code,
                                                    const float* pm_row, size_t base, int A, int C,
                                                    const ColumnEdits& e, float cpuct, int lane,
                                                    float* best_a, float* best_code) {
  float total = 0.f;
  if (!e.install) {
    for (int a0 = 0; a0 < A; a0 += 32 * kStreamJ) {
      float nv[kStreamJ];
#pragma unroll
      for (int j = 0; j < kStreamJ; ++j) {
        const int a = a0 + 32 * j + lane;
        nv[j] = a < A ? n[base + (size_t)a * C] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kStreamJ; ++j) total = __fadd_rn(total, nv[j]);
    }
  }
  total = warp_visit_sum(total);
  if (e.path_a >= 0) total = __fadd_rn(total, 1.f);
  const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
  float best = kNoEdge, ba = kNoAction, bc = 0.f;
  for (int a0 = 0; a0 < A; a0 += 32 * kStreamJ) {
    float nv[kStreamJ], wv[kStreamJ], pv[kStreamJ], cv[kStreamJ];
#pragma unroll
    for (int j = 0; j < kStreamJ; ++j) {
      const int a = a0 + 32 * j + lane;
      if (a < A) {
        const size_t off = base + (size_t)a * C;
        nv[j] = e.install ? 0.f : n[off];
        wv[j] = e.install ? 0.f : w[off];
        pv[j] = e.install ? pm_row[a] : p[off];
        cv[j] = e.install ? -1.f : code[off];
      }
    }
#pragma unroll
    for (int j = 0; j < kStreamJ; ++j) {
      const int a = a0 + 32 * j + lane;
      if (a < A) {
        const size_t off = base + (size_t)a * C;
        if (e.install) {  // fresh row at the lockstep slot
          n[off] = nv[j];
          w[off] = wv[j];
          p[off] = pv[j];
          code[off] = cv[j];
        }
        if (a == e.path_a) {  // backup along the path
          nv[j] = __fadd_rn(nv[j], 1.f);
          wv[j] = __fadd_rn(wv[j], e.path_v);
          n[off] = nv[j];
          w[off] = wv[j];
        }
        if (a == e.link_a) {  // parent -> new child
          cv[j] = e.link_code;
          code[off] = cv[j];
        }
        const float sc = puct_score(nv[j], wv[j], pv[j], sq, cpuct);
        if (sc > best) {
          best = sc;
          ba = (float)a;
          bc = cv[j];
        }
      }
    }
  }
  warp_first_max(best, ba);
  const float c_best = warp_code(bc, ba);
  if (lane == 0) {
    *best_a = ba;
    *best_code = c_best;
  }
}

// The dense K=1 merge: one warp per game. The warp finds, 32 nodes at a
// time, the columns the merge writes (the path nodes, the install slot, the
// expanded parent) with a ballot and merges and refreshes each of them; no
// other column is read. Every other node's besta/bestc is left as it is:
// the precondition is that on entry they are the refresh of the entry
// planes (the search's seed refresh makes it so, every merge keeps it).
template <int J>
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
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kMergeWarps + (int)(threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const float* m2 = meta2 + (size_t)b * 8;
  const bool exp_ok = m2[1] > 0.5f;
  const int link_node = exp_ok ? (int)m2[5] : -1;
  const int install_node = exp_ok ? slot : -1;
  const size_t row = (size_t)b * C;
  if (lane == 0 && install_node >= 0 && install_node < C) {
    done[row + install_node] = m2[3];
    tval[row + install_node] = m2[4];
  }
  const float mval = m2[0], link_code = m2[2];
  const int link_a = (int)m2[6];
  // the path record 32 nodes at a time, the next chunk's loads in flight
  // while this chunk's columns are merged
  float next_pa = lane < C ? patha[row + lane] : 0.f;
  float next_ps = lane < C ? psgn[row + lane] : 0.f;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const float on_path = next_pa, sign = next_ps;  // action+1 (0 off the path), its sign
    next_pa = c + 32 < C ? patha[row + c + 32] : 0.f;
    next_ps = c + 32 < C ? psgn[row + c + 32] : 0.f;
    unsigned touched = __ballot_sync(
        kFullMask, c < C && (on_path > 0.5f || c == install_node || c == link_node));
    while (touched) {
      const int j = __ffs(touched) - 1;
      touched &= touched - 1;
      const int col = c0 + j;
      float pa = on_path, sg = sign;
      shfl2(pa, sg, j);
      ColumnEdits e;
      e.install = col == install_node;
      e.path_a = pa > 0.5f ? (int)pa - 1 : -1;
      e.path_v = __fmul_rn(mval, sg);
      e.link_a = col == link_node ? link_a : -1;
      e.link_code = link_code;
      if constexpr (J == kStream) {
        merge_column_stream(n, w, p, code, pm + (size_t)b * A, (size_t)b * A * C + col, A, C, e,
                            cpuct, lane, besta + row + col, bestc + row + col);
      } else {
        merge_column_warp<J>(n, w, p, code, pm + (size_t)b * A, (size_t)b * A * C + col, A, C, e,
                             cpuct, lane, besta + row + col, bestc + row + col);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The A <= 8 merges: one warp per game, one lane per touched column
// ---------------------------------------------------------------------------

constexpr int kScanChunks = 4;  // chunks of 32 nodes whose loads a merge's scan issues together

// The columns of one game that a merge touches, gathered by the game's warp
// in node order, 32 nodes a ballot: `load(c)` reads what the merge's test
// of node c needs (lane c % 32), for kScanChunks chunks at once (C <= 128,
// the main path's 101, in one trip to memory), then `visit(c, loaded)`
// says whether the merge writes the node's column; lane l of the warp then
// runs `merge(col)` on the l-th touched column, all of them at once, their
// loads in flight together. `cols` is the warp's list in shared memory;
// when it would overflow (more than 32 touched columns: long paths, or a
// round's K), the columns gathered so far are merged first.
template <class Load, class Visit, class Merge>
__device__ __forceinline__ void merge_touched_columns(int C, int lane, int* cols, Load load,
                                                      Visit visit, Merge merge) {
  int count = 0;
  auto flush = [&] {
    __syncwarp();  // the list is written
    if (lane < count) merge(cols[lane]);
    __syncwarp();  // every lane has read its column before the list is refilled
    count = 0;
  };
  for (int c0 = 0; c0 < C; c0 += 32 * kScanChunks) {
    decltype(load(0)) loaded[kScanChunks] = {};
#pragma unroll
    for (int j = 0; j < kScanChunks; ++j) {
      if (c0 + 32 * j + lane < C) loaded[j] = load(c0 + 32 * j + lane);
    }
#pragma unroll
    for (int j = 0; j < kScanChunks; ++j) {
      const int c = c0 + 32 * j + lane;
      const bool touched = c < C && visit(c, loaded[j]);
      const unsigned mask = __ballot_sync(kFullMask, touched);
      if (count + __popc(mask) > 32) flush();
      if (touched) cols[count + __popc(mask & ((1u << lane) - 1u))] = c;
      count += __popc(mask);
    }
  }
  flush();
}

// The A <= 8 K=1 merge: one warp per game. The warp finds the columns the
// merge writes (the path nodes, the install slot, the expanded parent) and
// lane l merges and refreshes the l-th of them alone: its A cells of the
// four planes loaded together (28 loads in flight at A=7; none at the
// install slot, which is written anew from its prior row), the install,
// the backup and the link applied in that order with the reference's
// round-to-nearest operations, the first-max argmax (refresh_node) from
// registers. No other column is read, and every other node's besta/bestc
// is left as it is: the precondition is that on entry they are the
// refresh of the entry planes (the search's seed refresh makes it so, every
// merge keeps it).
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
  __shared__ int block_cols[kMergeWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = (int)(threadIdx.x >> 5);
  const int b = blockIdx.x * kMergeWarps + warp;
  if (b >= B) return;  // the whole warp
  const float* m2 = meta2 + (size_t)b * 8;
  const bool exp_ok = m2[1] > 0.5f;
  const int link_node = exp_ok ? (int)m2[5] : -1;
  const int install_node = exp_ok ? slot : -1;
  const size_t row = (size_t)b * C;
  if (lane == 0 && install_node >= 0 && install_node < C) {
    done[row + install_node] = m2[3];
    tval[row + install_node] = m2[4];
  }
  const float mval = m2[0], link_code = m2[2];
  const int link_a = (int)m2[6];
  const float* pm_row = pm + (size_t)b * A;
  auto load = [&](int c) { return patha[row + c]; };  // action+1, or 0 off the path
  auto visit = [&](int c, float on_path) {
    return on_path > 0.5f || c == install_node || c == link_node;
  };
  auto merge = [&](int col) {
    const float pa = patha[row + col];  // action+1, or 0 off the path
    const int path_a = pa > 0.5f ? (int)pa - 1 : -1;
    const float path_v = __fmul_rn(mval, psgn[row + col]);
    const bool install = col == install_node;
    const int col_link_a = col == link_node ? link_a : -1;
    const size_t base = (size_t)b * A * C + col;
    float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      const size_t off = base + (size_t)a * C;
      const bool live = a < A;
      nv[a] = live && !install ? n[off] : 0.f;
      wv[a] = live && !install ? w[off] : 0.f;
      pv[a] = live ? (install ? pm_row[a] : p[off]) : 0.f;
      cv[a] = live && !install ? code[off] : (live ? -1.f : 0.f);
    }
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      if (a < A) {
        const size_t off = base + (size_t)a * C;
        if (install) {  // fresh row at the lockstep slot
          n[off] = nv[a];
          w[off] = wv[a];
          p[off] = pv[a];
          code[off] = cv[a];
        }
        if (a == path_a) {  // backup along the path
          nv[a] = __fadd_rn(nv[a], 1.f);
          wv[a] = __fadd_rn(wv[a], path_v);
          n[off] = nv[a];
          w[off] = wv[a];
        }
        if (a == col_link_a) {  // parent -> new child
          cv[a] = link_code;
          code[off] = cv[a];
        }
      }
    }
    refresh_node(nv, wv, pv, cv, A, cpuct, besta + row + col, bestc + row + col);
  };
  merge_touched_columns(C, lane, block_cols[warp], load, visit, merge);
}

// ---------------------------------------------------------------------------
// K>1 leaf-parallel rounds (descend_round_kernel, merge_round_kernel and
// _refresh2 of alphazero_tpu/mcts/hybrid.py)
// ---------------------------------------------------------------------------

// One round's K descents per game, one warp per game, each descent walked
// as descend_kernel walks its one. The warp loads the root board once and
// starts each descent from it (a register copy; a RowBoard copies the
// root's row into the descent's leaf row); the root's four best cells are
// loaded once too. Every node's in-round counters (how often this round
// took its best action there, and its runner-up) are the warp's own
// `taken_best` [2][C], zeroed by the warp: every lane reads them, then,
// after a __syncwarp, lane 0 alone adds this descent's take; a descent
// never meets a node twice, and a __syncwarp ends each descent, so every
// read sees the takes of the descents before it. Outputs are K-major:
// bd[k, b, :], patha/psgn[k, b, :], meta[k, b, :] = (exp, term, psign,
// v_term, cut, exp_node, exp_action, dup).
template <class Game, class Count>
__device__ __forceinline__ void descend_round_walk(
    const float* __restrict__ besta, const float* __restrict__ bestc,
    const float* __restrict__ seca, const float* __restrict__ secc,
    const float* __restrict__ done, const float* __restrict__ tval,
    const float* __restrict__ boards, float* __restrict__ bd, float* __restrict__ patha,
    float* __restrict__ psgn, float* __restrict__ meta, int B, int C, int K, int max_depth,
    int cells, int b, int lane, Count* taken_best) {
  const int L = Game::kBoardCells > 0 ? Game::kBoardCells : cells;
  Count* taken_second = taken_best + C;   // [C] each
  const size_t row = (size_t)b * C;
  const bool root_live = done[row] < 0.5f;  // a terminal root is not descended
  const float root_ba = besta[row], root_bc = bestc[row];
  const float root_sa = seca[row], root_sc = secc[row];
  typename Game::Board root;
  board_load(root, boards + (size_t)b * L, L, lane);
  // zero the counters and the game's rows of the K path records
  for (int i = lane; i < 2 * C; i += 32) taken_best[i] = 0;
  for (int k = 0; k < K; ++k) {
    const size_t prow = ((size_t)k * B + b) * C;
    for (int c = lane; c < C; c += 32) {
      patha[prow + c] = 0.f;
      psgn[prow + c] = 0.f;
    }
  }
  __syncwarp();  // every lane's zeros before the counters are read and the path written

  for (int k = 0; k < K; ++k) {
    float* leaf_row = bd + ((size_t)k * B + b) * L;
    typename Game::Board board;
    board_begin(board, root, leaf_row, L, lane);
    const size_t prow = ((size_t)k * B + b) * C;
    int node = 0, depth = 0, leaf = -1;
    float psign = 1.f;
    float exp = 0.f, term = 0.f, cut = 0.f, dup = 0.f, exp_node = 0.f, exp_action = 0.f;
    float ba = root_ba, bc = root_bc, sa = root_sa, sc = root_sc;
    bool act = root_live;
    while (act) {
      // the runner-up when there is one and this round took it less often
      // than the best action here
      const Count n_best = taken_best[node];
      const Count n_second = taken_second[node];
      const bool use2 = sa > -0.5f && n_second < n_best;
      const float af = use2 ? sa : ba;
      const float code = use2 ? sc : bc;
      const bool again = (use2 ? n_second : n_best) > 0;  // read before this descent's take
      __syncwarp();  // every lane has read the counters before lane 0 takes
      if (lane == 0) {
        if (use2) {
          taken_second[node] = n_second + 1;
        } else {
          taken_best[node] = n_best + 1;
        }
        patha[prow + node] = af + 1.f;
        psgn[prow + node] = psign;
      }

      const bool cterm = code < -1.5f;
      const bool unexp = !cterm && code < -0.5f;
      const float child = cterm ? -2.f - code : code;
      const bool live = !unexp && !cterm;
      const bool cutoff = live && depth + 1 >= max_depth;
      const bool go = live && !cutoff;
      if (go) {
        const size_t at = row + (int)child;
        ba = besta[at];
        bc = bestc[at];
        sa = seca[at];
        sc = secc[at];
      }
      Game::step(board, (int)af, lane);
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
    __syncwarp();  // this descent's takes before the next descent's reads

    const float v_term = leaf >= 0 ? tval[row + leaf] : 0.f;
    warp_store_leaf(leaf_row, meta + ((size_t)k * B + b) * 8, L, lane, board, exp, term, psign,
                    v_term, cut, exp_node, exp_action, dup);
  }
}

// The round descend of K <= 255 descents and C <= kMaxByteNodes nodes: the
// counters are bytes in the warp's slice of the block's dynamic shared
// memory, [2][C] a warp (above 48 KB the launch opts in).
template <class Game>
__global__ void __launch_bounds__(kDescendThreads)
    descend_round_kernel(const float* __restrict__ besta, const float* __restrict__ bestc,
                         const float* __restrict__ seca, const float* __restrict__ secc,
                         const float* __restrict__ done, const float* __restrict__ tval,
                         const float* __restrict__ boards, float* __restrict__ bd,
                         float* __restrict__ patha, float* __restrict__ psgn,
                         float* __restrict__ meta, int B, int C, int K, int max_depth,
                         int cells) {
  extern __shared__ unsigned char round_counts[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kDescendWarps + warp;
  if (b >= B) return;  // the whole warp
  descend_round_walk<Game>(besta, bestc, seca, secc, done, tval, boards, bd, patha, psgn, meta, B,
                           C, K, max_depth, cells, b, lane, round_counts + (size_t)warp * 2 * C);
}

// The round descend of any K and C: 32-bit counters in `scratch` [B][2][C]
// in global memory, the game's rows zeroed by its warp as the byte
// kernel's shared ones are.
template <class Game>
__global__ void __launch_bounds__(kDescendThreads)
    descend_round_wide_kernel(const float* __restrict__ besta, const float* __restrict__ bestc,
                              const float* __restrict__ seca, const float* __restrict__ secc,
                              const float* __restrict__ done, const float* __restrict__ tval,
                              const float* __restrict__ boards, float* __restrict__ bd,
                              float* __restrict__ patha, float* __restrict__ psgn,
                              float* __restrict__ meta, unsigned* __restrict__ scratch, int B,
                              int C, int K, int max_depth, int cells) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kDescendWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  descend_round_walk<Game>(besta, bestc, seca, secc, done, tval, boards, bd, patha, psgn, meta, B,
                           C, K, max_depth, cells, b, lane, scratch + (size_t)b * 2 * C);
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

__device__ __forceinline__ void store_if_changed(float* at, float old, float v) {
  if (__float_as_uint(old) != __float_as_uint(v)) *at = v;
}

// What descent k of a round does to the column of node c of game b: the
// JAX merge_round_kernel's per-descent terms, of which only these are not
// zero.
struct RoundTerm {
  float nm;       // installed here: inst_k * [c == slot0 + k]
  int path_a;     // the edge its path took at this node, or -1 ...
  float path_v;   // ... and what it backs up there, mval * psgn
  int link_a;     // the edge of this node it expanded, or -1 ...
  float link_v;   // ... and (link_code + 1) * inst_k
};

// meta2_b: game b's record of descent 0, descent k's at meta2_b + k * kstride.
__device__ __forceinline__ RoundTerm round_term(const float* patha, const float* psgn,
                                                const float* meta2_b, size_t kstride, int b,
                                                int c, int k, int B, int C, int slot0) {
  const float* m2 = meta2_b + k * kstride;
  const float inst = m2[1];  // exp * (1 - dup) * (slot < C)
  const size_t kidx = ((size_t)k * B + b) * C + c;
  const float pa = patha[kidx];  // action+1, or 0 off the path
  RoundTerm t;
  t.nm = __fmul_rn(inst, c == slot0 + k ? 1.f : 0.f);
  t.path_a = pa > 0.5f ? (int)pa - 1 : -1;
  t.path_v = __fmul_rn(m2[0], __fmul_rn(psgn[kidx], 1.f));
  t.link_a = inst != 0.f && (int)m2[5] == c ? (int)m2[6] : -1;  // parent -> new child
  t.link_v = __fmul_rn(__fadd_rn(m2[2], 1.f), inst);
  return t;
}

// The done/tval cells of node c of game b, from their entry values:
// done = done * (1 - sum_k installed_k) + sum_k installed_k * cdone_k.
__device__ __forceinline__ void round_node_update(float* done, float* tval, float old_done,
                                                  float old_tval, const float* meta2_b,
                                                  size_t kstride, int b, int c, int C, int K,
                                                  int slot0) {
  float nm_all = 0.f, dn = 0.f, dt = 0.f;
  for (int k = 0; k < K; ++k) {
    const float* m2 = meta2_b + k * kstride;
    const float nm = __fmul_rn(m2[1], c == slot0 + k ? 1.f : 0.f);
    dn = __fadd_rn(dn, __fmul_rn(nm, m2[3]));
    dt = __fadd_rn(dt, __fmul_rn(nm, m2[4]));
    nm_all = __fadd_rn(nm_all, nm);
  }
  const size_t idx = (size_t)b * C + c;
  const float not_new = __fsub_rn(1.f, nm_all);
  store_if_changed(done + idx, old_done, __fadd_rn(__fmul_rn(old_done, not_new), dn));
  store_if_changed(tval + idx, old_tval, __fadd_rn(__fmul_rn(old_tval, not_new), dt));
}

__device__ __forceinline__ void round_node_cells(float* done, float* tval, const float* meta2_b,
                                                 size_t kstride, int b, int c, int C, int K,
                                                 int slot0) {
  const size_t idx = (size_t)b * C + c;
  round_node_update(done, tval, done[idx], tval[idx], meta2_b, kstride, b, c, C, K, slot0);
}

// What the round merge's scan reads of a node: its done/tval cells, and 1
// where any descent's path passes through it: an integer OR of each
// descent's bit (with a bool, which the compiler may settle at the first
// hit, the K = 256 merge ran 1.4x slower on an H100).
struct RoundNodeScan {
  float done, tval;
  unsigned on_path;
};

// keep = prod_k (1 - installed_k), 0 where a descent installs at this node,
// and that descent (or -1).
__device__ __forceinline__ float round_keep(const RoundTerm* terms, int K, int& inst) {
  float keep = 1.f;
  inst = -1;
  for (int k = 0; k < K; ++k) {
    keep = __fmul_rn(keep, __fsub_rn(1.f, terms[k].nm));
    if (terms[k].nm != 0.f) inst = k;
  }
  return keep;
}

// One cell (action a) of the column: x * keep + (the terms' sum in k order);
// pm_a is the installing descent's prior of a (unread without one).
__device__ __forceinline__ void round_cell(const RoundTerm* terms, int K, float keep, bool inst,
                                           float pm_a, int a, float& n, float& w, float& p,
                                           float& code) {
  float n_add = 0.f, w_add = 0.f;
  float code_delta = inst ? -1.f : 0.f;
  for (int k = 0; k < K; ++k) {
    if (terms[k].path_a == a) {
      n_add = __fadd_rn(n_add, 1.f);
      w_add = __fadd_rn(w_add, terms[k].path_v);
    }
  }
  for (int k = 0; k < K; ++k) {
    if (terms[k].link_a == a) code_delta = __fadd_rn(code_delta, terms[k].link_v);
  }
  const float p_inst = inst ? __fadd_rn(0.f, pm_a) : 0.f;
  n = __fadd_rn(__fmul_rn(n, keep), n_add);
  w = __fadd_rn(__fmul_rn(w, keep), w_add);
  p = __fadd_rn(__fmul_rn(p, keep), p_inst);
  code = __fadd_rn(__fmul_rn(code, keep), code_delta);
}

// The A <= 8 round merge: one warp per game. The warp stages the game's K
// meta2 records in shared memory, merges every node's done/tval cells (two
// coalesced rows: the reference rewrites them all) and finds the columns
// the K records write (the path nodes of every descent, the install slots,
// the expanded parents); lane l then merges the l-th of them alone and
// refreshes its top-2 from registers (top2_push in action order, as the
// unrolled _refresh2): the K descents' additions to each cell are summed
// in k order first (n_add, w_add, code_delta, a register per action, read
// from the staged records and the column's path cells: no per-thread array
// of the K terms), then applied once as x * keep + add, storing only the
// cells whose bits change. An install column (keep = 0 there) is not read:
// x * 0 + add is +0 + add for the finite x of a search's planes, since add
// is never -0. No other column is read, and every other node's top-2
// planes are left as they are: the precondition is that on entry they are
// the refresh2 of the entry planes (the search's seed refresh makes it so,
// every merge keeps it). kWide (K > kMaxRoundK): the records are read where
// they lie in meta2 (every lane the same address: one broadcast
// transaction) instead of being staged.
template <bool kWide>
__global__ void merge_round_kernel(float* __restrict__ n, float* __restrict__ w,
                                   float* __restrict__ p, float* __restrict__ code,
                                   float* __restrict__ done, float* __restrict__ tval,
                                   const float* __restrict__ pm, const float* __restrict__ patha,
                                   const float* __restrict__ psgn,
                                   const float* __restrict__ meta2, float* __restrict__ besta,
                                   float* __restrict__ bestc, float* __restrict__ seca,
                                   float* __restrict__ secc, int B, int A, int C, int K,
                                   int slot0, float cpuct) {
  __shared__ float block_meta2[kMergeWarps][kWide ? 1 : kMaxRoundK * 8];
  __shared__ int block_cols[kMergeWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = (int)(threadIdx.x >> 5);
  const int b = blockIdx.x * kMergeWarps + warp;
  if (b >= B) return;  // the whole warp
  // the game's K meta2 records, descent k's at m2s + k * mstride
  const float* m2s = meta2 + (size_t)b * 8;
  const std::conditional_t<kWide, size_t, int> mstride = kWide ? (size_t)B * 8 : 8;
  if constexpr (!kWide) {
    float* staged = block_meta2[warp];
    for (int i = lane; i < K * 8; i += 32) {
      staged[i] = meta2[((size_t)(i / 8) * B + b) * 8 + i % 8];
    }
    __syncwarp();
    m2s = staged;
  }
  const size_t row = (size_t)b * C;
  const size_t kstride = (size_t)B * C;  // descent k's path record at + k * kstride
  auto load = [&](int c) {
    RoundNodeScan v{done[row + c], tval[row + c], 0u};
#pragma unroll 4
    for (int k = 0; k < K; ++k) v.on_path |= patha[k * kstride + row + c] > 0.5f ? 1u : 0u;
    return v;
  };
  auto visit = [&](int c, const RoundNodeScan& v) {
    round_node_update(done, tval, v.done, v.tval, m2s, mstride, b, c, C, K, slot0);
    bool writes = v.on_path != 0u;
    for (int k = 0; k < K; ++k) {
      const float* m2 = m2s + k * mstride;
      writes |= m2[1] != 0.f & (c == slot0 + k | (int)m2[5] == c);
    }
    return writes;
  };
  auto merge = [&](int col) {
    // keep = prod_k (1 - installed_k) and the installing descent (or -1)
    float keep = 1.f;
    int inst = -1;
    for (int k = 0; k < K; ++k) {
      const float nm = __fmul_rn(m2s[k * mstride + 1], col == slot0 + k ? 1.f : 0.f);
      keep = __fmul_rn(keep, __fsub_rn(1.f, nm));
      if (nm != 0.f) inst = k;
    }
    float n_add[kMaxA], w_add[kMaxA], code_delta[kMaxA];
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      n_add[a] = 0.f;
      w_add[a] = 0.f;
      code_delta[a] = inst >= 0 ? -1.f : 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {  // descent k's terms at this column (round_term)
      const float* m2 = m2s + k * mstride;
      const size_t kidx = k * kstride + row + col;
      const float pa = patha[kidx];  // action+1, or 0 off the path
      const int path_a = pa > 0.5f ? (int)pa - 1 : -1;
      const float path_v = __fmul_rn(m2[0], __fmul_rn(psgn[kidx], 1.f));
      const float inst_k = m2[1];
      const int link_a = inst_k != 0.f && (int)m2[5] == col ? (int)m2[6] : -1;
      const float link_v = __fmul_rn(__fadd_rn(m2[2], 1.f), inst_k);
#pragma unroll
      for (int a = 0; a < kMaxA; ++a) {
        if (a == path_a) {
          n_add[a] = __fadd_rn(n_add[a], 1.f);
          w_add[a] = __fadd_rn(w_add[a], path_v);
        }
        if (a == link_a) code_delta[a] = __fadd_rn(code_delta[a], link_v);
      }
    }
    const float* pm_row = pm + ((size_t)(inst >= 0 ? inst : 0) * B + b) * A;
    const bool read = keep != 0.f;  // not an install column
    const size_t base = (size_t)b * A * C + col;
    float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
    float total = 0.f;
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      if (a < A) {
        const size_t off = base + (size_t)a * C;
        const float n0 = read ? n[off] : 0.f, w0 = read ? w[off] : 0.f;
        const float p0 = read ? p[off] : 0.f, c0 = read ? code[off] : 0.f;
        const float p_inst = inst >= 0 ? __fadd_rn(0.f, pm_row[a]) : 0.f;
        nv[a] = __fadd_rn(__fmul_rn(n0, keep), n_add[a]);
        wv[a] = __fadd_rn(__fmul_rn(w0, keep), w_add[a]);
        pv[a] = __fadd_rn(__fmul_rn(p0, keep), p_inst);
        cv[a] = __fadd_rn(__fmul_rn(c0, keep), code_delta[a]);
        if (read) {
          store_if_changed(n + off, n0, nv[a]);
          store_if_changed(w + off, w0, wv[a]);
          store_if_changed(p + off, p0, pv[a]);
          store_if_changed(code + off, c0, cv[a]);
        } else {
          n[off] = nv[a];
          w[off] = wv[a];
          p[off] = pv[a];
          code[off] = cv[a];
        }
        total = __fadd_rn(total, nv[a]);  // integers: exact in any order
      } else {
        nv[a] = wv[a] = pv[a] = cv[a] = 0.f;
      }
    }
    const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
    Top2 t{};
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      if (a < A) top2_push(t, a, puct_score(nv[a], wv[a], pv[a], sq, cpuct), cv[a]);
    }
    top2_store(t, false, row + col, besta, bestc, seca, secc);
  };
  merge_touched_columns(C, lane, block_cols[warp], load, visit, merge);
}

// The merge of one touched column of game b and its top-2 refresh, by the
// calling warp, from the round's terms at this column (`terms`, shared by
// the warp): lane l owns actions l, l + 32, ...; the first J of them are
// loaded together (one trip to memory) and stay in registers between the
// write and the scan (A <= 32 J). The arithmetic
// is merge_round_kernel's, cell by cell; the top-2 is each lane's own two,
// pushed in action order, then the warp's.
template <int J>
__device__ __forceinline__ void merge_round_column_warp(float* n, float* w, float* p, float* code,
                                                        const float* pm_row,
                                                        const RoundTerm* terms, int K, float keep,
                                                        bool inst, size_t base, int A, int C,
                                                        float cpuct, int lane, Top2& t) {
  auto load = [&](int a, float& n_, float& w_, float& p_, float& c_, float& pm_) {
    const size_t off = base + (size_t)a * C;
    n_ = n[off];
    w_ = w[off];
    p_ = p[off];
    c_ = code[off];
    pm_ = inst ? pm_row[a] : 0.f;
  };
  float total = 0.f;
  auto edit = [&](int a, float& n_, float& w_, float& p_, float& c_, float pm_) {
    const size_t off = base + (size_t)a * C;
    const float n0 = n_, w0 = w_, p0 = p_, c0 = c_;
    round_cell(terms, K, keep, inst, pm_, a, n_, w_, p_, c_);
    store_if_changed(n + off, n0, n_);
    store_if_changed(w + off, w0, w_);
    store_if_changed(p + off, p0, p_);
    store_if_changed(code + off, c0, c_);
    total = __fadd_rn(total, n_);
  };
  float nv[J], wv[J], pv[J], cv[J], pmv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < A) load(lane + 32 * j, nv[j], wv[j], pv[j], cv[j], pmv[j]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (lane + 32 * j < A) edit(lane + 32 * j, nv[j], wv[j], pv[j], cv[j], pmv[j]);
  }
  const float sq = __fsqrt_rn(__fadd_rn(warp_visit_sum(total), kPuctEps));
  t = Top2{kNoEdge, kNoEdge, kNoAction, 0.f, kNoAction, 0.f};
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = lane + 32 * j;
    if (a < A) lane_top2_push(t, (float)a, puct_score(nv[j], wv[j], pv[j], sq, cpuct), cv[j]);
  }
  const Top2 own = t;
  warp_top2(t);
  t.best_code = warp_code(own.best_a == t.best_a ? own.best_code : own.sec_code, t.best_a);
  t.sec_code = warp_code(own.best_a == t.sec_a ? own.best_code : own.sec_code, t.sec_a);
}

// The dense round merge for any A and K (the instance J = kStream): as
// merge_round_dense_kernel, with neither the column nor the round held
// whole. The K records are read where they lie in meta2 (every lane the
// same address: one broadcast transaction); a column's terms are staged
// kMaxRoundK descents at a time in the warp's shared RoundTerms, and the
// lanes walk the column's actions in chunks of 32 * kStreamSmallJ, in
// increasing order. The visit sum comes first: the counts are integers and
// keep is 0 or 1, so the sum after the merge is the entry counts' (none
// where a descent installs, keep = 0) plus one for each descent whose path
// passes here, exact in any order. Then each chunk sums the K descents'
// terms of each of its cells in k order, chunk of records after chunk (the
// keep product and the installing descent run in k order too, as
// round_keep), rewrites the cells as x * keep + that sum, storing only the
// cells whose bits change, and pushes their scores into the lane's own
// top-2 (strict >, in increasing action order, so an equal score in a later
// chunk never displaces an earlier action); the warp reduces once a column.
__device__ __forceinline__ void merge_round_dense_stream(
    float* __restrict__ n, float* __restrict__ w, float* __restrict__ p, float* __restrict__ code,
    float* __restrict__ done, float* __restrict__ tval, const float* __restrict__ pm,
    const float* __restrict__ patha, const float* __restrict__ psgn,
    const float* __restrict__ meta2, float* __restrict__ besta, float* __restrict__ bestc,
    float* __restrict__ seca, float* __restrict__ secc, int B, int A, int C, int K, int slot0,
    float cpuct) {
  constexpr int J = kStreamSmallJ;
  __shared__ RoundTerm block_terms[kMergeWarps][kMaxRoundK];
  const int lane = threadIdx.x & 31;
  const int warp = (int)(threadIdx.x >> 5);
  const int b = blockIdx.x * kMergeWarps + warp;
  if (b >= B) return;  // the whole warp
  RoundTerm* terms = block_terms[warp];
  const float* m2b = meta2 + (size_t)b * 8;   // descent k's record at m2b + k * mstride
  const size_t mstride = (size_t)B * 8;
  const size_t kstride = (size_t)B * C;       // descent k's path record at + k * kstride
  const size_t row = (size_t)b * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    bool writes = false;
    if (c < C) {
      round_node_cells(done, tval, m2b, mstride, b, c, C, K, slot0);
      for (int k = 0; k < K; ++k) {
        const float* m2 = m2b + k * mstride;
        const bool on_path = patha[k * kstride + row + c] > 0.5f;
        writes |= on_path | (m2[1] != 0.f & (c == slot0 + k | (int)m2[5] == c));
      }
    }
    unsigned touched = __ballot_sync(kFullMask, writes);
    while (touched) {
      const int col = c0 + __ffs(touched) - 1;
      touched &= touched - 1;
      float keep = 1.f;
      int inst = -1;
      for (int k = 0; k < K; ++k) {
        const float nm = __fmul_rn(m2b[k * mstride + 1], col == slot0 + k ? 1.f : 0.f);
        keep = __fmul_rn(keep, __fsub_rn(1.f, nm));
        if (nm != 0.f) inst = k;
      }
      float paths = 0.f;  // the descents whose path passes here
      for (int k = lane; k < K; k += 32) {
        if (patha[k * kstride + row + col] > 0.5f) paths = __fadd_rn(paths, 1.f);
      }
      const size_t base = (size_t)b * A * C + col;
      float total = 0.f;
      if (keep != 0.f) {
        for (int a0 = 0; a0 < A; a0 += 32 * kStreamJ) {
          float nv[kStreamJ];
#pragma unroll
          for (int j = 0; j < kStreamJ; ++j) {
            const int a = a0 + 32 * j + lane;
            nv[j] = a < A ? n[base + (size_t)a * C] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kStreamJ; ++j) total = __fadd_rn(total, nv[j]);
        }
      }
      total = __fadd_rn(warp_visit_sum(total), warp_visit_sum(paths));
      const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
      const float* pm_row = pm + ((size_t)(inst >= 0 ? inst : 0) * B + b) * A;
      Top2 t{kNoEdge, kNoEdge, kNoAction, 0.f, kNoAction, 0.f};
      for (int a0 = 0; a0 < A; a0 += 32 * J) {
        float n_add[J], w_add[J], code_delta[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          n_add[j] = 0.f;
          w_add[j] = 0.f;
          code_delta[j] = inst >= 0 ? -1.f : 0.f;
        }
        for (int k0 = 0; k0 < K; k0 += kMaxRoundK) {
          const int kn = min(kMaxRoundK, K - k0);
          if (lane < kn) {
            terms[lane] = round_term(patha, psgn, m2b, mstride, b, col, k0 + lane, B, C, slot0);
          }
          __syncwarp();
          for (int i = 0; i < kn; ++i) {
            const RoundTerm tk = terms[i];
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const int a = a0 + 32 * j + lane;
              if (tk.path_a == a) {
                n_add[j] = __fadd_rn(n_add[j], 1.f);
                w_add[j] = __fadd_rn(w_add[j], tk.path_v);
              }
              if (tk.link_a == a) code_delta[j] = __fadd_rn(code_delta[j], tk.link_v);
            }
          }
          __syncwarp();  // every lane has read the terms before the next chunk's
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int a = a0 + 32 * j + lane;
          if (a < A) {
            const size_t off = base + (size_t)a * C;
            const float n0 = n[off], w0 = w[off], p0 = p[off], c0_ = code[off];
            const float p_inst = inst >= 0 ? __fadd_rn(0.f, pm_row[a]) : 0.f;
            const float nn = __fadd_rn(__fmul_rn(n0, keep), n_add[j]);
            const float wn = __fadd_rn(__fmul_rn(w0, keep), w_add[j]);
            const float pn = __fadd_rn(__fmul_rn(p0, keep), p_inst);
            const float cn = __fadd_rn(__fmul_rn(c0_, keep), code_delta[j]);
            store_if_changed(n + off, n0, nn);
            store_if_changed(w + off, w0, wn);
            store_if_changed(p + off, p0, pn);
            store_if_changed(code + off, c0_, cn);
            lane_top2_push(t, (float)a, puct_score(nn, wn, pn, sq, cpuct), cn);
          }
        }
      }
      const Top2 own = t;
      warp_top2(t);
      t.best_code = warp_code(own.best_a == t.best_a ? own.best_code : own.sec_code, t.best_a);
      t.sec_code = warp_code(own.best_a == t.sec_a ? own.best_code : own.sec_code, t.sec_a);
      if (lane == 0) top2_store(t, true, row + col, besta, bestc, seca, secc);
    }
  }
}

// The dense round merge: one warp per game. The warp walks its game's nodes
// 32 at a time: it merges every node's done/tval cells (two coalesced rows)
// and finds with a ballot the columns the K records write (the path nodes
// of every descent, the install slots, the expanded parents); for each of
// them lanes 0..K-1 gather the K descents' terms into shared memory, then
// the warp merges and refreshes the column. No other stat column is read,
// and every other node's top-2 planes are left as they are: the
// precondition is that on entry they are the refresh2 of the entry planes
// (the search's seed refresh makes it so, every merge keeps it). J =
// kStream: merge_round_dense_stream, for any A and K.
template <int J>
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
  if constexpr (J == kStream) {
    merge_round_dense_stream(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc, seca,
                             secc, B, A, C, K, slot0, cpuct);
  } else {
    __shared__ RoundTerm block_terms[kMergeWarps][kMaxRoundK];
    __shared__ float block_meta2[kMergeWarps][kMaxRoundK * 8];
    const int lane = threadIdx.x & 31;
    const int warp = (int)(threadIdx.x >> 5);
    const int b = blockIdx.x * kMergeWarps + warp;
    if (b >= B) return;  // the whole warp
    RoundTerm* terms = block_terms[warp];
    // the game's K meta2 records, read by every lane at every node: staged
    // once in shared memory
    float* m2s = block_meta2[warp];
    for (int i = lane; i < K * 8; i += 32) m2s[i] = meta2[((size_t)(i / 8) * B + b) * 8 + i % 8];
    __syncwarp();
    const size_t row = (size_t)b * C;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      bool writes = false;
      if (c < C) {
        round_node_cells(done, tval, m2s, 8, b, c, C, K, slot0);
        for (int k = 0; k < K; ++k) {
          const float* m2 = m2s + k * 8;
          const bool on_path = patha[(size_t)k * B * C + row + c] > 0.5f;
          writes |= on_path | (m2[1] != 0.f & (c == slot0 + k | (int)m2[5] == c));
        }
      }
      unsigned touched = __ballot_sync(kFullMask, writes);
      while (touched) {
        const int col = c0 + __ffs(touched) - 1;
        touched &= touched - 1;
        if (lane < K) terms[lane] = round_term(patha, psgn, m2s, 8, b, col, lane, B, C, slot0);
        __syncwarp();
        int inst;
        const float keep = round_keep(terms, K, inst);
        const float* pm_row = pm + ((size_t)(inst >= 0 ? inst : 0) * B + b) * A;
        Top2 t;
        merge_round_column_warp<J>(n, w, p, code, pm_row, terms, K, keep, inst >= 0,
                                   (size_t)b * A * C + col, A, C, cpuct, lane, t);
        if (lane == 0) top2_store(t, true, row + col, besta, bestc, seca, secc);
        __syncwarp();  // every lane has read the terms before the next column's
      }
    }
  }
}

// The seed of a fresh search at every A, one warp per game (kMergeWarps
// games a block): _refresh (and with kTop2 _refresh2) of the planes
// _init_planes leaves, which is its precondition: the roots' priors in
// p[:, :, 0], and n = w = p = 0, code = -1 everywhere else. Only the game's
// A priors are read: lane l loads those of actions l, l + 32, ... (J a
// lane, all in flight together; J = 1 at A <= 8, where lane a holds action
// a), scores each at n = w = 0 with the reference's operations
// (puct_score; an illegal prior scores -1e30) and pushes them in action
// order with strict comparisons; the warp then reduces in the first-max
// order (score descending, action ascending). That is the dense branch's
// result and the unrolled one's too (A <= 8): its strict-> scan from edge 0
// keeps the first maximum, action 0 at an all-illegal root, and its
// runner-up is the first maximum of the other edges, as the dense branch's
// exclude-and-re-reduce. Every child code is -1, so the root's best code is
// -1 and so is its runner-up's, which is -1 (action and code) where no
// legal runner-up exists: the dense branch resets that code to -1, the
// unrolled one keeps the child code its scan left there (top2_store), which
// on these planes is -1 as well. Every column c >= 1 is the empty node,
// whose edges all score +0: best action 0, runner-up action 1 (-1 at A = 1:
// no runner-up), codes -1. The warp writes the game's rows lane-strided
// (coalesced): the root's values at column 0, those constants elsewhere;
// all are +0 or exact integers.
// One chunk of a seed's root edges: lane l's actions a0 + l, a0 + l + 32,
// ... (J of them, loaded together), scored at n = w = 0 and pushed in
// increasing order into the lane's running top-2 (kTop2) or first maximum.
template <int J, bool kTop2>
__device__ __forceinline__ void seed_chunk(const float* p_root, int a0, int A, int C, int lane,
                                           float sq, float cpuct, Top2& t, float& best,
                                           float& ba) {
  float pv[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = a0 + lane + 32 * j;
    pv[j] = a < A ? p_root[(size_t)a * C] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int a = a0 + lane + 32 * j;
    if (a < A) {
      const float sc = puct_score(0.f, 0.f, pv[j], sq, cpuct);
      if constexpr (kTop2) {
        lane_top2_push(t, (float)a, sc, -1.f);
      } else if (sc > best) {
        best = sc;
        ba = (float)a;
      }
    }
  }
}

// J = kStream: the instance for any A, the root's edges in chunks of 32 *
// kStreamSmallJ (a lane's running best carried across them, so an equal
// score in a later chunk never displaces an earlier action).
template <int J, bool kTop2>
__global__ void __launch_bounds__(kMergeWarpThreads)
    seed_dense_kernel(const float* __restrict__ p, float* __restrict__ besta,
                      float* __restrict__ bestc, float* __restrict__ seca,
                      float* __restrict__ secc, int B, int A, int C, float cpuct) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kMergeWarps + (int)(threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const float* p_root = p + (size_t)b * A * C;  // p[b, a, 0] at a * C
  const float sq = __fsqrt_rn(__fadd_rn(0.f, kPuctEps));  // the root's visit sum is 0
  Top2 t{kNoEdge, kNoEdge, kNoAction, -1.f, kNoAction, -1.f};
  float best = kNoEdge, ba = kNoAction;
  if constexpr (J == kStream) {
    for (int a0 = 0; a0 < A; a0 += 32 * kStreamSmallJ) {
      seed_chunk<kStreamSmallJ, kTop2>(p_root, a0, A, C, lane, sq, cpuct, t, best, ba);
    }
  } else {
    seed_chunk<J, kTop2>(p_root, 0, A, C, lane, sq, cpuct, t, best, ba);
  }
  float root_a, root_sa = -1.f;
  if constexpr (kTop2) {
    warp_top2(t);
    root_a = t.best_a;
    if (t.second > -1e29f) root_sa = t.sec_a;  // a legal runner-up
  } else {
    warp_first_max(best, ba);
    root_a = ba;
  }
  const float empty_sa = A > 1 ? 1.f : -1.f;
  const size_t row = (size_t)b * C;
  for (int c = lane; c < C; c += 32) {
    besta[row + c] = c == 0 ? root_a : 0.f;
    bestc[row + c] = -1.f;
    if constexpr (kTop2) {
      seca[row + c] = c == 0 ? root_sa : empty_sa;
      secc[row + c] = -1.f;
    }
  }
}

unsigned int blocks_for(size_t items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

// kDescendWarps games (warps) a block.
template <class Game>
int launch_descend(const float* besta, const float* bestc, const float* done,
                   const float* tval, const float* boards, float* bd, float* patha,
                   float* psgn, float* meta, int B, int C, int max_depth, int cells,
                   void* stream) {
  descend_kernel<Game><<<blocks_for(B, kDescendWarps), kDescendThreads, 0,
                         (cudaStream_t)stream>>>(
      besta, bestc, done, tval, boards, bd, patha, psgn, meta, B, C, max_depth, cells);
  return (int)cudaGetLastError();
}

// Whether a round descend counts in bytes in shared memory (K <= 255, C <=
// kMaxByteNodes); else its 32-bit counters are in the caller's scratch.
bool round_counts_in_bytes(int C, int K) { return K <= kMaxByteK && C <= kMaxByteNodes; }

// The K descents of a round, kDescendWarps games (warps) a block: byte
// counters in dynamic shared memory (above 48 KB only after opting in), or
// 32-bit ones in the global scratch [B][2][C].
template <class Game>
int launch_descend_round(const float* besta, const float* bestc, const float* seca,
                         const float* secc, const float* done, const float* tval,
                         const float* boards, float* bd, float* patha, float* psgn, float* meta,
                         unsigned* scratch, int B, int C, int K, int max_depth, int cells,
                         void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  if (round_counts_in_bytes(C, K)) {
    const size_t smem = 2 * (size_t)C * kDescendWarps;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          descend_round_kernel<Game>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    descend_round_kernel<Game><<<blocks_for(B, kDescendWarps), kDescendThreads, smem,
                                 (cudaStream_t)stream>>>(
        besta, bestc, seca, secc, done, tval, boards, bd, patha, psgn, meta, B, C, K, max_depth,
        cells);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  descend_round_wide_kernel<Game><<<blocks_for(B, kDescendWarps), kDescendThreads, 0,
                                    (cudaStream_t)stream>>>(
      besta, bestc, seca, secc, done, tval, boards, bd, patha, psgn, meta, scratch, B, C, K,
      max_depth, cells);
  return (int)cudaGetLastError();
}

// The dense merges: kMergeWarps games (warps) a block, in the kernel
// instance whose lanes keep J actions each in registers: J = 4 up to A =
// 128, 8 up to 256, 16 up to 512, 24 up to kMaxDenseA = 768; above, the
// streamed instance (J = kStream).
template <int J>
int launch_merge_dense(float* n, float* w, float* p, float* code, float* done, float* tval,
                       const float* pm, const float* patha, const float* psgn, const float* meta2,
                       float* besta, float* bestc, int B, int A, int C, int slot, float cpuct,
                       void* stream) {
  merge_dense_kernel<J><<<blocks_for(B, kMergeWarps), kMergeWarpThreads, 0,
                          (cudaStream_t)stream>>>(n, w, p, code, done, tval, pm, patha, psgn,
                                                  meta2, besta, bestc, B, A, C, slot, cpuct);
  return (int)cudaGetLastError();
}

// The seeds: kMergeWarps games (warps) a block, J actions a lane as the
// dense merges keep them, one at A <= kMaxA, streamed above kMaxDenseA.
template <int J, bool kTop2>
int launch_seed(const float* p, float* besta, float* bestc, float* seca, float* secc, int B, int A,
                int C, float cpuct, void* stream) {
  seed_dense_kernel<J, kTop2><<<blocks_for(B, kMergeWarps), kMergeWarpThreads, 0,
                                (cudaStream_t)stream>>>(p, besta, bestc, seca, secc, B, A, C,
                                                        cpuct);
  return (int)cudaGetLastError();
}

template <bool kTop2>
int seed(const float* p, float* besta, float* bestc, float* seca, float* secc, int B, int A, int C,
         float cpuct, void* stream) {
  if (A < 1) return (int)cudaErrorInvalidValue;
  if (A <= kMaxA) return launch_seed<1, kTop2>(p, besta, bestc, seca, secc, B, A, C, cpuct, stream);
  if (A <= 32 * 4) {
    return launch_seed<4, kTop2>(p, besta, bestc, seca, secc, B, A, C, cpuct, stream);
  }
  if (A <= 32 * 8) {
    return launch_seed<8, kTop2>(p, besta, bestc, seca, secc, B, A, C, cpuct, stream);
  }
  if (A <= 32 * 16) {
    return launch_seed<16, kTop2>(p, besta, bestc, seca, secc, B, A, C, cpuct, stream);
  }
  if (A <= kMaxDenseA) {
    return launch_seed<24, kTop2>(p, besta, bestc, seca, secc, B, A, C, cpuct, stream);
  }
  return launch_seed<kStream, kTop2>(p, besta, bestc, seca, secc, B, A, C, cpuct, stream);
}

template <int J>
int launch_merge_round_dense(float* n, float* w, float* p, float* code, float* done, float* tval,
                             const float* pm, const float* patha, const float* psgn,
                             const float* meta2, float* besta, float* bestc, float* seca,
                             float* secc, int B, int A, int C, int K, int slot0, float cpuct,
                             void* stream) {
  merge_round_dense_kernel<J><<<blocks_for(B, kMergeWarps), kMergeWarpThreads, 0,
                                (cudaStream_t)stream>>>(n, w, p, code, done, tval, pm, patha,
                                                        psgn, meta2, besta, bestc, seca, secc, B,
                                                        A, C, K, slot0, cpuct);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The descend entries: boards f32[B, cells], cells being the game's own
// (42, 64, 49) or, for Gomoku, its edge squared, any edge: the 8-word
// instance up to 512 cells, the 12-word one up to 768, the leaf-row one
// above.
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
  if (cells <= 64 * 8) {
    return launch_descend<GomokuGame<8>>(besta, bestc, done, tval, boards, bd, patha, psgn, meta,
                                         B, C, max_depth, cells, stream);
  }
  if (cells <= 64 * 12) {
    return launch_descend<GomokuGame<12>>(besta, bestc, done, tval, boards, bd, patha, psgn,
                                          meta, B, C, max_depth, cells, stream);
  }
  return launch_descend<GomokuRowGame>(besta, bestc, done, tval, boards, bd, patha, psgn, meta, B,
                                       C, max_depth, cells, stream);
}

int az_descend_hex(const float* besta, const float* bestc, const float* done,
                   const float* tval, const float* boards, float* bd, float* patha,
                   float* psgn, float* meta, int B, int C, int max_depth, int cells,
                   void* stream) {
  return launch_descend<HexGame>(besta, bestc, done, tval, boards, bd, patha, psgn, meta, B, C,
                                 max_depth, cells, stream);
}

// The A <= 8 K=1 merge: updates besta/bestc in place at the columns it
// writes, and relies on them being the refresh of the entry planes.
int az_merge(float* n, float* w, float* p, float* code, float* done,
             float* tval, const float* pm, const float* patha,
             const float* psgn, const float* meta2, float* besta,
             float* bestc, int B, int A, int C, int slot, float cpuct,
             void* stream) {
  if (A > kMaxA) return (int)cudaErrorInvalidValue;
  merge_kernel<<<blocks_for(B, kMergeWarps), kMergeWarpThreads, 0,
                 (cudaStream_t)stream>>>(n, w, p, code, done, tval, pm, patha,
                                         psgn, meta2, besta, bestc, B, A, C,
                                         slot, cpuct);
  return (int)cudaGetLastError();
}

// The dense K=1 merge, any A (streamed above 768): updates besta/bestc in
// place at the columns it writes, and relies on them being the refresh of
// the entry planes.
int az_merge_dense(float* n, float* w, float* p, float* code, float* done,
                   float* tval, const float* pm, const float* patha,
                   const float* psgn, const float* meta2, float* besta,
                   float* bestc, int B, int A, int C, int slot, float cpuct,
                   void* stream) {
  if (A <= 32 * 4) {
    return launch_merge_dense<4>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc,
                                 B, A, C, slot, cpuct, stream);
  }
  if (A <= 32 * 8) {
    return launch_merge_dense<8>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc,
                                 B, A, C, slot, cpuct, stream);
  }
  if (A <= 32 * 16) {
    return launch_merge_dense<16>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc,
                                  B, A, C, slot, cpuct, stream);
  }
  if (A <= kMaxDenseA) {
    return launch_merge_dense<24>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta, bestc,
                                  B, A, C, slot, cpuct, stream);
  }
  return launch_merge_dense<kStream>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta,
                                     bestc, B, A, C, slot, cpuct, stream);
}

// The seed of a fresh search (A >= 1; the wrappers send it A <= 8):
// n, w and code are not read; the planes must be as _init_planes leaves
// them (see seed_dense_kernel).
int az_refresh(const float* n, const float* w, const float* p,
               const float* code, float* besta, float* bestc, int B, int A,
               int C, float cpuct, void* stream) {
  return seed<false>(p, besta, bestc, nullptr, nullptr, B, A, C, cpuct, stream);
}

// The same seed for the dense path (A >= 2).
int az_refresh_dense(const float* n, const float* w, const float* p,
                     const float* code, float* besta, float* bestc, int B,
                     int A, int C, float cpuct, void* stream) {
  if (A < 2) return (int)cudaErrorInvalidValue;
  return seed<false>(p, besta, bestc, nullptr, nullptr, B, A, C, cpuct, stream);
}

// The round entries: K >= 1 descents per game, outputs K-major. `scratch`
// holds az_descend_round_scratch(B, C, K) 32-bit counters (none: nullptr).
int az_descend_round(const float* besta, const float* bestc, const float* seca,
                     const float* secc, const float* done, const float* tval,
                     const float* boards, float* bd, float* patha, float* psgn, float* meta,
                     unsigned* scratch, int B, int C, int K, int max_depth, int cells,
                     void* stream) {
  return launch_descend_round<ConnectFourGame>(besta, bestc, seca, secc, done, tval, boards, bd,
                                               patha, psgn, meta, scratch, B, C, K, max_depth,
                                               cells, stream);
}

int az_descend_round_othello(const float* besta, const float* bestc, const float* seca,
                             const float* secc, const float* done, const float* tval,
                             const float* boards, float* bd, float* patha, float* psgn,
                             float* meta, unsigned* scratch, int B, int C, int K, int max_depth,
                             int cells, void* stream) {
  return launch_descend_round<OthelloGame>(besta, bestc, seca, secc, done, tval, boards, bd,
                                           patha, psgn, meta, scratch, B, C, K, max_depth, cells,
                                           stream);
}

int az_descend_round_gomoku(const float* besta, const float* bestc, const float* seca,
                            const float* secc, const float* done, const float* tval,
                            const float* boards, float* bd, float* patha, float* psgn,
                            float* meta, unsigned* scratch, int B, int C, int K, int max_depth,
                            int cells, void* stream) {
  if (cells <= 64 * 8) {
    return launch_descend_round<GomokuGame<8>>(besta, bestc, seca, secc, done, tval, boards, bd,
                                               patha, psgn, meta, scratch, B, C, K, max_depth,
                                               cells, stream);
  }
  if (cells <= 64 * 12) {
    return launch_descend_round<GomokuGame<12>>(besta, bestc, seca, secc, done, tval, boards, bd,
                                                patha, psgn, meta, scratch, B, C, K, max_depth,
                                                cells, stream);
  }
  return launch_descend_round<GomokuRowGame>(besta, bestc, seca, secc, done, tval, boards, bd,
                                             patha, psgn, meta, scratch, B, C, K, max_depth,
                                             cells, stream);
}

int az_descend_round_hex(const float* besta, const float* bestc, const float* seca,
                         const float* secc, const float* done, const float* tval,
                         const float* boards, float* bd, float* patha, float* psgn, float* meta,
                         unsigned* scratch, int B, int C, int K, int max_depth, int cells,
                         void* stream) {
  return launch_descend_round<HexGame>(besta, bestc, seca, secc, done, tval, boards, bd, patha,
                                       psgn, meta, scratch, B, C, K, max_depth, cells, stream);
}

// The 32-bit counters [B][2][C] a round descend of B games, C nodes and K
// descents keeps in global memory: 0 where its byte counters fit in shared
// memory (K <= 255 and C <= 29056).
long long az_descend_round_scratch(int B, int C, int K) {
  return round_counts_in_bytes(C, K) ? 0LL : 2LL * B * C;
}

// The round merges: pm f32[K, B, A], patha/psgn f32[K, B, C], meta2
// f32[K, B, 8]; descent k installs at slot slot0 + k, K >= 1 (the records
// staged in shared memory up to K = 16, read where they lie above). The
// A <= 8 one updates the four top-2 planes in place at the columns it
// writes, and relies on them being the refresh2 of the entry planes.
int az_merge_round(float* n, float* w, float* p, float* code, float* done, float* tval,
                   const float* pm, const float* patha, const float* psgn, const float* meta2,
                   float* besta, float* bestc, float* seca, float* secc, int B, int A, int C,
                   int K, int slot0, float cpuct, void* stream) {
  if (K < 1 || A > kMaxA) return (int)cudaErrorInvalidValue;
  if (K <= kMaxRoundK) {
    merge_round_kernel<false><<<blocks_for(B, kMergeWarps), kMergeWarpThreads, 0,
                                (cudaStream_t)stream>>>(n, w, p, code, done, tval, pm, patha, psgn,
                                                        meta2, besta, bestc, seca, secc, B, A, C,
                                                        K, slot0, cpuct);
  } else {
    merge_round_kernel<true><<<blocks_for(B, kMergeWarps), kMergeWarpThreads, 0,
                               (cudaStream_t)stream>>>(n, w, p, code, done, tval, pm, patha, psgn,
                                                       meta2, besta, bestc, seca, secc, B, A, C,
                                                       K, slot0, cpuct);
  }
  return (int)cudaGetLastError();
}

// The dense round merge, any A and K (streamed above A = 768 or K = 16):
// updates the four top-2 planes in place at the columns it writes, and
// relies on them being the refresh2 of the entry planes.
int az_merge_round_dense(float* n, float* w, float* p, float* code, float* done, float* tval,
                         const float* pm, const float* patha, const float* psgn,
                         const float* meta2, float* besta, float* bestc, float* seca,
                         float* secc, int B, int A, int C, int K, int slot0, float cpuct,
                         void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  if (K > kMaxRoundK || A > kMaxDenseA) {
    return launch_merge_round_dense<kStream>(n, w, p, code, done, tval, pm, patha, psgn, meta2,
                                             besta, bestc, seca, secc, B, A, C, K, slot0, cpuct,
                                             stream);
  }
  if (A <= 32 * 4) {
    return launch_merge_round_dense<4>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta,
                                       bestc, seca, secc, B, A, C, K, slot0, cpuct, stream);
  }
  if (A <= 32 * 8) {
    return launch_merge_round_dense<8>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta,
                                       bestc, seca, secc, B, A, C, K, slot0, cpuct, stream);
  }
  if (A <= 32 * 16) {
    return launch_merge_round_dense<16>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta,
                                        bestc, seca, secc, B, A, C, K, slot0, cpuct, stream);
  }
  return launch_merge_round_dense<24>(n, w, p, code, done, tval, pm, patha, psgn, meta2, besta,
                                      bestc, seca, secc, B, A, C, K, slot0, cpuct, stream);
}

// The top-2 seed of a fresh round search (A >= 1; the wrappers send it
// A <= 8), as az_refresh.
int az_refresh2(const float* n, const float* w, const float* p, const float* code, float* besta,
                float* bestc, float* seca, float* secc, int B, int A, int C, float cpuct,
                void* stream) {
  return seed<true>(p, besta, bestc, seca, secc, B, A, C, cpuct, stream);
}

// The same top-2 seed for the dense path (A >= 2).
int az_refresh2_dense(const float* n, const float* w, const float* p, const float* code,
                      float* besta, float* bestc, float* seca, float* secc, int B, int A, int C,
                      float cpuct, void* stream) {
  if (A < 2) return (int)cudaErrorInvalidValue;
  return seed<true>(p, besta, bestc, seca, secc, B, A, C, cpuct, stream);
}

}  // extern "C"
