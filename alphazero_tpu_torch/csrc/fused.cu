// Fused search kernels for Hopper (sm_90a): every simulation of a search in
// one launch. One search serves two evaluators, each at K=1 and in K>1
// leaf-parallel rounds, on two games (game policies, below): Connect-Four
// and Gomoku boards of at most 16 cells, the games the reference's fused
// kernel takes (A <= 16, flat ops, a zero heuristic):
// * az_fused, az_fused_rounds (Connect-Four), az_fused_gomoku,
//   az_fused_gomoku_rounds: a constant (uniform) prior and value;
// * az_fused_mlp, az_fused_mlp_rounds (Connect-Four, 1 to 4 hidden layers of
//   at most 256 units: the resident or staged plan of mlp.cuh) and
//   az_fused_mlp_stream, az_fused_mlp_stream_rounds (either game, any widths
//   and depth: the streamed plan): MLPNet, evaluated inside the kernel by
//   mlp.cuh.
//
// Replaces the Pallas `kernel` of make_fused_root_fn
// (alphazero_tpu/mcts/fused.py:156), pallas_call at :670: on its K=1 path
// sim_body (:282-426) and refresh_best (:220-256); on its K>1 path (K2)
// round_body (:428-639) and refresh_best's top-2 branch (:258-277); with
// the uniform evaluator (:380-383, :553-556) or the in-kernel MLP (:384-388,
// :557-561, the K3 eval_fn of alphazero_tpu/models/nets.py:129), and the
// Connect-Four or Gomoku FlatOps traced into it (here the game policies,
// on the helpers of c4.cuh and gomoku.cuh). The
// plain PyTorch versions are fused_search, fused_mlp_search,
// fused_rounds_search and fused_mlp_rounds_search in
// alphazero_tpu_torch/mcts/fused.py; each kernel must agree with its plain
// version bit for bit (the MLP kernels for weights whose sums are exact in
// any order: their evaluator adds on the tensor cores, see mlp.cuh).
//
// Semantics kept from the reference: root in slot 0 with the masked prior
// and a terminal root never descended; the lockstep slot cursor s = i + 1
// with no install once s >= C; child codes -1 unexpanded, >= 0 a child
// slot, -2-s a terminal child; the cutoff depth + 1 >= max_depth backing up
// 0; leaf value ctval + (1 - cdone) * (v - ctval) on expansion, with v the
// evaluator's value, the child's tval at a terminal child; backup n += 1,
// w += mval * (-1)^d on the edge at depth d, mval = v_leaf * (-1)^depth;
// the first-max PUCT argmax of refresh_node. The uniform evaluator's prior
// is 1/n_valid on the valid edges (the softmax of zero logits) and
// INVALID_P elsewhere; the MLP's is mlp_prior.
//
// The tree lives in device-memory scratch the wrapper allocates,
// f32[B, C, 4 R]: one record of R 16-byte cells per node, edge-major
//   cell a < A: (n[a], w[a], p[a], code[a])   edge a
//   cell A:     (done, tval, link, 0)         link = parent slot << s |
//                                             action, -1 at the root
// Connect-Four: A = 7, R = 8 (128 bytes), s = 3; Gomoku: R = A + 1 (272
// bytes at A = 16), s = 5.
// Only slot 0 is initialised: a slot is read only after the simulation
// that installs it links it in.
// * No best-action planes: the descent computes a node's PUCT argmax from
//   its record when it arrives there. A node's argmax is a function of its
//   own record, and the JAX kernel refreshes every node after each merge,
//   so the argmax read here equals the one the reference's planes hold.
// * No path record: the backup walks from the last edge to the root along
//   the parent links that each install writes (the tree has no
//   transpositions), so no depth limit is needed beyond max_depth itself.
//
// The uniform kernels: G lanes a game, the smallest power of two >= A + 1
// (Connect-Four and Gomoku up to A = 7: eight lanes, four games a warp;
// Gomoku 3x3: 16; Gomoku 4x4: a whole warp a game). Lane e of a game's
// group owns cell e of every node of its tree (and of its round record):
// it alone reads and writes that cell, so the lanes share nothing through
// memory and meet only in shuffles; lanes past A own no cell (a lane a cell
// costs Gomoku 4x4 15 idle lanes of 32, where two cells a lane would need a
// second butterfly and argmax per lane: the simpler layout was taken). The
// text below speaks of Connect-Four's eight lanes; a group of G lanes runs
// its butterflies over log2 G steps and masks its ballots to its lanes.
// * A descent step is one 128-bit load a lane: a warp's four games touch
//   four 128-byte lines, where a thread a game touched 28 x 32 lines
//   with 4-byte loads (the earlier design, 4.79 ms at B=65536 on an H100).
// * The PUCT argmax: each lane scores its own edge with puct_score, in the
//   reference's operation order; the visit sum is a 3-step butterfly
//   inside the group (integers: exact in any order); the best score a
//   3-step butterfly max, and the first lane that holds it is the first
//   maximum of refresh_node's strict > scan (a ballot: equal scores, +0
//   and -0 too, pick the smallest action). Lane 7 scores kNoEdge. The
//   round's top-2 takes the best as above, then the best of the other
//   lanes the same way; c4.cuh's top2_push gives the same pair, with no
//   runner-up when its score is <= -1e29. The chosen edge's code and the
//   round's takes come from their lanes by shuffle.
// * Every lane keeps the game's two bitboards and steps them with c4_step:
//   the board is the same across the group. A warp instruction serves 4
//   games here, not 32, so per-game work is split over the lanes where it
//   can be: the leaf's terminal test runs one of c4_four's eight window
//   tests a lane, gathered by a ballot (group_terminal). Gomoku's tests
//   a win line a lane (lines e, e + G, ...: at most 64 lines, Gomoku(4, 1);
//   tic-tac-toe has 8), from the masks the wrapper builds from the game's
//   win-line matrix.
// * The backup walks the parent links: at each node the lane that owns the
//   edge does the read-modify-write, lane 7 reads the link and shuffles it
//   to the group. The install is one 128-bit store a lane; the parent's
//   code one 4-byte store by the lane of the edge.
// * Shuffles meet all 32 lanes, so every loop with one inside runs until a
//   ballot shows each group of the warp done; a finished group, a done
//   root and a padding game (b >= B) stay in it idle, without memory
//   access. No lane returns early.
// * Blocks of 128 threads (16 games), one pass over the games: at B=65536
//   4,096 blocks, ~3.5 waves of the ~9 blocks an SM holds. A persistent
//   grid of the resident blocks, each walking strides of the games, was
//   1-7% slower on an H100 than the hardware's own block scheduling.
// * az_fused_rounds keeps its K leaves in shared memory, Leaf[16][9] a
//   block (5,760 bytes), written by lane 0 of the group and read by all
//   eight after a __syncwarp. Gomoku takes every K the reference's rule
//   (K+1)^A < 2^24 admits (K <= 5 at A = 9, 62 at A = 4, only K = 1 at
//   A = 16): above 9 the leaves go to a device scratch the wrapper
//   allocates, K a game.
// Trees in shared memory (12.9 KB a game at C=101) were not taken: ~17
// games an SM, 29 waves of latency-bound walks at B=65536.
//
// The MLP kernels keep one thread a game: blocks of
// 32 games and 256 threads in lockstep, as the JAX kernel's block does. At
// kernel start the block copies the MLP's biases, and its weights when
// they fit, into dynamic shared memory (mlp_preload); in each simulation
// threads 0..31 walk their games' descents, reading a node as its A
// 128-bit loads, and write the leaf boards' input rows (mlp.cuh's plan:
// resident or staged for Connect-Four's MLPs of up to 4 x 256 units,
// streamed for any other);
// the whole block evaluates the 32 leaves on the tensor cores (mlp.cuh);
// threads 0..31 then install and back up. A game that does not expand (a
// terminal child, the cutoff, a done root, a padding game b >= B) still
// passes through the evaluation and its result is discarded. No thread
// returns early: every thread reaches every __syncthreads().
//
// What bounds them on an H100: az_fused moves only boards and priors in
// and counts and root W out (16.5 MB at B=65536, ~5 us at 3.35 TB/s), and
// its arithmetic is ~68 f32 operations per descent step. What holds it is
// the tree walks: dependent loads, each node a line of L2 or device
// memory (the trees, 847 MB at B=65536, are far larger than L2), and the
// instructions around them. A thread a game spent 28 x 32 L1 wavefronts a
// descent step on its 4-byte loads, and its time grew linearly with B
// above one block an SM: the load pipe's throughput held it. The group
// layout makes a step 4 wavefronts a warp; what holds it then is
// instruction throughput: the PUCT scores (two IEEE divisions and a square
// root a lane), the shuffles and the board steps, ~144 games an SM in
// flight. az_fused_mlp's bound is the MLP's
// bf16 operations (174,080 per expansion at (256, 256), ~72 us for a
// 100-simulation search of 4096 games at 989 TFLOP/s) plus its f32 head.
// The evaluator does them with mma.sync on the tensor cores from weights
// that stay in shared memory for the launch (mlp.cuh), a few microseconds
// a simulation, so what holds the MLP kernels is again the owner threads'
// dependent tree loads, 32 walkers a block, one block per SM (its 222,720
// bytes of shared memory).
//
// K>1 rounds (parallel_sims = K, round_body): round r's K descents run one
// after another in the game's thread (group), each from the root, all on
// the tree as it stood at the start of the round; then the K leaves are
// finished in k order (descent k installs at slot r*K + 1 + k while that
// is < C, unless it is a duplicate) and backed up. What differs from K=1:
// * The top-2 is computed on arrival from the node's record, as the argmax
//   is (c4.cuh's Top2: strict >, first max, no runner-up when the second
//   score is <= -1e29). A descent takes the runner-up when one exists and
//   the round has taken it fewer times than the best action; an expansion
//   of an edge the round already took is a duplicate: it is evaluated and
//   backs up its value, but installs nothing. (Here an install would write
//   an identical fresh child into its own, otherwise burned, slot; the rule
//   is the reference's, whose additive merge needs it.)
// * The round's takes of each edge are exact small counts in a round
//   record of R float2 cells per node in a second scratch, f32[B, C, 2 R],
//   that the wrapper allocates, edge-major as the tree: cell a = (the
//   round's W sum of edge a, its takes), cell A unused. (The reference packs
//   the takes base-(K+1) into one f32 lane, a layout trick; only its limit
//   (K+1)^A < 2^24, K <= 9 at A = 7, is kept.) A node's round record is
//   zeroed when it is made and along each path after each round.
// * Rounding order: the JAX merge adds w + w_add once per edge, with w_add
//   the round's terms mval_k * (-1)^d summed in k order from 0. Backing up
//   each descent in turn would round otherwise wherever two paths share an
//   edge (the root edges nearly always). So the backup walks path k up the
//   parent links adding n += 1 (exact in any order) and its term to the
//   edge's W sum in the round record; a second walk of every path adds each
//   sum to W and zeroes it, so a later path through the same edge adds +0,
//   which leaves W as it is (W is never -0).
// * az_fused_mlp_rounds runs K block evaluations per round, one per descent
//   k in k order, every thread reaching every __syncthreads(). Each owner
//   thread keeps its K leaves (40 bytes each) in a local array, which
//   ptxas places in the stack frame; on Gomoku (K up to 62), in the leaf
//   scratch.
// Their bound is as K1's: the same bytes in and out, and operations per
// descent step (a top-2 scan instead of an argmax) times the steps.
//
// Arithmetic is bit-exact with the reference as in hybrid.cu: built with
// --fmad=false, the PUCT score and the backup with explicit round-to-nearest
// intrinsics, the uniform prior as __fdiv_rn(1, n_valid).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "c4.cuh"
#include "gomoku.cuh"
#include "mlp.cuh"

namespace {

constexpr int kThreads = 128;    // a block of the uniform kernels
constexpr int kNodeCells = 8;    // Connect-Four's 16-byte cells per node record (and round record)
constexpr int kMaxRoundK = 9;    // leaves a game a round in shared memory (registers): C4's K <= 9
constexpr int kMaxSmallCells = 16;   // the Gomoku boards the fused kernels take: A <= 16
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNoEdge = -3.0e38f;  // a lane without an edge scores below every edge, -1e30 too

// Where a simulation's descent ended.
struct Leaf {
  uint64_t mine, theirs;  // the leaf board
  int last, last_a;       // the last edge walked: its node and action
  int depth;              // edges walked
  int leaf;               // the terminal child's slot (term)
  bool exp, term;         // ended at an unexpanded edge / a terminal child
  bool dup;               // exp at an edge this round already took (rounds)
};

// ---- the games -------------------------------------------------------------
// A game policy: its actions A, the cells L of its flat board, its node
// record (A edge cells and the meta cell, 16 bytes each), and the FlatOps
// the reference traces into its kernel (load, step, valid, terminal) on two
// 64-bit bitboards, `mine` (+1, the player to move) and `theirs`. kActions
// and kEdges bound the per-action arrays at compile time; kLinkShift packs
// a parent link as slot << kLinkShift | action.

// Connect-Four: everything at compile time (c4.cuh); the 8-cell record.
struct C4Game {
  static constexpr int kActions = kCols;
  static constexpr int kEdges = kMaxA;     // refresh_node's 8
  static constexpr int kLinkShift = 3;
  static constexpr bool kWide = false;     // K <= kMaxRoundK: no leaf scratch
  __device__ __forceinline__ int actions() const { return kCols; }
  __device__ __forceinline__ int cells() const { return kCells; }
  __device__ __forceinline__ int record() const { return kNodeCells; }
  __device__ __forceinline__ bool in_record(int) const { return true; }   // every lane of 8
  __device__ __forceinline__ void load(const float* board, uint64_t& m, uint64_t& t) const {
    c4_load(board, m, t);
  }
  __device__ __forceinline__ void step(uint64_t& m, uint64_t& t, int a) const { c4_step(m, t, a); }
  __device__ __forceinline__ bool valid(uint64_t m, uint64_t t, int a) const {
    return c4_valid(m, t, a);
  }
  __device__ __forceinline__ int n_valid(uint64_t m, uint64_t t) const {
    return kCols - __popcll(c4_full_columns(m, t));
  }
  __device__ __forceinline__ void terminal(uint64_t m, uint64_t t, bool* done, float* value) const {
    c4_terminal(m, t, done, value);
  }
  // c4_terminal of the group's board, its eight window tests split over the
  // G = 8 lanes: lane e tests c4_four's direction e % 4 (horizontal,
  // vertical, the two diagonals) on the side to move (e < 4) or the other,
  // and a ballot gathers them.
  template <int G>
  __device__ __forceinline__ void group_terminal(uint64_t mine, uint64_t theirs, int e, int g0,
                                                 bool* done, float* value) const {
    static_assert(G == 8, "a lane a window direction and side");
    const int dir = e % 4;
    const int step = dir == 0 ? 1 : dir == 1 ? kCols : dir == 2 ? kCols + 1 : kCols - 1;
    const uint64_t start = dir == 1 ? ~0ull : dir == 3 ? kStartRight : kStartLeft;
    const bool four = c4_windows(e < 4 ? mine : theirs, step, start) != 0;
    const unsigned sides = __ballot_sync(kFullMask, four) >> g0;
    const bool win = (sides & 0x0fu) != 0, lose = (sides & 0xf0u) != 0;
    const bool full = c4_full_columns(mine, theirs) == (1ull << kCols) - 1;
    *done = win || lose || full;
    *value = (win ? 1.f : 0.f) - ((lose && !win) ? 1.f : 0.f);
  }
};

// Gomoku(size, win) boards of at most 16 cells (size <= 4; tic-tac-toe is
// Gomoku(3, 3)), size and win at run time: cell i is bit i, row-major. The
// step is gomoku.cuh's (+1 at the cell, an occupied one overwritten, then
// the sides swap); the terminal test is GomokuFlatOps.terminal's: a win
// line full of the side to move's stones is +1, else one full of the other
// side's -1, else a full board 0. The lines are masks in device memory that
// the wrapper builds from the win-line matrix (at most 64: Gomoku(4, 1)).
// The record is A + 1 cells (272 bytes at A = 16), links slot * 32 + action.
struct SmallGomoku {
  static constexpr int kActions = kMaxSmallCells;
  static constexpr int kEdges = kMaxSmallCells;
  static constexpr int kLinkShift = 5;
  static constexpr bool kWide = true;      // any K the (K+1)^A < 2^24 rule admits (62 at A = 4)
  int a;                   // cells = actions
  int n_lines;             // win lines
  const uint32_t* lines;   // each line's cells, a bit each
  __device__ __forceinline__ int actions() const { return a; }
  __device__ __forceinline__ int cells() const { return a; }
  __device__ __forceinline__ int record() const { return a + 1; }
  __device__ __forceinline__ bool in_record(int e) const { return e <= a; }
  __device__ __forceinline__ void load(const float* board, uint64_t& m, uint64_t& t) const {
    m = t = 0;
    for (int i = 0; i < a; ++i) {
      const float v = board[i];
      if (v > 0.5f) m |= 1ull << i;
      if (v < -0.5f) t |= 1ull << i;
    }
  }
  __device__ __forceinline__ void step(uint64_t& m, uint64_t& t, int x) const {
    uint64_t mine[1] = {m}, theirs[1] = {t};
    gomoku_step<1>(mine, theirs, x);
    m = mine[0];
    t = theirs[0];
  }
  __device__ __forceinline__ bool valid(uint64_t m, uint64_t t, int x) const {
    return (((m | t) >> x) & 1ull) == 0;
  }
  __device__ __forceinline__ int n_valid(uint64_t m, uint64_t t) const { return a - __popcll(m | t); }
  __device__ __forceinline__ bool full(uint64_t m, uint64_t t) const {
    return (m | t) == (1ull << a) - 1;
  }
  __device__ __forceinline__ void terminal(uint64_t m, uint64_t t, bool* done, float* value) const {
    bool win = false, lose = false;
    for (int j = 0; j < n_lines; ++j) {
      const uint64_t line = lines[j];
      win = win || (m & line) == line;
      lose = lose || (t & line) == line;
    }
    *done = win || lose || full(m, t);
    *value = (win ? 1.f : 0.f) - ((lose && !win) ? 1.f : 0.f);
  }
  // terminal with the lines split over the group's G lanes (lane e tests
  // lines e, e + G, ...), gathered by ballots over the group's lanes.
  template <int G>
  __device__ __forceinline__ void group_terminal(uint64_t m, uint64_t t, int e, int g0, bool* done,
                                                 float* value) const {
    bool w = false, l = false;
    for (int j = e; j < n_lines; j += G) {
      const uint64_t line = lines[j];
      w = w || (m & line) == line;
      l = l || (t & line) == line;
    }
    const unsigned group = (G == 32 ? kFullMask : (1u << G) - 1) << g0;
    const bool win = (__ballot_sync(kFullMask, w) & group) != 0;
    const bool lose = (__ballot_sync(kFullMask, l) & group) != 0;
    *done = win || lose || full(m, t);
    *value = (win ? 1.f : 0.f) - ((lose && !win) ? 1.f : 0.f);
  }
};

__device__ __forceinline__ float4 fresh_edge(float p) { return make_float4(0.f, 0.f, p, -1.f); }

__device__ __forceinline__ float4* node_at(float4* T, int node, int rec) {
  return T + (size_t)node * rec;
}
__device__ __forceinline__ const float4* node_at(const float4* T, int node, int rec) {
  return T + (size_t)node * rec;
}
__device__ __forceinline__ float2* rnd_at(float2* V, int node, int rec) {
  return V + (size_t)node * rec;
}

// A parent link as the float the meta cell holds, and back.
template <class Game>
__device__ __forceinline__ float link_of(int slot, int a) {
  return (float)((slot << Game::kLinkShift) + a);
}
template <class Game>
__device__ __forceinline__ void unlink(int link, int& nd, int& a) {
  nd = link >> Game::kLinkShift;
  a = link & ((1 << Game::kLinkShift) - 1);
}

// The uniform evaluator's prior of edge a of a board: 1/n_valid on the
// valid edges, kInvalidP elsewhere.
template <class Game>
__device__ __forceinline__ float uniform_p(const Game& g, uint64_t mine, uint64_t theirs, int a) {
  const int n_valid = g.n_valid(mine, theirs);
  const float prior = __fdiv_rn(1.f, (float)(n_valid > 0 ? n_valid : 1));
  return g.valid(mine, theirs, a) ? prior : kInvalidP;
}

__device__ __forceinline__ float leaf_value(bool cdone, float ctval, float v_nn) {
  const float cd = cdone ? 1.f : 0.f;
  return __fadd_rn(ctval, __fmul_rn(1.f - cd, v_nn - ctval));
}

// masked_policy of the head outputs out[0..A-1] over the legal moves of the
// board (INVALID_P on the others), its sum taken in action order; and the
// value tanh(out[A]).
template <class Game>
__device__ __forceinline__ void mlp_prior(const Game& g, const float* out, uint64_t mine,
                                          uint64_t theirs, float (&pm)[Game::kActions],
                                          float* value) {
  const int A = g.actions();
  bool vm[Game::kActions];
  float masked[Game::kActions];
  int n_valid = 0;
#pragma unroll
  for (int a = 0; a < Game::kActions; ++a) {
    if (a < A) {
      vm[a] = g.valid(mine, theirs, a);
      n_valid += vm[a] ? 1 : 0;
      masked[a] = vm[a] ? out[a] : kNegInf;
    }
  }
  float mx = masked[0];
#pragma unroll
  for (int a = 1; a < Game::kActions; ++a)
    if (a < A) mx = fmaxf(mx, masked[a]);
  float e[Game::kActions];
  float total = 0.f;
#pragma unroll
  for (int a = 0; a < Game::kActions; ++a) {
    if (a < A) {
      e[a] = vm[a] ? expf(__fsub_rn(masked[a], mx)) : 0.f;
      total = __fadd_rn(total, e[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < Game::kActions; ++a) {
    if (a < A) {
      // the uniform fallback over the legal moves; with none, every edge is
      // INVALID_P whatever the prior
      const float p = total > 0.f ? __fdiv_rn(e[a], fmaxf(total, 1e-30f))
                                  : (vm[a] ? __fdiv_rn(1.f, (float)n_valid) : 0.f);
      pm[a] = vm[a] ? p : kInvalidP;
    }
  }
  *value = tanhf(out[A]);
}

// ---- one thread a game (the MLP kernels) ---------------------------------

// The root in slot 0 with the masked prior, no visits and no children.
template <class Game>
__device__ __forceinline__ void init_root(const Game& g, float4* T, const float* board,
                                          const float* prior, uint64_t& mine, uint64_t& theirs,
                                          bool& done) {
  g.load(board, mine, theirs);
  float tval;
  g.terminal(mine, theirs, &done, &tval);
  for (int a = 0; a < g.actions(); ++a) T[a] = fresh_edge(prior[a]);
  T[g.actions()] = make_float4(done ? 1.f : 0.f, tval, -1.f, 0.f);
}

// A node's edges from its record, into registers.
template <class Game>
__device__ __forceinline__ void load_edges(const Game& g, const float4* R,
                                           float (&nv)[Game::kEdges], float (&wv)[Game::kEdges],
                                           float (&pv)[Game::kEdges], float (&cv)[Game::kEdges]) {
#pragma unroll
  for (int a = 0; a < Game::kEdges; ++a) {
    const float4 c = a < g.actions() ? R[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    nv[a] = c.x;
    wv[a] = c.y;
    pv[a] = c.z;
    cv[a] = c.w;
  }
}

// c4.cuh's refresh_node over N edges in registers: the first-max PUCT
// argmax of the A edges of one node.
template <int N>
__device__ __forceinline__ void refresh_edges(const float (&n)[N], const float (&w)[N],
                                              const float (&p)[N], const float (&code)[N], int A,
                                              float cpuct, float* best_a, float* best_code) {
  float total = 0.f;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    if (a < A) total = __fadd_rn(total, n[a]);  // integers: exact in any order
  }
  const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
  float best = 0.f, ba = 0.f, bc = 0.f;
#pragma unroll
  for (int a = 0; a < N; ++a) {
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

// One descent from the root along the PUCT argmax.
template <class Game>
__device__ __forceinline__ Leaf descend(const Game& g, const float4* T, uint64_t root_mine,
                                        uint64_t root_theirs, int max_depth, float cpuct) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false};
  const int rec = g.record();
  int node = 0;
  for (;;) {
    float nv[Game::kEdges], wv[Game::kEdges], pv[Game::kEdges], cv[Game::kEdges];
    load_edges(g, node_at(T, node, rec), nv, wv, pv, cv);
    float af, code;
    refresh_edges(nv, wv, pv, cv, g.actions(), cpuct, &af, &code);
    const int a = (int)af;
    g.step(L.mine, L.theirs, a);
    L.last = node;
    L.last_a = a;
    L.depth += 1;
    if (code < -1.5f) {  // terminal child: back up its value
      L.term = true;
      L.leaf = (int)(-2.f - code);
      break;
    }
    if (code < -0.5f) {  // unexpanded edge: expand
      L.exp = true;
      break;
    }
    if (L.depth >= max_depth) break;  // cutoff: back up 0
    node = (int)code;
  }
  return L;
}

// The leaf value of simulation s; an expansion also installs the child at
// slot s (while s < C) with the prior pm and links it to its parent edge.
// pm and v_nn (the evaluator's value of the leaf board) are read only on
// an expansion.
template <class Game>
__device__ __forceinline__ float finish_leaf(const Game& g, float4* T, const Leaf& L, int s, int C,
                                             const float (&pm)[Game::kActions], float v_nn) {
  const int A = g.actions(), rec = g.record();
  if (L.term) return node_at(T, L.leaf, rec)[A].y;
  if (!L.exp) return 0.f;
  bool cdone;
  float ctval;
  g.terminal(L.mine, L.theirs, &cdone, &ctval);
  if (s < C) {
    float4* S = node_at(T, s, rec);
#pragma unroll
    for (int a = 0; a < Game::kActions; ++a)
      if (a < A) S[a] = fresh_edge(pm[a]);
    S[A] = make_float4(cdone ? 1.f : 0.f, ctval, link_of<Game>(L.last, L.last_a), 0.f);
    node_at(T, L.last, rec)[L.last_a].w = cdone ? (float)(-2 - s) : (float)s;
  }
  return leaf_value(cdone, ctval, v_nn);
}

// Backup along the parent links, last edge first.
template <class Game>
__device__ __forceinline__ void backup(const Game& g, float4* T, const Leaf& L, float v_leaf) {
  const int rec = g.record();
  const float psign = (L.depth & 1) ? -1.f : 1.f;  // (-1)^depth
  const float mval = __fmul_rn(v_leaf, psign);
  float sign = -psign;                              // (-1)^(depth - 1)
  int nd = L.last, a = L.last_a;
  for (;;) {
    float4* R = node_at(T, nd, rec);
    R[a].x = __fadd_rn(R[a].x, 1.f);
    R[a].y = __fadd_rn(R[a].y, __fmul_rn(mval, sign));
    if (nd == 0) break;
    unlink<Game>((int)R[g.actions()].z, nd, a);
    sign = -sign;
  }
}

// One descent of a round from the root. At each node it takes the top-2
// PUCT actions of the node's record, which no descent of the round has
// changed, and the runner-up when one exists and the round has taken it
// fewer times than the best action (round_body's use2 = has2 * (v2 < v1),
// fused.py:494-495); it counts its take in the node's round record V.
template <class Game>
__device__ __forceinline__ Leaf descend_round(const Game& g, const float4* T, float2* V,
                                              uint64_t root_mine, uint64_t root_theirs,
                                              int max_depth, float cpuct) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false, false};
  const int A = g.actions(), rec = g.record();
  int node = 0;
  for (;;) {
    float nv[Game::kEdges], wv[Game::kEdges], pv[Game::kEdges], cv[Game::kEdges];
    load_edges(g, node_at(T, node, rec), nv, wv, pv, cv);
    float total = 0.f;
#pragma unroll
    for (int a = 0; a < Game::kActions; ++a)
      if (a < A) total = __fadd_rn(total, nv[a]);  // integers: exact
    const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
    Top2 t{};
#pragma unroll
    for (int a = 0; a < Game::kActions; ++a)
      if (a < A) top2_push(t, a, puct_score(nv[a], wv[a], pv[a], sq, cpuct), cv[a]);
    float2* Vn = rnd_at(V, node, rec);
    const bool use2 = t.second > -1e29f && Vn[(int)t.sec_a].y < Vn[(int)t.best_a].y;
    const int a = (int)(use2 ? t.sec_a : t.best_a);
    const float code = use2 ? t.sec_code : t.best_code;
    const float before = Vn[a].y;
    Vn[a].y = __fadd_rn(before, 1.f);
    g.step(L.mine, L.theirs, a);
    L.last = node;
    L.last_a = a;
    L.depth += 1;
    if (code < -1.5f) {  // terminal child: back up its value
      L.term = true;
      L.leaf = (int)(-2.f - code);
      break;
    }
    if (code < -0.5f) {  // unexpanded edge: expand, unless the round took it before
      L.exp = true;
      L.dup = before > 0.5f;
      break;
    }
    if (L.depth >= max_depth) break;  // cutoff: back up 0
    node = (int)code;
  }
  return L;
}

template <class Game>
__device__ __forceinline__ void zero_round_record(const Game& g, float2* Vn) {
  for (int a = 0; a < g.actions(); ++a) Vn[a] = make_float2(0.f, 0.f);
}

// finish_leaf for descent k of round r, at slot s = r*K + 1 + k; an install
// also zeroes the new node's round record. A duplicate is finished as an
// expansion past the last slot: its value without an install.
template <class Game>
__device__ __forceinline__ float finish_round_leaf(const Game& g, float4* T, float2* V,
                                                   const Leaf& L, int s, int C,
                                                   const float (&pm)[Game::kActions], float v_nn) {
  if (L.dup) s = C;
  if (L.exp && s < C) zero_round_record(g, rnd_at(V, s, g.record()));
  return finish_leaf(g, T, L, s, C, pm, v_nn);
}

// A round's backup of one descent, walking its path as backup does: n += 1
// on each edge, and the descent's term mval * (-1)^d added to the edge's W
// sum in the round record, so each sum is taken in k order from 0.
template <class Game>
__device__ __forceinline__ void round_backup(const Game& g, float4* T, float2* V, const Leaf& L,
                                             float v_leaf) {
  const int rec = g.record();
  const float psign = (L.depth & 1) ? -1.f : 1.f;
  const float mval = __fmul_rn(v_leaf, psign);
  float sign = -psign;
  int nd = L.last, a = L.last_a;
  for (;;) {
    float4* R = node_at(T, nd, rec);
    float2* Vn = rnd_at(V, nd, rec);
    R[a].x = __fadd_rn(R[a].x, 1.f);
    Vn[a].x = __fadd_rn(Vn[a].x, __fmul_rn(mval, sign));
    if (nd == 0) break;
    unlink<Game>((int)R[g.actions()].z, nd, a);
    sign = -sign;
  }
}

// The end of a round along one descent's path: each edge's W sum added to
// its W and zeroed with the edge's takes. A later path through the same
// edge adds the zeroed sum, +0, which leaves W as it is.
template <class Game>
__device__ __forceinline__ void round_apply(const Game& g, float4* T, float2* V, const Leaf& L) {
  const int rec = g.record();
  int nd = L.last, a = L.last_a;
  for (;;) {
    float4* R = node_at(T, nd, rec);
    float2* Vn = rnd_at(V, nd, rec);
    R[a].y = __fadd_rn(R[a].y, Vn[a].x);
    Vn[a] = make_float2(0.f, 0.f);
    if (nd == 0) break;
    unlink<Game>((int)R[g.actions()].z, nd, a);
  }
}

template <class Game>
__device__ __forceinline__ void write_root(const Game& g, const float4* T, float* counts,
                                           float* rootw) {
  for (int a = 0; a < g.actions(); ++a) {
    counts[a] = T[a].x;
    rootw[a] = T[a].y;
  }
}

// ---- G lanes a game (the uniform kernels) -----------------------------------
// `e` is the lane's cell (lane % G), `g0` the group's first lane in the
// warp. Every function here is called by all 32 lanes of the warp; `live`
// says whether the lane's game takes part. Lanes 0..A-1 own the edges, lane
// A the meta cell; lanes past A (Gomoku's A + 1 < G) own nothing and score
// kNoEdge. The butterflies span the group's G lanes, the ballots are masked
// to them.

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// The smallest edge lane of the group where `pred` holds (0 where none).
__device__ __forceinline__ int group_first(bool pred, int g0, unsigned edge_lanes) {
  const unsigned bits = (__ballot_sync(kFullMask, pred) >> g0) & edge_lanes;
  return bits ? __ffs(bits) - 1 : 0;
}

// The lane's cell of a node, zeros where the lane has no access.
__device__ __forceinline__ float4 group_load(const float4* T, int node, int rec, bool live, int e) {
  return live ? node_at(T, node, rec)[e] : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The lane's PUCT score of its edge at a node whose cell it holds in c.
template <int G>
__device__ __forceinline__ float group_score(float4 c, int e, int A, float cpuct) {
  const float sq = __fsqrt_rn(__fadd_rn(group_sum<G>(e < A ? c.x : 0.f), kPuctEps));
  return e < A ? puct_score(c.x, c.y, c.z, sq, cpuct) : kNoEdge;
}

// The group's step along edge a with child code `code`: the board and the
// leaf's fields, and whether the descent goes on (to node = code). It has
// no branch: the games of a warp end their descents at other steps, and
// selects keep them from diverging there.
template <class Game>
__device__ __forceinline__ bool group_step(const Game& g, Leaf& L, int& node, int a, float code,
                                           int max_depth) {
  g.step(L.mine, L.theirs, a);
  L.last = node;
  L.last_a = a;
  L.depth += 1;
  L.term = code < -1.5f;              // terminal child: back up its value
  L.exp = !L.term && code < -0.5f;    // unexpanded edge: expand
  L.leaf = L.term ? (int)(-2.f - code) : L.leaf;
  const bool on = !L.term && !L.exp && L.depth < max_depth;   // else the cutoff: back up 0
  node = on ? (int)code : node;
  return on;
}

// descend, a group a game.
template <class Game, int G>
__device__ __forceinline__ Leaf group_descend(const Game& g, const float4* T, bool live,
                                              uint64_t root_mine, uint64_t root_theirs,
                                              int max_depth, float cpuct, int e, int g0) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false, false};
  const int A = g.actions(), rec = g.record();
  const bool mine = g.in_record(e);
  int node = 0;
  bool walking = live;
  while (__ballot_sync(kFullMask, walking)) {
    const float4 c = group_load(T, node, rec, walking && mine, e);
    const float s = group_score<G>(c, e, A, cpuct);
    const int a = group_first(s == group_max<G>(s), g0, (1u << A) - 1);
    const float code = __shfl_sync(kFullMask, c.w, g0 + a);
    if (walking) walking = group_step(g, L, node, a, code, max_depth);
  }
  return L;
}

// descend_round, a group a game: the round's takes of edge e are .y of lane
// e's cell of the node's round record.
template <class Game, int G>
__device__ __forceinline__ Leaf group_descend_round(const Game& g, const float4* T, float2* V,
                                                    bool live, uint64_t root_mine,
                                                    uint64_t root_theirs, int max_depth,
                                                    float cpuct, int e, int g0) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false, false};
  const int A = g.actions(), rec = g.record();
  const unsigned edges = (1u << A) - 1;
  const bool mine = g.in_record(e);
  int node = 0;
  bool walking = live;
  while (__ballot_sync(kFullMask, walking)) {
    const float4 c = group_load(T, node, rec, walking && mine, e);
    const float taken = walking && mine ? rnd_at(V, node, rec)[e].y : 0.f;
    const float s = group_score<G>(c, e, A, cpuct);
    const int ba = group_first(s == group_max<G>(s), g0, edges);
    const float s2 = e == ba ? kNoEdge : s;   // the other edges
    const float second = group_max<G>(s2);
    const int sa = group_first(s2 == second, g0, edges);
    const float tb = __shfl_sync(kFullMask, taken, g0 + ba);
    const float ts = __shfl_sync(kFullMask, taken, g0 + sa);
    const bool use2 = second > -1e29f && ts < tb;
    const int a = use2 ? sa : ba;
    const float code = __shfl_sync(kFullMask, c.w, g0 + a);
    if (walking) {
      const float before = use2 ? ts : tb;
      if (e == a) rnd_at(V, node, rec)[a].y = __fadd_rn(before, 1.f);
      walking = group_step(g, L, node, a, code, max_depth);
      L.dup = L.exp && before > 0.5f;   // an expansion the round took before
    }
  }
  return L;
}

// finish_leaf, a group a game: the install is lane e's cell of slot s
// (lane A the child's done, tval and link) and the parent's code, written
// by the lane of the edge. p_e is the lane's prior of the leaf board.
template <class Game, int G>
__device__ __forceinline__ float group_finish_leaf(const Game& g, float4* T, const Leaf& L,
                                                   bool live, int s, int C, float p_e, float v_nn,
                                                   int e, int g0) {
  const int A = g.actions(), rec = g.record();
  float tval = 0.f;   // the terminal child's, read by lane A, which owns it
  if (live && L.term && e == A) tval = node_at(T, L.leaf, rec)[A].y;
  tval = __shfl_sync(kFullMask, tval, g0 + A);
  bool cdone;
  float ctval;
  g.template group_terminal<G>(L.mine, L.theirs, e, g0, &cdone, &ctval);
  if (L.term) return tval;
  if (!L.exp) return 0.f;
  if (live && s < C && g.in_record(e)) {
    node_at(T, s, rec)[e] = e < A ? fresh_edge(p_e)
                                  : make_float4(cdone ? 1.f : 0.f, ctval,
                                                link_of<Game>(L.last, L.last_a), 0.f);
    if (e == L.last_a) node_at(T, L.last, rec)[e].w = cdone ? (float)(-2 - s) : (float)s;
  }
  return leaf_value(cdone, ctval, v_nn);
}

// A walk of a descent's path up the parent links, last edge first: at
// each node nd the lane of the edge calls visit(nd, d), d the step's index
// from the last edge; lane A reads the link and shuffles it to the group.
template <class Game, class Visit>
__device__ __forceinline__ void group_walk(const Game& g, float4* T, const Leaf& L, bool live,
                                           int e, int g0, Visit visit) {
  const int A = g.actions(), rec = g.record();
  int nd = L.last, a = L.last_a, d = 0;
  bool walking = live;
  while (__ballot_sync(kFullMask, walking)) {
    float link = 0.f;
    if (walking) {
      if (e == a) visit(nd, d);
      if (e == A) link = node_at(T, nd, rec)[A].z;
    }
    link = __shfl_sync(kFullMask, link, g0 + A);
    if (walking) {
      walking = nd != 0;
      unlink<Game>((int)link, nd, a);
      d += 1;
    }
  }
}

// backup, a group a game.
template <class Game>
__device__ __forceinline__ void group_backup(const Game& g, float4* T, const Leaf& L, bool live,
                                             float v_leaf, int e, int g0) {
  const int rec = g.record();
  const float psign = (L.depth & 1) ? -1.f : 1.f;  // (-1)^depth
  const float mval = __fmul_rn(v_leaf, psign);
  group_walk(g, T, L, live, e, g0, [&](int nd, int d) {
    const float sign = (d & 1) ? psign : -psign;   // (-1)^(depth - 1 - d)
    float2* nw = reinterpret_cast<float2*>(node_at(T, nd, rec) + e);   // (n, w) of the edge
    float2 v = *nw;
    v.x = __fadd_rn(v.x, 1.f);
    v.y = __fadd_rn(v.y, __fmul_rn(mval, sign));
    *nw = v;
  });
}

// round_backup, a group a game.
template <class Game>
__device__ __forceinline__ void group_round_backup(const Game& g, float4* T, float2* V,
                                                   const Leaf& L, bool live, float v_leaf, int e,
                                                   int g0) {
  const int rec = g.record();
  const float psign = (L.depth & 1) ? -1.f : 1.f;
  const float mval = __fmul_rn(v_leaf, psign);
  group_walk(g, T, L, live, e, g0, [&](int nd, int d) {
    const float sign = (d & 1) ? psign : -psign;
    float4* R = node_at(T, nd, rec) + e;
    float2* sum = rnd_at(V, nd, rec) + e;
    R->x = __fadd_rn(R->x, 1.f);
    sum->x = __fadd_rn(sum->x, __fmul_rn(mval, sign));
  });
}

// round_apply, a group a game.
template <class Game>
__device__ __forceinline__ void group_round_apply(const Game& g, float4* T, float2* V,
                                                  const Leaf& L, bool live, int e, int g0) {
  const int rec = g.record();
  group_walk(g, T, L, live, e, g0, [&](int nd, int) {
    float4* R = node_at(T, nd, rec) + e;
    float2* sum = rnd_at(V, nd, rec) + e;
    R->y = __fadd_rn(R->y, sum->x);
    *sum = make_float2(0.f, 0.f);
  });
}

// The group's game b: its root in slot 0 (lane e writes its cell), the
// root board in every lane, and whether the search runs (b < B, root not
// done).
template <class Game>
__device__ __forceinline__ bool group_init_root(const Game& g, float4* T, const float* boards,
                                                const float* priors, int b, int B, int e,
                                                uint64_t& mine, uint64_t& theirs) {
  const int A = g.actions();
  mine = theirs = 0;
  if (b >= B) return false;
  g.load(boards + (size_t)b * g.cells(), mine, theirs);
  bool done;
  float tval;
  g.terminal(mine, theirs, &done, &tval);
  if (g.in_record(e))
    T[e] = e < A ? fresh_edge(priors[(size_t)b * A + e])
                 : make_float4(done ? 1.f : 0.f, tval, -1.f, 0.f);
  return !done;
}

template <class Game>
__device__ __forceinline__ void group_write_root(const Game& g, const float4* T, int b, int B,
                                                 int e, float* counts, float* rootw) {
  const int A = g.actions();
  if (b < B && e < A) {
    const float4 c = T[e];
    counts[(size_t)b * A + e] = c.x;
    rootw[(size_t)b * A + e] = c.y;
  }
}

// ---- the evaluator plans of the MLP kernels ----------------------------------
// The resident/staged plan (MlpWeights: Connect-Four, today's widths) and
// the streamed one (MlpStream: any board, width and depth); see mlp.cuh.

struct ResidentPlan {
  using Weights = MlpWeights;
  using Shared = MlpShared;
  static __device__ __forceinline__ Shared shared(const Weights&, uint4* smem) {
    return mlp_shared(smem);
  }
  static __device__ __forceinline__ void preload(const Weights& m, const Shared& s) {
    mlp_preload(m, s);
  }
  template <class Game>
  static __device__ __forceinline__ void input(const Weights&, const Shared& s, int t, const Game&,
                                               uint64_t mine, uint64_t theirs) {
    mlp_input(s.act[0][t], mine, theirs);
  }
  static __device__ __forceinline__ void eval(const Weights& m, const Shared& s) {
    mlp_block_eval(m, s);
  }
  static __device__ __forceinline__ const float* out(const Weights&, const Shared& s, int t) {
    return s.out[t];
  }
};

struct StreamPlan {
  using Weights = MlpStream;
  using Shared = MlpStreamShared;
  static __device__ __forceinline__ Shared shared(const Weights& m, uint4* smem) {
    return mlp_stream_shared(m, smem);
  }
  static __device__ __forceinline__ void preload(const Weights&, const Shared&) {}
  template <class Game>
  static __device__ __forceinline__ void input(const Weights& m, const Shared& s, int t,
                                               const Game& g, uint64_t mine, uint64_t theirs) {
    mlp_input_cells(s.act + (size_t)t * m.stride, mine, theirs, g.cells());
  }
  static __device__ __forceinline__ void eval(const Weights& m, const Shared& s) {
    mlp_stream_eval(m, s);
  }
  static __device__ __forceinline__ const float* out(const Weights& m, const Shared& s, int t) {
    return s.out + t * m.head;
  }
};

// ---- kernels -------------------------------------------------------------

template <class Game, int G>
__global__ void fused_kernel(const float* __restrict__ boards,
                             const float* __restrict__ priors,
                             const Game game,
                             float* __restrict__ tree,
                             float* __restrict__ counts,
                             float* __restrict__ rootw,
                             int B, int C, int num_sims, int max_depth,
                             float cpuct, float uval) {
  constexpr int kGames = kThreads / G;
  const int lane = threadIdx.x % 32, e = lane % G, g0 = lane - e;
  const int b = blockIdx.x * kGames + threadIdx.x / G;   // a padding game idles
  float4* T = reinterpret_cast<float4*>(tree) + (size_t)(b < B ? b : 0) * C * game.record();
  uint64_t root_mine, root_theirs;
  const bool live = group_init_root(game, T, boards, priors, b, B, e, root_mine, root_theirs);
  if (__ballot_sync(kFullMask, live)) {
    for (int i = 0; i < num_sims; ++i) {
      const Leaf L = group_descend<Game, G>(game, T, live, root_mine, root_theirs, max_depth,
                                            cpuct, e, g0);
      const float p_e = L.exp ? uniform_p(game, L.mine, L.theirs, e) : 0.f;
      const float v = group_finish_leaf<Game, G>(game, T, L, live, i + 1, C, p_e, uval, e, g0);
      group_backup(game, T, L, live, v, e, g0);
    }
  }
  group_write_root(game, T, b, B, e, counts, rootw);
}

template <class Game, class Plan>
__global__ void fused_mlp_kernel(const float* __restrict__ boards,
                                 const float* __restrict__ priors,
                                 const typename Plan::Weights m,
                                 const Game game,
                                 float* __restrict__ tree,
                                 float* __restrict__ counts,
                                 float* __restrict__ rootw,
                                 int B, int C, int num_sims, int max_depth, float cpuct) {
  extern __shared__ uint4 mlp_smem[];
  const typename Plan::Shared s = Plan::shared(m, mlp_smem);
  const int A = game.actions();
  const int t = threadIdx.x;
  const int b = blockIdx.x * kG + t;
  const bool owner = t < kG && b < B;  // the thread that walks game b
  float4* T = owner ? reinterpret_cast<float4*>(tree) + (size_t)b * C * game.record() : nullptr;
  uint64_t root_mine = 0, root_theirs = 0;
  bool rdone = true;
  if (owner)
    init_root(game, T, boards + (size_t)b * game.cells(), priors + (size_t)b * A, root_mine,
              root_theirs, rdone);
  Plan::preload(m, s);
  const bool live = owner && !rdone;
  for (int i = 0; i < num_sims; ++i) {
    Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false};
    if (live) L = descend(game, T, root_mine, root_theirs, max_depth, cpuct);
    if (t < kG) Plan::input(m, s, t, game, L.mine, L.theirs);
    __syncthreads();
    Plan::eval(m, s);
    if (live) {
      float pm[Game::kActions], v_nn = 0.f;
      if (L.exp) mlp_prior(game, Plan::out(m, s, t), L.mine, L.theirs, pm, &v_nn);
      backup(game, T, L, finish_leaf(game, T, L, i + 1, C, pm, v_nn));
    }
  }
  if (owner) write_root(game, T, counts + (size_t)b * A, rootw + (size_t)b * A);
}

// K>1 rounds, a group a game. A game's K leaves of a round are kept in
// shared memory (K <= kMaxRoundK) or, in the Gomoku instances above, in the
// leaf scratch the wrapper allocates: K leaves a game, indexed by the
// game's place in the grid (padding games included).
template <class Game, int G>
__global__ void fused_rounds_kernel(const float* __restrict__ boards,
                                    const float* __restrict__ priors,
                                    const Game game,
                                    float* __restrict__ tree,
                                    float* __restrict__ rnd,
                                    Leaf* __restrict__ wide_leaves,
                                    float* __restrict__ counts,
                                    float* __restrict__ rootw,
                                    int B, int C, int K, int rounds, int max_depth,
                                    float cpuct, float uval) {
  constexpr int kGames = kThreads / G;
  __shared__ Leaf leaves[kGames][kMaxRoundK];   // the round's K leaves of each game
  const int lane = threadIdx.x % 32, e = lane % G, g0 = lane - e;
  const int gi = blockIdx.x * kGames + threadIdx.x / G;   // the game's place in the grid
  Leaf* kept = leaves[threadIdx.x / G];
  if constexpr (Game::kWide) {
    if (K > kMaxRoundK) kept = wide_leaves + (size_t)gi * K;
  }
  const int b = gi;   // a padding game idles
  const size_t cells = (size_t)(b < B ? b : 0) * C * game.record();
  float4* T = reinterpret_cast<float4*>(tree) + cells;
  float2* V = reinterpret_cast<float2*>(rnd) + cells;
  uint64_t root_mine, root_theirs;
  const bool live = group_init_root(game, T, boards, priors, b, B, e, root_mine, root_theirs);
  if (live && game.in_record(e)) V[e] = make_float2(0.f, 0.f);
  if (__ballot_sync(kFullMask, live)) {
    for (int r = 0; r < rounds; ++r) {
      __syncwarp();   // the last round's reads of `kept` are done
      for (int k = 0; k < K; ++k) {
        const Leaf L = group_descend_round<Game, G>(game, T, V, live, root_mine, root_theirs,
                                                    max_depth, cpuct, e, g0);
        if (e == 0) kept[k] = L;
      }
      __syncwarp();
      for (int k = 0; k < K; ++k) {
        const Leaf L = kept[k];
        const int s = L.dup ? C : r * K + 1 + k;   // a duplicate installs nothing
        if (live && L.exp && s < C && game.in_record(e))
          rnd_at(V, s, game.record())[e] = make_float2(0.f, 0.f);
        const float p_e = L.exp ? uniform_p(game, L.mine, L.theirs, e) : 0.f;
        const float v = group_finish_leaf<Game, G>(game, T, L, live, s, C, p_e, uval, e, g0);
        group_round_backup(game, T, V, L, live, v, e, g0);
      }
      for (int k = 0; k < K; ++k) group_round_apply(game, T, V, kept[k], live, e, g0);
    }
  }
  group_write_root(game, T, b, B, e, counts, rootw);
}

// K>1 rounds, a thread a game. Each owner keeps its K leaves in a local
// array (K <= kMaxRoundK, which ptxas places in the stack frame) or, in the
// Gomoku instance, in the leaf scratch: K leaves a game, indexed by the
// game's place in the grid.
template <class Game, class Plan>
__global__ void fused_mlp_rounds_kernel(const float* __restrict__ boards,
                                        const float* __restrict__ priors,
                                        const typename Plan::Weights m,
                                        const Game game,
                                        float* __restrict__ tree,
                                        float* __restrict__ rnd,
                                        Leaf* __restrict__ wide_leaves,
                                        float* __restrict__ counts,
                                        float* __restrict__ rootw,
                                        int B, int C, int K, int rounds, int max_depth,
                                        float cpuct) {
  extern __shared__ uint4 mlp_smem[];
  const typename Plan::Shared s = Plan::shared(m, mlp_smem);
  const int A = game.actions(), rec = game.record();
  const int t = threadIdx.x;
  const int b = blockIdx.x * kG + t;
  const bool owner = t < kG && b < B;  // the thread that walks game b
  float4* T = owner ? reinterpret_cast<float4*>(tree) + (size_t)b * C * rec : nullptr;
  float2* V = owner ? reinterpret_cast<float2*>(rnd) + (size_t)b * C * rec : nullptr;
  uint64_t root_mine = 0, root_theirs = 0;
  bool rdone = true;
  if (owner) {
    init_root(game, T, boards + (size_t)b * game.cells(), priors + (size_t)b * A, root_mine,
              root_theirs, rdone);
    zero_round_record(game, V);
  }
  Plan::preload(m, s);
  const bool live = owner && !rdone;
  for (int r = 0; r < rounds; ++r) {
    Leaf local[kMaxRoundK];
    Leaf* L = local;
    if constexpr (Game::kWide) L = wide_leaves + (size_t)(t < kG ? b : 0) * K;
    if (t < kG) {
      for (int k = 0; k < K; ++k) {
        L[k] = Leaf{root_mine, root_theirs, 0, 0, 0, -1, false, false, false};
        if (live) L[k] = descend_round(game, T, V, root_mine, root_theirs, max_depth, cpuct);
      }
    }
    for (int k = 0; k < K; ++k) {  // descent k's 32 leaves, evaluated together
      if (t < kG) Plan::input(m, s, t, game, L[k].mine, L[k].theirs);
      __syncthreads();
      Plan::eval(m, s);
      if (live) {
        float pm[Game::kActions], v_nn = 0.f;
        if (L[k].exp) mlp_prior(game, Plan::out(m, s, t), L[k].mine, L[k].theirs, pm, &v_nn);
        round_backup(game, T, V, L[k],
                     finish_round_leaf(game, T, V, L[k], r * K + 1 + k, C, pm, v_nn));
      }
    }
    if (live) {
      for (int k = 0; k < K; ++k) round_apply(game, T, V, L[k]);
    }
  }
  if (owner) write_root(game, T, counts + (size_t)b * A, rootw + (size_t)b * A);
}

// The evaluator alone on a batch of boards (for checking it against its
// plain version): logits, masked prior and value of each board.
template <class Game, class Plan>
__global__ void mlp_eval_kernel(const float* __restrict__ boards, const typename Plan::Weights m,
                                const Game game, float* __restrict__ logits,
                                float* __restrict__ pm, float* __restrict__ value, int B) {
  extern __shared__ uint4 mlp_smem[];
  const typename Plan::Shared s = Plan::shared(m, mlp_smem);
  const int A = game.actions();
  const int t = threadIdx.x;
  const int b = blockIdx.x * kG + t;
  const bool owner = t < kG && b < B;
  uint64_t mine = 0, theirs = 0;
  if (owner) game.load(boards + (size_t)b * game.cells(), mine, theirs);
  Plan::preload(m, s);
  if (t < kG) Plan::input(m, s, t, game, mine, theirs);
  __syncthreads();
  Plan::eval(m, s);
  if (owner) {
    const float* out = Plan::out(m, s, t);
    float p[Game::kActions], v;
    mlp_prior(game, out, mine, theirs, p, &v);
#pragma unroll
    for (int a = 0; a < Game::kActions; ++a) {
      if (a < A) {
        logits[(size_t)b * A + a] = out[a];
        pm[(size_t)b * A + a] = p[a];
      }
    }
    value[b] = v;
  }
}

unsigned int blocks_for(size_t items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

// ---- launches: one per kernel template, every instance through it --------

template <class Game, int G>
int launch_fused(const float* boards, const float* priors, const Game& game, float* tree,
                 float* counts, float* rootw, int B, int C, int num_sims, int max_depth,
                 float cpuct, float uval, void* stream) {
  fused_kernel<Game, G><<<blocks_for(B, kThreads / G), kThreads, 0,
                          (cudaStream_t)stream>>>(boards, priors, game, tree, counts, rootw,
                                                  B, C, num_sims, max_depth, cpuct, uval);
  return (int)cudaGetLastError();
}

template <class Game, int G>
int launch_fused_rounds(const float* boards, const float* priors, const Game& game, float* tree,
                        float* rnd, void* leaves, float* counts, float* rootw, int B, int C, int K,
                        int num_sims, int max_depth, float cpuct, float uval, void* stream) {
  fused_rounds_kernel<Game, G><<<blocks_for(B, kThreads / G), kThreads, 0,
                                 (cudaStream_t)stream>>>(boards, priors, game, tree, rnd,
                                                         static_cast<Leaf*>(leaves), counts,
                                                         rootw, B, C, K, num_sims / K,
                                                         max_depth, cpuct, uval);
  return (int)cudaGetLastError();
}

template <class Game, class Plan>
int launch_fused_mlp(const float* boards, const float* priors, const typename Plan::Weights& m,
                     const Game& game, float* tree, float* counts, float* rootw, int B, int C,
                     int num_sims, int max_depth, float cpuct, void* stream) {
  const int smem = m.smem_bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<Game, Plan>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_kernel<Game, Plan><<<blocks_for(B, kG), kMlpThreads, smem,
                                 (cudaStream_t)stream>>>(boards, priors, m, game, tree, counts,
                                                         rootw, B, C, num_sims, max_depth, cpuct);
  return (int)cudaGetLastError();
}

template <class Game, class Plan>
int launch_fused_mlp_rounds(const float* boards, const float* priors,
                            const typename Plan::Weights& m, const Game& game, float* tree,
                            float* rnd, void* leaves, float* counts, float* rootw, int B, int C,
                            int K, int num_sims, int max_depth, float cpuct, void* stream) {
  const int smem = m.smem_bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_rounds_kernel<Game, Plan>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_rounds_kernel<Game, Plan><<<blocks_for(B, kG), kMlpThreads, smem,
                                        (cudaStream_t)stream>>>(boards, priors, m, game, tree, rnd,
                                                                static_cast<Leaf*>(leaves),
                                                                counts, rootw, B, C, K,
                                                                num_sims / K, max_depth, cpuct);
  return (int)cudaGetLastError();
}

template <class Game, class Plan>
int launch_mlp_eval(const float* boards, const typename Plan::Weights& m, const Game& game,
                    float* logits, float* pm, float* value, int B, void* stream) {
  const int smem = m.smem_bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_eval_kernel<Game, Plan>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mlp_eval_kernel<Game, Plan><<<blocks_for(B, kG), kMlpThreads, smem,
                                (cudaStream_t)stream>>>(boards, m, game, logits, pm, value, B);
  return (int)cudaGetLastError();
}

// The small-Gomoku game of A cells and its lines, or an invalid value.
bool small_gomoku(int A, const unsigned* lines, int n_lines, SmallGomoku* g) {
  if (A < 1 || A > kMaxSmallCells || n_lines < 0 || (n_lines > 0 && lines == nullptr)) return false;
  *g = SmallGomoku{A, n_lines, reinterpret_cast<const uint32_t*>(lines)};
  return true;
}

// (K+1)^A < 2^24, the reference's rule for the round records' packing.
bool rounds_fit(int K, int A, int num_sims) {
  if (K < 1 || num_sims % K != 0) return false;
  double p = 1.0;
  for (int a = 0; a < A; ++a) p *= (double)(K + 1);
  return p < 16777216.0;
}

}  // namespace

// Linked into one library with hybrid.cu, whose az_error_string serves both.
extern "C" {

int az_fused(const float* boards, const float* priors, float* tree,
             float* counts, float* rootw, int B, int C, int num_sims,
             int max_depth, float cpuct, float uval, void* stream) {
  return launch_fused<C4Game, 8>(boards, priors, C4Game{}, tree, counts, rootw, B, C, num_sims,
                                 max_depth, cpuct, uval, stream);
}

// `sections`: the addresses of the weights of n_hidden hidden layers of
// widths h0..h3 (mlp_weights; the wrapper checks their shapes and that
// 1 <= n_hidden <= 4, every width <= 256). The launch takes the dynamic
// shared memory of mlp_weights' plan (az_mlp_plan).
int az_fused_mlp(const float* boards, const float* priors, const void* const* sections,
                 float* tree, float* counts, float* rootw, int B, int C,
                 int num_sims, int max_depth, int n_hidden, int h0, int h1,
                 int h2, int h3, float cpuct, void* stream) {
  const int hidden[kMaxHidden] = {h0, h1, h2, h3};
  const MlpWeights m = mlp_weights(sections, n_hidden, hidden);
  return launch_fused_mlp<C4Game, ResidentPlan>(boards, priors, m, C4Game{}, tree, counts, rootw,
                                                B, C, num_sims, max_depth, cpuct, stream);
}

// K > 1 leaf-parallel rounds: `rnd` is the round-record scratch, f32[B, C, 16] (R = 8).
int az_fused_rounds(const float* boards, const float* priors, float* tree, float* rnd,
                    float* counts, float* rootw, int B, int C, int K, int num_sims,
                    int max_depth, float cpuct, float uval, void* stream) {
  if (K < 1 || K > kMaxRoundK || num_sims % K != 0) return (int)cudaErrorInvalidValue;
  return launch_fused_rounds<C4Game, 8>(boards, priors, C4Game{}, tree, rnd, nullptr, counts,
                                        rootw, B, C, K, num_sims, max_depth, cpuct, uval, stream);
}

int az_fused_mlp_rounds(const float* boards, const float* priors, const void* const* sections,
                        float* tree, float* rnd, float* counts, float* rootw, int B, int C,
                        int K, int num_sims, int max_depth, int n_hidden, int h0, int h1,
                        int h2, int h3, float cpuct, void* stream) {
  if (K < 1 || K > kMaxRoundK || num_sims % K != 0) return (int)cudaErrorInvalidValue;
  const int hidden[kMaxHidden] = {h0, h1, h2, h3};
  const MlpWeights m = mlp_weights(sections, n_hidden, hidden);
  return launch_fused_mlp_rounds<C4Game, ResidentPlan>(boards, priors, m, C4Game{}, tree, rnd,
                                                       nullptr, counts, rootw, B, C, K, num_sims,
                                                       max_depth, cpuct, stream);
}

int az_mlp_eval(const float* boards, const void* const* sections, float* logits,
                float* pm, float* value, int B, int n_hidden, int h0, int h1,
                int h2, int h3, void* stream) {
  const int hidden[kMaxHidden] = {h0, h1, h2, h3};
  const MlpWeights m = mlp_weights(sections, n_hidden, hidden);
  return launch_mlp_eval<C4Game, ResidentPlan>(boards, m, C4Game{}, logits, pm, value, B, stream);
}

// The evaluator's shared-memory plan for n_hidden layers of widths
// h0..h3: the dynamic bytes of a launch, and in *resident whether every
// layer's weights stay in shared memory for it (1) or are staged (0).
int az_mlp_plan(int n_hidden, int h0, int h1, int h2, int h3, int* resident) {
  const int hidden[kMaxHidden] = {h0, h1, h2, h3};
  const void* sections[2 * kMaxHidden + 2] = {};
  const MlpWeights m = mlp_weights(sections, n_hidden, hidden);
  *resident = m.resident ? 1 : 0;
  return m.smem_bytes;
}

// ---- Gomoku boards of at most 16 cells; the streamed evaluator ------------
// `lines`: the win lines' cell masks (device memory), n_lines of them;
// `leaves`: the rounds' leaf scratch, az_fused_leaf_bytes() x K a game for
// every game of the grid (B rounded up to 32), used where K > kMaxRoundK
// (uniform) or always (the MLP). The group width G is the smallest power
// of two >= A + 1: 8 lanes up to A = 7, 16 up to 15, a warp at A = 16.

int az_fused_leaf_bytes() { return (int)sizeof(Leaf); }

int az_fused_gomoku(const float* boards, const float* priors, const unsigned* lines, int n_lines,
                    float* tree, float* counts, float* rootw, int B, int C, int A, int num_sims,
                    int max_depth, float cpuct, float uval, void* stream) {
  SmallGomoku g;
  if (!small_gomoku(A, lines, n_lines, &g)) return (int)cudaErrorInvalidValue;
  if (A < 8)
    return launch_fused<SmallGomoku, 8>(boards, priors, g, tree, counts, rootw, B, C, num_sims,
                                        max_depth, cpuct, uval, stream);
  if (A < 16)
    return launch_fused<SmallGomoku, 16>(boards, priors, g, tree, counts, rootw, B, C, num_sims,
                                         max_depth, cpuct, uval, stream);
  return launch_fused<SmallGomoku, 32>(boards, priors, g, tree, counts, rootw, B, C, num_sims,
                                       max_depth, cpuct, uval, stream);
}

int az_fused_gomoku_rounds(const float* boards, const float* priors, const unsigned* lines,
                           int n_lines, float* tree, float* rnd, void* leaves, float* counts,
                           float* rootw, int B, int C, int A, int K, int num_sims, int max_depth,
                           float cpuct, float uval, void* stream) {
  SmallGomoku g;
  if (!small_gomoku(A, lines, n_lines, &g) || !rounds_fit(K, A, num_sims) ||
      (K > kMaxRoundK && leaves == nullptr))
    return (int)cudaErrorInvalidValue;
  if (A < 8)
    return launch_fused_rounds<SmallGomoku, 8>(boards, priors, g, tree, rnd, leaves, counts, rootw,
                                               B, C, K, num_sims, max_depth, cpuct, uval, stream);
  if (A < 16)
    return launch_fused_rounds<SmallGomoku, 16>(boards, priors, g, tree, rnd, leaves, counts,
                                                rootw, B, C, K, num_sims, max_depth, cpuct, uval,
                                                stream);
  return launch_fused_rounds<SmallGomoku, 32>(boards, priors, g, tree, rnd, leaves, counts, rootw,
                                              B, C, K, num_sims, max_depth, cpuct, uval, stream);
}

// The streamed evaluator's plan for a board of `cells` cells, A = head - 1
// actions and hidden widths hidden[0..n_hidden-1] (a host array, any
// length, 0 too): the dynamic shared bytes of a launch, and in
// *act_block_bytes the activation scratch a block needs in device memory
// (0 while the activations fit shared memory).
int az_mlp_stream_plan(int cells, int head, const int* hidden, int n_hidden,
                       long long* act_block_bytes) {
  const MlpStream m = mlp_stream(nullptr, n_hidden, hidden, 2 * cells, head, nullptr, nullptr,
                                 nullptr);
  *act_block_bytes = m.act_block_bytes;
  return m.smem_bytes;
}

// The streamed MLP kernels. `layers`: the hidden layers' descriptors in
// device memory (MlpLayer, int64 [n_hidden, 3]); `hidden`: their widths, a
// host array; `act`: the activation scratch (az_mlp_stream_plan's bytes a
// block, for blocks_for(B, 32) blocks) or null when it needs none. A null
// `lines` is Connect-Four (A = 7); else Gomoku of A <= 16 cells.
int az_fused_mlp_stream(const float* boards, const float* priors, const void* layers,
                        const int* hidden, int n_hidden, const float* wh, const float* bh,
                        void* act, const unsigned* lines, int n_lines, float* tree, float* counts,
                        float* rootw, int B, int C, int A, int num_sims, int max_depth,
                        float cpuct, void* stream) {
  if (lines == nullptr) {
    if (A != kCols) return (int)cudaErrorInvalidValue;
    const MlpStream m = mlp_stream(layers, n_hidden, hidden, 2 * kCells, kCols + 1, wh, bh, act);
    return launch_fused_mlp<C4Game, StreamPlan>(boards, priors, m, C4Game{}, tree, counts, rootw,
                                                B, C, num_sims, max_depth, cpuct, stream);
  }
  SmallGomoku g;
  if (!small_gomoku(A, lines, n_lines, &g)) return (int)cudaErrorInvalidValue;
  const MlpStream m = mlp_stream(layers, n_hidden, hidden, 2 * A, A + 1, wh, bh, act);
  return launch_fused_mlp<SmallGomoku, StreamPlan>(boards, priors, m, g, tree, counts, rootw, B,
                                                   C, num_sims, max_depth, cpuct, stream);
}

int az_fused_mlp_stream_rounds(const float* boards, const float* priors, const void* layers,
                               const int* hidden, int n_hidden, const float* wh, const float* bh,
                               void* act, const unsigned* lines, int n_lines, float* tree,
                               float* rnd, void* leaves, float* counts, float* rootw, int B, int C,
                               int A, int K, int num_sims, int max_depth, float cpuct,
                               void* stream) {
  if (lines == nullptr) {
    if (A != kCols || K > kMaxRoundK || !rounds_fit(K, A, num_sims))
      return (int)cudaErrorInvalidValue;
    const MlpStream m = mlp_stream(layers, n_hidden, hidden, 2 * kCells, kCols + 1, wh, bh, act);
    return launch_fused_mlp_rounds<C4Game, StreamPlan>(boards, priors, m, C4Game{}, tree, rnd,
                                                       nullptr, counts, rootw, B, C, K, num_sims,
                                                       max_depth, cpuct, stream);
  }
  SmallGomoku g;
  if (!small_gomoku(A, lines, n_lines, &g) || !rounds_fit(K, A, num_sims) || leaves == nullptr)
    return (int)cudaErrorInvalidValue;
  const MlpStream m = mlp_stream(layers, n_hidden, hidden, 2 * A, A + 1, wh, bh, act);
  return launch_fused_mlp_rounds<SmallGomoku, StreamPlan>(boards, priors, m, g, tree, rnd, leaves,
                                                          counts, rootw, B, C, K, num_sims,
                                                          max_depth, cpuct, stream);
}

int az_mlp_eval_stream(const float* boards, const void* layers, const int* hidden, int n_hidden,
                       const float* wh, const float* bh, void* act, const unsigned* lines,
                       int n_lines, float* logits, float* pm, float* value, int B, int A,
                       void* stream) {
  if (lines == nullptr) {
    if (A != kCols) return (int)cudaErrorInvalidValue;
    const MlpStream m = mlp_stream(layers, n_hidden, hidden, 2 * kCells, kCols + 1, wh, bh, act);
    return launch_mlp_eval<C4Game, StreamPlan>(boards, m, C4Game{}, logits, pm, value, B, stream);
  }
  SmallGomoku g;
  if (!small_gomoku(A, lines, n_lines, &g)) return (int)cudaErrorInvalidValue;
  const MlpStream m = mlp_stream(layers, n_hidden, hidden, 2 * A, A + 1, wh, bh, act);
  return launch_mlp_eval<SmallGomoku, StreamPlan>(boards, m, g, logits, pm, value, B, stream);
}

}  // extern "C"
