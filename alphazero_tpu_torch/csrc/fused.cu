// Fused search kernels for Hopper (sm_90a): every simulation of a search in
// one launch. One search serves two evaluators, each at K=1 and in K>1
// leaf-parallel rounds:
// * az_fused, az_fused_rounds: a constant (uniform) prior and value;
// * az_fused_mlp, az_fused_mlp_rounds: MLPNet, evaluated inside the kernel
//   by mlp.cuh.
//
// Replaces the Pallas `kernel` of make_fused_root_fn
// (alphazero_tpu/mcts/fused.py:156), pallas_call at :670: on its K=1 path
// sim_body (:282-426) and refresh_best (:220-256); on its K>1 path (K2)
// round_body (:428-639) and refresh_best's top-2 branch (:258-277); with
// the uniform evaluator (:380-383, :553-556) or the in-kernel MLP (:384-388,
// :557-561, the K3 eval_fn of alphazero_tpu/models/nets.py:129), and the
// Connect-Four FlatOps traced into it (here the helpers of c4.cuh). The
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
// f32[B, C, 32]: one 128-byte record per node, edge-major, eight 16-byte
// cells
//   cell a = 0..6: (n[a], w[a], p[a], code[a])   edge a of A = 7
//   cell 7:        (done, tval, link, 0)         link = parent slot * 8 +
//                                                action, -1 at the root
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
// az_fused and az_fused_rounds: eight lanes a game, four games a warp.
// Lane e of a game's group owns cell e of every node of its tree (and of
// its round record): it alone reads and writes that cell, so the lanes
// share nothing through memory and meet only in shuffles.
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
//   tests a lane, gathered by a ballot (group_terminal).
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
//   eight after a __syncwarp.
// Trees in shared memory (12.9 KB a game at C=101) were not taken: ~17
// games an SM, 29 waves of latency-bound walks at B=65536.
//
// az_fused_mlp and az_fused_mlp_rounds keep one thread a game: blocks of
// 32 games and 256 threads in lockstep, as the JAX kernel's block does. At
// kernel start the block copies the MLP's biases, and its weights when
// they fit, into dynamic shared memory (mlp_preload); in each simulation
// threads 0..31 walk their games' descents, reading a node as eight
// 128-bit loads, and write the leaf boards' input rows to shared memory;
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
//   record of 16 floats per node in a second scratch, f32[B, C, 16], that
//   the wrapper allocates, edge-major as the tree: cell a = (the round's W
//   sum of edge a, its takes), cell 7 unused. (The reference packs the
//   takes base-(K+1) into one f32 lane, a layout trick; only its limit
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
//   ptxas places in the stack frame.
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
#include "mlp.cuh"

namespace {

constexpr int kThreads = 128;    // a block of the uniform kernels
constexpr int kLanes = 8;        // lanes a game in the uniform kernels: one a cell
constexpr int kGames = kThreads / kLanes;   // 16 games a block
constexpr int kA = kCols;        // Connect-Four's 7 actions
constexpr int kNodeCells = 8;    // 16-byte cells per node record (and round record)
constexpr int kMeta = kA;        // cell 7: (done, tval, link, 0)
constexpr int kMaxRoundK = 9;    // descents per round: (K+1)^7 < 2^24 (kernels.FUSED_MAX_K)
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kEdgeLanes = (1u << kA) - 1;   // a group's lanes 0..6
constexpr float kNoEdge = -3.0e38f;  // lane 7's score: below every edge's, -1e30 too

// Where a simulation's descent ended.
struct Leaf {
  uint64_t mine, theirs;  // the leaf board
  int last, last_a;       // the last edge walked: its node and action
  int depth;              // edges walked
  int leaf;               // the terminal child's slot (term)
  bool exp, term;         // ended at an unexpanded edge / a terminal child
  bool dup;               // exp at an edge this round already took (rounds)
};

__device__ __forceinline__ float4 fresh_edge(float p) { return make_float4(0.f, 0.f, p, -1.f); }

__device__ __forceinline__ float4* node_at(float4* T, int node) {
  return T + (size_t)node * kNodeCells;
}
__device__ __forceinline__ const float4* node_at(const float4* T, int node) {
  return T + (size_t)node * kNodeCells;
}
__device__ __forceinline__ float2* rnd_at(float2* V, int node) {
  return V + (size_t)node * kNodeCells;
}

// The uniform evaluator's prior of edge a of a board: 1/n_valid on the
// valid edges, kInvalidP elsewhere.
__device__ __forceinline__ float uniform_p(uint64_t mine, uint64_t theirs, int a) {
  const int n_valid = kA - __popcll(c4_full_columns(mine, theirs));
  const float prior = __fdiv_rn(1.f, (float)(n_valid > 0 ? n_valid : 1));
  return c4_valid(mine, theirs, a) ? prior : kInvalidP;
}

__device__ __forceinline__ float leaf_value(bool cdone, float ctval, float v_nn) {
  const float cd = cdone ? 1.f : 0.f;
  return __fadd_rn(ctval, __fmul_rn(1.f - cd, v_nn - ctval));
}

// ---- one thread a game (the MLP kernels) ---------------------------------

// The root in slot 0 with the masked prior, no visits and no children.
__device__ __forceinline__ void init_root(float4* T, const float* board, const float* prior,
                                          uint64_t& mine, uint64_t& theirs, bool& done) {
  c4_load(board, mine, theirs);
  float tval;
  c4_terminal(mine, theirs, &done, &tval);
  for (int a = 0; a < kA; ++a) T[a] = fresh_edge(prior[a]);
  T[kMeta] = make_float4(done ? 1.f : 0.f, tval, -1.f, 0.f);
}

// A node's edges from its record, into registers.
__device__ __forceinline__ void load_edges(const float4* R, float (&nv)[kMaxA], float (&wv)[kMaxA],
                                           float (&pv)[kMaxA], float (&cv)[kMaxA]) {
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) {
    const float4 c = a < kA ? R[a] : make_float4(0.f, 0.f, 0.f, 0.f);
    nv[a] = c.x;
    wv[a] = c.y;
    pv[a] = c.z;
    cv[a] = c.w;
  }
}

// One descent from the root along the PUCT argmax.
__device__ __forceinline__ Leaf descend(const float4* T, uint64_t root_mine, uint64_t root_theirs,
                                        int max_depth, float cpuct) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false};
  int node = 0;
  for (;;) {
    float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
    load_edges(node_at(T, node), nv, wv, pv, cv);
    float af, code;
    refresh_node(nv, wv, pv, cv, kA, cpuct, &af, &code);
    const int a = (int)af;
    c4_step(L.mine, L.theirs, a);
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
__device__ __forceinline__ float finish_leaf(float4* T, const Leaf& L, int s, int C,
                                             const float (&pm)[kA], float v_nn) {
  if (L.term) return node_at(T, L.leaf)[kMeta].y;
  if (!L.exp) return 0.f;
  bool cdone;
  float ctval;
  c4_terminal(L.mine, L.theirs, &cdone, &ctval);
  if (s < C) {
    float4* S = node_at(T, s);
    for (int a = 0; a < kA; ++a) S[a] = fresh_edge(pm[a]);
    S[kMeta] = make_float4(cdone ? 1.f : 0.f, ctval, (float)(L.last * 8 + L.last_a), 0.f);
    node_at(T, L.last)[L.last_a].w = cdone ? (float)(-2 - s) : (float)s;
  }
  return leaf_value(cdone, ctval, v_nn);
}

// Backup along the parent links, last edge first.
__device__ __forceinline__ void backup(float4* T, const Leaf& L, float v_leaf) {
  const float psign = (L.depth & 1) ? -1.f : 1.f;  // (-1)^depth
  const float mval = __fmul_rn(v_leaf, psign);
  float sign = -psign;                              // (-1)^(depth - 1)
  int nd = L.last, a = L.last_a;
  for (;;) {
    float4* R = node_at(T, nd);
    R[a].x = __fadd_rn(R[a].x, 1.f);
    R[a].y = __fadd_rn(R[a].y, __fmul_rn(mval, sign));
    if (nd == 0) break;
    const int link = (int)R[kMeta].z;
    nd = link >> 3;
    a = link & 7;
    sign = -sign;
  }
}

// One descent of a round from the root. At each node it takes the top-2
// PUCT actions of the node's record, which no descent of the round has
// changed, and the runner-up when one exists and the round has taken it
// fewer times than the best action (round_body's use2 = has2 * (v2 < v1),
// fused.py:494-495); it counts its take in the node's round record V.
__device__ __forceinline__ Leaf descend_round(const float4* T, float2* V, uint64_t root_mine,
                                              uint64_t root_theirs, int max_depth, float cpuct) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false, false};
  int node = 0;
  for (;;) {
    float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
    load_edges(node_at(T, node), nv, wv, pv, cv);
    float total = 0.f;
#pragma unroll
    for (int a = 0; a < kA; ++a) total = __fadd_rn(total, nv[a]);  // integers: exact
    const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
    Top2 t{};
#pragma unroll
    for (int a = 0; a < kA; ++a) top2_push(t, a, puct_score(nv[a], wv[a], pv[a], sq, cpuct), cv[a]);
    float2* Vn = rnd_at(V, node);
    const bool use2 = t.second > -1e29f && Vn[(int)t.sec_a].y < Vn[(int)t.best_a].y;
    const int a = (int)(use2 ? t.sec_a : t.best_a);
    const float code = use2 ? t.sec_code : t.best_code;
    const float before = Vn[a].y;
    Vn[a].y = __fadd_rn(before, 1.f);
    c4_step(L.mine, L.theirs, a);
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

__device__ __forceinline__ void zero_round_record(float2* Vn) {
  for (int a = 0; a < kA; ++a) Vn[a] = make_float2(0.f, 0.f);
}

// finish_leaf for descent k of round r, at slot s = r*K + 1 + k; an install
// also zeroes the new node's round record. A duplicate is finished as an
// expansion past the last slot: its value without an install.
__device__ __forceinline__ float finish_round_leaf(float4* T, float2* V, const Leaf& L, int s,
                                                   int C, const float (&pm)[kA], float v_nn) {
  if (L.dup) s = C;
  if (L.exp && s < C) zero_round_record(rnd_at(V, s));
  return finish_leaf(T, L, s, C, pm, v_nn);
}

// A round's backup of one descent, walking its path as backup does: n += 1
// on each edge, and the descent's term mval * (-1)^d added to the edge's W
// sum in the round record, so each sum is taken in k order from 0.
__device__ __forceinline__ void round_backup(float4* T, float2* V, const Leaf& L, float v_leaf) {
  const float psign = (L.depth & 1) ? -1.f : 1.f;
  const float mval = __fmul_rn(v_leaf, psign);
  float sign = -psign;
  int nd = L.last, a = L.last_a;
  for (;;) {
    float4* R = node_at(T, nd);
    float2* Vn = rnd_at(V, nd);
    R[a].x = __fadd_rn(R[a].x, 1.f);
    Vn[a].x = __fadd_rn(Vn[a].x, __fmul_rn(mval, sign));
    if (nd == 0) break;
    const int link = (int)R[kMeta].z;
    nd = link >> 3;
    a = link & 7;
    sign = -sign;
  }
}

// The end of a round along one descent's path: each edge's W sum added to
// its W and zeroed with the edge's takes. A later path through the same
// edge adds the zeroed sum, +0, which leaves W as it is.
__device__ __forceinline__ void round_apply(float4* T, float2* V, const Leaf& L) {
  int nd = L.last, a = L.last_a;
  for (;;) {
    float4* R = node_at(T, nd);
    float2* Vn = rnd_at(V, nd);
    R[a].y = __fadd_rn(R[a].y, Vn[a].x);
    Vn[a] = make_float2(0.f, 0.f);
    if (nd == 0) break;
    const int link = (int)R[kMeta].z;
    nd = link >> 3;
    a = link & 7;
  }
}

__device__ __forceinline__ void write_root(const float4* T, float* counts, float* rootw) {
  for (int a = 0; a < kA; ++a) {
    counts[a] = T[a].x;
    rootw[a] = T[a].y;
  }
}

// ---- eight lanes a game (the uniform kernels) ----------------------------
// `e` is the lane's cell (lane % 8), `g0` the group's first lane in the
// warp. Every function here is called by all 32 lanes of the warp; `live`
// says whether the lane's game takes part.

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

// The smallest edge lane of the group where `pred` holds (0 where none).
__device__ __forceinline__ int group_first(bool pred, int g0) {
  const unsigned bits = (__ballot_sync(kFullMask, pred) >> g0) & kEdgeLanes;
  return bits ? __ffs(bits) - 1 : 0;
}

// The lane's cell of a node, zeros where the lane has no access.
__device__ __forceinline__ float4 group_load(const float4* T, int node, bool live, int e) {
  return live ? node_at(T, node)[e] : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The lane's PUCT score of its edge at a node whose cell it holds in c.
__device__ __forceinline__ float group_score(float4 c, int e, float cpuct) {
  const float sq = __fsqrt_rn(__fadd_rn(group_sum(e < kA ? c.x : 0.f), kPuctEps));
  return e < kA ? puct_score(c.x, c.y, c.z, sq, cpuct) : kNoEdge;
}

// The group's step along edge a with child code `code`: the board and the
// leaf's fields, and whether the descent goes on (to node = code). It has
// no branch: the four games of a warp end their descents at other steps,
// and selects keep them from diverging there.
__device__ __forceinline__ bool group_step(Leaf& L, int& node, int a, float code, int max_depth) {
  c4_step(L.mine, L.theirs, a);
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
__device__ __forceinline__ Leaf group_descend(const float4* T, bool live, uint64_t root_mine,
                                              uint64_t root_theirs, int max_depth, float cpuct,
                                              int e, int g0) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false, false};
  int node = 0;
  bool walking = live;
  while (__ballot_sync(kFullMask, walking)) {
    const float4 c = group_load(T, node, walking, e);
    const float s = group_score(c, e, cpuct);
    const int a = group_first(s == group_max(s), g0);
    const float code = __shfl_sync(kFullMask, c.w, g0 + a);
    if (walking) walking = group_step(L, node, a, code, max_depth);
  }
  return L;
}

// descend_round, a group a game: the round's takes of edge e are .y of lane
// e's cell of the node's round record.
__device__ __forceinline__ Leaf group_descend_round(const float4* T, float2* V, bool live,
                                                    uint64_t root_mine, uint64_t root_theirs,
                                                    int max_depth, float cpuct, int e, int g0) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false, false};
  int node = 0;
  bool walking = live;
  while (__ballot_sync(kFullMask, walking)) {
    const float4 c = group_load(T, node, walking, e);
    const float taken = walking ? rnd_at(V, node)[e].y : 0.f;
    const float s = group_score(c, e, cpuct);
    const int ba = group_first(s == group_max(s), g0);
    const float s2 = e == ba ? kNoEdge : s;   // the other edges
    const float second = group_max(s2);
    const int sa = group_first(s2 == second, g0);
    const float tb = __shfl_sync(kFullMask, taken, g0 + ba);
    const float ts = __shfl_sync(kFullMask, taken, g0 + sa);
    const bool use2 = second > -1e29f && ts < tb;
    const int a = use2 ? sa : ba;
    const float code = __shfl_sync(kFullMask, c.w, g0 + a);
    if (walking) {
      const float before = use2 ? ts : tb;
      if (e == a) rnd_at(V, node)[a].y = __fadd_rn(before, 1.f);
      walking = group_step(L, node, a, code, max_depth);
      L.dup = L.exp && before > 0.5f;   // an expansion the round took before
    }
  }
  return L;
}

// c4_terminal of the group's board, its eight window tests split over the
// lanes: lane e tests c4_four's direction e % 4 (horizontal, vertical, the
// two diagonals) on the side to move (e < 4) or the other, and a ballot
// gathers them.
__device__ __forceinline__ void group_terminal(uint64_t mine, uint64_t theirs, int e, int g0,
                                               bool* done, float* value) {
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

// finish_leaf, a group a game: the install is lane e's cell of slot s
// (lane 7 the child's done, tval and link) and the parent's code, written
// by the lane of the edge. p_e is the lane's prior of the leaf board.
__device__ __forceinline__ float group_finish_leaf(float4* T, const Leaf& L, bool live, int s,
                                                   int C, float p_e, float v_nn, int e, int g0) {
  float tval = 0.f;   // the terminal child's, read by lane 7, which owns it
  if (live && L.term && e == kMeta) tval = node_at(T, L.leaf)[kMeta].y;
  tval = __shfl_sync(kFullMask, tval, g0 + kMeta);
  bool cdone;
  float ctval;
  group_terminal(L.mine, L.theirs, e, g0, &cdone, &ctval);
  if (L.term) return tval;
  if (!L.exp) return 0.f;
  if (live && s < C) {
    node_at(T, s)[e] = e < kA ? fresh_edge(p_e)
                              : make_float4(cdone ? 1.f : 0.f, ctval,
                                            (float)(L.last * 8 + L.last_a), 0.f);
    if (e == L.last_a) node_at(T, L.last)[e].w = cdone ? (float)(-2 - s) : (float)s;
  }
  return leaf_value(cdone, ctval, v_nn);
}

// A walk of a descent's path up the parent links, last edge first: at
// each node nd the lane of the edge calls visit(nd, d), d the step's index
// from the last edge; lane 7 reads the link and shuffles it to the group.
template <class Visit>
__device__ __forceinline__ void group_walk(float4* T, const Leaf& L, bool live, int e, int g0,
                                           Visit visit) {
  int nd = L.last, a = L.last_a, d = 0;
  bool walking = live;
  while (__ballot_sync(kFullMask, walking)) {
    float link = 0.f;
    if (walking) {
      if (e == a) visit(nd, d);
      if (e == kMeta) link = node_at(T, nd)[kMeta].z;
    }
    link = __shfl_sync(kFullMask, link, g0 + kMeta);
    if (walking) {
      walking = nd != 0;
      nd = (int)link >> 3;
      a = (int)link & 7;
      d += 1;
    }
  }
}

// backup, a group a game.
__device__ __forceinline__ void group_backup(float4* T, const Leaf& L, bool live, float v_leaf,
                                             int e, int g0) {
  const float psign = (L.depth & 1) ? -1.f : 1.f;  // (-1)^depth
  const float mval = __fmul_rn(v_leaf, psign);
  group_walk(T, L, live, e, g0, [&](int nd, int d) {
    const float sign = (d & 1) ? psign : -psign;   // (-1)^(depth - 1 - d)
    float2* nw = reinterpret_cast<float2*>(node_at(T, nd) + e);   // (n, w) of the edge
    float2 v = *nw;
    v.x = __fadd_rn(v.x, 1.f);
    v.y = __fadd_rn(v.y, __fmul_rn(mval, sign));
    *nw = v;
  });
}

// round_backup, a group a game.
__device__ __forceinline__ void group_round_backup(float4* T, float2* V, const Leaf& L, bool live,
                                                   float v_leaf, int e, int g0) {
  const float psign = (L.depth & 1) ? -1.f : 1.f;
  const float mval = __fmul_rn(v_leaf, psign);
  group_walk(T, L, live, e, g0, [&](int nd, int d) {
    const float sign = (d & 1) ? psign : -psign;
    float4* R = node_at(T, nd) + e;
    float2* sum = rnd_at(V, nd) + e;
    R->x = __fadd_rn(R->x, 1.f);
    sum->x = __fadd_rn(sum->x, __fmul_rn(mval, sign));
  });
}

// round_apply, a group a game.
__device__ __forceinline__ void group_round_apply(float4* T, float2* V, const Leaf& L, bool live,
                                                  int e, int g0) {
  group_walk(T, L, live, e, g0, [&](int nd, int) {
    float4* R = node_at(T, nd) + e;
    float2* sum = rnd_at(V, nd) + e;
    R->y = __fadd_rn(R->y, sum->x);
    *sum = make_float2(0.f, 0.f);
  });
}

// The group's game b: its root in slot 0 (lane e writes its cell), the
// root board in every lane, and whether the search runs (b < B, root not
// done).
__device__ __forceinline__ bool group_init_root(float4* T, const float* boards,
                                                const float* priors, int b, int B, int e,
                                                uint64_t& mine, uint64_t& theirs) {
  mine = theirs = 0;
  if (b >= B) return false;
  c4_load(boards + (size_t)b * kCells, mine, theirs);
  bool done;
  float tval;
  c4_terminal(mine, theirs, &done, &tval);
  T[e] = e < kA ? fresh_edge(priors[(size_t)b * kA + e])
                : make_float4(done ? 1.f : 0.f, tval, -1.f, 0.f);
  return !done;
}

__device__ __forceinline__ void group_write_root(const float4* T, int b, int B, int e,
                                                 float* counts, float* rootw) {
  if (b < B && e < kA) {
    const float4 c = T[e];
    counts[(size_t)b * kA + e] = c.x;
    rootw[(size_t)b * kA + e] = c.y;
  }
}

// ---- kernels -------------------------------------------------------------

__global__ void fused_kernel(const float* __restrict__ boards,
                             const float* __restrict__ priors,
                             float* __restrict__ tree,
                             float* __restrict__ counts,
                             float* __restrict__ rootw,
                             int B, int C, int num_sims, int max_depth,
                             float cpuct, float uval) {
  const int lane = threadIdx.x % 32, e = lane % kLanes, g0 = lane - e;
  const int b = blockIdx.x * kGames + threadIdx.x / kLanes;   // a padding game idles
  float4* T = reinterpret_cast<float4*>(tree) + (size_t)(b < B ? b : 0) * C * kNodeCells;
  uint64_t root_mine, root_theirs;
  const bool live = group_init_root(T, boards, priors, b, B, e, root_mine, root_theirs);
  if (__ballot_sync(kFullMask, live)) {
    for (int i = 0; i < num_sims; ++i) {
      const Leaf L = group_descend(T, live, root_mine, root_theirs, max_depth, cpuct, e, g0);
      const float p_e = L.exp ? uniform_p(L.mine, L.theirs, e) : 0.f;
      const float v = group_finish_leaf(T, L, live, i + 1, C, p_e, uval, e, g0);
      group_backup(T, L, live, v, e, g0);
    }
  }
  group_write_root(T, b, B, e, counts, rootw);
}

__global__ void fused_mlp_kernel(const float* __restrict__ boards,
                                 const float* __restrict__ priors,
                                 MlpWeights m,
                                 float* __restrict__ tree,
                                 float* __restrict__ counts,
                                 float* __restrict__ rootw,
                                 int B, int C, int num_sims, int max_depth, float cpuct) {
  extern __shared__ uint4 mlp_smem[];
  const MlpShared s = mlp_shared(mlp_smem);
  const int t = threadIdx.x;
  const int b = blockIdx.x * kG + t;
  const bool owner = t < kG && b < B;  // the thread that walks game b
  float4* T = owner ? reinterpret_cast<float4*>(tree) + (size_t)b * C * kNodeCells : nullptr;
  uint64_t root_mine = 0, root_theirs = 0;
  bool rdone = true;
  if (owner)
    init_root(T, boards + (size_t)b * kCells, priors + (size_t)b * kA, root_mine, root_theirs,
              rdone);
  mlp_preload(m, s);
  const bool live = owner && !rdone;
  for (int i = 0; i < num_sims; ++i) {
    Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false};
    if (live) L = descend(T, root_mine, root_theirs, max_depth, cpuct);
    if (t < kG) mlp_input(s.act[0][t], L.mine, L.theirs);
    __syncthreads();
    mlp_block_eval(m, s);
    if (live) {
      float pm[kA], v_nn = 0.f;
      if (L.exp) mlp_prior(s.out[t], L.mine, L.theirs, pm, &v_nn);
      backup(T, L, finish_leaf(T, L, i + 1, C, pm, v_nn));
    }
  }
  if (owner) write_root(T, counts + (size_t)b * kA, rootw + (size_t)b * kA);
}

__global__ void fused_rounds_kernel(const float* __restrict__ boards,
                                    const float* __restrict__ priors,
                                    float* __restrict__ tree,
                                    float* __restrict__ rnd,
                                    float* __restrict__ counts,
                                    float* __restrict__ rootw,
                                    int B, int C, int K, int rounds, int max_depth,
                                    float cpuct, float uval) {
  __shared__ Leaf leaves[kGames][kMaxRoundK];   // the round's K leaves of each game
  const int lane = threadIdx.x % 32, e = lane % kLanes, g0 = lane - e;
  Leaf* kept = leaves[threadIdx.x / kLanes];
  const int b = blockIdx.x * kGames + threadIdx.x / kLanes;   // a padding game idles
  const size_t cells = (size_t)(b < B ? b : 0) * C * kNodeCells;
  float4* T = reinterpret_cast<float4*>(tree) + cells;
  float2* V = reinterpret_cast<float2*>(rnd) + cells;
  uint64_t root_mine, root_theirs;
  const bool live = group_init_root(T, boards, priors, b, B, e, root_mine, root_theirs);
  if (live) V[e] = make_float2(0.f, 0.f);
  if (__ballot_sync(kFullMask, live)) {
    for (int r = 0; r < rounds; ++r) {
      __syncwarp();   // the last round's reads of `kept` are done
      for (int k = 0; k < K; ++k) {
        const Leaf L = group_descend_round(T, V, live, root_mine, root_theirs, max_depth, cpuct,
                                           e, g0);
        if (e == 0) kept[k] = L;
      }
      __syncwarp();
      for (int k = 0; k < K; ++k) {
        const Leaf L = kept[k];
        const int s = L.dup ? C : r * K + 1 + k;   // a duplicate installs nothing
        if (live && L.exp && s < C) rnd_at(V, s)[e] = make_float2(0.f, 0.f);
        const float p_e = L.exp ? uniform_p(L.mine, L.theirs, e) : 0.f;
        const float v = group_finish_leaf(T, L, live, s, C, p_e, uval, e, g0);
        group_round_backup(T, V, L, live, v, e, g0);
      }
      for (int k = 0; k < K; ++k) group_round_apply(T, V, kept[k], live, e, g0);
    }
  }
  group_write_root(T, b, B, e, counts, rootw);
}

__global__ void fused_mlp_rounds_kernel(const float* __restrict__ boards,
                                        const float* __restrict__ priors,
                                        MlpWeights m,
                                        float* __restrict__ tree,
                                        float* __restrict__ rnd,
                                        float* __restrict__ counts,
                                        float* __restrict__ rootw,
                                        int B, int C, int K, int rounds, int max_depth,
                                        float cpuct) {
  extern __shared__ uint4 mlp_smem[];
  const MlpShared s = mlp_shared(mlp_smem);
  const int t = threadIdx.x;
  const int b = blockIdx.x * kG + t;
  const bool owner = t < kG && b < B;  // the thread that walks game b
  float4* T = owner ? reinterpret_cast<float4*>(tree) + (size_t)b * C * kNodeCells : nullptr;
  float2* V = owner ? reinterpret_cast<float2*>(rnd) + (size_t)b * C * kNodeCells : nullptr;
  uint64_t root_mine = 0, root_theirs = 0;
  bool rdone = true;
  if (owner) {
    init_root(T, boards + (size_t)b * kCells, priors + (size_t)b * kA, root_mine, root_theirs,
              rdone);
    zero_round_record(V);
  }
  mlp_preload(m, s);
  const bool live = owner && !rdone;
  for (int r = 0; r < rounds; ++r) {
    Leaf L[kMaxRoundK];
    if (t < kG) {
      for (int k = 0; k < K; ++k) {
        L[k] = Leaf{root_mine, root_theirs, 0, 0, 0, -1, false, false, false};
        if (live) L[k] = descend_round(T, V, root_mine, root_theirs, max_depth, cpuct);
      }
    }
    for (int k = 0; k < K; ++k) {  // descent k's 32 leaves, evaluated together
      if (t < kG) mlp_input(s.act[0][t], L[k].mine, L[k].theirs);
      __syncthreads();
      mlp_block_eval(m, s);
      if (live) {
        float pm[kA], v_nn = 0.f;
        if (L[k].exp) mlp_prior(s.out[t], L[k].mine, L[k].theirs, pm, &v_nn);
        round_backup(T, V, L[k], finish_round_leaf(T, V, L[k], r * K + 1 + k, C, pm, v_nn));
      }
    }
    if (live) {
      for (int k = 0; k < K; ++k) round_apply(T, V, L[k]);
    }
  }
  if (owner) write_root(T, counts + (size_t)b * kA, rootw + (size_t)b * kA);
}

// The evaluator alone on a batch of boards (for checking it against its
// plain version): logits, masked prior and value of each board.
__global__ void mlp_eval_kernel(const float* __restrict__ boards, MlpWeights m,
                                float* __restrict__ logits, float* __restrict__ pm,
                                float* __restrict__ value, int B) {
  extern __shared__ uint4 mlp_smem[];
  const MlpShared s = mlp_shared(mlp_smem);
  const int t = threadIdx.x;
  const int b = blockIdx.x * kG + t;
  const bool owner = t < kG && b < B;
  uint64_t mine = 0, theirs = 0;
  if (owner) c4_load(boards + (size_t)b * kCells, mine, theirs);
  mlp_preload(m, s);
  if (t < kG) mlp_input(s.act[0][t], mine, theirs);
  __syncthreads();
  mlp_block_eval(m, s);
  if (owner) {
    float p[kA], v;
    mlp_prior(s.out[t], mine, theirs, p, &v);
    for (int a = 0; a < kA; ++a) {
      logits[(size_t)b * kA + a] = s.out[t][a];
      pm[(size_t)b * kA + a] = p[a];
    }
    value[b] = v;
  }
}

unsigned int blocks_for(size_t items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

}  // namespace

// Linked into one library with hybrid.cu, whose az_error_string serves both.
extern "C" {

int az_fused(const float* boards, const float* priors, float* tree,
             float* counts, float* rootw, int B, int C, int num_sims,
             int max_depth, float cpuct, float uval, void* stream) {
  fused_kernel<<<blocks_for(B, kGames), kThreads, 0,
                 (cudaStream_t)stream>>>(boards, priors, tree, counts, rootw,
                                         B, C, num_sims, max_depth, cpuct,
                                         uval);
  return (int)cudaGetLastError();
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
  const int smem = m.smem_bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_kernel<<<blocks_for(B, kG), kMlpThreads, smem,
                     (cudaStream_t)stream>>>(boards, priors, m, tree, counts,
                                             rootw, B, C, num_sims, max_depth,
                                             cpuct);
  return (int)cudaGetLastError();
}

// K > 1 leaf-parallel rounds: `rnd` is the round-record scratch, f32[B, C, 16].
int az_fused_rounds(const float* boards, const float* priors, float* tree, float* rnd,
                    float* counts, float* rootw, int B, int C, int K, int num_sims,
                    int max_depth, float cpuct, float uval, void* stream) {
  if (K < 1 || K > kMaxRoundK || num_sims % K != 0) return (int)cudaErrorInvalidValue;
  fused_rounds_kernel<<<blocks_for(B, kGames), kThreads, 0,
                        (cudaStream_t)stream>>>(boards, priors, tree, rnd, counts, rootw, B,
                                                C, K, num_sims / K, max_depth, cpuct, uval);
  return (int)cudaGetLastError();
}

int az_fused_mlp_rounds(const float* boards, const float* priors, const void* const* sections,
                        float* tree, float* rnd, float* counts, float* rootw, int B, int C,
                        int K, int num_sims, int max_depth, int n_hidden, int h0, int h1,
                        int h2, int h3, float cpuct, void* stream) {
  if (K < 1 || K > kMaxRoundK || num_sims % K != 0) return (int)cudaErrorInvalidValue;
  const int hidden[kMaxHidden] = {h0, h1, h2, h3};
  const MlpWeights m = mlp_weights(sections, n_hidden, hidden);
  const int smem = m.smem_bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_rounds_kernel<<<blocks_for(B, kG), kMlpThreads, smem,
                            (cudaStream_t)stream>>>(boards, priors, m, tree, rnd, counts,
                                                    rootw, B, C, K, num_sims / K, max_depth,
                                                    cpuct);
  return (int)cudaGetLastError();
}

int az_mlp_eval(const float* boards, const void* const* sections, float* logits,
                float* pm, float* value, int B, int n_hidden, int h0, int h1,
                int h2, int h3, void* stream) {
  const int hidden[kMaxHidden] = {h0, h1, h2, h3};
  const MlpWeights m = mlp_weights(sections, n_hidden, hidden);
  const int smem = m.smem_bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mlp_eval_kernel<<<blocks_for(B, kG), kMlpThreads, smem,
                    (cudaStream_t)stream>>>(boards, m, logits, pm, value, B);
  return (int)cudaGetLastError();
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

}  // extern "C"
