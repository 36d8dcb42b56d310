// Fused search kernels for Hopper (sm_90a): every simulation of a search in
// one launch. One copy of the search (the device functions below) serves
// two evaluators, each at K=1 and in K>1 leaf-parallel rounds:
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
// Design: the tree lives in device-memory scratch the wrapper allocates,
// f32[B, C, 32]: one 128-byte record per node, four rows of 8 lanes, A = 7
// edges in lanes 0..6 of each
//   row 0: n[a],    lane 7 done
//   row 1: w[a],    lane 7 tval
//   row 2: p[a],    lane 7 parent link (parent slot * 8 + action; -1 root)
//   row 3: code[a], lane 7 unused
// so a descent step reads one line. Only slot 0 is initialised: a slot is
// read only after the simulation that installs it links it in.
// * No best-action planes: the descent computes a node's PUCT argmax from
//   its record when it arrives there. A node's argmax is a function of its
//   own record, and the JAX kernel refreshes every node after each merge,
//   so the argmax read here equals the one the reference's planes hold.
// * No path record: the backup walks from the last edge to the root along
//   the parent links that each install writes (the tree has no
//   transpositions), so no depth limit is needed beyond max_depth itself.
// * az_fused runs one thread per game, blocks of 128 games.
// * az_fused_mlp runs blocks of 32 games and 256 threads in lockstep, as
//   the JAX kernel's block does: at kernel start the block copies the MLP's
//   biases, and its weights when they fit, into dynamic shared memory
//   (mlp_preload); in each simulation threads 0..31 walk their games'
//   descents and write the leaf boards' input rows to shared memory; the
//   whole block evaluates the 32 leaves on the tensor cores (mlp.cuh);
//   threads 0..31 then install and back up. A game that does not expand (a
//   terminal child, the cutoff, a done root, a padding game b >= B) still
//   passes through the evaluation and its result is discarded. No thread
//   returns early: every thread reaches every __syncthreads().
//
// What bounds them on an H100: az_fused moves only boards and priors in
// and counts and root W out (16.5 MB at B=65536, ~5 us at 3.35 TB/s), and
// its arithmetic is ~68 f32 operations per descent step. What holds it is
// latency: each descent step is a dependent 128-byte load from device
// memory, and each thread walks its own game. Keeping the trees in shared
// memory (12.9 KB per game at C=101) is the redesign for a later change.
// az_fused_mlp's bound is the MLP's bf16 operations (174,080 per
// expansion at (256, 256), ~72 us for a 100-simulation search of 4096
// games at 989 TFLOP/s) plus its f32 head. The evaluator does them with
// mma.sync on the tensor cores from weights that stay in shared memory for
// the launch (mlp.cuh), a few microseconds a simulation, so what holds the
// MLP kernels is again the owner threads' dependent tree loads, 32 walkers
// a block, one block per SM (its 222,720 bytes of shared memory).
//
// K>1 rounds (parallel_sims = K, round_body): round r's K descents run one
// after another in the game's thread, each from the root, all on the tree as
// it stood at the start of the round; then the K leaves are finished in k
// order (descent k installs at slot r*K + 1 + k while that is < C, unless it
// is a duplicate) and backed up. What differs from K=1:
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
//   the wrapper allocates: lanes 0..6 the round's W sum of each edge,
//   lanes 8..14 its takes. (The reference packs the takes base-(K+1) into
//   one f32 lane, a layout trick; only its limit (K+1)^A < 2^24, K <= 9 at
//   A = 7, is kept.) A node's round record is zeroed when it is made and
//   along each path after each round.
// * Rounding order: the JAX merge adds w + w_add once per edge, with w_add
//   the round's terms mval_k * (-1)^d summed in k order from 0. Backing up
//   each descent in turn would round otherwise wherever two paths share an
//   edge (the root edges nearly always). So the backup walks path k up the
//   parent links adding n += 1 (exact in any order) and its term to the
//   edge's W sum in the round record; a second walk of every path adds each
//   sum to W and zeroes it, so a later path through the same edge adds +0,
//   which leaves W as it is (W is never -0).
// * az_fused_rounds runs one thread per game, blocks of 128 games, as
//   az_fused; az_fused_mlp_rounds runs K block evaluations per round, one
//   per descent k in k order, every thread reaching every __syncthreads().
//   Each owner thread keeps its K leaves (40 bytes each) in a local array,
//   which ptxas places in the stack frame.
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

constexpr int kThreads = 128;
constexpr int kA = kCols;        // Connect-Four's 7 actions
constexpr int kRec = 32;         // floats per node record
constexpr int kN = 0, kW = 8, kP = 16, kCode = 24;  // row offsets
constexpr int kDone = kN + 7, kTval = kW + 7, kLink = kP + 7;
constexpr int kMaxRoundK = 9;    // descents per round: (K+1)^7 < 2^24 (kernels.FUSED_MAX_K)
constexpr int kRnd = 16;         // floats per node of the round record
constexpr int kSum = 0, kTaken = 8;  // its lanes: each edge's W sum, its takes

// Where a simulation's descent ended.
struct Leaf {
  uint64_t mine, theirs;  // the leaf board
  int last, last_a;       // the last edge walked: its node and action
  int depth;              // edges walked
  int leaf;               // the terminal child's slot (term)
  bool exp, term;         // ended at an unexpanded edge / a terminal child
  bool dup;               // exp at an edge this round already took (rounds)
};

// The root in slot 0 with the masked prior, no visits and no children.
__device__ __forceinline__ void init_root(float* T, const float* board, const float* prior,
                                          uint64_t& mine, uint64_t& theirs, bool& done) {
  c4_load(board, mine, theirs);
  float tval;
  c4_terminal(mine, theirs, &done, &tval);
  for (int a = 0; a < kA; ++a) {
    T[kN + a] = 0.f;
    T[kW + a] = 0.f;
    T[kP + a] = prior[a];
    T[kCode + a] = -1.f;
  }
  T[kDone] = done ? 1.f : 0.f;
  T[kTval] = tval;
  T[kLink] = -1.f;
  T[kCode + 7] = 0.f;
}

// A node's edges from its record, into registers.
__device__ __forceinline__ void load_edges(const float* R, float (&nv)[kMaxA], float (&wv)[kMaxA],
                                           float (&pv)[kMaxA], float (&cv)[kMaxA]) {
#pragma unroll
  for (int a = 0; a < kMaxA; ++a) {
    const bool edge = a < kA;
    nv[a] = edge ? R[kN + a] : 0.f;
    wv[a] = edge ? R[kW + a] : 0.f;
    pv[a] = edge ? R[kP + a] : 0.f;
    cv[a] = edge ? R[kCode + a] : 0.f;
  }
}

// One descent from the root along the PUCT argmax.
__device__ __forceinline__ Leaf descend(const float* T, uint64_t root_mine, uint64_t root_theirs,
                                        int max_depth, float cpuct) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false};
  int node = 0;
  for (;;) {
    float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
    load_edges(T + (size_t)node * kRec, nv, wv, pv, cv);
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

// The uniform evaluator's prior of the leaf board.
__device__ __forceinline__ void uniform_prior(const Leaf& L, float (&pm)[kA]) {
  int n_valid = 0;
  for (int a = 0; a < kA; ++a) n_valid += c4_valid(L.mine, L.theirs, a) ? 1 : 0;
  const float prior = __fdiv_rn(1.f, (float)(n_valid > 0 ? n_valid : 1));
  for (int a = 0; a < kA; ++a) pm[a] = c4_valid(L.mine, L.theirs, a) ? prior : kInvalidP;
}

// The leaf value of simulation s; an expansion also installs the child at
// slot s (while s < C) with the prior pm and links it to its parent edge.
// pm and v_nn (the evaluator's value of the leaf board) are read only on
// an expansion.
__device__ __forceinline__ float finish_leaf(float* T, const Leaf& L, int s, int C,
                                             const float (&pm)[kA], float v_nn) {
  if (L.term) return T[(size_t)L.leaf * kRec + kTval];
  if (!L.exp) return 0.f;
  bool cdone;
  float ctval;
  c4_terminal(L.mine, L.theirs, &cdone, &ctval);
  const float cd = cdone ? 1.f : 0.f;
  if (s < C) {
    float* S = T + (size_t)s * kRec;
    for (int a = 0; a < kA; ++a) {
      S[kN + a] = 0.f;
      S[kW + a] = 0.f;
      S[kP + a] = pm[a];
      S[kCode + a] = -1.f;
    }
    S[kDone] = cd;
    S[kTval] = ctval;
    S[kLink] = (float)(L.last * 8 + L.last_a);
    S[kCode + 7] = 0.f;
    T[(size_t)L.last * kRec + kCode + L.last_a] = cdone ? (float)(-2 - s) : (float)s;
  }
  return __fadd_rn(ctval, __fmul_rn(1.f - cd, v_nn - ctval));
}

// Backup along the parent links, last edge first.
__device__ __forceinline__ void backup(float* T, const Leaf& L, float v_leaf) {
  const float psign = (L.depth & 1) ? -1.f : 1.f;  // (-1)^depth
  const float mval = __fmul_rn(v_leaf, psign);
  float sign = -psign;                              // (-1)^(depth - 1)
  int nd = L.last, a = L.last_a;
  for (;;) {
    float* R = T + (size_t)nd * kRec;
    R[kN + a] = __fadd_rn(R[kN + a], 1.f);
    R[kW + a] = __fadd_rn(R[kW + a], __fmul_rn(mval, sign));
    if (nd == 0) break;
    const int link = (int)R[kLink];
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
__device__ __forceinline__ Leaf descend_round(const float* T, float* V, uint64_t root_mine,
                                              uint64_t root_theirs, int max_depth, float cpuct) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false, false};
  int node = 0;
  for (;;) {
    float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
    load_edges(T + (size_t)node * kRec, nv, wv, pv, cv);
    float total = 0.f;
#pragma unroll
    for (int a = 0; a < kA; ++a) total = __fadd_rn(total, nv[a]);  // integers: exact
    const float sq = __fsqrt_rn(__fadd_rn(total, kPuctEps));
    Top2 t{};
#pragma unroll
    for (int a = 0; a < kA; ++a) top2_push(t, a, puct_score(nv[a], wv[a], pv[a], sq, cpuct), cv[a]);
    float* taken = V + (size_t)node * kRnd + kTaken;
    const bool use2 = t.second > -1e29f && taken[(int)t.sec_a] < taken[(int)t.best_a];
    const int a = (int)(use2 ? t.sec_a : t.best_a);
    const float code = use2 ? t.sec_code : t.best_code;
    const float before = taken[a];
    taken[a] = __fadd_rn(before, 1.f);
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

__device__ __forceinline__ void zero_round_record(float* Vn) {
  for (int a = 0; a < kA; ++a) {
    Vn[kSum + a] = 0.f;
    Vn[kTaken + a] = 0.f;
  }
}

// finish_leaf for descent k of round r, at slot s = r*K + 1 + k; an install
// also zeroes the new node's round record. A duplicate is finished as an
// expansion past the last slot: its value without an install.
__device__ __forceinline__ float finish_round_leaf(float* T, float* V, const Leaf& L, int s, int C,
                                                   const float (&pm)[kA], float v_nn) {
  if (L.dup) s = C;
  if (L.exp && s < C) zero_round_record(V + (size_t)s * kRnd);
  return finish_leaf(T, L, s, C, pm, v_nn);
}

// A round's backup of one descent, walking its path as backup does: n += 1
// on each edge, and the descent's term mval * (-1)^d added to the edge's W
// sum in the round record, so each sum is taken in k order from 0.
__device__ __forceinline__ void round_backup(float* T, float* V, const Leaf& L, float v_leaf) {
  const float psign = (L.depth & 1) ? -1.f : 1.f;
  const float mval = __fmul_rn(v_leaf, psign);
  float sign = -psign;
  int nd = L.last, a = L.last_a;
  for (;;) {
    float* R = T + (size_t)nd * kRec;
    float* sum = V + (size_t)nd * kRnd + kSum;
    R[kN + a] = __fadd_rn(R[kN + a], 1.f);
    sum[a] = __fadd_rn(sum[a], __fmul_rn(mval, sign));
    if (nd == 0) break;
    const int link = (int)R[kLink];
    nd = link >> 3;
    a = link & 7;
    sign = -sign;
  }
}

// The end of a round along one descent's path: each edge's W sum added to
// its W and zeroed with the edge's takes. A later path through the same
// edge adds the zeroed sum, +0, which leaves W as it is.
__device__ __forceinline__ void round_apply(float* T, float* V, const Leaf& L) {
  int nd = L.last, a = L.last_a;
  for (;;) {
    float* R = T + (size_t)nd * kRec;
    float* Vn = V + (size_t)nd * kRnd;
    R[kW + a] = __fadd_rn(R[kW + a], Vn[kSum + a]);
    Vn[kSum + a] = 0.f;
    Vn[kTaken + a] = 0.f;
    if (nd == 0) break;
    const int link = (int)R[kLink];
    nd = link >> 3;
    a = link & 7;
  }
}

__device__ __forceinline__ void write_root(const float* T, float* counts, float* rootw) {
  for (int a = 0; a < kA; ++a) {
    counts[a] = T[kN + a];
    rootw[a] = T[kW + a];
  }
}

__global__ void fused_kernel(const float* __restrict__ boards,
                             const float* __restrict__ priors,
                             float* __restrict__ tree,
                             float* __restrict__ counts,
                             float* __restrict__ rootw,
                             int B, int C, int num_sims, int max_depth,
                             float cpuct, float uval) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // this kernel has no barrier
  float* T = tree + (size_t)b * C * kRec;
  uint64_t root_mine, root_theirs;
  bool rdone;
  init_root(T, boards + (size_t)b * kCells, priors + (size_t)b * kA, root_mine, root_theirs, rdone);
  for (int i = 0; i < num_sims && !rdone; ++i) {
    const Leaf L = descend(T, root_mine, root_theirs, max_depth, cpuct);
    float pm[kA];
    if (L.exp) uniform_prior(L, pm);
    backup(T, L, finish_leaf(T, L, i + 1, C, pm, uval));
  }
  write_root(T, counts + (size_t)b * kA, rootw + (size_t)b * kA);
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
  float* T = owner ? tree + (size_t)b * C * kRec : nullptr;
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
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;  // this kernel has no barrier
  float* T = tree + (size_t)b * C * kRec;
  float* V = rnd + (size_t)b * C * kRnd;
  uint64_t root_mine, root_theirs;
  bool rdone;
  init_root(T, boards + (size_t)b * kCells, priors + (size_t)b * kA, root_mine, root_theirs, rdone);
  zero_round_record(V);
  for (int r = 0; r < rounds && !rdone; ++r) {
    Leaf L[kMaxRoundK];
    for (int k = 0; k < K; ++k) L[k] = descend_round(T, V, root_mine, root_theirs, max_depth, cpuct);
    for (int k = 0; k < K; ++k) {
      float pm[kA];
      if (L[k].exp) uniform_prior(L[k], pm);
      round_backup(T, V, L[k], finish_round_leaf(T, V, L[k], r * K + 1 + k, C, pm, uval));
    }
    for (int k = 0; k < K; ++k) round_apply(T, V, L[k]);
  }
  write_root(T, counts + (size_t)b * kA, rootw + (size_t)b * kA);
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
  float* T = owner ? tree + (size_t)b * C * kRec : nullptr;
  float* V = owner ? rnd + (size_t)b * C * kRnd : nullptr;
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
  fused_kernel<<<blocks_for(B, kThreads), kThreads, 0,
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
  fused_rounds_kernel<<<blocks_for(B, kThreads), kThreads, 0,
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
