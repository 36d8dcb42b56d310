// Fused search kernels for Hopper (sm_90a): every simulation of a search in
// one launch. One copy of the search (the device functions below) serves
// two evaluators:
// * az_fused: a constant (uniform) prior and value;
// * az_fused_mlp: MLPNet, evaluated inside the kernel by mlp.cuh.
//
// Replaces the Pallas `kernel` of make_fused_root_fn
// (alphazero_tpu/mcts/fused.py:156) on its K=1 path: sim_body (:282-426)
// and refresh_best (:220-256), pallas_call at :670, with the uniform
// evaluator (:380-383) or the in-kernel MLP (:384-388, the K3 eval_fn of
// alphazero_tpu/models/nets.py:129), and the Connect-Four FlatOps traced
// into it (here the helpers of c4.cuh). The plain PyTorch versions are
// fused_search and fused_mlp_search in alphazero_tpu_torch/mcts/fused.py;
// each kernel must agree with its plain version bit for bit.
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
//   the JAX kernel's block does: in each simulation threads 0..31 walk
//   their games' descents and write the leaf boards' input rows to shared
//   memory; the whole block evaluates the 32 leaves (mlp.cuh); threads
//   0..31 then install and back up. A game that does not expand (a
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
// games at 989 TFLOP/s) plus its f32 head; its design does them on the
// CUDA cores in a fixed order (see mlp.cuh), bound by instruction throughput.
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

// Where a simulation's descent ended.
struct Leaf {
  uint64_t mine, theirs;  // the leaf board
  int last, last_a;       // the last edge walked: its node and action
  int depth;              // edges walked
  int leaf;               // the terminal child's slot (term)
  bool exp, term;         // ended at an unexpanded edge / a terminal child
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

// One descent from the root along the PUCT argmax.
__device__ __forceinline__ Leaf descend(const float* T, uint64_t root_mine, uint64_t root_theirs,
                                        int max_depth, float cpuct) {
  Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false};
  int node = 0;
  for (;;) {
    const float* R = T + (size_t)node * kRec;
    float nv[kMaxA], wv[kMaxA], pv[kMaxA], cv[kMaxA];
#pragma unroll
    for (int a = 0; a < kMaxA; ++a) {
      const bool edge = a < kA;
      nv[a] = edge ? R[kN + a] : 0.f;
      wv[a] = edge ? R[kW + a] : 0.f;
      pv[a] = edge ? R[kP + a] : 0.f;
      cv[a] = edge ? R[kCode + a] : 0.f;
    }
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
  __shared__ __nv_bfloat16 act[2][kG][kMaxWidth];
  __shared__ float out[kG][kHead];
  const int t = threadIdx.x;
  const int b = blockIdx.x * kG + t;
  const bool owner = t < kG && b < B;  // the thread that walks game b
  float* T = owner ? tree + (size_t)b * C * kRec : nullptr;
  uint64_t root_mine = 0, root_theirs = 0;
  bool rdone = true;
  if (owner)
    init_root(T, boards + (size_t)b * kCells, priors + (size_t)b * kA, root_mine, root_theirs,
              rdone);
  const bool live = owner && !rdone;
  for (int i = 0; i < num_sims; ++i) {
    Leaf L{root_mine, root_theirs, 0, 0, 0, -1, false, false};
    if (live) L = descend(T, root_mine, root_theirs, max_depth, cpuct);
    if (t < kG) mlp_input(act[0][t], L.mine, L.theirs);
    __syncthreads();
    mlp_block_eval(m, act, out);
    if (live) {
      float pm[kA], v_nn = 0.f;
      if (L.exp) mlp_prior(out[t], L.mine, L.theirs, pm, &v_nn);
      backup(T, L, finish_leaf(T, L, i + 1, C, pm, v_nn));
    }
  }
  if (owner) write_root(T, counts + (size_t)b * kA, rootw + (size_t)b * kA);
}

// The evaluator alone on a batch of boards (for checking it against its
// plain version): logits, masked prior and value of each board.
__global__ void mlp_eval_kernel(const float* __restrict__ boards, MlpWeights m,
                                float* __restrict__ logits, float* __restrict__ pm,
                                float* __restrict__ value, int B) {
  __shared__ __nv_bfloat16 act[2][kG][kMaxWidth];
  __shared__ float out[kG][kHead];
  const int t = threadIdx.x;
  const int b = blockIdx.x * kG + t;
  const bool owner = t < kG && b < B;
  uint64_t mine = 0, theirs = 0;
  if (owner) c4_load(boards + (size_t)b * kCells, mine, theirs);
  if (t < kG) mlp_input(act[0][t], mine, theirs);
  __syncthreads();
  mlp_block_eval(m, act, out);
  if (owner) {
    float p[kA], v;
    mlp_prior(out[t], mine, theirs, p, &v);
    for (int a = 0; a < kA; ++a) {
      logits[(size_t)b * kA + a] = out[t][a];
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
// 1 <= n_hidden <= 4, every width <= 256).
int az_fused_mlp(const float* boards, const float* priors, const void* const* sections,
                 float* tree, float* counts, float* rootw, int B, int C,
                 int num_sims, int max_depth, int n_hidden, int h0, int h1,
                 int h2, int h3, float cpuct, void* stream) {
  const int hidden[kMaxHidden] = {h0, h1, h2, h3};
  const MlpWeights m = mlp_weights(sections, n_hidden, hidden);
  fused_mlp_kernel<<<blocks_for(B, kG), kMlpThreads, 0,
                     (cudaStream_t)stream>>>(boards, priors, m, tree, counts,
                                             rootw, B, C, num_sims, max_depth,
                                             cpuct);
  return (int)cudaGetLastError();
}

int az_mlp_eval(const float* boards, const void* const* sections, float* logits,
                float* pm, float* value, int B, int n_hidden, int h0, int h1,
                int h2, int h3, void* stream) {
  const int hidden[kMaxHidden] = {h0, h1, h2, h3};
  const MlpWeights m = mlp_weights(sections, n_hidden, hidden);
  mlp_eval_kernel<<<blocks_for(B, kG), kMlpThreads, 0,
                    (cudaStream_t)stream>>>(boards, m, logits, pm, value, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
