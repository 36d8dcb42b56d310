// Fused search kernel for Hopper (sm_90a): every simulation of a search in
// one launch, for a constant (uniform) prior and value.
//
// Replaces the Pallas `kernel` of make_fused_root_fn
// (alphazero_tpu/mcts/fused.py:156) on its K=1 path: sim_body (:282-426)
// and refresh_best (:220-256), pallas_call at :670, with the uniform
// evaluator (:380-383) and the Connect-Four FlatOps traced into it (here the
// helpers of c4.cuh). The plain PyTorch version is fused_search in
// alphazero_tpu_torch/mcts/fused.py; the two must agree bit for bit.
//
// Semantics kept from the reference: root in slot 0 with the masked prior
// and a terminal root never descended; the lockstep slot cursor s = i + 1
// with no install once s >= C; child codes -1 unexpanded, >= 0 a child
// slot, -2-s a terminal child; the cutoff depth + 1 >= max_depth backing up
// 0; leaf value ctval + (1 - cdone) * (uval - ctval) on expansion, the
// child's tval at a terminal child; backup n += 1, w += mval * (-1)^d on
// the edge at depth d, mval = v_leaf * (-1)^depth; the first-max PUCT
// argmax of refresh_node. The installed prior is 1/n_valid on the valid
// edges (the softmax of zero logits) and INVALID_P elsewhere.
//
// Design: one thread per game, blocks of 128 games. The tree lives in
// device-memory scratch the wrapper allocates, f32[B, C, 32]: one 128-byte
// record per node, four rows of 8 lanes, A = 7 edges in lanes 0..6 of each
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
//
// What bounds it on an H100: the function moves only boards and priors in
// and counts and root W out (16.5 MB at B=65536, ~5 us at 3.35 TB/s), and
// its arithmetic is ~68 f32 operations per descent step. What holds it is
// latency: each descent step is a dependent 128-byte load from device
// memory, and each thread walks its own game. Keeping the trees in shared
// memory (12.9 KB per game at C=101) is the redesign for a later change.
//
// Arithmetic is bit-exact with the reference as in hybrid.cu: built with
// --fmad=false, the PUCT score and the backup with explicit round-to-nearest
// intrinsics, the prior as __fdiv_rn(1, n_valid).

#include <cstdint>
#include <cuda_runtime.h>

#include "c4.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kA = kCols;        // Connect-Four's 7 actions
constexpr int kRec = 32;         // floats per node record
constexpr int kN = 0, kW = 8, kP = 16, kCode = 24;  // row offsets
constexpr int kDone = kN + 7, kTval = kW + 7, kLink = kP + 7;

__global__ void fused_kernel(const float* __restrict__ boards,
                             const float* __restrict__ priors,
                             float* __restrict__ tree,
                             float* __restrict__ counts,
                             float* __restrict__ rootw,
                             int B, int C, int num_sims, int max_depth,
                             float cpuct, float uval) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float* T = tree + (size_t)b * C * kRec;

  uint64_t root_mine, root_theirs;
  c4_load(boards + (size_t)b * kCells, root_mine, root_theirs);
  bool rdone;
  float rtval;
  c4_terminal(root_mine, root_theirs, &rdone, &rtval);
  for (int a = 0; a < kA; ++a) {
    T[kN + a] = 0.f;
    T[kW + a] = 0.f;
    T[kP + a] = priors[(size_t)b * kA + a];
    T[kCode + a] = -1.f;
  }
  T[kDone] = rdone ? 1.f : 0.f;
  T[kTval] = rtval;
  T[kLink] = -1.f;
  T[kCode + 7] = 0.f;

  for (int i = 0; i < num_sims && !rdone; ++i) {
    const int s = i + 1;
    uint64_t mine = root_mine, theirs = root_theirs;
    int node = 0, depth = 0, last = 0, last_a = 0, leaf = -1;
    bool exp = false, term = false;
    // ---- descent ----
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
      c4_step(mine, theirs, a);
      last = node;
      last_a = a;
      depth += 1;
      const bool cterm = code < -1.5f;
      if (cterm) {  // terminal child: back up its value
        term = true;
        leaf = (int)(-2.f - code);
        break;
      }
      if (code < -0.5f) {  // unexpanded edge: expand
        exp = true;
        break;
      }
      if (depth >= max_depth) break;  // cutoff: back up 0
      node = (int)code;
    }

    // ---- expand at the lockstep slot, leaf value ----
    float v_leaf = 0.f;
    if (exp) {
      bool cdone;
      float ctval;
      c4_terminal(mine, theirs, &cdone, &ctval);
      const float cd = cdone ? 1.f : 0.f;
      v_leaf = __fadd_rn(ctval, __fmul_rn(1.f - cd, uval - ctval));
      if (s < C) {
        int n_valid = 0;
        for (int a = 0; a < kA; ++a) n_valid += c4_valid(mine, theirs, a) ? 1 : 0;
        const float prior = __fdiv_rn(1.f, (float)(n_valid > 0 ? n_valid : 1));
        float* S = T + (size_t)s * kRec;
        for (int a = 0; a < kA; ++a) {
          S[kN + a] = 0.f;
          S[kW + a] = 0.f;
          S[kP + a] = c4_valid(mine, theirs, a) ? prior : kInvalidP;
          S[kCode + a] = -1.f;
        }
        S[kDone] = cd;
        S[kTval] = ctval;
        S[kLink] = (float)(last * 8 + last_a);
        S[kCode + 7] = 0.f;
        T[(size_t)last * kRec + kCode + last_a] = cdone ? (float)(-2 - s) : (float)s;
      }
    } else if (term) {
      v_leaf = T[(size_t)leaf * kRec + kTval];
    }

    // ---- backup along the parent links, last edge first ----
    const float psign = (depth & 1) ? -1.f : 1.f;  // (-1)^depth
    const float mval = __fmul_rn(v_leaf, psign);
    float sign = -psign;                            // (-1)^(depth - 1)
    int nd = last, a = last_a;
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

  for (int a = 0; a < kA; ++a) {
    counts[(size_t)b * kA + a] = T[kN + a];
    rootw[(size_t)b * kA + a] = T[kW + a];
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

}  // extern "C"
