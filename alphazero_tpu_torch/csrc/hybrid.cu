// Hybrid-engine search kernels for Hopper (sm_90a): descend, merge, refresh.
//
// Replace the Pallas kernels of alphazero_tpu/mcts/hybrid.py:
//   az_descend, az_descend_othello
//               <- descend_kernel (hybrid.py:242-356), one instance per game
//                  of descend_kernel<Game>: the Connect-Four step
//                  (FlatOps.step, games/connect_four.py:201-217) from c4.cuh,
//                  the Othello step (OthelloFlatOps.step, games/othello.py
//                  :228-265) from othello.cuh;
//   az_merge    <- merge_kernel (hybrid.py:363-422) with the A<=8 PUCT
//                  refresh (_refresh, hybrid.py:120-149);
//   az_merge_dense
//               <- the same merge with _refresh's dense branch for larger
//                  action spaces (hybrid.py:150-168; Othello A=65);
//   az_refresh, az_refresh_dense
//               <- the same two refreshes alone, which seed the first
//                  best-action planes of a search (hybrid.py:815).
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
//   layout, not semantics) and carries the board as two 64-bit bitboards in
//   registers, so a Connect-Four step is a popcount and two bit ops and an
//   Othello step a register-only walk of the 8 rays. Small blocks (32
//   games) spread the games over the SMs: 4096 games fill all 132 SMs, the
//   1024 of the Othello full preset only 32 of them (launch geometry is
//   later work).
// * merge is bandwidth-bound: it must read the four [B, A, C] planes
//   (46 MB at B=4096, C=101, A=7; 108 MB at B=1024, C=101, A=65) to
//   refresh every node's PUCT argmax. One thread per (game, node) reads its
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
// Arithmetic is bit-exact with the reference: build with --fmad=false (no
// a*b+c contraction), default -prec-div/-prec-sqrt, never --use_fast_math;
// the PUCT score is written with explicit round-to-nearest intrinsics in the
// reference's operation order q + ((cpuct*p)*sqrt(sum n + EPS))/(1 + n),
// q = w / max(n, 1), and ties keep the first maximum (strict >), which is
// the dense branch's smallest action among the exact maxima.

#include <cstdint>
#include <cuda_runtime.h>

#include "c4.cuh"       // c4_step, refresh_node and the constants
#include "othello.cuh"  // othello_step

namespace {

constexpr int kDescendThreads = 32;
constexpr int kMergeThreads = 256;

// The games descend_kernel is instantiated for: board cells and step.
struct ConnectFourGame {
  static constexpr int kBoardCells = kCells;
  static __device__ __forceinline__ void step(uint64_t& mine, uint64_t& theirs, int a) {
    c4_step(mine, theirs, a);
  }
};

struct OthelloGame {
  static constexpr int kBoardCells = kOthCells;
  static __device__ __forceinline__ void step(uint64_t& mine, uint64_t& theirs, int a) {
    othello_step(mine, theirs, a);
  }
};

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
                               int B, int C, int max_depth) {
  constexpr int L = Game::kBoardCells;
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

  uint64_t mine = 0, theirs = 0;  // flat f32[L] board (+1 / -1 / 0) -> bitboards
  const float* board = boards + (size_t)b * L;
  for (int i = 0; i < L; ++i) {
    const float v = board[i];
    if (v > 0.5f) mine |= 1ull << i;
    if (v < -0.5f) theirs |= 1ull << i;
  }

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

  float* out = bd + (size_t)b * L;
  for (int i = 0; i < L; ++i) {
    out[i] = ((mine >> i) & 1ull) ? 1.f : (((theirs >> i) & 1ull) ? -1.f : 0.f);
  }
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
    const float na = n[off], pa = p[off];
    const float q = __fdiv_rn(w[off], fmaxf(na, 1.f));
    const float u = __fdiv_rn(__fmul_rn(__fmul_rn(cpuct, pa), sq), __fadd_rn(1.f, na));
    const float s = pa <= kIllegal ? kNegInf : __fadd_rn(q, u);
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

unsigned int blocks_for(size_t items, int threads) {
  return (unsigned int)((items + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* az_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int az_descend(const float* besta, const float* bestc, const float* done,
               const float* tval, const float* boards, float* bd, float* patha,
               float* psgn, float* meta, int B, int C, int max_depth,
               void* stream) {
  descend_kernel<ConnectFourGame><<<blocks_for(B, kDescendThreads), kDescendThreads, 0,
                                    (cudaStream_t)stream>>>(
      besta, bestc, done, tval, boards, bd, patha, psgn, meta, B, C, max_depth);
  return (int)cudaGetLastError();
}

int az_descend_othello(const float* besta, const float* bestc, const float* done,
                       const float* tval, const float* boards, float* bd,
                       float* patha, float* psgn, float* meta, int B, int C,
                       int max_depth, void* stream) {
  descend_kernel<OthelloGame><<<blocks_for(B, kDescendThreads), kDescendThreads, 0,
                                (cudaStream_t)stream>>>(
      besta, bestc, done, tval, boards, bd, patha, psgn, meta, B, C, max_depth);
  return (int)cudaGetLastError();
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

}  // extern "C"
