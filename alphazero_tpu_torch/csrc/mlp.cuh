// In-kernel MLPNet evaluator for the fused search (fused.cu), Hopper
// (sm_90a). Replaces the traced-in `eval_fn` of attach_mlp_kernel_eval
// (alphazero_tpu/models/nets.py:129-154), which the Pallas fused kernel
// calls at alphazero_tpu/mcts/fused.py:384-388, and the `masked_policy`
// traced in after it (alphazero_tpu/ops/policy.py:18-44). The plain PyTorch
// versions are mlp_forward and mlp_prior in alphazero_tpu_torch/mcts/
// fused.py; they do the same operations in the same order.
//
// The network: the input is the board's [+plane | -plane] (84 values of
// 0 or 1), then 1 to 4 hidden layers h = relu(bf16(bf16(x . W) + b)), each
// dot product summed in f32 over k in order, then the fused f32 head
// out = h . Wh + bh: lanes 0..6 are the policy logits, lane 7 the value
// before its tanh.
//
// Weights: the device address of each section (models/nets.py
// pack_mlp_weights keeps them in one buffer): W_l bf16 [in, out]
// row-major, b_l bf16 [out] for each hidden layer, then Wh f32 [H, 8] and
// bh f32 [8]. W_0's rows are in the [+plane | -plane] order.
//
// Design: a block evaluates kG = 32 games together with 256 threads. In a
// hidden layer, thread t computes unit j = t (then t + 256, ...) for all 32
// games: it reads W[k, j] once per k (neighbouring threads read
// neighbouring units, through the read-only cache; the 183 KB of weights
// at (256, 256) stay in L2) and each game's activation from shared memory
// (one address for the whole block, a broadcast), and keeps the 32 sums in
// registers. The head gives each thread one (game, output) pair:
// 32 x 8 = 256. Activations are bf16 in shared memory, two buffers of
// 32 x 256 (32 KB).
//
// What bounds it on an H100: per evaluation 2 (84 H1 + H1 H2 + ...) bf16
// operations (174,080 at (256, 256)), which the tensor cores would do at
// 989 TFLOP/s. This design does them as separate f32 multiplies and adds
// on the CUDA cores, ~100 instructions per k per thread, so it is bound by
// instruction throughput, far above that bound. It has to be, for now: its sums
// are bit-equal to the plain version's because the order of the adds is
// fixed, and a tensor-core tile (mma.sync / wgmma on [32, 84] x [84, 256])
// adds in its own order. Tensor-core tiles and weights resident in shared
// memory are later work (ROADMAP), held to a statistical bound.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "c4.cuh"

namespace {

constexpr int kG = 32;               // games a block evaluates together
constexpr int kHead = kCols + 1;     // 7 logits | the value
constexpr int kMlpThreads = kG * kHead;  // 256: one head output per thread
constexpr int kMaxHidden = 4;        // hidden layers the kernel takes
constexpr int kMaxWidth = 256;       // units per layer it takes
constexpr int kIn = 2 * kCells;      // 84 input features

// The weights' addresses and widths, by value in the kernel's parameters.
struct MlpWeights {
  int n_hidden;
  int width[kMaxHidden + 1];         // width[0] = kIn; width[l + 1]: layer l
  const __nv_bfloat16* w[kMaxHidden];
  const __nv_bfloat16* b[kMaxHidden];
  const float* wh;
  const float* bh;
};

// From the host array `sections` = W_0, b_0, ..., Wh, bh (2 n_hidden + 2
// device addresses), whose shapes the launch wrappers check.
inline MlpWeights mlp_weights(const void* const* sections, int n_hidden, const int* hidden) {
  MlpWeights m{};
  m.n_hidden = n_hidden;
  m.width[0] = kIn;
  for (int l = 0; l < n_hidden; ++l) {
    m.width[l + 1] = hidden[l];
    m.w[l] = (const __nv_bfloat16*)sections[2 * l];
    m.b[l] = (const __nv_bfloat16*)sections[2 * l + 1];
  }
  m.wh = (const float*)sections[2 * n_hidden];
  m.bh = (const float*)sections[2 * n_hidden + 1];
  return m;
}

// One game's input row: bit k of `mine` for k < 42 (the +1 plane), bit
// k - 42 of `theirs` after it (the -1 plane).
__device__ __forceinline__ void mlp_input(__nv_bfloat16* row, uint64_t mine, uint64_t theirs) {
  for (int k = 0; k < kCells; ++k) {
    row[k] = __float2bfloat16_rn((float)((mine >> k) & 1ull));
    row[kCells + k] = __float2bfloat16_rn((float)((theirs >> k) & 1ull));
  }
}

// Every thread of the block calls this once the kG games' input rows are in
// act[0] and a __syncthreads() has passed. It leaves the head outputs in
// out[g][0..7] and ends with a __syncthreads().
__device__ __forceinline__ void mlp_block_eval(const MlpWeights& m,
                                               __nv_bfloat16 (*act)[kG][kMaxWidth],
                                               float (*out)[kHead]) {
  const int t = threadIdx.x;
  int cur = 0;
  for (int l = 0; l < m.n_hidden; ++l) {
    const int K = m.width[l], H = m.width[l + 1];
    const __nv_bfloat16* __restrict__ W = m.w[l];
    for (int j = t; j < H; j += kMlpThreads) {
      float acc[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float w = __bfloat162float(W[(size_t)k * H + j]);
#pragma unroll
        for (int g = 0; g < kG; ++g)
          acc[g] = __fadd_rn(acc[g], __fmul_rn(__bfloat162float(act[cur][g][k]), w));
      }
      const float bj = __bfloat162float(m.b[l][j]);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        // the sum rounded to bf16, then the bias add rounded again, then ReLU
        const float h = __bfloat162float(__float2bfloat16_rn(acc[g]));
        const float y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(h, bj)));
        act[cur ^ 1][g][j] = __float2bfloat16_rn(y > 0.f ? y : 0.f);
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  const int g = t / kHead, o = t % kHead;
  const int K = m.width[m.n_hidden];
  float acc = 0.f;
  for (int k = 0; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(act[cur][g][k]), m.wh[k * kHead + o]));
  out[g][o] = __fadd_rn(acc, m.bh[o]);
  __syncthreads();
}

// masked_policy of the logits out[0..6] over the legal moves of the board
// (INVALID_P on the others), its 7-term sum taken in action order; and the
// value tanh(out[7]).
__device__ __forceinline__ void mlp_prior(const float* out, uint64_t mine, uint64_t theirs,
                                          float (&pm)[kCols], float* value) {
  bool vm[kCols];
  float masked[kCols];
  int n_valid = 0;
  for (int a = 0; a < kCols; ++a) {
    vm[a] = c4_valid(mine, theirs, a);
    n_valid += vm[a] ? 1 : 0;
    masked[a] = vm[a] ? out[a] : kNegInf;
  }
  float mx = masked[0];
  for (int a = 1; a < kCols; ++a) mx = fmaxf(mx, masked[a]);
  float e[kCols];
  float total = 0.f;
  for (int a = 0; a < kCols; ++a) {
    e[a] = vm[a] ? expf(__fsub_rn(masked[a], mx)) : 0.f;
    total = __fadd_rn(total, e[a]);
  }
  for (int a = 0; a < kCols; ++a) {
    // the uniform fallback over the legal moves; with none, every edge is
    // INVALID_P whatever the prior
    const float p = total > 0.f ? __fdiv_rn(e[a], fmaxf(total, 1e-30f))
                                : (vm[a] ? __fdiv_rn(1.f, (float)n_valid) : 0.f);
    pm[a] = vm[a] ? p : kInvalidP;
  }
  *value = tanhf(out[kCols]);
}

}  // namespace
