// In-kernel MLPNet evaluator for the fused search (fused.cu), Hopper
// (sm_90a). Replaces the traced-in `eval_fn` of attach_mlp_kernel_eval
// (alphazero_tpu/models/nets.py:129-154), which the Pallas fused kernel
// calls at alphazero_tpu/mcts/fused.py:385 (K=1) and :563 (K>1 rounds),
// and the `masked_policy` traced in after it (alphazero_tpu/ops/policy.py:
// 18-44). The plain PyTorch versions are mlp_forward and mlp_prior in
// alphazero_tpu_torch/mcts/fused.py; they keep the reference's rounding
// points and sum each dot product in k order.
//
// The network: the input is the board's [+plane | -plane] (84 values of
// 0 or 1), then 1 to 4 hidden layers h = relu(bf16(bf16(x . W) + b)), each
// dot product summed in f32, then the fused f32 head out = h . Wh + bh:
// lanes 0..6 are the policy logits, lane 7 the value before its tanh.
//
// Weights: the device address of each section (models/nets.py
// pack_mlp_weights keeps them in one buffer): W_l bf16 [in, out]
// row-major, b_l bf16 [out] for each hidden layer, then Wh f32 [H, 8] and
// bh f32 [8]. W_0's rows are in the [+plane | -plane] order.
//
// Design: a block of 256 threads (8 warps) evaluates kG = 32 games, the
// leaves of its 32 searches, together.
// * The hidden layers run on the bf16 tensor cores, mma.sync m16n8k16 with
//   f32 accumulators: the 32 leaves are two m16 tiles; a layer's outputs,
//   padded with zero columns to a multiple of 16, are n8 tiles that the 8
//   warps split (at H = 256 a warp takes 32 columns: 2 x 4 tiles, 32
//   accumulators a thread); its inputs are padded with zero rows to a
//   multiple of 16 (84 to 96).
// * The epilogue stays in the accumulators' registers and keeps the
//   reference's rounding points: the f32 sum rounded to bf16, the bias
//   added and rounded to bf16 again, ReLU; the bf16 activations go to
//   shared memory for the next layer's A fragments. Only the order of the
//   adds inside a dot product differs from the plain version's k order.
// * The weights live in shared memory, rows padded by 16 bytes so that the
//   fragment loads (32-bit for A, 16-bit pairs for B) hit 32 distinct
//   banks. When every layer fits beside the activations (the mlp preset's
//   (256, 256): 185,856 bytes of weights, 222,720 in all), each block
//   copies them once at kernel start with 16-byte cp.async and they stay
//   for the launch ("resident"). A stack that does not fit (3 or 4 layers
//   of 256) is "staged": each layer is copied into one buffer before it
//   runs, every evaluation. mlp_weights picks from the widths.
// * The head (f32, on the CUDA cores, summed in k order) and mlp_prior are
//   the plain version's operations in its order.
//
// What bounds it on an H100: per evaluation 2 (84 H1 + H1 H2 + ...) bf16
// operations (174,080 at (256, 256)), 989 TFLOP/s on the tensor cores;
// and the weights, 183 KB, read once per block. A 32-leaf evaluation is
// 2 x 4 x (6 + 16) = 176 mma.sync a warp, a few microseconds with its
// fragment loads and four barriers; the fused kernels are then paced by the
// owner threads' dependent tree loads (fused.cu). One 128-row evaluation per
// round on wgmma (64-row tiles) is later work.
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
constexpr int kMlpWarps = kMlpThreads / 32;
constexpr int kMaxHidden = 4;        // hidden layers the kernel takes
constexpr int kMaxWidth = 256;       // units per layer it takes
constexpr int kIn = 2 * kCells;      // 84 input features
constexpr int kInPad = 96;           // ... padded to the MMA's k16
constexpr int kActStride = kMaxWidth + 8;   // bf16 per activation row (+16 bytes)
constexpr int kMaxNTiles = kMaxWidth / 8 / kMlpWarps;   // 4 n8 tiles a warp
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may take
// the dynamic shared memory: activations, head outputs, biases, weights
constexpr int kActBytes = 2 * kG * kActStride * 2;          // 33,792
constexpr int kOutBytes = kG * kHead * 4;                    // 1,024
constexpr int kBiasBytes = kMaxHidden * kMaxWidth * 2;       // 2,048
constexpr int kWeightBase = kActBytes + kOutBytes + kBiasBytes;   // 36,864

static_assert(kWeightBase % 16 == 0, "16-byte cp.async destinations");
static_assert(kInPad % 16 == 0 && kInPad >= kIn, "k16 steps over the input");

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// The weights' addresses and widths, and their place in shared memory, by
// value in the kernel's parameters.
struct MlpWeights {
  int n_hidden;
  int width[kMaxHidden + 1];         // width[0] = kIn; width[l + 1]: layer l
  const __nv_bfloat16* w[kMaxHidden];
  const __nv_bfloat16* b[kMaxHidden];
  const float* wh;
  const float* bh;
  int kpad[kMaxHidden];              // layer l's input rows, padded to 16
  int npad[kMaxHidden];              // its units, padded to 16 (= kpad[l + 1])
  int w_off[kMaxHidden];             // its weights' bytes from kWeightBase
  bool resident;                     // every layer in shared memory for the launch
  int smem_bytes;                    // the launch's dynamic shared memory
};

// Bytes of layer l's weights in shared memory: kpad rows of npad + 8 bf16.
__host__ __device__ constexpr int mlp_layer_bytes(int kpad, int npad) {
  return kpad * (npad + 8) * 2;
}

// From the host array `sections` = W_0, b_0, ..., Wh, bh (2 n_hidden + 2
// device addresses), whose shapes the launch wrappers check. Resident when
// all layers fit in the block's shared memory, else staged.
inline MlpWeights mlp_weights(const void* const* sections, int n_hidden, const int* hidden) {
  MlpWeights m{};
  m.n_hidden = n_hidden;
  m.width[0] = kIn;
  int total = 0, largest = 0;
  for (int l = 0; l < n_hidden; ++l) {
    m.width[l + 1] = hidden[l];
    m.w[l] = (const __nv_bfloat16*)sections[2 * l];
    m.b[l] = (const __nv_bfloat16*)sections[2 * l + 1];
    m.kpad[l] = l == 0 ? kInPad : round16(hidden[l - 1]);
    m.npad[l] = round16(hidden[l]);
    m.w_off[l] = total;
    const int bytes = mlp_layer_bytes(m.kpad[l], m.npad[l]);
    total += bytes;
    largest = bytes > largest ? bytes : largest;
  }
  m.wh = (const float*)sections[2 * n_hidden];
  m.bh = (const float*)sections[2 * n_hidden + 1];
  m.resident = kWeightBase + total <= kSmemLimit;
  if (!m.resident)
    for (int l = 0; l < n_hidden; ++l) m.w_off[l] = 0;   // one buffer, a layer at a time
  m.smem_bytes = kWeightBase + (m.resident ? total : largest);
  return m;
}

// The evaluator's views of the dynamic shared memory.
struct MlpShared {
  __nv_bfloat16 (*act)[kG][kActStride];   // two activation buffers
  float (*out)[kHead];                    // the head outputs of the kG games
  __nv_bfloat16 (*bias)[kMaxWidth];       // each layer's biases, zero-padded
  unsigned char* w;                       // the weight region
};

__device__ __forceinline__ MlpShared mlp_shared(uint4* smem) {
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  return MlpShared{reinterpret_cast<__nv_bfloat16 (*)[kG][kActStride]>(base),
                   reinterpret_cast<float (*)[kHead]>(base + kActBytes),
                   reinterpret_cast<__nv_bfloat16 (*)[kMaxWidth]>(base + kActBytes + kOutBytes),
                   base + kWeightBase};
}

// A 16-byte asynchronous copy from device to shared memory, and the wait
// for every copy this thread issued.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#ifdef CUDA_EMU
  emu_cp_async16(dst, src);
#else
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef CUDA_EMU
  emu_cp_async_wait_all();
#else
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Layer l's weights into shared memory at `dst`: rows k < K of W[k, :H]
// (16-byte cp.async when every row is 16-byte aligned, else 2-byte loads),
// zeros in the padding columns H..npad and rows K..kpad. The caller waits
// (cp_async_wait_all) and passes a barrier before reading them.
__device__ __forceinline__ void mlp_copy_layer(const MlpWeights& m, int l, unsigned char* dst) {
  const int t = threadIdx.x;
  const int K = m.width[l], H = m.width[l + 1], kp = m.kpad[l], np = m.npad[l], ld = np + 8;
  const uint16_t* __restrict__ W = reinterpret_cast<const uint16_t*>(m.w[l]);
  uint16_t* sw = reinterpret_cast<uint16_t*>(dst);
  if (H % 8 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0) {
    const int chunks = H / 8;   // 16-byte chunks a row
    for (int i = t; i < K * chunks; i += kMlpThreads) {
      const int k = i / chunks, c = i % chunks;
      cp_async16(sw + k * ld + 8 * c, W + (size_t)k * H + 8 * c);
    }
  } else {
    for (int i = t; i < K * H; i += kMlpThreads) sw[(i / H) * ld + i % H] = W[i];
  }
  const int pad_cols = np - H;
  for (int i = t; i < K * pad_cols; i += kMlpThreads) sw[(i / pad_cols) * ld + H + i % pad_cols] = 0;
  for (int i = t; i < (kp - K) * np; i += kMlpThreads) sw[(K + i / np) * ld + i % np] = 0;
}

// Every thread of the block calls this once, at kernel start: the biases
// (zero-padded), and for a resident stack every layer's weights, into
// shared memory. It ends with a __syncthreads().
__device__ __forceinline__ void mlp_preload(const MlpWeights& m, const MlpShared& s) {
  for (int l = 0; l < m.n_hidden; ++l) {
    for (int j = threadIdx.x; j < m.npad[l]; j += kMlpThreads)
      s.bias[l][j] = j < m.width[l + 1] ? m.b[l][j] : __float2bfloat16_rn(0.f);
    if (m.resident) mlp_copy_layer(m, l, s.w + m.w_off[l]);
  }
  cp_async_wait_all();
  __syncthreads();
}

// One game's input row: bit k of `mine` for k < 42 (the +1 plane), bit
// k - 42 of `theirs` after it (the -1 plane), then zeros to kInPad.
__device__ __forceinline__ void mlp_input(__nv_bfloat16* row, uint64_t mine, uint64_t theirs) {
  for (int k = 0; k < kCells; ++k) {
    row[k] = __float2bfloat16_rn((float)((mine >> k) & 1ull));
    row[kCells + k] = __float2bfloat16_rn((float)((theirs >> k) & 1ull));
  }
  for (int k = kIn; k < kInPad; ++k) row[k] = __float2bfloat16_rn(0.f);
}

// 2 x kMaxNTiles instructions mma.sync.aligned.m16n8k16.row.col.f32.bf16.
// bf16.f32 of the calling warp: d[i][j] += A_i B_j for the warp's first
// n_tiles tiles j, A_i the 16x16 fragment a[i], B_j the 16x8 fragment b[j].
__device__ __forceinline__ void mlp_mma(float (&d)[2][kMaxNTiles][4], const uint32_t (&a)[2][4],
                                        const uint32_t (&b)[kMaxNTiles][2], int n_tiles) {
#ifdef CUDA_EMU
  // block-collective: every warp runs every tile (B is zero past n_tiles)
  emu_mma_m16n8k16_bf16(&d[0][0][0], &a[0][0], &b[0][0], 2, kMaxNTiles);
#else
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kMaxNTiles; ++j) {
      if (j < n_tiles) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[i][j][0]), "+f"(d[i][j][1]), "+f"(d[i][j][2]), "+f"(d[i][j][3])
            : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]), "r"(b[j][0]),
              "r"(b[j][1]));
      }
    }
  }
#endif
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A hidden unit's epilogue: the sum rounded to bf16, then the bias add
// rounded again, then ReLU.
__device__ __forceinline__ uint32_t mlp_unit(float acc, float bias) {
  const float h = __bfloat162float(__float2bfloat16_rn(acc));
  const float y = __bfloat162float(__float2bfloat16_rn(__fadd_rn(h, bias)));
  return __bfloat16_as_ushort(__float2bfloat16_rn(y > 0.f ? y : 0.f));
}

// Hidden layer l from act[cur] into act[cur ^ 1], its weights at `sw`.
__device__ __forceinline__ void mlp_layer(const MlpWeights& m, const MlpShared& s, int l, int cur,
                                          const uint16_t* sw) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tq = lane % 4;   // the fragments' row group, thread in group
  const int kp = m.kpad[l], np = m.npad[l], ld = np + 8;
  const int tiles = np / 8;
  const int per = (tiles + kMlpWarps - 1) / kMlpWarps;   // n8 tiles a warp, <= kMaxNTiles
  const int first = warp * per;                          // this warp's first tile
  const int owned = tiles - first < per ? (tiles - first > 0 ? tiles - first : 0) : per;

  float acc[2][kMaxNTiles][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const __nv_bfloat16(*x)[kActStride] = s.act[cur];
  for (int k0 = 0; k0 < kp; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // a0: row gid, k 2tq, 2tq+1; a1: row gid + 8; a2, a3: the same at k + 8
      const __nv_bfloat16* r = &x[16 * i + gid][k0 + 2 * tq];
      a[i][0] = lds32(r);
      a[i][1] = lds32(r + 8 * kActStride);
      a[i][2] = lds32(r + 8);
      a[i][3] = lds32(r + 8 * kActStride + 8);
    }
    uint32_t b[kMaxNTiles][2];
#pragma unroll
    for (int j = 0; j < kMaxNTiles; ++j) {
      // b0: k 2tq, 2tq+1 of column gid; b1: k 2tq+8, 2tq+9 (the lower k in the lower half)
      b[j][0] = b[j][1] = 0u;
      if (j < owned) {
        const uint16_t* w = sw + (k0 + 2 * tq) * ld + 8 * (first + j) + gid;
        b[j][0] = (uint32_t)w[0] | (uint32_t)w[ld] << 16;
        b[j][1] = (uint32_t)w[8 * ld] | (uint32_t)w[9 * ld] << 16;
      }
    }
    mlp_mma(acc, a, b, owned);
  }

  __nv_bfloat16(*y)[kActStride] = s.act[cur ^ 1];
#pragma unroll
  for (int j = 0; j < kMaxNTiles; ++j) {
    if (j < owned) {
      const int n = 8 * (first + j) + 2 * tq;   // d0, d2: column n; d1, d3: n + 1
      const float b0 = __bfloat162float(s.bias[l][n]), b1 = __bfloat162float(s.bias[l][n + 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // rows gid (d0, d1) and gid + 8 (d2, d3)
          *reinterpret_cast<uint32_t*>(&y[16 * i + 8 * h + gid][n]) =
              mlp_unit(acc[i][j][2 * h], b0) | mlp_unit(acc[i][j][2 * h + 1], b1) << 16;
        }
      }
    }
  }
}

// Every thread of the block calls this once the kG games' input rows are in
// s.act[0] and a __syncthreads() has passed. It leaves the head outputs in
// s.out[g][0..7] and ends with a __syncthreads().
__device__ __forceinline__ void mlp_block_eval(const MlpWeights& m, const MlpShared& s) {
  const int t = threadIdx.x;
  int cur = 0;
  for (int l = 0; l < m.n_hidden; ++l) {
    if (!m.resident) {   // staged: this layer into the one buffer
      mlp_copy_layer(m, l, s.w);
      cp_async_wait_all();
      __syncthreads();
    }
    mlp_layer(m, s, l, cur, reinterpret_cast<const uint16_t*>(s.w + m.w_off[l]));
    __syncthreads();
    cur ^= 1;
  }
  const int g = t / kHead, o = t % kHead;
  const int K = m.width[m.n_hidden];
  float acc = 0.f;
  for (int k = 0; k < K; ++k)
    acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(s.act[cur][g][k]), m.wh[k * kHead + o]));
  s.out[g][o] = __fadd_rn(acc, m.bh[o]);
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
