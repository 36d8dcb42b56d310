// In-kernel MLPNet evaluator for the fused search (fused.cu), Hopper
// (sm_90a). Replaces the traced-in `eval_fn` of attach_mlp_kernel_eval
// (alphazero_tpu/models/nets.py:129-154), which the Pallas fused kernel
// calls at alphazero_tpu/mcts/fused.py:385 (K=1) and :563 (K>1 rounds),
// and the `masked_policy` traced in after it (alphazero_tpu/ops/policy.py:
// 18-44; the prior is fused.cu's mlp_prior). The plain PyTorch versions are
// mlp_forward and mlp_prior in alphazero_tpu_torch/mcts/fused.py; they keep
// the reference's rounding points and sum each dot product in k order.
//
// The network: the input is the board's [+plane | -plane] (2 L values of
// 0 or 1 for a board of L cells), then any number of hidden layers h =
// relu(bf16(bf16(x . W) + b)), each dot product summed in f32, then the
// fused f32 head out = h . Wh + bh (on the bf16 input itself when there is
// no hidden layer): outputs 0..A-1 are the policy logits, output A the
// value before its tanh.
//
// Weights: the device address of each section (models/nets.py
// pack_mlp_weights keeps them in one buffer): W_l bf16 [in, out]
// row-major, b_l bf16 [out] for each hidden layer, then Wh f32 [H, A + 1]
// and bh f32 [A + 1]. The rows of the first matrix that reads the input
// (W_0, or Wh when there is no hidden layer) are in the [+plane | -plane]
// order.
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
// * The head (f32, on the CUDA cores, summed in k order) and the prior are
//   the plain version's operations in its order.
//
// Three plans, which the launch wrappers pick from the widths
// (kernels.mlp_plan):
// * "resident" and "staged" (MlpWeights, Connect-Four, 1 to 4 hidden layers
//   of at most 256 units: one head output a thread, kG x 8 = 256). The
//   weights live in shared memory, rows padded by 16 bytes so that the
//   fragment loads (32-bit for A, 16-bit pairs for B) hit 32 distinct
//   banks. When every layer fits beside the activations (the mlp preset's
//   (256, 256): 185,856 bytes of weights, 222,720 in all), each block
//   copies them once at kernel start with 16-byte cp.async and they stay
//   for the launch ("resident"). A stack that does not fit (3 or 4 layers
//   of 256) is "staged": each layer is copied into one buffer before it
//   runs, every evaluation.
// * "streamed" (MlpStream: any board, any width, any depth, no hidden
//   layer too). A (512, 512) net has ~632 KB of padded weights, more than
//   a block's 227 KB, so nothing stays: each layer runs in passes of at
//   most 256 output columns (the 4 n8 tiles a warp's accumulators hold),
//   and each pass streams its columns of W through a ring of two slots of
//   kChunkRows = 32 rows in shared memory: chunk c + 1's 16-byte cp.async
//   copies are issued before chunk c's MMAs run, so the copy of one overlaps
//   the products of the other; the weights come from device memory and,
//   across the blocks and simulations of a search, stay in L2 (0.63 MB at
//   (512, 512)). The biases are read from device memory in each pass's
//   epilogue. The layer descriptors (MlpLayer) are a device array, so the
//   depth has no limit; padding rows and columns (widths not a multiple of
//   16 or 8) are written as zeros by the staging. The activations stay in
//   shared memory while their two buffers (2 x kG x (H + 8) x 2 bytes, H the
//   widest padded layer) fit beside the ring and the head outputs, up to
//   H ~ 1,520; above, they go to a device scratch of the same layout, a
//   block's own slice, that the wrapper allocates. (Fewer games a block
//   would keep them in shared memory but split the two m16 tiles the MMAs
//   need: a device slice keeps one code path for every width; its rows are
//   read back from L1/L2, once per k step.) The head outputs kG x (A + 1)
//   are looped over by the 256 threads.
//
// What bounds it on an H100: per evaluation 2 (2L H1 + H1 H2 + ...) bf16
// operations (174,080 at (256, 256); 610,304 at (512, 512)), 989 TFLOP/s on
// the tensor cores; and the weights, read once per block (resident) or once
// per evaluation of a block from L2 (staged, streamed). A 32-leaf
// evaluation at (256, 256) is 2 x 4 x (6 + 16) = 176 mma.sync a warp, a few
// microseconds with its fragment loads and four barriers; the fused kernels
// are then paced by the owner threads' dependent tree loads (fused.cu). One
// 128-row evaluation per round on wgmma (64-row tiles) is later work.
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

// ---- the streamed plan: any board, width and depth -------------------------

constexpr int kPassCols = kMlpWarps * kMaxNTiles * 8;         // 256 output columns a pass
constexpr int kChunkRows = 32;                                 // weight rows a ring slot holds
constexpr int kRingStride = kPassCols + 8;                     // bf16 a ring row (+16 bytes)
constexpr int kRingBytes = 2 * kChunkRows * kRingStride * 2;   // 33,792: two slots

static_assert(kChunkRows % 16 == 0, "whole k16 steps a chunk");

// One hidden layer, a row of the device array the wrapper packs (int64
// [n_hidden, 3]: w, b, k | n << 32).
struct MlpLayer {
  const __nv_bfloat16* w;   // [k, n] row-major
  const __nv_bfloat16* b;   // [n]
  int k, n;                 // inputs, units
};
static_assert(sizeof(MlpLayer) == 24, "the wrapper's int64 [n_hidden, 3] rows");

// The streamed plan's weights and the layout of its memory, by value in
// the kernel's parameters.
struct MlpStream {
  const MlpLayer* layers;   // n_hidden descriptors in device memory
  int n_hidden;
  int in;                   // input features: 2 L
  int head;                 // head outputs: A + 1
  const float* wh;          // [last width, head]
  const float* bh;          // [head]
  int stride;               // bf16 an activation row: the widest padded width + 8
  int out_bytes;            // the head outputs' bytes at the base of shared memory
  __nv_bfloat16* act;       // the activations' device scratch, null while they fit shared memory
  int act_block_bytes;      // ... its bytes a block: 0 while they fit
  int smem_bytes;           // the launch's dynamic shared memory
};

// From the host: the descriptors' device address, the hidden widths (a host
// array), the input and head widths, the head's device addresses and the
// activation scratch (used only when the activations do not fit).
inline MlpStream mlp_stream(const void* layers, int n_hidden, const int* hidden, int in, int head,
                            const float* wh, const float* bh, void* act) {
  MlpStream m{};
  m.layers = static_cast<const MlpLayer*>(layers);
  m.n_hidden = n_hidden;
  m.in = in;
  m.head = head;
  m.wh = wh;
  m.bh = bh;
  int widest = round16(in);
  for (int l = 0; l < n_hidden; ++l) widest = round16(hidden[l]) > widest ? round16(hidden[l]) : widest;
  m.stride = widest + 8;
  m.out_bytes = round16(kG * head * 4);
  const int act_bytes = 2 * kG * m.stride * 2;
  const bool shared = m.out_bytes + kRingBytes + act_bytes <= kSmemLimit;
  m.act = shared ? nullptr : static_cast<__nv_bfloat16*>(act);
  m.act_block_bytes = shared ? 0 : act_bytes;
  m.smem_bytes = m.out_bytes + kRingBytes + (shared ? act_bytes : 0);
  return m;
}

// The streamed plan's views: the head outputs, the weight ring and the two
// activation buffers (act + c * kG * stride, row g at + g * stride).
struct MlpStreamShared {
  float* out;
  uint16_t* ring;
  __nv_bfloat16* act;
};

__device__ __forceinline__ MlpStreamShared mlp_stream_shared(const MlpStream& m, uint4* smem) {
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  __nv_bfloat16* act = m.act ? m.act + (size_t)blockIdx.x * 2 * kG * m.stride
                             : reinterpret_cast<__nv_bfloat16*>(base + m.out_bytes + kRingBytes);
  return MlpStreamShared{reinterpret_cast<float*>(base),
                         reinterpret_cast<uint16_t*>(base + m.out_bytes), act};
}

// One game's input row of a board of L <= 64 cells: bit k of `mine` (the
// +1 plane), then bit k of `theirs` (the -1 plane), then zeros to the next
// multiple of 16.
__device__ __forceinline__ void mlp_input_cells(__nv_bfloat16* row, uint64_t mine, uint64_t theirs,
                                                int L) {
  for (int k = 0; k < L; ++k) {
    row[k] = __float2bfloat16_rn((float)((mine >> k) & 1ull));
    row[L + k] = __float2bfloat16_rn((float)((theirs >> k) & 1ull));
  }
  for (int k = 2 * L; k < round16(2 * L); ++k) row[k] = __float2bfloat16_rn(0.f);
}

// Rows k0 .. k0 + rows - 1 of columns n0 .. n0 + cols - 1 of the layer's W
// into a ring slot (row r at slot + r * kRingStride): 16-byte cp.async where
// a whole aligned run lies inside W, zeros in the padding rows (k >= K) and
// columns (n >= N). The caller waits and passes a barrier before reading.
__device__ __forceinline__ void mlp_stage(const MlpLayer& ly, int n0, int cols, int k0, int rows,
                                          uint16_t* slot) {
  const uint16_t* __restrict__ W = reinterpret_cast<const uint16_t*>(ly.w);
  const bool vec = ly.n % 8 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const int runs = cols / 8;   // 16-byte runs a row
  for (int i = threadIdx.x; i < rows * runs; i += kMlpThreads) {
    const int r = i / runs, c = 8 * (i % runs);
    const int k = k0 + r, n = n0 + c;
    uint16_t* dst = slot + r * kRingStride + c;
    if (vec && k < ly.k && n < ly.n) {
      cp_async16(dst, W + (size_t)k * ly.n + n);
    } else {
      for (int j = 0; j < 8; ++j)
        dst[j] = k < ly.k && n + j < ly.n ? W[(size_t)k * ly.n + n + j] : (uint16_t)0;
    }
  }
}

// One hidden layer from the activations x into y (rows `stride` bf16 apart),
// its weights streamed through the ring (see the plan above). Every thread
// of the block calls it after a barrier behind x's writes; it ends with a
// __syncthreads().
__device__ __forceinline__ void mlp_stream_layer(const MlpLayer& ly, const __nv_bfloat16* x,
                                                 __nv_bfloat16* y, int stride, uint16_t* ring) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tq = lane % 4;   // the fragments' row group, thread in group
  const int kp = round16(ly.k), np = round16(ly.n);
  const int chunks = (kp + kChunkRows - 1) / kChunkRows;
  constexpr int kSlot = kChunkRows * kRingStride;
  for (int n0 = 0; n0 < np; n0 += kPassCols) {
    const int cols = np - n0 < kPassCols ? np - n0 : kPassCols;
    const int tiles = cols / 8;
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

    mlp_stage(ly, n0, cols, 0, kp < kChunkRows ? kp : kChunkRows, ring);
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait_all();
      __syncthreads();   // chunk c is in its slot; every warp is done with chunk c - 1's
      const int k0 = c * kChunkRows;
      const int rows = kp - k0 < kChunkRows ? kp - k0 : kChunkRows;
      if (c + 1 < chunks) {
        const int next = kp - k0 - kChunkRows;
        mlp_stage(ly, n0, cols, k0 + kChunkRows, next < kChunkRows ? next : kChunkRows,
                  ring + ((c + 1) & 1) * kSlot);
      }
      const uint16_t* sw = ring + (c & 1) * kSlot;
      for (int ks = 0; ks < rows; ks += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // a0: row gid, k 2tq, 2tq+1; a1: row gid + 8; a2, a3: the same at k + 8
          const __nv_bfloat16* r = x + (size_t)(16 * i + gid) * stride + k0 + ks + 2 * tq;
          a[i][0] = lds32(r);
          a[i][1] = lds32(r + 8 * stride);
          a[i][2] = lds32(r + 8);
          a[i][3] = lds32(r + 8 * stride + 8);
        }
        uint32_t b[kMaxNTiles][2];
#pragma unroll
        for (int j = 0; j < kMaxNTiles; ++j) {
          b[j][0] = b[j][1] = 0u;
          if (j < owned) {
            const uint16_t* w = sw + (ks + 2 * tq) * kRingStride + 8 * (first + j) + gid;
            b[j][0] = (uint32_t)w[0] | (uint32_t)w[kRingStride] << 16;
            b[j][1] = (uint32_t)w[8 * kRingStride] | (uint32_t)w[9 * kRingStride] << 16;
          }
        }
        mlp_mma(acc, a, b, owned);
      }
    }

#pragma unroll
    for (int j = 0; j < kMaxNTiles; ++j) {
      if (j < owned) {
        const int n = n0 + 8 * (first + j) + 2 * tq;   // d0, d2: column n; d1, d3: n + 1
        const float b0 = n < ly.n ? __bfloat162float(ly.b[n]) : 0.f;
        const float b1 = n + 1 < ly.n ? __bfloat162float(ly.b[n + 1]) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // rows gid (d0, d1) and gid + 8 (d2, d3)
            *reinterpret_cast<uint32_t*>(y + (size_t)(16 * i + 8 * h + gid) * stride + n) =
                mlp_unit(acc[i][j][2 * h], b0) | mlp_unit(acc[i][j][2 * h + 1], b1) << 16;
          }
        }
      }
    }
    __syncthreads();   // y's pass is written; the ring is free for the next pass
  }
}

// The streamed evaluation: every thread of the block calls this once the
// kG games' input rows are in activation buffer 0 and a __syncthreads()
// has passed. It leaves the head outputs in s.out[g * head + o] and ends
// with a __syncthreads().
__device__ __forceinline__ void mlp_stream_eval(const MlpStream& m, const MlpStreamShared& s) {
  const size_t buf = (size_t)kG * m.stride;
  int cur = 0, width = m.in;
  for (int l = 0; l < m.n_hidden; ++l) {
    const MlpLayer ly = m.layers[l];
    mlp_stream_layer(ly, s.act + cur * buf, s.act + (cur ^ 1) * buf, m.stride, s.ring);
    cur ^= 1;
    width = ly.n;
  }
  const __nv_bfloat16* h = s.act + cur * buf;
  for (int i = threadIdx.x; i < kG * m.head; i += kMlpThreads) {
    const int g = i / m.head, o = i % m.head;
    float acc = 0.f;
    for (int k = 0; k < width; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(h[(size_t)g * m.stride + k]),
                                     m.wh[k * m.head + o]));
    s.out[i] = __fadd_rn(acc, m.bh[o]);
  }
  __syncthreads();
}
}  // namespace
