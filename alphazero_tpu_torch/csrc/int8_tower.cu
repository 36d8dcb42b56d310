// The fused int8 ResNet tower for Hopper (sm_90a): az_int8_tower.
//
// Replaces the Pallas `tower_kernel` of experiments/int8_fused_tower.py
// (:46-96, pallas_call at :112): the whole Connect-Four tower — a stem conv
// and 5 residual blocks of two convs, 11 convs of 3x3 SAME from 64 to 64
// channels on the 6x7 board — in one kernel, int8 activations and weights,
// int32 accumulation, every layer requantized in the epilogue. The plain
// PyTorch version is tower_plain in
// alphazero_tpu_torch/experiments/int8_fused_tower.py; the two agree bit for
// bit.
//
// Function (the reference's, exactly): x f32[B*42, 64], rows game-major
// b*42 + r*7 + c, is quantized q = clip(rint(x * 32), -127, 127); each layer
// computes acc[m, n] = sum over taps (dr, dc) and c of
// q[neighbour (r+dr, c+dc) of m, c] * w[n, tap*64 + c] (zero off the board),
// then f = relu(acc * 2^-9 (+ the block's residual f)), and the next q =
// clip(rint(f * 32), -127, 127). The stem and each block's second conv
// carry f; the last f is the output, f32[B*42, 64]. The reference's 256-game
// blocks and [9, M] boundary masks are TPU layout: the masks zero every
// neighbour off the board, so each game is a 3x3 conv with zero padding.
//
// Design:
// * One block per tile of kG = 8 games, 336 output rows. The tile's int8
//   activations stay in shared memory across all 11 layers in two planes
//   (a conv's input q and output q), rows of 80 bytes (64 channels + 16
//   bytes of padding, so the 8 rows of a fragment load fall in distinct
//   banks). One layer's weights, int8[64][576] padded to 592-byte rows the
//   same way, are copied in before the layer.
// * The products run on the int8 tensor cores: mma.sync m16n8k32 s8.s8.s32.
//   14 warps: warp w owns rows (w/2)*48 .. +47 (3 m16 tiles) and columns
//   (w%2)*32 .. +31 (4 n8 tiles), the same outputs in every layer, so the
//   f32 residual f stays in its registers (48 a thread). K = 576 is 9 taps
//   x 64 channels, so each k32 step lies inside one tap: the A fragment's
//   row for output (g, r, c) is 32 contiguous bytes of the shifted cell's
//   row in the q plane, or zeros where (r+dr, c+dc) falls off the board —
//   the im2col costs one address per row and tap.
// * The epilogue keeps the reference's order of operations: the exact
//   int->float conversion, * 2^-9, + the residual, ReLU, * 32, rint (half
//   to even), clip. Built with --fmad=false.
// * A tail tile (B not a multiple of 8) computes its missing games on zeros
//   and stores nothing for them. Every thread runs every MMA and reaches
//   every __syncthreads().
//
// What bounds it on an H100: 2 * 42 * 576 * 64 * 11 = 34.1 Mop per game
// (1.395e11 at B=4096, 0.0705 ms at the int8 tensor cores' 1979 TOP/s)
// against 21.5 KB of input and output per game (88.5 MB, 0.026 ms at
// 3.35 TB/s): operations. This first version issues warp-level mma.sync
// from fragments loaded with 32-bit shared-memory loads, and copies each
// layer's weights between two barriers; wgmma, ldmatrix and a TMA weight
// pipeline are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 6, kCols = 7, kCells = kRows * kCols;
constexpr int kCh = 64;
constexpr int kK = 9 * kCh;                   // 576
constexpr int kLayers = 11;
constexpr int kG = 8;                         // games per block
constexpr int kM = kG * kCells;               // 336 output rows per block
constexpr int kRowBytes = kCh + 16;           // a q-plane row, padded
constexpr int kWRowBytes = kK + 16;           // a weight row (output channel), padded
constexpr int kMTiles = 3, kNTiles = 4;       // m16 and n8 tiles of a warp
constexpr int kWarps = (kM / (16 * kMTiles)) * (kCh / (8 * kNTiles));   // 7 x 2
constexpr int kThreads = 32 * kWarps;         // 448
constexpr int kPlaneBytes = kM * kRowBytes;   // 26,880
constexpr int kWBytes = kCh * kWRowBytes;     // 37,888
constexpr int kSmemBytes = 2 * kPlaneBytes + kWBytes;   // 91,648
constexpr float kAccScale = 1.0f / 512.0f;    // WSCALE / ASCALE
constexpr float kAScale = 32.0f;              // ASCALE

static_assert(kM % (16 * kMTiles) == 0 && kCh % (8 * kNTiles) == 0, "warp tiles cover the block");
static_assert(kRowBytes % 16 == 0 && kWRowBytes % 16 == 0, "16-byte rows");
static_assert(kSmemBytes <= 232448, "a block's dynamic shared memory on sm_90");

// kMTiles x kNTiles instructions mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// of the calling warp: d[i][j] += A_i B_j, A_i the 16x32 fragment a[i], B_j
// the 32x8 fragment b[j].
__device__ __forceinline__ void warp_mma(int32_t (&d)[kMTiles][kNTiles][4],
                                         const uint32_t (&a)[kMTiles][4],
                                         const uint32_t (&b)[kNTiles][2]) {
#ifdef CUDA_EMU
  emu_mma_m16n8k32_s8(&d[0][0][0], &a[0][0], &b[0][0], kMTiles, kNTiles);
#else
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(d[i][j][0]), "+r"(d[i][j][1]), "+r"(d[i][j][2]), "+r"(d[i][j][3])
          : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]), "r"(b[j][0]),
            "r"(b[j][1]));
    }
  }
#endif
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// f32 -> int8 at ASCALE: round half to even, clip to +-127.
__device__ __forceinline__ int quantize(float f) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(f, kAScale)), -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 | (uint32_t)(c & 0xff) << 16 |
         (uint32_t)(d & 0xff) << 24;
}

// One layer's weights int8[64][576] into the padded shared-memory rows.
__device__ void load_weights(const int8_t* __restrict__ w, unsigned char* sw) {
  constexpr int kChunks = kK / 16;   // 36 16-byte chunks a row
  for (int i = threadIdx.x; i < kCh * kChunks; i += kThreads) {
    const int n = i / kChunks, c = i % kChunks;
    *reinterpret_cast<uint4*>(sw + n * kWRowBytes + c * 16) =
        *reinterpret_cast<const uint4*>(w + n * kK + c * 16);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    int8_tower_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                      float* __restrict__ out, int B) {
  extern __shared__ uint4 tower_smem[];
  // q planes 0 and 1 (layer l reads plane l % 2, writes the other), then
  // the layer's weights
  unsigned char* smem = reinterpret_cast<unsigned char*>(tower_smem);
  unsigned char* sw = smem + 2 * kPlaneBytes;

  const int game0 = blockIdx.x * kG;
  const int live = min(kG, B - game0);   // games of this tile that exist
  const size_t row0 = (size_t)game0 * kCells;

  // the input, quantized, into plane 0 (zeros for the missing games)
  for (int i = threadIdx.x; i < kM * (kCh / 4); i += kThreads) {
    const int m = i / (kCh / 4), c4 = i % (kCh / 4);
    uint32_t packed = 0;
    if (m < live * kCells) {
      const float4 v = *reinterpret_cast<const float4*>(x + (row0 + m) * kCh + c4 * 4);
      packed = pack4(quantize(v.x), quantize(v.y), quantize(v.z), quantize(v.w));
    }
    *reinterpret_cast<uint32_t*>(smem + m * kRowBytes + c4 * 4) = packed;
  }
  load_weights(w, sw);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;   // the fragments' row group and thread in group
  const int mbase = (warp / 2) * (16 * kMTiles);
  const int nbase = (warp % 2) * (8 * kNTiles);
  // this thread's fragment rows (m16 tile i, upper half h) and the taps
  // whose neighbour is on the board, bit tap = (dr+1)*3 + (dc+1)
  int mrow[kMTiles][2];
  unsigned taps_on[kMTiles][2];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mbase + 16 * i + 8 * h + gid;
      const int r = (m % kCells) / kCols, c = m % kCols;
      unsigned bits = 0;
      for (int tap = 0; tap < 9; ++tap) {
        const int rr = r + tap / 3 - 1, cc = c + tap % 3 - 1;
        if (rr >= 0 && rr < kRows && cc >= 0 && cc < kCols) bits |= 1u << tap;
      }
      mrow[i][h] = m;
      taps_on[i][h] = bits;
    }
  }

  float res[kMTiles][kNTiles][4];   // the f32 residual f of this thread's outputs
  for (int layer = 0; layer < kLayers; ++layer) {
    if (layer > 0) {
      __syncthreads();   // every read of the last layer's weights and input is done
      load_weights(w + (size_t)layer * kCh * kK, sw);
    }
    __syncthreads();
    const unsigned char* qin = smem + (layer & 1) * kPlaneBytes;
    unsigned char* qout = smem + ((layer + 1) & 1) * kPlaneBytes;

    int32_t acc[kMTiles][kNTiles][4];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3 - 1) * kCols + (tap % 3 - 1);   // row offset of the neighbour
#pragma unroll
      for (int half = 0; half < 2; ++half) {   // input channels 0..31, 32..63
        const int k0 = tap * kCh + half * 32;
        uint32_t b[kNTiles][2];
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          const unsigned char* wp = sw + (nbase + 8 * j + gid) * kWRowBytes + k0 + 4 * tq;
          b[j][0] = lds32(wp);
          b[j][1] = lds32(wp + 16);
        }
        uint32_t a[kMTiles][4];
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t lo = 0, hi = 0;
            if (taps_on[i][h] >> tap & 1u) {
              const unsigned char* ap =
                  qin + (mrow[i][h] + shift) * kRowBytes + half * 32 + 4 * tq;
              lo = lds32(ap);
              hi = lds32(ap + 16);
            }
            a[i][h] = lo;       // a0 (row gid), a1 (row gid + 8): k 4*tq..+3
            a[i][2 + h] = hi;   // a2, a3: k 16 + 4*tq..+3
          }
        }
        warp_mma(acc, a, b);
      }
    }

    // epilogue: the reference's order of operations
    const bool add_res = layer >= 2 && layer % 2 == 0;   // each block's second conv
    const bool keep_f = layer % 2 == 0;                   // the stem and second convs
    const bool last = layer == kLayers - 1;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int n = nbase + 8 * j + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float f[2];
          int q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), kAccScale);
            if (add_res) v = __fadd_rn(v, res[i][j][2 * h + e]);
            v = fmaxf(v, 0.0f);
            if (keep_f) res[i][j][2 * h + e] = v;
            f[e] = v;
            q[e] = quantize(v);
          }
          const int m = mrow[i][h];
          if (!last) {
            *reinterpret_cast<uint16_t*>(qout + m * kRowBytes + n) =
                (uint16_t)((q[0] & 0xff) | (q[1] & 0xff) << 8);
          } else if (m < live * kCells) {
            *reinterpret_cast<float2*>(out + (row0 + m) * kCh + n) = make_float2(f[0], f[1]);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x f32[B*42, 64] and w int8[11, 64, 576], both 16-byte aligned (the
// wrapper checks); out f32[B*42, 64].
int az_int8_tower(const float* x, const int8_t* w, float* out, int B, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned int blocks = (unsigned int)((B + kG - 1) / kG);
  int8_tower_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(x, w, out, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
