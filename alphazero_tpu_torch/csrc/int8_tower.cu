// The fused int8 ResNet tower for Hopper (sm_90a): az_int8_tower.
//
// Replaces the Pallas `tower_kernel` of experiments/int8_fused_tower.py
// (:46-96, pallas_call at :112): the whole Connect-Four tower — a stem conv
// and 5 residual blocks of two convs, 11 convs of 3x3 SAME from 64 to 64
// channels on the 6x7 board — in one kernel, int8 activations and weights,
// int32 accumulation, every layer requantized in the epilogue. The plain
// PyTorch version is tower_plain in alphazero_tpu_torch/models/int8_tower.py;
// the two agree bit for bit.
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
// * Products on wgmma.mma_async m64n64k32 .s32.s8.s8, both operands from
//   shared memory (the SS form). One m64 tile is 64 output rows x all 64
//   output channels over K = 576: 9 taps x 2 k32 steps, issued as
//   wgmma.fence, 18 wgmma, commit_group, wait_group 0. The accumulator
//   fragment is the m16n8 C fragment of mma.sync, per warp of the group.
// * Activations: a tile of kG = 8 games lives in two q planes (a conv's
//   input and output) for all 11 layers. Each game is a padded board: a
//   zero row of 8 cells, then its 6 rows of 8 cells whose 8th is a zero
//   column (also the next row's left neighbour): 56 rows a game, 448 = 7
//   m64 tiles, with kHalo zero rows before the first game and after the
//   last. A plane is K-chunk-major in wgmma's no-swizzle (INTERLEAVE)
//   K-major layout: chunk j (channels 16j..16j+15) holds every plane row's
//   16 bytes contiguously, so a core matrix (8 rows x 16 bytes) starts at
//   any row (LBO = one chunk, SBO = 128 bytes) and tap (dr, dc)'s shifted
//   operand is the same descriptor with its start moved by 8 dr + dc rows:
//   a neighbour off the board reads a pad zero. The epilogue writes q = 0
//   into every pad row and column in every layer; the halo rows are zeroed
//   once a launch. The price of no per-row addressing: 56 x 9 (row, tap)
//   pairs a game against the board's 304, 1.66x its products. (The
//   alternative, A from registers loaded by ldmatrix at 42 rows a game with
//   per-lane row addresses, was not built: it moves the same A bytes
//   through shared memory and adds the ldmatrix issue and the addresses.)
// * Weights: a TMA tensor map over w viewed as [704 rows, 576 bytes] with
//   a 64 x 64-byte box and the 64-byte swizzle gives one tap's B tile
//   (64 output channels x 64 input channels, K-major), in the layout a
//   B64 wgmma descriptor reads (SBO 512 bytes; the second k32 step starts
//   32 bytes in). A layer is 9 boxes, 36,864 bytes, into a two-stage ring;
//   stage s completes on mbarrier s (expect_tx, then try_wait.parity).
//   Thread 0 issues the boxes of the block's layer after next right after
//   a layer's closing barrier, so they land while the next layer computes;
//   the ring runs on across the block's tiles. The tensor map is encoded
//   on the host per call through cudaGetDriverEntryPointByVersion, so the
//   library links no driver library, and passed as a __grid_constant__.
// * Block: 4 warpgroups (512 threads); warpgroup g owns m64 tiles g and
//   g + 4 (< 7) in every layer, so the f32 residual of its outputs stays in
//   its registers (2 x 32 a thread). One __syncthreads a layer (after every
//   group's epilogue and a proxy fence) orders the planes and frees the
//   weight stage. Shared memory: 2 weight stages (73,728 bytes), 2 planes
//   (61,440), the next tile's f32 input (86,016) and 3 mbarriers from a
//   1024-aligned base, 222,232 bytes with the slack: one block an SM (so
//   too by its 512 threads' registers).
// * Grid: persistent, min(tiles, SMs) blocks, block b taking tiles b,
//   b + grid, ...; a cp.async.bulk per game brings the next tile's input
//   while the current one computes, and its output stores drain behind the
//   next. At B=4096, 512 tiles on 132 SMs: 3.88 waves (116 blocks take 4
//   tiles, 16 take 3).
// * The epilogue keeps the reference's order of operations: the exact
//   int->float conversion, * 2^-9, + the residual, ReLU, * 32, rint (half
//   to even), clip. Built with --fmad=false. Each layer's kind is a
//   template argument, so a block's first conv, which keeps no f, scales
//   once by 2^-4 (exact: both scales are powers of two); rint and the clip
//   are one add of 1.5 * 2^23 to min(f * 32, 127) (f >= 0 after the ReLU),
//   the integer in the sum's low byte: no float->int conversion, which
//   runs on the SM's narrower conversion unit (int->float compiles to
//   I2FP, an ALU instruction).
// * A tail tile (B not a multiple of 8) computes its missing games on zeros
//   and stores nothing for them. Every thread runs every wgmma of its group
//   and reaches every barrier and mbarrier wait.
//
// What bounds it on an H100: the reference's count, every cell's 9 taps,
// is 2 * 42 * 576 * 64 * 11 = 34.1 Mop per game (1.395e11 at B=4096, 0.0705
// ms at the int8 tensor cores' 1979 TOP/s); the taps whose neighbour is on
// the board (304 of a game's 378 pairs) need 27.4 Mop (0.0567 ms, the bound
// chip_smoke.py and PERF.md use), against 21.5 KB of input and output per
// game (88.5 MB, 0.026 ms at 3.35 TB/s): operations. The padded layout
// computes 1.66x the on-board count (0.094 ms at the peak rate). At N = 64
// each m64n64k32 reads 2 KB of A and 2 KB of B from shared memory per 32
// tensor-core clocks, the whole 128 B/clk of the SM.
#include <cuda_runtime.h>
#include <stdint.h>
#ifndef CUDA_EMU
#include <cuda.h>
#endif

namespace {

constexpr int kRows = 6, kCols = 7, kCells = kRows * kCols;
constexpr int kCh = 64;
constexpr int kTaps = 9;
constexpr int kK = kTaps * kCh;                 // 576
constexpr int kLayers = 11;
constexpr int kG = 8;                           // games per tile
constexpr int kPadCols = 8;                     // a board row and its zero column
constexpr int kGameRows = kPadCols * (1 + kRows);   // 56: a zero row, then 6 rows of 8
constexpr int kM = kG * kGameRows;              // 448 output rows a tile
constexpr int kTileM = 64;                      // wgmma's M
constexpr int kTiles = kM / kTileM;             // 7 m64 tiles
constexpr int kHalo = 16;                       // zero plane rows before and after the games
constexpr int kPlaneRows = kHalo + kM + kHalo;  // 480
constexpr int kChunk = 16;                      // channels (bytes) of a core-matrix row
constexpr int kChunks = kCh / kChunk;           // 4
constexpr int kChunkBytes = kPlaneRows * kChunk;   // 7,680: LBO of the A descriptor
constexpr int kPlaneBytes = kChunks * kChunkBytes;  // 30,720
constexpr int kTapBytes = kCh * kCh;            // 4,096: one tap's B tile
constexpr int kStageBytes = kTaps * kTapBytes;  // 36,864: one layer's weights
constexpr int kGroups = 4;                      // warpgroups a block
constexpr int kThreads = 128 * kGroups;         // 512
constexpr int kTilesPerGroup = (kTiles + kGroups - 1) / kGroups;   // 2
constexpr int kGameBytes = kCells * kCh * 4;    // 10,752: one game's f32 input
constexpr int kPlaneOff = 2 * kStageBytes;      // 73,728
constexpr int kInputOff = kPlaneOff + 2 * kPlaneBytes;   // 135,168: the next tile's x
constexpr int kBarOff = kInputOff + kG * kGameBytes;     // 221,184: 3 mbarriers
constexpr int kAlign = 1024;
constexpr int kSmemBytes = kBarOff + 24 + kAlign;        // 222,232
constexpr float kAccScale = 1.0f / 512.0f;      // WSCALE / ASCALE
constexpr float kAScale = 32.0f;                // ASCALE

static_assert(kM % kTileM == 0, "m64 tiles cover the tile");
static_assert(kHalo >= kPadCols + 1, "the halo covers the +-9-row shifts");
static_assert(kTileM * kTilesPerGroup * kGroups >= kM, "the groups cover the tiles");
static_assert(kSmemBytes <= 232448, "a block's dynamic shared memory on sm_90");
static_assert(kPlaneOff % kAlign == 0 && kTapBytes % 512 == 0, "B tiles on the swizzle's 512-byte period");

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all >> 4), layout type in bits 62-63 (0 no swizzle, 2 the
// 64-byte swizzle).
constexpr uint64_t kLayoutNone = 0, kLayoutB64 = 2;
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((saddr & 0x3ffff) >> 4) | (uint64_t)((lbo & 0x3ffff) >> 4) << 16 |
         (uint64_t)((sbo & 0x3ffff) >> 4) << 32 | layout << 62;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
#ifdef CUDA_EMU
  emu_mbarrier_init(bar, count);
#else
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
#endif
}

// the barriers' initialisation, visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
#ifndef CUDA_EMU
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
#ifdef CUDA_EMU
  emu_mbarrier_arrive_expect_tx(bar, bytes);
#else
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
#endif
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
#ifdef CUDA_EMU
  while (!emu_mbarrier_try_wait_parity(bar, parity)) {
  }
#else
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
#endif
}

// One TMA box of the tensor map at (c0 bytes, c1 rows) into shared memory,
// completing on the mbarrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
#ifdef CUDA_EMU
  emu_tma_load_2d(dst, map, c0, c1, bar);
#else
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
#endif
}

// cp.async.bulk: `bytes` (a multiple of 16) from global to shared memory,
// completing on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, unsigned bytes,
                                          uint32_t bar) {
#ifdef CUDA_EMU
  emu_bulk_load(dst, src, bytes, bar);
#else
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
#endif
}

// Writes of the generic proxy to shared memory, visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
#ifndef CUDA_EMU
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_fence() {
#ifdef CUDA_EMU
  emu_wgmma_fence();
#else
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#ifdef CUDA_EMU
  emu_wgmma_commit_group();
#else
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_wait_all() {
#ifdef CUDA_EMU
  emu_wgmma_wait_group(0);
#else
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#endif
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(int32_t (&d)[32]) {
#ifndef CUDA_EMU
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
#endif
}

// wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8: d (+)= A B^T, A 64 x 32
// and B 64 x 32 int8 from the descriptors; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
#ifdef CUDA_EMU
  emu_wgmma_m64nNk32_s8(d, 64, da, db, accumulate);
#else
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
#endif
}

// f32 -> int8 at ASCALE: round half to even, clip to +-127.
__device__ __forceinline__ int quantize(float f) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(f, kAScale)), -127.0f), 127.0f);
}

// The cell (game-major row of x and out) of padded row m, or -1 for a pad.
__device__ __forceinline__ int cell_of(int m) {
  const int g = m / kGameRows, p = m % kGameRows;
  const int r = p / kPadCols - 1, c = p % kPadCols;
  return (r >= 0 && c < kCols) ? g * kCells + r * kCols + c : -1;
}

// The float bits of min(qf, 127) + 1.5 * 2^23 for qf = f * 32 >= 0 (after
// the ReLU): rint(f * 32) >= 0, so only the upper clip binds, and the add
// rounds half to even onto the integer in its low byte: quantize(f).
__device__ __forceinline__ uint32_t quantized_bits(float qf) {
  return __float_as_uint(__fadd_rn(fminf(qf, 127.0f), 12582912.0f));
}

// What a layer's epilogue computes, by its place in the tower.
enum Kind {
  kStem,     // layer 0: f = relu(acc 2^-9), kept as the residual
  kFirst,    // a block's first conv: only q = quantize(relu(acc 2^-9))
  kSecond,   // a block's second conv: f = relu(acc 2^-9 + res), kept
  kLast,     // the last conv: f = relu(acc 2^-9 + res) is the output
};

// One m64 tile's epilogue for this thread's 32 outputs (rows gid and gid + 8
// of its warp's 16, channels 8j + 2tq + {0, 1}): q = quantize(f) into the
// output plane (0 in pad rows), or f to out after the last layer. The
// scales are powers of two, so relu(acc 2^-9) * 32 = relu(acc 2^-4) exactly.
// A game's leading pad row is a whole 8-row group of a warp: it only stores
// zeros.
template <Kind kKind>
__device__ __forceinline__ void epilogue(const int32_t (&acc)[32], float (&res)[32], int mt,
                                         unsigned char* qout, float* __restrict__ out, size_t row0,
                                         int live) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tq = lane % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {   // fragment rows gid and gid + 8
    const int m0 = mt * kTileM + (threadIdx.x % 128) / 32 * 16 + 8 * hr;   // warp-uniform
    const int m = m0 + gid;
    const int cell = cell_of(m);
    unsigned char* qrow = qout + (kHalo + m) * kChunk + 2 * tq;
    if (m0 % kGameRows == 0) {   // the pad row before a game
      if (kKind != kLast) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint16_t*>(qrow + (j / 2) * kChunkBytes + (j % 2) * 8) = 0;
      }
      continue;
    }
    const bool on_board = cell >= 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {   // n8 blocks
      float f[2];
      uint32_t q[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 4 * j + 2 * hr + e;
        const float a = __int2float_rn(acc[k]);
        if (kKind == kFirst) {
          q[e] = quantized_bits(fmaxf(__fmul_rn(a, kAScale * kAccScale), 0.0f));
        } else {
          float v = __fmul_rn(a, kAccScale);
          if (kKind != kStem) v = __fadd_rn(v, res[k]);
          v = fmaxf(v, 0.0f);
          res[k] = v;
          f[e] = v;
          q[e] = quantized_bits(__fmul_rn(v, kAScale));
        }
      }
      if (kKind != kLast) {
        *reinterpret_cast<uint16_t*>(qrow + (j / 2) * kChunkBytes + (j % 2) * 8) =
            on_board ? (uint16_t)__byte_perm(q[0], q[1], 0x0040) : (uint16_t)0;
      } else if (on_board && cell < live * kCells) {
        *reinterpret_cast<float2*>(out + (row0 + cell) * kCh + 8 * j + 2 * tq) =
            make_float2(f[0], f[1]);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | (uint32_t)(b & 0xff) << 8 | (uint32_t)(c & 0xff) << 16 |
         (uint32_t)(d & 0xff) << 24;
}

// Thread 0: one layer's 9 weight boxes into a stage of the ring.
__device__ __forceinline__ void load_layer(const CUtensorMap* map, uint32_t stage, uint32_t bar,
                                           int layer) {
  mbar_expect_tx(bar, kStageBytes);
#pragma unroll 1
  for (int tap = 0; tap < kTaps; ++tap)
    tma_load_2d(stage + tap * kTapBytes, map, tap * kCh, layer * kCh, bar);
}

// What every layer of a tile reads: the weights' tensor map, the shared
// base (weight stages, planes, mbarriers), the output and the tile's games.
struct Tower {
  const CUtensorMap* wmap;
  uint32_t base;
  unsigned char* planes;
  float* out;
  size_t row0;
  int live;
};

// One layer of a tile, the block's `step`-th (of `steps`): its weights'
// stage and input plane, each of the group's m64 tiles (18 wgmma, then the
// epilogue into the other plane), then the barrier after which the stage
// takes the weights of the block's step after next (the next tile's layer 0
// or 1 at the end of a tile).
template <Kind kKind>
__device__ __forceinline__ void layer_pass(const Tower& tw, float (&res)[kTilesPerGroup][32],
                                           int layer, int step, int steps) {
  const int stage = step & 1, group = threadIdx.x / 128;
  const uint32_t wst = tw.base + stage * kStageBytes, bar = tw.base + kBarOff + 8 * stage;
  mbar_wait(bar, (step >> 1) & 1);
  const uint32_t qin = tw.base + kPlaneOff + (layer & 1) * kPlaneBytes;
  unsigned char* qout = tw.planes + ((layer + 1) & 1) * kPlaneBytes;
#pragma unroll
  for (int t = 0; t < kTilesPerGroup; ++t) {
    const int mt = group + kGroups * t;   // the m64 tile
    if (mt >= kTiles) continue;            // warpgroup-uniform
    int32_t acc[32];
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int shift = (tap / 3 - 1) * kPadCols + (tap % 3 - 1);   // rows to the neighbour
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // input channels 0..31, 32..63
        const uint64_t da =
            make_desc(qin + 2 * h * kChunkBytes + (kHalo + mt * kTileM + shift) * kChunk,
                      kChunkBytes, 8 * kChunk, kLayoutNone);
        const uint64_t db = make_desc(wst + tap * kTapBytes + h * 32, 16, 8 * 64, kLayoutB64);
        wgmma_s8(acc, da, db, tap | h);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    epilogue<kKind>(acc, res[t], mt, qout, tw.out, tw.row0, tw.live);
  }
  fence_proxy_async();
  __syncthreads();   // every group's reads of this stage and plane, and writes of the next plane
  if (threadIdx.x == 0 && step + 2 < steps) load_layer(tw.wmap, wst, bar, (layer + 2) % kLayers);
}

// Thread 0: the f32 input of tile `tile`'s games (contiguous rows of x)
// into the input buffer, completing on the mbarrier.
__device__ __forceinline__ void load_input(const float* x, int B, int tile, uint32_t dst,
                                           uint32_t bar) {
  const int game0 = tile * kG, live = min(kG, B - game0);
  mbar_expect_tx(bar, live * kGameBytes);
#pragma unroll 1
  for (int g = 0; g < live; ++g)
    bulk_load(dst + g * kGameBytes, x + (size_t)(game0 + g) * kCells * kCh, kGameBytes, bar);
}

__global__ void __launch_bounds__(kThreads, 1)
    int8_tower_kernel(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ x,
                      float* __restrict__ out, int B) {
  extern __shared__ uint4 tower_smem[];
  // a 1024-aligned base: [weight stage 0 | stage 1 | q plane 0 | plane 1 |
  // the next tile's input | mbarriers of stage 0, stage 1, the input]; a
  // tile's layer l computes from plane l % 2 into the other plane
  const uint32_t raw = smem_addr(tower_smem);
  const uint32_t pad = (kAlign - raw % kAlign) % kAlign;
  unsigned char* smem = reinterpret_cast<unsigned char*>(tower_smem) + pad;
  const uint32_t base = raw + pad;
  const uint32_t bar0 = base + kBarOff;
  unsigned char* planes = smem + kPlaneOff;

  // the block's tiles of kG games: blockIdx.x, + gridDim.x, ... (gridDim.x <= tiles)
  const int tiles = (B + kG - 1) / kG;
  const int iters = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const uint32_t xbar = bar0 + 16, input = base + kInputOff;
  const float* xs = reinterpret_cast<const float*>(smem + kInputOff);

  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init(xbar, 1);
    fence_mbar_init();
    load_layer(&wmap, base, bar0, 0);
    load_layer(&wmap, base + kStageBytes, bar0 + 8, 1);
    load_input(x, B, blockIdx.x, input, xbar);
  }
  // the halo rows of both planes, zero for the whole launch
  for (int i = threadIdx.x; i < 2 * 2 * kHalo * kChunks; i += kThreads) {
    const int plane = i / (2 * kHalo * kChunks), j = i / (2 * kHalo) % kChunks, r = i % (2 * kHalo);
    const int pr = r < kHalo ? r : kM + r;
    *reinterpret_cast<uint4*>(planes + plane * kPlaneBytes + j * kChunkBytes + pr * kChunk) =
        uint4{0u, 0u, 0u, 0u};
  }
  __syncthreads();   // the mbarriers are initialised before anyone waits on them

  float res[kTilesPerGroup][32];   // the f32 residual f of this thread's outputs
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    const int game0 = tile * kG;
    const int live = min(kG, B - game0);   // games of this tile that exist
    const size_t row0 = (size_t)game0 * kCells;
    // the input, quantized, into plane 0 at the padded rows (zeros in every
    // pad row and for missing games); plane 1's rows are written by every
    // layer's epilogue
    mbar_wait(xbar, it & 1);
    for (int i = threadIdx.x; i < kM * kChunks; i += kThreads) {
      const int m = i / kChunks, j = i % kChunks;
      const int cell = cell_of(m);
      uint4 v = {0u, 0u, 0u, 0u};
      if (cell >= 0 && cell < live * kCells) {
        const float4* src = reinterpret_cast<const float4*>(xs + cell * kCh + j * kChunk);
        uint32_t word[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 f = src[q];
          word[q] = pack4(quantize(f.x), quantize(f.y), quantize(f.z), quantize(f.w));
        }
        v = {word[0], word[1], word[2], word[3]};
      }
      *reinterpret_cast<uint4*>(planes + j * kChunkBytes + (kHalo + m) * kChunk) = v;
    }
    fence_proxy_async();
    __syncthreads();   // the input buffer is free: the next tile's input comes during this one
    if (threadIdx.x == 0 && it + 1 < iters) load_input(x, B, tile + gridDim.x, input, xbar);

    const Tower tw = {&wmap, base, planes, out, row0, live};
    const int step = it * kLayers, steps = iters * kLayers;
    layer_pass<kStem>(tw, res, 0, step, steps);
#pragma unroll 1
    for (int layer = 1; layer < kLayers - 2; layer += 2) {
      layer_pass<kFirst>(tw, res, layer, step + layer, steps);
      layer_pass<kSecond>(tw, res, layer + 1, step + layer + 1, steps);
    }
    layer_pass<kFirst>(tw, res, kLayers - 2, step + kLayers - 2, steps);
    layer_pass<kLast>(tw, res, kLayers - 1, step + kLayers - 1, steps);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

extern "C" {

// x f32[B*42, 64] and w int8[11, 64, 576], both 16-byte aligned (the
// wrapper checks); out f32[B*42, 64].
int az_int8_tower(const float* x, const int8_t* w, float* out, int B, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // w as [11 * 64 rows (layer, output channel), 576 bytes (tap, input
  // channel)]; a box is one tap of one layer, 64 rows x 64 bytes
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)kK, (cuuint64_t)kLayers * kCh};
  const cuuint64_t strides[1] = {(cuuint64_t)kK};
  const cuuint32_t box[2] = {(cuuint32_t)kCh, (cuuint32_t)kCh};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return (int)cudaGetLastError();
  const unsigned int blocks = (unsigned int)min((B + kG - 1) / kG, sms);   // one block an SM
  int8_tower_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(wmap, x, out, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
