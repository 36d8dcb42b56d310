// CPU stand-in for the few CUDA runtime features alphazero_tpu_torch's
// csrc/*.cu kernels use, so their logic compiles with g++ and runs on the
// host (tests/test_torch_kernels.py). Each launch runs its blocks one after
// another, each block's threads as fibers on the calling host thread (below,
// "Block threads as fibers") meeting at a barrier for __syncthreads(); a
// __shared__ array is a static one, which the block's threads share
// (blocks run one at a time), and the launch's
// dynamic shared memory one buffer (the test rewrites each
// `extern __shared__ T name[];` into a pointer to it). The round-to-nearest
// intrinsics are plain IEEE float operations (build with
// -ffp-contract=off), as on the card; expf and tanhf are glibc's, which
// may differ from the card's in the last bit. Inline PTX has no stand-in:
// a source keeps it under `#ifndef CUDA_EMU` and calls the emulated
// instruction below (emu_mma_m16n8k16_bf16,
// emu_cp_async16 and emu_cp_async_wait_all; Hopper's int8 wgmma, its fence,
// commit and wait, the mbarrier and the TMA tiled load, emu_wgmma_* ,
// emu_mbarrier_* and emu_tma_load_2d) otherwise; a source keeps
// `#include <cuda.h>` under it too, and the host's tensor-map encoder
// (cuTensorMapEncodeTiled, found through cudaGetDriverEntryPointByVersion)
// is emulated below. Each block starts
// with its dynamic shared memory filled with 0xff bytes (a bf16 or f32 NaN),
// so that a kernel that reads what it never wrote shows it. The warp
// intrinsics (__shfl_sync, __shfl_xor_sync, __ballot_sync, __syncwarp)
// meet the warp's threads at a barrier of their own, beside an exchange
// slot per lane: every lane of the warp must call them in the same order
// (the full mask, as the kernels use them), and a block's threads come in
// whole warps.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <math.h>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <sys/mman.h>
#include <vector>
#if !defined(__x86_64__)
#include <ucontext.h>
#endif

#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
#define __grid_constant__
#define CUDA_EMU 1

struct emu_dim3 { unsigned int x, y, z; };
inline emu_dim3 blockIdx, blockDim, gridDim;

// ---- Block threads as fibers --------------------------------------------
// A block's threads run as fibers on the launching host thread, each on a
// stack of its own, and switch only where a CUDA thread waits: at
// __syncthreads(), a warp collective, an mbarrier poll that fails, and the
// block's end. (OS threads meeting at futex barriers spent most of the
// tests' time in the kernel's scheduler, more so on a loaded host.) The
// scheduler resumes the runnable fibers in turn, alternating forward and
// backward passes (odd blocks starting backward), so that between two
// barriers a block's threads run in both orders over a launch; a block
// whose threads all wait on barriers that cannot complete (a thread
// returned before a __syncthreads(), a lane skipped a collective) aborts,
// where the card would hang.
enum emu_fiber_state { EMU_RUNNABLE, EMU_BLOCKED, EMU_DONE };
struct emu_fiber {
  emu_dim3 idx;            // threadIdx
  int warp_phase = 0;      // which exchange buffer its warp's next collective uses
  int state = EMU_DONE;
  unsigned char* stack = nullptr;
#if defined(__x86_64__)
  void* sp = nullptr;      // the saved stack pointer while switched out
#else
  ucontext_t ctx;
#endif
};
inline emu_fiber* emu_self = nullptr;   // the fiber running now
#define threadIdx (emu_self->idx)
inline constexpr size_t emu_fiber_stack_bytes = size_t(1) << 20;
inline std::vector<std::unique_ptr<emu_fiber>> emu_fibers;
inline void (*emu_body_fn)(void*) = nullptr;   // the launch's kernel call
inline void* emu_body_arg = nullptr;

#if defined(__x86_64__)
// emu_ctx_switch(save, load): push the callee-saved registers and the
// x87/SSE control words, store the stack pointer at *save, take `load` as
// the stack pointer and pop the same. A new fiber's stack starts as if
// switched out just before emu_ctx_start, which calls r13(r12). Weak, as
// every source that includes this header defines it.
extern "C" void emu_ctx_switch(void** save, void* load);
extern "C" void emu_ctx_start();
asm(R"(
  .pushsection .text
  .weak emu_ctx_switch
  .type emu_ctx_switch, @function
emu_ctx_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  subq $8, %rsp
  stmxcsr (%rsp)
  fnstcw 4(%rsp)
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  ldmxcsr (%rsp)
  fldcw 4(%rsp)
  addq $8, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_ctx_switch, .-emu_ctx_switch
  .weak emu_ctx_start
  .type emu_ctx_start, @function
emu_ctx_start:
  movq %r12, %rdi
  callq *%r13
  ud2
  .size emu_ctx_start, .-emu_ctx_start
  .popsection
)");
inline void* emu_sched_sp = nullptr;
inline void emu_to_scheduler() { emu_ctx_switch(&emu_self->sp, emu_sched_sp); }
inline void emu_to_fiber(emu_fiber* f) { emu_ctx_switch(&emu_sched_sp, f->sp); }
#else
inline ucontext_t emu_sched_ctx;
inline void emu_to_scheduler() { swapcontext(&emu_self->ctx, &emu_sched_ctx); }
inline void emu_to_fiber(emu_fiber* f) { swapcontext(&emu_sched_ctx, &f->ctx); }
#endif

// A fiber's life: one block's run of the kernel as thread f->idx.
inline void emu_fiber_main(emu_fiber* f) {
  emu_body_fn(emu_body_arg);
  f->state = EMU_DONE;
  emu_to_scheduler();
  std::abort();   // a finished fiber is never resumed
}
// Ready f to start the kernel at its next resume.
inline void emu_fiber_reset(emu_fiber* f) {
  f->state = EMU_RUNNABLE;
  f->warp_phase = 0;
#if defined(__x86_64__)
  // the frame emu_ctx_switch pops: control words, r15, r14, r13, r12, rbx,
  // rbp, then the return address; 16-byte aligned after the ret
  uint64_t* top = reinterpret_cast<uint64_t*>(f->stack + emu_fiber_stack_bytes) - 10;
  uint32_t mxcsr;
  uint16_t fpucw;
  asm volatile("stmxcsr %0" : "=m"(mxcsr));
  asm volatile("fnstcw %0" : "=m"(fpucw));
  top[0] = mxcsr | (uint64_t)fpucw << 32;
  top[1] = top[2] = 0;                                        // r15, r14
  top[3] = reinterpret_cast<uint64_t>(&emu_fiber_main);       // r13
  top[4] = reinterpret_cast<uint64_t>(f);                     // r12
  top[5] = top[6] = 0;                                        // rbx, rbp
  top[7] = reinterpret_cast<uint64_t>(&emu_ctx_start);
  f->sp = top;
#else
  getcontext(&f->ctx);
  f->ctx.uc_stack.ss_sp = f->stack;
  f->ctx.uc_stack.ss_size = emu_fiber_stack_bytes;
  f->ctx.uc_link = nullptr;
  makecontext(&f->ctx, reinterpret_cast<void (*)()>(&emu_fiber_main), 1, f);
#endif
}
inline emu_fiber* emu_fiber_at(unsigned t) {
  while (emu_fibers.size() <= t) {
    auto f = std::make_unique<emu_fiber>();
    void* mem = mmap(nullptr, emu_fiber_stack_bytes, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (mem == MAP_FAILED) std::abort();
    mprotect(mem, 4096, PROT_NONE);   // a guard page: an overflow faults
    f->stack = static_cast<unsigned char*>(mem);
    emu_fibers.push_back(std::move(f));
  }
  return emu_fibers[t].get();
}
// Run threads 0 .. threads-1 of one block to their end.
inline void emu_run_block(unsigned threads) {
  for (unsigned t = 0; t < threads; ++t) {
    emu_fiber* f = emu_fiber_at(t);
    f->idx = {t, 0, 0};
    emu_fiber_reset(f);
  }
  unsigned done = 0;
  bool backward = blockIdx.x & 1;   // odd blocks start backward: both orders from the start
  while (done < threads) {
    bool ran = false;
    for (unsigned i = 0; i < threads; ++i) {
      emu_fiber* f = emu_fibers[backward ? threads - 1 - i : i].get();
      if (f->state != EMU_RUNNABLE) continue;
      ran = true;
      emu_self = f;
      emu_to_fiber(f);
      if (f->state == EMU_DONE) ++done;
    }
    if (!ran) {
      std::fprintf(stderr, "emulated block %u: every thread waits at a barrier that cannot complete\n",
                   blockIdx.x);
      std::abort();
    }
    backward = !backward;
  }
  emu_self = nullptr;
}
// A barrier of `count` block threads: the last to arrive releases the others.
struct emu_barrier {
  unsigned count = 0, arrived = 0;
  std::vector<emu_fiber*> waiting;
  explicit emu_barrier(unsigned n) : count(n) {}
  void arrive_and_wait() {
    if (++arrived == count) {
      arrived = 0;
      for (emu_fiber* f : waiting) f->state = EMU_RUNNABLE;
      waiting.clear();
      return;
    }
    emu_fiber* me = emu_self;
    waiting.push_back(me);
    me->state = EMU_BLOCKED;
    emu_to_scheduler();
  }
};
inline emu_barrier* emu_block_barrier = nullptr;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
constexpr cudaError_t cudaErrorSymbolNotFound = 500;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
// The emulated card's multiprocessors: few, so that a persistent grid's
// blocks walk several tiles in the tests.
inline int emu_multiprocessors = 2;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* device) { *device = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *value = emu_multiprocessors;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return 0; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline unsigned char* emu_dynamic_smem = nullptr;
inline size_t emu_dynamic_smem_bytes = 0;
// The shared-window address of the dynamic buffer: 16-byte aligned, as the
// card guarantees, and no more, so a kernel that needs a 1024-byte base
// has to align it itself.
inline constexpr uint32_t emu_smem_window = 0x410;
inline size_t __cvta_generic_to_shared(const void* p) {
  return (size_t)(static_cast<const unsigned char*>(p) - emu_dynamic_smem) + emu_smem_window;
}
// The dynamic buffer's bytes at a shared-window address; aborts outside it.
inline unsigned char* emu_smem_ptr(uint32_t addr, size_t bytes = 1) {
  if (addr < emu_smem_window || addr - emu_smem_window + bytes > emu_dynamic_smem_bytes) std::abort();
  return emu_dynamic_smem + (addr - emu_smem_window);
}
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

// The warps of the running block: a barrier each and a double-buffered
// exchange slot per lane. A collective writes its lane's slot of the
// buffer this call uses, meets the warp at the barrier and reads; the
// next call uses the other buffer, so a lane that runs ahead never
// overwrites a slot another lane has still to read (it cannot pass the
// next barrier before that lane has read).
struct emu_warp {
  emu_barrier* bar;
  uint64_t slot[2][32];
};
inline std::vector<emu_warp> emu_warps;
// Post this lane's value, meet the warp, return the slots of every lane.
inline const uint64_t* emu_warp_post(uint64_t v) {
  emu_warp& warp = emu_warps[threadIdx.x / 32];
  const int ph = emu_self->warp_phase;
  emu_self->warp_phase ^= 1;
  warp.slot[ph][threadIdx.x % 32] = v;
  warp.bar->arrive_and_wait();
  return warp.slot[ph];
}
template <class T>
T emu_shfl_from(T v, unsigned src) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "a warp shuffle moves at most 8 bytes");
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  const uint64_t got = emu_warp_post(bits)[src % 32];
  T r;
  std::memcpy(&r, &got, sizeof(T));
  return r;
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return emu_shfl_from(v, (threadIdx.x % 32) ^ (unsigned)lane_mask);
}
template <class T>
T __shfl_sync(unsigned, T v, int src_lane) {
  return emu_shfl_from(v, (unsigned)src_lane);
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const uint64_t* slots = emu_warp_post(pred ? 1u : 0u);
  const unsigned lanes = std::min(32u, blockDim.x - threadIdx.x / 32 * 32);
  unsigned bits = 0;
  for (unsigned l = 0; l < lanes; ++l) bits |= (unsigned)(slots[l] & 1u) << l;
  return bits;
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warps[threadIdx.x / 32].bar->arrive_and_wait(); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline unsigned int __float_as_uint(float x) {
  unsigned int u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned int u) {
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
}
inline float __int2float_rn(int x) { return static_cast<float>(x); }
// prmt.b32 (default mode): byte i of the result is byte s of the 8 bytes
// {y, x} (x the low four), s the i-th nibble of the selector
inline unsigned int __byte_perm(unsigned int x, unsigned int y, unsigned int s) {
  const uint64_t bytes = (uint64_t)y << 32 | x;
  unsigned int r = 0;
  for (int i = 0; i < 4; ++i) r |= (unsigned int)(bytes >> (8 * (s >> (4 * i) & 7)) & 0xff) << (8 * i);
  return r;
}
using std::fmaxf;
using std::min;

struct uint4 { unsigned int x, y, z, w; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

// m_tiles x n_tiles instructions mma.sync.aligned.m16n8k16.row.col.f32.bf16
// .bf16.f32 of the calling thread's warp: d[i][j][0..3] += A_i B_j, with the
// PTX ISA's fragments: lane l = 4 * gid + tq holds of A_i (16x16, row-major)
// a[i][0] = row gid, k 2tq, 2tq+1; a[i][1] = row gid + 8, the same k;
// a[i][2], a[i][3] the same rows at k 8 + 2tq, 8 + 2tq + 1; of B_j (16x8)
// b[j][0] = k 2tq, 2tq+1 of column gid, b[j][1] = k 8 + 2tq, 8 + 2tq + 1;
// of D rows gid (d 0, 1) and gid + 8 (d 2, 3), columns 2tq and 2tq + 1; two
// bf16 a register, the lower k in the lower half. Each product is exact; an
// instruction's 16 products and its accumulator are summed in float64 and
// rounded once to f32. Block-collective: every thread of the block stages
// its fragments, meets the others at a barrier, computes its own
// accumulators from its warp's 32 lanes and meets them again, so the kernel
// must issue its MMAs block-uniformly (as the card needs them warp-uniform).
inline constexpr int emu_mma_max_words = 32;
inline uint32_t emu_mma_stage[1024][emu_mma_max_words];
inline float emu_bf16_half(uint32_t word, int k) {
  const uint32_t u = (k % 2 ? word >> 16 : word & 0xffffu) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline void emu_mma_m16n8k16_bf16(float* d, const uint32_t* a, const uint32_t* b, int m_tiles,
                                  int n_tiles) {
  const int na = 4 * m_tiles, nb = 2 * n_tiles;
  if (na + nb > emu_mma_max_words) std::abort();
  const unsigned t = threadIdx.x, lane = t % 32, warp0 = t - lane;
  std::memcpy(emu_mma_stage[t], a, na * sizeof(uint32_t));
  std::memcpy(emu_mma_stage[t] + na, b, nb * sizeof(uint32_t));
  __syncthreads();
  const int gid = lane / 4, tq = lane % 4;
  for (int i = 0; i < m_tiles; ++i) {
    for (int j = 0; j < n_tiles; ++j) {
      for (int e = 0; e < 4; ++e) {
        const int row = gid + 8 * (e / 2), col = 2 * tq + e % 2;
        float& out = d[(i * n_tiles + j) * 4 + e];
        double sum = out;
        for (int k = 0; k < 16; ++k) {
          const unsigned src = k % 8 / 2;   // the thread in group holding k
          const uint32_t* la = emu_mma_stage[warp0 + 4 * (row % 8) + src];
          const uint32_t* lb = emu_mma_stage[warp0 + 4 * col + src];
          sum += (double)emu_bf16_half(la[4 * i + row / 8 + 2 * (k / 8)], k) *
                 (double)emu_bf16_half(lb[na + 2 * j + k / 8], k);
        }
        out = (float)sum;
      }
    }
  }
  __syncthreads();
}

// cp.async of 16 bytes from device to shared memory: the copy lands only
// when the issuing thread waits (emu_cp_async_wait_all, the stand-in of
// cp.async.wait_all), so a read before the wait sees the old bytes. A
// thread that ends with copies it never waited for aborts the launch.
struct emu_cp_async_copy { void* dst; const void* src; };
inline std::vector<std::vector<emu_cp_async_copy>> emu_cp_async_pending;   // by thread
inline void emu_cp_async16(void* dst, const void* src) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16) std::abort();
  emu_cp_async_pending[threadIdx.x].push_back({dst, src});
}
inline void emu_cp_async_wait_all() {
  auto& mine = emu_cp_async_pending[threadIdx.x];
  for (const auto& c : mine) std::memcpy(c.dst, c.src, 16);
  mine.clear();
}

// ---- Hopper: the TMA tiled load, mbarriers and int8 wgmma -------------

// The driver's tensor-map types (cuda.h), as far as the kernels use them.
typedef int CUresult;
constexpr CUresult CUDA_SUCCESS = 0;
constexpr CUresult CUDA_ERROR_INVALID_VALUE = 1;
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_32B = 1,
                          CU_TENSOR_MAP_SWIZZLE_64B = 2, CU_TENSOR_MAP_SWIZZLE_128B = 3 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0,
                                       cudaDriverEntryPointSymbolNotFound = 1 };
constexpr unsigned long long cudaEnableDefault = 0;
// A 2-D tiled tensor map of bytes: what cuTensorMapEncodeTiled recorded.
struct alignas(64) CUtensorMap {
  const unsigned char* base;
  uint64_t dims[2];   // bytes of a row, rows
  uint64_t stride;    // bytes from one row to the next
  uint32_t box[2];    // bytes, rows
  int swizzle;        // CUtensorMapSwizzle
};

// The 16-byte-unit swizzle of a shared-memory address, as TMA writes and
// wgmma reads it: bits [4, 4 + b) ^= bits [7, 7 + b), b = 1, 2, 3 for the
// 32-, 64- and 128-byte modes (CUTLASS's Swizzle<b, 4, 3>).
inline uint32_t emu_swizzle(uint32_t addr, int b) {
  return addr ^ (((addr >> 7) & ((1u << b) - 1)) << 4);
}

// cuTensorMapEncodeTiled for 2-D maps of bytes; with a swizzle, only a box
// row of exactly the swizzle's span is emulated (the driver also takes
// narrower).
inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                 void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* elem_strides,
                                 CUtensorMapInterleave interleave, CUtensorMapSwizzle swizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  const uint32_t span = swizzle == CU_TENSOR_MAP_SWIZZLE_NONE ? 0u : 16u << swizzle;
  if (type != CU_TENSOR_MAP_DATA_TYPE_UINT8 || rank != 2 || reinterpret_cast<uintptr_t>(base) % 16 ||
      strides[0] % 16 || strides[0] < dims[0] || box[0] < 1 || box[0] > 256 || box[1] < 1 ||
      box[1] > 256 || box[0] % 16 || elem_strides[0] != 1 || elem_strides[1] != 1 ||
      interleave != CU_TENSOR_MAP_INTERLEAVE_NONE || (span && box[0] != span))
    return CUDA_ERROR_INVALID_VALUE;
  *map = {static_cast<const unsigned char*>(base), {dims[0], dims[1]}, strides[0],
          {box[0], box[1]}, (int)swizzle};
  return CUDA_SUCCESS;
}

inline cudaError_t cudaGetDriverEntryPointByVersion(const char* symbol, void** fn, unsigned int,
                                                    unsigned long long,
                                                    cudaDriverEntryPointQueryResult* status) {
  const bool found = std::strcmp(symbol, "cuTensorMapEncodeTiled") == 0;
  *fn = found ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  if (status) *status = found ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}

// mbarriers, by shared address: init sets the arrival count; arrive
// (.expect_tx adds its bytes first) counts one arrival; a phase completes
// when every arrival is in and every expected byte has landed, and the next
// phase begins. try_wait.parity(P) is true once the phase of parity P is
// complete: current phase parity != P. A TMA load lands only when a thread
// waits on its barrier (then its bytes complete), so a read of the tile
// before that wait sees the old bytes.
struct emu_tma_copy { uint32_t dst; CUtensorMap map; int c0, c1; };
struct emu_bulk_copy { uint32_t dst; const void* src; uint32_t bytes; };
struct emu_mbar {
  unsigned count = 0, pending = 0, phase = 0;
  long long tx = 0;
  std::vector<emu_tma_copy> copies;
  std::vector<emu_bulk_copy> bulk;
};
inline std::mutex emu_mbar_mutex;
inline std::map<uint32_t, emu_mbar> emu_mbars;

inline emu_mbar& emu_mbar_at(uint32_t bar) {
  const auto it = emu_mbars.find(bar);
  if (it == emu_mbars.end() || bar % 8) std::abort();   // not initialised, or misaligned
  return it->second;
}
inline void emu_mbar_complete(emu_mbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    ++b.phase;
    b.pending = b.count;
  }
}
inline void emu_mbarrier_init(uint32_t bar, unsigned count) {
  std::lock_guard<std::mutex> lock(emu_mbar_mutex);
  emu_smem_ptr(bar, 8);
  if (bar % 8 || count == 0) std::abort();
  emu_mbar& b = emu_mbars[bar];
  b = emu_mbar{};
  b.count = b.pending = count;
}
inline void emu_mbarrier_arrive_expect_tx(uint32_t bar, unsigned bytes) {
  std::lock_guard<std::mutex> lock(emu_mbar_mutex);
  emu_mbar& b = emu_mbar_at(bar);
  if (b.pending == 0) std::abort();
  b.tx += bytes;
  --b.pending;
  emu_mbar_complete(b);
}
// cp.async.bulk.tensor.2d ... mbarrier::complete_tx::bytes [dst], [map, {c0, c1}], [bar]
inline void emu_tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  std::lock_guard<std::mutex> lock(emu_mbar_mutex);
  if (dst % 128) std::abort();
  emu_smem_ptr(dst, (size_t)map->box[0] * map->box[1]);
  emu_mbar_at(bar).copies.push_back({dst, *map, c0, c1});
}
// cp.async.bulk ... mbarrier::complete_tx::bytes [dst], [src], bytes, [bar]
inline void emu_bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  std::lock_guard<std::mutex> lock(emu_mbar_mutex);
  if (dst % 16 || reinterpret_cast<uintptr_t>(src) % 16 || bytes % 16) std::abort();
  emu_smem_ptr(dst, bytes);
  emu_mbar_at(bar).bulk.push_back({dst, src, bytes});
}
// The box at (c0, c1): row r, byte i of the box to dst + r * box[0] + i,
// swizzled; bytes outside the tensor read zero.
inline void emu_tma_perform(const emu_tma_copy& c) {
  const CUtensorMap& m = c.map;
  for (uint32_t r = 0; r < m.box[1]; ++r) {
    for (uint32_t i = 0; i < m.box[0]; ++i) {
      const long long col = c.c0 + (long long)i, row = c.c1 + (long long)r;
      const bool inside = col >= 0 && row >= 0 && col < (long long)m.dims[0] && row < (long long)m.dims[1];
      uint32_t addr = c.dst + r * m.box[0] + i;
      if (m.swizzle) addr = emu_swizzle(addr, m.swizzle);
      *emu_smem_ptr(addr) = inside ? m.base[row * m.stride + col] : 0;
    }
  }
}
inline bool emu_mbarrier_try_wait_parity(uint32_t bar, unsigned parity) {
  bool done;
  {
    std::lock_guard<std::mutex> lock(emu_mbar_mutex);
    emu_mbar& b = emu_mbar_at(bar);
    for (const auto& c : b.copies) {
      emu_tma_perform(c);
      b.tx -= (long long)c.map.box[0] * c.map.box[1];
    }
    b.copies.clear();
    for (const auto& c : b.bulk) {
      std::memcpy(emu_smem_ptr(c.dst, c.bytes), c.src, c.bytes);
      b.tx -= c.bytes;
    }
    b.bulk.clear();
    emu_mbar_complete(b);
    done = (b.phase & 1u) != (parity & 1u);
  }
  if (!done) emu_to_scheduler();   // stays runnable: the others run, then it polls again
  return done;
}

// A wgmma shared-memory matrix descriptor's byte of row `row` (M or N), K
// byte `k`: start address, LBO and SBO in 16-byte units at bits 0, 16 and
// 32, the layout in bits 62-63 (0 no swizzle, 1 128-byte, 2 64-byte, 3
// 32-byte swizzle); K-major. No swizzle: 8 x 16-byte core matrices, rows
// 16 bytes apart, the next 8 rows SBO on, the next 16 K bytes LBO on.
// Swizzled: rows the swizzle's width apart (LBO unused), the next 8 rows
// SBO on, K contiguous, then the address swizzled. A base offset (bits
// 49-51) is not emulated.
inline const int8_t* emu_desc_row(uint64_t desc, int row, int k) {
  const uint32_t start = (uint32_t)(desc & 0x3fff) << 4;
  const uint32_t lbo = (uint32_t)(desc >> 16 & 0x3fff) << 4;
  const uint32_t sbo = (uint32_t)(desc >> 32 & 0x3fff) << 4;
  const int layout = (int)(desc >> 62);
  if (desc >> 49 & 7) std::abort();
  uint32_t addr;
  if (layout == 0) {
    addr = start + row / 8 * sbo + row % 8 * 16 + k / 16 * lbo + k % 16;
  } else {
    const int b = layout == 1 ? 3 : layout == 2 ? 2 : 1;
    addr = emu_swizzle(start + row / 8 * sbo + row % 8 * (16u << b) + k, b);
  }
  return reinterpret_cast<const int8_t*>(emu_smem_ptr(addr, 16));
}

// wgmma.mma_async.sync.aligned.m64nNk32.s32.s8.s8 of the calling thread's
// warpgroup, A and B from descriptors: D (+)= A B^T, A 64 x 32 and B N x 32
// bytes, both K-major. Thread t of the group holds d[4 j + e] = row 16 (t /
// 32 % 4) + t % 32 / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2 (the m16n8
// C fragment of each warp, for every n8 block j). Asynchronous, as on the
// card: the instruction is queued (a wgmma.fence must come first), its
// group is closed by commit_group, and it computes, reading shared memory
// then, only in the wait_group that retires the group; accumulate = 0
// overwrites d. A thread that ends with a group it never waited for aborts
// the launch.
struct emu_wgmma_op { int32_t* d; int n; uint64_t da, db; int accumulate; };
struct emu_wgmma_queue {
  std::vector<emu_wgmma_op> open;
  std::deque<std::vector<emu_wgmma_op>> groups;
  bool fenced = false;
};
inline std::vector<emu_wgmma_queue> emu_wgmma_queues;   // by thread
inline void emu_wgmma_fence() { emu_wgmma_queues[threadIdx.x].fenced = true; }
inline void emu_wgmma_m64nNk32_s8(int32_t* d, int n, uint64_t da, uint64_t db, int accumulate) {
  emu_wgmma_queue& q = emu_wgmma_queues[threadIdx.x];
  if (!q.fenced || n % 8 || n < 8 || n > 256) std::abort();
  q.open.push_back({d, n, da, db, accumulate});
}
inline void emu_wgmma_commit_group() {
  emu_wgmma_queue& q = emu_wgmma_queues[threadIdx.x];
  q.groups.push_back(std::move(q.open));
  q.open.clear();
}
inline void emu_wgmma_run(const emu_wgmma_op& op) {
  const unsigned t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + t % 32 / 4, tq = t % 4;
  int8_t a[2][32];
  for (int h = 0; h < 2; ++h)
    for (int c = 0; c < 2; ++c) std::memcpy(a[h] + 16 * c, emu_desc_row(op.da, r0 + 8 * h, 16 * c), 16);
  for (int j = 0; j < op.n / 8; ++j) {
    for (int e = 0; e < 2; ++e) {
      int8_t b[32];
      for (int c = 0; c < 2; ++c) std::memcpy(b + 16 * c, emu_desc_row(op.db, 8 * j + 2 * tq + e, 16 * c), 16);
      for (int h = 0; h < 2; ++h) {
        int32_t sum = 0;
        for (int k = 0; k < 32; ++k) sum += (int32_t)a[h][k] * (int32_t)b[k];
        int32_t& out = op.d[4 * j + 2 * h + e];
        out = op.accumulate ? out + sum : sum;
      }
    }
  }
}
inline void emu_wgmma_wait_group(int n) {
  emu_wgmma_queue& q = emu_wgmma_queues[threadIdx.x];
  while ((int)q.groups.size() > n) {
    for (const auto& op : q.groups.front()) emu_wgmma_run(op);
    q.groups.pop_front();
  }
  q.fenced = false;   // the accumulators may be read now: fence again before the next
}

// kernel<<<grid, threads, smem, stream>>>(args) is rewritten by the test to
// emu_launch(grid, threads, smem, [&] { kernel(args); });
template <class F>
void emu_launch(unsigned int grid, unsigned int threads, size_t smem, F body) {
  if (emu_self) std::abort();   // a launch from inside a kernel
  blockDim = {threads, 1, 1};
  gridDim = {grid, 1, 1};
  std::vector<unsigned char> dynamic_smem(smem);
  emu_dynamic_smem = dynamic_smem.data();
  emu_dynamic_smem_bytes = smem;
  emu_body_fn = [](void* arg) { (*static_cast<F*>(arg))(); };
  emu_body_arg = &body;
  emu_cp_async_pending.assign(threads, {});
  emu_wgmma_queues.assign(threads, {});
  for (unsigned int bx = 0; bx < grid; ++bx) {
    std::fill(dynamic_smem.begin(), dynamic_smem.end(), (unsigned char)0xff);
    emu_mbars.clear();
    blockIdx = {bx, 0, 0};
    emu_barrier bar(threads);
    emu_block_barrier = &bar;
    std::vector<std::unique_ptr<emu_barrier>> warp_bars;
    emu_warps.assign((threads + 31) / 32, emu_warp{});
    for (unsigned int w = 0; w < emu_warps.size(); ++w) {
      warp_bars.push_back(std::make_unique<emu_barrier>(std::min(32u, threads - 32 * w)));
      emu_warps[w].bar = warp_bars.back().get();
    }
    emu_run_block(threads);
    for (unsigned int t = 0; t < threads; ++t)
      if (!emu_cp_async_pending[t].empty() || !emu_wgmma_queues[t].open.empty() ||
          !emu_wgmma_queues[t].groups.empty())
        std::abort();
  }
}
