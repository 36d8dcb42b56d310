// CPU stand-in for the few CUDA runtime features alphazero_tpu_torch's
// csrc/*.cu kernels use, so their logic compiles with g++ and runs on the
// host (tests/test_torch_kernels.py). Each launch runs its blocks one after
// another, each block's threads as std::threads meeting at a std::barrier
// for __syncthreads(); a __shared__ array is a static one, which the
// block's threads share (blocks run one at a time), and the launch's
// dynamic shared memory one buffer (the test rewrites each
// `extern __shared__ T name[];` into a pointer to it). The round-to-nearest
// intrinsics are plain IEEE float operations (build with
// -ffp-contract=off), as on the card; expf and tanhf are glibc's, which
// may differ from the card's in the last bit. Inline PTX has no stand-in:
// a source keeps it under `#ifndef CUDA_EMU` and calls the emulated
// instruction below (emu_mma_m16n8k32_s8, emu_mma_m16n8k16_bf16,
// emu_cp_async16 and emu_cp_async_wait_all) otherwise. Each block starts
// with its dynamic shared memory filled with 0xff bytes (a bf16 or f32 NaN),
// so that a kernel that reads what it never wrote shows it. The warp
// intrinsics (__shfl_sync, __shfl_xor_sync, __ballot_sync, __syncwarp)
// meet the warp's threads at a barrier of their own, beside an exchange
// slot per lane: every lane of the warp must call them in the same order
// (the full mask, as the kernels use them), and a block's threads come in
// whole warps.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)
#define CUDA_EMU 1

struct emu_dim3 { unsigned int x, y, z; };
inline thread_local emu_dim3 threadIdx, blockIdx;
inline emu_dim3 blockDim;
inline std::barrier<>* emu_block_barrier = nullptr;

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaGetLastError() { return 0; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline unsigned char* emu_dynamic_smem = nullptr;
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

// The warps of the running block: a barrier each and a double-buffered
// exchange slot per lane. A collective writes its lane's slot of the
// buffer this call uses, meets the warp at the barrier and reads; the
// next call uses the other buffer, so a lane that runs ahead never
// overwrites a slot another lane has still to read (it cannot pass the
// next barrier before that lane has read).
struct emu_warp {
  std::barrier<>* bar;
  uint64_t slot[2][32];
};
inline std::vector<emu_warp> emu_warps;
inline thread_local int emu_warp_phase = 0;
// Post this lane's value, meet the warp, return the slots of every lane.
inline const uint64_t* emu_warp_post(uint64_t v) {
  emu_warp& warp = emu_warps[threadIdx.x / 32];
  const int ph = emu_warp_phase;
  emu_warp_phase ^= 1;
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
using std::fmaxf;
using std::min;

struct uint4 { unsigned int x, y, z, w; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

// m_tiles x n_tiles instructions mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// of the calling thread's warp: d[i][j][0..3] += A_i B_j, with the PTX ISA's
// fragments: lane l = 4 * gid + tq holds of A_i (16x32, row-major) a[i][0]
// = row gid, k 4tq..4tq+3; a[i][1] = row gid + 8, the same k; a[i][2], a[i][3]
// the same rows at k 16 + 4tq..; of B_j (32x8) b[j][0] = k 4tq..4tq+3 of
// column gid, b[j][1] = k 16 + 4tq..; of D rows gid (d 0, 1) and gid + 8
// (d 2, 3), columns 2tq and 2tq + 1; 4 int8 a register, the lowest k in
// the lowest byte. Block-collective: every thread of the block stages its
// fragments, meets the others at a barrier, computes its own accumulators
// from its warp's 32 lanes and meets them again, so the kernel must issue
// its MMAs block-uniformly (as the card needs them warp-uniform).
inline constexpr int emu_mma_max_words = 32;
inline uint32_t emu_mma_stage[1024][emu_mma_max_words];
inline void emu_mma_m16n8k32_s8(int32_t* d, const uint32_t* a, const uint32_t* b, int m_tiles,
                                int n_tiles) {
  const int na = 4 * m_tiles, nb = 2 * n_tiles;
  if (na + nb > emu_mma_max_words) std::abort();
  const unsigned t = threadIdx.x, lane = t % 32, warp0 = t - lane;
  std::memcpy(emu_mma_stage[t], a, na * sizeof(uint32_t));
  std::memcpy(emu_mma_stage[t] + na, b, nb * sizeof(uint32_t));
  __syncthreads();
  auto byte = [](uint32_t word, int k) { return (int)(int8_t)(word >> (8 * (k % 4)) & 0xff); };
  const int gid = lane / 4, tq = lane % 4;
  for (int i = 0; i < m_tiles; ++i) {
    for (int j = 0; j < n_tiles; ++j) {
      for (int e = 0; e < 4; ++e) {
        const int row = gid + 8 * (e / 2), col = 2 * tq + e % 2;
        int32_t sum = 0;
        for (int k = 0; k < 32; ++k) {
          const unsigned src = k % 16 / 4;   // the thread in group holding k
          const uint32_t* la = emu_mma_stage[warp0 + 4 * (row % 8) + src];
          const uint32_t* lb = emu_mma_stage[warp0 + 4 * col + src];
          sum += byte(la[4 * i + row / 8 + 2 * (k / 16)], k) * byte(lb[na + 2 * j + k / 16], k);
        }
        d[(i * n_tiles + j) * 4 + e] += sum;
      }
    }
  }
  __syncthreads();
}

// m_tiles x n_tiles instructions mma.sync.aligned.m16n8k16.row.col.f32.bf16
// .bf16.f32 of the calling thread's warp: d[i][j][0..3] += A_i B_j, with the
// PTX ISA's fragments: lane l = 4 * gid + tq holds of A_i (16x16, row-major)
// a[i][0] = row gid, k 2tq, 2tq+1; a[i][1] = row gid + 8, the same k;
// a[i][2], a[i][3] the same rows at k 8 + 2tq, 8 + 2tq + 1; of B_j (16x8)
// b[j][0] = k 2tq, 2tq+1 of column gid, b[j][1] = k 8 + 2tq, 8 + 2tq + 1;
// of D rows gid (d 0, 1) and gid + 8 (d 2, 3), columns 2tq and 2tq + 1; two
// bf16 a register, the lower k in the lower half. Each product is exact; an
// instruction's 16 products and its accumulator are summed in float64 and
// rounded once to f32. Block-collective, as emu_mma_m16n8k32_s8.
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
inline thread_local std::vector<emu_cp_async_copy> emu_cp_async_pending;
inline void emu_cp_async16(void* dst, const void* src) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16) std::abort();
  emu_cp_async_pending.push_back({dst, src});
}
inline void emu_cp_async_wait_all() {
  for (const auto& c : emu_cp_async_pending) std::memcpy(c.dst, c.src, 16);
  emu_cp_async_pending.clear();
}

// kernel<<<grid, threads, smem, stream>>>(args) is rewritten by the test to
// emu_launch(grid, threads, smem, [&] { kernel(args); });
template <class F>
void emu_launch(unsigned int grid, unsigned int threads, size_t smem, F body) {
  blockDim = {threads, 1, 1};
  std::vector<unsigned char> dynamic_smem(smem);
  emu_dynamic_smem = dynamic_smem.data();
  for (unsigned int bx = 0; bx < grid; ++bx) {
    std::fill(dynamic_smem.begin(), dynamic_smem.end(), (unsigned char)0xff);
    std::barrier<> bar(threads);
    emu_block_barrier = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
    emu_warps.assign((threads + 31) / 32, emu_warp{});
    for (unsigned int w = 0; w < emu_warps.size(); ++w) {
      warp_bars.push_back(std::make_unique<std::barrier<>>(std::min(32u, threads - 32 * w)));
      emu_warps[w].bar = warp_bars.back().get();
    }
    std::vector<std::thread> team;
    for (unsigned int t = 0; t < threads; ++t) {
      team.emplace_back([&, bx, t] {
        blockIdx = {bx, 0, 0};
        threadIdx = {t, 0, 0};
        body();
        if (!emu_cp_async_pending.empty()) std::abort();
      });
    }
    for (auto& th : team) th.join();
  }
}
