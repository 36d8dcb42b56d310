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
// may differ from the card's in the last bit.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <thread>
#include <vector>

#define __global__
#define __host__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static

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
using std::fmaxf;
using std::min;

// kernel<<<grid, threads, smem, stream>>>(args) is rewritten by the test to
// emu_launch(grid, threads, smem, [&] { kernel(args); });
template <class F>
void emu_launch(unsigned int grid, unsigned int threads, size_t smem, F body) {
  blockDim = {threads, 1, 1};
  std::vector<unsigned char> dynamic_smem(smem);
  emu_dynamic_smem = dynamic_smem.data();
  for (unsigned int bx = 0; bx < grid; ++bx) {
    std::barrier<> bar(threads);
    emu_block_barrier = &bar;
    std::vector<std::thread> team;
    for (unsigned int t = 0; t < threads; ++t) {
      team.emplace_back([&, bx, t] {
        blockIdx = {bx, 0, 0};
        threadIdx = {t, 0, 0};
        body();
      });
    }
    for (auto& th : team) th.join();
  }
}
