// Probes of the emulated Hopper instructions, for tests/test_torch_tower_emu.py:
// each runs one emulated block on shared memory the test lays out, so the
// test can hold the stand-ins against numpy.
#include "cuda_runtime.h"

extern "C" {

uint32_t emu_probe_smem_window() { return emu_smem_window; }

// One TMA tiled load of the box at (c0, c1) of src (uint8[rows][cols],
// `stride` bytes a row) into a shared buffer of `smem_bytes` (0xff-filled)
// at window address `dst`, with `swizzle` (CUtensorMapSwizzle), completed on
// an mbarrier at window address `bar`. flags[0..3]: try_wait.parity 0 and 1
// right after init, then both after the wait for phase 0. The buffer comes
// back in `image`. Returns the encoder's result.
int emu_probe_tma_2d(const uint8_t* src, uint64_t cols, uint64_t rows, uint64_t stride,
                     uint32_t box_cols, uint32_t box_rows, int swizzle, int c0, int c1, uint32_t dst,
                     uint32_t bar, uint8_t* image, uint32_t smem_bytes, int* flags) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
  if (found != cudaDriverEntryPointSuccess) return -1;
  CUtensorMap map;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t es[2] = {1, 1};
  const CUresult rc = reinterpret_cast<decltype(&emu_encode_tiled)>(fn)(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<uint8_t*>(src), dims, strides, box, es,
      CU_TENSOR_MAP_INTERLEAVE_NONE, (CUtensorMapSwizzle)swizzle, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return rc;
  emu_launch(1, 32, smem_bytes, [&] {
    if (threadIdx.x == 0) {
      emu_mbarrier_init(bar, 1);
      flags[0] = emu_mbarrier_try_wait_parity(bar, 0);
      flags[1] = emu_mbarrier_try_wait_parity(bar, 1);
      emu_mbarrier_arrive_expect_tx(bar, box_cols * box_rows);
      emu_tma_load_2d(dst, &map, c0, c1, bar);
    }
    __syncthreads();
    while (!emu_mbarrier_try_wait_parity(bar, 0)) {
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      flags[2] = emu_mbarrier_try_wait_parity(bar, 0);
      flags[3] = emu_mbarrier_try_wait_parity(bar, 1);
      std::memcpy(image, emu_dynamic_smem, smem_bytes);
    }
  });
  return 0;
}

// One warpgroup's chain of `steps` wgmma m64nNk32 s8 on a shared buffer
// holding `image` (smem_bytes): step s reads descriptors da[s], db[s] and
// accumulates from the second step on; the accumulators start at 12345.
// With `wait`, d (int32[64][n]) receives every thread's fragment after
// wait_group 0; without, the fragments as read before the wait (which then
// follows).
void emu_probe_wgmma(const uint8_t* image, uint32_t smem_bytes, const uint64_t* da,
                     const uint64_t* db, int steps, int n, int wait, int32_t* d) {
  emu_launch(1, 128, smem_bytes, [&] {
    if (threadIdx.x == 0) std::memcpy(emu_dynamic_smem, image, smem_bytes);
    __syncthreads();
    int32_t acc[128];
    for (int i = 0; i < n / 2; ++i) acc[i] = 12345;
    emu_wgmma_fence();
    for (int s = 0; s < steps; ++s) emu_wgmma_m64nNk32_s8(acc, n, da[s], db[s], s > 0);
    emu_wgmma_commit_group();
    int32_t seen[128];
    std::memcpy(seen, acc, sizeof seen);
    emu_wgmma_wait_group(0);
    const int32_t* got = wait ? acc : seen;
    const unsigned t = threadIdx.x;
    const int row = 16 * (t / 32) + t % 32 / 4, tq = t % 4;
    for (int j = 0; j < n / 8; ++j)
      for (int e = 0; e < 4; ++e)
        d[(row + 8 * (e / 2)) * n + 8 * j + 2 * tq + e % 2] = got[4 * j + e];
  });
}

}  // extern "C"
