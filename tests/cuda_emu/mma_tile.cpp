// One warp's emulated bf16 MMAs on fragments given lane by lane, for the
// tile test of tests/test_torch_kernels.py: lane l's registers are a[l][0
// .. 4 m_tiles), b[l][0 .. 2 n_tiles) and its accumulators d[l][0 .. 4
// m_tiles n_tiles), which the call updates in place.
#include "cuda_runtime.h"

extern "C" int emu_mma_bf16_tiles(const uint32_t* a, const uint32_t* b, float* d, int m_tiles,
                                  int n_tiles) {
  emu_launch(1, 32, 0, [&] {
    const int l = threadIdx.x;
    emu_mma_m16n8k16_bf16(d + l * 4 * m_tiles * n_tiles, a + l * 4 * m_tiles, b + l * 2 * n_tiles,
                          m_tiles, n_tiles);
  });
  return 0;
}
