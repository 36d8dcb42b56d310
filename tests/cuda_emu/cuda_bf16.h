// CPU stand-in for the few bfloat16 features of CUDA's cuda_bf16.h that
// alphazero_tpu_torch's csrc/*.cuh use (see cuda_runtime.h). The rounding
// is round-to-nearest-even, as the card's cvt.rn.bf16.f32 and torch's
// c10::BFloat16 do it.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  unsigned short x;
};

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {0x7fc0};  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.x) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
