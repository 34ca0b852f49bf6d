// Stand-in for cuda_bf16.h (see cuda_runtime.h beside it): bfloat16 as
// its 16 bits, rounded to nearest even.
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 {
  unsigned short x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const unsigned u = static_cast<unsigned>(h.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) {
    return {static_cast<unsigned short>((u >> 16) | 0x40)};
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}

inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}
