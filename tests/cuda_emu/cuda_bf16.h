// bfloat16 for the host stand-in of cuda_runtime.h: round to nearest even.
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {(uint16_t)0x7fc0};  // NaN
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 p) {
  return {__bfloat162float(p.x), __bfloat162float(p.y)};
}
