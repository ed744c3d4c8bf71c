// Division-free activation quantization, shared by the CUDA sources.
//
// round_to_byte() is bit-equal to clamp(rn(v / scale), -127, 127) with an
// IEEE division, in six full-rate float ops per element:
//   q0 = rn(v * rcp) with rcp = rn(1 / scale) is within an ulp of v / scale;
//   q  = rn(q0 + rn(v - q0 * scale) * rcp), both steps one FMA, is then the
//        correctly rounded quotient (Markstein's theorem: the residual is
//        exact and the corrected quotient rounds once);
//   y  = clamp(q, -127, 127), and y + 1.5 * 2^23 lands where the float
//        spacing is 1, so the addition rounds y to an integer, ties to even,
//        and the sum's low byte is that integer as int8.
// IEEE division itself is a long sequence with a slow path for v = 0 (half
// of a ReLU output), and F2I/FRND run on a quarter-rate pipe. A quotient
// that overflows to +-inf keeps q0's sign.

#pragma once

#include <stdint.h>

constexpr float kRoundMagic = 12582912.0f;  // 1.5 * 2^23

__device__ __forceinline__ uint32_t round_to_byte(float v, float scale, float rcp) {
  const float q0 = __fmul_rn(v, rcp);
  const float q = fabsf(q0) < 1e30f ? __fmaf_rn(__fmaf_rn(-q0, scale, v), rcp, q0) : q0;
  const float y = fminf(fmaxf(q, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, kRoundMagic));  // low byte: the int8
}

// low bytes of four words -> one word, first in the lowest byte
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}
