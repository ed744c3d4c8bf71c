// What the GroupNorm backward's two kernels share — K2r
// (gn_backward_sums.cu) and K2d (gn_backward_dx.cu): a thread's channels'
// forward coefficients, prepared once, and the ReLU mask recomputed from x.
//
// The mask is that of the forward's output as stored in x's type: y > 0 for
// y = ((x - mean) * mul) + add, with mul = rsqrt(var + eps) * scale, each
// operation rounded on its own and in K2a's order (gn_apply.cu), then y
// rounded to x's type. K2a equals its plain version bit for bit, so this
// mask is the one the saved output would give, and no y is saved or read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float param_float(float v) { return v; }
__device__ __forceinline__ float param_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// K2a's (mean, mul, add) of a thread's E channels col * E .. col * E + E - 1
// in image b, and inv = rsqrt(var + eps) of each channel's group.
template <int E, typename TP>
__device__ __forceinline__ void forward_coefficients(const float* __restrict__ stats,
                                                     const TP* __restrict__ scale,
                                                     const TP* __restrict__ bias, int b,
                                                     int col, int groups, int k, float eps,
                                                     float (&mean)[E], float (&inv)[E],
                                                     float (&mul)[E], float (&add)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = col * E + e;
    const int g = c / k;
    mean[e] = __ldg(stats + ((int64_t)b * 2 + 0) * groups + g);
    const float var = __ldg(stats + ((int64_t)b * 2 + 1) * groups + g);
    inv[e] = rsqrtf(__fadd_rn(var, eps));
    mul[e] = __fmul_rn(inv[e], param_float(scale[c]));
    add[e] = param_float(bias[c]);
  }
}

// Does the forward's ReLU pass this element? `centred` is x - mean
// (__fsub_rn, as K2a takes it).
template <typename T>
__device__ __forceinline__ bool relu_passes(float centred, float mul, float add);

template <>
__device__ __forceinline__ bool relu_passes<float>(float centred, float mul, float add) {
  return __fadd_rn(__fmul_rn(centred, mul), add) > 0.f;
}

// rounded to bfloat16 first, as K2a's encode stores it: a float32 below
// bfloat16's least subnormal becomes 0 and fails the mask
template <>
__device__ __forceinline__ bool relu_passes<__nv_bfloat16>(float centred, float mul, float add) {
  const float y = __fadd_rn(__fmul_rn(centred, mul), add);
  return __bfloat162float(__float2bfloat16_rn(y)) > 0.f;
}
