// Activation quantization pass — kernel K3q, the first half of the int8 conv.
//
// Replaces the quantization inside QuantConv (handnet_tpu/nn/quant.py:122-151,
// quantize_symmetric and the static-scale branch), which XLA fuses into the
// producer of the int8 conv_general_dilated. Here it is a pass of its own, so
// that each activation is quantized once and the implicit GEMM
// (int8_conv.cu, K3g) reads ready int8 through TMA:
//   q[b,h,w,c] = clamp(rn(x[b,h,w,c] / sx[b]), -127, 127)   (int8)
// for NHWC x in float32 or bfloat16, with sx one scale per sample or one for
// the tensor. round_to_byte() gives the IEEE quotient's rounding without a
// division, so q is bit-equal to the plain version.
//
// What bounds it on the H100: bytes. Each element is read once (2 or 4
// bytes) and written once (1 byte); the six float ops per element are far
// below the ALU rate. So a thread moves 16 elements: 16-byte loads, one
// 16-byte store of 16 int8, neighbouring threads on neighbouring addresses,
// and a grid-stride loop over enough blocks to keep all 132 SMs loading.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "round_to_byte.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;        // elements per thread and step
constexpr int kBlocksPerSm = 16;  // grid cap: 8 resident blocks and a queue behind them

__device__ __forceinline__ void load16(const float* __restrict__ p, float (&v)[kGroup]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + j);
    v[4 * j + 0] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ p, float (&v)[kGroup]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + j);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[8 * j + i] = __bfloat162float(h[i]);
  }
}

// groups = B * per_image groups of 16 elements; block kThreads, grid-stride.
template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_quantize_kernel(const T* __restrict__ x, const float* __restrict__ sx, int64_t sx_stride,
                     int8_t* __restrict__ q, int64_t groups, int64_t per_image) {
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x; g < groups; g += step) {
    const float scale = __ldg(sx + (g / per_image) * sx_stride);
    const float rcp = __frcp_rn(scale);
    float v[kGroup];
    load16(x + g * kGroup, v);
    uint32_t packed[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      packed[j] = pack_low_bytes(round_to_byte(v[4 * j + 0], scale, rcp),
                                 round_to_byte(v[4 * j + 1], scale, rcp),
                                 round_to_byte(v[4 * j + 2], scale, rcp),
                                 round_to_byte(v[4 * j + 3], scale, rcp));
    }
    reinterpret_cast<uint4*>(q)[g] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* sx, int64_t sx_stride, void* q, int64_t groups,
                   int64_t per_image, int sms, cudaStream_t stream) {
  const int64_t blocks = (groups + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSm;
  const unsigned grid = (unsigned)(blocks < cap ? blocks : cap);
  int8_quantize_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(sx), sx_stride,
      static_cast<int8_t*>(q), groups, per_image);
  return cudaGetLastError();
}

}  // namespace

// x [batch, per_sample] contiguous (dtype 0 = float32, 1 = bfloat16), 16-byte
// aligned, per_sample a multiple of 16; sx float32 read with stride sx_stride
// (0 for one scale); q [batch, per_sample] int8, 16-byte aligned. Returns the
// launch's cudaError_t.
extern "C" int hn_int8_quantize(const void* x, const void* sx, int64_t sx_stride, void* q,
                                int64_t batch, int64_t per_sample, int dtype, void* stream) {
  if (batch <= 0 || per_sample <= 0 || per_sample % kGroup != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int64_t per_image = per_sample / kGroup;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, sx, sx_stride, q, batch * per_image, per_image, sms, st);
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(x, sx, sx_stride, q, batch * per_image, per_image, sms, st);
  }
  return (int)cudaErrorInvalidValue;
}
