// GroupNorm normalize, affine and ReLU of an NHWC activation in one pass —
// kernel K2a.
//
// Replaces the second half of `pallas_group_norm`
// (handnet_tpu/ops/pallas_gn.py:152-169): after `gn_group_stats` (the Pallas
// kernel `_stats_kernel`, here K2s in gn_stats.cu) the JAX package writes
// the normalize and affine as plain jnp and leaves them to XLA, which fuses
// them and the tower's ReLU into one pass. PyTorch fuses nothing, so that
// pass is this kernel.
//
// Computes, for x [B, HW, C], stats [B, 2, G] float32 (mean, biased variance)
// and per-channel scale and bias:
//     y = ((x - mean) * (rsqrt(var + eps) * scale)) + bias,  then max(y, 0)
// in float32, each operation rounded on its own (no fused multiply-add), and
// stores y in x's type: the operations of the plain version
// (ops/cuda_gn.py: gn_apply_reference), in their order, so the two agree bit
// for bit.
//
// What bounds it on the H100: bytes, x read once and y written once (P3 at
// B=128 in bf16: 629 MB). The plain version moves about ten times that.
//
// Design: the walk of K2s. A thread owns one 16-byte chunk column of the
// pixels and prepares its channels' mean, multiplier and bias once, in
// registers, from its group's mean and variance (a chunk lies in one group
// where K >= the chunk's E values, as K = 32 and 64 do); then it walks pixel
// rows with kUnroll 16-byte loads in flight and one 16-byte store for each.
// grid = splits x B. Any K that divides C; a block is at most kMaxThreads =
// 256 threads of whole pixel rows, or one row of up to kWideThreads chunks
// (float32 C = 2048), as in K2s, under one 512-thread bound (its registers
// are those of a 256-thread bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk16.cuh"

namespace {

constexpr int kMaxThreads = 256;   // a block of whole pixel rows
constexpr int kWideThreads = 512;  // a block of one pixel row of 257 to 512 chunks
constexpr int kUnroll = 4;  // 16-byte loads a thread has in flight

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (splits, B), block rows * cp threads. Block (s, b) writes pixels
// [s * per_split, (s + 1) * per_split) of image b.
template <typename T, typename TP, bool kRelu>
__global__ void __launch_bounds__(kWideThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                const TP* __restrict__ scale, const TP* __restrict__ bias, T* __restrict__ out,
                int hw, int channels, int groups, int cp, int rows, int per_split, float eps) {
  constexpr int E = 16 / sizeof(T);  // values in a 16-byte chunk
  const int col = threadIdx.x % cp;
  const int row = threadIdx.x / cp;
  const int b = blockIdx.y;
  const int k = channels / groups;
  const int p0 = blockIdx.x * per_split;
  const int p1 = min(hw, p0 + per_split);

  float mean[E], mul[E], add[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = col * E + e;
    const int g = c / k;
    mean[e] = __ldg(stats + ((int64_t)b * 2 + 0) * groups + g);
    const float var = __ldg(stats + ((int64_t)b * 2 + 1) * groups + g);
    mul[e] = __fmul_rn(rsqrtf(__fadd_rn(var, eps)), to_float(scale[c]));
    add[e] = to_float(bias[c]);
  }

  const int64_t image = (int64_t)b * hw * cp;  // in chunks
  const uint4* src = reinterpret_cast<const uint4*>(x) + image + col;
  uint4* dst = reinterpret_cast<uint4*>(out) + image + col;

  auto apply = [&](const uint4& raw) {
    float v[E];
    decode(raw, v);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float y = __fadd_rn(__fmul_rn(__fsub_rn(v[e], mean[e]), mul[e]), add[e]);
      if (kRelu) y = y < 0.f ? 0.f : y;
      v[e] = y;
    }
    return encode(v);
  };

  int p = p0 + row;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = __ldg(src + (int64_t)(p + u * rows) * cp);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[(int64_t)(p + u * rows) * cp] = apply(raw[u]);
  }
  for (; p < p1; p += rows) dst[(int64_t)p * cp] = apply(__ldg(src + (int64_t)p * cp));
}

template <typename T, typename TP>
cudaError_t launch(const void* x, const void* stats, const void* scale, const void* bias,
                   void* out, int64_t batch, int64_t hw, int64_t channels, int64_t groups,
                   int64_t cp, int64_t rows, int64_t splits, int64_t per_split, float eps,
                   int relu, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int64_t threads = rows * cp;
  if (batch < 1 || batch > 65535 || hw < 1 || groups < 1 || channels % groups != 0 ||
      cp * E != channels || rows < 1 || threads > kWideThreads ||
      (threads > kMaxThreads && rows != 1) || splits < 1 || splits * per_split < hw ||
      (splits - 1) * per_split >= hw) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)splits, (unsigned)batch);
#define HN_GN_APPLY(RELU)                                                                     \
  gn_apply_kernel<T, TP, RELU><<<grid, (unsigned)threads, 0, stream>>>(                       \
      static_cast<const T*>(x), static_cast<const float*>(stats),                             \
      static_cast<const TP*>(scale), static_cast<const TP*>(bias), static_cast<T*>(out),      \
      (int)hw, (int)channels, (int)groups, (int)cp, (int)rows, (int)per_split, eps)
  if (relu) {
    HN_GN_APPLY(true);
  } else {
    HN_GN_APPLY(false);
  }
#undef HN_GN_APPLY
  return cudaGetLastError();
}

}  // namespace

// x and out [batch, hw, channels] contiguous, 16-byte aligned, of one dtype
// (0 = float32, 1 = bfloat16); stats [batch, 2, groups] float32; scale and
// bias [channels] of param_dtype (same codes). The block shape (at most 256
// threads, or one row of up to 512 chunks) and the cut of hw into splits
// come from the wrapper (ops/cuda_gn.py: row_plan). Returns the launch's
// cudaError_t.
extern "C" int hn_gn_apply(const void* x, const void* stats, const void* scale,
                           const void* bias, void* out, int64_t batch, int64_t hw,
                           int64_t channels, int64_t groups, int64_t cp, int64_t rows,
                           int64_t splits, int64_t per_split, float eps, int relu, int dtype,
                           int param_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HN_GN_APPLY_AS(T, TP)                                                                \
  return (int)launch<T, TP>(x, stats, scale, bias, out, batch, hw, channels, groups, cp,     \
                            rows, splits, per_split, eps, relu, s)
  if (dtype == 0 && param_dtype == 0) HN_GN_APPLY_AS(float, float);
  if (dtype == 0 && param_dtype == 1) HN_GN_APPLY_AS(float, __nv_bfloat16);
  if (dtype == 1 && param_dtype == 0) HN_GN_APPLY_AS(__nv_bfloat16, float);
  if (dtype == 1 && param_dtype == 1) HN_GN_APPLY_AS(__nv_bfloat16, __nv_bfloat16);
#undef HN_GN_APPLY_AS
  return (int)cudaErrorInvalidValue;
}
