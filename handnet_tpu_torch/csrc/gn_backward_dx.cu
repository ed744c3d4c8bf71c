// dx of GroupNorm's backward in one pass — kernel K2d.
//
// Replaces no Pallas kernel (the JAX package's `pallas_group_norm` in
// handnet_tpu/ops/pallas_gn.py has no VJP; its training GroupNorms are flax
// GroupNorms that XLA differentiates, handnet_tpu/models/fcos.py:62-65). It
// follows K2r (gn_backward_sums.cu), whose sums it reads.
//
// For y = relu(((x - mean) * inv) * scale + bias) over n values per (image,
// group), g = dy * [y > 0] and c = x - mean, with K2r's per-group sums S1 =
// sum g * scale and S2 = sum g * scale * c:
//     dx = inv * (g * scale - S1 / n) - c * inv^3 * S2 / n
// computed as ((g * (inv * scale)) - inv * (S1 * (1/n))) - c * (inv^3 *
// (S2 * (1/n))) in float32, each operation rounded on its own (no fused
// multiply-add) and in the plain version's order (ops/cuda_gn.py:
// gn_backward_dx_reference), then stored in x's type: given the same sums,
// the two agree bit for bit.
//
// What bounds it on the H100: bytes, x and dy read once and dx written once
// (P3 of a train step, [8, 100, 136, 256] bf16: 167 MB). The ReLU mask is
// recomputed from x with K2a's operations (gn_backward.cuh), so y is not
// read.
//
// Design: the walk of K2a (gn_apply.cu). A thread owns one 16-byte chunk
// column and prepares its channels' coefficients once, in registers: mean,
// inv * scale (K2a's multiplier, which the mask needs too), bias, and the
// two group terms; then each element costs a subtraction, the mask, and
// three multiplies and two subtractions. grid = splits x B. Nothing depends
// on the group width (K = 2 to 64). A block is at most kMaxThreads = 256
// threads of whole pixel rows, or one pixel row of 257 to 512 chunks
// (float32 C = 2048) in a block of up to kWideThreads threads. One
// instantiation serves both, as in gn_apply.cu: under a 512-thread bound
// ptxas gives each kernel within 5 registers of what a 256-thread bound
// gives it (H100, sm_90a: bf16 72-78 against 72-76, float32 53-54 against
// 48-55).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk16.cuh"
#include "gn_backward.cuh"

namespace {

constexpr int kMaxThreads = 256;   // a block of whole pixel rows
constexpr int kWideThreads = 512;  // a block of one pixel row of 257 to 512 chunks
constexpr int kUnroll = 4;  // 16-byte loads of x, and as many of dy, in flight

// grid (splits, B), block rows * cp threads. Block (s, b) writes pixels
// [s * per_split, (s + 1) * per_split) of image b.
template <typename T, typename TP, bool kRelu>
__global__ void __launch_bounds__(kWideThreads)
gn_backward_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ stats, const TP* __restrict__ scale,
                      const TP* __restrict__ bias, const float* __restrict__ sums,
                      T* __restrict__ dx, int hw, int channels, int groups, int cp, int rows,
                      int per_split, float eps, float inv_n) {
  constexpr int E = 16 / sizeof(T);  // values in a 16-byte chunk
  const int col = threadIdx.x % cp;
  const int row = threadIdx.x / cp;
  const int b = blockIdx.y;
  const int k = channels / groups;
  const int p0 = blockIdx.x * per_split;
  const int p1 = min(hw, p0 + per_split);

  float mean[E], inv[E], mul[E], add[E], shift[E], slope[E];
  forward_coefficients<E, TP>(stats, scale, bias, b, col, groups, k, eps, mean, inv, mul, add);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int g = (col * E + e) / k;
    const float s1 = __ldg(sums + ((int64_t)b * 2 + 0) * groups + g);
    const float s2 = __ldg(sums + ((int64_t)b * 2 + 1) * groups + g);
    shift[e] = __fmul_rn(inv[e], __fmul_rn(s1, inv_n));
    slope[e] = __fmul_rn(__fmul_rn(__fmul_rn(inv[e], inv[e]), inv[e]), __fmul_rn(s2, inv_n));
  }

  const int64_t image = (int64_t)b * hw * cp;  // in chunks
  const uint4* xs = reinterpret_cast<const uint4*>(x) + image + col;
  const uint4* ds = reinterpret_cast<const uint4*>(dy) + image + col;
  uint4* out = reinterpret_cast<uint4*>(dx) + image + col;

  auto grad = [&](const uint4& xr, const uint4& dr) {
    float v[E], d[E];
    decode(xr, v);
    decode(dr, d);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float centred = __fsub_rn(v[e], mean[e]);
      const float g = !kRelu || relu_passes<T>(centred, mul[e], add[e]) ? d[e] : 0.f;
      v[e] = __fsub_rn(__fsub_rn(__fmul_rn(g, mul[e]), shift[e]),
                       __fmul_rn(centred, slope[e]));
    }
    return encode(v);
  };

  int p = p0 + row;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    uint4 xr[kUnroll], dr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xr[u] = __ldg(xs + (int64_t)(p + u * rows) * cp);
      dr[u] = __ldg(ds + (int64_t)(p + u * rows) * cp);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) out[(int64_t)(p + u * rows) * cp] = grad(xr[u], dr[u]);
  }
  for (; p < p1; p += rows) {
    out[(int64_t)p * cp] = grad(__ldg(xs + (int64_t)p * cp), __ldg(ds + (int64_t)p * cp));
  }
}

template <typename T, typename TP>
cudaError_t launch(const void* x, const void* dy, const void* stats, const void* scale,
                   const void* bias, const void* sums, void* dx, int64_t batch, int64_t hw,
                   int64_t channels, int64_t groups, int64_t cp, int64_t rows, int64_t splits,
                   int64_t per_split, float eps, float inv_n, int relu, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int64_t threads = rows * cp;
  if (batch < 1 || batch > 65535 || hw < 1 || groups < 1 || channels % groups != 0 ||
      cp * E != channels || rows < 1 || threads > kWideThreads ||
      (threads > kMaxThreads && rows != 1) || splits < 1 || splits * per_split < hw ||
      (splits - 1) * per_split >= hw) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)splits, (unsigned)batch);
#define HN_GN_BACKWARD_DX(RELU)                                                              \
  gn_backward_dx_kernel<T, TP, RELU><<<grid, (unsigned)threads, 0, stream>>>(                \
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(stats), \
      static_cast<const TP*>(scale), static_cast<const TP*>(bias),                           \
      static_cast<const float*>(sums), static_cast<T*>(dx), (int)hw, (int)channels,          \
      (int)groups, (int)cp, (int)rows, (int)per_split, eps, inv_n)
  if (relu) {
    HN_GN_BACKWARD_DX(true);
  } else {
    HN_GN_BACKWARD_DX(false);
  }
#undef HN_GN_BACKWARD_DX
  return cudaGetLastError();
}

}  // namespace

// x, dy and dx [batch, hw, channels] contiguous, 16-byte aligned, of one
// dtype (0 = float32, 1 = bfloat16); stats [batch, 2, groups] float32 (K2s's)
// and sums [batch, 2, groups] float32 (K2r's); scale and bias [channels] of
// param_dtype (same codes); inv_n = 1 / (hw * channels / groups) rounded to
// float32. The block shape (at most 256 threads, or one row of up to 512
// chunks) and the cut of hw into splits come from the wrapper
// (ops/cuda_gn.py: row_plan). Returns the launch's cudaError_t.
extern "C" int hn_gn_backward_dx(const void* x, const void* dy, const void* stats,
                                 const void* scale, const void* bias, const void* sums, void* dx,
                                 int64_t batch, int64_t hw, int64_t channels, int64_t groups,
                                 int64_t cp, int64_t rows, int64_t splits, int64_t per_split,
                                 float eps, float inv_n, int relu, int dtype, int param_dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HN_GN_BACKWARD_DX_AS(T, TP)                                                          \
  return (int)launch<T, TP>(x, dy, stats, scale, bias, sums, dx, batch, hw, channels, groups, \
                            cp, rows, splits, per_split, eps, inv_n, relu, s)
  if (dtype == 0 && param_dtype == 0) HN_GN_BACKWARD_DX_AS(float, float);
  if (dtype == 0 && param_dtype == 1) HN_GN_BACKWARD_DX_AS(float, __nv_bfloat16);
  if (dtype == 1 && param_dtype == 0) HN_GN_BACKWARD_DX_AS(__nv_bfloat16, float);
  if (dtype == 1 && param_dtype == 1) HN_GN_BACKWARD_DX_AS(__nv_bfloat16, __nv_bfloat16);
#undef HN_GN_BACKWARD_DX_AS
  return (int)cudaErrorInvalidValue;
}
