// GroupNorm statistics of an NHWC activation in one read — kernel K2.
//
// Replaces the TPU kernel `_stats_kernel`, launched by `gn_group_stats`
// (handnet_tpu/ops/pallas_gn.py:58-149, pallas_call at :138).
//
// Computes, for x [B, HW, C] (NHWC flattened) and G groups of K = C/G
// channels, out [B, 2, G] float32: the group mean and the biased group
// variance over (HW, K), as flax GroupNorm(use_fast_variance=False) does.
//
// What bounds it on the H100: bytes. Each element is read once and takes a
// handful of flops, far below the card's ~295 flops per byte of bf16. At the
// fast profile's P3 level (B=128, 60x80, C=256, bf16) one call reads 315 MB.
//
// Design:
// * The TPU kernel walks HW tiles in grid order and carries a running mean
//   and M2 in VMEM scratch from one grid step to the next. Hopper blocks run
//   in no order and carry nothing, so here one block owns one (b, g) pair
//   and loops over HW itself; B*G = 4096 blocks at B=128 fill 132 SMs (at
//   B=1 only 32 blocks run: a split-HW variant is later work).
// * A group's K channels are contiguous in NHWC: for C=256, G=32 in bf16 they
//   are 16 bytes, read with one 16-byte vector load per pixel.
// * Numerics: never sum and sum-of-squares (the E[x^2]-E[x]^2 cancellation
//   the JAX kernel exists to avoid). Each pixel's K values take an exact
//   two-pass mean and M2; each thread folds pixels into its running
//   (count, mean, M2) with Chan's parallel-variance combine
//       delta = mean_b - mean_a;  n = n_a + n_b
//       mean  = mean_a + delta * n_b / n
//       M2    = M2_a + M2_b + delta^2 * n_a * n_b / n
//   and threads combine the same way: warp shuffles, then one partial per
//   warp through shared memory. The TPU kernel's channel->group fold (iota
//   matmuls) disappears: a block already covers exactly one group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Fold partial b = (nb, mb, m2b) into a = (n, mean, m2).
__device__ __forceinline__ void chan_combine(float& n, float& mean, float& m2,
                                             float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb; mean = mb; m2 = m2b;
    return;
  }
  const float total = n + nb;
  const float delta = mb - mean;
  const float frac = nb / total;
  mean += delta * frac;
  m2 += m2b + delta * delta * n * frac;
  n = total;
}

// Load one pixel's K channels of a group into floats: 16-byte vector loads
// when the group spans whole 16-byte words (the wrapper checks alignment).
template <typename T, int K>
__device__ __forceinline__ void load_group(const T* __restrict__ p, float (&v)[K]) {
  if constexpr ((K * sizeof(T)) % 16 == 0) {
    constexpr int kPerVec = 16 / sizeof(T);
#pragma unroll
    for (int j = 0; j < K / kPerVec; ++j) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + j);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int q = 0; q < kPerVec; ++q) v[j * kPerVec + q] = to_float(e[q]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = to_float(p[k]);
  }
}

// grid (G, B), block kThreads: block (g, b) reduces group g of image b.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ out,
                int64_t hw, int64_t channels) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int groups = gridDim.x;
  const T* base = x + (int64_t)b * hw * channels + (int64_t)g * K;

  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int64_t i = threadIdx.x; i < hw; i += kThreads) {
    float v[K];
    load_group<T, K>(base + i * channels, v);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) s += v[k];
    const float pm = s / K;
    float pm2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float d = v[k] - pm;
      pm2 += d * d;
    }
    chan_combine(n, mean, m2, (float)K, pm, pm2);
  }

  // warp-level combine
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    chan_combine(n, mean, m2, nb, mb, m2b);
  }

  // one partial per warp through shared memory, combined by warp 0
  constexpr int kWarps = kThreads / 32;
  __shared__ float sh_n[kWarps], sh_mean[kWarps], sh_m2[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_n[warp] = n; sh_mean[warp] = mean; sh_m2[warp] = m2;
  }
  __syncthreads();
  if (warp == 0) {
    n = lane < kWarps ? sh_n[lane] : 0.f;
    mean = lane < kWarps ? sh_mean[lane] : 0.f;
    m2 = lane < kWarps ? sh_m2[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, n, off);
      const float mb = __shfl_down_sync(0xffffffffu, mean, off);
      const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
      chan_combine(n, mean, m2, nb, mb, m2b);
    }
    if (lane == 0) {
      out[((int64_t)b * 2 + 0) * groups + g] = mean;
      out[((int64_t)b * 2 + 1) * groups + g] = m2 / n;  // biased, like GN
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int64_t batch, int64_t hw,
                   int64_t channels, int64_t groups, cudaStream_t stream) {
  const dim3 grid((unsigned)groups, (unsigned)batch);
  const T* xp = static_cast<const T*>(x);
  float* op = static_cast<float*>(out);
  switch (channels / groups) {
    case 2: gn_stats_kernel<T, 2><<<grid, kThreads, 0, stream>>>(xp, op, hw, channels); break;
    case 4: gn_stats_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xp, op, hw, channels); break;
    case 8: gn_stats_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xp, op, hw, channels); break;
    case 16: gn_stats_kernel<T, 16><<<grid, kThreads, 0, stream>>>(xp, op, hw, channels); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int hn_gn_group_stats(const void* x, void* out, int64_t batch,
                                 int64_t hw, int64_t channels, int64_t groups,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, out, batch, hw, channels, groups, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, out, batch, hw, channels, groups, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
