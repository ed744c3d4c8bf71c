// The sums of GroupNorm's backward in one read of x and dy — kernel K2r.
//
// Replaces no Pallas kernel: the JAX package's `pallas_group_norm`
// (handnet_tpu/ops/pallas_gn.py) is inference-only and has no VJP, and its
// training GroupNorms are flax GroupNorms whose gradient XLA derives and
// fuses (handnet_tpu/models/fcos.py:62-65, handnet_tpu/nn/resnet.py:68).
// The port trains through K2s and K2a (gn_stats.cu, gn_apply.cu); this
// kernel and K2d (gn_backward_dx.cu) are their backward.
//
// For y = relu(((x - mean) * inv) * scale + bias), inv = rsqrt(var + eps),
// over n = HW * K values per (image, group), with g = dy * [y > 0] (g = dy
// without the ReLU) and c = x - mean, it computes in float32
//     sums [B, 2, G]:  S1 = sum g * scale,  S2 = sum g * scale * c
//                      (per image and group, over its n values)
//     dparams [2, C]:  dscale = sum g * c * inv,  dbias = sum g
//                      (per channel, over B, H and W)
// from which K2d makes dx = inv * (g * scale - S1 / n) - c * inv^3 * S2 / n.
// c is x - mean, never x * inv - mean * inv, so S2 keeps its precision when
// mean >> std (as gn_stats.cu keeps the variance's).
//
// What bounds it on the H100: bytes. x and dy are read once each (P3 of a
// train step, [8, 100, 136, 256] bf16: 111 MB); the ReLU mask is recomputed
// from x with K2a's operations (gn_backward.cuh), so y is not read.
//
// Design:
// * The walk of K2s and K2a: thread t owns 16-byte chunk column t % cp
//   (E channels) of pixel row t / cp; a block reads whole pixel rows, with
//   kUnroll loads of x and kUnroll of dy in flight; grid = splits x B.
// * Scale is constant over an image's pixels, so a thread keeps only two
//   float32 sums per channel, sum g and sum g * c; every output is made from
//   those per-channel sums: S1 = sum over the group's channels of
//   scale * (sum g), S2 likewise, dscale = inv * (sum g * c) per image.
// * The rows of a block fold by a fixed tree in shared memory; each block
//   leaves its per-channel partials in a workspace. The last block of an
//   image (split_done.cuh) folds that image's splits in split order, writes
//   the image's S1 and S2, and leaves the image's dscale and dbias terms;
//   the last image to finish folds those over the images in image order.
//   No float atomics: two launches on the same inputs give the same bits.
// * The tail: an image folds its own splits as soon as its blocks are done,
//   so the last fold reads only B partials per channel. The wrapper also
//   plans fewer splits than K2s's (ops/cuda_gn.py: SUMS_BLOCKS_PER_SM): at
//   [8, 100, 136, 256] bf16 an image has 33 splits, not K2s's 107, which
//   is one wave of blocks on the card, and each image's fold reads 33
//   partials per value with kAhead loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk16.cuh"
#include "gn_backward.cuh"
#include "split_done.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads of x, and as many of dy, in flight
constexpr int kAhead = 8;   // partials loaded before they are folded

// Sum of `count` values `stride` floats apart, in order, from L2 (another
// block wrote them), with kAhead loads in flight.
__device__ __forceinline__ float fold_in_order(const float* src, int count, int64_t stride) {
  float acc = 0.f;
  for (int s = 0; s < count; s += kAhead) {
    float part[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      part[a] = s + a < count ? __ldcg(src + (int64_t)(s + a) * stride) : 0.f;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) acc += part[a];
  }
  return acc;
}

// grid (splits, B), block rows * cp threads, 2 * E * blockDim.x floats of
// dynamic shared memory. Block (s, b) reduces pixels [s * per_split,
// (s + 1) * per_split) of image b. work is [B, splits + 1, 2, C] float32:
// slot s < splits holds block (s, b)'s per-channel (sum g, sum g * c), slot
// `splits` the image's (dscale, dbias) terms.
template <typename T, typename TP, bool kRelu>
__global__ void __launch_bounds__(kMaxThreads)
gn_backward_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ stats, const TP* __restrict__ scale,
                        const TP* __restrict__ bias, float* __restrict__ work,
                        unsigned* __restrict__ counters, float* __restrict__ sums,
                        float* __restrict__ dparams, int hw, int channels, int groups, int cp,
                        int rows, int per_split, float eps) {
  constexpr int E = 16 / sizeof(T);  // values in a 16-byte chunk
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int col = tid % cp;
  const int row = tid / cp;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int b = blockIdx.y;
  const int batch = gridDim.y;
  const int k = channels / groups;
  const int p0 = split * per_split;
  const int p1 = min(hw, p0 + per_split);

  float mean[E], inv[E], mul[E], add[E];
  forward_coefficients<E, TP>(stats, scale, bias, b, col, groups, k, eps, mean, inv, mul, add);
  float sum_g[E], sum_gc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) sum_g[e] = sum_gc[e] = 0.f;

  const int64_t image = (int64_t)b * hw * cp;  // in chunks
  const uint4* xs = reinterpret_cast<const uint4*>(x) + image + col;
  const uint4* ds = reinterpret_cast<const uint4*>(dy) + image + col;

  auto take = [&](const uint4& xr, const uint4& dr) {
    float v[E], d[E];
    decode(xr, v);
    decode(dr, d);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float centred = __fsub_rn(v[e], mean[e]);
      const float g = !kRelu || relu_passes<T>(centred, mul[e], add[e]) ? d[e] : 0.f;
      sum_g[e] += g;
      sum_gc[e] = fmaf(g, centred, sum_gc[e]);
    }
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
    for (int u = 0; u < kUnroll; ++u) take(xr[u], dr[u]);
  }
  for (; p < p1; p += rows) take(__ldg(xs + (int64_t)p * cp), __ldg(ds + (int64_t)p * cp));

  // the block's rows by a fixed tree: row r takes row r + ceil(active / 2)
  // while the active rows halve; planes of blockDim.x floats, one per value
#pragma unroll
  for (int e = 0; e < E; ++e) {
    smem[e * threads + tid] = sum_g[e];
    smem[(E + e) * threads + tid] = sum_gc[e];
  }
  for (int active = rows; active > 1;) {
    const int half = (active + 1) >> 1;
    __syncthreads();
    if (row + half < active) {
      const int other = tid + half * cp;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sum_g[e] += smem[e * threads + other];
        sum_gc[e] += smem[(E + e) * threads + other];
        smem[e * threads + tid] = sum_g[e];
        smem[(E + e) * threads + tid] = sum_gc[e];
      }
    }
    active = half;
  }
  const int64_t slot = 2 * (int64_t)channels;  // floats in one partial
  float* image_work = work + (int64_t)b * (splits + 1) * slot;
  if (row == 0) {
    float* mine = image_work + split * slot + col * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      mine[e] = sum_g[e];
      mine[channels + e] = sum_gc[e];
    }
  }
  if (!last_block_done(counters + b, (unsigned)splits)) return;

  // the image's last block: its splits in split order, one value a thread
  for (int i = tid; i < 2 * channels; i += threads) {
    smem[i] = fold_in_order(image_work + i, splits, slot);
  }
  __syncthreads();
  // smem[0, C): sum g per channel; smem[C, 2C): sum g * c
  for (int g = tid; g < groups; g += threads) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * k; c < (g + 1) * k; ++c) {
      const float sc = param_float(scale[c]);
      s1 = fmaf(sc, smem[c], s1);
      s2 = fmaf(sc, smem[channels + c], s2);
    }
    sums[((int64_t)b * 2 + 0) * groups + g] = s1;
    sums[((int64_t)b * 2 + 1) * groups + g] = s2;
  }
  float* terms = image_work + splits * slot;
  for (int c = tid; c < channels; c += threads) {
    const float var = __ldg(stats + ((int64_t)b * 2 + 1) * groups + c / k);
    terms[c] = rsqrtf(__fadd_rn(var, eps)) * smem[channels + c];  // dscale's term
    terms[channels + c] = smem[c];                                // dbias's
  }
  if (!last_block_done(counters + batch, (unsigned)batch)) return;

  // the last image: the images' terms in image order
  for (int i = tid; i < 2 * channels; i += threads) {
    dparams[i] = fold_in_order(work + splits * slot + i, batch, (splits + 1) * slot);
  }
}

template <typename T, typename TP>
cudaError_t launch(const void* x, const void* dy, const void* stats, const void* scale,
                   const void* bias, void* sums, void* dparams, void* work, void* counters,
                   int64_t batch, int64_t hw, int64_t channels, int64_t groups, int64_t cp,
                   int64_t rows, int64_t splits, int64_t per_split, float eps, int relu,
                   cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int64_t threads = rows * cp;
  if (batch < 1 || batch > 65535 || hw < 1 || groups < 1 || channels % groups != 0 ||
      cp * E != channels || rows < 1 || threads > kMaxThreads || splits < 1 ||
      splits * per_split < hw || (splits - 1) * per_split >= hw || work == nullptr ||
      counters == nullptr) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)splits, (unsigned)batch);
  const size_t shmem = 2 * (size_t)E * threads * sizeof(float);
#define HN_GN_BACKWARD_SUMS(RELU)                                                          \
  gn_backward_sums_kernel<T, TP, RELU><<<grid, (unsigned)threads, shmem, stream>>>(        \
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(stats), \
      static_cast<const TP*>(scale), static_cast<const TP*>(bias), static_cast<float*>(work), \
      static_cast<unsigned*>(counters), static_cast<float*>(sums),                           \
      static_cast<float*>(dparams), (int)hw, (int)channels, (int)groups, (int)cp, (int)rows, \
      (int)per_split, eps)
  if (relu) {
    HN_GN_BACKWARD_SUMS(true);
  } else {
    HN_GN_BACKWARD_SUMS(false);
  }
#undef HN_GN_BACKWARD_SUMS
  return cudaGetLastError();
}

}  // namespace

// x and dy [batch, hw, channels] contiguous, 16-byte aligned, of one dtype
// (0 = float32, 1 = bfloat16); stats [batch, 2, groups] float32 (K2s's);
// scale and bias [channels] of param_dtype (same codes). Writes sums
// [batch, 2, groups] and dparams [2, channels] float32. work is [batch,
// splits + 1, 2, channels] float32 scratch; counters holds batch + 1 zeros,
// which the launch leaves zero. The block shape and the cut of hw into
// splits come from the wrapper (ops/cuda_gn.py: row_plan). Returns the
// launch's cudaError_t.
extern "C" int hn_gn_backward_sums(const void* x, const void* dy, const void* stats,
                                   const void* scale, const void* bias, void* sums,
                                   void* dparams, void* work, void* counters, int64_t batch,
                                   int64_t hw, int64_t channels, int64_t groups, int64_t cp,
                                   int64_t rows, int64_t splits, int64_t per_split, float eps,
                                   int relu, int dtype, int param_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HN_GN_BACKWARD_SUMS_AS(T, TP)                                                      \
  return (int)launch<T, TP>(x, dy, stats, scale, bias, sums, dparams, work, counters,     \
                            batch, hw, channels, groups, cp, rows, splits, per_split, eps, \
                            relu, s)
  if (dtype == 0 && param_dtype == 0) HN_GN_BACKWARD_SUMS_AS(float, float);
  if (dtype == 0 && param_dtype == 1) HN_GN_BACKWARD_SUMS_AS(float, __nv_bfloat16);
  if (dtype == 1 && param_dtype == 0) HN_GN_BACKWARD_SUMS_AS(__nv_bfloat16, float);
  if (dtype == 1 && param_dtype == 1) HN_GN_BACKWARD_SUMS_AS(__nv_bfloat16, __nv_bfloat16);
#undef HN_GN_BACKWARD_SUMS_AS
  return (int)cudaErrorInvalidValue;
}
