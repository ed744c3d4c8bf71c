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
//   kUnroll loads of x and kUnroll of dy in flight; grid = splits x B. A
//   block is at most kMaxThreads = 256 threads of whole pixel rows; a row
//   of 257 to 512 chunks (float32 C = 2048) is a block of its own, one
//   pixel row of up to kWideThreads threads, each still one chunk column.
//   One instantiation serves both: ptxas gives each kernel as many
//   registers under a 512-thread bound as under a 256-thread one (H100,
//   sm_90a: 91-124 against 96-126), so 256-thread blocks keep their two
//   per SM.
// * Scale is constant over an image's pixels, so a thread keeps only two
//   float32 sums per channel, sum g and sum g * c; every output is made from
//   those per-channel sums: S1 = sum over the group's channels of
//   scale * (sum g), S2 likewise, dscale = inv * (sum g * c) per image. No
//   step depends on the group width: K = 2 to 64 take the same code.
// * The rows of a block fold by a fixed tree in shared memory; each block
//   leaves its per-channel partials in a workspace. Three folds follow,
//   each done by the block that arrives last at a counter (split_done.cuh),
//   each in a fixed order:
//   1. the last block of an image folds that image's splits in split
//      order, writes the image's S1 and S2, and leaves the image's dscale
//      and dbias terms;
//   2. the images fold in runs of `image_fold` (the wrapper's
//      SUMS_IMAGE_FOLD): the last image of a run folds the run's terms in
//      image order;
//   3. the last run to finish folds the runs' sums in run order into
//      dparams. With one run (B <= image_fold) step 2 writes dparams and
//      step 3 is skipped: the images then fold in image order, in one run.
//   No float atomics: two launches on the same inputs give the same bits.
// * The tail. A fold is a latency chain of L2 reads that one block makes
//   while the rest of the card idles, so the folds are kept short and wide:
//   each thread folds whole float4 columns (4 values a load) with kAhead
//   loads in flight over up to 4 of its columns, and no fold reads more
//   than splits, image_fold or B / image_fold partials per value. At B=64,
//   11x11x2048 bf16, one last fold of all 64 images' 4096 values by 256
//   threads, a value and 8 loads at a time, would make some 128 dependent
//   round trips to L2; the three folds here make 1, 2 and 2. The image's
//   last block then works from shared memory: the scales are loaded kSpread
//   at a time, and its planes are padded so that the loop over a group's
//   channels, a lane per group, is free of bank conflicts (unpadded, k = 32
//   and 64 put every lane on one bank: 8 of the kernel's 47 us at
//   11x11x2048 bf16, H100, k2r_breakdown.py).
// * The plan (ops/cuda_gn.py: SUMS_BLOCKS_PER_SM, row_plan's one_wave):
//   few splits, so that the grid is one wave of blocks on the card. A
//   second, partial wave would hold every image's fold back until it ends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "chunk16.cuh"
#include "gn_backward.cuh"
#include "split_done.cuh"

namespace {

constexpr int kMaxThreads = 256;   // a block of whole pixel rows
constexpr int kWideThreads = 512;  // a block of one pixel row of 257 to 512 chunks
constexpr int kUnroll = 4;  // 16-byte loads of x, and as many of dy, in flight
constexpr int kAhead = 16;  // float4 partials loaded before they are folded
constexpr int kSpread = 8;  // channels' scales a thread loads at once

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// store(i, the sum over s < count of src[i + s * stride .. + 3], in order of
// s) for every i = 0, 4, 8, ... < values: each thread folds whole float4
// columns, reading the partials from L2 (other blocks wrote them) with
// kAhead loads in flight, spread over kCols of its columns at a time.
// values, stride and src are multiples of 4 floats.
template <int kCols, typename Store>
__device__ __forceinline__ void fold_pass(const float* src, int values, int count,
                                          int64_t stride, Store& store) {
  constexpr int kDepth = kAhead / kCols;  // partials per column per batch
  const int step = 4 * blockDim.x;
  for (int i0 = 4 * threadIdx.x; i0 < values; i0 += kCols * step) {
    float4 acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < count; s += kDepth) {
      float4 part[kCols][kDepth];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int a = 0; a < kDepth; ++a) {
          const int i = i0 + c * step;
          part[c][a] = i < values && s + a < count
                           ? __ldcg(reinterpret_cast<const float4*>(
                                 src + i + (int64_t)(s + a) * stride))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int a = 0; a < kDepth; ++a) add4(acc[c], part[c][a]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (i0 + c * step < values) store(i0 + c * step, acc[c]);
    }
  }
}

template <typename Store>
__device__ __forceinline__ void fold_columns(const float* src, int values, int count,
                                             int64_t stride, Store store) {
  const int columns = (values / 4 + blockDim.x - 1) / blockDim.x;  // a thread's
  if (columns >= 4) {
    fold_pass<4>(src, values, count, stride, store);
  } else if (columns >= 2) {
    fold_pass<2>(src, values, count, stride, store);
  } else {
    fold_pass<1>(src, values, count, stride, store);
  }
}

// the store of a fold into global memory, a float4 at a time
struct StoreGlobal {
  float* dst;
  __device__ __forceinline__ void operator()(int i, const float4& v) const {
    *reinterpret_cast<float4*>(dst + i) = v;
  }
};

// N pixel rows p, p + rows, ... of a thread's chunk column: N loads of x and
// N of dy in flight, then taken in pixel order
template <int N, typename Take>
__device__ __forceinline__ void trip(const uint4* xs, const uint4* ds, int p, int rows, int cp,
                                     Take& take) {
  uint4 xr[N], dr[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    xr[u] = __ldg(xs + (int64_t)(p + u * rows) * cp);
    dr[u] = __ldg(ds + (int64_t)(p + u * rows) * cp);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) take(xr[u], dr[u]);
}

// grid (splits, B), block rows * cp threads, max(2 * E *
// blockDim.x, 3 * C + 4 * G) floats of dynamic shared memory. Block (s, b)
// reduces pixels [s * per_split, (s + 1) * per_split) of image b. work
// holds, per image, splits + 1 slots of [2, C] float32 (slot s < splits:
// block (s, b)'s per-channel (sum g, sum g * c); slot `splits`: the image's
// (dscale, dbias) terms), then one slot per run of image_fold images (the
// run's sums). counters: one per image, one per run, one for the runs.
template <typename T, typename TP, bool kRelu>
__global__ void __launch_bounds__(kWideThreads)
gn_backward_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ stats, const TP* __restrict__ scale,
                        const TP* __restrict__ bias, float* __restrict__ work,
                        unsigned* __restrict__ counters, float* __restrict__ sums,
                        float* __restrict__ dparams, int hw, int channels, int groups, int cp,
                        int rows, int per_split, int image_fold, float eps) {
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
    trip<kUnroll>(xs, ds, p, rows, cp, take);
  }
  for (; p < p1; p += rows) trip<1>(xs, ds, p, rows, cp, take);

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
  const int values = 2 * channels;  // floats in one slot
  const int64_t per_image = (int64_t)(splits + 1) * values;
  float* image_work = work + (int64_t)b * per_image;
  if (row == 0) {
    float* mine = image_work + (int64_t)split * values + col * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      mine[e] = sum_g[e];
      mine[channels + e] = sum_gc[e];
    }
  }
  if (!last_block_done(counters + b, (unsigned)splits)) return;

  // 1. the image's last block: its splits in split order, then the image's
  // S1, S2 and terms from shared memory, which holds sum g, sum g * c and
  // the scales in three planes of C + G floats, channel c at c + c / k: a
  // group's channels are contiguous and each group starts one bank after
  // the last, so the group loop's lanes (a group each, walking its channels
  // in order) read 32 different banks. Every load a thread makes here is
  // issued with its others: a chain of round trips to L2, one per channel
  // a thread owns, would set the tail at wide rows.
  const int padded = channels + groups;
  float* scales = smem + 2 * padded;
  float* invs = scales + padded;  // [G]: rsqrt(var + eps)
  auto at = [k](int c) { return c + c / k; };
  auto into_planes = [&](int i, const float4& v) {
    const int plane = i < channels ? 0 : 1;
    float* dst = smem + plane * padded;
    const int c = i - plane * channels;  // c .. c + 3 lie in one plane
    dst[at(c)] = v.x;
    dst[at(c + 1)] = v.y;
    dst[at(c + 2)] = v.z;
    dst[at(c + 3)] = v.w;
  };
  fold_columns(image_work, values, splits, values, into_planes);
  for (int c0 = tid; c0 < channels; c0 += kSpread * threads) {
    float v[kSpread];
#pragma unroll
    for (int j = 0; j < kSpread; ++j) {
      const int c = c0 + j * threads;
      v[j] = c < channels ? param_float(scale[c]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kSpread; ++j) {
      if (c0 + j * threads < channels) scales[at(c0 + j * threads)] = v[j];
    }
  }
  __syncthreads();
  for (int g = tid; g < groups; g += threads) {
    const float var = __ldg(stats + ((int64_t)b * 2 + 1) * groups + g);
    const int first = g * (k + 1);  // at(g * k)
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
    for (int c = first; c < first + k; ++c) {
      s1 = fmaf(scales[c], smem[c], s1);
      s2 = fmaf(scales[c], smem[padded + c], s2);
    }
    sums[((int64_t)b * 2 + 0) * groups + g] = s1;
    sums[((int64_t)b * 2 + 1) * groups + g] = s2;
    invs[g] = rsqrtf(__fadd_rn(var, eps));
  }
  __syncthreads();
  float* terms = image_work + (int64_t)splits * values;
  for (int c = tid; c < channels; c += threads) {
    terms[c] = invs[c / k] * smem[padded + at(c)];  // dscale's term
    terms[channels + c] = smem[at(c)];              // dbias's
  }

  // 2. the last image of a run of image_fold: the run's terms in image order
  const int runs = (batch + image_fold - 1) / image_fold;
  const int run = b / image_fold;
  const int first = run * image_fold;
  const int members = min(image_fold, batch - first);
  float* run_sums = work + (int64_t)batch * per_image + (int64_t)run * values;
  if (!last_block_done(counters + batch + run, (unsigned)members)) return;
  fold_columns(work + (int64_t)first * per_image + (int64_t)splits * values, values, members,
               per_image, StoreGlobal{runs == 1 ? dparams : run_sums});
  if (runs == 1) return;

  // 3. the last run: the runs' sums in run order
  if (!last_block_done(counters + batch + runs, (unsigned)runs)) return;
  fold_columns(work + (int64_t)batch * per_image, values, runs, values, StoreGlobal{dparams});
}

template <typename T, typename TP>
cudaError_t launch(const void* x, const void* dy, const void* stats, const void* scale,
                   const void* bias, void* sums, void* dparams, void* work, void* counters,
                   int64_t batch, int64_t hw, int64_t channels, int64_t groups, int64_t cp,
                   int64_t rows, int64_t splits, int64_t per_split, int64_t image_fold,
                   float eps, int relu, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int64_t threads = rows * cp;
  if (batch < 1 || batch > 65535 || hw < 1 || groups < 1 || channels % groups != 0 ||
      cp * E != channels || rows < 1 || threads > kWideThreads ||
      (threads > kMaxThreads && rows != 1) || splits < 1 || splits * per_split < hw ||
      (splits - 1) * per_split >= hw || image_fold < 1 || work == nullptr ||
      counters == nullptr) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)splits, (unsigned)batch);
  // the rows' planes, then the image's fold, the scales and the groups' inv
  const size_t shmem =
      std::max(2 * (size_t)E * threads, 3 * (size_t)channels + 4 * groups) * sizeof(float);
#define HN_GN_BACKWARD_SUMS(RELU)                                                          \
  gn_backward_sums_kernel<T, TP, RELU><<<grid, (unsigned)threads, shmem, stream>>>(         \
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(stats), \
      static_cast<const TP*>(scale), static_cast<const TP*>(bias), static_cast<float*>(work), \
      static_cast<unsigned*>(counters), static_cast<float*>(sums),                           \
      static_cast<float*>(dparams), (int)hw, (int)channels, (int)groups, (int)cp, (int)rows, \
      (int)per_split, (int)image_fold, eps)
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
// [batch, 2, groups] and dparams [2, channels] float32. work is [batch *
// (splits + 1) + runs, 2, channels] float32 scratch, runs = ceil(batch /
// image_fold); counters holds batch + runs + 1 zeros, which the launch
// leaves zero. The block shape (at most 256 threads, or one row of up to
// 512 chunks), the cut of hw into splits and image_fold come from the
// wrapper (ops/cuda_gn.py: row_plan, SUMS_IMAGE_FOLD). Returns the launch's
// cudaError_t.
extern "C" int hn_gn_backward_sums(const void* x, const void* dy, const void* stats,
                                   const void* scale, const void* bias, void* sums,
                                   void* dparams, void* work, void* counters, int64_t batch,
                                   int64_t hw, int64_t channels, int64_t groups, int64_t cp,
                                   int64_t rows, int64_t splits, int64_t per_split,
                                   int64_t image_fold, float eps, int relu, int dtype,
                                   int param_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HN_GN_BACKWARD_SUMS_AS(T, TP)                                                      \
  return (int)launch<T, TP>(x, dy, stats, scale, bias, sums, dparams, work, counters,     \
                            batch, hw, channels, groups, cp, rows, splits, per_split,     \
                            image_fold, eps, relu, s)
  if (dtype == 0 && param_dtype == 0) HN_GN_BACKWARD_SUMS_AS(float, float);
  if (dtype == 0 && param_dtype == 1) HN_GN_BACKWARD_SUMS_AS(float, __nv_bfloat16);
  if (dtype == 1 && param_dtype == 0) HN_GN_BACKWARD_SUMS_AS(__nv_bfloat16, float);
  if (dtype == 1 && param_dtype == 1) HN_GN_BACKWARD_SUMS_AS(__nv_bfloat16, __nv_bfloat16);
#undef HN_GN_BACKWARD_SUMS_AS
  return (int)cudaErrorInvalidValue;
}
