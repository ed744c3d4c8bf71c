// Fused A2J anchor decode — kernel K1, and K1xy, its variant without depth.
//
// K1 replaces the TPU kernel `_decode_kernel`, launched by
// `a2j_decode_pallas` (handnet_tpu/ops/pallas_a2j.py:26-75, pallas_call at
// :55). K1xy serves the 2D A2J (no depth head), whose decode the JAX package
// leaves to the einsum (handnet_tpu/models/a2j.py:145-153): the same kernel
// with the depth stream compiled out (the template flag kDepth).
//
// Computes, for each image b and joint p, a max-subtracted softmax over the
// N anchor logits cls[b, :, p] and the softmax-weighted means of
// anchor_u + reg[b, n, p, 0], anchor_v + reg[b, n, p, 1] and depth[b, n, p]:
// out [B, P, 3] float32 (u, v, d), accumulated in float32. K1xy leaves out
// the depth: out [B, P, 2] (u, v).
//
// What bounds it on the H100: bytes, by the count: at the fast profile (N =
// 11*11*16 = 1936, P = 21, B = 128, bf16 heads) it reads ~42 MB once and does
// a few flops and one exp per element. As measured, a block's fixed costs
// (launch, barriers, the tree, the arrival count) weigh as much as its copy:
// more and smaller blocks, a ring of staging buffers, and ex2.approx in
// place of expf were each tried and were slower or within 4% (PERF.md).
//
// Design:
// * The TPU kernel keeps one image's four [N, P] float32 blocks resident in
//   VMEM (~650 KB), nearly three times the 227 KB of shared memory a Hopper
//   block can have, and one block per image would leave a B=1 call on one
//   SM. Here an image's anchors are cut into gridDim.x splits (grid = splits
//   x B, chosen by the wrapper: eight at B=128, more at small B), and a block
//   stages its anchors through shared memory in chunks of at most 42 KB. A
//   block is 504 threads at P = 21, four of them fit an SM, and at B=128 the
//   eight splits make 1,024 blocks: two full waves of the 132 SMs.
// * The inputs are contiguous, so a chunk of anchors is one flat run of
//   cls, one of depth and one of reg (u and v interleaved, read in place).
//   Anchor counts per chunk are multiples of V = 16 / sizeof(T), so each run
//   starts and ends on 16 bytes and is copied by 16-byte cp.async, all of
//   them in flight at once, with no register staging. Rows of P = 21 values
//   are not aligned, which is why the copy is flat and the joint comes from
//   the flat index: element e of a chunk is anchor e / P, joint e % P. Where
//   N * P * sizeof(T) is not a multiple of 16 the same kernel copies element
//   by element (V = 1).
// * From shared memory thread t = r * P + p takes joint p and the chunk's
//   anchors r, r + R, ...: first their max, then exp(x - max) and the four
//   sums, the exact two-pass softmax; consecutive threads read consecutive
//   shared-memory words. Chunks combine by the max-rescaling rule (as flash
//   attention does), and so do the R rows of a block (a tree in shared
//   memory) and the splits of an image: each block leaves its partial in a
//   workspace, and the image's last block folds them in split order by the
//   same tree (split_done.cuh), so two runs give the same bits.
// * Without depth (K1xy) a chunk stages cls and reg only, three quarters of
//   K1's bytes per anchor, so a chunk holds a third more anchors; the
//   partials and the trees carry four sums (max, sum of exp, u, v) in place
//   of five. K1's instantiation (kDepth true) is the code as it was before
//   the flag, operation for operation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_done.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kStageBytes = 42 * 1024;  // of one chunk's cls, depth and reg

// Values kept per partial: m, s, u, v (and d with depth). Also the planes of
// the trees and the rows of the workspace, and the outputs per joint after m
// and s: u, v (and d).
__host__ __device__ constexpr int planes(bool depth) { return depth ? 5 : 4; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// reg's (u, v) pair of one element, in one shared-memory load
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Sums of exp(x - m) and of exp(x - m) times u, v and d.
struct Partial {
  float m, s, u, v, d;
};

__device__ __forceinline__ Partial empty_partial() {
  return Partial{-INFINITY, 0.f, 0.f, 0.f, 0.f};
}

// Fold partial b into a (d only with depth).
template <bool kDepth>
__device__ __forceinline__ void softmax_combine(Partial& a, const Partial b) {
  if (b.m == -INFINITY) return;
  if (a.m == -INFINITY) {
    a = b;
    return;
  }
  const float mx = fmaxf(a.m, b.m);
  const float ca = expf(a.m - mx);
  const float cb = expf(b.m - mx);
  a.s = a.s * ca + b.s * cb;
  a.u = a.u * ca + b.u * cb;
  a.v = a.v * ca + b.v * cb;
  if constexpr (kDepth) a.d = a.d * ca + b.d * cb;
  a.m = mx;
}

// Shared memory holds planes(kDepth) planes (m, s, u, v[, d]) of blockDim.x
// floats each.
template <bool kDepth>
__device__ __forceinline__ void put(float* tree, int i, const Partial a) {
  const int plane = blockDim.x;
  tree[i] = a.m;
  tree[plane + i] = a.s;
  tree[2 * plane + i] = a.u;
  tree[3 * plane + i] = a.v;
  if constexpr (kDepth) tree[4 * plane + i] = a.d;
}

template <bool kDepth>
__device__ __forceinline__ Partial get(const float* tree, int i) {
  const int plane = blockDim.x;
  return Partial{tree[i], tree[plane + i], tree[2 * plane + i], tree[3 * plane + i],
                 kDepth ? tree[4 * plane + i] : 0.f};
}

// One image's output row of joint p: (u, v[, d]) / s.
template <bool kDepth>
__device__ __forceinline__ void store_out(float* out, int64_t row, const Partial a) {
  const float inv = 1.f / a.s;
  float* o = out + row * (planes(kDepth) - 2);
  o[0] = a.u * inv;
  o[1] = a.v * inv;
  if constexpr (kDepth) o[2] = a.d * inv;
}

// Fold the partials of `rows` rows, `width` threads apart, into row 0 by a
// fixed tree: row r takes row r + ceil(active / 2) while the active rows
// halve. Every thread of the block calls it; a thread that holds no partial
// passes member = false.
template <bool kDepth>
__device__ __forceinline__ void fold_rows(Partial& a, float* tree, int tid, int row, int rows,
                                          int width, bool member) {
  if (member) put<kDepth>(tree, tid, a);
  for (int active = rows; active > 1;) {
    const int half = (active + 1) >> 1;
    __syncthreads();
    if (member && row + half < active) {
      softmax_combine<kDepth>(a, get<kDepth>(tree, tid + half * width));
      put<kDepth>(tree, tid, a);
    }
    active = half;
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Copy `count` elements from global to shared memory: by 16-byte cp.async
// (V > 1: both ends lie on 16 bytes), or element by element.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src, int count, int tid, int threads) {
  if constexpr (V > 1) {
    for (int i = tid; i < count / V; i += threads) cp_async16(dst + i * V, src + (int64_t)i * V);
  } else {
    for (int i = tid; i < count; i += threads) dst[i] = src[i];
  }
}

// grid (splits, B), block rows * P threads; dynamic shared memory: a chunk's
// cls, depth (with kDepth) and reg, and over them, once they are read,
// planes(kDepth) * blockDim.x floats for the trees. Block (s, b) reduces
// anchors [s * per_split, (s + 1) * per_split) of image b, `chunk` anchors at
// a time. Without kDepth, `depth` is not read.
template <typename T, int V, bool kDepth>
__global__ void __launch_bounds__(kMaxThreads)
a2j_decode_kernel(const T* __restrict__ cls, const T* __restrict__ reg,
                  const T* __restrict__ depth, const float* __restrict__ anchors,
                  float* __restrict__ partials, unsigned* __restrict__ counters,
                  float* __restrict__ out, int n_anchors, int n_joints, int rows, int per_split,
                  int chunk) {
  constexpr int kPlanes = planes(kDepth);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_cls = reinterpret_cast<T*>(smem_raw);
  T* s_dep = s_cls + chunk * n_joints;
  T* s_reg = s_cls + (kDepth ? 2 : 1) * chunk * n_joints;
  float* tree = reinterpret_cast<float*>(smem_raw);  // after the last chunk's barrier
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int p = tid % n_joints;
  const int r = tid / n_joints;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int b = blockIdx.y;
  const int a_end = min(n_anchors, (split + 1) * per_split);
  const int64_t image = (int64_t)b * n_anchors * n_joints;  // in elements of cls

  Partial acc = empty_partial();
  for (int a0 = split * per_split; a0 < a_end; a0 += chunk) {
    const int count = min(chunk, a_end - a0);  // anchors of this chunk
    const int64_t first = image + (int64_t)a0 * n_joints;
    stage<T, V>(s_cls, cls + first, count * n_joints, tid, threads);
    if constexpr (kDepth) stage<T, V>(s_dep, depth + first, count * n_joints, tid, threads);
    stage<T, V>(s_reg, reg + 2 * first, 2 * count * n_joints, tid, threads);
    if constexpr (V > 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    float m = -INFINITY;
    for (int a = r; a < count; a += rows) m = fmaxf(m, to_float(s_cls[a * n_joints + p]));
    Partial part{m, 0.f, 0.f, 0.f, 0.f};
    for (int a = r; a < count; a += rows) {
      const int e = a * n_joints + p;
      const float w = expf(to_float(s_cls[e]) - m);
      const float2 anchor = __ldg(reinterpret_cast<const float2*>(anchors) + a0 + a);
      const float2 offset = load_pair(s_reg + 2 * e);
      part.s += w;
      part.u += w * (anchor.x + offset.x);
      part.v += w * (anchor.y + offset.y);
      if constexpr (kDepth) part.d += w * to_float(s_dep[e]);
    }
    softmax_combine<kDepth>(acc, part);
    __syncthreads();  // the chunk is read: the next one may overwrite it
  }

  fold_rows<kDepth>(acc, tree, tid, r, rows, n_joints, true);

  if (r == 0) {
    if (splits == 1) {
      store_out<kDepth>(out, (int64_t)b * n_joints + p, acc);
    } else {
      float* dst = partials + ((int64_t)b * splits + split) * kPlanes * n_joints + p;
      dst[0] = acc.m;
      dst[n_joints] = acc.s;
      dst[2 * n_joints] = acc.u;
      dst[3 * n_joints] = acc.v;
      if constexpr (kDepth) dst[4 * n_joints] = acc.d;
    }
  }
  if (splits == 1) return;
  if (!last_block_done(counters + b, (unsigned)splits)) return;

  // the image's last block: row r takes splits r, r + lanes, ... in order,
  // then the rows meet by the same tree
  const int lanes = min(splits, rows);
  const bool member = r < lanes;
  acc = empty_partial();
  if (member) {
    for (int s = r; s < splits; s += lanes) {
      const float* src = partials + ((int64_t)b * splits + s) * kPlanes * n_joints + p;
      softmax_combine<kDepth>(acc, Partial{__ldcg(src), __ldcg(src + n_joints),
                                           __ldcg(src + 2 * n_joints),
                                           __ldcg(src + 3 * n_joints),
                                           kDepth ? __ldcg(src + 4 * n_joints) : 0.f});
    }
  }
  fold_rows<kDepth>(acc, tree, tid, r, lanes, n_joints, member);
  if (r == 0) store_out<kDepth>(out, (int64_t)b * n_joints + p, acc);
}

template <typename T, bool kDepth>
cudaError_t launch(const void* cls, const void* reg, const void* depth, const void* anchors,
                   void* partials, void* counters, void* out, int64_t batch, int64_t n,
                   int64_t p, int64_t vec, int64_t rows, int64_t splits, int64_t per_split,
                   int64_t chunk, cudaStream_t stream) {
  constexpr int kFull = 16 / sizeof(T);
  const int64_t threads = rows * p;
  // cls, depth and reg's two values per element; K1xy has no depth
  const int64_t staged = chunk * p * (kDepth ? 4 : 3) * (int64_t)sizeof(T);
  if (batch < 1 || batch > 65535 || n < 1 || p < 1 || rows < 1 || threads > kMaxThreads ||
      splits < 1 || splits * per_split < n || (splits - 1) * per_split >= n || chunk < 1 ||
      staged > kStageBytes || (vec != 1 && vec != kFull) ||
      (vec > 1 && (per_split % vec || chunk % vec || (n * p) % vec)) ||
      (splits > 1 && (partials == nullptr || counters == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)splits, (unsigned)batch);
  const size_t tree = planes(kDepth) * (size_t)threads * sizeof(float);
  const size_t shmem = (size_t)staged > tree ? (size_t)staged : tree;
#define HN_A2J_DECODE(V)                                                                    \
  a2j_decode_kernel<T, V, kDepth><<<grid, (unsigned)threads, shmem, stream>>>(              \
      static_cast<const T*>(cls), static_cast<const T*>(reg), static_cast<const T*>(depth), \
      static_cast<const float*>(anchors), static_cast<float*>(partials),                    \
      static_cast<unsigned*>(counters), static_cast<float*>(out), (int)n, (int)p, (int)rows, \
      (int)per_split, (int)chunk)
  if (vec > 1) {
    HN_A2J_DECODE(kFull);
  } else {
    HN_A2J_DECODE(1);
  }
#undef HN_A2J_DECODE
  return cudaGetLastError();
}

}  // namespace

// cls and depth [batch, n, p] and reg [batch, n, p, 2], contiguous, of one
// dtype (0 = float32, 1 = bfloat16); anchors [n, 2] float32 contiguous; out
// [batch, p, 3] float32. The block shape (rows x p threads), the cut of n into
// `splits` runs of `per_split` anchors, the staged `chunk` and the copy width
// `vec` (16 / itemsize with every pointer on 16 bytes, or 1) come from the
// wrapper (ops/cuda_a2j.py: decode_plan). With splits > 1, partials is
// [batch, splits, 5, p] float32 scratch and counters holds batch zeros, which
// the launch leaves zero. Returns the launch's cudaError_t.
extern "C" int hn_a2j_decode(const void* cls, const void* reg, const void* depth,
                             const void* anchors, void* out, void* partials, void* counters,
                             int64_t batch, int64_t n, int64_t p, int64_t vec, int64_t rows,
                             int64_t splits, int64_t per_split, int64_t chunk, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return (int)launch<float, true>(cls, reg, depth, anchors, partials, counters, out, batch, n,
                                    p, vec, rows, splits, per_split, chunk, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16, true>(cls, reg, depth, anchors, partials, counters, out,
                                            batch, n, p, vec, rows, splits, per_split, chunk, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K1xy: as hn_a2j_decode without depth. cls [batch, n, p] and reg [batch, n,
// p, 2]; out [batch, p, 2] float32; with splits > 1, partials is [batch,
// splits, 4, p] float32 scratch. The plan comes from decode_plan(...,
// depth=False).
extern "C" int hn_a2j_decode_xy(const void* cls, const void* reg, const void* anchors, void* out,
                                void* partials, void* counters, int64_t batch, int64_t n,
                                int64_t p, int64_t vec, int64_t rows, int64_t splits,
                                int64_t per_split, int64_t chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float, false>(cls, reg, nullptr, anchors, partials, counters, out, batch,
                                     n, p, vec, rows, splits, per_split, chunk, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16, false>(cls, reg, nullptr, anchors, partials, counters,
                                             out, batch, n, p, vec, rows, splits, per_split,
                                             chunk, s);
  }
  return (int)cudaErrorInvalidValue;
}
