// GroupNorm statistics of an NHWC activation in one read — kernel K2s.
//
// Replaces the TPU kernel `_stats_kernel`, launched by `gn_group_stats`
// (handnet_tpu/ops/pallas_gn.py:58-149, pallas_call at :138). Its result
// feeds K2a (gn_apply.cu); the two together are `pallas_group_norm`
// (pallas_gn.py:152-169), whose normalize and affine the TPU left to XLA.
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
// * Whole pixel rows are read. A pixel's C channels are `cp` chunks of 16
//   bytes; thread t of a block owns chunk column t % cp and pixel row
//   t / cp, so the block's threads read consecutive 16-byte chunks of
//   consecutive pixels (bf16, C=256: a warp's 32 lanes take the 32 chunks of
//   one pixel, lane = group) and every 32-byte sector is used whole.
// * The TPU kernel walks HW tiles in grid order and carries a running mean
//   and M2 in VMEM scratch from one grid step to the next. Hopper blocks run
//   in no order and carry nothing, so HW is cut into gridDim.x splits per
//   image (grid = splits x B, chosen by the wrapper so that the blocks fill
//   the SMs at B=1 as at B=128). Each block leaves one partial
//   (count, mean, M2) per group in a workspace; the block of an image that
//   finishes last folds the partials in split order (split_done.cuh), so two
//   runs give the same bits.
// * A thread keeps kUnroll 16-byte loads in flight before it folds them.
// * Numerics: never sum and sum-of-squares (the E[x^2]-E[x]^2 cancellation
//   the JAX kernel exists to avoid). The kUnroll x W values of one group
//   that a thread holds take an exact two-pass mean and M2; the thread folds
//   them into its running (count, mean, M2) with Chan's combine
//       delta = mean_b - mean_a;  n = n_a + n_b
//       mean  = mean_a + delta * n_b / n
//       M2    = M2_a + M2_b + delta^2 * n_a * n_b / n
//   and pixel rows, chunk columns of one group, and splits combine the same
//   way, each in a fixed tree or order. The TPU kernel's channel->group fold
//   (iota matmuls) becomes: a chunk holds S whole groups (K <= chunk), or J
//   neighbouring chunk columns make one group (K > chunk). A thread of row 0
//   folds a run of up to kRun of a group's columns in order; where a group
//   spans more (K = 32 and 64: J = 8 or 16 in float32, 8 in bf16), its runs
//   meet by the fixed tree of the pixel rows.
// * Widths: K = 2 to 64, every divisor of C that the TPU kernel takes for
//   GroupNorm(32) over 64 to 2048 channels. A block is at most kMaxThreads =
//   256 threads of whole pixel rows; a row of more than 256 chunks (float32
//   C = 2048: 512 chunks) takes a block of its own kWideThreads threads, one
//   pixel row, each thread still one chunk column. The two sizes are two
//   instantiations: under a 512-thread bound ptxas gives the bf16 kernels of
//   K = 8 to 64 95 to 128 registers, where a 256-thread bound gives 79 or
//   80, and one 512-bound instantiation ran K2s at bf16 11x11x1024 in
//   0.0161 ms against 0.0129 (H100 80GB HBM3, 700 W; the same bits by
//   k12_device_times.py --gn-hash). K2a's registers do not move: it has one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk16.cuh"
#include "split_done.cuh"

namespace {

constexpr int kMaxThreads = 256;   // a block of whole pixel rows
constexpr int kWideThreads = 512;  // a block of one pixel row of 257 to 512 chunks
constexpr int kUnroll = 8;  // 16-byte loads a thread has in flight
constexpr int kRun = 4;     // a group's chunk columns that one thread folds in order

struct Stat {
  float n, mean, m2;
};

// Fold partial b into a.
__device__ __forceinline__ void chan_combine(Stat& a, const Stat b) {
  if (b.n == 0.f) return;
  if (a.n == 0.f) {
    a = b;
    return;
  }
  const float total = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float frac = b.n / total;
  a.mean += delta * frac;
  a.m2 += b.m2 + delta * delta * a.n * frac;
  a.n = total;
}

// Exact two-pass (count, mean, M2) of the N x W values v[u][first .. first+W).
template <int N, int E, int W>
__device__ __forceinline__ Stat two_pass(const float (&v)[N][E], int first) {
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < N; ++u) {
#pragma unroll
    for (int e = 0; e < W; ++e) sum += v[u][first + e];
  }
  const float mean = sum * (1.f / (N * W));  // N * W is a power of two: exact
  float m2 = 0.f;
#pragma unroll
  for (int u = 0; u < N; ++u) {
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float d = v[u][first + e] - mean;
      m2 += d * d;
    }
  }
  return Stat{(float)(N * W), mean, m2};
}

// Shared memory holds three planes (n, mean, M2) of `plane` floats each.
__device__ __forceinline__ void put(float* smem, int plane, int i, const Stat s) {
  smem[i] = s.n;
  smem[plane + i] = s.mean;
  smem[2 * plane + i] = s.m2;
}

__device__ __forceinline__ Stat get(const float* smem, int plane, int i) {
  return Stat{smem[i], smem[plane + i], smem[2 * plane + i]};
}

// Fold the partials of `rows` rows, `width` threads apart, into row 0 by a
// fixed tree: row r takes row r + ceil(active / 2) while the active rows
// halve. Every thread of the block calls it; a thread that holds no partial
// passes member = false. Afterwards row 0's sums are in `st` and in shared
// memory at its own index.
template <int S>
__device__ __forceinline__ void fold_rows(Stat (&st)[S], float* smem, int plane, int tid,
                                          int row, int rows, int width, bool member) {
  if (member) {
#pragma unroll
    for (int j = 0; j < S; ++j) put(smem, plane, tid * S + j, st[j]);
  }
  for (int active = rows; active > 1;) {
    const int half = (active + 1) >> 1;
    __syncthreads();
    if (member && row + half < active) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        chan_combine(st[j], get(smem, plane, (tid + half * width) * S + j));
        put(smem, plane, tid * S + j, st[j]);
      }
    }
    active = half;
  }
  __syncthreads();
}

// grid (splits, B), block rows * cp threads (at most kBlock), 3 * blockDim.x
// * S floats of dynamic shared memory. Block (s, b) reduces pixels
// [s * per_split, (s + 1) * per_split) of image b.
template <typename T, int K, int kBlock>
__global__ void __launch_bounds__(kBlock)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                unsigned* __restrict__ counters, float* __restrict__ out, int hw,
                int channels, int cp, int rows, int per_split) {
  constexpr int E = 16 / sizeof(T);  // values in a 16-byte chunk
  constexpr int W = K < E ? K : E;   // of them, in one group
  constexpr int S = E / W;           // groups that a chunk holds (K <= E)
  constexpr int J = K / W;           // chunk columns that a group spans (K > E)
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int col = tid % cp;
  const int row = tid / cp;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int b = blockIdx.y;
  const int groups = channels / K;
  const int plane = blockDim.x * S;
  const int p0 = split * per_split;
  const int p1 = min(hw, p0 + per_split);
  // chunk `col` of pixel p of this image is base[p * cp]
  const uint4* base = reinterpret_cast<const uint4*>(x + (int64_t)b * hw * channels) + col;

  Stat st[S];
#pragma unroll
  for (int j = 0; j < S; ++j) st[j] = Stat{0.f, 0.f, 0.f};

  int p = p0 + row;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = __ldg(base + (int64_t)(p + u * rows) * cp);
    float v[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) decode(raw[u], v[u]);
#pragma unroll
    for (int j = 0; j < S; ++j) chan_combine(st[j], two_pass<kUnroll, E, W>(v, j * W));
  }
  for (; p < p1; p += rows) {  // the ragged end of the split, a pixel at a time
    float v[1][E];
    decode(__ldg(base + (int64_t)p * cp), v[0]);
#pragma unroll
    for (int j = 0; j < S; ++j) chan_combine(st[j], two_pass<1, E, W>(v, j * W));
  }

  fold_rows<S>(st, smem, plane, tid, row, rows, cp, true);

  // chunk columns to groups; row 0 holds the block's sums. The thread at
  // the head of each run of R columns folds the run in column order; the
  // NR runs of a group meet by fold_rows' tree, R columns apart.
  constexpr int R = J < kRun ? J : kRun;
  constexpr int NR = J / R;
  const bool head = row == 0 && col % R == 0;
  Stat a[S];
#pragma unroll
  for (int j = 0; j < S; ++j) a[j] = st[j];
  if (head) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
#pragma unroll
      for (int i = 1; i < R; ++i) chan_combine(a[j], get(smem, plane, (col + i) * S + j));
    }
  }
  if constexpr (NR > 1) fold_rows<S>(a, smem, plane, tid, (col / R) % NR, NR, R, head);
  if (head && col % J == 0) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int g = J > 1 ? col / J : col * S + j;
      if (splits == 1) {
        out[((int64_t)b * 2 + 0) * groups + g] = a[j].mean;
        out[((int64_t)b * 2 + 1) * groups + g] = a[j].m2 / a[j].n;  // biased, like GN
      } else {
        float* dst = partials + ((int64_t)b * splits + split) * 3 * groups + g;
        dst[0] = a[j].n;
        dst[groups] = a[j].mean;
        dst[2 * groups] = a[j].m2;
      }
    }
  }
  if (splits == 1) return;
  if (!last_block_done(counters + b, (unsigned)splits)) return;

  // the image's last block: `lanes` threads per group take the splits in
  // turn, in split order, and meet by the same tree
  const int lanes = min(splits, (int)blockDim.x / groups);
  const bool member = tid < lanes * groups;
  const int g = tid % groups;
  const int lane = tid / groups;
  Stat acc[1] = {Stat{0.f, 0.f, 0.f}};
  if (member) {
    const float* mine = partials + (int64_t)b * splits * 3 * groups + g;
    constexpr int kAhead = 4;  // partials loaded before they are folded
    for (int s = lane; s < splits; s += kAhead * lanes) {
      Stat part[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const float* src = mine + (int64_t)(s + i * lanes) * 3 * groups;
        part[i] = s + i * lanes < splits
                      ? Stat{__ldcg(src), __ldcg(src + groups), __ldcg(src + 2 * groups)}
                      : Stat{0.f, 0.f, 0.f};
      }
#pragma unroll
      for (int i = 0; i < kAhead; ++i) chan_combine(acc[0], part[i]);
    }
  }
  fold_rows<1>(acc, smem, plane, tid, lane, lanes, groups, member);
  if (member && lane == 0) {
    out[((int64_t)b * 2 + 0) * groups + g] = acc[0].mean;
    out[((int64_t)b * 2 + 1) * groups + g] = acc[0].m2 / acc[0].n;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* partials, void* counters, void* out, int64_t batch,
                   int64_t hw, int64_t channels, int64_t groups, int64_t cp, int64_t rows,
                   int64_t splits, int64_t per_split, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int64_t k = channels / groups;
  const int64_t threads = rows * cp;
  if (batch < 1 || hw < 1 || groups < 1 || channels != groups * k || cp * E != channels ||
      rows < 1 || threads > kWideThreads || (threads > kMaxThreads && rows != 1) ||
      groups > threads || splits < 1 || splits * per_split < hw ||
      (splits - 1) * per_split >= hw || batch > 65535 ||
      (splits > 1 && (partials == nullptr || counters == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const int s_per_chunk = k < E ? (int)(E / k) : 1;
  const dim3 grid((unsigned)splits, (unsigned)batch);
  const size_t shmem = 3 * (size_t)threads * s_per_chunk * sizeof(float);
#define HN_GN_STATS_BLOCK(K, BLOCK)                                                        \
  gn_stats_kernel<T, K, BLOCK><<<grid, (unsigned)threads, shmem, stream>>>(                \
      static_cast<const T*>(x), static_cast<float*>(partials),                             \
      static_cast<unsigned*>(counters), static_cast<float*>(out), (int)hw, (int)channels,  \
      (int)cp, (int)rows, (int)per_split)
#define HN_GN_STATS(K)                   \
  if (threads <= kMaxThreads) {          \
    HN_GN_STATS_BLOCK(K, kMaxThreads);   \
  } else {                               \
    HN_GN_STATS_BLOCK(K, kWideThreads);  \
  }
  switch (k) {
    case 2: HN_GN_STATS(2); break;
    case 4: HN_GN_STATS(4); break;
    case 8: HN_GN_STATS(8); break;
    case 16: HN_GN_STATS(16); break;
    case 32: HN_GN_STATS(32); break;
    case 64: HN_GN_STATS(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef HN_GN_STATS_BLOCK
#undef HN_GN_STATS
  return cudaGetLastError();
}

}  // namespace

// x [batch, hw, channels] contiguous, 16-byte aligned (dtype 0 = float32,
// 1 = bfloat16); out [batch, 2, groups] float32, channels / groups one of
// 2, 4, 8, 16, 32, 64. The block shape (cp chunk columns x rows pixel rows:
// at most 256 threads, or one row of up to 512 chunks) and the cut of hw
// into `splits` runs of `per_split` pixels come from the wrapper
// (ops/cuda_gn.py: row_plan).
// With splits > 1, partials is [batch, splits, 3, groups] float32 scratch and
// counters holds batch zeros, which the launch leaves zero. Returns the
// launch's cudaError_t.
extern "C" int hn_gn_group_stats(const void* x, void* out, void* partials, void* counters,
                                 int64_t batch, int64_t hw, int64_t channels, int64_t groups,
                                 int64_t cp, int64_t rows, int64_t splits, int64_t per_split,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(x, partials, counters, out, batch, hw, channels, groups, cp, rows,
                              splits, per_split, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(x, partials, counters, out, batch, hw, channels, groups,
                                      cp, rows, splits, per_split, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* hn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
