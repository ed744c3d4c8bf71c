// Fused A2J anchor decode — kernel K1.
//
// Replaces the TPU kernel `_decode_kernel`, launched by `a2j_decode_pallas`
// (handnet_tpu/ops/pallas_a2j.py:26-75, pallas_call at :55).
//
// Computes, for each image b and joint p, a max-subtracted softmax over the
// N anchor logits cls[b, :, p] and the softmax-weighted means of
// anchor_u + reg[b, n, p, 0], anchor_v + reg[b, n, p, 1] and depth[b, n, p]:
// out [B, P, 3] float32 (u, v, d), accumulated in float32.
//
// What bounds it on the H100: bytes. At the fast profile (N = 11*11*16 =
// 1936, P = 21, B = 128, bf16 heads) it reads ~42 MB once and does a few
// flops and one exp per element.
//
// Design:
// * The TPU kernel keeps one image's four [N, P] float32 blocks resident in
//   VMEM (~650 KB), nearly three times the 227 KB of shared memory a Hopper
//   block can have. Here nothing is staged: each thread runs a single-pass
//   online softmax in registers, keeping a running max and rescaling its
//   four accumulators when the max moves (as flash attention does), so every
//   input element is read exactly once.
// * One block per image, R*P threads: thread t owns joint p = t % P and
//   anchors n = t / P, t / P + R, ... Consecutive threads then read
//   consecutive (n, p) elements of the P-innermost layout: coalesced.
// * reg [B, N, P, 2] is read in place through its strides (the JAX wrapper
//   copies the two channels into separate arrays first; this does not).
// * The R partials of each joint meet in shared memory and one thread per
//   joint combines them with the same max-rescaling rule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Strides3 { int64_t b, n, p; };
struct Strides4 { int64_t b, n, p, c; };

// Fold partial (mb, sb, ub, vb, db) into (m, s, u, v, d): sums of exp(x - m).
__device__ __forceinline__ void softmax_combine(float& m, float& s, float& u,
                                                float& v, float& d, float mb,
                                                float sb, float ub, float vb,
                                                float db) {
  if (mb == -INFINITY) return;
  if (m == -INFINITY) {
    m = mb; s = sb; u = ub; v = vb; d = db;
    return;
  }
  const float mx = fmaxf(m, mb);
  const float ca = expf(m - mx);
  const float cb = expf(mb - mx);
  s = s * ca + sb * cb;
  u = u * ca + ub * cb;
  v = v * ca + vb * cb;
  d = d * ca + db * cb;
  m = mx;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
a2j_decode_kernel(const T* __restrict__ cls, const T* __restrict__ reg,
                  const T* __restrict__ depth, const float* __restrict__ anchors,
                  float* __restrict__ out, int n_anchors, int n_joints, int rows,
                  Strides3 cs, Strides4 rs, Strides3 ds) {
  extern __shared__ float smem[];  // 5 arrays of blockDim.x partials
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int p = t % n_joints;
  const int r = t / n_joints;

  const T* cls_b = cls + b * cs.b + p * cs.p;
  const T* reg_b = reg + b * rs.b + p * rs.p;
  const T* dep_b = depth + b * ds.b + p * ds.p;

  float m = -INFINITY, s = 0.f, su = 0.f, sv = 0.f, sd = 0.f;
  for (int n = r; n < n_anchors; n += rows) {
    const float x = to_float(cls_b[n * cs.n]);
    const float pu = anchors[2 * n] + to_float(reg_b[n * rs.n]);
    const float pv = anchors[2 * n + 1] + to_float(reg_b[n * rs.n + rs.c]);
    const float pd = to_float(dep_b[n * ds.n]);
    if (x > m) {  // the max moved: rescale what was summed so far
      const float c = expf(m - x);  // expf(-inf) = 0 on the first element
      s *= c; su *= c; sv *= c; sd *= c;
      m = x;
    }
    const float w = expf(x - m);
    s += w;
    su += w * pu;
    sv += w * pv;
    sd += w * pd;
  }

  const int nt = blockDim.x;
  smem[t] = m;
  smem[nt + t] = s;
  smem[2 * nt + t] = su;
  smem[3 * nt + t] = sv;
  smem[4 * nt + t] = sd;
  __syncthreads();
  if (r == 0) {
    for (int rr = 1; rr < rows; ++rr) {
      const int q = rr * n_joints + p;
      softmax_combine(m, s, su, sv, sd, smem[q], smem[nt + q], smem[2 * nt + q],
                      smem[3 * nt + q], smem[4 * nt + q]);
    }
    const float inv = 1.f / s;
    float* o = out + ((int64_t)b * n_joints + p) * 3;
    o[0] = su * inv;
    o[1] = sv * inv;
    o[2] = sd * inv;
  }
}

template <typename T>
cudaError_t launch(const void* cls, const void* reg, const void* depth,
                   const void* anchors, void* out, int64_t batch, int64_t n,
                   int64_t p, Strides3 cs, Strides4 rs, Strides3 ds,
                   cudaStream_t stream) {
  if (p < 1 || p > kMaxThreads || n < 1) return cudaErrorInvalidValue;
  int rows = (int)(kMaxThreads / p);
  if (rows > n) rows = (int)n;
  const int threads = rows * (int)p;
  const size_t shmem = 5 * (size_t)threads * sizeof(float);
  a2j_decode_kernel<T><<<(unsigned)batch, threads, shmem, stream>>>(
      static_cast<const T*>(cls), static_cast<const T*>(reg),
      static_cast<const T*>(depth), static_cast<const float*>(anchors),
      static_cast<float*>(out), (int)n, (int)p, rows, cs, rs, ds);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (cls, reg and depth share it); anchors
// are float32 [N, 2] contiguous; strides are in elements. Returns the
// launch's cudaError_t.
extern "C" int hn_a2j_decode(const void* cls, const void* reg, const void* depth,
                             const void* anchors, void* out, int64_t batch,
                             int64_t n, int64_t p, int64_t cls_sb,
                             int64_t cls_sn, int64_t cls_sp, int64_t reg_sb,
                             int64_t reg_sn, int64_t reg_sp, int64_t reg_sc,
                             int64_t dep_sb, int64_t dep_sn, int64_t dep_sp,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides3 cs{cls_sb, cls_sn, cls_sp};
  const Strides4 rs{reg_sb, reg_sn, reg_sp, reg_sc};
  const Strides3 ds{dep_sb, dep_sn, dep_sp};
  if (dtype == 0)
    return (int)launch<float>(cls, reg, depth, anchors, out, batch, n, p, cs, rs, ds, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(cls, reg, depth, anchors, out, batch, n, p, cs, rs, ds, s);
  return (int)cudaErrorInvalidValue;
}
