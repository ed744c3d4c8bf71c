// int8 implicit-GEMM convolution with quantize-on-load — kernel K3.
//
// Replaces the int8 convolution that XLA computes for QuantConv
// (handnet_tpu/nn/quant.py:122-151: quantize the activation, int8 x int8
// conv_general_dilated with int32 accumulation, dequantize, bias). It is not
// a Pallas port: torch has no int8 convolution on CUDA, and the only route
// without a kernel (im2col + torch._int_mm, ops/cuda_int8_conv.py) writes
// and reads a kh*kw times larger operand for every 3x3 conv.
//
// Computes, for an NHWC activation x [B, H, W, C] (float32 or bfloat16) and
// int8 weights wq [O, kh, kw, C] with per-output-channel scales sw [O]:
//   q[b,h,w,c]   = clamp(rn(x / sx[b]), -127, 127)            (int8, 0 in the padding)
//   acc[m, o]    = sum_k q_im2col[m, k] * wq[o, k]              (int32, exact)
//   out[m, o]    = float(acc) * (sx[b] * sw[o]) (+ bias[o])     (float32, then x's dtype)
// with M = B*Ho*Wo output pixels and K = kh*kw*C in (ky, kx, c) order, the
// order of NHWC im2col and of wq's layout. Every step gives the plain
// version's float32 result: the quotient is the correctly rounded x / sx[b]
// (round_to_byte), integers round half to even, and the epilogue multiplies
// and adds with no FMA contraction. So the two agree bit for bit.
//
// What bounds it on the H100: at the pipeline's shapes (M up to 614,400,
// K up to 4,608) the GEMM is far above the card's ops-per-byte line, so the
// tensor cores and the instruction issue bound it. Quantize-on-load runs
// once per activation element per tap and N-tile on the ALUs beside the
// mma.sync stream: a multiply by the row's reciprocal scale, an FMA
// correction to the exact quotient and a rounding by float addition
// (round_to_byte() below).
//
// Design (a simple tiling; wgmma, TMA and a deeper pipeline are later work):
// * Block tile 128 (M) x BN (N, 128 or 64) x 64 (K), 256 threads = 8 warps
//   as 4 (M) x 2 (N); a warp owns 32 x BN/2 of the output and runs
//   mma.sync.m16n8k32 s8.s8.s32 on fragments read from shared memory.
// * C is a multiple of 64, so one 64-wide K tile lies inside one (ky, kx)
//   tap: each tile is a plain channel slice of one input pixel per output
//   row, loaded with 16-byte vector loads, quantized in registers and stored
//   to shared memory as packed int8. Rows outside the image (padding) or
//   past M are int8 zeros, which is what JAX pads the quantized tensor with.
// * Two shared-memory stages and a register prefetch: the global loads of
//   K tile k+1 are issued before the MMAs of tile k and quantized into the
//   other stage after them, so one barrier per K tile suffices and the load
//   latency hides behind the MMAs.
// * Shared-memory rows are 80 bytes (64 + 16 of skew), so the 32-bit
//   fragment loads of a warp fall on 32 different banks.
// * The epilogue dequantizes from the int32 accumulators and writes the
//   output pixel's channel pair as one 8-byte (f32) or 4-byte (bf16) store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kRow = kBK + 16;  // shared-memory row stride in bytes

struct ConvShape {
  int64_t h, w, cin, cout, ho, wo, m, k;
  int kh, kw, sh, sw, ph, pw, dh, dw;
};

// Quantize-on-load, bit-equal to clamp(rn(v / scale), -127, 127) with an
// IEEE division, in six full-rate float ops per element:
//   q0 = rn(v * rcp) with rcp = rn(1 / scale) is within an ulp of v / scale;
//   q  = rn(q0 + rn(v - q0 * scale) * rcp), both steps one FMA, is then the
//        correctly rounded quotient (Markstein's theorem: the residual is
//        exact and the corrected quotient rounds once);
//   y  = clamp(q, -127, 127), and y + 1.5 * 2^23 lands where the float
//        spacing is 1, so the addition rounds y to an integer, ties to even,
//        and the sum's low byte is that integer as int8.
// IEEE division itself is a long sequence with a slow path for v = 0 (half
// of a ReLU output), and F2I/FRND run on a quarter-rate pipe. A quotient
// that overflows to +-inf keeps q0's sign.
constexpr float kRoundMagic = 12582912.0f;  // 1.5 * 2^23

__device__ __forceinline__ uint32_t round_to_byte(float v, float scale, float rcp) {
  const float q0 = __fmul_rn(v, rcp);
  const float q = fabsf(q0) < 1e30f ? __fmaf_rn(__fmaf_rn(-q0, scale, v), rcp, q0) : q0;
  const float y = fminf(fmaxf(q, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, kRoundMagic));  // low byte: the int8
}

// low bytes of four words -> one word, first in the lowest byte
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// One thread's 32 consecutive channels of a K tile, as loaded from global
// memory: held in registers while the previous tile's MMAs run.
template <typename T>
struct RawA;
template <>
struct RawA<float> {
  float4 v[8];
};
template <>
struct RawA<__nv_bfloat16> {
  uint4 v[4];
};

__device__ __forceinline__ void load_raw(const float* __restrict__ p, RawA<float>& r) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r.v[j] = __ldg(reinterpret_cast<const float4*>(p) + j);
}

__device__ __forceinline__ void load_raw(const __nv_bfloat16* __restrict__ p,
                                         RawA<__nv_bfloat16>& r) {
#pragma unroll
  for (int j = 0; j < 4; ++j) r.v[j] = __ldg(reinterpret_cast<const uint4*>(p) + j);
}

__device__ __forceinline__ float raw_value(const RawA<float>& r, int i) {
  const float4 v = r.v[i / 4];
  return i % 4 == 0 ? v.x : i % 4 == 1 ? v.y : i % 4 == 2 ? v.z : v.w;
}

__device__ __forceinline__ float raw_value(const RawA<__nv_bfloat16>& r, int i) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&r.v[i / 8])[i % 8]);
}

// 32 raw values -> 32 int8 packed into 8 words (see round_to_byte).
template <typename T>
__device__ __forceinline__ void quantize32(const RawA<T>& r, float scale, float rcp,
                                           uint32_t (&packed)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    packed[j] = pack_low_bytes(round_to_byte(raw_value(r, 4 * j + 0), scale, rcp),
                               round_to_byte(raw_value(r, 4 * j + 1), scale, rcp),
                               round_to_byte(raw_value(r, 4 * j + 2), scale, rcp),
                               round_to_byte(raw_value(r, 4 * j + 3), scale, rcp));
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  __nv_bfloat162 pair;
  pair.x = __float2bfloat16_rn(v0);
  pair.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = pair;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// grid (ceil(M / 128), O / BN), block kThreads.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ sx, int64_t sx_stride,
                 const float* __restrict__ sw, const float* __restrict__ bias,
                 T* __restrict__ out, ConvShape s) {
  constexpr int kWN = BN / 2;           // warp tile width
  constexpr int kNT = kWN / 8;          // n8 tiles per warp
  constexpr int kBThreadsPerRow = kThreads / BN;
  constexpr int kBBytes = kBK / kBThreadsPerRow;  // 32 (BN=128) or 16 (BN=64)
  // two stages: the MMAs read one while the next K tile is stored to the other
  __shared__ __align__(16) int8_t sa[2][kBM * kRow];
  __shared__ __align__(16) int8_t sb[2][BN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int64_t hw_out = s.ho * s.wo;

  // A tile: thread -> (row, 32-channel half) of the 128 x 64 slice
  const int a_row = tid >> 1;
  const int a_half = tid & 1;
  const int64_t am = m0 + a_row;
  const bool a_valid = am < s.m;
  int64_t ab = 0;
  int iy0 = 0, ix0 = 0;
  float a_scale = 1.f;
  if (a_valid) {
    ab = am / hw_out;
    const int64_t r = am - ab * hw_out;
    const int oy = (int)(r / s.wo);
    const int ox = (int)(r - (int64_t)oy * s.wo);
    iy0 = oy * s.sh - s.ph;
    ix0 = ox * s.sw - s.pw;
    a_scale = sx[ab * sx_stride];
  }
  const float a_rcp = __frcp_rn(a_scale);
  const T* a_base = x + ab * s.h * s.w * s.cin + a_half * 32;
  const int a_dst = a_row * kRow + a_half * 32;

  // B tile: thread -> (row, kBBytes-byte chunk) of the BN x 64 weight slice
  const int b_row = tid / kBThreadsPerRow;
  const int b_off = (tid % kBThreadsPerRow) * kBBytes;
  const int8_t* b_src = wq + (int64_t)(n0 + b_row) * s.k + b_off;
  const int b_dst = b_row * kRow + b_off;

  int acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int cin_tiles = (int)(s.cin / kBK);
  const int k_tiles = (int)(s.k / kBK);
  RawA<T> a_raw;
  bool a_in = false;
  uint4 b_raw[kBBytes / 16];

  // global -> registers for K tile kt (the loads stay in flight)
  auto fetch = [&](int kt) {
    const int tap = kt / cin_tiles;
    const int c0 = (kt - tap * cin_tiles) * kBK;
    const int ky = tap / s.kw;
    const int kx = tap - ky * s.kw;
    const int iy = iy0 + ky * s.dh;
    const int ix = ix0 + kx * s.dw;
    a_in = a_valid && iy >= 0 && iy < s.h && ix >= 0 && ix < s.w;
    if (a_in) load_raw(a_base + ((int64_t)iy * s.w + ix) * s.cin + c0, a_raw);
#pragma unroll
    for (int j = 0; j < kBBytes / 16; ++j) {
      b_raw[j] = __ldg(reinterpret_cast<const uint4*>(b_src + (int64_t)kt * kBK) + j);
    }
  };
  // registers -> shared stage: quantize A (int8 0 outside the image), copy B
  auto stash = [&](int stage) {
    uint32_t packed[8];
    if (a_in) {
      quantize32(a_raw, a_scale, a_rcp, packed);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) packed[j] = 0u;
    }
    uint4* a_out = reinterpret_cast<uint4*>(sa[stage] + a_dst);
    a_out[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    a_out[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
#pragma unroll
    for (int j = 0; j < kBBytes / 16; ++j) {
      reinterpret_cast<uint4*>(sb[stage] + b_dst)[j] = b_raw[j];
    }
  };

  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < k_tiles) fetch(kt + 1);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[2][4];
      uint32_t bf[kNT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* p = sa[stage] + (warp_m * 32 + mt * 16 + g) * kRow + ks * 32 + t * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int8_t* p = sb[stage] + (warp_n * kWN + nt * 8 + g) * kRow + ks * 32 + t * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    // the other stage was last read before the previous barrier
    if (kt + 1 < k_tiles) stash(stage ^ 1);
    __syncthreads();
  }

  // epilogue: dequantize, bias, convert, store (accumulator rows g and g+8,
  // columns 2t and 2t+1 of each m16n8 tile)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + warp_m * 32 + mt * 16 + half * 8 + g;
      if (m >= s.m) continue;
      const float row_scale = sx[(m / hw_out) * sx_stride];
      T* dst = out + m * s.cout;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = n0 + warp_n * kWN + nt * 8 + t * 2;
        float v0 = __fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + 0]),
                             __fmul_rn(row_scale, sw[n]));
        float v1 = __fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + 1]),
                             __fmul_rn(row_scale, sw[n + 1]));
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, bias[n]);
          v1 = __fadd_rn(v1, bias[n + 1]);
        }
        store2(dst + n, v0, v1);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wq, const void* sx, int64_t sx_stride,
                   const void* sw, const void* bias, void* out, const ConvShape& s,
                   cudaStream_t stream) {
  const int bn = s.cout % 128 == 0 ? 128 : 64;
  const dim3 grid((unsigned)((s.m + kBM - 1) / kBM), (unsigned)(s.cout / bn));
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wq);
  const float* sxp = static_cast<const float*>(sx);
  const float* swp = static_cast<const float*>(sw);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  if (bn == 128) {
    int8_conv_kernel<T, 128><<<grid, kThreads, 0, stream>>>(xp, wp, sxp, sx_stride, swp, bp, op, s);
  } else {
    int8_conv_kernel<T, 64><<<grid, kThreads, 0, stream>>>(xp, wp, sxp, sx_stride, swp, bp, op, s);
  }
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, C] (dtype 0 = float32, 1 = bfloat16), wq [O, kh, kw, C] int8,
// sx [B] float32 read with stride sx_stride (0 for one per-layer scale),
// sw [O] float32, bias [O] float32 or null, out [B, Ho, Wo, O] in x's dtype.
// C and O must be multiples of 64. Returns the launch's cudaError_t.
extern "C" int hn_int8_conv(const void* x, const void* wq, const void* sx, int64_t sx_stride,
                            const void* sw, const void* bias, void* out, int64_t batch,
                            int64_t h, int64_t w, int64_t cin, int64_t cout, int64_t ho,
                            int64_t wo, int64_t kh, int64_t kw, int64_t sh, int64_t sw_,
                            int64_t ph, int64_t pw, int64_t dh, int64_t dw, int dtype,
                            void* stream) {
  if (cin % kBK != 0 || cout % 64 != 0 || batch <= 0 || ho <= 0 || wo <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  ConvShape s;
  s.h = h; s.w = w; s.cin = cin; s.cout = cout; s.ho = ho; s.wo = wo;
  s.m = batch * ho * wo;
  s.k = kh * kw * cin;
  s.kh = (int)kh; s.kw = (int)kw; s.sh = (int)sh; s.sw = (int)sw_;
  s.ph = (int)ph; s.pw = (int)pw; s.dh = (int)dh; s.dw = (int)dw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, wq, sx, sx_stride, sw, bias, out, s, st);
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(x, wq, sx, sx_stride, sw, bias, out, s, st);
  }
  return (int)cudaErrorInvalidValue;
}
