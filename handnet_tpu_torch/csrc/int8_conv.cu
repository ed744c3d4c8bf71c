// int8 implicit-GEMM convolution on quantized activations — kernel K3g, the
// second half of the int8 conv (K3q, int8_quantize.cu, is the first).
//
// Replaces the int8 convolution that XLA computes for QuantConv
// (handnet_tpu/nn/quant.py:122-151: int8 x int8 conv_general_dilated with
// int32 accumulation, dequantize, bias). It is not a Pallas port: torch has
// no int8 convolution on CUDA, and the only route without a kernel (im2col +
// torch._int_mm, ops/cuda_int8_conv.py) writes and reads a kh*kw times
// larger operand for every 3x3 conv.
//
// Computes, for int8 NHWC q [B, H, W, C] (0 in the padding) and int8 weights
// wq [O, kh, kw, C] with per-output-channel scales sw [O]:
//   acc[m, o] = sum_k q_im2col[m, k] * wq[o, k]              (int32, exact)
//   out[m, o] = float(acc) * (sx[b] * sw[o]) (+ bias[o])     (float32, then the output dtype)
// with M = B*Ho*Wo output pixels in NHWC order and K = kh*kw*C in (ky, kx, c)
// order, the order of NHWC im2col and of wq's layout. Integer sums are exact
// in any order and the epilogue multiplies and adds with no FMA contraction,
// so the result is bit-equal to the plain version whatever the tiling.
//
// What bounds it on the H100: tensor-core operations. At the pipeline's
// shapes (M up to 2,457,600, K up to 4,608) the GEMM is far above the card's
// operations-per-byte line, and only wgmma reaches the int8 rate. So the
// design keeps every other instruction off the warps that multiply:
// * wgmma.mma_async m64nBNk32 s32.s8.s8 with both operands read from shared
//   memory. int8 needs both K-major, and they are: a pixel's channels are
//   contiguous in NHWC q, and wq is [O, K].
// * TMA fills shared memory, one elected thread issuing. The weights are a
//   plain 2-D map [O, K]. The activations use TMA's im2col mode over
//   q [B, H, W, C] rather than a tiled 4-D map: an A tile is then 128
//   consecutive output pixels in NHWC order, running on across row ends and
//   images, so the small maps (11x11, 22x22, 15x20) fill their tiles, the
//   rows of a tile are 128 consecutive rows of the output, and one map
//   serves every class: the traversal strides are the conv's stride, the
//   per-tap im2col offsets its dilation, the bounding box its padding, and
//   the hardware's out-of-bounds fill writes the int8 zeros of the padding
//   and of the rows past M. C is a multiple of BK, so a K tile is the
//   channels c0..c0+BK of one tap (ky, kx).
// * The tiles land in the 128-byte (BK = 128, when C % 128 == 0) or 64-byte
//   (BK = 64) swizzle, which the wgmma matrix descriptors name too; a stage
//   is 1,024-byte aligned.
// * A ring of 4 to 6 stages with a full and an empty mbarrier per stage:
//   warpgroup 0 is the producer (setmaxnreg down to 40 registers), warpgroups
//   1 and 2 the consumers (up to 232), each owning 64 rows x BN columns of
//   the 128 x BN tile in BN/2 accumulator registers a thread. A stage is
//   released one K tile late (wgmma.wait_group 1), so the next wgmma group
//   is issued before the previous one is waited for. No block-wide barrier
//   after the set-up.
// * One persistent block per SM walks over the output tiles (N tiles of one
//   M tile side by side, so that they share the activations in L2); the
//   producer runs ahead into the next tile while the consumers dequantize
//   and store the last one.
// * BN = 256, 128 or 64, the largest that divides O.
// * The epilogue passes each warp's 16 rows through a patch of shared memory,
//   so that the output leaves as whole 128-byte lines.
// Every mbarrier wait is bounded: a barrier that never completes traps
// instead of hanging the card.
//
// The bounding box and the tile and tap arithmetic below (tile_start, the
// tap offsets) are transcribed in ops/cuda_int8_conv.py (im2col_geometry,
// tile_start, tma_im2col_gather), where a CPU test holds them against the
// plain im2col: the two must change together.

#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is reached through dlsym
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma_s8.cuh"

namespace {

constexpr int kBM = 128;                // output pixels per tile
constexpr int kConsumers = 2;           // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr uint32_t kSpinLimit = 1u << 26;  // mbarrier polls before a wait traps
constexpr int kEncodeFailed = 10000;    // entry-point return codes from here up: CUresult + this

template <int BN, int BK>
struct Tile {
  static constexpr int kABytes = kBM * BK;
  static constexpr int kBBytes = BN * BK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = 6 * kStageBytes <= 200 * 1024 ? 6 : 4;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // slack to align the ring
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0, "stages must stay 1,024-byte aligned");
};

struct ConvShape {
  int m;                 // B * Ho * Wo
  int hw_out, wo;        // Ho * Wo, Wo
  int cout;
  int taps, kw;          // kh * kw, kw
  int cin_tiles;         // C / BK: K tiles per tap
  int sh, sw, dh, dw;    // stride, dilation
  int lower_h, lower_w;  // bounding box's lower corner: -padding
  int m_tiles, n_tiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > kSpinLimit) __trap();
  }
}

// BK channels from c0 of the 128 pixels that follow base pixel (w, h, n) in
// the map's bounding box, each read at (w + off_w, h + off_h).
__device__ __forceinline__ void tma_load_im2col(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                                int c0, int w, int h, int n, uint16_t off_w,
                                                uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(w), "r"(h), "r"(n), "h"(off_w),
      "h"(off_h)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are BK bytes,
// as TMA wrote it with the BK-byte swizzle: 8-row groups are 8 * BK bytes
// apart (the stride offset); the leading offset is unused for a swizzled
// K-major operand. A K step of 32 bytes inside the swizzle span advances the
// start address.
template <int BK>
__device__ __forceinline__ uint64_t smem_descriptor(uint32_t addr) {
  constexpr uint64_t kLayout = BK == 128 ? 1 : 2;  // 128-byte, 64-byte swizzle
  constexpr uint64_t kStride = (8 * BK) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (kStride << 32) | (kLayout << 62);
}

// Two dequantized neighbours as they lie in the output row.
__device__ __forceinline__ float2 pack2(float v0, float v1, float) { return make_float2(v0, v1); }

__device__ __forceinline__ uint32_t pack2(float v0, float v1, __nv_bfloat16) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// Dequantize one consumer warp's 16 x BN accumulators and store them. In
// wgmma's layout thread t holds rows lane / 4 and + 8, columns
// 8j + 2 * (lane % 4) and + 1 (wgmma_s8.cuh): stored from there, a warp's
// store would touch 8 rows with 16 bytes each, half a sector at a time. So
// the warp passes each 128-byte slice of its 16 rows through its own patch of
// shared memory (rows padded to kPatchRow bytes against bank conflicts) and
// writes it out as whole 128-byte lines, 16 bytes a thread. Only the warp
// itself touches the patch: __syncwarp orders it. sx is read per row: a tile
// may span images.
constexpr int kPatchRow = 128 + 16;
constexpr int kPatchBytes = 16 * kPatchRow;  // one warp's patch

template <typename T, int BN>
__device__ __forceinline__ void epilogue(const int (&acc)[BN / 2], int row0, int n0,
                                         uint8_t* __restrict__ patch,
                                         const float* __restrict__ sx, int64_t sx_stride,
                                         const float* __restrict__ sw,
                                         const float* __restrict__ bias, T* __restrict__ out,
                                         const ConvShape& s) {
  constexpr int kSliceCols = 128 / (int)sizeof(T);  // columns in 128 bytes of a row
  constexpr int kSliceJ = kSliceCols / 8;           // n8 blocks of the accumulators
  using Pair = decltype(pack2(0.f, 0.f, T()));
  const int lane = threadIdx.x & 31;
  const int quad_row = lane >> 2;
  const int quad_col = (lane & 3) * 2;
  float row_scale[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = row0 + quad_row + half * 8;
    row_scale[half] = m < s.m ? __ldg(sx + (int64_t)(m / s.hw_out) * sx_stride) : 0.f;
  }
#pragma unroll
  for (int slice = 0; slice < BN / kSliceCols; ++slice) {
#pragma unroll
    for (int jj = 0; jj < kSliceJ; ++jj) {
      const int j = slice * kSliceJ + jj;
      const int n = n0 + 8 * j + quad_col;
      const float w0 = __ldg(sw + n), w1 = __ldg(sw + n + 1);
      float b0 = 0.f, b1 = 0.f;
      if (bias != nullptr) {
        b0 = __ldg(bias + n);
        b1 = __ldg(bias + n + 1);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 0]),
                             __fmul_rn(row_scale[half], w0));
        float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + 1]),
                             __fmul_rn(row_scale[half], w1));
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        *reinterpret_cast<Pair*>(patch + (quad_row + half * 8) * kPatchRow +
                                 (8 * jj + quad_col) * sizeof(T)) = pack2(v0, v1, T());
      }
    }
    __syncwarp();
    // 4 rows x 128 bytes per step: lanes 0-7 one row, 8-15 the next, ...
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int row = step * 4 + (lane >> 3);
      const int byte = (lane & 7) * 16;
      const int m = row0 + row;
      if (m < s.m) {
        const uint4 v = *reinterpret_cast<const uint4*>(patch + row * kPatchRow + byte);
        uint8_t* dst = reinterpret_cast<uint8_t*>(out + (int64_t)m * s.cout + n0) +
                       slice * 128 + byte;
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
    __syncwarp();
  }
}

// grid min(tiles, SMs), block kThreads, Tile<BN, BK>::kSmemBytes of dynamic
// shared memory.
template <typename T, int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, const float* __restrict__ sx,
                      int64_t sx_stride, const float* __restrict__ sw,
                      const float* __restrict__ bias, T* __restrict__ out, const ConvShape s) {
  using Cfg = Tile<BN, BK>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(16) uint8_t patches[kConsumerWarps * kPatchBytes];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = smem_u32(full_bar);
  const uint32_t empty0 = smem_u32(empty_bar);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, 1);                // the producer's expect_tx
      mbar_init(empty0 + 8 * i, kConsumerWarps);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x >> 7;
  const int k_tiles = s.taps * s.cin_tiles;
  const int tiles = s.m_tiles * s.n_tiles;

  if (warpgroup == 0) {
    // producer: one thread keeps the ring full, across tile boundaries
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / s.n_tiles) * kBM;
        const int n0 = (tile % s.n_tiles) * BN;
        // tile_start: the first output pixel's base pixel in the bounding box
        const int img = m0 / s.hw_out;
        const int rest = m0 - img * s.hw_out;
        const int oy = rest / s.wo;
        const int ox = rest - oy * s.wo;
        const int w = s.lower_w + ox * s.sw;
        const int h = s.lower_h + oy * s.sh;
        for (int tap = 0; tap < s.taps; ++tap) {
          const int ky = tap / s.kw;
          const int kx = tap - ky * s.kw;
          const uint16_t off_w = (uint16_t)(kx * s.dw);
          const uint16_t off_h = (uint16_t)(ky * s.dh);
          for (int ct = 0; ct < s.cin_tiles; ++ct) {
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            const uint32_t full = full0 + 8 * stage;
            const uint32_t a_dst = ring + stage * Cfg::kStageBytes;
            mbar_expect_tx(full, Cfg::kStageBytes);
            tma_load_im2col(a_dst, &map_a, full, ct * BK, w, h, img, off_w, off_h);
            tma_load_2d(a_dst + Cfg::kABytes, &map_b, full, (tap * s.cin_tiles + ct) * BK, n0);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // consumers: wgmma on the stages that have arrived, then the epilogue
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int consumer = warpgroup - 1;
    const bool releaser = (threadIdx.x & 31) == 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / s.n_tiles) * kBM;
      const int n0 = (tile % s.n_tiles) * BN;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev_stage = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a_src = ring + stage * Cfg::kStageBytes + consumer * 64 * BK;
        const uint32_t b_src = ring + stage * Cfg::kStageBytes + Cfg::kABytes;
        const uint64_t desc_a = smem_descriptor<BK>(a_src);
        const uint64_t desc_b = smem_descriptor<BK>(b_src);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
          // 32 bytes along K = 2 units of the descriptor's 16-byte address
          WgmmaS8<BN>::mma(acc, desc_a + 2 * ks, desc_b + 2 * ks, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (kt > 0) {
          // the group before this one has read its stage: hand it back
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (releaser) mbar_arrive(empty0 + 8 * prev_stage);
        }
        prev_stage = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (releaser) mbar_arrive(empty0 + 8 * prev_stage);
      const int warp = (threadIdx.x >> 5) - 4;  // among the consumer warps
      epilogue<T, BN>(acc, m0 + warp * 16, n0, patches + warp * kPatchBytes, sx, sx_stride, sw,
                      bias, out, s);
    }
  }
}

// --- host side -------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2colFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                    cuuint32_t, cuuint32_t, const cuuint32_t*,
                                    CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

struct Encoders {
  EncodeTiledFn tiled = nullptr;
  EncodeIm2colFn im2col = nullptr;
};

// The two tensor-map encoders of libcuda, looked up once in the copy that
// the CUDA runtime has already loaded (nothing links against libcuda).
const Encoders& encoders() {
  static const Encoders d = [] {
    Encoders r;
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) {
      r.tiled = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
      r.im2col = reinterpret_cast<EncodeIm2colFn>(dlsym(lib, "cuTensorMapEncodeIm2col"));
    }
    return r;
  }();
  return d;
}

struct ConvArgs {
  const void* q;
  const void* wq;
  int64_t batch, h, w, cin, cout, ho, wo;
  int kh, kw, sh, sw, dh, dw;
  int lower_h, lower_w, upper_h, upper_w;
};

int tile_n(int64_t cout) { return cout % 256 == 0 ? 256 : cout % 128 == 0 ? 128 : 64; }
int tile_k(int64_t cin) { return cin % 128 == 0 ? 128 : 64; }

bool valid(const ConvArgs& a) {
  return a.cin % 64 == 0 && a.cout % 64 == 0 && a.batch > 0 && a.ho > 0 && a.wo > 0 &&
         a.batch * a.ho * a.wo + kBM < INT32_MAX;
}

// The activations' im2col map and the weights' tiled map for one launch.
// Returns 0, or kEncodeFailed + the encoder's CUresult.
int encode_maps(const ConvArgs& a, CUtensorMap* map_a, CUtensorMap* map_b) {
  const Encoders& enc = encoders();
  if (enc.tiled == nullptr || enc.im2col == nullptr) return kEncodeFailed + (int)CUDA_ERROR_NOT_FOUND;
  const int bn = tile_n(a.cout), bk = tile_k(a.cin);
  const CUtensorMapSwizzle swizzle = bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  {
    // q [B, H, W, C] int8, innermost first; the bounding box of the base pixels
    // is [lower, size - 1 + upper] in W and H, traversed with the conv's stride
    const cuuint64_t dims[4] = {(cuuint64_t)a.cin, (cuuint64_t)a.w, (cuuint64_t)a.h,
                                (cuuint64_t)a.batch};
    const cuuint64_t strides[3] = {(cuuint64_t)a.cin, (cuuint64_t)(a.w * a.cin),
                                   (cuuint64_t)(a.h * a.w * a.cin)};
    const int lower[2] = {a.lower_w, a.lower_h};
    const int upper[2] = {a.upper_w, a.upper_h};
    const cuuint32_t traversal[4] = {1, (cuuint32_t)a.sw, (cuuint32_t)a.sh, 1};
    const CUresult r = enc.im2col(map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(a.q),
                                  dims, strides, lower, upper, (cuuint32_t)bk, (cuuint32_t)kBM,
                                  traversal, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  }
  {
    const cuuint64_t k = (cuuint64_t)(a.kh * a.kw * a.cin);
    const cuuint64_t dims[2] = {k, (cuuint64_t)a.cout};
    const cuuint64_t strides[1] = {k};
    const cuuint32_t box[2] = {(cuuint32_t)bk, (cuuint32_t)bn};
    const cuuint32_t ones[2] = {1, 1};
    const CUresult r = enc.tiled(map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(a.wq),
                                 dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  }
  return 0;
}

template <typename T, int BN, int BK>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const void* sx,
                   int64_t sx_stride, const void* sw, const void* bias, void* out,
                   const ConvShape& s, int sms, cudaStream_t stream) {
  auto kernel = int8_conv_gemm_kernel<T, BN, BK>;
  constexpr int kSmem = Tile<BN, BK>::kSmemBytes;
  // above 48 KB the kernel must be told; the attribute is per device, so it
  // is set at every launch and not cached
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = s.m_tiles * s.n_tiles;
  kernel<<<tiles < sms ? tiles : sms, kThreads, kSmem, stream>>>(
      map_a, map_b, static_cast<const float*>(sx), sx_stride, static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<T*>(out), s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tiled(int bn, int bk, const CUtensorMap& map_a, const CUtensorMap& map_b,
                         const void* sx, int64_t sx_stride, const void* sw, const void* bias,
                         void* out, const ConvShape& s, int sms, cudaStream_t stream) {
#define HN_LAUNCH(BN, BK)                                                                      \
  if (bn == BN && bk == BK)                                                                    \
    return launch<T, BN, BK>(map_a, map_b, sx, sx_stride, sw, bias, out, s, sms, stream);
  HN_LAUNCH(256, 128)
  HN_LAUNCH(128, 128)
  HN_LAUNCH(64, 128)
  HN_LAUNCH(256, 64)
  HN_LAUNCH(128, 64)
  HN_LAUNCH(64, 64)
#undef HN_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, W, C] int8 and wq [O, kh, kw, C] int8, both 16-byte aligned; sx
// float32 read with stride sx_stride (0 for one per-layer scale); sw [O]
// float32; bias [O] float32 or null; out [B, Ho, Wo, O] (dtype 0 = float32,
// 1 = bfloat16), 16-byte aligned. C and O must be multiples of 64. lower and upper are the
// corners of the im2col bounding box (ops/cuda_int8_conv.py,
// im2col_geometry). Returns the launch's cudaError_t, or 10000 + the
// CUresult of a failed tensor-map encoding.
extern "C" int hn_int8_conv_gemm(const void* q, const void* wq, const void* sx, int64_t sx_stride,
                                 const void* sw, const void* bias, void* out, int64_t batch,
                                 int64_t h, int64_t w, int64_t cin, int64_t cout, int64_t ho,
                                 int64_t wo, int64_t kh, int64_t kw, int64_t sh, int64_t sw_,
                                 int64_t dh, int64_t dw, int64_t lower_h, int64_t lower_w,
                                 int64_t upper_h, int64_t upper_w, int dtype, void* stream) {
  const ConvArgs a = {q, wq, batch, h, w, cin, cout, ho, wo, (int)kh, (int)kw, (int)sh, (int)sw_,
                      (int)dh, (int)dw, (int)lower_h, (int)lower_w, (int)upper_h, (int)upper_w};
  if (!valid(a) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  const int encoded = encode_maps(a, &map_a, &map_b);
  if (encoded != 0) return encoded;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int bn = tile_n(cout), bk = tile_k(cin);
  ConvShape s;
  s.m = (int)(batch * ho * wo);
  s.hw_out = (int)(ho * wo);
  s.wo = (int)wo;
  s.cout = (int)cout;
  s.taps = a.kh * a.kw;
  s.kw = a.kw;
  s.cin_tiles = (int)(cin / bk);
  s.sh = a.sh; s.sw = a.sw; s.dh = a.dh; s.dw = a.dw;
  s.lower_h = a.lower_h; s.lower_w = a.lower_w;
  s.m_tiles = (s.m + kBM - 1) / kBM;
  s.n_tiles = (int)(cout / bn);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_tiled<float>(bn, bk, map_a, map_b, sx, sx_stride, sw, bias, out, s, sms, st);
  }
  return (int)launch_tiled<__nv_bfloat16>(bn, bk, map_a, map_b, sx, sx_stride, sw, bias, out, s,
                                          sms, st);
}

// Encodes the two tensor maps of one launch and drops them: the host cost
// that every hn_int8_conv_gemm call pays before its launch, for timing.
extern "C" int hn_int8_conv_encode_maps(const void* q, const void* wq, int64_t batch, int64_t h,
                                        int64_t w, int64_t cin, int64_t cout, int64_t kh,
                                        int64_t kw, int64_t sh, int64_t sw_, int64_t lower_h,
                                        int64_t lower_w, int64_t upper_h, int64_t upper_w) {
  const ConvArgs a = {q, wq, batch, h, w, cin, cout, 1, 1, (int)kh, (int)kw, (int)sh, (int)sw_,
                      1, 1, (int)lower_h, (int)lower_w, (int)upper_h, (int)upper_w};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  return encode_maps(a, &map_a, &map_b);
}
