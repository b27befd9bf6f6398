// Kernel K2's Hopper design (sm_90a): the int8 depthwise 3x3 of the
// post-training-quantized backbone, the "tma" route of xdt::int8_dwconv and
// the only route of xdt::int8_dwconv_q.
//
// Replaces: the int8 lax.conv_general_dilated with feature_group_count = C
// of QuantConv's "int8" mode, x_detector_tpu/models/layers.py:180-185 (XLA's
// op, not a Pallas kernel), and, on the separable blocks, the quantize of
// the pointwise conv that follows it (:167-170). It computes what
// int8_conv.cu's first design ("simt" route) computes:
//   out[b, ho, wo, c] = OutT(float(acc) * scale[c]),
//   acc = the exact int32 sum over the 9 taps (i, j) of
//         xq[b, ho*s - pt + i*d, wo*s - pl + j*d, c] * w[c, i, j]
// (zero outside the map), OutT bf16 or fp32 ("dequant" mode); or, in the
// "quantize on store" mode, that value rounded to the module dtype (bf16 or
// fp32) and quantized at the next conv's scale sx_out as K3 does it:
//   out = int8(clamp(rint(v / sx_out), -127, 127)), rint half to even.
// The sums are exact in any order (|acc| <= 9 * 128 * 128 < 2^22), and
// every rounding is the plain version's: float(acc) is exact (the magic
// number form below is the same value as __int2float_rn), then one
// __fmul_rn, one rounding to bf16 or fp32, then the quantize, whose
// division-free form (quantize_fast) gives __fdiv_rn and __float2int_rn's
// bits, shown on the card; no FMA contraction, no fast-math. So the kernel
// equals its plain version (ops/int8_conv.py) bit for bit in both modes.
//
// What bounds it on an H100: the bytes (the int8 map in once, the output
// out once); the 9 multiply-adds an output are 1/10 of that at the CUDA
// cores' rate, but only if they take few instructions. Measured
// (int8_dwconv_variants.py): dequantizing, its stores bind it (75% of the
// bytes bound at config 3); quantizing, the quantize's arithmetic on each
// value does (43% of a bound that counts 1 byte an output). The first
// design ran one thread an output pixel and 16 channels: 9 global loads of
// 16 bytes relied on L1 for the 9-fold reuse, every tap's weights were
// loaded again by every thread, and each tap sign-extended 16 bytes one by
// one into 16 scalar IMADs (about 20 integer instructions an output), with
// 32-bit divisions in the index decode and 4-byte stores. This design:
//   - Work unit: a tile of TH x TW output pixels of one image times CB =
//     128 channels. One TMA load brings its input halo box, ((TH-1)*s + 2d
//     + 1) x ((TW-1)*s + 2d + 1) x 128 int8, from a 4D tensor map over [B,
//     H, W, C]; the map's zero fill of out-of-bounds coordinates (negative
//     ones too) is the padding, and channels past C read as zero.
//   - A persistent grid of one wave; a producer warp keeps the next units'
//     boxes in flight in a ring of 2-4 stages (full and empty mbarriers)
//     while the 4-14 consumer warps compute the current one.
//   - A lane owns one 32-bit word of 4 channels (a warp's 32 lanes are the
//     unit's 128 channels, so every shared-memory access of a warp is 128
//     contiguous bytes: no bank conflict) and a run of RH output rows x 4
//     output columns. Each input word of the run's rows is read from shared
//     memory once, and the 4 x 4 block of (4 columns x 4 channels) is
//     transposed with 8 __byte_perm into 4 words of 4 columns of one
//     channel; the run's input rows stay in registers while the outputs
//     that read them are computed, so a row is read once for the run (s =
//     1: RH + 2d rows for RH output rows).
//   - Products: an output's 3 taps of a row are 3 bytes of those words
//     (one __byte_perm, or none where they start a word), and one __dp4a
//     multiplies them by the row's taps (w_i0, w_i1, w_i2, 0), signed: 3
//     dp4a an output and channel, against 9 IMADs and 9 sign extensions.
//     The 9 taps of the lane's 4 channels sit in 12 registers for the unit,
//     laid out so by the host once (ops/int8_conv.py::prepare_weight).
//   - Stride 1 and 2 and dilation 1 and 2 are template cases (RH = 8 / s):
//     every config 3 call takes this route; other strides and dilations
//     take the first design (the host's plan, ops/int8_conv.py).
//   - Epilogue: a warp stages its run's outputs (RH x 4 pixels x 128
//     channels) in shared memory, one contiguous 128 x (4 bytes x the
//     output's size) row of lanes at a time, and one lane stores the run
//     with a TMA store (a 4D map over [B, Ho, Wo, C], which clips the
//     edges) while the warp goes on.
// No atomics: every output has one owner.

#include <cuda_bf16.h>
#include <limits.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int CB = 128;            // channels a unit: 32 lanes x 4
constexpr int QUAD = 4;            // output columns a lane's run
constexpr int MAX_WARPS = 14;      // consumer warps a block
constexpr int MAX_STAGES = 4;      // ring stages at most
constexpr int BOX_SLACK = 512;     // bytes past a box that a run may read
constexpr int BAR_BYTES = 1024;    // mbarriers
constexpr int SMEM_LIMIT = 232448;
constexpr int THREADS_MAX = 32 * (MAX_WARPS + 1);

// output modes: dequant to bf16 or fp32; quantize on store from a bf16 or
// an fp32 module dtype
constexpr int OUT_BF16 = 0, OUT_F32 = 1, OUT_S8_BF16 = 2, OUT_S8_F32 = 3;

struct Params {
  const int8_t* w;       // [C][3][4]: channel c's tap row i at 12c + 4i
  const float* scale;    // [C]
  const float* sx_out;   // one fp32 on the device (quantize modes)
  int C, Ho, Wo, pt, pl;
  int qw, rr;            // a tile's runs across and down: qw * rr warps
  int th, tw;            // the tile: rr * RH rows, qw * 4 columns
  int tiles_h, tiles_w, cblocks, units;
  int bw;                // the box's columns
  int box_bytes, stage_bytes, stages, staging_bytes;
};

struct Unit {
  int b, oy0, ox0, c0;
};

// Unit u, channel blocks fastest, then tile columns, rows and images.
__device__ __forceinline__ Unit unit_of(const Params& p, int u) {
  Unit U;
  U.c0 = (u % p.cblocks) * CB;
  u /= p.cblocks;
  U.ox0 = (u % p.tiles_w) * p.tw;
  u /= p.tiles_w;
  U.oy0 = (u % p.tiles_h) * p.th;
  U.b = u / p.tiles_h;
  return U;
}

template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// The first output row (of a run's RH) that reads input row R of the run,
// or RH where none does (s = 2, d = 2 reads only even rows).
template <int S, int D, int RH>
__host__ __device__ constexpr int first_use(int R) {
  for (int r = 0; r < RH; ++r)
    for (int i = 0; i < 3; ++i)
      if (r * S + i * D == R) return r;
  return RH;
}

// float(acc), exact for |acc| < 2^22: the same value as __int2float_rn,
// without the conversion unit (a quarter of the integer rate)
__device__ __forceinline__ float exact_float(int acc) {
  return __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.0f);
}

// K3's arithmetic: clamp(rint(v / sx), -127, 127), IEEE division, rint
// half to even; NaN gives 0 (cvt.rni's NaN)
__device__ __forceinline__ int quantize1(float v, float sx) {
  const int q = __float2int_rn(__fdiv_rn(v, sx));
  return min(max(q, -127), 127);
}

// The quantize's fast form takes |sx| in [2^-40, 2^40] and |v| <= 2^78
// (a lane's channels with |scale| <= 2^60: |v| <= 147456 |scale|): there
// r = 1 / sx is normal, v r finite and the remainder below exact wherever
// the quotient can round to anything but 0 or +-127. Elsewhere (NaN or
// huge scales) the lane takes quantize1.
constexpr float FAST_SX_MIN = 0x1p-40f;
constexpr float FAST_SX_MAX = 0x1p40f;
constexpr float FAST_SCALE_MAX = 0x1p60f;
constexpr float FAST_V_MAX = 0x1p78f;

__device__ __forceinline__ bool fast_scale(float sx) {
  const float a = fabsf(sx);
  return a >= FAST_SX_MIN && a <= FAST_SX_MAX;
}

// quantize1 without its division and conversion (a MUFU.RCP, a slow-path
// check and a conversion at a quarter of the FMA rate, an output), for
// finite |v| <= 2^78 and fast_scale(sx): r = __frcp_rn(sx), once; q0 = v r
// is within an ulp of v / sx, the remainder v - q0 sx is exact by fma, and
// q0 + rem r rounded once is v / sx correctly rounded (Markstein's
// theorem: r within half an ulp of 1 / sx). Clamping to +-127 before
// rounding gives the clamp after it (127 is an integer), and rint of |y|
// <= 127 is the magic number's round-half-even add, whose low byte is the
// int8 (0x4B400000's is 0). Held bitwise to quantize1 on the card over
// every bf16 v and at fp32 rounding boundaries (xdt_int8_quantize_forms).
__device__ __forceinline__ uint32_t quantize_fast(float v, float sx,
                                                  float r) {
  const float q0 = __fmul_rn(v, r);
  const float y = __fmaf_rn(__fmaf_rn(-q0, sx, v), r, q0);
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(y, -127.0f), 127.0f), 12582912.0f));
}

// Four quantized values packed into a word, byte k from v[k].
template <bool FAST>
__device__ __forceinline__ uint32_t quantize4(const float (&v)[4], float sx,
                                              float r) {
  uint32_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = FAST ? quantize_fast(v[k], sx, r)
                : static_cast<uint32_t>(quantize1(v[k], sx));
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                     __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// The 4 x 4 byte transpose: a, b, c, d (4 channels of columns 0-3) -> t[k]
// (columns 0-3 of channel k).
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d,
                                           uint32_t (&t)[4]) {
  const uint32_t ab01 = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
  const uint32_t ab23 = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
  const uint32_t cd01 = __byte_perm(c, d, 0x5140);
  const uint32_t cd23 = __byte_perm(c, d, 0x7362);
  t[0] = __byte_perm(ab01, cd01, 0x5410);            // a0 b0 c0 d0
  t[1] = __byte_perm(ab01, cd01, 0x7632);            // a1 b1 c1 d1
  t[2] = __byte_perm(ab23, cd23, 0x5410);
  t[3] = __byte_perm(ab23, cd23, 0x7632);
}

// Bytes P, P + D, P + 2D of a channel's column stream (G words) in bytes
// 0-2 of a word; byte 3 meets a zero tap.
template <int P, int D, int G>
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[G]) {
  constexpr int m = P / 4, o = P % 4;
  if constexpr (o == 0 && D == 1) {
    return w[m];
  } else if constexpr (o + 2 * D < 4) {
    return __byte_perm(w[m], 0u, o | ((o + D) << 4) | ((o + 2 * D) << 8));
  } else {
    static_assert(m + 1 < G && o + 2 * D < 8, "taps span two words");
    return __byte_perm(w[m], w[m + 1],
                       o | ((o + D) << 4) | ((o + 2 * D) << 8));
  }
}

template <int S, int D, int RH, int MODE>
__global__ void __launch_bounds__(THREADS_MAX, 1)
int8_dwconv_tma_kernel(const __grid_constant__ CUtensorMap in_map,
                       const __grid_constant__ CUtensorMap out_map,
                       const Params p) {
  constexpr int L = 3 * S + 2 * D + 1;   // input columns of a run's row
  constexpr int G = (L + 3) / 4;         // their words a channel
  constexpr int NR = (RH - 1) * S + 2 * D + 1;   // input rows of a run
  constexpr int OB = MODE == OUT_F32 ? 4 : MODE == OUT_BF16 ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int warps = p.qw * p.rr;
  unsigned char* staging = smem + p.stages * p.stage_bytes;
  const uint32_t bar0 = smem_u32(staging + warps * p.staging_bytes);
  auto full = [bar0](int s) { return bar0 + 8u * s; };
  auto empty = [bar0](int s) { return bar0 + 8u * (MAX_STAGES + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), warps);       // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == warps) {
    // Producer warp: one lane starts every box load.
    if (lane == 0) {
      int g = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++g) {
        const int s = g % p.stages;
        mbar_wait(empty(s), ((g / p.stages) & 1) ^ 1);
        const Unit U = unit_of(p, u);
        mbar_expect_tx(full(s), p.box_bytes);
        tma_load_4d(smem_u32(smem + s * p.stage_bytes), &in_map, full(s),
                    U.c0, U.ox0 * S - p.pl, U.oy0 * S - p.pt, U.b);
      }
    }
    return;
  }

  // Consumers: warp (qi, rr) owns the tile's output rows [rr * RH, rr * RH
  // + RH) and columns [4 qi, 4 qi + 4), its lane channels c0 + 4 lane + k.
  const int qi = warp % p.qw, r0 = (warp / p.qw) * RH;
  unsigned char* stg = staging + warp * p.staging_bytes;  // [RH][4][CB]
  const int rowbytes = p.bw * CB;
  int wt[4][3];        // channel k's tap row i: (w_i0, w_i1, w_i2, 0)
  float sc[4];
  float sxo = 0.0f, rcp = 0.0f;
  bool fast = false;   // this lane's channels take quantize_fast
  if constexpr (MODE == OUT_S8_BF16 || MODE == OUT_S8_F32) {
    sxo = *p.sx_out;
    rcp = __frcp_rn(sxo);
  }
  int loaded = -1;     // the channel block whose taps are in wt
  int g = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x, ++g) {
    const Unit U = unit_of(p, u);
    if (U.c0 != loaded) {
      loaded = U.c0;
      const int c = U.c0 + 4 * lane;
      int4 t[3] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0),
                   make_int4(0, 0, 0, 0)};
      float4 s4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c < p.C) {
        const int4* src = reinterpret_cast<const int4*>(p.w + 12 * c);
        t[0] = __ldg(src);
        t[1] = __ldg(src + 1);
        t[2] = __ldg(src + 2);
        s4 = __ldg(reinterpret_cast<const float4*>(p.scale + c));
      }
      int words[12];
      memcpy(words, t, sizeof(words));
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 3; ++i) wt[k][i] = words[3 * k + i];
      sc[0] = s4.x;
      sc[1] = s4.y;
      sc[2] = s4.z;
      sc[3] = s4.w;
      fast = fast_scale(sxo) && fabsf(s4.x) <= FAST_SCALE_MAX &&
             fabsf(s4.y) <= FAST_SCALE_MAX && fabsf(s4.z) <= FAST_SCALE_MAX &&
             fabsf(s4.w) <= FAST_SCALE_MAX;
    }
    const int s = g % p.stages;
    mbar_wait(full(s), (g / p.stages) & 1);

    // the run's input rows start at box row r0 * S, its columns at 4 qi S
    const unsigned char* run = smem + s * p.stage_bytes +
                               (r0 * S) * rowbytes + (qi * QUAD * S) * CB +
                               4 * lane;
    uint32_t rows[NR][4][G];
    static_for<0, RH>([&](auto r_) {
      constexpr int r = decltype(r_)::value;
      static_for<0, NR>([&](auto R_) {
        constexpr int R = decltype(R_)::value;
        if constexpr (first_use<S, D, RH>(R) == r) {
          const unsigned char* src = run + R * rowbytes;
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            uint32_t t[4];
            transpose4(*reinterpret_cast<const uint32_t*>(src + (4 * gi) * CB),
                       *reinterpret_cast<const uint32_t*>(
                           src + (4 * gi + 1) * CB),
                       *reinterpret_cast<const uint32_t*>(
                           src + (4 * gi + 2) * CB),
                       *reinterpret_cast<const uint32_t*>(
                           src + (4 * gi + 3) * CB),
                       t);
#pragma unroll
            for (int k = 0; k < 4; ++k) rows[R][k][gi] = t[k];
          }
        }
      });
      int acc[4][QUAD];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < QUAD; ++q) acc[k][q] = 0;
      static_for<0, 3>([&](auto i_) {
        constexpr int i = decltype(i_)::value;
        constexpr int R = r * S + i * D;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          static_for<0, QUAD>([&](auto q_) {
            constexpr int q = decltype(q_)::value;
            acc[k][q] = __dp4a(static_cast<int>(pick<q * S, D, G>(rows[R][k])),
                               wt[k][i], acc[k][q]);
          });
      });
      // Epilogue of output row r: pixel q's 4 channels at staging (r, q),
      // once the run's last store has read the staging (its first row's
      // products gave the store that time)
      if constexpr (r == 0) {
        if (lane == 0) bulk_wait_read<0>();
        __syncwarp();
      }
#pragma unroll
      for (int q = 0; q < QUAD; ++q) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = __fmul_rn(exact_float(acc[k][q]), sc[k]);
        unsigned char* o = stg + ((r * QUAD + q) * CB + 4 * lane) * OB;
        if constexpr (MODE == OUT_BF16) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          uint2 w2;
          memcpy(&w2.x, &lo, 4);
          memcpy(&w2.y, &hi, 4);
          *reinterpret_cast<uint2*>(o) = w2;
        } else if constexpr (MODE == OUT_F32) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
          if constexpr (MODE == OUT_S8_BF16) {   // the module dtype's value
            const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
            v[0] = __low2float(lo);
            v[1] = __high2float(lo);
            v[2] = __low2float(hi);
            v[3] = __high2float(hi);
          }
          uint32_t word;
          if (fast)   // every lane of the model's calls: no divergence
            word = quantize4<true>(v, sxo, rcp);
          else
            word = quantize4<false>(v, sxo, rcp);
          *reinterpret_cast<uint32_t*>(o) = word;
        }
      }
    });
    // every lane has read the box: release the stage to the producer
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    // the staged run to the output; the map clips rows and columns past
    // the map's edge and channels past C
    fence_async_shared();
    __syncwarp();
    if (lane == 0 && U.oy0 + r0 < p.Ho && U.ox0 + QUAD * qi < p.Wo) {
      tma_store_4d(&out_map, smem_u32(stg), U.c0, U.ox0 + QUAD * qi,
                   U.oy0 + r0, U.b);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait<0>();
}

template <int S, int D, int MODE>
int launch(const CUtensorMap& in_map, const CUtensorMap& out_map,
           const Params& p, int smem_bytes, int grid, cudaStream_t st) {
  constexpr int RH = 8 / S;
  auto kernel = int8_dwconv_tma_kernel<S, D, RH, MODE>;
  // the shared memory a block may take, raised once a card
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) raised[dev] = true;
  }
  kernel<<<grid, 32 * (p.qw * p.rr + 1), smem_bytes, st>>>(in_map, out_map,
                                                           p);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(int s, int d, const CUtensorMap& in_map,
                const CUtensorMap& out_map, const Params& p, int smem_bytes,
                int grid, cudaStream_t st) {
  if (s == 1 && d == 1)
    return launch<1, 1, MODE>(in_map, out_map, p, smem_bytes, grid, st);
  if (s == 1 && d == 2)
    return launch<1, 2, MODE>(in_map, out_map, p, smem_bytes, grid, st);
  if (s == 2 && d == 1)
    return launch<2, 1, MODE>(in_map, out_map, p, smem_bytes, grid, st);
  if (s == 2 && d == 2)
    return launch<2, 2, MODE>(in_map, out_map, p, smem_bytes, grid, st);
  return (int)cudaErrorInvalidValue;
}

bool tiled_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box) {
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encoder()(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                   step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// v -> (quantize_fast where the kernel takes it, else quantize1;
// quantize1)
__global__ void quantize_forms_kernel(const float* __restrict__ v, int n,
                                      const float* __restrict__ sx,
                                      int8_t* __restrict__ kernel_q,
                                      int8_t* __restrict__ k3_q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float s = *sx, r = __frcp_rn(s);
  kernel_q[i] = (int8_t)(fast_scale(s) && fabsf(v[i]) <= FAST_V_MAX
                             ? quantize_fast(v[i], s, r) & 0xff
                             : quantize1(v[i], s));
  k3_q[i] = (int8_t)quantize1(v[i], s);
}

}  // namespace

// The quantize on the store, as the kernel computes it, beside K3's form:
// v [n] fp32, sx one fp32 on the device -> kernel_q, k3_q [n] int8. The
// card tests hold the two equal (tests/test_torch_cuda_kernels.py).
extern "C" int xdt_int8_quantize_forms(const void* v, int n, const void* sx,
                                       void* kernel_q, void* k3_q,
                                       void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  quantize_forms_kernel<<<(n + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), n, static_cast<const float*>(sx),
      static_cast<int8_t*>(kernel_q), static_cast<int8_t*>(k3_q));
  return (int)cudaGetLastError();
}

// x [B, H, W, C] int8, w [C][3][4] int8 (channel c's tap row i at bytes
// 12c + 4i: w_i0, w_i1, w_i2, 0; the "tma" rows of
// ops/int8_conv.py::prepare_weight's operand), scale [C] fp32 -> out [B,
// Ho, Wo, C]: mode 0 bf16, 1 fp32 (dequant); 2 and 3 int8, quantized at
// *sx_out from the bf16 (2) or fp32 (3) value. stride and dilation 1 or 2;
// explicit top and left pads. The host's plan (ops/int8_conv.py::
// plan_depthwise): qw x rr runs a tile (qw * rr consumer warps), the
// ring's stages, smem_bytes of dynamic shared memory, grid persistent
// blocks. Returns a cudaError_t.
extern "C" int xdt_int8_dwconv_tma(
    const void* x, const void* w, const void* scale, const void* sx_out,
    void* out, int mode, int B, int H, int W, int C, int Ho, int Wo,
    int stride, int dil, int pt, int pl, int qw, int rr, int stages,
    int smem_bytes, int grid, void* stream) {
  const int ob = mode == OUT_F32 ? 4 : mode == OUT_BF16 ? 2 : 1;
  const int rh = 8 / (stride > 0 ? stride : 1);
  if (B < 1 || H < 1 || W < 1 || C < 1 || C % 16 || Ho < 1 || Wo < 1 ||
      stride < 1 || stride > 2 || dil < 1 || dil > 2 || pt < 0 || pl < 0 ||
      mode < 0 || mode > 3 || qw < 1 || rr < 1 || qw * rr > MAX_WARPS ||
      stages < 2 || stages > MAX_STAGES || grid < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || (mode >= 2 && !sx_out))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.sx_out = static_cast<const float*>(sx_out);
  p.C = C; p.Ho = Ho; p.Wo = Wo; p.pt = pt; p.pl = pl;
  p.qw = qw; p.rr = rr;
  p.th = rr * rh;
  p.tw = qw * QUAD;
  const int bh = (p.th - 1) * stride + 2 * dil + 1;
  p.bw = (p.tw - 1) * stride + 2 * dil + 1;
  if (bh > 256 || p.bw > 256) return (int)cudaErrorInvalidValue;
  p.tiles_h = (Ho + p.th - 1) / p.th;
  p.tiles_w = (Wo + p.tw - 1) / p.tw;
  p.cblocks = (C + CB - 1) / CB;
  const long long units = (long long)B * p.tiles_h * p.tiles_w * p.cblocks;
  if (units > INT_MAX) return (int)cudaErrorInvalidValue;
  p.units = (int)units;
  p.box_bytes = bh * p.bw * CB;
  p.stage_bytes = (p.box_bytes + BOX_SLACK + 1023) / 1024 * 1024;
  p.stages = stages;
  p.staging_bytes = rh * QUAD * CB * ob;
  const int need = stages * p.stage_bytes + qw * rr * p.staging_bytes +
                   BAR_BYTES + 1024;
  if (smem_bytes < need || smem_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;

  CUtensorMap in_map, out_map;
  memset(&in_map, 0, sizeof(in_map));
  memset(&out_map, 0, sizeof(out_map));
  {   // [B, H, W, C] int8, boxes of bh x bw pixels x 128 channels
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)C, (cuuint64_t)W * C,
                                   (cuuint64_t)H * W * C};
    const cuuint32_t box[4] = {CB, (cuuint32_t)p.bw, (cuuint32_t)bh, 1};
    if (!tiled_map(&in_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, dims, strides,
                   box))
      return (int)cudaErrorInvalidValue;
  }
  {   // [B, Ho, Wo, C] of the output type, a run's rh x 4 pixels x 128
    const CUtensorMapDataType type =
        mode == OUT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
        : mode == OUT_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8;
    const cuuint64_t row = (cuuint64_t)C * ob;
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)Wo,
                                (cuuint64_t)Ho, (cuuint64_t)B};
    const cuuint64_t strides[3] = {row, row * Wo, row * Wo * Ho};
    const cuuint32_t box[4] = {CB, QUAD, (cuuint32_t)rh, 1};
    if (!tiled_map(&out_map, type, out, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  const int blocks = grid < p.units ? grid : p.units;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case OUT_BF16:
      return launch_mode<OUT_BF16>(stride, dil, in_map, out_map, p,
                                   smem_bytes, blocks, st);
    case OUT_F32:
      return launch_mode<OUT_F32>(stride, dil, in_map, out_map, p,
                                  smem_bytes, blocks, st);
    case OUT_S8_BF16:
      return launch_mode<OUT_S8_BF16>(stride, dil, in_map, out_map, p,
                                      smem_bytes, blocks, st);
    default:
      return launch_mode<OUT_S8_F32>(stride, dil, in_map, out_map, p,
                                     smem_bytes, blocks, st);
  }
}
