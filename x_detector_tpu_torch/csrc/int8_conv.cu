// int8 convolutions of the post-training-quantized backbone on Hopper
// (sm_90a): a dense conv (K1), a depthwise 3x3 (K2) and the activation
// quantizer that feeds both (K3).
//
// Replaces: the int8 lax.conv_general_dilated of QuantConv's "int8" mode,
// x_detector_tpu/models/layers.py:180-185 (XLA's op, not a Pallas kernel),
// and the quantize / dequantize around it (:167-170, :186).
//
// What they compute (QuantConv, int8 mode):
//   xq = clip(round(x / sx), -127, 127)          K3, round half to even
//   acc = sum over (tap, cin) of xq * wq          int32, exact
//   y = bf16_or_fp32(float(acc) * scale[cout])   scale = sx * sw, fp32
// The products and their int32 sums are exact, so each kernel equals its
// plain version (ops/int8_conv.py, a float64 sum of the same integers) bit
// for bit: the epilogue rounds exactly as written, __int2float_rn, one
// __fmul_rn, one __float2bfloat16_rn, with no FMA contraction and no
// fast-math (the build passes no --use_fast_math). K3 divides with
// __fdiv_rn: a multiply by 1/sx would round other values.
//
// K1, the dense conv, has two routes; ops/int8_conv.py::plan_conv picks
// one by a rule on the call's shape, never by a failure:
//   - "tma" (int8_conv_tma.cu, its note says how): every call whose Cin is
//     a multiple of 16 and whose activation is 16-byte aligned, TMA's rules
//     for a global stride and address; wgmma s8 on TMA-loaded tiles, split
//     K in clusters, a TMA-stored epilogue. Every call of configs 2 and 3
//     but the stems.
//   - "mma", xdt_int8_conv here, the first design: the rest, on the main
//     paths the two stems (ResNet's 7x7 at Cin 3, Xception's folded (12, 3)
//     at Cin 12), whose pixel rows of 3 or 12 bytes are no stride a tensor
//     map takes (a multiple of 16 bytes). An implicit GEMM, M = B*Ho*Wo output
//     pixels by N = Cout by K = kh*kw*Cin, the activation NHWC and the
//     weight OHWI ([Cout][Kp], K padded with zeros to a multiple of 64,
//     prepared once per weight on the host). A block owns 128 pixels by BN
//     (64 or 128) channels; warps of 64 x 32 run mma.sync m16n8k32 s8 x s8
//     -> s32 from ldmatrix'd shared-memory tiles. The A tile is gathered on
//     the fly (no im2col in device memory): each block first tables its rows
//     (image offset and the top-left input pixel) in shared memory; a
//     thread's column of the tile decodes once per K step into (tap,
//     channel), and VEC-byte runs of a pixel's channels move with cp.async
//     (16, 8 or 4 bytes, the largest that divides Cin) or byte by byte (Cin
//     3), zero-filled for padding, the M tail and the K tail. Three stages
//     in flight; rows padded to 80 bytes so that ldmatrix reads 8 rows
//     without bank conflicts.
//     What bounds it: the stems move bytes (the input once, the output
//     once: 0.02-0.06 ms at configs 2 and 3), but at Cin 3 or 12 every
//     thread gathers single bytes or 4-byte runs a K step and the products
//     run half-empty, so the gather binds it (7-17% of the bound; cuDNN's
//     bf16 conv of ResNet's stem takes as long). A stem route of its own is
//     later work.
// K2, the depthwise 3x3, has two routes; ops/int8_conv.py::plan_depthwise
// picks one by a rule on the call's shape:
//   - "tma" (int8_dwconv_tma.cu, its note says how): every call whose C is
//     a multiple of 16, whose stride and dilation are 1 or 2 and whose
//     operands are 16-byte aligned (every call of config 3); TMA-loaded
//     halo boxes, dp4a on transposed words, TMA-stored runs. It alone
//     also quantizes its output on the store for the next conv
//     (xdt::int8_dwconv_q), in place of K3 on the separable blocks.
//   - "simt", xdt_int8_dwconv here, the first design: the rest. Any
//     stride and dilation, explicit top and left pads (the bottom and
//     right follow from Ho and Wo). A thread takes VEC channels (16, 4 or
//     1, the largest that divides C) of one output pixel: 9 taps of VEC
//     int8 each, read as one load, int32 sums in registers, the same
//     epilogue. It moves the int8 map in and the output out once each (the
//     taps' reuse hits the L1 and L2); at config 3 it reached a third of
//     that bound: one thread an output pixel reloads every tap and weight
//     and spends ~20 integer instructions an output.
//
// K3, xdt_quantize_s8: a bf16 or fp32 tensor to int8 at the per-tensor
// scale sx, read from device memory (no host sync on act_amax). 8 elements
// a thread. It is a pass of its own rather than folded into K1's gather:
// K1 reads each input pixel kh*kw times, and K3's IEEE division would run
// again on each; once, it costs one read of the activation and one write
// of a quarter (bf16: half) of its bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBM = 128;           // output pixels a block
constexpr int kBK = 64;            // bytes of K a pipeline stage
constexpr int kRow = kBK + 16;     // a shared-memory row: 80 bytes
constexpr int kStages = 3;

struct ConvParams {
  const int8_t* x;        // [B, H, W, Cin]
  const int8_t* w;        // [Cout, Kp]
  const float* scale;     // [Cout]
  void* out;              // [M, Cout]
  int B, H, W, Cin, Ho, Wo, Cout, kh, kw, sh, sw, dh, dw, pt, pl, K, Kp, M;
};

struct RowInfo {          // one output pixel of the block's tile
  long long base;         // b * H * W * Cin
  int h0, w0;             // its top-left input pixel (before the tap)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VEC bytes global -> shared, zero-filled where !ok (src is then any valid
// address and is not read)
template <int VEC>
__device__ __forceinline__ void copy_chunk(void* dst, const int8_t* src,
                                           bool ok) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else if constexpr (VEC == 8 || VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(VEC), "r"(ok ? VEC : 0));
  } else {
    *static_cast<int8_t*>(dst) = ok ? *src : int8_t(0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), int32, exact
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the dequant epilogue: one rounding to fp32, one multiply, one rounding to
// the output type
__device__ __forceinline__ float dequant(int acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
}

__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float v0, float v1) {
  __nv_bfloat162 h;
  h.x = __float2bfloat16_rn(v0);
  h.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(o) = h;
}

template <int BN>
constexpr int conv_smem_bytes() {
  return kStages * (kBM + BN) * kRow + kBM * (int)sizeof(RowInfo);
}

// ---- K1 --------------------------------------------------------------------

template <int BN, int VEC, typename OutT>
__global__ void __launch_bounds__(BN * 2)
    int8_conv_kernel(const ConvParams p) {
  constexpr int kThreads = BN * 2;          // 2 x (BN / 32) warps of 64 x 32
  constexpr int kCpr = kBK / VEC;           // A chunks a row
  constexpr int kRpp = kThreads / kCpr;     // A rows a pass
  static_assert(kThreads % kCpr == 0 && kBM % kRpp == 0, "A tile split");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sA = smem;
  unsigned char* sB = sA + kStages * kBM * kRow;
  RowInfo* rows = reinterpret_cast<RowInfo*>(sB + kStages * BN * kRow);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;

  for (int r = tid; r < kBM; r += kThreads) {
    const int m = m0 + r;
    RowInfo info;
    if (m < p.M) {
      const int hw = p.Ho * p.Wo;
      const int b = m / hw, rem = m - b * hw;
      const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
      info.base = (long long)b * p.H * p.W * p.Cin;
      info.h0 = ho * p.sh - p.pt;
      info.w0 = wo * p.sw - p.pl;
    } else {                                 // the M tail: never in bounds
      info.base = 0;
      info.h0 = -(1 << 29);
      info.w0 = 0;
    }
    rows[r] = info;
  }
  __syncthreads();

  const int a_col = (tid % kCpr) * VEC;     // this thread's column of A
  auto load_tile = [&](int kt, int stage) {
    const int k = kt * kBK + a_col;
    const bool k_ok = k < p.K;
    int dy = 0, dx = 0, c = 0;
    if (k_ok) {
      const int tap = k / p.Cin;
      c = k - tap * p.Cin;
      const int i = tap / p.kw;
      dy = i * p.dh;
      dx = (tap - i * p.kw) * p.dw;
    }
    unsigned char* a = sA + stage * kBM * kRow + a_col;
#pragma unroll 4
    for (int r = tid / kCpr; r < kBM; r += kRpp) {
      const RowInfo info = rows[r];
      const int h = info.h0 + dy, w = info.w0 + dx;
      const bool ok = k_ok && (unsigned)h < (unsigned)p.H &&
                      (unsigned)w < (unsigned)p.W;
      const int8_t* src =
          ok ? p.x + info.base + ((long long)h * p.W + w) * p.Cin + c : p.x;
      copy_chunk<VEC>(a + r * kRow, src, ok);
    }
    unsigned char* b = sB + stage * BN * kRow;
#pragma unroll
    for (int ch = tid; ch < BN * (kBK / 16); ch += kThreads) {
      const int n = ch / (kBK / 16), col = (ch % (kBK / 16)) * 16;
      const bool ok = n0 + n < p.Cout;
      const int8_t* src =
          ok ? p.w + (long long)(n0 + n) * p.Kp + kt * kBK + col : p.w;
      copy_chunk<16>(b + n * kRow + col, src, ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = p.Kp / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // tile kt landed; stage (kt-1) % S is free
    const int next = kt + kStages - 1;
    if (next < nk) load_tile(next, next % kStages);
    cp_async_commit();
    const unsigned char* a = sA + (kt % kStages) * kBM * kRow;
    const unsigned char* b = sB + (kt % kStages) * BN * kRow;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], a + (warp_m * 64 + mt * 16 + (lane & 15)) * kRow +
                                ks * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned t[4];
        ldmatrix_x4(t, b + (warp_n * 32 + np * 16 + (lane >> 4) * 8 +
                            (lane & 7)) * kRow +
                           ks * 32 + ((lane >> 3) & 1) * 16);
        bf[2 * np][0] = t[0];
        bf[2 * np][1] = t[1];
        bf[2 * np + 1][0] = t[2];
        bf[2 * np + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
  cp_async_wait<0>();

  OutT* out = static_cast<OutT*>(p.out);
  const bool paired = (p.Cout & 1) == 0;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + warp_n * 32 + nt * 8 + t4 * 2;
    const float s0 = col < p.Cout ? p.scale[col] : 0.0f;
    const float s1 = col + 1 < p.Cout ? p.scale[col + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + warp_m * 64 + mt * 16 + g + half * 8;
        if (row >= p.M || col >= p.Cout) continue;
        const float v0 = dequant(acc[mt][nt][2 * half], s0);
        const float v1 = dequant(acc[mt][nt][2 * half + 1], s1);
        OutT* o = out + (long long)row * p.Cout + col;
        if (col + 1 < p.Cout && paired) {
          store2(o, v0, v1);
        } else {
          store1(o, v0);
          if (col + 1 < p.Cout) store1(o + 1, v1);
        }
      }
  }
}

template <int BN, int VEC, typename OutT>
int launch_conv(const ConvParams& p, cudaStream_t s) {
  auto kernel = int8_conv_kernel<BN, VEC, OutT>;
  constexpr int smem = conv_smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.M + kBM - 1) / kBM),
                  (unsigned)((p.Cout + BN - 1) / BN));
  kernel<<<grid, BN * 2, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int BN, typename OutT>
int launch_conv_vec(const ConvParams& p, int vec, cudaStream_t s) {
  switch (vec) {
    case 16: return launch_conv<BN, 16, OutT>(p, s);
    case 8: return launch_conv<BN, 8, OutT>(p, s);
    case 4: return launch_conv<BN, 4, OutT>(p, s);
    case 1: return launch_conv<BN, 1, OutT>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- K2 --------------------------------------------------------------------

template <int VEC>
__device__ __forceinline__ void load_s8(int8_t (&v)[VEC], const int8_t* p) {
  if constexpr (VEC == 16) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    memcpy(v, &t, 16);
  } else if constexpr (VEC == 4) {
    const int t = __ldg(reinterpret_cast<const int*>(p));
    memcpy(v, &t, 4);
  } else {
    v[0] = p[0];
  }
}

template <int VEC, typename OutT>
__global__ void __launch_bounds__(256)
    int8_dwconv_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       OutT* __restrict__ out, int H, int W, int C, int Ho,
                       int Wo, int stride, int dil, int pt, int pl,
                       int total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int groups = C / VEC;
  const int c0 = (idx % groups) * VEC;
  int p = idx / groups;                    // (b * Ho + ho) * Wo + wo
  const int wo = p % Wo;
  p /= Wo;
  const int ho = p % Ho, b = p / Ho;
  int acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int h = ho * stride - pt + i * dil;
    if ((unsigned)h >= (unsigned)H) continue;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int ww = wo * stride - pl + j * dil;
      if ((unsigned)ww >= (unsigned)W) continue;
      int8_t xv[VEC], wv[VEC];
      load_s8<VEC>(xv, x + (((long long)b * H + h) * W + ww) * C + c0);
      load_s8<VEC>(wv, w + (i * 3 + j) * C + c0);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += (int)xv[v] * (int)wv[v];
    }
  }
  OutT* o = out + (long long)idx * VEC;    // the output is [.., C] too
  if constexpr (VEC == 1) {
    store1(o, dequant(acc[0], scale[c0]));
  } else {
#pragma unroll
    for (int v = 0; v < VEC; v += 2)
      store2(o + v, dequant(acc[v], scale[c0 + v]),
             dequant(acc[v + 1], scale[c0 + v + 1]));
  }
}

template <int VEC, typename OutT>
int launch_dwconv(const int8_t* x, const int8_t* w, const float* scale,
                  OutT* out, int B, int H, int W, int C, int Ho, int Wo,
                  int stride, int dil, int pt, int pl, cudaStream_t s) {
  const long long total = (long long)B * Ho * Wo * (C / VEC);
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  int8_dwconv_kernel<VEC, OutT><<<blocks, 256, 0, s>>>(
      x, w, scale, out, H, W, C, Ho, Wo, stride, dil, pt, pl, (int)total);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_dwconv_vec(int vec, const int8_t* x, const int8_t* w,
                      const float* scale, OutT* out, int B, int H, int W,
                      int C, int Ho, int Wo, int stride, int dil, int pt,
                      int pl, cudaStream_t s) {
  switch (vec) {
    case 16: return launch_dwconv<16>(x, w, scale, out, B, H, W, C, Ho, Wo,
                                      stride, dil, pt, pl, s);
    case 4: return launch_dwconv<4>(x, w, scale, out, B, H, W, C, Ho, Wo,
                                    stride, dil, pt, pl, s);
    case 1: return launch_dwconv<1>(x, w, scale, out, B, H, W, C, Ho, Wo,
                                    stride, dil, pt, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- K3 --------------------------------------------------------------------

__device__ __forceinline__ int8_t quantize1(float v, float sx) {
  const int q = __float2int_rn(__fdiv_rn(v, sx));
  return (int8_t)min(max(q, -127), 127);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename InT, int VEC>
__global__ void __launch_bounds__(256)
    quantize_s8_kernel(const InT* __restrict__ x, const float* __restrict__ sx,
                       int8_t* __restrict__ q, int n) {
  const long long i0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (i0 >= n) return;
  const float s = *sx;
  if constexpr (VEC == 8) {
    if (i0 + 8 <= n) {
      InT v[8];
      if constexpr (sizeof(InT) == 2) {
        const int4 t = __ldg(reinterpret_cast<const int4*>(x + i0));
        memcpy(v, &t, 16);
      } else {
        const float4 a = __ldg(reinterpret_cast<const float4*>(x + i0));
        const float4 b = __ldg(reinterpret_cast<const float4*>(x + i0 + 4));
        memcpy(v, &a, 16);
        memcpy(v + 4, &b, 16);
      }
      int8_t out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = quantize1(to_float(v[e]), s);
      uint2 packed;
      memcpy(&packed, out, 8);
      *reinterpret_cast<uint2*>(q + i0) = packed;
      return;
    }
  }
  for (long long i = i0; i < i0 + VEC && i < n; ++i)
    q[i] = quantize1(to_float(x[i]), s);
}

template <typename InT>
int launch_quantize(const InT* x, const float* sx, int8_t* q, int n, int vec,
                    cudaStream_t s) {
  if (vec != 8 && vec != 1) return (int)cudaErrorInvalidValue;
  const long long threads = (n + vec - 1) / vec;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  if (vec == 8)
    quantize_s8_kernel<InT, 8><<<blocks, 256, 0, s>>>(x, sx, q, n);
  else
    quantize_s8_kernel<InT, 1><<<blocks, 256, 0, s>>>(x, sx, q, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, Cin] int8, w [Cout, Kp] int8 (OHWI, K = kh*kw*Cin padded to
// Kp with zeros), scale [Cout] fp32 -> out [B, Ho, Wo, Cout] bf16 or fp32.
// The host plans bn (64 or 128) and vec (16, 8, 4 or 1: divides Cin and
// the address of x).
extern "C" int xdt_int8_conv(const void* x, const void* w, const void* scale,
                             void* out, int out_is_bf16, int B, int H, int W,
                             int Cin, int Ho, int Wo, int Cout, int kh,
                             int kw, int sh, int sw, int dh, int dw, int pt,
                             int pl, int Kp, int bn, int vec, void* stream) {
  ConvParams p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.B = B; p.H = H; p.W = W; p.Cin = Cin; p.Ho = Ho; p.Wo = Wo;
  p.Cout = Cout; p.kh = kh; p.kw = kw; p.sh = sh; p.sw = sw; p.dh = dh;
  p.dw = dw; p.pt = pt; p.pl = pl; p.Kp = Kp;
  p.K = kh * kw * Cin;
  const long long m = (long long)B * Ho * Wo;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Ho < 1 || Wo < 1 || Cout < 1 ||
      kh < 1 || kw < 1 || sh < 1 || sw < 1 || dh < 1 || dw < 1 || pt < 0 ||
      pl < 0 || Kp < p.K || Kp % kBK || Cin % vec ||
      reinterpret_cast<uintptr_t>(x) % vec ||
      reinterpret_cast<uintptr_t>(w) % 16 || m > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.M = (int)m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return out_is_bf16 ? launch_conv_vec<64, __nv_bfloat16>(p, vec, s)
                       : launch_conv_vec<64, float>(p, vec, s);
  if (bn == 128)
    return out_is_bf16 ? launch_conv_vec<128, __nv_bfloat16>(p, vec, s)
                       : launch_conv_vec<128, float>(p, vec, s);
  return (int)cudaErrorInvalidValue;
}

// x [B, H, W, C] int8, w [9, C] int8 (taps row-major: rows 0-8 of the
// operand ops/int8_conv.py::prepare_weight makes), scale [C] fp32 ->
// out [B, Ho, Wo, C] bf16 or fp32; vec (16, 4 or 1) divides C and the
// addresses.
extern "C" int xdt_int8_dwconv(const void* x, const void* w,
                               const void* scale, void* out, int out_is_bf16,
                               int B, int H, int W, int C, int Ho, int Wo,
                               int stride, int dil, int pt, int pl, int vec,
                               void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || Ho < 1 || Wo < 1 || stride < 1 ||
      dil < 1 || pt < 0 || pl < 0 || (vec != 16 && vec != 4 && vec != 1) ||
      C % vec || reinterpret_cast<uintptr_t>(x) % vec ||
      reinterpret_cast<uintptr_t>(w) % vec ||
      reinterpret_cast<uintptr_t>(out) % (vec * (out_is_bf16 ? 2 : 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  if (out_is_bf16)
    return launch_dwconv_vec(vec, xs, ws, sc,
                             static_cast<__nv_bfloat16*>(out), B, H, W, C, Ho,
                             Wo, stride, dil, pt, pl, s);
  return launch_dwconv_vec(vec, xs, ws, sc, static_cast<float*>(out), B, H, W,
                           C, Ho, Wo, stride, dil, pt, pl, s);
}

// x [n] bf16 or fp32, sx one fp32 on the device -> q [n] int8; vec 8 needs
// x 16-byte and q 8-byte aligned.
extern "C" int xdt_quantize_s8(const void* x, const void* sx, void* q,
                               int x_is_bf16, int n, int vec, void* stream) {
  if (n < 1 ||
      (vec == 8 && (reinterpret_cast<uintptr_t>(x) % 16 ||
                    reinterpret_cast<uintptr_t>(q) % 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* scale = static_cast<const float*>(sx);
  auto* out = static_cast<int8_t*>(q);
  if (x_is_bf16)
    return launch_quantize(static_cast<const __nv_bfloat16*>(x), scale, out,
                           n, vec, s);
  return launch_quantize(static_cast<const float*>(x), scale, out, n, vec, s);
}
