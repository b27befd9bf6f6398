// Fused depthwise-separable conv, the first design ("wmma" route), kept as
// the route for shapes that the TMA kernel (fused_sepconv.cu) does not take:
// Cin or Cout not a multiple of 8.
//   out = relu((dw3x3(x; SAME, dilation d) @ wp) * scale + bias [+ residual])
//
// Replaces: x_detector_tpu/ops/pallas/fused_sepconv.py::_kernel (driven by
// fused_separable_conv). The rounding order is that kernel's: the 9 taps
// accumulate in fp32 and are rounded to bf16 before the pointwise product;
// the product accumulates in fp32; the folded-BN affine, the residual and
// the ReLU apply in fp32; one rounding to bf16 on store. The TPU kernel's
// carry-ring of row bands and its sublane rolls serve a sequential grid and
// have no counterpart here: this kernel takes any H and W.
//
// Design: each block owns BM output pixels (flattened over B*H*W, so a tile
// may span rows and images) and every output channel.
//   1. Depthwise, once: the BM x Cin depthwise result goes to shared memory
//      (fp32 accumulation over the 9 taps, SAME zero padding, dilation d,
//      rounded to bf16), V channels per thread with one 16-byte load per
//      tap when the widths allow (V = 8), else one (V = 1), two units'
//      loads in flight at a time; the fp32 taps of all Cin are staged in
//      shared memory first.
//   2. Pointwise, per tile of BN output channels: the BM x Cin result times
//      wp, on the tensor cores (WMMA 16x16x16 bf16 -> fp32, eight warps of
//      32 x 32), with wp streamed in BK-row slices through two
//      shared-memory buffers by cp.async (the next slice loads while this
//      one multiplies); then the epilogue, each 16 x 16 fragment staged in
//      the warp's own buffer and stored 16 bytes per thread.
// So the depthwise result is computed once per (pixel, channel), never per
// output channel or per Cout tile.
//
// What bounds it: about 500 GFLOP per batch of 16 at 800 px over the 14
// calls (stage 4 alone ~84 GFLOP per 1024->1024 call) and ~3 GB of
// activation traffic: memory-bound at stage 1 (128 channels), compute-heavy
// at stage 4. Each block reads all of wp (2 MB in bf16 at 1024 x 1024) from
// L2, and the 9 taps of each pixel come through L1/L2. The shared memory
// holds BM x Cin (about 130 KB at Cin = 512, 210 KB at 1024), so from
// Cin = 512 one block runs per SM and its two phases do not overlap with
// another block's: the depthwise phase waits on loads while the tensor
// cores idle, then the product phase runs with no loads but wp's. Cin is
// bounded: at most 1088 at BM = 64 (a larger Cin makes
// the launch fail with an error, which the wrapper raises).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 128;       // output channels per pointwise tile
constexpr int BK = 64;        // rows of wp per streamed slice
constexpr int THREADS = 256;  // 8 warps: 2 (M) x 4 (N), 32 x 32 each
constexpr int B_LD = BN + 8;  // bf16 elements (pad against bank conflicts)
constexpr int E_LD = 16 + 4;  // fp32 elements of a warp's epilogue buffer
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int E_BYTES = (THREADS / 32) * 16 * E_LD * 4;
constexpr int PIX_BYTES = BM * (8 + 4 + 4);
static_assert(B_BYTES % 128 == 0, "tile alignment");

// Shared memory, in order: two wp slices, the epilogue buffers, the pixel
// table, the 9 x Cin fp32 taps, the BM x a_ld bf16 depthwise result.
struct Layout {
  int kpad;   // Cin rounded up to BK
  int a_ld;   // row stride of the depthwise result, bf16 elements
  int wd_off, a_off, bytes;
  __host__ __device__ explicit Layout(int cin) {
    kpad = (cin + BK - 1) / BK * BK;
    a_ld = kpad + 8;
    wd_off = 2 * B_BYTES + E_BYTES + PIX_BYTES;
    a_off = (wd_off + 9 * cin * 4 + 127) / 128 * 128;
    bytes = a_off + BM * a_ld * 2;
  }
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// V consecutive bf16, loaded raw (or zero when !ok), widened on use
template <int V>
struct Raw;

template <>
struct Raw<8> {
  uint4 r;
  __device__ __forceinline__ void load(const bf16* p, bool ok) {
    r = ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ float get(int i) const {
    const unsigned w = i < 2 ? r.x : (i < 4 ? r.y : (i < 6 ? r.z : r.w));
    return __uint_as_float(i % 2 ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Raw<1> {
  unsigned short r;
  __device__ __forceinline__ void load(const bf16* p, bool ok) {
    r = ok ? __ldg(reinterpret_cast<const unsigned short*>(p)) : 0;
  }
  __device__ __forceinline__ float get(int) const {
    return __uint_as_float(static_cast<unsigned>(r) << 16);
  }
};

// V fp32 -> V consecutive bf16 (round to nearest even)
template <int V>
__device__ __forceinline__ void store_bf16(bf16* p, const float* v) {
  if constexpr (V == 8) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

// One BK x BN slice of wp (rows k0.., columns n0..) into a buffer; rows or
// columns past the ends are zero. V = 8: 16-byte cp.async copies (committed
// as one group); V = 1: plain loads.
template <int V>
__device__ __forceinline__ void load_wp_slice(bf16* dst,
                                              const bf16* __restrict__ wp,
                                              int k0, int n0, int Cin,
                                              int Cout, int tid) {
  if constexpr (V == 8) {
    for (int i = tid; i < BK * BN / 8; i += THREADS) {
      const int row = i / (BN / 8), col = (i % (BN / 8)) * 8;
      const int k = k0 + row, n = n0 + col;
      bf16* d = dst + row * B_LD + col;
      if (k < Cin && n < Cout)
        cp_async16(d, wp + (int64_t)k * Cout + n);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int row = i / BN, col = i % BN;
      const int k = k0 + row, n = n0 + col;
      dst[row * B_LD + col] = (k < Cin && n < Cout)
                                  ? wp[(int64_t)k * Cout + n]
                                  : __float2bfloat16(0.0f);
    }
  }
  cp_async_commit();
}

template <int V>
__global__ void __launch_bounds__(THREADS)
fused_sepconv_kernel(const bf16* __restrict__ x, const float* __restrict__ wd,
                     const bf16* __restrict__ wp,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const bf16* __restrict__ residual, bf16* __restrict__ out,
                     int B, int H, int W, int Cin, int Cout, int d, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(Cin);
  bf16* b_s[2] = {reinterpret_cast<bf16*>(smem),
                  reinterpret_cast<bf16*>(smem + B_BYTES)};
  float* e_s = reinterpret_cast<float*>(smem + 2 * B_BYTES);
  int64_t* pix_p =
      reinterpret_cast<int64_t*>(smem + 2 * B_BYTES + E_BYTES);
  int* pix_h = reinterpret_cast<int*>(pix_p + BM);
  int* pix_w = pix_h + BM;
  float* wd_s = reinterpret_cast<float*>(smem + L.wd_off);  // 9 x Cin
  bf16* a_s = reinterpret_cast<bf16*>(smem + L.a_off);      // BM x a_ld

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int warp_m = warp / 4;  // 0..1
  const int warp_n = warp % 4;  // 0..3
  const int64_t P = (int64_t)B * H * W;
  const int64_t p0 = (int64_t)blockIdx.x * BM;

  // the first wp slice starts loading now, under the depthwise phase
  load_wp_slice<V>(b_s[0], wp, 0, 0, Cin, Cout, tid);
  for (int i = tid; i < BM; i += THREADS) {
    const int64_t p = p0 + i;
    pix_p[i] = p < P ? p : -1;
    pix_w[i] = p < P ? (int)(p % W) : 0;
    pix_h[i] = p < P ? (int)((p / W) % H) : 0;
  }
  for (int i = tid; i < 9 * Cin; i += THREADS) wd_s[i] = __ldg(wd + i);
  __syncthreads();

  // 1. depthwise result -> a_s (bf16); columns Cin..kpad are zero. Column
  //    planes are combined as the TPU kernel combines them:
  //    plane[jj] = sum_t x[t, jj] * wd[t, jj]; acc = plane[1] + plane[0]
  //    + plane[2].
  {
    const int per_row = L.kpad / V;
    const int units = BM * per_row;  // (pixel, V channels)
    constexpr int PAIR = 2;          // units whose loads are in flight
    for (int u0 = tid; u0 < units; u0 += PAIR * THREADS) {
      Raw<V> taps[PAIR][9];
      int row[PAIR], c[PAIR];
      bool live[PAIR];
#pragma unroll
      for (int q = 0; q < PAIR; ++q) {
        const int u = u0 + q * THREADS;
        row[q] = (u < units ? u : 0) / per_row;
        c[q] = ((u < units ? u : 0) % per_row) * V;
        const int64_t p = pix_p[row[q]];
        live[q] = u < units && p >= 0 && c[q] < Cin;  // V=8: Cin % 8 == 0
        const int h = pix_h[row[q]], w = pix_w[row[q]];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            const int hh = h + (t - 1) * d, ww = w + (jj - 1) * d;
            const bool ok =
                live[q] && hh >= 0 && hh < H && ww >= 0 && ww < W;
            const int64_t qp = p + (int64_t)(t - 1) * d * W + (jj - 1) * d;
            taps[q][t * 3 + jj].load(x + qp * Cin + c[q], ok);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < PAIR; ++q) {
        if (u0 + q * THREADS >= units) continue;
        float acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          if (!live[q]) break;  // dead units store zeros
          const int jj = s == 0 ? 1 : (s == 1 ? 0 : 2);
          float plane[V];
#pragma unroll
          for (int i = 0; i < V; ++i) plane[i] = 0.0f;
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const float* wt = wd_s + (t * 3 + jj) * Cin + c[q];
#pragma unroll
            for (int i = 0; i < V; ++i)
              plane[i] += taps[q][t * 3 + jj].get(i) * wt[i];
          }
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += plane[i];
        }
        store_bf16<V>(a_s + row[q] * L.a_ld + c[q], acc);
      }
    }
  }

  // 2. pointwise, one BN-wide tile of output channels at a time
  const int kslices = L.kpad / BK;
  const int ntiles = (Cout + BN - 1) / BN;
  const int total = ntiles * kslices;  // wp slices, in (tile, k) order
  float* ep = e_s + warp * 16 * E_LD;
  const int r = lane / 2;           // epilogue: fragment row of this lane
  const int half = (lane % 2) * 8;  // and the first of its 8 columns
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int it = 0; it < total; ++it) {
    const int nt = it / kslices, ks = it % kslices;
    if (ks == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) wmma::fill_fragment(acc[m][n], 0.0f);
    }
    if (it + 1 < total) {  // the next slice loads while this one multiplies
      const int nn = (it + 1) / kslices, kn = (it + 1) % kslices;
      load_wp_slice<V>(b_s[(it + 1) % 2], wp, kn * BK, nn * BN, Cin, Cout,
                       tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice `it` (and, at it == 0, the a_s tile) is ready
    const bf16* bs = b_s[it % 2];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int m = 0; m < 2; ++m)
        wmma::load_matrix_sync(
            fa[m], a_s + (warp_m * 32 + m * 16) * L.a_ld + ks * BK + kk,
            L.a_ld);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        wmma::load_matrix_sync(fb, bs + kk * B_LD + warp_n * 32 + n * 16,
                               B_LD);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          wmma::mma_sync(acc[m][n], fa[m], fb, acc[m][n]);
      }
    }
    __syncthreads();  // buffer it % 2 is free for slice it + 2

    if (ks == kslices - 1) {
      // epilogue: folded BN affine [+ residual] [ReLU] in fp32, one store
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int64_t p = pix_p[warp_m * 32 + m * 16 + r];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          wmma::store_matrix_sync(ep, acc[m][n], E_LD, wmma::mem_row_major);
          __syncwarp();
          const int col = nt * BN + warp_n * 32 + n * 16 + half;
          if (p >= 0 && col < Cout) {
            float y[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) y[i] = ep[r * E_LD + half + i];
            if constexpr (V == 8) {  // Cout % 8 == 0: all 8 columns exist
              Raw<8> res;
              res.load(residual + p * Cout + col, residual != nullptr);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                y[i] = y[i] * __ldg(scale + col + i) +
                       __ldg(bias + col + i) + res.get(i);
                if (relu) y[i] = fmaxf(y[i], 0.0f);
              }
              store_bf16<8>(out + p * Cout + col, y);
            } else {
              for (int i = 0; i < 8 && col + i < Cout; ++i) {
                float v =
                    y[i] * __ldg(scale + col + i) + __ldg(bias + col + i);
                if (residual != nullptr)
                  v += __bfloat162float(residual[p * Cout + col + i]);
                if (relu) v = fmaxf(v, 0.0f);
                out[p * Cout + col + i] = __float2bfloat16(v);
              }
            }
          }
          __syncwarp();  // the buffer is reused by the next fragment
        }
      }
    }
  }
}

template <int V>
cudaError_t launch(const void* x, const void* wd, const void* wp,
                   const void* scale, const void* bias, const void* residual,
                   void* out, int B, int H, int W, int Cin, int Cout, int d,
                   int relu, cudaStream_t stream) {
  const Layout L(Cin);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sepconv_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L.bytes);
  if (err != cudaSuccess) return err;
  const int64_t P = (int64_t)B * H * W;
  fused_sepconv_kernel<V>
      <<<(unsigned)((P + BM - 1) / BM), THREADS, L.bytes, stream>>>(
          static_cast<const bf16*>(x), static_cast<const float*>(wd),
          static_cast<const bf16*>(wp), static_cast<const float*>(scale),
          static_cast<const float*>(bias),
          static_cast<const bf16*>(residual), static_cast<bf16*>(out), B, H,
          W, Cin, Cout, d, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int xdt_fused_sepconv_wmma(const void* x, const void* wd,
                                      const void* wp, const void* scale,
                                      const void* bias, const void* residual,
                                      void* out, int B, int H, int W, int Cin,
                                      int Cout, int dilation, int relu,
                                      void* stream) {
  const uintptr_t addr =
      (uintptr_t)x | (uintptr_t)wp | (uintptr_t)residual | (uintptr_t)out;
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && addr % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<8>(x, wd, wp, scale, bias, residual, out, B, H,
                               W, Cin, Cout, dilation, relu, s)
                   : launch<1>(x, wd, wp, scale, bias, residual, out, B, H,
                               W, Cin, Cout, dilation, relu, s));
}
