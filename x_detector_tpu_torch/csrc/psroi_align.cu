// PSROIAlign forward and backward on Hopper (sm_90a).
//
// Replaces: x_detector_tpu/ops/pallas/psroi_align_kernel.py::_psroi_kernel
// (the TPU kernel, driven by _psroi_pallas_raw / psroi_align_pallas) and its
// custom_vjp backward _bwd (the transposed contractions, in XLA there).
//
// What it computes: for roi r and bin (i, j), the mean over S x S samples of
// a bilinear read from channel group g = i*k + j of NHWC features. Sample
// coordinates follow x_detector_tpu/ops/psroi_align.py:41-55: for sample s
// of cell i, norm = lo + (i + (s + 0.5)/S) * (hi - lo)/k, then
// px = norm * extent - 0.5, clamped to [0, extent - 1]; the four taps are
// floor(px) and floor(px) + 1 clamped to the edge. That clamp makes the
// four-tap read equal to the triangular weights relu(1 - |p - px|) of
// _interp_weights (psroi_align.py:99) that the TPU kernel contracts.
//
// Forward design: the direct gather form. One thread per output element
// (b, r, i, j, c) with c fastest, so a warp reads C consecutive channels of
// one pixel per tap. The TPU's slab / selector-matmul layout exists only to
// feed the MXU and is not carried over. Features are bf16 or fp32 and
// accumulate in fp32; the output is fp32.
//
// What bounds the forward: at config 3 (B=16, R=512, k=7, C=10, 50x50x490
// maps) the output is 16 MB of fp32 and each image's thin map (2.45 MB in
// bf16) sits in the 50 MB L2, so the bound is L2 gather traffic: S*S*4 = 16
// reads per output element. It is small next to the backbone.
//
// Backward: dfeat[b,p,q,(i,j),c] = sum_r wy[r,i,p] * wx[r,j,q] * g[b,r,i,j,c]
// / S^2, with wy[r,i,p] = sum_s relu(1 - |p - y_s|) (the same weights as the
// forward). It must be deterministic and free of atomic adds (the reference's
// own CUDA op scattered with them; DESIGN.md sections 3 and 8), so it
// gathers by destination: a block owns 256 consecutive pixels of one image
// and one channel group (i, j), one thread per pixel with its C sums in
// registers. The block walks the rois in index order, 256 at a time: each
// thread computes one roi's S row and S column sample coordinates, a ballot
// and a prefix count compact the rois whose band can touch the block's
// pixels into shared memory, in order, with their C upstream gradients; then
// every thread walks that list and adds wy * (g * wx) where both weights are
// non-zero. Every output element is written once, by one thread, after a
// sum in a fixed order: the same inputs give the same bits.
//
// What bounds the backward: the band tests, not the arithmetic. At config 4
// (B=16, R=1000, 50x50 maps, k=7) there are 16 * 49 * 10 blocks, each testing
// all 1000 rois once (8e6 tests) and walking the few hundred that hit its
// rows; the useful work is ~1e8 multiply-adds. The dense separable form (one
// [H, R] x [R, k*W*C] product per image and row bin, ~40 GFLOP at config 4)
// was the alternative; it does ~400x the useful work, so the gather was
// chosen.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Sample coordinate along one axis, as _sample_coords computes it.
__device__ __forceinline__ float sample_coord(float lo, float hi, int cell,
                                              int s, int grid, int samples,
                                              int extent) {
  float span = (hi - lo) / (float)grid;
  float sub = ((float)s + 0.5f) / (float)samples;
  float norm = lo + ((float)cell + sub) * span;
  float px = norm * (float)extent - 0.5f;
  return fminf(fmaxf(px, 0.0f), (float)(extent - 1));
}

template <typename T>
__global__ void psroi_align_fwd_kernel(const T* __restrict__ feat,
                                       const float* __restrict__ rois,
                                       float* __restrict__ out, int B, int H,
                                       int W, int R, int grid, int C,
                                       int samples) {
  const int64_t total = (int64_t)B * R * grid * grid * C;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  int64_t t = idx / C;
  const int j = (int)(t % grid);
  t /= grid;
  const int i = (int)(t % grid);
  t /= grid;
  const int r = (int)(t % R);
  const int b = (int)(t / R);

  const float* roi = rois + ((int64_t)b * R + r) * 4;
  const float ymin = roi[0], xmin = roi[1], ymax = roi[2], xmax = roi[3];
  const int kkc = grid * grid * C;
  const T* base = feat + (int64_t)b * H * W * kkc + (i * grid + j) * C + c;

  float acc = 0.0f;
  for (int sy = 0; sy < samples; ++sy) {
    const float y = sample_coord(ymin, ymax, i, sy, grid, samples, H);
    const float y0f = fminf(fmaxf(floorf(y), 0.0f), (float)(H - 1));
    const float fy = y - y0f;
    const int y0 = (int)y0f;
    const int y1 = min(y0 + 1, H - 1);
    for (int sx = 0; sx < samples; ++sx) {
      const float x = sample_coord(xmin, xmax, j, sx, grid, samples, W);
      const float x0f = fminf(fmaxf(floorf(x), 0.0f), (float)(W - 1));
      const float fx = x - x0f;
      const int x0 = (int)x0f;
      const int x1 = min(x0 + 1, W - 1);
      const float v00 = load_f(base + ((int64_t)y0 * W + x0) * kkc);
      const float v01 = load_f(base + ((int64_t)y0 * W + x1) * kkc);
      const float v10 = load_f(base + ((int64_t)y1 * W + x0) * kkc);
      const float v11 = load_f(base + ((int64_t)y1 * W + x1) * kkc);
      acc += (1.0f - fy) * (1.0f - fx) * v00 + (1.0f - fy) * fx * v01 +
             fy * (1.0f - fx) * v10 + fy * fx * v11;
    }
  }
  out[idx] = acc / (float)(samples * samples);
}

template <typename T>
__device__ __forceinline__ void store_f(T* p, float v);
template <>
__device__ __forceinline__ void store_f<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store_f<__nv_bfloat16>(__nv_bfloat16* p,
                                                       float v) {
  *p = __float2bfloat16(v);    // round to nearest even, as astype rounds
}

constexpr int kBwdThreads = 256;   // pixels per block, rois per chunk
constexpr int kMaxSamples = 4;

// sum_s relu(1 - |p - coord_s|): _interp_weights for one pixel, summed over
// the samples in order.
__device__ __forceinline__ float tri_weight(float p,
                                            float (*coords)[kBwdThreads],
                                            int n, int samples) {
  float w = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s)
    if (s < samples) w += fmaxf(0.0f, 1.0f - fabsf(p - coords[s][n]));
  return w;
}

// CT: C rounded up to a compile-time size for the per-thread sums.
template <typename T, int CT>
__global__ void __launch_bounds__(kBwdThreads)
    psroi_align_bwd_kernel(const float* __restrict__ grad,
                           const float* __restrict__ rois,
                           T* __restrict__ dfeat, int H, int W, int R,
                           int grid, int C, int samples) {
  __shared__ float s_y[kMaxSamples][kBwdThreads];
  __shared__ float s_x[kMaxSamples][kBwdThreads];
  __shared__ float s_g[CT][kBwdThreads];
  __shared__ int s_count[kBwdThreads / 32];

  const int b = blockIdx.z;
  const int bin = blockIdx.y;                      // g = i * grid + j
  const int i = bin / grid, j = bin % grid;
  const int npix = H * W;
  const int pix0 = blockIdx.x * kBwdThreads;
  const int pix = pix0 + threadIdx.x;
  const bool live = pix < npix;
  const float p = (float)(pix / W), q = (float)(pix % W);
  // the rows and columns that this block's pixels span
  const int last = min(pix0 + kBwdThreads, npix) - 1;
  const int row_lo = pix0 / W, row_hi = last / W;
  const int col_lo = row_lo == row_hi ? pix0 % W : 0;
  const int col_hi = row_lo == row_hi ? last % W : W - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kk = grid * grid;

  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] = 0.0f;

  for (int r0 = 0; r0 < R; r0 += kBwdThreads) {
    const int r = r0 + threadIdx.x;
    float ys[kMaxSamples], xs[kMaxSamples];
    bool hit = false;
    if (r < R) {
      const float* roi = rois + ((int64_t)b * R + r) * 4;
      const float ymin = roi[0], xmin = roi[1], ymax = roi[2], xmax = roi[3];
      float ylo = 3.0e38f, yhi = -3.0e38f, xlo = 3.0e38f, xhi = -3.0e38f;
#pragma unroll
      for (int s = 0; s < kMaxSamples; ++s) {
        if (s < samples) {
          ys[s] = sample_coord(ymin, ymax, i, s, grid, samples, H);
          xs[s] = sample_coord(xmin, xmax, j, s, grid, samples, W);
          ylo = fminf(ylo, ys[s]);
          yhi = fmaxf(yhi, ys[s]);
          xlo = fminf(xlo, xs[s]);
          xhi = fmaxf(xhi, xs[s]);
        }
      }
      // pixel p has a non-zero weight iff |p - y_s| < 1 for some sample
      hit = yhi > (float)row_lo - 1.0f && ylo < (float)row_hi + 1.0f &&
            xhi > (float)col_lo - 1.0f && xlo < (float)col_hi + 1.0f;
    }
    // compact the hits into shared memory, keeping roi order
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kBwdThreads / 32; ++w) {
      const int n = s_count[w];
      offset += w < warp ? n : 0;
      total += n;
    }
    if (hit) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
      for (int s = 0; s < kMaxSamples; ++s) {
        if (s < samples) {
          s_y[s][pos] = ys[s];
          s_x[s][pos] = xs[s];
        }
      }
      const float* g = grad + (((int64_t)b * R + r) * kk + bin) * C;
#pragma unroll
      for (int c = 0; c < CT; ++c)
        if (c < C) s_g[c][pos] = g[c];
    }
    __syncthreads();
    if (live) {
      for (int n = 0; n < total; ++n) {
        const float wy = tri_weight(p, s_y, n, samples);
        const float wx = tri_weight(q, s_x, n, samples);
        if (wy != 0.0f && wx != 0.0f) {
#pragma unroll
          for (int c = 0; c < CT; ++c)
            if (c < C) acc[c] = fmaf(wy, s_g[c][n] * wx, acc[c]);
        }
      }
    }
    __syncthreads();           // the next chunk overwrites shared memory
  }
  if (live) {
    const float inv = 1.0f / (float)(samples * samples);
    T* out = dfeat + ((int64_t)b * npix + pix) * kk * C + bin * C;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      if (c < C) store_f<T>(out + c, acc[c] * inv);
  }
}

template <typename T>
int launch_bwd(const float* grad, const float* rois, T* dfeat, int B, int H,
               int W, int R, int grid, int C, int samples, cudaStream_t s) {
  const dim3 blocks((unsigned)((H * W + kBwdThreads - 1) / kBwdThreads),
                    (unsigned)(grid * grid), (unsigned)B);
#define XDT_PSROI_BWD(CT)                                                  \
  if (C <= CT) {                                                           \
    psroi_align_bwd_kernel<T, CT><<<blocks, kBwdThreads, 0, s>>>(          \
        grad, rois, dfeat, H, W, R, grid, C, samples);                     \
    return (int)cudaGetLastError();                                        \
  }
  XDT_PSROI_BWD(4)
  XDT_PSROI_BWD(8)
  XDT_PSROI_BWD(16)
  XDT_PSROI_BWD(32)
#undef XDT_PSROI_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int xdt_psroi_align_fwd(const void* features, const void* rois,
                                   void* out, int features_are_bf16, int B,
                                   int H, int W, int R, int grid, int C,
                                   int samples, void* stream) {
  const int64_t total = (int64_t)B * R * grid * grid * C;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (features_are_bf16) {
    psroi_align_fwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(features),
        static_cast<const float*>(rois), static_cast<float*>(out), B, H, W, R,
        grid, C, samples);
  } else {
    psroi_align_fwd_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(features), static_cast<const float*>(rois),
        static_cast<float*>(out), B, H, W, R, grid, C, samples);
  }
  return (int)cudaGetLastError();
}

// grad [B, R, k, k, C] fp32 and rois [B, R, 4] fp32 -> dfeat [B, H, W, k*k*C]
// in bf16 or fp32. Needs C <= 32 and samples <= 4 (the wrapper checks).
extern "C" int xdt_psroi_align_bwd(const void* grad, const void* rois,
                                   void* dfeat, int dfeat_is_bf16, int B,
                                   int H, int W, int R, int grid, int C,
                                   int samples, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grad);
  const float* r = static_cast<const float*>(rois);
  if (C > 32 || samples > kMaxSamples) return (int)cudaErrorInvalidValue;
  if (dfeat_is_bf16)
    return launch_bwd(g, r, static_cast<__nv_bfloat16*>(dfeat), B, H, W, R,
                      grid, C, samples, s);
  return launch_bwd(g, r, static_cast<float*>(dfeat), B, H, W, R, grid, C,
                    samples, s);
}
