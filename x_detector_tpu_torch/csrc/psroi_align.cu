// PSROIAlign forward on Hopper (sm_90a).
//
// Replaces: x_detector_tpu/ops/pallas/psroi_align_kernel.py::_psroi_kernel
// (the TPU kernel, driven by _psroi_pallas_raw / psroi_align_pallas).
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
// Design: the direct gather form. One thread per output element
// (b, r, i, j, c) with c fastest, so a warp reads C consecutive channels of
// one pixel per tap. The TPU's slab / selector-matmul layout exists only to
// feed the MXU and is not carried over. Features are bf16 or fp32 and
// accumulate in fp32; the output is fp32.
//
// What bounds it: at config 3 (B=16, R=512, k=7, C=10, 50x50x490 maps) the
// output is 16 MB of fp32 and each image's thin map (2.45 MB in bf16) sits
// in the 50 MB L2, so the bound is L2 gather traffic: S*S*4 = 16 reads per
// output element. It is small next to the backbone.

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
