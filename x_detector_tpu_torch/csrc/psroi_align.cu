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
// Backward: dfeat[b,p,q,(i,j),c] = (1/S^2) sum_r wy[r,i,p] * (g[b,r,i,j,c] *
// wx[r,j,q]), with wy[r,i,p] = sum_s relu(1 - |p - y_s|) (the same weights
// as the forward). It replaces the JAX package's custom_vjp backward _bwd
// (psroi_align_kernel.py:169, two einsums in XLA there). It must be
// deterministic and free of atomic adds (the reference's own CUDA op
// scattered with them; DESIGN.md sections 3 and 8), so it gathers by
// destination. The first design of this kernel gave each block 256
// flattened pixels and one bin: at 50-wide maps that is five whole rows, so
// only the y band culled, every block re-tested all R rois, every thread
// walked every listed roi, and each thread stored its C sums at a stride of
// k*k*C elements (1.01 ms at config 4 on an H100).
//
// What bounds it: not HBM (config 4, B=16, R=1000, 50x50 maps, k=7, C=10,
// S=2: 31.4 MB of fp32 gradient in and 39.2 MB of bf16 map out, 0.021 ms)
// but matching rois to pixels: each (roi, bin) reaches a band of ~3 x 3
// pixels, ~7e7 multiply-adds in all, and the work of finding them, done
// with one block of 16 warps an SM (the tile's sums take the registers),
// is latency-bound.
//
// Design (the host plans the launch: ops/psroi_align.py::plan_backward):
//   * A pre-pass, one warp per roi, reads its gradient row once. For a row
//     that holds a value other than +-0 (NaN and Inf count) it writes the
//     least and greatest sample coordinate along y and x (the first and the
//     last samples bound the rest); for a zero row, an empty interval. In a
//     train step OHEM keeps 256 of 1000 rois per image and the other rows
//     are exactly zero; adding +-0 * w to an fp32 sum that starts at +0
//     leaves its bits as they are, so dropping them changes no bit.
//   * A block owns a 5 x 10 tile of one image's pixels and every channel of
//     them (k*k*C; beyond 512, further blocks along grid.y), one thread per
//     channel with the tile's TH*TW sums in registers. Each output element
//     is summed by one thread, in roi order, and written once, zeros
//     included. No atomics: the same inputs give the same bits.
//   * Culling, once per tile: each thread tests one roi's interval against
//     the tile widened by one pixel (a 16-byte load, four compares), and a
//     ballot and a prefix count append the hits to a list in shared memory,
//     in roi order. A full list is consumed and refilled (rois covering
//     the whole map fill it on every tile).
//   * Consuming the list: one lane per (roi, axis, cell) writes that cell's
//     weights over the tile's rows or columns into shared memory (rows
//     padded to 4 floats, for 16-byte loads), and a warp ballot gives each
//     roi its masks of row and column bins with a non-zero weight on the
//     tile. Then each warp takes 32 list entries at a time, lists in order
//     those that reach one of its bins, and every thread adds each such roi
//     whose masks hold its own bin: 4 gradient loads in flight, then
//     wy[p] * (g * wx[q]) over the whole tile (a branch to skip zero rows
//     cost more than the products it saved).
//   * Sample coordinates and weights round each operation as the plain
//     version does in PyTorch (no contraction into an fma), so the weights
//     are the plain version's.
//   * Stores: for each pixel a warp writes 32 neighbouring channels, so a
//     tile row of the map goes out in contiguous runs (staging it through
//     shared memory in 4-byte words, or streaming stores, measured no
//     faster).
//
// Switches for psroi_bwd_variants.py's measurements, each giving wrong
// results on purpose: XDT_BWD_PREPARE_ONLY (the pre-pass alone),
// XDT_BWD_NO_GRAD_LOAD (1.0 for every gradient), XDT_BWD_NO_ACCUMULATE (the
// gradients are loaded and summed, the weights are not applied) and
// XDT_BWD_CULL_ONLY (the list is built and never consumed).

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

constexpr int kMaxSamples = 4;
constexpr int kMaxGrid = 32;        // bins per axis: one bit each in a mask
constexpr int kMaxBwdThreads = 512;
// The pixel tile, ops/psroi_align.py's BACKWARD_TILE: 5 x 10 covers 50 x 50
// maps with no dead pixel, and its 50 sums a thread leave one block of 512
// an SM (5 x 5 with two blocks measured 8% faster on a dense gradient and
// 11% slower on a train step's, 10 x 5 slower on both).
constexpr int kTileH = 5, kTileW = 10;
constexpr int kPrefetch = 4;        // gradient loads in flight per thread
constexpr int kPrepThreads = 256;
// Shared memory of the tile kernel, mirrored by ops/psroi_align.py's
// backward_smem_bytes: 32 warp counts, each warp's 32-entry work list, then
// per list entry its header (roi index, row and column bin masks) and its
// weights over the tile's rows and columns, each row padded to 4 floats.
constexpr int kCountBytes = 32 * 4;
constexpr int kWarpListBytes = 32 * 32 * 4;
constexpr int kEntryBytes = 16;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ constexpr int bwd_smem_bytes(int th, int tw, int grid,
                                                 int cap) {
  return kCountBytes + kWarpListBytes +
         cap * (kEntryBytes + 4 * grid * (pad4(th) + pad4(tw)));
}

// The sample coordinate as _sample_coords computes it in PyTorch, one
// rounding per operation and no fma contraction: span = (hi - lo) / grid
// and sub = (s + 0.5) / samples, each divided once by the caller.
__device__ __forceinline__ float sample_coord_rn(float lo, float span,
                                                 int cell, float sub,
                                                 int extent) {
  const float norm =
      __fadd_rn(lo, __fmul_rn(__fadd_rn((float)cell, sub), span));
  const float px = __fsub_rn(__fmul_rn(norm, (float)extent), 0.5f);
  return fminf(fmaxf(px, 0.0f), (float)(extent - 1));
}

__device__ __forceinline__ float cell_span(float lo, float hi, int grid) {
  return __fdiv_rn(__fsub_rn(hi, lo), (float)grid);
}

__device__ __forceinline__ void sample_subs(float (&subs)[kMaxSamples],
                                            int samples) {
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s)
    subs[s] = __fdiv_rn((float)s + 0.5f, (float)samples);
}

// _interp_weights at one pixel: sum_s relu(1 - |pix - c_s|), in order.
__device__ __forceinline__ float interp_weight(int pix, const float* cs,
                                               int samples) {
  float w = 0.0f;
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s)
    if (s < samples)
      w = __fadd_rn(w, fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(
                                                 (float)pix, cs[s])))));
  return w;
}

// The pre-pass, one warp per roi: ext[row] = (the least and the greatest
// sample coordinate along y, then along x) of a roi whose gradient row
// (row_len floats) holds a value that is not +-0 (NaN and Inf count), and
// an empty interval for a zero row. The coordinates of a roi's samples are
// monotone in (cell, sample), so its first and last samples bound them all.
__global__ void __launch_bounds__(kPrepThreads)
    psroi_align_bwd_prepare(const float* __restrict__ grad,
                            const float* __restrict__ rois,
                            float4* __restrict__ ext, int rows, int row_len,
                            int H, int W, int grid, int samples) {
  const int64_t row = ((int64_t)blockIdx.x * kPrepThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                       // the whole warp leaves
  const float* g = grad + row * row_len;
  bool nonzero = false;
#pragma unroll 4
  for (int e = lane; e < row_len; e += 32) nonzero |= __ldg(g + e) != 0.0f;
  const bool any = __any_sync(0xffffffffu, nonzero);
  if (lane != 0) return;
  float4 out = make_float4(INFINITY, -INFINITY, INFINITY, -INFINITY);
  if (any) {
    const float4 box = *reinterpret_cast<const float4*>(rois + row * 4);
    float subs[kMaxSamples];
    sample_subs(subs, samples);
    const float sy = cell_span(box.x, box.z, grid);
    const float sx = cell_span(box.y, box.w, grid);
    const float y0 = sample_coord_rn(box.x, sy, 0, subs[0], H);
    const float y1 =
        sample_coord_rn(box.x, sy, grid - 1, subs[samples - 1], H);
    const float x0 = sample_coord_rn(box.y, sx, 0, subs[0], W);
    const float x1 =
        sample_coord_rn(box.y, sx, grid - 1, subs[samples - 1], W);
    out = make_float4(fminf(y0, y1), fmaxf(y0, y1), fminf(x0, x1),
                      fmaxf(x0, x1));
  }
  ext[row] = out;
}

template <int TH, int TW>
struct TileList {
  static constexpr int kTHP = pad4(TH), kTWP = pad4(TW);
  int* count;       // [32] listed rois per warp, for the prefix count
  int* work;        // [32 warps][32] a warp's entries to add, in order
  int4* head;       // [cap] roi index, row bins and column bins whose
                    // weights reach the tile, unused
  float* wy;        // [cap][grid][kTHP]
  float* wx;        // [cap][grid][kTWP]
};

// The thread's place: whether its channel exists, its bin (i, j), and the
// bins of its warp's channels: how many, and (i, j) of the first.
struct Lanes {
  bool live;
  int bi, bj;
  int wbins, wi, wj;
};

// Consume list entries [0, n). First the weights: one lane per (entry,
// axis, cell) writes that cell's weights over the tile's rows (or
// columns), and a ballot gives each entry its masks of cells with a
// non-zero one. Then each warp takes 32 entries at a time, lists those that
// reach one of its bins, and every thread adds those that reach its own
// bin to its sums in list order, kPrefetch gradient loads in flight.
template <int TH, int TW>
__device__ __forceinline__ void consume(const TileList<TH, TW>& L, int n,
                                       float (&acc)[TH][TW],
                                       const float* __restrict__ rois_b,
                                       const float* __restrict__ g_col,
                                       int64_t g_stride, const Lanes& me,
                                       int grid, int samples,
                                       const float* subs, int H, int W,
                                       int row0, int col0) {
  constexpr int kTHP = TileList<TH, TW>::kTHP, kTWP = TileList<TH, TW>::kTWP;
  // one lane per (entry, axis, cell); a warp holds 32 / slots (entry,
  // axis) pairs, and its ballot gives each pair's mask of cells
  const int lane = threadIdx.x & 31;
  const int slots = grid <= 8 ? 8 : grid <= 16 ? 16 : 32;
  for (int base = threadIdx.x - lane; base < 2 * n * slots;
       base += blockDim.x) {
    const int item = base + lane, pair = item / slots;
    const int cell = item - pair * slots, e = pair >> 1;
    const bool along_x = pair & 1, valid = pair < 2 * n && cell < grid;
    bool any = false;
    if (valid) {
      const float4 box = *reinterpret_cast<const float4*>(
          rois_b + (int64_t)L.head[e].x * 4);
      const float lo = along_x ? box.y : box.x;
      const float span = cell_span(lo, along_x ? box.w : box.z, grid);
      const int extent = along_x ? W : H, first = along_x ? col0 : row0;
      const int size = along_x ? TW : TH, padded = along_x ? kTWP : kTHP;
      float* out = (along_x ? L.wx : L.wy) + (e * grid + cell) * padded;
      float cs[kMaxSamples];
#pragma unroll
      for (int s = 0; s < kMaxSamples; ++s)
        if (s < samples)
          cs[s] = sample_coord_rn(lo, span, cell, subs[s], extent);
#pragma unroll
      for (int p = 0; p < (TH > TW ? kTHP : kTWP); ++p) {
        if (p >= padded) break;
        const float w = p < size && first + p < extent
                            ? interp_weight(first + p, cs, samples)
                            : 0.0f;
        out[p] = w;
        any |= w != 0.0f;
      }
    }
    const unsigned bits = __ballot_sync(0xffffffffu, any);
    if (valid && cell == 0)
      reinterpret_cast<int*>(L.head + e)[1 + along_x] =
          (int)((bits >> lane) & (grid == 32 ? ~0u : (1u << grid) - 1u));
  }
  __syncthreads();
  int* work = L.work + (threadIdx.x >> 5) * 32;
  for (int n0 = 0; n0 < n; n0 += 32) {
    // the entries among these 32 that reach a bin of this warp, in order
    const int4 h = n0 + lane < n ? L.head[n0 + lane] : make_int4(0, 0, 0, 0);
    bool reach = false;
    for (int k = 0, i = me.wi, j = me.wj; k < me.wbins; ++k) {
      reach |= ((h.y >> i) & (h.z >> j) & 1) != 0;
      if (++j == grid) j = 0, ++i;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, reach);
    if (reach) work[__popc(ballot & ((1u << lane) - 1u))] = n0 + lane;
    __syncwarp();
    const int todo = __popc(ballot);
    for (int t0 = 0; t0 < todo; t0 += kPrefetch) {
      int pos[kPrefetch];
      float gv[kPrefetch];
      bool act[kPrefetch];
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        pos[u] = t0 + u < todo ? work[t0 + u] : 0;
        const int4 e = L.head[pos[u]];
        act[u] = t0 + u < todo && me.live &&
                 ((e.y >> me.bi) & (e.z >> me.bj) & 1);
#ifdef XDT_BWD_NO_GRAD_LOAD
        gv[u] = act[u] ? 1.0f : 0.0f;
#else
        gv[u] = act[u] ? __ldg(g_col + (int64_t)e.x * g_stride) : 0.0f;
#endif
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        if (!act[u]) continue;
#ifdef XDT_BWD_NO_ACCUMULATE
        acc[0][0] += gv[u];
        continue;
#endif
        const float4* wy4 = reinterpret_cast<const float4*>(
            L.wy + (pos[u] * grid + me.bi) * kTHP);
        const float4* wx4 = reinterpret_cast<const float4*>(
            L.wx + (pos[u] * grid + me.bj) * kTWP);
        float wy[kTHP], gx[kTWP];
#pragma unroll
        for (int v = 0; v < kTHP / 4; ++v) {
          const float4 w4 = wy4[v];
          wy[4 * v] = w4.x, wy[4 * v + 1] = w4.y;
          wy[4 * v + 2] = w4.z, wy[4 * v + 3] = w4.w;
        }
#pragma unroll
        for (int v = 0; v < kTWP / 4; ++v) {
          const float4 w4 = wx4[v];
          gx[4 * v] = __fmul_rn(gv[u], w4.x);
          gx[4 * v + 1] = __fmul_rn(gv[u], w4.y);
          gx[4 * v + 2] = __fmul_rn(gv[u], w4.z);
          gx[4 * v + 3] = __fmul_rn(gv[u], w4.w);
        }
#pragma unroll
        for (int p = 0; p < TH; ++p)
#pragma unroll
          for (int q = 0; q < TW; ++q)
            acc[p][q] = fmaf(wy[p], gx[q], acc[p][q]);
      }
    }
    __syncwarp();              // the warp's work list is rewritten next
  }
  __syncthreads();             // the list is refilled after this
}

// One block: a TH x TW tile of image blockIdx.z (tile blockIdx.x, row-major
// over tiles_w columns of tiles), channels [blockIdx.y * blockDim.x, +
// blockDim.x) of k*k*C, one thread each. ``cap`` list entries fit in the
// dynamic shared memory; the rois are culled min(blockDim.x, cap) at a time;
// both are multiples of 32.
template <typename T, int TH, int TW>
__global__ void __launch_bounds__(kMaxBwdThreads, 1)
    psroi_align_bwd_tile_kernel(const float* __restrict__ grad,
                                const float* __restrict__ rois,
                                const float4* __restrict__ ext,
                                T* __restrict__ dfeat, int H, int W, int R,
                                int grid, int C, int samples, int tiles_w,
                                int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  TileList<TH, TW> L;
  L.count = reinterpret_cast<int*>(smem);
  L.work = L.count + 32;
  L.head = reinterpret_cast<int4*>(L.work + 32 * 32);
  L.wy = reinterpret_cast<float*>(L.head + cap);
  L.wx = L.wy + cap * grid * L.kTHP;

  const int b = blockIdx.z;
  const int row0 = (blockIdx.x / tiles_w) * TH;
  const int col0 = (blockIdx.x % tiles_w) * TW;
  // a roi reaches the tile only if a sample lies in these open intervals
  const float y_lo = (float)row0 - 1.0f, y_hi = (float)min(row0 + TH, H);
  const float x_lo = (float)col0 - 1.0f, x_hi = (float)min(col0 + TW, W);
  const int kkc = grid * grid * C;
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Lanes me;
  me.live = ch < kkc;
  const int bin = me.live ? ch / C : 0;
  me.bi = bin / grid;
  me.bj = bin - me.bi * grid;
  const int ch0 = ch - lane;                     // the warp's first channel
  const int wfirst = min(ch0, kkc - 1) / C;
  me.wbins = min(ch0 + 31, kkc - 1) / C - wfirst + 1;
  me.wi = wfirst / grid;
  me.wj = wfirst - me.wi * grid;
  const float* rois_b = rois + (int64_t)b * R * 4;
  const float* g_col = grad + (int64_t)b * R * kkc + (me.live ? ch : 0);
  float subs[kMaxSamples];
  sample_subs(subs, samples);

  float acc[TH][TW];
#pragma unroll
  for (int p = 0; p < TH; ++p)
#pragma unroll
    for (int q = 0; q < TW; ++q) acc[p][q] = 0.0f;

  const int batch = min((int)blockDim.x, cap);
  int listed = 0;
  for (int r0 = 0; r0 < R; r0 += batch) {
    const int r = r0 + threadIdx.x;
    bool hit = false;
    if (threadIdx.x < batch && r < R) {
      const float4 e = ext[(int64_t)b * R + r];
      hit = e.y > y_lo && e.x < y_hi && e.w > x_lo && e.z < x_hi;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) L.count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int n = L.count[w];
      offset += w < warp ? n : 0;
      total += n;
    }
    if (listed + total > cap) {          // the same on every thread
      consume<TH, TW>(L, listed, acc, rois_b, g_col, kkc, me, grid, samples,
                      subs, H, W, row0, col0);
      listed = 0;
    }
    if (hit)
      L.head[listed + offset + __popc(ballot & ((1u << lane) - 1u))] =
          make_int4(r, 0, 0, 0);
    listed += total;
    __syncthreads();           // the list is whole; the counts may be reused
  }
#ifndef XDT_BWD_CULL_ONLY
  if (listed)
    consume<TH, TW>(L, listed, acc, rois_b, g_col, kkc, me, grid, samples,
                    subs, H, W, row0, col0);
#endif

  const float inv = (float)(1.0 / (double)(samples * samples));
  if (me.live) {
#pragma unroll
    for (int p = 0; p < TH; ++p)
#pragma unroll
      for (int q = 0; q < TW; ++q)
        if (row0 + p < H && col0 + q < W)
          store_f<T>(dfeat + (((int64_t)b * H + row0 + p) * W + col0 + q) *
                                 kkc + ch,
                     acc[p][q] * inv);
  }
}

template <typename T>
int launch_tiles(const float* grad, const float* rois, const float4* ext,
                 T* dfeat, int B, int H, int W, int R, int grid, int C,
                 int samples, int threads, int cap, int smem_bytes,
                 cudaStream_t s) {
  if (smem_bytes != bwd_smem_bytes(kTileH, kTileW, grid, cap))
    return (int)cudaErrorInvalidValue;
  auto kernel = psroi_align_bwd_tile_kernel<T, kTileH, kTileW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int passes = (grid * grid * C + threads - 1) / threads;
  const dim3 blocks((unsigned)(tiles_h * tiles_w), (unsigned)passes,
                    (unsigned)B);
  kernel<<<blocks, threads, smem_bytes, s>>>(grad, rois, ext, dfeat, H, W, R,
                                             grid, C, samples, tiles_w, cap);
  return (int)cudaGetLastError();
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
// in bf16 or fp32; ext: [B * R] float4 scratch for the pre-pass. The launch
// plan (threads per block, list capacity, shared memory bytes) comes from
// ops/psroi_align.py::plan_backward. Needs samples <= 4, grid <= 32.
extern "C" int xdt_psroi_align_bwd(const void* grad, const void* rois,
                                   void* dfeat, void* ext, int dfeat_is_bf16,
                                   int B, int H, int W, int R, int grid, int C,
                                   int samples, int threads, int cap,
                                   int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grad);
  const float* r = static_cast<const float*>(rois);
  float4* x = static_cast<float4*>(ext);
  if (samples < 1 || samples > kMaxSamples || grid < 1 || grid > kMaxGrid ||
      threads < 32 || threads > kMaxBwdThreads || threads % 32 || cap < 32 ||
      cap % 32 || R < 1)
    return (int)cudaErrorInvalidValue;
  const int rows = B * R;
  const unsigned prep_blocks =
      (unsigned)(((int64_t)rows * 32 + kPrepThreads - 1) / kPrepThreads);
  psroi_align_bwd_prepare<<<prep_blocks, kPrepThreads, 0, s>>>(
      g, r, x, rows, grid * grid * C, H, W, grid, samples);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#ifdef XDT_BWD_PREPARE_ONLY
  return 0;
#endif
  if (dfeat_is_bf16)
    return launch_tiles(g, r, x, static_cast<__nv_bfloat16*>(dfeat), B, H, W,
                        R, grid, C, samples, threads, cap, smem_bytes, s);
  return launch_tiles(g, r, x, static_cast<float*>(dfeat), B, H, W, R, grid,
                      C, samples, threads, cap, smem_bytes, s);
}
