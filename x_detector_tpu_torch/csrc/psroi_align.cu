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
// Forward: out[b,r,i,j,c] = (1/S^2) sum over its S x S samples of the
// bilinear read of feat[b, :, :, (i*k + j)*C + c]. Features are bf16 or
// fp32 and accumulate in fp32; the output is fp32. The TPU's slab /
// selector-matmul layout exists only to feed the MXU and is not carried
// over: this is the direct gather.
//
// What bounded the first design (one thread an output element; measured
// on an H100): not HBM (39.2 MB of map in and 16 MB
// out at config 3, 0.0165 ms) but issue. Each thread decoded its index with
// 64-bit divisions, and every thread of a roi recomputed the same sample
// coordinates (four IEEE divisions a sample) and 64-bit addresses: with its
// loads switched off it kept 75% of its 0.10 ms, with its coordinates from
// constants 80%.
//
// Design (the host plans the launch: ops/psroi_align.py::plan_forward):
//   * A block owns a run of rois of one image (2 at config 3: ~2 lanes of
//     work a thread of 256; more lanes a thread left a tail of partly
//     filled waves) and first writes their taps to shared memory, one
//     thread a (roi, axis, cell, sample): the element offsets of the two
//     neighbouring rows (or columns) and the weights 1 - f and f. The
//     coordinate is rounded op by op with IEEE division, as the plain
//     version does on the CPU and as the backward does (sample_coord_rn),
//     so the forward and the backward read the same taps. A roi whose table
//     exceeds the shared memory (k*S > 4842) makes its taps in each lane.
//   * The threads walk the block's outputs, c fastest, blockDim.x lanes
//     apart, by loop counters: a thread divides only to find its first lane
//     and its step, in 32 bits. Lane e writes the block's e-th output, so a
//     warp stores 256 contiguous bytes.
//   * Where C is even and the map is aligned to two elements, a lane reads
//     two channels a tap (__nv_bfloat162 or float2) and writes two outputs;
//     else one. The wrapper picks the path from C and data_ptr().
//   * S = 2 (every preset) is fixed at compile time, so a lane's 16 loads
//     unroll and are in flight together; other S loop at run time.
//
// What bounds it now (config 3, on an H100): issue and latency, not HBM
// and not the L2. With its loads switched off it keeps ~60% of its time (the
// walk, the table and the 16 MB of stores); the gather asks for 9.7 M
// 32-byte sectors (310 MB, counted from the rois; ~6.4 bins, each a 20-byte
// run in its own line, per warp load), which at the 0.014 ms the loads add
// would be ~22 TB/s if L1 served none of it. Reading each distinct pixel of
// a bin once (a table of distinct rows and columns with summed weights)
// cost more issue than the reads it saved, and was dropped.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
        gv[u] = act[u] ? __ldg(g_col + (int64_t)e.x * g_stride) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        if (!act[u]) continue;
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
  if (listed)
    consume<TH, TW>(L, listed, acc, rois_b, g_col, kkc, me, grid, samples,
                    subs, H, W, row0, col0);

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

// ---------------------------------------------------------------------------
// The forward kernel
// ---------------------------------------------------------------------------

constexpr int kMaxFwdThreads = 512;

// One sample's bilinear read along one axis: the element offsets of its two
// neighbouring rows (or columns) in the map, and their weights 1 - f and f.
// Its size is mirrored by ops/psroi_align.py's FORWARD_TAP_BYTES.
struct Tap {
  long long o0, o1;
  float w0, w1;
};

// The tap of sample s of cell `cell` along an axis of `extent` pixels that
// lie `stride` elements apart, rounded as the plain version rounds it: the
// coordinate op by op (sample_coord_rn), its floor, clamped neighbour and
// fraction, and 1 - fraction.
__device__ __forceinline__ Tap make_tap(float lo, float hi, int cell, int s,
                                        int grid, int samples, int extent,
                                        long long stride) {
  const float p = sample_coord_rn(lo, cell_span(lo, hi, grid), cell,
                                  __fdiv_rn((float)s + 0.5f, (float)samples),
                                  extent);
  const float p0f = floorf(p);
  const int p0 = (int)p0f;
  const float f = __fsub_rn(p, p0f);
  Tap t;
  t.o0 = p0 * stride;
  t.o1 = min(p0 + 1, extent - 1) * stride;
  t.w0 = __fsub_rn(1.0f, f);
  t.w1 = f;
  return t;
}

// A lane's channels at one tap: one value (.y unused), or with kPaired two
// neighbours in one 4-byte (bf16) or 8-byte (fp32) load.
template <bool kPaired>
__device__ __forceinline__ float2 load_lane(const float* p) {
  if constexpr (kPaired) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), 0.0f);
}

template <bool kPaired>
__device__ __forceinline__ float2 load_lane(const __nv_bfloat16* p) {
  if constexpr (kPaired)
    return __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
  return make_float2(__bfloat162float(__ldg(p)), 0.0f);
}

// One block: rois [r0, r0 + n) of image b, n <= rois_per_block, where
// blockIdx.x = b * blocks_per_image + r0 / rois_per_block. With kTabled the
// block first writes its rois' taps to shared memory, one thread a tap,
// [roi][axis y, x][cell][sample]; without (a table beyond the shared
// memory) each lane makes the taps it reads. Then the threads walk the
// rois' lanes of work (roi, i, j, c), c fastest, one or (kPaired) two
// channels a lane, blockDim.x lanes apart, by loop counters; lane e writes
// the block's e-th output (or pair), so the stores are contiguous. kS > 0
// fixes the samples per axis, so a lane's S*S*4 loads unroll.
template <typename T, bool kPaired, bool kTabled, int kS>
__global__ void __launch_bounds__(kMaxFwdThreads)
    psroi_align_fwd_kernel(const T* __restrict__ feat,
                           const float* __restrict__ rois,
                           float* __restrict__ out, int H, int W, int R,
                           int grid, int C, int samples, int rois_per_block,
                           int blocks_per_image) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tap* table = reinterpret_cast<Tap*>(smem);
  const int S = kS > 0 ? kS : samples;
  const int b = blockIdx.x / blocks_per_image;
  const int r0 = (blockIdx.x - b * blocks_per_image) * rois_per_block;
  const int n = min(rois_per_block, R - r0);
  const int kkc = grid * grid * C;
  const long long row = (long long)W * kkc;
  const float* box = rois + ((long long)b * R + r0) * 4;
  if (kTabled) {
    for (int e = threadIdx.x; e < n * 2 * grid * S; e += blockDim.x) {
      const int line = e / S;                    // (roi, axis, cell)
      const int s = e - line * S;
      const int roi_axis = line / grid;
      const int cell = line - roi_axis * grid;
      const float* bx = box + (roi_axis >> 1) * 4 + (roi_axis & 1);
      table[e] = make_tap(bx[0], bx[2], cell, s, grid, S,
                          roi_axis & 1 ? W : H,
                          roi_axis & 1 ? (long long)kkc : row);
    }
    __syncthreads();
  }

  // The thread's first lane of work as (roi, i, j, c), and its step of
  // blockDim.x lanes in the same digits: the only divisions of the walk.
  const int per_bin = kPaired ? C / 2 : C;
  const int per_roi = grid * grid * per_bin;
  int roi = threadIdx.x / per_roi;
  int rest = threadIdx.x - roi * per_roi;
  int c = rest % per_bin, i = rest / per_bin / grid;
  int j = rest / per_bin - i * grid;
  const int step_roi = blockDim.x / per_roi;
  rest = blockDim.x - step_roi * per_roi;
  const int step_c = rest % per_bin, step_i = rest / per_bin / grid;
  const int step_j = rest / per_bin - step_i * grid;

  const T* fb = feat + (long long)b * H * row;
  float* ob = out + ((long long)b * R + r0) * kkc;
  const float inv = 1.0f / (float)(S * S);
  for (int e = threadIdx.x; e < n * per_roi; e += blockDim.x) {
    const T* base = fb + (i * grid + j) * C + (kPaired ? 2 * c : c);
    const Tap* ty = table + (roi * 2 * grid + i) * S;
    const Tap* tx = table + ((roi * 2 + 1) * grid + j) * S;
    const float* bx = box + roi * 4;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int sy = 0; sy < S; ++sy) {
      const Tap y = kTabled ? ty[sy]
                            : make_tap(bx[0], bx[2], i, sy, grid, S, H, row);
      const T* p0 = base + y.o0;
      const T* p1 = base + y.o1;
#pragma unroll
      for (int sx = 0; sx < S; ++sx) {
        const Tap x = kTabled ? tx[sx]
                              : make_tap(bx[1], bx[3], j, sx, grid, S, W,
                                         (long long)kkc);
        const float2 v00 = load_lane<kPaired>(p0 + x.o0);
        const float2 v01 = load_lane<kPaired>(p0 + x.o1);
        const float2 v10 = load_lane<kPaired>(p1 + x.o0);
        const float2 v11 = load_lane<kPaired>(p1 + x.o1);
        // the plain version's weights, (1 - fy) * (1 - fx) and so on
        const float w00 = __fmul_rn(y.w0, x.w0), w01 = __fmul_rn(y.w0, x.w1);
        const float w10 = __fmul_rn(y.w1, x.w0), w11 = __fmul_rn(y.w1, x.w1);
        a0 = fmaf(w11, v11.x, fmaf(w10, v10.x, fmaf(w01, v01.x,
                                                    fmaf(w00, v00.x, a0))));
        if (kPaired)
          a1 = fmaf(w11, v11.y, fmaf(w10, v10.y, fmaf(w01, v01.y,
                                                      fmaf(w00, v00.y, a1))));
      }
    }
    if (kPaired)
      reinterpret_cast<float2*>(ob)[e] = make_float2(a0 * inv, a1 * inv);
    else
      ob[e] = a0 * inv;
    // the next lane, blockDim.x on: add the step digit by digit
    c += step_c;
    int carry = c >= per_bin;
    c -= carry ? per_bin : 0;
    j += step_j + carry;
    carry = j >= grid;
    j -= carry ? grid : 0;
    i += step_i + carry;
    carry = i >= grid;
    i -= carry ? grid : 0;
    roi += step_roi + carry;
  }
}

template <typename T, bool kPaired>
int launch_fwd(const T* feat, const float* rois, float* out, int B, int H,
               int W, int R, int grid, int C, int samples, int threads,
               int rois_per_block, bool tabled, int smem_bytes,
               cudaStream_t s) {
  const bool two = samples == 2;
  auto kernel = !tabled ? psroi_align_fwd_kernel<T, kPaired, false, 0>
                : two   ? psroi_align_fwd_kernel<T, kPaired, true, 2>
                        : psroi_align_fwd_kernel<T, kPaired, true, 0>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_image = (R + rois_per_block - 1) / rois_per_block;
  kernel<<<(unsigned)(B * per_image), threads, smem_bytes, s>>>(
      feat, rois, out, H, W, R, grid, C, samples, rois_per_block, per_image);
  return (int)cudaGetLastError();
}

}  // namespace

// features [B, H, W, k*k*C] bf16 or fp32 and rois [B, R, 4] fp32 -> out [B,
// R, k, k, C] fp32. The launch plan (threads per block, rois per block, the
// paired path, the tap table and its shared memory bytes) comes from
// ops/psroi_align.py::plan_forward; the paired path needs C even and
// features aligned to two elements.
extern "C" int xdt_psroi_align_fwd(const void* features, const void* rois,
                                   void* out, int features_are_bf16, int B,
                                   int H, int W, int R, int grid, int C,
                                   int samples, int threads,
                                   int rois_per_block, int paired, int tabled,
                                   int smem_bytes, void* stream) {
  const long long table =
      2LL * rois_per_block * grid * samples * (long long)sizeof(Tap);
  const uintptr_t pair_bytes = features_are_bf16 ? 4 : 8;
  if (B < 1 || H < 1 || W < 1 || R < 1 || grid < 1 || C < 1 ||
      samples < 1 || threads < 32 || threads > kMaxFwdThreads ||
      threads % 32 || rois_per_block < 1 ||
      smem_bytes != (tabled ? table : 0) ||
      (long long)B * ((R + rois_per_block - 1) / rois_per_block) >
          0x7fffffffLL ||
      (paired && (C % 2 || reinterpret_cast<uintptr_t>(features) % pair_bytes ||
                  reinterpret_cast<uintptr_t>(out) % 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  float* o = static_cast<float*>(out);
  if (features_are_bf16) {
    const auto* f = static_cast<const __nv_bfloat16*>(features);
    return paired ? launch_fwd<__nv_bfloat16, true>(
                        f, r, o, B, H, W, R, grid, C, samples, threads,
                        rois_per_block, tabled, smem_bytes, s)
                  : launch_fwd<__nv_bfloat16, false>(
                        f, r, o, B, H, W, R, grid, C, samples, threads,
                        rois_per_block, tabled, smem_bytes, s);
  }
  const auto* f = static_cast<const float*>(features);
  return paired ? launch_fwd<float, true>(f, r, o, B, H, W, R, grid, C,
                                          samples, threads, rois_per_block,
                                          tabled, smem_bytes, s)
                : launch_fwd<float, false>(f, r, o, B, H, W, R, grid, C,
                                           samples, threads, rois_per_block,
                                           tabled, smem_bytes, s);
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
  if (dfeat_is_bf16)
    return launch_tiles(g, r, x, static_cast<__nv_bfloat16*>(dfeat), B, H, W,
                        R, grid, C, samples, threads, cap, smem_bytes, s);
  return launch_tiles(g, r, x, static_cast<float*>(dfeat), B, H, W, R, grid,
                      C, samples, threads, cap, smem_bytes, s);
}
