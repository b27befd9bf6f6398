// Exact greedy NMS on Hopper (sm_90a): the suppressed flags of score-sorted
// boxes, with no host sync and no launch that depends on the data.
//
// Replaces no Pallas kernel: the JAX package's exact NMS
// (x_detector_tpu/ops/nms.py::nms_padded) is XLA loops, a fori_loop over
// tiles of 128 boxes (:186), each resolved by a Gauss-Jacobi fixpoint in a
// while_loop (:74). The port's plain
// version (ops/nms.py::suppress_plain, the CPU implementation of
// xdt::nms_suppress) walks the same tiles in Python, with one host check of
// the fixpoint a tile; on the card that loop made ~45 small launches and one
// host sync a tile (8 tiles a served batch's proposals, 47 a train step's).
//
// What it computes: boxes [R, N, 4] fp32 ([ymin, xmin, ymax, xmax]), each
// row in descending score order, invalid boxes zero -> flags [R, N] (bytes
// 0 / 1): flags[r, t] = 1 where some kept box j < t of the row has
// IoU(j, t) > thr, kept meaning flags[r, j] = 0. That is sequential greedy
// NMS, the recurrence the plain version's fixpoint solves.
//
// The IoU rounds every operation as ops/boxes.py's intersection, area and
// iou do in PyTorch, in the same order (min / max, subtract, clamp at 0,
// product; area_a + area_b - inter; inter / max(union, 1e-8) where
// union > 0, else 0), with the _rn intrinsics so that nothing contracts into
// an fma, and NaN coordinates give an IoU of 0 as there. It is compared
// with the fp32 threshold, as PyTorch compares an fp32 tensor with a Python
// float. So every decision is bitwise the plain version's.
//
// Two kernels, launched back to back on one stream:
//   * mask: one block of 64 threads for each 64 x 64 block of box pairs in
//     the upper triangle of every row (column block >= row block). It stages
//     its 64 column boxes and their areas in shared memory; thread i writes
//     one 64-bit word, bit t set where t > i and IoU(i, t) > thr, into
//     mask[r, i, column block]. A pair that does not intersect skips the
//     division (0 / union is 0). The blocks on the diagonal also write, by
//     ballot, a word of the row block's boxes whose row of the mask can hold
//     a bit: a box of area 0 (an invalid one) has IoU 0 with everything, so
//     for thr >= 0 its row is all zero and the scan never reads it.
//   * scan: one warp a row. The row's "removed" words, ceil(N / 64) of
//     them, live in the lanes' registers (lane l holds words l, l + 32, ...;
//     94 words at N = 6016, 3 a lane). For each 64-box block in order: the
//     owning lane broadcasts the block's removed word; the block's 64
//     decisions are resolved in registers from its diagonal words (two a
//     lane, broadcast by shuffles, the same in every lane); the flags are
//     stored; then each kept box whose row can hold a bit is ORed into the
//     later blocks' words, each lane loading the words it owns: the loads of
//     a row are coalesced, and those of 8 kept rows are issued before any is
//     used. The next block's diagonal words are loaded before that, so
//     their latency hides behind it.
//
// What bounds it: the mask's bytes, R * N * ceil(N/64) * 8 written once
// (72 MB at a train step's 16 x 6016, 2 MB at a served batch's 16 x 1024),
// and the scan's latency: the row's blocks are sequential, and each waits
// for its diagonal words and its kept rows' words. The mask is written in
// one wide launch (71,440 blocks at 16 x 6016) and the scan reads only the
// diagonal words and the rows of kept boxes that can suppress anything,
// with their loads batched so that 8 rows' latencies overlap. Only R warps
// run the scan (16 in serving's proposal stage): it is a chain of
// dependent steps, and a row's steps do not split across warps without a
// reduction per block.
//
// No atomics: every word is written by one thread, and the same inputs
// give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;            // boxes a block; bits a mask word
constexpr int kMaxWordsPerLane = 8;   // the scan's words: N <= 64 * 32 * 8
constexpr int kRowsInFlight = 8;      // kept rows whose loads are batched
constexpr float kEps = 1e-8f;         // ops/boxes.py's EPS in fp32

// PyTorch's clamp_min(0): NaN in, NaN out. A NaN coordinate makes its
// box's area NaN, so every union it enters is NaN and the IoU 0 (union > 0
// fails), whatever min and max make of it: plain fminf / fmaxf do there.
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

struct Box {
  float y0, x0, y1, x1, area;
};

__device__ __forceinline__ Box load_box(const float* p) {
  Box b{p[0], p[1], p[2], p[3], 0.f};
  // (boxes[..., 2:] - boxes[..., :2]).clamp_min(0).prod(-1)
  b.area = __fmul_rn(clamp0(__fsub_rn(b.y1, b.y0)),
                     clamp0(__fsub_rn(b.x1, b.x0)));
  return b;
}

__device__ __forceinline__ bool over(const Box& a, const Box& b, float thr) {
  const float h = clamp0(__fsub_rn(fminf(a.y1, b.y1), fmaxf(a.y0, b.y0)));
  const float w = clamp0(__fsub_rn(fminf(a.x1, b.x1), fmaxf(a.x0, b.x0)));
  const float inter = __fmul_rn(h, w);
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  const float iou = (uni > 0.f && inter != 0.f)
                        ? __fdiv_rn(inter, fmaxf(uni, kEps))
                        : 0.f;
  return iou > thr;
}

// the upper triangle's blocks column by column: column c holds row blocks
// 0..c, and starts at c (c + 1) / 2
__device__ __forceinline__ void triangle(int t, int* rb, int* cb) {
  int c = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (c > 0 && c * (c + 1) / 2 > t) --c;
  while ((c + 1) * (c + 2) / 2 <= t) ++c;
  *cb = c;
  *rb = t - c * (c + 1) / 2;
}

__global__ void __launch_bounds__(kBlock)
nms_mask_kernel(const float* __restrict__ boxes,
                unsigned long long* __restrict__ mask,
                unsigned* __restrict__ live, int N, int words, int tri,
                float thr) {
  const int r = (int)(blockIdx.x / (unsigned)tri);
  int rb, cb;
  triangle((int)(blockIdx.x % (unsigned)tri), &rb, &cb);
  const float* row = boxes + (size_t)r * N * 4;
  const int c0 = cb * kBlock, ncols = min(kBlock, N - c0);
  __shared__ Box cols[kBlock];
  if ((int)threadIdx.x < ncols)
    cols[threadIdx.x] = load_box(row + (size_t)(c0 + threadIdx.x) * 4);
  __syncthreads();
  const int i = rb * kBlock + threadIdx.x;
  const bool in = i < N;
  const Box a = in ? load_box(row + (size_t)i * 4) : Box{0.f, 0.f, 0.f, 0.f,
                                                         0.f};
  if (rb == cb) {
    // a box of area 0 (or NaN) has IoU 0 with every box: its row holds a
    // bit only where 0 > thr
    const unsigned bits = __ballot_sync(0xffffffffu,
                                        in && (a.area > 0.f || thr < 0.f));
    if ((threadIdx.x & 31) == 0)
      live[((size_t)r * words + rb) * 2 + (threadIdx.x >> 5)] = bits;
  }
  if (!in) return;
  unsigned long long bits = 0;
  for (int k = rb == cb ? (int)threadIdx.x + 1 : 0; k < ncols; ++k)
    if (over(a, cols[k], thr)) bits |= 1ull << k;
  mask[((size_t)r * N + i) * words + cb] = bits;
}

template <int K>
__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const unsigned long long* __restrict__ live,
                unsigned char* __restrict__ flags, int N, int words) {
  const int r = blockIdx.x, lane = threadIdx.x;
  const unsigned long long* m = mask + (size_t)r * N * words;
  const unsigned long long* lv = live + (size_t)r * words;
  unsigned char* out = flags + (size_t)r * N;
  unsigned long long removed[K];
#pragma unroll
  for (int k = 0; k < K; ++k) removed[k] = 0;
  // block 0's diagonal words (rows lane and lane + 32) and live word
  unsigned long long d0 = lane < N ? m[(size_t)lane * words] : 0;
  unsigned long long d1 = lane + 32 < N ? m[(size_t)(lane + 32) * words] : 0;
  unsigned long long alive = lv[0];
  for (int b = 0; b < words; ++b) {
    const int base = b * kBlock, nb = min(kBlock, N - base);
    // 1. the block's removed word, from the lane that owns it
    unsigned long long mine = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k == b / 32) mine = removed[k];
    unsigned long long cur = __shfl_sync(0xffffffffu, mine, b % 32);
    // 2. the block's own decisions, in order, from its diagonal words
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const unsigned long long d = __shfl_sync(0xffffffffu, d0, j);
      if (!((cur >> j) & 1ull)) cur |= d;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const unsigned long long d = __shfl_sync(0xffffffffu, d1, j);
      if (!((cur >> (32 + j)) & 1ull)) cur |= d;
    }
    if (lane < nb) out[base + lane] = (unsigned char)((cur >> lane) & 1ull);
    if (lane + 32 < nb)
      out[base + 32 + lane] = (unsigned char)((cur >> (32 + lane)) & 1ull);
    if (b + 1 == words) break;
    unsigned long long kept = ~cur & alive;
    // the next block's diagonal words, while this block's rows load
    const int next = base + kBlock;
    d0 = next + lane < N ? m[(size_t)(next + lane) * words + b + 1] : 0;
    d1 = next + 32 + lane < N ? m[(size_t)(next + 32 + lane) * words + b + 1]
                              : 0;
    alive = lv[b + 1];
    // 3. every kept row into the later blocks' words this lane owns
    while (kept) {
      // up to kRowsInFlight rows: every load issued before any is used
      int rows[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        rows[u] = kept ? base + __ffsll((long long)kept) - 1 : -1;
        kept &= kept - 1;
      }
      unsigned long long v[kRowsInFlight][K];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int w = lane + 32 * k;
          v[u][k] = rows[u] >= 0 && w > b && w < words
                        ? __ldg(m + (size_t)rows[u] * words + w)
                        : 0ull;
        }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) removed[k] |= v[u][k];
    }
  }
}

template <int K>
cudaError_t launch_scan(const unsigned long long* mask,
                        const unsigned long long* live, unsigned char* flags,
                        int R, int N, int words, cudaStream_t s) {
  nms_scan_kernel<K><<<R, 32, 0, s>>>(mask, live, flags, N, words);
  return cudaGetLastError();
}

}  // namespace

// boxes [R, N, 4] fp32, each row score-sorted, invalid boxes zero ->
// flags [R, N] bytes (1 = suppressed). scratch: R * N * words + R * words
// 64-bit words (words = ceil(N / 64)): the mask, then the live words; every
// word the scan reads is written first, so it needs no clearing.
extern "C" int xdt_nms_suppress(const void* boxes, void* scratch, void* flags,
                                int R, int N, float thr, void* stream) {
  if (R < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const int words = (N + kBlock - 1) / kBlock;
  const long long tri = (long long)words * (words + 1) / 2;
  if (words > 32 * kMaxWordsPerLane || (long long)R * tri > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* mask = static_cast<unsigned long long*>(scratch);
  unsigned long long* live = mask + (size_t)R * N * words;
  nms_mask_kernel<<<(unsigned)(R * tri), kBlock, 0, s>>>(
      static_cast<const float*>(boxes), mask,
      reinterpret_cast<unsigned*>(live), N, words, (int)tri, thr);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto* f = static_cast<unsigned char*>(flags);
  const int lanes = (words + 31) / 32;
  if (lanes <= 1) return (int)launch_scan<1>(mask, live, f, R, N, words, s);
  if (lanes <= 2) return (int)launch_scan<2>(mask, live, f, R, N, words, s);
  if (lanes <= 4) return (int)launch_scan<4>(mask, live, f, R, N, words, s);
  return (int)launch_scan<8>(mask, live, f, R, N, words, s);
}
