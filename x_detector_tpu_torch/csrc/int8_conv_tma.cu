// Kernel K1's Hopper design (sm_90a): the dense int8 convolution of the
// post-training-quantized backbone as a GEMM on TMA-loaded tiles and
// wgmma with s8 operands, the "tma" route of xdt::int8_conv.
//
// Replaces: the int8 lax.conv_general_dilated of QuantConv's "int8" mode,
// x_detector_tpu/models/layers.py:180-185 (XLA's op, not a Pallas kernel).
// It computes what int8_conv.cu's first design ("mma" route) computes:
//   out[b, ho, wo, n] = OutT(float(acc) * scale[n]),
//   acc = the exact int32 sum over (tap, cin) of xq * wq,
// xq int8 NHWC [B, H, W, Cin], wq the prepared [Cout, Kp] OHWI weight (K =
// kh*kw*Cin padded with zeros to a multiple of 64), OutT bf16 or fp32. The
// products and their int32 sums are exact in any order, and the epilogue
// rounds as the plain version does (__int2float_rn, one __fmul_rn, one
// __float2bfloat16_rn; no FMA contraction, no fast-math), so the kernel
// equals its plain version (ops/int8_conv.py) bit for bit.
//
// What bounds it on an H100: the tensor cores' int8 rate (2 M N K over
// 1,979 TOPS) for the 3x3s and the deep 1x1s of ResNet's stages 3-4, the
// bytes of xq and the output (3.35 TB/s) for the wide maps at Cin 64-256.
// The first design reached 5-32% of that: mma.sync from ldmatrix'd tiles,
// every thread gathering its own A bytes with cp.async, no split of K, so
// config 2's 16 x 16 and 32 x 32 calls filled half the SMs or less while
// walking K 1024-4608 deep, and an epilogue of scattered 4- and 8-byte
// stores. This design:
//   - Operands by TMA, no gather. One producer thread keeps a ring of
//     4-8 stages of 128-byte K chunks in flight (full and empty mbarriers a
//     stage). The "gemm" form (1x1, stride 1, no pads) reads A as a 2D map
//     over [B*H*W, Cin], 128 flat rows a tile. The "conv" form (every other
//     kernel, stride and dilation) reads, for each tap (i, j) and 128-byte
//     channel chunk, a TH x TW box of one image from a 4D map over [B, H,
//     W, Cin] starting at (ho0 * s - pt + i * d, wo0 * s - pl + j * d): the
//     map's element strides (s, at most 8) step the stride, TMA's zero fill
//     of out-of-bounds coordinates (negative ones too) is the padding, and
//     channels past Cin read as zero, so a chunk that runs into the next
//     tap's weight columns multiplies them by zeros. B is a 2D map over
//     [Cout, Kp]; both in the 128-byte swizzle. Cin must be a multiple of 16
//     and xq and the weight 16-byte aligned (TMA's rules for a global
//     stride and address): the host's plan sends other calls to the "mma"
//     route.
//   - wgmma.mma_async m64nNk32 .s32.s8.s8, N = 64, 128 or 256 by Cout, both
//     operands K-major in shared memory (integer wgmma has no transpose),
//     four k32 steps a chunk, each 32 bytes further into the swizzle atom.
//     Two consumer warpgroups own 64 output rows each, int32 accumulators
//     in registers (the fp32 accumulator's fragment layout).
//   - Exact split-K where a call has too few tiles for the SMs: the host
//     splits the K chunks into S slices (ops/int8_conv.py::split_count: the
//     most that keep one wave, at most 8), and the S blocks of a tile form a
//     thread-block cluster, one slice each. Each writes its int32 partial
//     tile into its own shared memory (the ring, idle by then) in the
//     accumulators' register order; after a cluster barrier, block r sums
//     the S partials of the output passes r, r + S, ... through
//     distributed shared memory and runs their epilogue; a second barrier
//     keeps every partial alive until it has been read. Integer addition
//     is exact and associative, so the result is the plain version's bits
//     whatever the order. Nothing goes through device memory: no
//     workspace, no counter, no atomic, so launches on any number of
//     streams share nothing.
//   - Staged epilogue: 128 bytes of output channels at a time (64 bf16 or
//     32 fp32), the two warpgroups dequantize the tile into a swizzled
//     staging tile in shared memory, which one thread stores by TMA (a 2D
//     map over the [M, Cout] output, or a 4D one over [B, Ho, Wo, Cout]
//     with the conv form's th x tw box), clipping the M and N tails, while
//     the consumers go on; two staging tiles alternate. Where Cout's row is
//     not a multiple of 16 bytes (no tensor map takes it), the threads
//     store the staged rows element by element.
//   - A persistent grid, one block per SM walking the tiles: the producer
//     loads the next tile's chunks while the consumers run this tile's
//     epilogue, which at K 64-256 (ResNet's wide 1x1s) is as long as the
//     products. (A split plan is one wave: a unit a block.)

#include <cuda_bf16.h>
#include <limits.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int KC = 128;            // bytes of K a chunk: one swizzled row
constexpr int BM = 128;            // output rows a tile: 2 warpgroups x m64
constexpr int THREADS = 384;       // 2 consumer warpgroups + 1 producer one
constexpr int A_BYTES = BM * KC;   // one stage's A tile, 16 KB
constexpr int PASS_BYTES = BM * 128;   // a staging tile: 128 B a row
constexpr int STAGING_BYTES = 2 * PASS_BYTES;  // double-buffered
constexpr int BAR_BYTES = 2048;    // mbarriers, last-slice flag, row tables
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLITS = 8;      // a cluster's blocks, at most (portable)
constexpr int SMEM_LIMIT = 232448;

// Shared memory from a 1024-byte aligned base: the ring (each stage an A
// tile, then BN rows of B), the two staging tiles of the epilogue, then the
// mbarriers (full, empty), the last-slice flag and two row tables.
struct Layout {
  int stage, staging, bars, bytes;
  __host__ __device__ Layout(int bn, int stages) {
    stage = A_BYTES + bn * KC;
    staging = stages * stage;
    bars = staging + STAGING_BYTES;
    bytes = bars + BAR_BYTES + 1024;   // + slack to align the base
  }
};

struct Params {
  const float* scale;  // [Cout]
  void* out;           // [M, Cout]
  int gemm;            // 1: the "gemm" form; 0: the "conv" form
  int M, Cin, Ho, Wo, Cout, kw, sh, sw, dh, dw, pt, pl;
  int th, tw, tiles_h, tiles_w, tiles_n, splits, units, nk, cchunks;
  int stages, a_bytes;
  int tma_store;       // 1: the output map stores; 0: element stores
};

template <int BN>
struct Acc {
  int d[BN / 2];       // m64 x BN int32 over a warpgroup's 128 threads
};

// d (+)= a (64 x 32 s8, K-major) * b (N x 32 s8, K-major), int32, exact;
// scale_d = 0 starts the sum anew
__device__ __forceinline__ void wgmma_s8(Acc<64>& acc, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  int* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(Acc<128>& acc, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  int* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(Acc<256>& acc, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  int* d = acc.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ float dequant(int acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
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

struct Tile {
  int b, h0, w0;       // the conv form: image, first output row and column
  int m0;              // the gemm form: first output row
  int n0;              // first output channel
};

// Tile t, output channels fastest: the tiles that read one A tile run
// side by side and share it in L2.
template <int BN>
__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  Tile T;
  T.n0 = (t % p.tiles_n) * BN;
  t /= p.tiles_n;
  if (p.gemm) {
    T.m0 = t * BM;
    T.b = T.h0 = T.w0 = 0;
  } else {
    T.m0 = 0;
    T.w0 = (t % p.tiles_w) * p.tw;
    t /= p.tiles_w;
    T.h0 = (t % p.tiles_h) * p.th;
    T.b = t / p.tiles_h;
  }
  return T;
}

// K chunks [chunk_begin, chunk_end) of a slice: whole chunks, every slice
// at least one (the host keeps splits <= nk)
__device__ __forceinline__ int chunk_begin(const Params& p, int slice) {
  return (int)((long long)slice * p.nk / p.splits);
}

// The output row (pixel) of a tile's row r, or -1 where r maps to none:
// past M (gemm), past the TH x TW box or the map's edge (conv).
__device__ __forceinline__ int out_row(const Params& p, const Tile& T,
                                       int r) {
  if (p.gemm) return T.m0 + r < p.M ? T.m0 + r : -1;
  if (r >= p.th * p.tw) return -1;
  const int ho = T.h0 + r / p.tw, wo = T.w0 + r % p.tw;
  if (ho >= p.Ho || wo >= p.Wo) return -1;
  return (T.b * p.Ho + ho) * p.Wo + wo;
}

// SPLIT: the tile's K slices are a cluster (p.splits > 1), else whole K.
template <int BN, bool SPLIT, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
int8_conv_tma_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ CUtensorMap out_map,
                     const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L(BN, p.stages);
  const uint32_t bar0 = smem_u32(smem + L.bars);
  auto full = [bar0](int s) { return bar0 + 8u * s; };
  auto empty = [bar0](int s) { return bar0 + 8u * (MAX_STAGES + s); };
  int* rowtab = reinterpret_cast<int*>(smem + L.bars + 1024);   // [2][128]
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);             // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // Producer warpgroup, on few registers: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == 256) {
      int g = 0;   // chunks issued, over all units: the ring's position
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int tile = u / p.splits, slice = u - tile * p.splits;
        const Tile T = tile_of<BN>(p, tile);
        const int k1 = chunk_begin(p, slice + 1);
        for (int k = chunk_begin(p, slice); k < k1; ++k, ++g) {
          const int s = g % p.stages;
          mbar_wait(empty(s), ((g / p.stages) & 1) ^ 1);
          unsigned char* st = smem + s * L.stage;
          mbar_expect_tx(full(s), p.a_bytes + BN * KC);
          if (p.gemm) {
            tma_load_2d(smem_u32(st), &a_map, full(s), k * KC, T.m0);
            tma_load_2d(smem_u32(st + A_BYTES), &b_map, full(s), k * KC,
                        T.n0);
          } else {
            const int tap = k / p.cchunks, c = (k - tap * p.cchunks) * KC;
            const int i = tap / p.kw, j = tap - i * p.kw;
            tma_load_4d(smem_u32(st), &a_map, full(s), c,
                        T.w0 * p.sw - p.pl + j * p.dw,
                        T.h0 * p.sh - p.pt + i * p.dh, T.b);
            tma_load_2d(smem_u32(st + A_BYTES), &b_map, full(s),
                        tap * p.Cin + c, T.n0);
          }
        }
      }
    }
    if constexpr (SPLIT) {  // the consumers' two cluster barriers
      __syncwarp();
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // Consumers: warpgroup wg owns the tile's rows [64 wg, 64 wg + 64).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31;
  OutT* out = static_cast<OutT*>(p.out);
  constexpr int OB = (int)sizeof(OutT);
  constexpr int SC = 128 / OB;              // output channels a pass
  constexpr int EPC = 16 / OB;              // output elements in 16 bytes
  constexpr int PARTS = BN / 8;             // int4s of a thread's partial

  Acc<BN> acc;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc.d[i] = 0;
  int g = 0;        // chunks consumed: the ring's position
  int ep = 0;       // epilogues run: the row table's parity
  int es = 0;       // epilogue passes run: the staging tile's parity
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int tile = u / p.splits, slice = u - tile * p.splits;
    const Tile T = tile_of<BN>(p, tile);
    const int k0 = chunk_begin(p, slice), k1 = chunk_begin(p, slice + 1);
    for (int k = k0; k < k1; ++k, ++g) {
      const int s = g % p.stages;
      mbar_wait(full(s), (g / p.stages) & 1);
      const unsigned char* st = smem + s * L.stage;
      wgmma_fence();
      const uint64_t da = sw128_desc(smem_u32(st + wg * (A_BYTES / 2)));
      const uint64_t db = sw128_desc(smem_u32(st + A_BYTES));
#pragma unroll
      for (int ks = 0; ks < KC / 32; ++ks)     // + 32 bytes of K a step
        wgmma_s8(acc, da + 2 * ks, db + 2 * ks, (k != k0) | (ks != 0));
      wgmma_commit();
      wgmma_wait<1>();                 // the products of chunk k - 1 are done
      if (k > k0 && t == 0) mbar_arrive(empty((g - 1) % p.stages));
    }
    wgmma_wait<0>();
    if (t == 0) mbar_arrive(empty((g - 1) % p.stages));

    // Split K: the cluster's blocks hold the tile's slices (one unit
    // each). Each writes its partial to its own ring, idle now, in the
    // accumulators' register order; after a cluster barrier, block r sums
    // the slices of the passes sl = r, r + S, ... from every block's
    // shared memory, and stores them.
    const int rank = SPLIT ? (int)cluster_rank() : 0;
    const uint32_t part = smem_u32(smem) + 16u * tid;
    if constexpr (SPLIT) {
      named_barrier(3, 256);   // both warpgroups' products have read the ring
#pragma unroll
      for (int i = 0; i < PARTS; ++i)
        *reinterpret_cast<int4*>(smem + 16 * (i * 256 + tid)) = make_int4(
            acc.d[4 * i], acc.d[4 * i + 1], acc.d[4 * i + 2],
            acc.d[4 * i + 3]);
      cluster_sync();
    }

    // Epilogue, 128 bytes of output channels a pass (64 bf16 or 32 fp32):
    // dequantized into a staging tile, 128-byte rows whose 16-byte chunks
    // are swizzled by the row (TMA's 128-byte swizzle: neither these
    // writes nor the reads conflict), then stored by TMA from one thread
    // while the consumers go on (the passes alternate between two staging
    // tiles), the M and N tails clipped by the map; where Cout's row is
    // not a multiple of 16 bytes (no map), the threads store it element by
    // element through the row table.
    int* rows = rowtab + 128 * (ep++ & 1);
    if (!p.tma_store && tid < 128) rows[tid] = out_row(p, T, tid);
#pragma unroll
    for (int sl = 0; sl < BN / SC; ++sl) {
      if (SPLIT && sl % p.splits != rank) continue;
      unsigned char* buf = smem + L.staging + (es++ & 1) * PASS_BYTES;
      if (p.tma_store && tid == 0) bulk_wait_read<1>();
      named_barrier(3, 256);           // buf's store two passes ago read it
#pragma unroll
      for (int jj = 0; jj < SC / 8; ++jj) {
        const int j = sl * (SC / 8) + jj;
        if constexpr (SPLIT) {          // the slices' int4 j of this thread
          int4 v = make_int4(0, 0, 0, 0);
          for (int q = 0; q < p.splits; ++q) {
            const int4 w = ld_cluster_s32x4(
                map_to_rank(part + 16u * 256 * j, q));
            v.x += w.x;
            v.y += w.y;
            v.z += w.z;
            v.w += w.w;
          }
          acc.d[4 * j] = v.x;
          acc.d[4 * j + 1] = v.y;
          acc.d[4 * j + 2] = v.z;
          acc.d[4 * j + 3] = v.w;
        }
        const int col = 8 * jj + 2 * (lane & 3);
        const int n = T.n0 + sl * SC + col;
        const float s0 = n < p.Cout ? __ldg(p.scale + n) : 0.0f;
        const float s1 = n + 1 < p.Cout ? __ldg(p.scale + n + 1) : 0.0f;
        const int byte = col * OB;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * r;
          store2(reinterpret_cast<OutT*>(
                     buf + row * 128 +
                     ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15))),
                 dequant(acc.d[4 * j + 2 * r], s0),
                 dequant(acc.d[4 * j + 2 * r + 1], s1));
        }
      }
      fence_async_shared();
      named_barrier(3, 256);
      if (p.tma_store) {
        if (tid == 0) {
          if (p.gemm)
            tma_store_2d(&out_map, smem_u32(buf), T.n0 + sl * SC, T.m0);
          else
            tma_store_4d(&out_map, smem_u32(buf), T.n0 + sl * SC, T.w0,
                         T.h0, T.b);
          bulk_commit();
        }
      } else {
        for (int idx = tid; idx < BM * 8; idx += 256) {
          const int row = idx >> 3, q = idx & 7;
          const int orow = rows[row];
          const int n = T.n0 + sl * SC + q * EPC;
          if (orow < 0 || n >= p.Cout) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(
              buf + row * 128 + ((q ^ (row & 7)) << 4));
          const OutT* e = reinterpret_cast<const OutT*>(&v);
          OutT* o = out + (size_t)orow * p.Cout + n;
          for (int i = 0; i < EPC && n + i < p.Cout; ++i) o[i] = e[i];
        }
      }
    }
  }
  if constexpr (SPLIT) cluster_sync();   // the others have read our partial
  if (p.tma_store && tid == 0) bulk_wait<0>();
}

struct Maps {
  CUtensorMap a, b, out;
};

// A split plan launches clusters of `splits` blocks along x, one tile's
// slices, a unit a block; a whole-K plan, plain blocks.
template <int BN, bool SPLIT, typename OutT>
int launch(const Maps& m, const Params& p, int smem_bytes, int grid,
           cudaStream_t s) {
  auto kernel = int8_conv_tma_kernel<BN, SPLIT, OutT>;
  // the shared memory a block may take, raised once a card (the host's
  // time a call counts on the small calls)
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
  if constexpr (SPLIT) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = (size_t)smem_bytes;
    cfg.stream = s;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = (unsigned)p.splits;
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, m.a, m.b, m.out, p);
    if (err != cudaSuccess) return (int)err;
  } else {
    kernel<<<grid, THREADS, smem_bytes, s>>>(m.a, m.b, m.out, p);
  }
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_bn(int bn, const Maps& m, const Params& p, int smem_bytes,
              int grid, cudaStream_t s) {
  const bool split = p.splits > 1;
  switch (bn) {
    case 64:
      return split ? launch<64, true, OutT>(m, p, smem_bytes, grid, s)
                   : launch<64, false, OutT>(m, p, smem_bytes, grid, s);
    case 128:
      return split ? launch<128, true, OutT>(m, p, smem_bytes, grid, s)
                   : launch<128, false, OutT>(m, p, smem_bytes, grid, s);
    case 256:
      return split ? launch<256, true, OutT>(m, p, smem_bytes, grid, s)
                   : launch<256, false, OutT>(m, p, smem_bytes, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

// A map of `rank` dimensions, innermost first (strides of the outer ones
// in bytes), in the 128-byte swizzle; out-of-bounds elements of a box
// read as zero, and a store's are dropped.
bool tiled_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               int rank, const cuuint64_t* dims, const cuuint64_t* strides,
               const cuuint32_t* box, const cuuint32_t* step,
               CUtensorMapL2promotion promotion) {
  return encoder()(map, type, rank, const_cast<void*>(ptr), dims, strides,
                   box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x [B, H, W, Cin] int8, w [Cout, Kp] int8 (OHWI, K = kh*kw*Cin padded to
// Kp with zeros), scale [Cout] fp32 -> out [B, Ho, Wo, Cout] bf16 or fp32.
// The host's plan (ops/int8_conv.py::plan_tma): the form (gemm 1 or 0), the
// conv form's th x tw output tile, bn (64, 128 or 256) output channels a
// tile, `stages` ring stages, `splits` slices of K (clusters of that many
// blocks, grid = tiles x splits), `smem_bytes` of dynamic shared memory and
// `grid` persistent blocks. Returns a cudaError_t.
extern "C" int xdt_int8_conv_tma(
    const void* x, const void* w, const void* scale, void* out,
    int out_is_bf16, int B, int H, int W, int Cin, int Ho, int Wo, int Cout,
    int kh, int kw, int sh, int sw, int dh, int dw, int pt, int pl, int Kp,
    int gemm, int th, int tw, int bn, int stages, int splits, int smem_bytes,
    int grid, void* stream) {
  const long long m = (long long)B * Ho * Wo, m_in = (long long)B * H * W;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Ho < 1 || Wo < 1 || Cout < 1 ||
      kh < 1 || kw < 1 || sh < 1 || sw < 1 || sh > 8 || sw > 8 || dh < 1 ||
      dw < 1 || pt < 0 || pl < 0 || Cin % 16 || Kp % 64 ||
      Kp < kh * kw * Cin || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || m > INT_MAX ||
      (bn != 64 && bn != 128 && bn != 256) || stages < 2 ||
      stages > MAX_STAGES || splits < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const Layout L(bn, stages);
  if (smem_bytes < L.bytes || smem_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.gemm = gemm != 0;
  p.M = (int)m;
  p.Cin = Cin; p.Ho = Ho; p.Wo = Wo; p.Cout = Cout; p.kw = kw;
  p.sh = sh; p.sw = sw; p.dh = dh; p.dw = dw; p.pt = pt; p.pl = pl;
  p.th = th; p.tw = tw;
  p.cchunks = (Cin + KC - 1) / KC;
  p.tiles_n = (Cout + bn - 1) / bn;
  long long tiles;
  if (p.gemm) {
    if (kh != 1 || kw != 1 || sh != 1 || sw != 1 || pt || pl || Ho != H ||
        Wo != W)
      return (int)cudaErrorInvalidValue;
    p.nk = p.cchunks;
    p.a_bytes = A_BYTES;
    p.tiles_h = p.tiles_w = 0;
    tiles = (m + BM - 1) / BM * p.tiles_n;
  } else {
    if (th < 1 || tw < 1 || th * tw > BM || tw * sw > 256 || th * sh > 256)
      return (int)cudaErrorInvalidValue;
    p.nk = kh * kw * p.cchunks;
    p.a_bytes = th * tw * KC;
    p.tiles_h = (Ho + th - 1) / th;
    p.tiles_w = (Wo + tw - 1) / tw;
    tiles = (long long)B * p.tiles_h * p.tiles_w * p.tiles_n;
  }
  // a split plan: one wave of clusters of at most 8 blocks, one unit each
  if (splits > p.nk || splits > MAX_SPLITS || tiles * splits > INT_MAX ||
      (splits > 1 && grid < tiles * splits))
    return (int)cudaErrorInvalidValue;
  p.splits = splits;
  p.units = (int)(tiles * splits);
  p.stages = stages;
  const int ob = out_is_bf16 ? 2 : 4;
  p.tma_store = (Cout * ob) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;

  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const CUtensorMapDataType s8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapDataType ot = out_is_bf16
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapL2promotion l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
  const cuuint32_t step2[2] = {1, 1}, step4[4] = {1, 1, 1, 1};
  const cuuint32_t sc = 128 / ob;       // output channels a staging pass
  const cuuint64_t row = (cuuint64_t)Cout * ob;
  bool ok;
  if (p.gemm) {    // A [B*H*W, Cin] and out [M, Cout], 128-row boxes
    const cuuint64_t dims[2] = {(cuuint64_t)Cin, (cuuint64_t)m_in};
    const cuuint64_t strides[1] = {(cuuint64_t)Cin};
    const cuuint32_t box[2] = {KC, BM};
    ok = tiled_map(&maps.a, s8, x, 2, dims, strides, box, step2, l2);
    const cuuint64_t odims[2] = {(cuuint64_t)Cout, (cuuint64_t)m};
    const cuuint32_t obox[2] = {sc, BM};
    ok = ok && (!p.tma_store || tiled_map(&maps.out, ot, out, 2, odims,
                                          &row, obox, step2, l2));
  } else {         // A [B, H, W, Cin], th x tw pixels at stride s; out
                   // [B, Ho, Wo, Cout], th x tw pixels
    const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W,
                                (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)Cin, (cuuint64_t)W * Cin,
                                   (cuuint64_t)H * W * Cin};
    const cuuint32_t box[4] = {KC, (cuuint32_t)(tw * sw),
                               (cuuint32_t)(th * sh), 1};
    const cuuint32_t step[4] = {1, (cuuint32_t)sw, (cuuint32_t)sh, 1};
    ok = tiled_map(&maps.a, s8, x, 4, dims, strides, box, step, l2);
    const cuuint64_t odims[4] = {(cuuint64_t)Cout, (cuuint64_t)Wo,
                                 (cuuint64_t)Ho, (cuuint64_t)B};
    const cuuint64_t ostrides[3] = {row, row * Wo, row * Wo * Ho};
    const cuuint32_t obox[4] = {sc, (cuuint32_t)tw, (cuuint32_t)th, 1};
    ok = ok && (!p.tma_store || tiled_map(&maps.out, ot, out, 4, odims,
                                          ostrides, obox, step4, l2));
  }
  {                // B [Cout, Kp]: boxes of bn rows x 128 bytes
    const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)Cout};
    const cuuint64_t strides[1] = {(cuuint64_t)Kp};
    const cuuint32_t box[2] = {KC, (cuuint32_t)bn};
    ok = ok && tiled_map(&maps.b, s8, w, 2, dims, strides, box, step2,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const int blocks = grid < p.units ? grid : p.units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_is_bf16
             ? launch_bn<__nv_bfloat16>(bn, maps, p, smem_bytes, blocks, s)
             : launch_bn<float>(bn, maps, p, smem_bytes, blocks, s);
}
