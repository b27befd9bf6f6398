// Fused depthwise-separable conv on Hopper (sm_90a), inference, stride 1:
//   out = relu((dw3x3(x; SAME, dilation d) @ wp) * scale + bias [+ residual])
//
// Replaces: x_detector_tpu/ops/pallas/fused_sepconv.py::_kernel (driven by
// fused_separable_conv). The rounding order is that kernel's: the 9 taps
// sum in fp32 by column planes, plane[1] + plane[0] + plane[2], and round
// to bf16 before the pointwise product; the product accumulates in fp32;
// the folded-BN affine, the residual and the ReLU apply in fp32; one
// rounding to bf16 on store.
//
// What bounds it (batch 16, 800 px, config 3's 14 calls): stages 1-3 are
// bound by HBM (x, out and the residual cross it once: 82-492 MB a call at
// 3.35 TB/s), stage 4 (1024 channels, d = 2) by the tensor cores (42-85
// GFLOP a call at 989 TFLOP/s). The first design (since retired) reached
// neither: it read every tap 9 times from L1/L2, ran its depthwise
// and product phases one after the other behind block barriers with one
// block per SM, re-read all of wp per 64 pixels and used WMMA fragments.
// This one reaches neither either: its depthwise, 9 fp32 FMAs and 9
// shared-memory reads per output element on the CUDA cores, is what the
// kernel waits on (on an H100 SXM at 700 W, batch 16, 1024 -> 1024 runs
// in 0.195 ms instead of 0.611 with the depthwise compiled out, 0.580 with
// the products compiled out, 0.490 with one tap row of three read), and
// where Cout is wider than one unit the depthwise of a tile is computed
// once per unit.
//
// Design, one persistent block per SM walking work units in a static
// order; a unit is one output tile of TH x TW pixels of one image (at most
// 128; the host picks the shape with the fewest units, 5 x 25 at config 3's
// sizes) times BN_U = 128 NACC output channels (NACC = 2 where Cout has 4
// or more 128-channel slices, else 1):
//   - a producer warpgroup, which hands its registers to the consumers
//     (setmaxnreg): two threads issue TMA loads into a ring of stages,
//     each holding one Kc = 64-channel chunk: the (TH + 2d) x (TW + 2d) x
//     64 halo box of x (a 4D tensor map over [B, H, W, Cin]; TMA's zero
//     fill of the out-of-bounds box is the SAME padding, dilation only
//     widens the box) and the BN_U x 64 slice of wp^T (128-byte swizzle),
//     each with its own full and empty mbarriers, as the halo is free
//     once the chunk's depthwise is written, the slice once its products
//     are done; a third thread stores each finished 128-channel round of
//     output by TMA and readies the staging tile for the next round by
//     loading its residual into it;
//   - two consumer warpgroups, each owning 64 of the tile's 128 pixel rows:
//     for chunk k they compute the depthwise from the halo in shared memory
//     (all nine taps read shared memory; x comes from HBM/L2 once per
//     unit, plus its halo), round it to bf16 into their A buffer in the
//     128-byte swizzled layout that the wgmma descriptor declares, and
//     issue wgmma.mma_async m64n128k16 into NACC fp32 accumulators in
//     registers; the product of chunk k runs on the tensor cores while the
//     same warps compute the depthwise of chunk k + 1 (wgmma.wait_group 1):
//     the K loop has no block-wide barrier, only each warpgroup's own, and
//     no Cin ceiling;
//   - the epilogue (affine, residual from shared memory, ReLU, one bf16
//     rounding) writes the swizzled staging tile, which the storing thread
//     sends out by TMA while the consumers go on to the next unit's chunks,
//     already loaded.
// Measured and dropped (PERF.md): a warpgroup of its own for the products
// (with 640 threads ptxas gave 96 registers a thread and spilled), and
// clusters that share a tile's depthwise through distributed shared memory
// (the per-chunk hand-over across CTAs costs more than it saves).
//
// The mbarrier, TMA and wgmma helpers and the CUDA driver's tensor-map
// encoder are shared with int8_conv_tma.cu (hopper.cuh). The host
// (ops/fused_sepconv.py) chooses the tile, the stages, the channels per
// unit, the shared memory bytes and the grid, and this file checks them.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int KC = 64;            // channels per chunk: one 128-byte row
constexpr int BN = 128;           // output channels per accumulator
constexpr int ROWS = 128;         // pixel rows of a unit (2 x m64)
constexpr int THREADS = 384;      // 2 consumer warpgroups + 1 producer one
constexpr int A_BYTES = ROWS * KC * 2;             // one A buffer, 16 KB
constexpr int WP_BYTES = BN * KC * 2;              // one wp slice, 16 KB
constexpr int SLAB_BYTES = ROWS * 128;             // 64 channels of a tile
constexpr int STAGING_BYTES = (BN / 64) * SLAB_BYTES;
constexpr int BAR_BYTES = 256;
constexpr int MAX_STAGES = 4;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared memory, from a 1024-byte aligned base: two A buffers (the two
// warpgroups' 64 rows each, double-buffered by chunk parity), the staging
// tile, the ring of stages (halo box, then wp slice), the mbarriers.
struct Layout {
  int halo_box;    // bytes TMA writes for one halo box
  int stage;       // bytes of one ring stage
  int ring, bars, bytes;
  __host__ __device__ Layout(int th, int tw, int d, int stages, int nacc) {
    halo_box = (th + 2 * d) * (tw + 2 * d) * KC * 2;
    stage = round_up(halo_box, 1024) + nacc * WP_BYTES;
    ring = 2 * A_BYTES + STAGING_BYTES;
    bars = ring + stages * stage;
    bytes = bars + BAR_BYTES + 1024;   // + slack to align the base
  }
};

__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

struct Unit {
  int b, h0, w0, n0;
};

__device__ __forceinline__ Unit decode(int u, int tiles_h, int tiles_w,
                                       int tiles_n, int th, int tw, int bn) {
  Unit r;
  r.n0 = (u % tiles_n) * bn;
  u /= tiles_n;
  r.w0 = (u % tiles_w) * tw;
  u /= tiles_w;
  r.h0 = (u % tiles_h) * th;
  r.b = u / tiles_h;
  return r;
}

// mbarriers: each ring stage's halo box and wp slice have their own full
// and empty barriers, as the halo is free once the depthwise of its chunk
// is written and the wp slice only once the chunk's products are done
// (each freed by both consumer warpgroups); then the staging tile's two,
// per round of 128 output channels: it is ready (its residual has landed,
// or its last store has read it) and the 8 consumer warps have written it.
constexpr int BAR_FULL_H = 0, BAR_EMPTY_H = MAX_STAGES,
              BAR_FULL_W = 2 * MAX_STAGES, BAR_EMPTY_W = 3 * MAX_STAGES,
              BAR_READY = 4 * MAX_STAGES, BAR_STAGED = BAR_READY + 1;

// NACC: 128-channel accumulators per consumer warpgroup, so a unit covers
// 128 NACC output channels and its depthwise serves all of them.
template <int NACC>
__global__ void __launch_bounds__(THREADS, 1)
sepconv_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap wp_map,
                   const __grid_constant__ CUtensorMap out_map,
                   const __grid_constant__ CUtensorMap res_map,
                   const float* __restrict__ wd,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, int Cin, int Cout, int d,
                   int relu, int has_res, int th, int tw, int tiles_h,
                   int tiles_w, int tiles_n, int units, int stages) {
  constexpr int BN_U = BN * NACC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L(th, tw, d, stages, NACC);
  const int k_chunks = (Cin + KC - 1) / KC;
  const int wp_off = round_up(L.halo_box, 1024);  // wp slice in a stage
  unsigned char* staging = smem + 2 * A_BYTES;
  const uint32_t bar0 = smem_u32(smem + L.bars);
  auto bar = [bar0](int i) { return bar0 + 8u * i; };
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar(BAR_FULL_H + s), 1);
      mbar_init(bar(BAR_EMPTY_H + s), 2);   // one arrival per warpgroup
      mbar_init(bar(BAR_FULL_W + s), 1);
      mbar_init(bar(BAR_EMPTY_W + s), 2);
    }
    mbar_init(bar(BAR_READY), 1);
    mbar_init(bar(BAR_STAGED), 8);          // one arrival per consumer warp
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // Producer warpgroup, on few registers: warp 8 loads the halo boxes,
    // warp 10 the wp slices, warp 9 stores each round of the staging tile
    // and then readies it for the next round (by loading its residual, or
    // at once).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int lane = tid - 256;
    if (lane == 0 || lane == 64) {
      const bool halo = lane == 0;
      const int full = halo ? BAR_FULL_H : BAR_FULL_W;
      const int empty = halo ? BAR_EMPTY_H : BAR_EMPTY_W;
      int g = 0;  // chunks issued, over all units: the ring's position
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit U = decode(u, tiles_h, tiles_w, tiles_n, th, tw, BN_U);
        for (int kc = 0; kc < k_chunks; ++kc, ++g) {
          const int s = g % stages;
          mbar_wait(bar(empty + s), ((g / stages) & 1) ^ 1);
          unsigned char* st = smem + L.ring + s * L.stage;
          if (halo) {
            mbar_expect_tx(bar(full + s), L.halo_box);
            tma_load_4d(smem_u32(st), &x_map, bar(full + s), kc * KC,
                        U.w0 - d, U.h0 - d, U.b);
          } else {
            mbar_expect_tx(bar(full + s), NACC * WP_BYTES);
            tma_load_2d(smem_u32(st + wp_off), &wp_map, bar(full + s),
                        kc * KC, U.n0);
          }
        }
      }
    } else if (lane == 32) {
      // slabs of 64 channels from channel n on, at most 2
      auto slabs = [Cout](int n) { return max(0, min(2, (Cout - n + 63) / 64)); };
      auto ready = [&](const Unit& U, int h) {
        const int n = U.n0 + BN * h;
        if (!has_res) {
          mbar_arrive(bar(BAR_READY));
          return;
        }
        mbar_expect_tx(bar(BAR_READY), slabs(n) * th * tw * 128);
        for (int j = 0; j < slabs(n); ++j)
          tma_load_4d(smem_u32(staging + j * SLAB_BYTES), &res_map,
                      bar(BAR_READY), n + 64 * j, U.w0, U.h0, U.b);
      };
      int rho = 0;   // rounds stored
      if ((int)blockIdx.x < units)
        ready(decode(blockIdx.x, tiles_h, tiles_w, tiles_n, th, tw, BN_U), 0);
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit U = decode(u, tiles_h, tiles_w, tiles_n, th, tw, BN_U);
        for (int h = 0; h < NACC; ++h, ++rho) {
          const int n = U.n0 + BN * h;
          mbar_wait(bar(BAR_STAGED), rho & 1);
          for (int j = 0; j < slabs(n); ++j)
            tma_store_4d(&out_map, smem_u32(staging + j * SLAB_BYTES),
                         n + 64 * j, U.w0, U.h0, U.b);
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          if (h + 1 < NACC)
            ready(U, h + 1);
          else if (u + (int)gridDim.x < units)
            ready(decode(u + gridDim.x, tiles_h, tiles_w, tiles_n, th, tw,
                         BN_U), 0);
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
    return;
  }

  // Consumers: warpgroup wg owns the tile's pixel rows [64 wg, 64 wg + 64);
  // thread t the channel group t % 8 (8 channels, 16 bytes) of its rows
  // t / 8 + 16 q, q = 0..3 (rows past th * tw are dead: any pixel).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid / 128, t = tid % 128;
  const int grp = t % 8;
  const int hw = tw + 2 * d;          // halo box width
  const int row_step = d * hw * 128, col_step = d * 128;
  int pix_off[4];                     // (pixel, grp) in the halo box
  int a_off[4];                       // (pixel, grp) in the A half, swizzled
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ml = t / 8 + 16 * q;    // row in this warpgroup's half
    const int m = min(64 * wg + ml, th * tw - 1);
    pix_off[q] = ((m / tw) * hw + m % tw) * 128 + grp * 16;
    a_off[q] = ml * 128 + ((grp ^ (ml & 7)) << 4);
  }
  const int warp = t / 32, lane = t % 32;
  const int erow = 64 * wg + 16 * warp + lane / 4;   // epilogue rows erow, +8

  float acc[NACC][64];
#pragma unroll
  for (int h = 0; h < NACC; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
  int g = 0, rho = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit U = decode(u, tiles_h, tiles_w, tiles_n, th, tw, BN_U);
    for (int kc = 0; kc < k_chunks; ++kc, ++g) {
      const int s = g % stages;
      const unsigned char* st = smem + L.ring + s * L.stage;
      const int ch = kc * KC + grp * 8;   // this thread's 8 channels
      unsigned char* A = smem + (kc & 1) * A_BYTES + wg * (A_BYTES / 2);
      mbar_wait(bar(BAR_FULL_H + s), (g / stages) & 1);

      // depthwise of chunk kc -> A (bf16), by column planes: y = plane[1] +
      // plane[0] + plane[2]; the product of chunk kc - 1 is still running
      // on the tensor cores
      float y[4][8];
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3) {
        const int jj = c3 == 0 ? 1 : (c3 == 1 ? 0 : 2);
        float wt[3][8];                   // taps (0..2, jj), zero past Cin
#pragma unroll
        for (int ti = 0; ti < 3; ++ti) {
          float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
          if (ch < Cin) {
            const float* src = wd + (ti * 3 + jj) * Cin + ch;
            lo = __ldg(reinterpret_cast<const float4*>(src));
            hi = __ldg(reinterpret_cast<const float4*>(src + 4));
          }
          wt[ti][0] = lo.x; wt[ti][1] = lo.y; wt[ti][2] = lo.z;
          wt[ti][3] = lo.w; wt[ti][4] = hi.x; wt[ti][5] = hi.y;
          wt[ti][6] = hi.z; wt[ti][7] = hi.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint4 v[3];
#pragma unroll
          for (int ti = 0; ti < 3; ++ti)
            v[ti] = *reinterpret_cast<const uint4*>(
                st + pix_off[q] + ti * row_step + jj * col_step);
          float plane[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) plane[i] = 0.0f;
#pragma unroll
          for (int ti = 0; ti < 3; ++ti) {
            const float* w = wt[ti];
            plane[0] += bf_lo(v[ti].x) * w[0];
            plane[1] += bf_hi(v[ti].x) * w[1];
            plane[2] += bf_lo(v[ti].y) * w[2];
            plane[3] += bf_hi(v[ti].y) * w[3];
            plane[4] += bf_lo(v[ti].z) * w[4];
            plane[5] += bf_hi(v[ti].z) * w[5];
            plane[6] += bf_lo(v[ti].w) * w[6];
            plane[7] += bf_hi(v[ti].w) * w[7];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            y[q][i] = c3 == 0 ? plane[i] : y[q][i] + plane[i];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint4*>(A + a_off[q]) = make_uint4(
            pack_bf16(y[q][0], y[q][1]), pack_bf16(y[q][2], y[q][3]),
            pack_bf16(y[q][4], y[q][5]), pack_bf16(y[q][6], y[q][7]));
      fence_async_shared();
      named_barrier(1 + wg, 128);     // this warpgroup's A half is written
      if (t == 0) mbar_arrive(bar(BAR_EMPTY_H + s));   // done with the halo

      mbar_wait(bar(BAR_FULL_W + s), (g / stages) & 1);
      wgmma_fence();
      const uint64_t da = sw128_desc(smem_u32(A));
      const uint64_t db = sw128_desc(smem_u32(st + wp_off));
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)     // +32 bytes of K per step
#pragma unroll
        for (int h = 0; h < NACC; ++h)         // + 128 rows of wp^T each
          wgmma_m64n128k16(acc[h], da + 2 * ks,
                           db + h * (WP_BYTES >> 4) + 2 * ks,
                           (kc | ks) != 0);
      wgmma_commit();
      wgmma_wait<1>();                 // the product of chunk kc - 1 is done
      if (kc > 0 && t == 0)
        mbar_arrive(bar(BAR_EMPTY_W + (g - 1) % stages));
    }
    wgmma_wait<0>();
    if (t == 0) mbar_arrive(bar(BAR_EMPTY_W + (g - 1) % stages));

    // epilogue, one round per 128 channels: affine [+ residual] [ReLU] in
    // fp32, one rounding, into the staging tile (the residual's place),
    // which warp 9 stores by TMA
#pragma unroll
    for (int h = 0; h < NACC; ++h, ++rho) {
      mbar_wait(bar(BAR_READY), rho & 1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const int n = U.n0 + BN * h + col;
        float2 sc = make_float2(0.f, 0.f), bi = sc;
        if (n < Cout) {
          sc = __ldg(reinterpret_cast<const float2*>(scale + n));
          bi = __ldg(reinterpret_cast<const float2*>(bias + n));
        }
        unsigned char* slab = staging + (j / 8) * SLAB_BYTES + (lane % 4) * 4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = erow + 8 * r;
          uint32_t* p = reinterpret_cast<uint32_t*>(
              slab + m * 128 + (((j % 8) ^ (m & 7)) << 4));
          float y0 = acc[h][4 * j + 2 * r] * sc.x + bi.x;
          float y1 = acc[h][4 * j + 2 * r + 1] * sc.y + bi.y;
          if (has_res) {
            const uint32_t res = *p;
            y0 += bf_lo(res);
            y1 += bf_hi(res);
          }
          if (relu) {
            y0 = fmaxf(y0, 0.0f);
            y1 = fmaxf(y1, 0.0f);
          }
          *p = pack_bf16(y0, y1);
        }
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(BAR_STAGED));
    }
  }
}

}  // namespace

namespace {

// A 4D map over a bf16 [B, H, W, C] tensor (innermost first: C, W, H, B);
// out-of-bounds elements of a box read as zero.
bool nhwc_map(CUtensorMap* map, const void* ptr, int B, int H, int W, int C,
              int box_c, int box_w, int box_h, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w,
                             (cuuint32_t)box_h, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x [B, H, W, Cin] bf16; wd [3, 3, Cin] fp32; wpt [Cout, Cin] bf16 (wp
// transposed: K-major for wgmma); scale, bias [Cout] fp32; residual (or
// NULL) and out [B, H, W, Cout] bf16. The launch geometry comes from the
// host's plan: a th x tw tile, `stages` ring stages, `smem_bytes` of
// dynamic shared memory, `bn` (128 or 256) output channels per work unit,
// `grid` persistent CTAs. Returns a cudaError_t.
extern "C" int xdt_fused_sepconv_tma(const void* x, const void* wd,
                                     const void* wpt, const void* scale,
                                     const void* bias, const void* residual,
                                     void* out, int B, int H, int W, int Cin,
                                     int Cout, int dilation, int relu, int th,
                                     int tw, int stages, int smem_bytes,
                                     int bn, int grid, void* stream) {
  const uintptr_t addr = (uintptr_t)x | (uintptr_t)wd | (uintptr_t)wpt |
                         (uintptr_t)residual | (uintptr_t)out |
                         (uintptr_t)scale | (uintptr_t)bias;
  const int d = dilation;
  const int64_t tiles_h = (H + th - 1) / th, tiles_w = (W + tw - 1) / tw;
  const int nacc = bn / BN;
  const int64_t tiles_n = (Cout + bn - 1) / bn;
  if (Cin % 8 || Cout % 8 || addr % 16 || d < 1 || th < 1 || tw < 1 ||
      th * tw > ROWS || tw + 2 * d > 256 || th + 2 * d > 256 ||
      stages < 2 || stages > MAX_STAGES || grid < 1 || B < 1 || H < 1 ||
      W < 1 || Cin < 1 || Cout < 1 || (bn != BN && bn != 2 * BN))
    return (int)cudaErrorInvalidValue;
  const Layout L(th, tw, d, stages, nacc);
  if (smem_bytes < L.bytes || smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  const int64_t units = (int64_t)B * tiles_h * tiles_w * tiles_n;
  if (units > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;

  CUtensorMap x_map, wp_map, out_map, res_map;
  bool ok = nhwc_map(&x_map, x, B, H, W, Cin, KC, tw + 2 * d, th + 2 * d,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  ok = ok && nhwc_map(&out_map, out, B, H, W, Cout, 64, tw, th,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  ok = ok && nhwc_map(&res_map, residual ? residual : out, B, H, W, Cout, 64,
                      tw, th, CU_TENSOR_MAP_SWIZZLE_128B);
  {  // wp^T [Cout, Cin]: boxes of bn rows x KC columns, 128-byte swizzle
    const cuuint64_t dims[2] = {(cuuint64_t)Cin, (cuuint64_t)Cout};
    const cuuint64_t strides[1] = {(cuuint64_t)Cin * 2};
    const cuuint32_t box[2] = {KC, (cuuint32_t)bn}, step[2] = {1, 1};
    ok = ok && encoder()(&wp_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(wpt), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  if (!ok) return (int)cudaErrorInvalidValue;

  void (*kernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                 const CUtensorMap, const float*, const float*, const float*,
                 int, int, int, int, int, int, int, int, int, int, int, int) =
      nacc == 1 ? sepconv_tma_kernel<1> : sepconv_tma_kernel<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(grid < units ? grid : units), THREADS, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      x_map, wp_map, out_map, res_map, static_cast<const float*>(wd),
      static_cast<const float*>(scale), static_cast<const float*>(bias), Cin,
      Cout, d, relu, (int)(residual != nullptr), th, tw, (int)tiles_h,
      (int)tiles_w, (int)tiles_n, (int)units, stages);
  return (int)cudaGetLastError();
}
