// fused_bottleneck_kernel: one BN-folded stride-1 ResNet bottleneck in one
// pass, bf16 in and out:
//   y   = relu(x . w1 + b1)                 (1x1, Cin -> Cm), rounded to bf16
//   z   = relu(conv3x3(y) + b2)             (SAME, Cm -> Cm), rounded to bf16
//   out = relu(z . w3 + b3 + residual)      (1x1, Cm -> Cout)
// with residual = x, or x . wd + bd (a 1x1 projection).
//
// Replaces the TPU kernel `fused_bottleneck` (smap_tpu/ops/fused_block.py,
// its body `_kernel`), which walks row bands in order with 1-row halos.
//
// What bounds it on an H100: device memory. At the serving shape (batch 16,
// 128x208, Cin 256, Cm 64, Cout 256) one call moves 436 MB (x in, out out:
// 0.130 ms at 3.35 TB/s) for 59 GFLOP (0.060 ms at 989 TFLOP/s). The
// design keeps every other byte on chip:
//
// - Persistent CTAs, one per SM, each walking 8 x 16 output tiles in
//   raster order (tile -> image, tile row, tile col, cols fastest;
//   `tile_origins` in ops/fused_block.py mirrors it), so that CTAs working
//   side by side share halo rows in L2.
// - All weights resident in shared memory, loaded once per CTA from the
//   image `pack_bottleneck_for_kernel` builds on the host: 64 x 64 blocks,
//   each in the 128-byte swizzle that wgmma reads (w1 Cin/64 blocks, w2 9,
//   w3 and wd 4 each, 136 KB at Cin 256).
// - The 10 x 18 x Cin input halo of a tile arrives by TMA (a 4-D tensor map
//   over NHWC x, box 64 x 18 x 10 x 1, 128-byte swizzle) in 64-channel
//   chunks through a 2-stage ring with one mbarrier per stage; thread 0
//   refills a stage as soon as both warpgroups are done with it, so the
//   next tile's first chunks load while this tile's conv2 and conv3 run.
//   The TMA's zero fill out of bounds is the image border.
// - Two warpgroups (256 threads). Products and the instruction each uses:
//     conv1: M = 180 halo pixels padded to 192, N = 64, K = Cin. A is the x
//       stage, a regular 64-row tile, so `wgmma` reads both operands from
//       shared memory (m64n32k16, each warpgroup 32 of the 64 channels).
//     conv2: M = 128, N = 64, K = 9 taps x 64. A's rows for tap (dy, dx) are
//       16-pixel runs 18 halo pixels apart, which no wgmma descriptor can
//       describe, so `ldmatrix` gathers them (one address per row) into
//       registers for register-A `wgmma` (m64n64k16, a warpgroup per 4
//       output rows).
//     conv3: M = 128, N = 256 in two halves of 128, K = 64. A is z, written
//       by conv2's epilogue as a regular 128-row tile: `wgmma` from shared
//       memory (m64n128k16). A projection adds x . wd into the same
//       accumulators (register-A `wgmma`, A gathered from the x stage):
//       [z | x] . [w3 ; wd], one sum in another order than the plain
//       version's two, well inside the bf16 tolerance.
// - Epilogues in registers: bias, ReLU and bf16 rounding on the accumulator
//   fragments. y and z go to shared memory in the swizzled layout (z aliases
//   y once conv2 has read it). w3's and wd's columns are permuted on the
//   host (`conv3_column_order`) so that each thread holds 8 consecutive
//   output channels: out is stored, and the identity residual read back
//   from x (L2-resident since its TMA load), 16 bytes at a time.
//
// Padding: SAME zero padding applies to conv2's input y. The TMA fills x
// with zeros outside the image, but conv1 of a zero pixel is relu(b1): the
// conv1 epilogue writes y = 0 at halo positions outside the image. Pixels
// past a ragged right or bottom edge are computed and never stored.
//
// Shared memory at Cin 256: weights 136 KB, x ring 2 x 24 KB, y/z 24 KB,
// 208 KB in all; at Cin 64 with the projection: 144 + 48 + 24 = 216 KB.
// Limits: Cin a multiple of 16 up to 256 (up to 64 with a projection),
// Cm <= 64 and Cout <= 256, zero-padded on the host.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTH = 8, kTW = 16;                 // output tile
constexpr int kHaloH = kTH + 2, kHaloW = kTW + 2;
constexpr int kHalo = kHaloH * kHaloW;           // 180 halo pixels
constexpr int kRowBytes = 128;                   // 64 bf16 channels
constexpr int kStageBytes = 192 * kRowBytes;     // 3 wgmma M tiles of 64
constexpr int kBoxBytes = kHalo * kRowBytes;     // what one TMA load writes
constexpr int kBlockBytes = 64 * kRowBytes;      // one 64 x 64 weight block
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;                 // an H100 block's limit
constexpr int kBias = 64 + 64 + 256 + 256;       // b1, b2, b3, bd

struct Layout {
  int w1, w2, w3, wd, x, y, bias, bar, total;
};

__host__ __device__ inline Layout layout(int nk, bool proj) {
  Layout l;
  l.w1 = 0;
  l.w2 = nk * kBlockBytes;
  l.w3 = l.w2 + 9 * kBlockBytes;
  l.wd = l.w3 + 4 * kBlockBytes;
  l.x = l.wd + (proj ? 4 * kBlockBytes : 0);
  l.y = l.x + 2 * kStageBytes;
  l.bias = l.y + kStageBytes;
  l.bar = l.bias + kBias * 4;
  l.total = l.bar + 16;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart. Every operand base is 1024-byte aligned; a K step of 16
// adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16)
       | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of wgmma's registers (accumulators,
// register A) across the wait that makes them valid.
template <int N>
__device__ __forceinline__ void fence_f32(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_u32(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* a, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// Waits for the phase of parity `parity` of `bar` to complete. A load that
// never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA load of a 64 x 18 x 10 x 1 box of x, completing on `bar`.
__device__ __forceinline__ void tma_load_halo(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int c, int w,
                                              int h, int b) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(kBoxBytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c),
      "r"(w), "r"(h), "r"(b)
      : "memory");
}

// wgmma, both operands from shared memory (SS) or A from registers (RS);
// `accumulate` 0 overwrites the accumulators.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

struct TileOrigin {
  int b, h0, w0;
};

__device__ __forceinline__ TileOrigin tile_origin(int tile, int ntx,
                                                  int nty) {
  return {tile / (ntx * nty), (tile / ntx) % nty * kTH, tile % ntx * kTW};
}

__global__ void __launch_bounds__(kThreads, 1)
fused_bottleneck_kernel(const __grid_constant__ CUtensorMap xmap,
                        const bf16* __restrict__ x,
                        const uint4* __restrict__ wpack,
                        const float* __restrict__ bias,
                        bf16* __restrict__ out, int H, int W, int cin,
                        int cout, int nk, int proj, int ntiles, int ntx,
                        int nty) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout l = layout(nk, proj != 0);
  const uint32_t s0 = smem_u32(smem);
  const uint32_t w1_s = s0 + l.w1, w2_s = s0 + l.w2, w3_s = s0 + l.w3,
                 wd_s = s0 + l.wd, x_s = s0 + l.x, y_s = s0 + l.y,
                 bar_s = s0 + l.bar;
  unsigned char* y_g = smem + l.y;            // y, then z, generic pointer
  float* bias_s = reinterpret_cast<float*>(smem + l.bias);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int my_tiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int loads = my_tiles * nk;            // chunk loads of this CTA

  // Load L = tile iteration * nk + chunk, into stage L % 2; thread 0 only.
  auto load_chunk = [&](int L) {
    const TileOrigin o = tile_origin(blockIdx.x + (L / nk) * gridDim.x,
                                     ntx, nty);
    tma_load_halo(x_s + (L & 1) * kStageBytes, &xmap, bar_s + (L & 1) * 8,
                  (L % nk) * 64, o.w0 - 1, o.h0 - 1, o.b);
  };
  if (tid == 0) {
    mbar_init(bar_s, 1);
    mbar_init(bar_s + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int L = 0; L < 2 && L < loads; ++L) load_chunk(L);
  }
  // The weights and biases, once per CTA.
  const int wbytes = l.x - l.w1;
  uint4* wdst = reinterpret_cast<uint4*>(smem + l.w1);
  for (int i = tid; i < wbytes / 16; i += kThreads) wdst[i] = __ldg(wpack + i);
  for (int i = tid; i < kBias; i += kThreads)
    bias_s[i] = __ldg(bias + i);
  // Generic-proxy writes that wgmma (the async proxy) will read.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int it = 0; it < my_tiles; ++it) {
    const TileOrigin o = tile_origin(blockIdx.x + it * gridDim.x, ntx, nty);

    // conv1 over the halo, each warpgroup 32 of the 64 channels.
    float acc1[3][16] = {};
    for (int kc = 0; kc < nk; ++kc) {
      const int L = it * nk + kc, s = L & 1;
      mbar_wait(bar_s + s * 8, (L >> 1) & 1);
      const uint32_t xa = x_s + s * kStageBytes;
      const uint32_t wb = w1_s + kc * kBlockBytes + wg * 4096;
#pragma unroll
      for (int m = 0; m < 3; ++m) fence_f32<16>(acc1[m]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int m = 0; m < 3; ++m)
          wgmma_ss_n32(acc1[m], desc128(xa + m * 8192 + 32 * k),
                       desc128(wb + 32 * k), kc | k);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int m = 0; m < 3; ++m) fence_f32<16>(acc1[m]);
      if (!proj) {        // the residual comes from x in device memory
        __syncthreads();  // both warpgroups are done with this stage
        if (tid == 0 && L + 2 < loads) load_chunk(L + 2);
      }
    }
    // y = relu(acc + b1) in bf16; 0 outside the image (conv2's padding).
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int p = 64 * m + 16 * warp + g + 8 * v;
        const int hy = p / kHaloW, hx = p - hy * kHaloW;
        const int gy = o.h0 - 1 + hy, gx = o.w0 - 1 + hx;
        const bool inside =
            p < kHalo && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 32 * wg + 8 * j + 2 * q;
          const float lo = fmaxf(acc1[m][4 * j + 2 * v] + bias_s[n], 0.0f);
          const float hi =
              fmaxf(acc1[m][4 * j + 2 * v + 1] + bias_s[n + 1], 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(
              y_g + p * kRowBytes + (((n >> 3) ^ (p & 7)) << 4) + 4 * q) =
              inside ? __floats2bfloat162_rn(lo, hi)
                     : __floats2bfloat162_rn(0.0f, 0.0f);
        }
      }
    __syncthreads();

    // conv2 (3x3 SAME): output row i, tap (dy, dx) reads the 16 halo
    // pixels from (i + dy, dx); warp `warp` of warpgroup `wg` owns row i.
    const int i_row = 4 * wg + warp;
    float acc2[32] = {};
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int p = (i_row + t / 3) * kHaloW + t % 3 + (lane & 15);
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(a[kk], y_s + p * kRowBytes
                           + (((2 * kk + (lane >> 4)) ^ (p & 7)) << 4));
      fence_f32<32>(acc2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64(acc2, a[kk], desc128(w2_s + t * kBlockBytes + 32 * kk),
                     t | kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_f32<32>(acc2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_u32<4>(a[kk]);
    }
    __syncthreads();      // all of y read: z takes its place
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int P = 64 * wg + 16 * warp + g + 8 * v;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * j + 2 * q;
        *reinterpret_cast<__nv_bfloat162*>(
            y_g + P * kRowBytes + ((j ^ (P & 7)) << 4) + 4 * q) =
            __floats2bfloat162_rn(
                fmaxf(acc2[4 * j + 2 * v] + bias_s[64 + n], 0.0f),
                fmaxf(acc2[4 * j + 2 * v + 1] + bias_s[64 + n + 1], 0.0f));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // conv3 (+ projection) and the output, in halves of 128 channels.
    const uint32_t xa = x_s + ((it * nk) & 1) * kStageBytes;
    const int nhalf = cout > 128 ? 2 : 1;
    for (int nh = 0; nh < nhalf; ++nh) {
      float acc3[64] = {};
      uint32_t a[4][4] = {};
      if (proj) {         // tile row i_row of x: halo row i_row + 1, col 1
        const int p = (i_row + 1) * kHaloW + 1 + (lane & 15);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          ldsm_x4(a[k], xa + p * kRowBytes
                            + (((2 * k + (lane >> 4)) ^ (p & 7)) << 4));
      }
      // The thread's outputs: pixel P (rows g and g + 8 of the warp's 16),
      // channels ch .. ch + 7 of each group G of 32 (columns 32G + 8t +
      // 2q + e hold channel 32G + 8q + 2t + e). The identity residual is
      // loaded before the products, so its latency hides behind them.
      uint4 res[2][4];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int P = 64 * wg + 16 * warp + g + 8 * v;
        const int gy = o.h0 + P / kTW, gx = o.w0 + P % kTW;
        const long long pix = (static_cast<long long>(o.b) * H + gy) * W + gx;
#pragma unroll
        for (int G = 0; G < 4; ++G) {
          const int ch = 128 * nh + 32 * G + 8 * q;
          res[v][G] = make_uint4(0u, 0u, 0u, 0u);
          if (!proj && gy < H && gx < W && ch < cout)
            res[v][G] =
                __ldg(reinterpret_cast<const uint4*>(x + pix * cin + ch));
        }
      }
      fence_f32<64>(acc3);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_ss_n128(acc3, desc128(y_s + wg * 8192 + 32 * k),
                      desc128(w3_s + nh * 16384 + 32 * k), k);
      if (proj) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_rs_n128(acc3, a[k], desc128(wd_s + nh * 16384 + 32 * k), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_f32<64>(acc3);
#pragma unroll
      for (int k = 0; k < 4; ++k) fence_u32<4>(a[k]);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int P = 64 * wg + 16 * warp + g + 8 * v;
        const int gy = o.h0 + P / kTW, gx = o.w0 + P % kTW;
        if (gy >= H || gx >= W) continue;
        const long long pix = (static_cast<long long>(o.b) * H + gy) * W + gx;
#pragma unroll
        for (int G = 0; G < 4; ++G) {
          const int ch = 128 * nh + 32 * G + 8 * q;
          if (ch >= cout) continue;
          const __nv_bfloat162* r2 =
              reinterpret_cast<const __nv_bfloat162*>(&res[v][G]);
          uint4 packed;
          __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int c = ch + 2 * t;
            const float2 r = __bfloat1622float2(r2[t]);
            const float v0 = acc3[4 * (4 * G + t) + 2 * v] + bias_s[128 + c]
                             + bias_s[384 + c] + r.x;
            const float v1 = acc3[4 * (4 * G + t) + 2 * v + 1]
                             + bias_s[128 + c + 1] + bias_s[384 + c + 1]
                             + r.y;
            o2[t] = __floats2bfloat162_rn(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
          }
          *reinterpret_cast<uint4*>(out + pix * cout + ch) = packed;
        }
      }
    }
    __syncthreads();      // z and this tile's x stage are free
    if (proj && tid == 0 && it * nk + 2 < loads)
      load_chunk(it * nk + 2);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: it is looked up through the
// runtime's entry-point query, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

}  // namespace

// x [B, H, W, cin] bf16 NHWC, 16-byte aligned; wpack the weight image of
// pack_bottleneck_for_kernel (ops/fused_block.py); bias [640] f32 (b1, b2,
// b3, bd); out [B, H, W, cout] bf16. cin, cout multiples of 16, cin <= 256
// (<= 64 with proj), cout <= 256, cin == cout without proj.
extern "C" int fused_bottleneck_launch(const void* x, const void* wpack,
                                       const float* bias, void* out, int B,
                                       int H, int W, int cin, int cout,
                                       int proj, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || cin % 16
      || cout % 16 || cin > 256 || cout > 256 || (proj && cin > 64)
      || (!proj && cin != cout))
    return (int)cudaErrorInvalidValue;
  const int nk = (cin + 63) / 64;
  const size_t smem = (size_t)layout(nk, proj != 0).total + 1024;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2,
                                 (cuuint64_t)W * cin * 2,
                                 (cuuint64_t)H * W * cin * 2};
  const cuuint32_t box[4] = {64, kHaloW, kHaloH, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_bottleneck_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntx = (W + kTW - 1) / kTW, nty = (H + kTH - 1) / kTH;
  const long long ntiles = (long long)B * ntx * nty;
  if (ntiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  fused_bottleneck_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      map, (const bf16*)x, (const uint4*)wpack, bias, (bf16*)out, H, W, cin,
      cout, nk, proj, (int)ntiles, ntx, nty);
  return (int)cudaGetLastError();
}
