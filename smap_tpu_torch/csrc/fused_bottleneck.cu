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
// What bounds it on an H100: the products. At the serving shape (batch 16,
// 128x208, Cin 256, Cm 64) one call is ~60 GFLOP against ~0.45 GB of
// device-memory traffic for x and out, so it sits on the compute side of
// the bf16 roofline, and only the tensor cores make it fast. The design:
// one block per (image, 8 x 16 output tile), 8 warps. The block stages the
// 10 x 18 input halo in shared memory once; computes y over the halo (the
// 3x3's one-pixel border) with `nvcuda::wmma` bf16 16x16x16 products and
// float32 accumulators; then z over the tile, as 9 shifted products whose
// A tiles are rows of y in shared memory (a tile row of 16 pixels is one
// 16-row A tile); then the output with the residual in the epilogue. y and
// z never leave shared memory. Weights are read as wmma B tiles straight
// from device memory, where they stay in L2 (w2 alone is 72 KB).
//
// Padding: SAME zero padding applies to conv2's input y. Halo positions
// outside the image get y = 0, not relu(b1). Positions past a ragged
// right or bottom edge are computed on zeros and never written.
//
// Shared memory rows carry 16 extra elements: a row stays 32-byte aligned,
// as wmma's loads need, and consecutive rows start in other banks.
// This is a simple first version: no wgmma, no TMA, no software pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTH = 8;                       // output rows per block
constexpr int kTW = 16;                      // output cols per block (one A tile)
constexpr int kHaloW = kTW + 2;              // 18
constexpr int kHalo = (kTH + 2) * kHaloW;    // 180 halo pixels
constexpr int kHaloRows = 192;               // padded to 12 A tiles
constexpr int kPix = kTH * kTW;              // 128
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSkew = 16;
constexpr int kMaxSmem = 232448;             // an H100 block's limit

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

size_t smem_bytes(int cin, int cm) {
  return sizeof(float) * kWarps * 512
       + sizeof(bf16) * ((size_t)kHaloRows * (cin + kSkew)
                         + (size_t)kHaloRows * (cm + kSkew)
                         + (size_t)kPix * (cm + kSkew));
}

__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2, const float* __restrict__ b2,
                        const bf16* __restrict__ w3, const float* __restrict__ b3,
                        const bf16* __restrict__ wd, const float* __restrict__ bd,
                        bf16* __restrict__ out, int H, int W, int cin, int cm,
                        int cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(smem) + warp * 512;
  const int ldx = cin + kSkew, ldy = cm + kSkew, ldz = cm + kSkew;
  bf16* xs = reinterpret_cast<bf16*>(smem + sizeof(float) * kWarps * 512);
  bf16* ys = xs + kHaloRows * ldx;
  bf16* zs = ys + kHaloRows * ldy;

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;

  // x over the halo, 16 bytes at a time; zeros outside the image and in
  // the padding rows.
  const int chunks = cin / 8;
  for (int e = threadIdx.x; e < kHaloRows * chunks; e += kThreads) {
    const int p = e / chunks, k = e % chunks;
    const int gy = h0 - 1 + p / kHaloW, gx = w0 - 1 + p % kHaloW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p < kHalo && gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const uint4*>(
          x + (((long long)b * H + gy) * W + gx) * cin + k * 8);
    *reinterpret_cast<uint4*>(xs + p * ldx + k * 8) = v;
  }
  __syncthreads();

  // conv1 over the halo: y = relu(x . w1 + b1), 0 outside the image.
  const int nm = cm / 16;
  for (int t = warp; t < (kHaloRows / 16) * nm; t += kWarps) {
    const int mt = t / nm, nt = t % nm;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < cin; k0 += 16) {
      FragA a;
      FragB bw;
      wmma::load_matrix_sync(a, xs + mt * 16 * ldx + k0, ldx);
      wmma::load_matrix_sync(bw, w1 + k0 * cm + nt * 16, cm);
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int p = mt * 16 + e / 16, n = nt * 16 + e % 16;
      const int gy = h0 - 1 + p / kHaloW, gx = w0 - 1 + p % kHaloW;
      const bool inside = p < kHalo && gy >= 0 && gy < H && gx >= 0 && gx < W;
      ys[p * ldy + n] =
          __float2bfloat16_rn(inside ? fmaxf(scratch[e] + b1[n], 0.0f) : 0.0f);
    }
    __syncwarp();
  }
  __syncthreads();

  // conv2 (3x3 SAME) over the tile: output row i, tap (dy, dx) reads the
  // 16 consecutive halo pixels starting at (i + dy, dx).
  for (int t = warp; t < kTH * nm; t += kWarps) {
    const int i = t / nm, nt = t % nm;
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const bf16* arow = ys + ((i + dy) * kHaloW + dx) * ldy;
        const bf16* wtap = w2 + (dy * 3 + dx) * cm * cm;
        for (int k0 = 0; k0 < cm; k0 += 16) {
          FragA a;
          FragB bw;
          wmma::load_matrix_sync(a, arow + k0, ldy);
          wmma::load_matrix_sync(bw, wtap + k0 * cm + nt * 16, cm);
          wmma::mma_sync(acc, a, bw, acc);
        }
      }
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int n = nt * 16 + e % 16;
      zs[(i * 16 + e / 16) * ldz + n] =
          __float2bfloat16_rn(fmaxf(scratch[e] + b2[n], 0.0f));
    }
    __syncwarp();
  }
  __syncthreads();

  // conv3 + residual: out = relu((z . w3 + b3) + residual).
  const int nc = cout / 16;
  for (int t = warp; t < kTH * nc; t += kWarps) {
    const int i = t / nc, nt = t % nc;
    const bf16* xc = xs + ((i + 1) * kHaloW + 1) * ldx;   // tile row i of x
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < cm; k0 += 16) {
      FragA a;
      FragB bw;
      wmma::load_matrix_sync(a, zs + i * 16 * ldz + k0, ldz);
      wmma::load_matrix_sync(bw, w3 + k0 * cout + nt * 16, cout);
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    if (wd != nullptr) {
      FragC accr;
      wmma::fill_fragment(accr, 0.0f);
      for (int k0 = 0; k0 < cin; k0 += 16) {
        FragA a;
        FragB bw;
        wmma::load_matrix_sync(a, xc + k0, ldx);
        wmma::load_matrix_sync(bw, wd + k0 * cout + nt * 16, cout);
        wmma::mma_sync(accr, a, bw, accr);
      }
      wmma::store_matrix_sync(scratch + 256, accr, 16, wmma::mem_row_major);
    }
    __syncwarp();
    const int gy = h0 + i;
    for (int e = lane; e < 256; e += 32) {
      const int j = e / 16, n = nt * 16 + e % 16;
      const int gx = w0 + j;
      if (gy < H && gx < W) {
        const float o = scratch[e] + b3[n];
        const float res = wd != nullptr ? scratch[256 + e] + bd[n]
                                        : __bfloat162float(xc[j * ldx + n]);
        out[(((long long)b * H + gy) * W + gx) * cout + n] =
            __float2bfloat16_rn(fmaxf(o + res, 0.0f));
      }
    }
    __syncwarp();
  }
}

}  // namespace

// x [B, H, W, cin] bf16 NHWC; w1 [cin, cm], w2 [3, 3, cm, cm], w3 [cm, cout],
// wd [cin, cout] or null, bf16; biases f32; out [B, H, W, cout] bf16.
// cin, cm and cout are multiples of 16.
extern "C" int fused_bottleneck_launch(
    const void* x, const void* w1, const float* b1, const void* w2,
    const float* b2, const void* w3, const float* b3, const void* wd,
    const float* bd, void* out, int B, int H, int W, int cin, int cm,
    int cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || cin % 16 || cm % 16
      || cout % 16 || cin <= 0 || cm <= 0 || cout <= 0
      || (wd == nullptr && cin != cout))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(cin, cm);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  fused_bottleneck_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, b1, (const bf16*)w2, b2,
      (const bf16*)w3, b3, (const bf16*)wd, bd, (bf16*)out, H, W, cin, cm,
      cout);
  return (int)cudaGetLastError();
}
