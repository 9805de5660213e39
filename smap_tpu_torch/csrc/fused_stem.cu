// fused_stem_kernel: the stem of a BN-folded SMAP in one pass,
// out = maxpool3x3/2(relu(conv7x7/2(x) + bias)), bf16 in, bf16 out.
//
// Replaces the TPU kernel `fused_stem` (smap_tpu/ops/fused_stem.py, its
// body `_kernel`). The TPU kernel reads a double space-to-depth image and
// splits the conv into per-parity matmuls to avoid stride-2 vector access;
// none of that is needed here: this kernel reads the NHWC image directly.
//
// What bounds it on an H100: the conv's arithmetic. At batch 16 and 512x832
// it is 147 multiply-adds per conv output, 32.1 GFLOP (0.0325 ms at the
// bf16 tensor-core peak), against 41 MB in and 54.5 MB out (0.0285 ms at
// 3.35 TB/s). The design is an implicit GEMM on the tensor cores:
//
// - A block stages the input patch of a 7 x 15 pool tile in shared memory
//   as NHWC with Cin padded 3 -> 4 (the 4th channel 0): 35 rows x 70 pixels
//   x 8 bytes. For conv position (r, s) and kernel row kh, the 7 taps x 4
//   channels are 28 consecutive bf16 at element 8s of patch row 2r + kh, a
//   16-byte aligned address. Reading 32 of them makes one 32-wide K slice,
//   so `ldmatrix` feeds mma A fragments straight from the patch with no
//   im2col copy: K = 7 kh x 32 = 224, the weights zero for kw = 7 and
//   ci = 3 (the 4 extra values per kh read a finite neighbouring pixel,
//   times 0). The padding costs 224 / 147 = 1.5x the products.
// - N = 64 output channels; the padded weights [64][224] (29 KB, rows 464
//   bytes apart so that ldmatrix is free of bank conflicts) stay resident
//   in shared memory. Products are `mma.sync.m16n8k16` bf16 with float32
//   sums: a warp computes two conv rows of the tile (31 positions each, as
//   two 16-row tiles) and shares each B fragment between the four tiles;
//   the 15 conv rows of a tile make 8 such units for the 4 warps.
// - The epilogue adds the bias, applies the ReLU and rounds to bf16 into a
//   conv buffer in shared memory (15 x 31 x 64); the 3x3/2 max-pool then
//   reads it 16 bytes at a time and stores 16-byte chunks of the output.
//   Rounding before the max equals rounding after it: round-to-nearest is
//   monotone.
// - Persistent blocks (two per SM, 107 KB of shared memory each) walk the
//   tiles, so the weights are read once per block.
//
// Padding: the conv's zero padding is a zero in the staged patch. A pool
// window's padding row or column is not a conv output: it is set to 0
// after the ReLU, which is the same as -inf because every window also
// holds a real, non-negative conv output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCout = 64;
constexpr int kTP = 7;                        // pool rows per tile
constexpr int kTQ = 15;                       // pool cols per tile
constexpr int kConvRows = 2 * kTP + 1;        // 15
constexpr int kConvCols = 2 * kTQ + 1;        // 31 (32 computed)
constexpr int kPatchRows = 4 * kTP + 7;       // 35
constexpr int kPatchCols = 2 * 32 + 6;        // 70: conv col 31, tap 7
constexpr int kPatchRowBytes = kPatchCols * 8;  // 4 bf16 channels a pixel
constexpr int kK = 7 * 32;                    // 224
constexpr int kWRow = kK + 8;                 // 232 bf16, 464 bytes
constexpr int kThreads = 128;
constexpr int kPatchBytes = kPatchRows * kPatchRowBytes;
constexpr int kWBytes = kCout * kWRow * 2;
constexpr int kConvBytes = kConvRows * kConvCols * 128;
constexpr int kSmem = kPatchBytes + kWBytes + kConvBytes + kCout * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* a, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NR conv rows from local row i0 (global 2*P0-1+i0): positions s = 0..31
// (global col 2*Q0-1+s) of each row as two 16-row A tiles, every B
// fragment shared by the 2 * NR tiles; then bias, ReLU and bf16 into the
// conv buffer, 0 where the pool's padding is (no conv output there).
template <int NR>
__device__ __forceinline__ void conv_rows(int i0, uint32_t patch_s,
                                          uint32_t w_s, unsigned char* conv,
                                          const float* bias_s, int P0, int Q0,
                                          int Hc, int Wc) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  float acc[NR][2][8][4] = {};
#pragma unroll 1
  for (int kh = 0; kh < 7; ++kh) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[NR][2][4], bw[4][4];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(a[r][mt], patch_s + (2 * (i0 + r) + kh) * kPatchRowBytes
                                + (16 * mt + (lane & 15)) * 16
                                + (2 * kk + (lane >> 4)) * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n = 16 * np + ((lane >> 4) << 3) + (lane & 7);
        const int k = kh * 32 + kk * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(bw[np], w_s + n * (kWRow * 2) + k * 2);
      }
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma_16816(acc[r][mt][nt], a[r][mt], bw[nt / 2][(nt % 2) * 2],
                      bw[nt / 2][(nt % 2) * 2 + 1]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = i0 + r, rg = 2 * P0 - 1 + i;
    const bool row_ok = rg >= 0 && rg < Hc;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int s = 16 * mt + g + 8 * v;
        const int cs = 2 * Q0 - 1 + s;
        const bool ok = row_ok && cs >= 0 && cs < Wc;
        if (s >= kConvCols) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = 8 * nt + 2 * q;
          const float lo = fmaxf(acc[r][mt][nt][2 * v] + bias_s[n], 0.0f);
          const float hi =
              fmaxf(acc[r][mt][nt][2 * v + 1] + bias_s[n + 1], 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(
              conv + (i * kConvCols + s) * 128 + ((nt ^ (s & 7)) << 4)
              + 4 * q) = ok ? __floats2bfloat162_rn(lo, hi)
                            : __floats2bfloat162_rn(0.0f, 0.0f);
        }
      }
  }
}

template <int CIN>
__global__ void __launch_bounds__(kThreads, 2)
fused_stem_kernel(const bf16* __restrict__ x,
                  const uint4* __restrict__ wpack,   // [64][232] bf16
                  const float* __restrict__ bias,
                  bf16* __restrict__ out, int H, int W, int Hc, int Wc,
                  int Hp, int Wp, int ntiles, int ntq, int ntp) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* patch = smem;
  unsigned char* wts = smem + kPatchBytes;
  unsigned char* conv = wts + kWBytes;
  float* bias_s = reinterpret_cast<float*>(conv + kConvBytes);
  const uint32_t patch_s = smem_u32(patch), w_s = smem_u32(wts);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;

  for (int i = tid; i < kWBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(wts)[i] = __ldg(wpack + i);
  if (tid < kCout) bias_s[tid] = __ldg(bias + tid);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (ntq * ntp);
    const int P0 = (tile / ntq) % ntp * kTP, Q0 = tile % ntq * kTQ;
    // Input patch: rows 4*P0-5 .., cols 4*Q0-5 .., zero outside the image
    // (the conv's padding) and in the 4th channel.
    const int r0 = 4 * P0 - 5, c0 = 4 * Q0 - 5;
    const bf16* xb = x + (long long)b * H * W * CIN;
    for (int e = tid; e < kPatchRows * kPatchCols; e += kThreads) {
      const int row = e / kPatchCols, col = e - row * kPatchCols;
      const int gy = r0 + row, gx = c0 + col;
      uint2 v = make_uint2(0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const bf16* px = xb + ((long long)gy * W + gx) * CIN;
        if (CIN == 4) {
          v = __ldg(reinterpret_cast<const uint2*>(px));
        } else {
          const unsigned short* p16 =
              reinterpret_cast<const unsigned short*>(px);
          v.x = (uint32_t)__ldg(p16) | ((uint32_t)__ldg(p16 + 1) << 16);
          v.y = (uint32_t)__ldg(p16 + 2);
        }
      }
      *reinterpret_cast<uint2*>(patch + row * kPatchRowBytes + col * 8) = v;
    }
    __syncthreads();

    // Conv rows of the tile (local i, global 2*P0-1+i) in units of two
    // rows (one of one row at the end), a unit per warp.
    for (int u = warp; u < (kConvRows + 1) / 2; u += kThreads / 32) {
      if (2 * u + 1 < kConvRows)
        conv_rows<2>(2 * u, patch_s, w_s, conv, bias_s, P0, Q0, Hc, Wc);
      else
        conv_rows<1>(2 * u, patch_s, w_s, conv, bias_s, P0, Q0, Hc, Wc);
    }
    __syncthreads();

    // 3x3/2 max-pool: pool (pp, qq) covers conv rows 2pp..2pp+2 and cols
    // 2qq..2qq+2 of the tile; 8 channels (16 bytes) per item.
    for (int e = tid; e < kTP * kTQ * 8; e += kThreads) {
      const int c = e % 8, qq = (e / 8) % kTQ, pp = e / (8 * kTQ);
      const int p = P0 + pp, qo = Q0 + qq;
      if (p >= Hp || qo >= Wp) continue;
      __nv_bfloat162 m[4];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int s = 2 * qq + dx;
          const uint4 v = *reinterpret_cast<const uint4*>(
              conv + ((2 * pp + dy) * kConvCols + s) * 128
              + ((c ^ (s & 7)) << 4));
          const __nv_bfloat162* v2 =
              reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int t = 0; t < 4; ++t)
            m[t] = (dy == 0 && dx == 0) ? v2[t] : __hmax2(m[t], v2[t]);
        }
      *reinterpret_cast<uint4*>(
          out + (((long long)b * Hp + p) * Wp + qo) * kCout + 8 * c) =
          *reinterpret_cast<const uint4*>(m);
    }
  }
}

template <int CIN>
int launch(const void* x, const void* wpack, const float* bias, void* out,
           int B, int H, int W, cudaStream_t stream) {
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1, Wp = (Wc - 1) / 2 + 1;
  const int ntq = (Wp + kTQ - 1) / kTQ, ntp = (Hp + kTP - 1) / kTP;
  const long long ntiles = (long long)B * ntq * ntp;
  if (ntiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_stem_kernel<CIN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(ntiles < 2 * sms ? ntiles : 2 * sms);
  fused_stem_kernel<CIN><<<grid, kThreads, kSmem, stream>>>(
      (const bf16*)x, (const uint4*)wpack, bias, (bf16*)out, H, W, Hc, Wc,
      Hp, Wp, (int)ntiles, ntq, ntp);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, cin] bf16 NHWC (cin 3 or 4; 8-byte aligned for 4); wpack the
// padded weights of pack_stem_for_kernel (ops/fused_stem.py), [64][232]
// bf16, 16-byte aligned; bias [64] f32; out [B, Hp, Wp, 64] bf16.
extern "C" int fused_stem_launch(const void* x, const void* wpack,
                                 const float* bias, void* out, int B, int H,
                                 int W, int cin, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (cin == 3)
    return launch<3>(x, wpack, bias, out, B, H, W, (cudaStream_t)stream);
  if (cin == 4)
    return launch<4>(x, wpack, bias, out, B, H, W, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
