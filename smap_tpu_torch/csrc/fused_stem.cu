// fused_stem_kernel: the stem of a BN-folded SMAP in one pass,
// out = maxpool3x3/2(relu(conv7x7/2(x) + bias)), bf16 in, bf16 out.
//
// Replaces the TPU kernel `fused_stem` (smap_tpu/ops/fused_stem.py, its
// body `_kernel`). The TPU kernel reads a double space-to-depth image and
// splits the conv into per-parity matmuls to avoid stride-2 vector access;
// none of that is needed here: this kernel reads the NHWC image directly.
//
// What bounds it on an H100: arithmetic on the CUDA cores. Cin is 3, so the
// conv is 147 multiply-adds per output (about 32 GFLOP at batch 16 and
// 512x832), too narrow for the tensor cores' K of 16 without padding it 5x;
// the bytes (41 MB in, 27 MB out) are small. The design keeps everything of
// one tile on chip: a block takes 8 x 16 pool outputs of one image, stages
// the 39 x 71 input patch they need and the 7x7xCinx64 weights in shared
// memory as float32, computes the 17 x 33 conv outputs under them, and
// pools in registers; only the pool outputs reach device memory.
//
// Thread (g, c) owns output channel c and 4 adjacent pool columns: per conv
// row it computes the 9 conv columns those pool windows cover (1.125x the
// conv work), pools them across columns, and carries the row pool from one
// conv row to the next. Each multiply-add is an explicit __fmaf_rn: a
// product of two bf16 values is exact in float32, so it rounds as the plain
// version's multiply-then-add does, and the library's -fmad=false does not
// split it.
//
// Padding: the conv's zero padding is a zero in the staged patch. A pool
// window's padding row or column is not a conv output: it is set to 0
// after the ReLU, which is the same as -inf because every window also
// holds a real, non-negative conv output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCout = 64;
constexpr int kTileP = 8;                   // pool rows per block
constexpr int kTileQ = 16;                  // pool cols per block
constexpr int kGroups = 4;                  // threads per channel
constexpr int kQPerThread = kTileQ / kGroups;
constexpr int kThreads = kCout * kGroups;
constexpr int kConvRows = 2 * kTileP + 1;   // 17
constexpr int kConvCols = 2 * kQPerThread + 1;  // 9 per thread
constexpr int kPatchRows = 4 * kTileP + 7;  // 39
constexpr int kPatchCols = 4 * kTileQ + 7;  // 71
constexpr int kSegCols = 2 * (kConvCols - 1) + 7;  // 23 input cols a thread reads

template <int CIN>
constexpr int smem_floats() {
  return kPatchRows * kPatchCols * CIN + 49 * CIN * kCout;
}

template <int CIN>
__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,  // [64, CIN, 7, 7]
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int H, int W, int Hc,
                  int Wc, int Hp, int Wp) {
  extern __shared__ float smem[];
  float* xs = smem;                                      // [39][71][CIN]
  float* ws = smem + kPatchRows * kPatchCols * CIN;      // [49*CIN][64]

  const int b = blockIdx.z;
  const int P0 = blockIdx.y * kTileP;
  const int Q0 = blockIdx.x * kTileQ;
  const int tid = threadIdx.x;
  const int c = tid % kCout;
  const int g = tid / kCout;

  // Input patch: rows 4*P0-5 .. 4*P0+33, cols 4*Q0-5 .. 4*Q0+65, zero
  // outside the image (the conv's padding).
  const int r0 = 4 * P0 - 5, s0 = 4 * Q0 - 5;
  const __nv_bfloat16* xb = x + (long long)b * H * W * CIN;
  for (int e = tid; e < kPatchRows * kPatchCols * CIN; e += kThreads) {
    const int ci = e % CIN;
    const int col = (e / CIN) % kPatchCols;
    const int row = e / (CIN * kPatchCols);
    const int gy = r0 + row, gx = s0 + col;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __bfloat162float(xb[((long long)gy * W + gx) * CIN + ci]);
    xs[e] = v;
  }
  // Weights, OIHW in device memory -> [(kh*7+kw)*CIN+ci][co] here.
  for (int e = tid; e < kCout * CIN * 49; e += kThreads) {
    const int kw = e % 7, kh = (e / 7) % 7;
    const int ci = (e / 49) % CIN, co = e / (49 * CIN);
    ws[((kh * 7 + kw) * CIN + ci) * kCout + co] = __bfloat162float(w[e]);
  }
  __syncthreads();

  const float bc = bias[c];
  const int q_first = Q0 + g * kQPerThread;       // first pool col owned
  const int s_first = 2 * q_first - 1;            // first conv col needed
  float run[kQPerThread];
  __nv_bfloat16* ob = out + (long long)b * Hp * Wp * kCout;

  for (int i = 0; i < kConvRows; ++i) {
    const int r = 2 * P0 - 1 + i;                 // global conv row
    float acc[kConvCols];
#pragma unroll
    for (int u = 0; u < kConvCols; ++u) acc[u] = 0.0f;
    for (int kh = 0; kh < 7; ++kh) {
      // Patch row of input row 2r-3+kh; the thread's 23 input columns.
      const float* xrow = xs + ((2 * i + kh) * kPatchCols
                                + 4 * kQPerThread * g) * CIN;
      float seg[kSegCols * CIN];
#pragma unroll
      for (int t = 0; t < kSegCols * CIN; ++t) seg[t] = xrow[t];
#pragma unroll
      for (int kw = 0; kw < 7; ++kw) {
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          const float wv = ws[((kh * 7 + kw) * CIN + ci) * kCout + c];
#pragma unroll
          for (int u = 0; u < kConvCols; ++u)
            acc[u] = __fmaf_rn(seg[(2 * u + kw) * CIN + ci], wv, acc[u]);
        }
      }
    }
    // Bias, ReLU; pool padding (no conv output there) becomes 0.
    const bool row_ok = r >= 0 && r < Hc;
#pragma unroll
    for (int u = 0; u < kConvCols; ++u) {
      const int s = s_first + u;
      const float v = fmaxf(acc[u] + bc, 0.0f);
      acc[u] = (row_ok && s >= 0 && s < Wc) ? v : 0.0f;
    }
    float m[kQPerThread];
#pragma unroll
    for (int q = 0; q < kQPerThread; ++q)
      m[q] = fmaxf(fmaxf(acc[2 * q], acc[2 * q + 1]), acc[2 * q + 2]);
    // Pool row p covers local conv rows 2p, 2p+1, 2p+2.
    if (i == 0) {
#pragma unroll
      for (int q = 0; q < kQPerThread; ++q) run[q] = m[q];
    } else if (i & 1) {
#pragma unroll
      for (int q = 0; q < kQPerThread; ++q) run[q] = fmaxf(run[q], m[q]);
    } else {
      const int p = P0 + i / 2 - 1;
#pragma unroll
      for (int q = 0; q < kQPerThread; ++q) {
        const int qq = q_first + q;
        if (p < Hp && qq < Wp)
          ob[((long long)p * Wp + qq) * kCout + c] =
              __float2bfloat16_rn(fmaxf(run[q], m[q]));
        run[q] = m[q];
      }
    }
  }
}

template <int CIN>
int launch(const void* x, const void* w, const float* bias, void* out, int B,
           int H, int W, cudaStream_t stream) {
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1, Wp = (Wc - 1) / 2 + 1;
  const size_t smem = sizeof(float) * smem_floats<CIN>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel<CIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Wp + kTileQ - 1) / kTileQ, (Hp + kTileP - 1) / kTileP, B);
  fused_stem_kernel<CIN><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, bias,
      (__nv_bfloat16*)out, H, W, Hc, Wc, Hp, Wp);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, cin] bf16 NHWC; w [64, cin, 7, 7] bf16; bias [64] f32;
// out [B, Hp, Wp, 64] bf16. cin is 3 or 4.
extern "C" int fused_stem_launch(const void* x, const void* w,
                                 const float* bias, void* out, int B, int H,
                                 int W, int cin, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (cin == 3)
    return launch<3>(x, w, bias, out, B, H, W, (cudaStream_t)stream);
  if (cin == 4)
    return launch<4>(x, w, bias, out, B, H, W, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
