// int8_conv_kernel: one int8 convolution of the int8 serving forward,
//   out = relu?(cast(float(sum xq * wq) * (s_x * kscale[co]) + bias[co])),
// int8 NHWC activations and int8 weights in, bf16 or float32 NHWC out.
//
// This is not a port of a TPU kernel: the JAX package runs this convolution
// outside Pallas, as lax.conv_general_dilated with int8 operands and int32
// sums (smap_tpu/models/layers.py, Conv2D's int8 branch). PyTorch has no
// int8 convolution on CUDA, so the port brings its own.
//
// What bounds it on an H100: at the forward's shapes most convolutions have
// 64-2048 input channels and are bound by the int8 tensor cores' rate
// (1,979 TOPS dense) only when K = kh * kw * Cin is large; the 1x1
// convolutions with few channels are bound by bytes. The design is a plain
// implicit GEMM, M = output pixels, N = output channels, K = taps x
// channels, on mma.sync.m16n8k32 (s8 x s8 -> s32):
//
// - A block computes a 128 x 64 tile of the output with 4 warps, each a
//   64 x 32 sub-tile (4 x 4 mma tiles). K advances 32 bytes a step through a
//   4-stage cp.async ring in shared memory. A thread always gathers the same
//   output pixel's row of A: 16-byte pieces when Cin is a multiple of 16,
//   4-byte pieces otherwise (the wrapper pads Cin to a multiple of 4, as
//   for the stem's 3 channels), zero-filled outside the image. Which tap
//   and channel a piece of K holds comes from a table built once per block
//   in shared memory.
// - The weights are packed once on the host as [Cout][K] rows, K padded to
//   a multiple of 32 with zeros (ops/int8_conv.py, pack_int8_weights); rows
//   past Cout are zero-filled.
// - Rows of A and B are 32 bytes; the two 16-byte halves of a row swap
//   places every 4 rows, so that ldmatrix reads 8 rows without bank
//   conflicts.
// - The epilogue dequantizes in the JAX package's order, each step rounded
//   on its own: float(acc) (round to nearest), times s_x * kscale[co], plus
//   bias[co], cast with round to nearest even, then the ReLU. The result is
//   bit-equal to the plain version (int8_conv2d_plain).
// - s_x is read from the device: no host round trip for the dynamic scale.
//
// Not done yet (ROADMAP.md): wgmma and TMA, and the activation quantize
// fused into the previous convolution's epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // output pixels a block
constexpr int kBN = 64;                  // output channels a block
constexpr int kBK = 32;                  // bytes of K a step
constexpr int kStages = 4;
constexpr int kThreads = 128;
constexpr int kABytes = kBM * kBK;       // one stage of A
constexpr int kBBytes = kBN * kBK;       // one stage of B
constexpr int kRingBytes = kStages * (kABytes + kBBytes);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of byte `off` (0..31) of row `r` in a 32-byte-row tile: the
// 16-byte halves swap every 4 rows.
__device__ __forceinline__ int swz(int r, int off) {
  return r * kBK + ((((off >> 4) ^ (r >> 2)) & 1) << 4) + (off & 15);
}

template <int G>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  const int n = ok ? G : 0;   // 0: fill with zeros, read nothing
  if (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* a, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue of one sum; the value is returned as a float, exact in bf16
// when to_bf16. The ReLU is fmaxf on the cast value, as PyTorch's relu on
// CUDA (clamp_min) computes it.
__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         bool relu, bool to_bf16) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  if (to_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
  return relu ? fmaxf(v, 0.0f) : v;
}

// G: bytes of A one cp.async brings (16 when Cin % 16 == 0, else 4).
template <int G>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ kscale,
                 const float* __restrict__ sx,
                 const float* __restrict__ bias, void* __restrict__ out,
                 int M, int H, int W, int cin, int Ho, int Wo, int cout,
                 int kw, int stride, int pad, int ktrue, int kpad, int relu,
                 int out_f32) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_s = smem;
  unsigned char* b_s = smem + kStages * kABytes;
  int* tab = reinterpret_cast<int*>(smem + kRingBytes);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = kpad / kBK;

  // Piece i of K (G bytes): (dh << 24) | (dw << 16) | ci, or -1 past K.
  for (int i = tid; i < kpad / G; i += kThreads) {
    const int k = i * G;
    int e = -1;
    if (k < ktrue) {
      const int tap = k / cin, ci = k - tap * cin;
      const int dh = tap / kw, dw = tap - dh * kw;
      e = (dh << 24) | (dw << 16) | ci;
    }
    tab[i] = e;
  }

  // This thread's row of A: output pixel m0 + tid.
  const int m = m0 + tid;
  const bool row_ok = m < M;
  int hi0 = 0, wi0 = 0;
  const int8_t* xb = x;
  if (row_ok) {
    const int hw = Ho * Wo, b = m / hw, r = m - b * hw;
    const int ho = r / Wo, wo = r - ho * Wo;
    hi0 = ho * stride - pad;
    wi0 = wo * stride - pad;
    xb = x + (long long)b * H * W * cin;
  }
  // This thread's piece of B: row n0 + tid / 2, half tid % 2.
  const int nb = tid >> 1, hb = tid & 1;
  const bool b_ok = n0 + nb < cout;
  const int8_t* wrow = w + (long long)(b_ok ? n0 + nb : 0) * kpad + hb * 16;
  __syncthreads();

  auto load = [&](int kt, int slot) {
    const uint32_t a_dst = smem_u32(a_s + slot * kABytes);
#pragma unroll
    for (int u = 0; u < kBK / G; ++u) {
      const int e = tab[kt * (kBK / G) + u];
      const int hi = hi0 + (e >> 24), wi = wi0 + ((e >> 16) & 0xff);
      const bool ok = row_ok && e >= 0 && hi >= 0 && hi < H && wi >= 0 &&
                      wi < W;
      const int8_t* src =
          ok ? xb + ((long long)hi * W + wi) * cin + (e & 0xffff) : x;
      cp_async<G>(a_dst + swz(tid, u * G), src, ok);
    }
    cp_async<16>(smem_u32(b_s + slot * kBBytes) + swz(nb, hb * 16),
                 b_ok ? wrow + kt * kBK : w, b_ok);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  const int wm = warp >> 1, wn = warp & 1;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // The slot refilled here was read in step kt - 1, which every thread
    // has finished (the barrier above).
    const int next = kt + kStages - 1;
    if (next < nk) load(next, next % kStages);
    cp_async_commit();

    const int slot = kt % kStages;
    const uint32_t a_base = smem_u32(a_s + slot * kABytes);
    const uint32_t b_base = smem_u32(b_s + slot * kBBytes);
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = wm * 64 + mt * 16 + (lane & 15);
      ldsm_x4(a[mt], a_base + swz(r, (lane >> 4) * 16));
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int n = wn * 32 + np * 16 + ((lane >> 4) << 3) + (lane & 7);
      ldsm_x4(b[np], b_base + swz(n, ((lane >> 3) & 1) * 16));
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_s8(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
               b[nt >> 1][(nt & 1) * 2 + 1]);
  }
  cp_async_wait<0>();

  // Epilogue: thread (g, q) holds rows g and g + 8 of each 16-row tile,
  // columns 2q and 2q + 1 of each 8-column tile.
  const int g = lane >> 2, q = lane & 3;
  const float s = __ldg(sx);
  const bool to_bf16 = !out_f32, pairs = (cout % 2) == 0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn * 32 + nt * 8 + 2 * q;
    if (n >= cout) continue;
    const bool has1 = n + 1 < cout;
    const float sc0 = __fmul_rn(s, __ldg(kscale + n));
    const float bi0 = __ldg(bias + n);
    const float sc1 = has1 ? __fmul_rn(s, __ldg(kscale + n + 1)) : 0.0f;
    const float bi1 = has1 ? __ldg(bias + n + 1) : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = m0 + wm * 64 + mt * 16 + g + 8 * h;
        if (mm >= M) continue;
        const float v0 = dequant(acc[mt][nt][2 * h], sc0, bi0, relu,
                                 to_bf16);
        const float v1 = dequant(acc[mt][nt][2 * h + 1], sc1, bi1, relu,
                                 to_bf16);
        const long long o = (long long)mm * cout + n;
        if (out_f32) {
          float* p = reinterpret_cast<float*>(out) + o;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (has1) p[1] = v1;
          }
        } else {
          bf16* p = reinterpret_cast<bf16*>(out) + o;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(p) =
                __floats2bfloat162_rn(v0, v1);   // exact: already bf16
          } else {
            p[0] = __float2bfloat16_rn(v0);
            if (has1) p[1] = __float2bfloat16_rn(v1);
          }
        }
      }
  }
}

template <int G>
int launch(const void* x, const void* w, const float* kscale, const float* sx,
           const float* bias, void* out, int M, int H, int W, int cin, int Ho,
           int Wo, int cout, int kw, int stride, int pad, int ktrue, int kpad,
           int relu, int out_f32, cudaStream_t stream) {
  const int smem = kRingBytes + (kpad / G) * 4;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(int8_conv_kernel<G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kBM - 1) / kBM, (cout + kBN - 1) / kBN);
  int8_conv_kernel<G><<<grid, kThreads, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)w, kscale, sx, bias, out, M, H, W,
      cin, Ho, Wo, cout, kw, stride, pad, ktrue, kpad, relu, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, cin] int8 NHWC, cin a multiple of 4 (16-byte aligned when a
// multiple of 16); w [cout][kpad] int8 rows, 16-byte aligned, kpad a
// multiple of 32 and >= kh * kw * cin; kscale, bias [cout] f32; sx a f32
// scalar on the device; out [B, Ho, Wo, cout] f32 (out_f32) or bf16.
extern "C" int int8_conv_launch(const void* x, const void* w,
                                const float* kscale, const float* sx,
                                const float* bias, void* out, int B, int H,
                                int W, int cin, int cout, int kh, int kw,
                                int stride, int pad, int kpad, int relu,
                                int out_f32, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || kh > 127 || kw > 255 || stride <= 0 || pad < 0 ||
      cin % 4 || cin > 0xffff || kpad % kBK)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - kh) / stride + 1;
  const int Wo = (W + 2 * pad - kw) / stride + 1;
  const long long ktrue = (long long)kh * kw * cin;
  const long long M = (long long)B * Ho * Wo;
  if (Ho <= 0 || Wo <= 0 || ktrue > kpad || M > 0x7fffffffLL ||
      (M + kBM - 1) / kBM > 0x7fffffffLL || (cout + kBN - 1) / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  if (cin % 16 == 0)
    return launch<16>(x, w, kscale, sx, bias, out, (int)M, H, W, cin, Ho, Wo,
                      cout, kw, stride, pad, (int)ktrue, kpad, relu, out_f32,
                      (cudaStream_t)stream);
  return launch<4>(x, w, kscale, sx, bias, out, (int)M, H, W, cin, Ho, Wo,
                   cout, kw, stride, pad, (int)ktrue, kpad, relu, out_f32,
                   (cudaStream_t)stream);
}
