// conv_epilogue_kernel: a convolution's bias, eval-mode BatchNorm, residual
// add and ReLU in one in-place pass over its channels-last output.
//
// Replaces no TPU kernel. On the TPU, XLA fuses this work into the output of
// each convolution: the bias (smap_tpu/models/layers.py:219), Flax's
// BatchNorm (:253-255), a bottleneck's residual add and the ReLUs. The
// port's eager forward made a pass over every conv output for each of them:
// the bias `add_`, BatchNorm's two kernels, the ReLU, and in a bottleneck or
// an upsample unit the residual add and its ReLU besides.
//
// What bounds it on an H100: bytes. It reads each output once (and the
// residual once), writes it once, and does a few flops an element. The
// design:
//
// - one grid-stride pass in which each thread moves 16 bytes at a time
//   (8 bf16 or 4 float32) and keeps kUnroll such loads, and as many of the
//   residual, in flight before it computes;
// - the per-channel values (bias, mean, BatchNorm factor, shift) are read
//   once a block into shared memory (C <= 2048), only those the form uses;
//   where every chunk of a thread has the same channels (C a power of two,
//   as every vector-path C of the model is), each thread keeps its 8
//   channels' values in registers, read from shared memory once; read per
//   chunk, consecutive threads 8 channels apart would meet 8-way bank
//   conflicts at C = 256 (2.2x slower at [16, 256, 128, 208] on an H100);
// - C not a multiple of the vector width (the heads' 43, 14 and 1
//   channels), or an operand not 16-byte aligned: the same arithmetic an
//   element at a time, in the same kernel;
// - the form (bias, BatchNorm, residual, ReLU) is a template argument, so
//   the loop carries no test of it and a form without a residual reads none.
//
// Numerics, as the plain chain (`ops/conv_epilogue.conv_epilogue_plain`)
// rounds: the bias, rounded to the output type, is added to the conv's
// already rounded result and the sum rounded; BatchNorm is Flax's,
// (y - mean) * (rsqrt(var + eps) * scale) + shift in float32 with the
// factor computed once a weight state on the host, then rounded; the
// residual is added and the sum rounded; the ReLU keeps NaN. The library is
// compiled with -fmad=false, so the BatchNorm product and sum round apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxChannels = 2048;
// The form's bits (ops/kernels.py, EPILOGUE_*).
constexpr int kBias = 1, kBn = 2, kResidual = 4, kRelu = 8;

__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

// v rounded to T, as a float again.
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_float(from_float<T>(v));
}

// One element, with its channel's bias, mean, factor and shift.
template <typename T, int kForm>
__device__ __forceinline__ T epilogue(T y, const T* r, float bias, float mean,
                                      float factor, float shift) {
  float v = to_float(y);
  if (kForm & kBias) v = rounded<T>(v + bias);
  if (kForm & kBn) v = rounded<T>((v - mean) * factor + shift);
  if (kForm & kResidual) v = rounded<T>(v + to_float(*r));
  if (kForm & kRelu) v = v < 0.0f ? 0.0f : v;
  return from_float<T>(v);
}

// sp holds the form's per-channel values: bias [0, C), mean [C, 2C),
// factor [2C, 3C), shift [3C, 4C).
template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(T* __restrict__ y, const T* __restrict__ r,
                         const float* __restrict__ params, int C,
                         unsigned n, int vector) {
  extern __shared__ float sp[];
  constexpr bool kParams = (kForm & (kBias | kBn)) != 0;
  for (int i = threadIdx.x; kParams && i < C; i += kThreads) {
    if (kForm & kBias) sp[i] = rounded<T>(params[i]);
    if (kForm & kBn) {
      sp[C + i] = params[C + i];
      sp[2 * C + i] = params[2 * C + i];
      sp[3 * C + i] = params[3 * C + i];
    }
  }
  __syncthreads();
  const unsigned stride = gridDim.x * kThreads;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  if (vector) {
    constexpr int kVec = 16 / sizeof(T);
    const unsigned chunks = n / kVec;
    const int row = C / kVec;   // chunks a pixel
    // The values of a chunk's kVec channels, in registers. When the
    // stride is a multiple of a pixel's chunks (C a power of two up to
    // kThreads * kVec), every chunk of a thread has the same channels and
    // they are read from shared memory once.
    float pv[4][kVec] = {};
    auto load = [&](unsigned i) {
      const int c0 = (int)(i % row) * kVec;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (kForm & kBias) pv[0][k] = sp[c0 + k];
        if (kForm & kBn) {
          pv[1][k] = sp[C + c0 + k];
          pv[2][k] = sp[2 * C + c0 + k];
          pv[3][k] = sp[3 * C + c0 + k];
        }
      }
    };
    const bool fixed = kThreads % row == 0;
    if (fixed) load(first);
    uint4* yv = reinterpret_cast<uint4*>(y);
    const uint4* rv = reinterpret_cast<const uint4*>(r);
    for (unsigned base = first; base < chunks; base += stride * kUnroll) {
      uint4 a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = base + u * stride;
        if (i < chunks) {
          a[u] = yv[i];
          if (kForm & kResidual) b[u] = rv[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = base + u * stride;
        if (i < chunks) {
          if (!fixed) load(i);
          T* ea = reinterpret_cast<T*>(&a[u]);
          const T* eb = reinterpret_cast<const T*>(&b[u]);
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            ea[k] = epilogue<T, kForm>(ea[k], eb + k, pv[0][k], pv[1][k],
                                       pv[2][k], pv[3][k]);
          yv[i] = a[u];
        }
      }
    }
  } else {
    for (unsigned base = first; base < n; base += stride * kUnroll) {
      T a[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = base + u * stride;
        if (i < n) {
          a[u] = y[i];
          if (kForm & kResidual) b[u] = r[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = base + u * stride;
        if (i < n) {
          const int c = (int)(i % C);
          constexpr bool kBnForm = (kForm & kBn) != 0;
          y[i] = epilogue<T, kForm>(
              a[u], &b[u], (kForm & kBias) ? sp[c] : 0.0f,
              kBnForm ? sp[C + c] : 0.0f, kBnForm ? sp[2 * C + c] : 0.0f,
              kBnForm ? sp[3 * C + c] : 0.0f);
        }
      }
    }
  }
}

template <typename T, int kForm>
cudaError_t launch(void* y, const void* r, const float* params, int C,
                   unsigned n, int sms, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int vector = C % kVec == 0 && (uintptr_t)y % 16 == 0 &&
                     (!(kForm & kResidual) || (uintptr_t)r % 16 == 0);
  const unsigned items = vector ? n / kVec : n;
  const unsigned per_block = kThreads * kUnroll;
  unsigned blocks = (items + per_block - 1) / per_block;
  const unsigned most = (unsigned)sms * kBlocksPerSm;
  if (blocks > most) blocks = most;
  if (blocks == 0) blocks = 1;
  // The BatchNorm values sit at [C, 4C), after the bias's place.
  const int arrays = (kForm & kBn) ? 4 : (kForm & kBias) ? 1 : 0;
  const size_t smem = sizeof(float) * arrays * C;
  conv_epilogue_kernel<T, kForm><<<blocks, kThreads, smem, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(r), params, C, n, vector);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int form, void* y, const void* r, const float* params,
                     int C, unsigned n, int sms, cudaStream_t stream) {
  switch (form) {
#define EPILOGUE_FORM(F) \
  case F:                \
    return launch<T, F>(y, r, params, C, n, sms, stream);
    EPILOGUE_FORM(1) EPILOGUE_FORM(2) EPILOGUE_FORM(3) EPILOGUE_FORM(4)
    EPILOGUE_FORM(5) EPILOGUE_FORM(6) EPILOGUE_FORM(7) EPILOGUE_FORM(8)
    EPILOGUE_FORM(9) EPILOGUE_FORM(10) EPILOGUE_FORM(11) EPILOGUE_FORM(12)
    EPILOGUE_FORM(13) EPILOGUE_FORM(14) EPILOGUE_FORM(15)
#undef EPILOGUE_FORM
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y [N, H, W, C] (NHWC memory), bf16 (elem_size 2) or float32 (4), updated
// in place; r the residual of the same shape and type, or null; params
// [4, C] float32 (bias, mean, factor, shift), or null when the form has
// neither bias nor BatchNorm. n = N * H * W * C < 2^31, C <= 2048.
extern "C" int conv_epilogue_launch(void* y, const void* r,
                                    const float* params, int C,
                                    long long n, int elem_size, int form,
                                    void* stream) {
  if (C <= 0 || C > kMaxChannels || n < 0 || n >= (1LL << 31) ||
      ((form & kResidual) != 0) != (r != nullptr) ||
      ((form & (kBias | kBn)) != 0) != (params != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (elem_size == 2)
    err = dispatch<bf16>(form, y, r, params, C, (unsigned)n, sms, s);
  else if (elem_size == 4)
    err = dispatch<float>(form, y, r, params, C, (unsigned)n, sms, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
