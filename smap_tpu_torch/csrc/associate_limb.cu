// associate_limb_kernel: one limb's sequential greedy association, for
// every image of a batch.
//
// Replaces the TPU kernel `associate_limb` (smap_tpu/ops/pallas_kernels.py):
// both its per-image body `_associate_limb_kernel` and the batched body
// `_associate_limb_batched_kernel` that its vmap rule picks. Person rows,
// in depth order, each take the highest-scoring valid, unused dst peak if
// that score is strictly > 0; ties go to the lowest index; -1 = none.
//
// What bounds it on an H100: the chain of K dependent steps (each person
// sees the used-mask left by the one before), not bytes or flops: a
// [16, 127, 127] table is 1 MB. The design runs one CTA per image, so the
// images run in parallel, and keeps the loop inside the CTA: thread j
// holds dst slot j, the used-mask lives in shared memory, and each step is
// one coalesced row load plus a block argmax (warp shuffles, then the 4
// warps' winners in shared memory). A step costs two barriers.
//
// The argmax follows torch.argmax / jnp.argmax: NaN counts as the largest
// value, and the first (lowest) index wins a tie. NaN is never > 0, so a
// row whose best entry is NaN takes nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// True if (av, ai) beats (bv, bi).
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an || bn) return an && (!bn || ai < bi);
  return av > bv || (av == bv && ai < bi);
}

__global__ void __launch_bounds__(kThreads)
associate_limb_kernel(const float* __restrict__ scores,
                      const unsigned char* __restrict__ valid,
                      int* __restrict__ assign, int K) {
  __shared__ unsigned char used[kThreads];
  __shared__ float warp_val[kWarps];
  __shared__ int warp_idx[kWarps];

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5;
  const bool slot_ok = j < K && valid[(long long)b * K + j] != 0;
  used[j] = 0;
  __syncthreads();

  const float* table = scores + (long long)b * K * K;
  for (int k1 = 0; k1 < K; ++k1) {
    // Slots past K carry index K, so they never win a tie.
    float v = -INFINITY;
    int vi = j < K ? j : K;
    if (slot_ok && !used[j]) v = table[(long long)k1 * K + j];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, vi, off);
      if (beats(ov, oi, v, vi)) {
        v = ov;
        vi = oi;
      }
    }
    if (lane == 0) {
      warp_val[warp] = v;
      warp_idx[warp] = vi;
    }
    __syncthreads();
    if (j == 0) {
      float best = warp_val[0];
      int best_i = warp_idx[0];
      for (int w = 1; w < kWarps; ++w) {
        if (beats(warp_val[w], warp_idx[w], best, best_i)) {
          best = warp_val[w];
          best_i = warp_idx[w];
        }
      }
      const bool take = best > 0.0f;
      assign[(long long)b * K + k1] = take ? best_i : -1;
      if (take) used[best_i] = 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int associate_limb_launch(const float* scores,
                                     const unsigned char* valid, int* assign,
                                     int B, int K, void* stream) {
  if (K > kThreads) return (int)cudaErrorInvalidValue;
  associate_limb_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      scores, valid, assign, K);
  return (int)cudaGetLastError();
}
