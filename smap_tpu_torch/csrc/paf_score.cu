// paf_score_kernel: the PAF line-integral score table [B, L, K, K].
//
// Replaces the TPU kernel `paf_sample` (smap_tpu/ops/pallas_kernels.py:62,
// `_make_paf_sample_kernel`) together with the scoring arithmetic around
// it in `paf_scores` (smap_tpu/ops/paf.py). The TPU kernel read the maps
// with one-hot matmuls on a 3-term bf16 split, because scalar gathers
// serialize there. Here each thread loads its samples directly.
//
// What bounds it on an H100: the latency and sector count of its scattered
// loads. A scored (image, limb, src peak, dst peak) pair reads 5-25 samples
// of (x, y) along its segment, from the batch's PAF maps (47.7 MB at
// [16, 28, 128, 208] f32, which L2 mostly holds), and does a few dozen flops
// per sample. The design:
//
// - reads the maps as the network leaves them, channels-last
//   ([B, 2L, H, W] with strides (2L H W, 1, 2L W, 2L)): x and y of a limb
//   are adjacent, so a sample is one 8-byte load, one 32-byte sector, and
//   the decode makes no NCHW copy of the maps;
// - issues all of a pair's samples before it reduces them: the sample loop
//   is unrolled to its compile-time bound and predicated on the pair's own
//   n_pts, so up to 25 loads per thread are in flight;
// - spends threads only on scored pairs: a block column per (image, limb),
//   thread e scores the e-th pair of the n_src x n_dst block and writes -1
//   to the e-th entry of the K x K table if that lies outside the block.
//
// Numerics: the order of operations is that of the plain PyTorch version
// (`paf_scores_plain`), and the library is compiled with -fmad=false, so
// each product and sum is rounded on its own as there: sample points and
// pass/fail decisions are the same. Only the sum of the passing samples
// runs in another order (sequentially here), so the mean score may differ
// in its last bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

template <int S>
__global__ void __launch_bounds__(kThreads)
paf_score_kernel(const float* __restrict__ pafs, const float* __restrict__ xy,
                 const int* __restrict__ count,
                 const int* __restrict__ limb_pairs, float* __restrict__ out,
                 int J, int K, int L, int H, int W, int num_samples,
                 float inter_threshold, float inter_min_above,
                 float default_score, float close_threshold) {
  const int l = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int src = limb_pairs[2 * l], dst = limb_pairs[2 * l + 1];
  const int n_src = min(max(count[b * J + src], 0), K);
  const int n_dst = min(max(count[b * J + dst], 0), K);
  float* table = out + ((long long)b * L + l) * K * K;

  if (e < K * K) {
    const int i = e / K, j = e - i * K;
    if (i >= n_src || j >= n_dst) table[e] = -1.0f;
  }
  if (e >= n_src * n_dst) return;
  const int i = e / n_dst, j = e - i * n_dst;

  const float2 pa = *reinterpret_cast<const float2*>(
      xy + (((long long)b * J + src) * K + i) * 2);
  const float2 pb = *reinterpret_cast<const float2*>(
      xy + (((long long)b * J + dst) * K + j) * 2);
  const float ax = pa.x, ay = pa.y;
  const float vx = pb.x - ax, vy = pb.y - ay;
  const float norm = sqrtf(vx * vx + vy * vy);
  const float vmax = fmaxf(fabsf(vx), fabsf(vy));
  const float n_pts = fminf(fmaxf(floorf(sqrtf(5.0f * vmax) + 0.5f), 5.0f),
                            (float)num_samples);
  const float denom = fmaxf(norm, 1e-12f);
  const float ux = vx / denom, uy = vy / denom;
  const float sx = vx / n_pts, sy = vy / n_pts;

  // Limb l's (x, y) at pixel (py, px): one float2 of the channels-last map.
  const int C = 2 * L;
  const float* maps = pafs + (long long)b * H * W * C + 2 * l;
  float2 v[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float f = (float)s;
    // intRound(a + s * step), clamped to the map (as the plain version).
    const int px = max((int)fminf(floorf(ax + f * sx + 0.5f), (float)(W - 1)),
                       0);
    const int py = max((int)fminf(floorf(ay + f * sy + 0.5f), (float)(H - 1)),
                       0);
    v[s] = make_float2(0.0f, 0.0f);
    if (f < n_pts)
      v[s] = __ldg(reinterpret_cast<const float2*>(
          maps + ((long long)py * W + px) * C));
  }
  int cnt = 0;
  float ssum = 0.0f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float sc = ux * v[s].x + uy * v[s].y;
    if ((float)s < n_pts && sc > inter_threshold) {
      ++cnt;
      ssum += sc;
    }
  }
  const float fcnt = (float)cnt;
  float score;
  if (fcnt / n_pts > inter_min_above) {
    score = ssum / fmaxf(fcnt, 1.0f);
  } else {
    score = norm < close_threshold ? default_score : -1.0f;
  }
  if (!(norm > 1e-6f)) score = -1.0f;
  table[i * K + j] = score;
}

template <int S>
void launch(const float* pafs, const float* xy, const int* count,
            const int* limb_pairs, float* out, int B, int J, int K, int L,
            int H, int W, int num_samples, float inter_threshold,
            float inter_min_above, float default_score,
            float close_threshold, cudaStream_t stream) {
  const dim3 grid((K * K + kThreads - 1) / kThreads, L, B);
  paf_score_kernel<S><<<grid, kThreads, 0, stream>>>(
      pafs, xy, count, limb_pairs, out, J, K, L, H, W, num_samples,
      inter_threshold, inter_min_above, default_score, close_threshold);
}

}  // namespace

extern "C" int paf_score_launch(const float* pafs, const float* xy,
                                const int* count, const int* limb_pairs,
                                float* out, int B, int J, int K, int L, int H,
                                int W, int num_samples, float inter_threshold,
                                float inter_min_above, float default_score,
                                float close_threshold, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_samples <= 25) {
    launch<25>(pafs, xy, count, limb_pairs, out, B, J, K, L, H, W,
               num_samples, inter_threshold, inter_min_above, default_score,
               close_threshold, s);
  } else if (num_samples <= 32) {
    launch<32>(pafs, xy, count, limb_pairs, out, B, J, K, L, H, W,
               num_samples, inter_threshold, inter_min_above, default_score,
               close_threshold, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
