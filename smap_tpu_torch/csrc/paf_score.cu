// paf_score_kernel: the PAF line-integral score table [B, L, K, K].
//
// Replaces the TPU kernel `paf_sample` (smap_tpu/ops/pallas_kernels.py,
// `_make_paf_sample_kernel`) together with the scoring arithmetic around
// it in `paf_scores` (smap_tpu/ops/paf.py). The TPU kernel read the maps
// with one-hot matmuls on a 3-term bf16 split, because scalar gathers
// serialize there. Here each thread loads its samples directly.
//
// What bounds it on an H100: loads. One thread per (image, limb, src peak,
// dst peak) entry reads at most 2 x 25 floats scattered over that limb's
// two maps (2 x 104 KB at 128x208, so the batch's maps stay in the 50 MB
// L2) and does a few dozen flops per sample; at the serving shape (B=16,
// L=14, K=40) that is 358,400 threads, at K=127 3.6 M. The design keeps
// every intermediate in registers and writes only the table, 4 bytes per
// entry; the sample loop stops at the pair's own n_pts.
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

__global__ void paf_score_kernel(const float* __restrict__ pafs,
                                 const float* __restrict__ xy,
                                 const int* __restrict__ count,
                                 const int* __restrict__ limb_pairs,
                                 float* __restrict__ out,
                                 int B, int J, int K, int L, int H, int W,
                                 int num_samples, float inter_threshold,
                                 float inter_min_above, float default_score,
                                 float close_threshold) {
  const long long total = (long long)B * L * K * K;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % K);
  long long r = idx / K;
  const int i = (int)(r % K);
  r /= K;
  const int l = (int)(r % L);
  const int b = (int)(r / L);

  const int src = limb_pairs[2 * l];
  const int dst = limb_pairs[2 * l + 1];
  if (i >= count[b * J + src] || j >= count[b * J + dst]) {
    out[idx] = -1.0f;
    return;
  }
  const float* pa = xy + (((long long)b * J + src) * K + i) * 2;
  const float* pb = xy + (((long long)b * J + dst) * K + j) * 2;
  const float ax = pa[0], ay = pa[1];
  const float vx = pb[0] - ax, vy = pb[1] - ay;
  const float norm = sqrtf(vx * vx + vy * vy);
  const float vmax = fmaxf(fabsf(vx), fabsf(vy));
  const float n_pts = fminf(fmaxf(floorf(sqrtf(5.0f * vmax) + 0.5f), 5.0f),
                            (float)num_samples);
  const float denom = fmaxf(norm, 1e-12f);
  const float ux = vx / denom, uy = vy / denom;
  const float sx = vx / n_pts, sy = vy / n_pts;

  const long long plane = (long long)H * W;
  const float* map_x = pafs + ((long long)b * 2 * L + 2 * l) * plane;
  const float* map_y = map_x + plane;
  int cnt = 0;
  float ssum = 0.0f;
  for (int lm = 0; lm < num_samples; ++lm) {
    const float flm = (float)lm;
    if (!(flm < n_pts)) break;
    // intRound(a + lm * step), clamped to the map (as the plain version).
    int px = (int)fminf(floorf(ax + flm * sx + 0.5f), (float)(W - 1));
    int py = (int)fminf(floorf(ay + flm * sy + 0.5f), (float)(H - 1));
    px = max(px, 0);
    py = max(py, 0);
    const long long off = (long long)py * W + px;
    const float s = ux * __ldg(map_x + off) + uy * __ldg(map_y + off);
    if (s > inter_threshold) {
      ++cnt;
      ssum += s;
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
  out[idx] = score;
}

}  // namespace

extern "C" int paf_score_launch(const float* pafs, const float* xy,
                                const int* count, const int* limb_pairs,
                                float* out, int B, int J, int K, int L, int H,
                                int W, int num_samples, float inter_threshold,
                                float inter_min_above, float default_score,
                                float close_threshold, void* stream) {
  const long long total = (long long)B * L * K * K;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  paf_score_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pafs, xy, count, limb_pairs, out, B, J, K, L, H, W, num_samples,
      inter_threshold, inter_min_above, default_score, close_threshold);
  return (int)cudaGetLastError();
}
