// Host-side image preprocessing: the port's copy of the JAX package's
// native/preprocess.cc, built by smap_tpu_torch/data/native.py with the
// same compiler and flags, so that both libraries compute the same bits.
//
// C++ equivalent of the intent of the reference's (unused) CUDA kernels
// resizeAndPadRbgGpu / reorderAndNormalize (zju3dv/SMAP
// extensions/gpu/cuda_cal.cu): aspect-preserving bilinear resize into a
// gray(128) letterbox canvas fused with [0,1] scaling and per-channel BGR
// normalization, emitting float32 NHWC. Single pass over the output, no
// intermediate buffers, in place of three numpy passes.
//
// Exposed as a tiny C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline float sample_bilinear(const uint8_t* img, int h, int w, int channels,
                             int c, float sy, float sx) {
  // cv2 INTER_LINEAR convention: clamp source coords to the valid range.
  int y0 = static_cast<int>(std::floor(sy));
  int x0 = static_cast<int>(std::floor(sx));
  float fy = sy - y0;
  float fx = sx - x0;
  int y1 = y0 + 1;
  int x1 = x0 + 1;
  y0 = std::min(std::max(y0, 0), h - 1);
  y1 = std::min(std::max(y1, 0), h - 1);
  x0 = std::min(std::max(x0, 0), w - 1);
  x1 = std::min(std::max(x1, 0), w - 1);
  const float v00 = img[(y0 * w + x0) * channels + c];
  const float v01 = img[(y0 * w + x1) * channels + c];
  const float v10 = img[(y1 * w + x0) * channels + c];
  const float v11 = img[(y1 * w + x1) * channels + c];
  return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
         v10 * fy * (1 - fx) + v11 * fy * fx;
}

}  // namespace

extern "C" {

// Letterbox-resize src (uint8 BGR HWC) into a net_h x net_w float32 canvas,
// normalized as (v/255 - mean[c]) / std[c]; padding pixels use value 128.
// Layout matches dataset/custom_dataset.py:41-68: symmetric // padding.
void letterbox_normalize(const uint8_t* src, int src_h, int src_w,
                         float* dst, int net_h, int net_w,
                         const float* mean, const float* stddev) {
  const float scale = std::min(static_cast<float>(net_w) / src_w,
                               static_cast<float>(net_h) / src_h);
  // cv2.resize(fx=scale) output size: round half away from zero; the
  // sampling step is the reciprocal of the *requested* factor, not the
  // src/dst ratio (verified against cv2 in tests/test_native.py and
  // tests/test_torch_native.py).
  const int rh = static_cast<int>(src_h * scale + 0.5f);
  const int rw = static_cast<int>(src_w * scale + 0.5f);
  const float inv_scale_x = 1.0f / scale;
  const float inv_scale_y = 1.0f / scale;

  int off_y = 0, off_x = 0;
  if (rw < net_w) {
    off_x = (net_w - rw) / 2;
  } else if (rh < net_h) {
    off_y = (net_h - rh) / 2;
  }

  float pad_norm[3];
  for (int c = 0; c < 3; ++c) {
    pad_norm[c] = (128.0f / 255.0f - mean[c]) / stddev[c];
  }
  float inv255_std[3], mean_over_std[3];
  for (int c = 0; c < 3; ++c) {
    inv255_std[c] = 1.0f / (255.0f * stddev[c]);
    mean_over_std[c] = mean[c] / stddev[c];
  }

  for (int y = 0; y < net_h; ++y) {
    const int sy_idx = y - off_y;
    float* row = dst + static_cast<int64_t>(y) * net_w * 3;
    if (sy_idx < 0 || sy_idx >= rh) {
      for (int x = 0; x < net_w; ++x) {
        row[x * 3 + 0] = pad_norm[0];
        row[x * 3 + 1] = pad_norm[1];
        row[x * 3 + 2] = pad_norm[2];
      }
      continue;
    }
    const float sy = (sy_idx + 0.5f) * inv_scale_y - 0.5f;
    for (int x = 0; x < net_w; ++x) {
      const int sx_idx = x - off_x;
      if (sx_idx < 0 || sx_idx >= rw) {
        row[x * 3 + 0] = pad_norm[0];
        row[x * 3 + 1] = pad_norm[1];
        row[x * 3 + 2] = pad_norm[2];
        continue;
      }
      const float sx = (sx_idx + 0.5f) * inv_scale_x - 0.5f;
      for (int c = 0; c < 3; ++c) {
        const float v = sample_bilinear(src, src_h, src_w, 3, c, sy, sx);
        row[x * 3 + c] = v * inv255_std[c] - mean_over_std[c];
      }
    }
  }
}

// Normalize an already-letterboxed uint8 image (HWC BGR) in one pass.
void normalize_u8(const uint8_t* src, int h, int w, float* dst,
                  const float* mean, const float* stddev) {
  float inv255_std[3], mean_over_std[3];
  for (int c = 0; c < 3; ++c) {
    inv255_std[c] = 1.0f / (255.0f * stddev[c]);
    mean_over_std[c] = mean[c] / stddev[c];
  }
  const int64_t n = static_cast<int64_t>(h) * w;
  for (int64_t i = 0; i < n; ++i) {
    dst[i * 3 + 0] = src[i * 3 + 0] * inv255_std[0] - mean_over_std[0];
    dst[i * 3 + 1] = src[i * 3 + 1] * inv255_std[1] - mean_over_std[1];
    dst[i * 3 + 2] = src[i * 3 + 2] * inv255_std[2] - mean_over_std[2];
  }
}

}  // extern "C"
