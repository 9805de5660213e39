// Host image operations for smap_tpu_torch/data/image.py, each bit-equal
// to its numpy version there (the plain versions, which reproduce
// OpenCV's): resize_linear with its area halving at exactly 0.5,
// warp_affine (linear and cubic, constant border) and PNG unfiltering.
//
// Built with -ffp-contract=off: the float32 sums and products below must
// round one by one as numpy's do (GCC would otherwise fuse a * b + c on an
// FMA host). Where numpy forms a product and a sum in float64 and rounds
// once to float32 (_fma32, _lerp), so does this code; rounding to an
// integer is to nearest even (np.rint). One thread, no global state.
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

// _linear_taps: the source index and the two 11-bit weights of each
// destination index.
void linear_taps(int n_dst, int n_src, double scale, bool clamp,
                 std::vector<int>* idx, std::vector<int>* w0,
                 std::vector<int>* w1) {
  idx->resize(n_dst);
  w0->resize(n_dst);
  w1->resize(n_dst);
  for (int d = 0; d < n_dst; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    const float s = std::floor(f);
    f = f - s;
    long si = static_cast<long>(s);
    if (clamp) {
      if (si < 0 || si >= n_src - 1) f = 0.0f;
      si = std::min<long>(std::max<long>(si, 0), n_src - 1);
    }
    (*idx)[d] = static_cast<int>(si);
    (*w0)[d] = static_cast<int>(std::nearbyint((1.0f - f) * 2048.0f));
    (*w1)[d] = static_cast<int>(std::nearbyint(f * 2048.0f));
  }
}

inline float fma32(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}

inline float lerp32(float t, float p, float q) {
  const float d = q - p;
  return static_cast<float>(static_cast<double>(t) * static_cast<double>(d) +
                            static_cast<double>(p));
}

inline uint8_t round_u8(float v) {
  const float r = std::nearbyint(v);
  return static_cast<uint8_t>(r < 0.0f ? 0.0f : r > 255.0f ? 255.0f : r);
}

void cubic_weights(float t, float* w) {
  const float a = -0.75f, one = 1.0f;
  const float tp = t + one;
  w[0] = ((a * tp - 5.0f * a) * tp + 8.0f * a) * tp - 4.0f * a;
  w[1] = (((a + 2.0f) * t - (a + 3.0f)) * t) * t + one;
  const float om = one - t;
  w[2] = (((a + 2.0f) * om - (a + 3.0f)) * om) * om + one;
  w[3] = ((one - w[0]) - w[1]) - w[2];
}

// warp_affine_u8's inputs.
struct Warp {
  const uint8_t* img;
  int src_h, src_w, cn;
  size_t row_stride;
  float border;
  const float* minv;
};

// One destination pixel x of the row whose map starts at (row_x, row_y),
// TAPS 2 (linear) or 4 (cubic), written to o[0, cn).
template <int TAPS>
inline void warp_pixel(const Warp& g, float row_x, float row_y, int x,
                       uint8_t* o) {
  constexpr int pad = TAPS, lo = 1 - TAPS / 2;
  const int cn = g.cn;
  const float xf = static_cast<float>(x);
  const float sx = fma32(g.minv[0], xf, row_x);
  const float sy = fma32(g.minv[3], xf, row_y);
  const float fx = std::floor(sx), fy = std::floor(sy);
  const float ax = sx - fx, ay = sy - fy;
  const float cx = std::min(std::max(fx, static_cast<float>(-pad)),
                            static_cast<float>(g.src_w + pad));
  const float cy = std::min(std::max(fy, static_cast<float>(-pad)),
                            static_cast<float>(g.src_h + pad));
  long ix = static_cast<long>(cx) + pad + lo;
  long iy = static_cast<long>(cy) + pad + lo;
  ix = std::min<long>(std::max<long>(ix, 0), g.src_w + 2 * pad - TAPS) - pad;
  iy = std::min<long>(std::max<long>(iy, 0), g.src_h + 2 * pad - TAPS) - pad;
  float px[TAPS][TAPS][4];   // [dy][dx][channel], cn <= 4
  for (int dy = 0; dy < TAPS; ++dy) {
    const long sy_i = iy + dy;
    for (int dx = 0; dx < TAPS; ++dx) {
      const long sx_i = ix + dx;
      const bool in = sy_i >= 0 && sy_i < g.src_h && sx_i >= 0 &&
                      sx_i < g.src_w;
      const uint8_t* p = g.img + sy_i * g.row_stride + sx_i * cn;
      for (int c = 0; c < cn; ++c)
        px[dy][dx][c] = in ? static_cast<float>(p[c]) : g.border;
    }
  }
  if (TAPS == 2) {
    for (int c = 0; c < cn; ++c) {
      const float top = lerp32(ax, px[0][0][c], px[0][1][c]);
      const float bot = lerp32(ax, px[TAPS - 1][0][c], px[TAPS - 1][1][c]);
      o[c] = round_u8(lerp32(ay, top, bot));
    }
    return;
  }
  float wx[4], wy[4];
  cubic_weights(ax, wx);
  cubic_weights(ay, wy);
  for (int c = 0; c < cn; ++c) {
    float v = 0.0f;
    for (int dy = 0; dy < TAPS; ++dy) {
      float row = 0.0f;
      for (int dx = 0; dx < TAPS; ++dx) row = row + px[dy][dx][c] * wx[dx];
      v = v + row * wy[dy];
    }
    o[c] = round_u8(v);
  }
}

#ifdef __AVX2__
// (double) a * (double) x + (double) c rounded to float32, lane by lane.
inline __m256 fma32_8(__m256d a, __m256 x, __m256d c) {
  const __m256d lo = _mm256_add_pd(
      _mm256_mul_pd(a, _mm256_cvtps_pd(_mm256_castps256_ps128(x))), c);
  const __m256d hi = _mm256_add_pd(
      _mm256_mul_pd(a, _mm256_cvtps_pd(_mm256_extractf128_ps(x, 1))), c);
  return _mm256_set_m128(_mm256_cvtpd_ps(hi), _mm256_cvtpd_ps(lo));
}

// lerp32 lane by lane: q - p in float32, then t * d + p in float64.
inline __m256 lerp32_8(__m256 t, __m256 p, __m256 q) {
  const __m256 d = _mm256_sub_ps(q, p);
  auto half = [](__m128 t4, __m128 d4, __m128 p4) {
    return _mm256_cvtpd_ps(_mm256_add_pd(
        _mm256_mul_pd(_mm256_cvtps_pd(t4), _mm256_cvtps_pd(d4)),
        _mm256_cvtps_pd(p4)));
  };
  return _mm256_set_m128(
      half(_mm256_extractf128_ps(t, 1), _mm256_extractf128_ps(d, 1),
           _mm256_extractf128_ps(p, 1)),
      half(_mm256_castps256_ps128(t), _mm256_castps256_ps128(d),
           _mm256_castps256_ps128(p)));
}

inline void cubic_weights_8(__m256 t, __m256* w) {
  const __m256 a = _mm256_set1_ps(-0.75f), one = _mm256_set1_ps(1.0f);
  const __m256 a5 = _mm256_set1_ps(5.0f * -0.75f);
  const __m256 a8 = _mm256_set1_ps(8.0f * -0.75f);
  const __m256 a4 = _mm256_set1_ps(4.0f * -0.75f);
  const __m256 a2 = _mm256_set1_ps(-0.75f + 2.0f);
  const __m256 a3 = _mm256_set1_ps(-0.75f + 3.0f);
  const __m256 tp = _mm256_add_ps(t, one);
  __m256 v = _mm256_sub_ps(_mm256_mul_ps(a, tp), a5);
  v = _mm256_add_ps(_mm256_mul_ps(v, tp), a8);
  w[0] = _mm256_sub_ps(_mm256_mul_ps(v, tp), a4);
  v = _mm256_mul_ps(_mm256_sub_ps(_mm256_mul_ps(a2, t), a3), t);
  w[1] = _mm256_add_ps(_mm256_mul_ps(v, t), one);
  const __m256 om = _mm256_sub_ps(one, t);
  v = _mm256_mul_ps(_mm256_sub_ps(_mm256_mul_ps(a2, om), a3), om);
  w[2] = _mm256_add_ps(_mm256_mul_ps(v, om), one);
  w[3] = _mm256_sub_ps(_mm256_sub_ps(_mm256_sub_ps(one, w[0]), w[1]), w[2]);
}

// Eight pixels x0..x0+7 of a 3-channel image, each lane the float
// operations of warp_pixel in its order. Returns false, writing nothing,
// unless every tap of every lane lies inside the source (and the 4-byte
// gather of its last tap inside the buffer).
template <int TAPS>
bool warp8_bgr(const Warp& g, float row_x, float row_y, int x0,
               uint8_t* o) {
  constexpr int pad = TAPS, lo = 1 - TAPS / 2;
  const __m256 xf = _mm256_cvtepi32_ps(_mm256_add_epi32(
      _mm256_set1_epi32(x0), _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7)));
  const __m256 sx = fma32_8(_mm256_set1_pd(g.minv[0]), xf,
                            _mm256_set1_pd(row_x));
  const __m256 sy = fma32_8(_mm256_set1_pd(g.minv[3]), xf,
                            _mm256_set1_pd(row_y));
  const __m256 fx = _mm256_floor_ps(sx), fy = _mm256_floor_ps(sy);
  const __m256 ax = _mm256_sub_ps(sx, fx), ay = _mm256_sub_ps(sy, fy);
  const __m256 npad = _mm256_set1_ps(static_cast<float>(-pad));
  const __m256 cx = _mm256_min_ps(_mm256_max_ps(fx, npad),
                                  _mm256_set1_ps(static_cast<float>(g.src_w + pad)));
  const __m256 cy = _mm256_min_ps(_mm256_max_ps(fy, npad),
                                  _mm256_set1_ps(static_cast<float>(g.src_h + pad)));
  const __m256i off = _mm256_set1_epi32(pad + lo), zero = _mm256_setzero_si256();
  const __m256i ix = _mm256_sub_epi32(_mm256_min_epi32(_mm256_max_epi32(
      _mm256_add_epi32(_mm256_cvttps_epi32(cx), off), zero),
      _mm256_set1_epi32(g.src_w + 2 * pad - TAPS)), _mm256_set1_epi32(pad));
  const __m256i iy = _mm256_sub_epi32(_mm256_min_epi32(_mm256_max_epi32(
      _mm256_add_epi32(_mm256_cvttps_epi32(cy), off), zero),
      _mm256_set1_epi32(g.src_h + 2 * pad - TAPS)), _mm256_set1_epi32(pad));
  const __m256i neg1 = _mm256_set1_epi32(-1);
  const __m256i xe = _mm256_set1_epi32(g.src_w - TAPS + 1);
  const __m256i ye = _mm256_set1_epi32(g.src_h - TAPS + 1);
  // Inside: ix > -1, iy > -1, ix < src_w - TAPS + 1, iy < src_h - TAPS + 1,
  // and not the last tap at the image's last pixel.
  __m256i ok = _mm256_and_si256(_mm256_cmpgt_epi32(ix, neg1),
                                _mm256_cmpgt_epi32(iy, neg1));
  ok = _mm256_and_si256(ok, _mm256_cmpgt_epi32(xe, ix));
  ok = _mm256_and_si256(ok, _mm256_cmpgt_epi32(ye, iy));
  const __m256i last = _mm256_and_si256(
      _mm256_cmpeq_epi32(ix, _mm256_set1_epi32(g.src_w - TAPS)),
      _mm256_cmpeq_epi32(iy, _mm256_set1_epi32(g.src_h - TAPS)));
  ok = _mm256_andnot_si256(last, ok);
  if (_mm256_movemask_epi8(ok) != -1) return false;
  const int stride = static_cast<int>(g.row_stride);
  const __m256i base = _mm256_add_epi32(
      _mm256_mullo_epi32(iy, _mm256_set1_epi32(stride)),
      _mm256_mullo_epi32(ix, _mm256_set1_epi32(3)));
  const __m256i byte = _mm256_set1_epi32(0xFF);
  __m256 px[TAPS][TAPS][3];
  for (int dy = 0; dy < TAPS; ++dy) {
    for (int dx = 0; dx < TAPS; ++dx) {
      const __m256i v = _mm256_i32gather_epi32(
          reinterpret_cast<const int*>(g.img),
          _mm256_add_epi32(base, _mm256_set1_epi32(dy * stride + dx * 3)), 1);
      px[dy][dx][0] = _mm256_cvtepi32_ps(_mm256_and_si256(v, byte));
      px[dy][dx][1] = _mm256_cvtepi32_ps(
          _mm256_and_si256(_mm256_srli_epi32(v, 8), byte));
      px[dy][dx][2] = _mm256_cvtepi32_ps(
          _mm256_and_si256(_mm256_srli_epi32(v, 16), byte));
    }
  }
  alignas(32) int32_t res[3][8];
  const __m256 zf = _mm256_setzero_ps(), top = _mm256_set1_ps(255.0f);
  __m256 wx[4], wy[4];
  if (TAPS == 4) {
    cubic_weights_8(ax, wx);
    cubic_weights_8(ay, wy);
  }
  for (int c = 0; c < 3; ++c) {
    __m256 v;
    if (TAPS == 2) {
      const __m256 t0 = lerp32_8(ax, px[0][0][c], px[0][1][c]);
      const __m256 t1 = lerp32_8(ax, px[TAPS - 1][0][c], px[TAPS - 1][1][c]);
      v = lerp32_8(ay, t0, t1);
    } else {
      v = zf;
      for (int dy = 0; dy < TAPS; ++dy) {
        __m256 row = zf;
        for (int dx = 0; dx < TAPS; ++dx)
          row = _mm256_add_ps(row, _mm256_mul_ps(px[dy][dx][c], wx[dx]));
        v = _mm256_add_ps(v, _mm256_mul_ps(row, wy[dy]));
      }
    }
    const __m256 r = _mm256_round_ps(v, _MM_FROUND_TO_NEAREST_INT |
                                            _MM_FROUND_NO_EXC);
    _mm256_store_si256(reinterpret_cast<__m256i*>(res[c]),
                       _mm256_cvttps_epi32(_mm256_min_ps(_mm256_max_ps(r, zf), top)));
  }
  for (int l = 0; l < 8; ++l)
    for (int c = 0; c < 3; ++c)
      o[(x0 + l) * 3 + c] = static_cast<uint8_t>(res[c][l]);
  return true;
}
#endif

template <int TAPS>
void warp_rows(const Warp& g, uint8_t* out, int h, int w) {
  const int cn = g.cn;
#ifdef __AVX2__
  // The gathers index bytes with 32-bit offsets.
  const bool vector = cn == 3 &&
                      g.row_stride * static_cast<size_t>(g.src_h) < (1u << 31);
#endif
  for (int y = 0; y < h; ++y) {
    const float yf = static_cast<float>(y);
    const float row_x = yf * g.minv[1] + g.minv[2];
    const float row_y = yf * g.minv[4] + g.minv[5];
    uint8_t* o = out + static_cast<size_t>(y) * w * cn;
    int x = 0;
#ifdef __AVX2__
    if (vector) {
      for (; x + 8 <= w; x += 8) {
        if (!warp8_bgr<TAPS>(g, row_x, row_y, x, o))
          for (int k = x; k < x + 8; ++k)
            warp_pixel<TAPS>(g, row_x, row_y, k, o + k * cn);
      }
    }
#endif
    for (; x < w; ++x) warp_pixel<TAPS>(g, row_x, row_y, x, o + x * cn);
  }
}

}  // namespace

extern "C" {

// warp_affine: img [src_h, src_w, cn] (cn <= 4) -> out [h, w, cn]; minv
// the inverse map as float32 (numpy's _invert_affine rounded); cubic 0 or
// 1; taps outside the source read border.
void warp_affine_u8(const uint8_t* img, int src_h, int src_w, int cn,
                    uint8_t* out, int h, int w, const float* minv, int cubic,
                    int border) {
  const Warp g{img, src_h, src_w, cn, static_cast<size_t>(src_w) * cn,
               static_cast<float>(border), minv};
  if (cubic)
    warp_rows<4>(g, out, h, w);
  else
    warp_rows<2>(g, out, h, w);
}

// resize_linear (not the half or same-size cases): img [h, w, cn] uint8 ->
// out [dh, dw, cn]; inv_fx, inv_fy are 1 / fx, 1 / fy.
void resize_linear_u8(const uint8_t* img, int h, int w, int cn, uint8_t* out,
                      int dh, int dw, double inv_fx, double inv_fy) {
  std::vector<int> xs, xw0, xw1, ys, yw0, yw1;
  linear_taps(dw, w, inv_fx, true, &xs, &xw0, &xw1);
  linear_taps(dh, h, inv_fy, false, &ys, &yw0, &yw1);
  // The horizontal pass of each source row the output reads, >> 4, cached
  // for the two rows the current output row needs.
  const size_t row_len = static_cast<size_t>(dw) * cn;
  std::vector<int32_t> buf0(row_len), buf1(row_len);
  int have0 = -1, have1 = -1;
  auto horizontal = [&](int r, std::vector<int32_t>* dst) {
    const uint8_t* src = img + static_cast<size_t>(r) * w * cn;
    for (int x = 0; x < dw; ++x) {
      const int x0 = xs[x], x1 = std::min(x0 + 1, w - 1);
      for (int c = 0; c < cn; ++c)
        (*dst)[x * cn + c] =
            (src[x0 * cn + c] * xw0[x] + src[x1 * cn + c] * xw1[x]) >> 4;
    }
  };
  for (int y = 0; y < dh; ++y) {
    const int r0 = std::min(std::max(ys[y], 0), h - 1);
    const int r1 = std::min(std::max(ys[y] + 1, 0), h - 1);
    if (have0 != r0) {
      if (have1 == r0) {
        std::swap(buf0, buf1);
        std::swap(have0, have1);
      } else {
        horizontal(r0, &buf0);
        have0 = r0;
      }
    }
    if (have1 != r1) {
      if (r1 == have0) {
        buf1 = buf0;
      } else {
        horizontal(r1, &buf1);
      }
      have1 = r1;
    }
    const int32_t b0 = yw0[y], b1 = yw1[y];
    uint8_t* o = out + static_cast<size_t>(y) * row_len;
    for (size_t i = 0; i < row_len; ++i) {
      const int32_t v = (((buf0[i] * b0) >> 16) + ((buf1[i] * b1) >> 16) + 2) >> 2;
      o[i] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

// _half_by_area: OpenCV's area halving, out [dh, dw, cn].
void half_by_area_u8(const uint8_t* img, int h, int w, int cn, uint8_t* out,
                     int dh, int dw) {
  const int fh = h / 2, fw = w / 2;
  auto px = [&](int y, int x, int c) {
    return static_cast<int>(img[(static_cast<size_t>(y) * w + x) * cn + c]);
  };
  auto put = [&](int y, int x, int c, int v) {
    out[(static_cast<size_t>(y) * dw + x) * cn + c] = static_cast<uint8_t>(v);
  };
  auto mean2 = [](int sum) {
    return static_cast<int>(std::nearbyint(static_cast<float>(sum) / 2.0f));
  };
  for (int y = 0; y < fh; ++y) {
    for (int x = 0; x < fw; ++x)
      for (int c = 0; c < cn; ++c)
        put(y, x, c, (px(2 * y, 2 * x, c) + px(2 * y, 2 * x + 1, c) +
                      px(2 * y + 1, 2 * x, c) + px(2 * y + 1, 2 * x + 1, c) + 2) >> 2);
    if (dw > fw)
      for (int c = 0; c < cn; ++c)
        put(y, fw, c, mean2(px(2 * y, w - 1, c) + px(2 * y + 1, w - 1, c)));
  }
  if (dh > fh) {
    for (int x = 0; x < fw; ++x)
      for (int c = 0; c < cn; ++c)
        put(fh, x, c, mean2(px(h - 1, 2 * x, c) + px(h - 1, 2 * x + 1, c)));
    if (dw > fw)
      for (int c = 0; c < cn; ++c) put(fh, fw, c, px(h - 1, w - 1, c));
  }
}

// PNG unfiltering: raw [height, 1 + stride] filtered scanlines -> out
// [height, stride]. Returns 0, or -1 for a filter type above 4.
int png_unfilter(const uint8_t* raw, int height, int stride, int bpp,
                 uint8_t* out) {
  std::vector<uint8_t> zero(static_cast<size_t>(stride), 0);
  const uint8_t* prev = zero.data();
  for (int r = 0; r < height; ++r) {
    const uint8_t* line = raw + static_cast<size_t>(r) * (stride + 1);
    const int kind = line[0];
    ++line;
    uint8_t* cur = out + static_cast<size_t>(r) * stride;
    switch (kind) {
      case 0:
        std::memcpy(cur, line, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) cur[i] = static_cast<uint8_t>(line[i] + prev[i]);
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(line[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int c = i >= bpp ? prev[i - bpp] : 0;
          const int b = prev[i];
          const int pa = std::abs(b - c), pb = std::abs(a - c),
                    pc = std::abs(a + b - 2 * c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(line[i] + pred);
        }
        break;
      default:
        return -1;
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
