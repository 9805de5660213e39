// JPEG decoding for smap_tpu_torch/data/image.py: the bits that
// cv2.imread(path, IMREAD_COLOR) returns from OpenCV built with
// libjpeg-turbo (x86 SIMD), with no library of either.
//
// Supported: baseline and extended sequential Huffman (SOF0, SOF1) and
// progressive Huffman (SOF2) coding of 8-bit samples, one component (grey,
// replicated to BGR) or three (YCbCr), every component's sampling factors
// dividing the largest by 1 or 2 (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart
// intervals, 8- and 16-bit quantization tables, the standard Huffman tables
// where a file defines none (Motion JPEG). Anything else raises
// "unsupported" with the feature's name.
//
// The numerics are libjpeg-turbo's: the islow inverse DCT as its SIMD code
// computes it (16-bit dequantization and packing, so that out-of-range
// coefficients of corrupt data saturate where they saturate there), fancy
// upsampling (h2v1, h2v2, h1v2; plain replication for a downsampled width
// of 2 or less), and the fixed-point YCbCr -> BGR tables. Damaged data
// decodes as libjpeg decodes it: past the end of the file the stream reads
// as repeated EOI markers; a segment whose data runs out decodes its next
// bits as zeros and then leaves its remaining blocks at zero (grey);
// restart markers resynchronize. A truncated progressive file, which
// libjpeg would finish with block smoothing, is reported unsupported.
//
// One thread, no global state: callers may decode in parallel. Exposed as
// a C ABI for ctypes (jpeg_decode below).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kCorrupt = 1;       // cv2.imread returns None
constexpr int kUnsupported = 2;   // a feature this decoder lacks

struct Failure {
  int code;
  std::string what;
};

[[noreturn]] void corrupt(const std::string& what) {
  throw Failure{kCorrupt, what};
}

[[noreturn]] void unsupported(const std::string& what) {
  throw Failure{kUnsupported, what};
}

// Zig-zag position -> natural position; 16 extra entries absorb the
// overrun of corrupt AC runs, as libjpeg's table does.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables of ITU T.81 Annex K.3, which libjpeg-turbo loads into
// slots 0 and 1 left undefined when decoding starts.
const uint8_t kStdDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                   1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                   5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                     7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// The file's bytes; past its end, FF D9 (EOI) repeated, as libjpeg's stdio
// source inserts a fake EOI marker each time it finds no more data.
struct Source {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;

  int byte() {
    if (pos < size) return data[pos++];
    return ((pos++ - size) & 1) ? 0xD9 : 0xFF;
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long n) {
    for (; n > 0 && pos < size; --n) ++pos;
    for (; n > 0; --n) byte();
  }
};

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  // Derived (jpeg_make_d_derived_tbl): the largest code of each length
  // (-1: none; [17] ends the search), the offset from code to symbol index,
  // and an 8-bit lookahead: (length << 8) | symbol, length 9 meaning longer.
  bool derived = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[256];

  void set(const uint8_t* b, const uint8_t* v) {
    std::memcpy(bits, b, 17);
    std::memset(vals, 0, sizeof(vals));
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += b[l];
    std::memcpy(vals, v, n);
    defined = true;
    derived = false;
  }

  void derive(bool dc) {
    if (derived) return;
    char size[257];
    uint32_t code[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int i = bits[l];
      if (p + i > 256) corrupt("bad Huffman table");
      while (i--) size[p++] = static_cast<char>(l);
    }
    size[p] = 0;
    const int num = p;
    uint32_t c = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) {
        code[p++] = c;
        ++c;
      }
      if (c >= (1u << si)) corrupt("bad Huffman table");
      c <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(code[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(code[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    for (int i = 0; i < 256; ++i) look[i] = 9 << 8;
    p = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        const int base = static_cast<int>(code[p]) << (8 - l);
        for (int k = 0; k < (1 << (8 - l)); ++k)
          look[base + k] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (dc) {
      for (int i = 0; i < num; ++i)
        if (vals[i] > 15) corrupt("bad Huffman table");
    }
    derived = true;
  }
};

// The entropy-coded segment's bits, libjpeg's way: FF 00 is a data FF,
// FF FF.. pads, FF xx stops at marker xx. Bits wanted past the marker read
// as zeros and mark the segment short of data.
struct BitReader {
  Source* src = nullptr;
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;
  bool insufficient = false;

  void fill() {
    while (bits <= 56 && !marker) {
      int c = src->byte();
      if (c == 0xFF) {
        do c = src->byte(); while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker = c;
          return;
        }
      }
      buf = (buf << 8) | static_cast<uint64_t>(c);
      bits += 8;
    }
  }

  void ensure(int n) {
    if (bits >= n) return;
    fill();
    if (bits < n) {
      insufficient = true;
      buf <<= (57 - bits);
      bits = 57;
    }
  }

  int get(int n) {
    if (n == 0) return 0;
    ensure(n);
    bits -= n;
    return static_cast<int>((buf >> bits) & ((1u << n) - 1));
  }

  int decode(const Huffman& h) {
    int l;
    int32_t code;
    if (bits < 8) fill();
    if (bits >= 8) {
      const int look = static_cast<int>((buf >> (bits - 8)) & 0xFF);
      const int entry = h.look[look];
      const int nb = entry >> 8;
      if (nb <= 8) {
        bits -= nb;
        return entry & 0xFF;
      }
      l = 9;
    } else {
      l = 1;
    }
    code = get(l);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;  // a bad code: libjpeg's zero
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }

  void reset_bits() {
    bits = 0;
    buf = 0;
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + static_cast<int>(~0u << s) + 1 : r;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;      // blocks a row / column on the MCU grid
  int wib = 0, hib = 0;    // blocks holding samples
  int dw = 0, dh = 0;      // the downsampled size
  bool latched = false;
  int16_t q[64];           // the dequantization multipliers (16-bit)
  int coef_bits[64];       // progressive: the last Al of each coefficient
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;
  int16_t* block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64;
  }
};

// ---------------------------------------------------------------------
// The islow inverse DCT as libjpeg-turbo's SSE2 / AVX2 code computes it:
// the same integer algorithm (jidctint.c, CONST_BITS 13, PASS1_BITS 2)
// with 16-bit dequantization, 16-bit sums where the vector code adds
// words, and saturation where it packs. On in-range coefficients this is
// exactly jpeg_idct_islow.

constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
                  F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
                  F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                  F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int16_t wrap16(int32_t x) { return static_cast<int16_t>(x); }
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(std::min(32767, std::max(-32768, x)));
}
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// One 8-point pass over in[0..7] (16-bit), results descaled by `shift`
// and saturated to 16 bits into out[0..7].
inline void idct_1d(const int16_t* in, int16_t* out, int shift) {
  const int32_t z2 = in[2], z3 = in[6];
  const int32_t tmp3 = z2 * (F_0_541 + F_0_765) + z3 * F_0_541;
  const int32_t tmp2 = z2 * F_0_541 + z3 * (F_0_541 - F_1_847);
  const int32_t t0 = static_cast<int32_t>(wrap16(in[0] + in[4])) * 8192;
  const int32_t t1 = static_cast<int32_t>(wrap16(in[0] - in[4])) * 8192;
  const int32_t tmp10 = add32(t0, tmp3), tmp13 = sub32(t0, tmp3);
  const int32_t tmp11 = add32(t1, tmp2), tmp12 = sub32(t1, tmp2);

  const int32_t i7 = in[7], i5 = in[5], i3 = in[3], i1 = in[1];
  const int32_t z3o = wrap16(i7 + i3), z4o = wrap16(i5 + i1);
  const int32_t Z3 = z3o * (F_1_175 - F_1_961) + z4o * F_1_175;
  const int32_t Z4 = z3o * F_1_175 + z4o * (F_1_175 - F_0_390);
  const int32_t o0 = add32(i7 * (F_0_298 - F_0_899) + i1 * -F_0_899, Z3);
  const int32_t o3 = add32(i7 * -F_0_899 + i1 * (F_1_501 - F_0_899), Z4);
  const int32_t o1 = add32(i5 * (F_2_053 - F_2_562) + i3 * -F_2_562, Z4);
  const int32_t o2 = add32(i5 * -F_2_562 + i3 * (F_3_072 - F_2_562), Z3);

  const int32_t round = 1 << (shift - 1);
  auto d = [&](int32_t x) { return sat16(add32(x, round) >> shift); };
  out[0] = d(add32(tmp10, o3));
  out[7] = d(sub32(tmp10, o3));
  out[1] = d(add32(tmp11, o2));
  out[6] = d(sub32(tmp11, o2));
  out[2] = d(add32(tmp12, o1));
  out[5] = d(sub32(tmp12, o1));
  out[3] = d(add32(tmp13, o0));
  out[4] = d(sub32(tmp13, o0));
}

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out,
                size_t stride) {
  int16_t ws[64];   // ws[row * 8 + col]
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; ++i) ac_zero = coef[i] == 0;
  if (ac_zero) {
    // The vector code's shortcut when rows 1-7 are all zero: each column
    // is its dequantized DC word shifted left by PASS1_BITS, in 16 bits.
    for (int c = 0; c < 8; ++c) {
      const int16_t v = wrap16(wrap16(coef[c] * q[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = v;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t in[8], o[8];
      for (int r = 0; r < 8; ++r) in[r] = wrap16(coef[r * 8 + c] * q[r * 8 + c]);
      idct_1d(in, o, 11);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = o[r];
    }
  }
  for (int r = 0; r < 8; ++r) {
    int16_t o[8];
    idct_1d(ws + r * 8, o, 18);
    uint8_t* row = out + r * stride;
    for (int c = 0; c < 8; ++c)
      row[c] = static_cast<uint8_t>(
          std::min(127, std::max(-128, static_cast<int>(o[c]))) + 128);
  }
}

// ---------------------------------------------------------------------

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) { src_.data = data; src_.size = size; }

  // Reads the markers up to the first scan: the size and EXIF
  // orientation.
  void header(int* height, int* width, int* orientation);
  // Decodes the whole image into out (height * width * 3 BGR bytes).
  void decode(uint8_t* out);

 private:
  Source src_;
  Huffman dc_[4], ac_[4];
  bool qt_defined_[4] = {};
  uint16_t qt_[4][64];
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false, saw_app1_ = false;
  int adobe_transform_ = 0;
  int orientation_ = 0;
  bool saw_sof_ = false, progressive_ = false;
  int height_ = 0, width_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  std::vector<Component> comps_;
  int scans_ = 0;
  bool multiscan_ = false;

  // The scan being decoded.
  std::vector<Component*> scan_;
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  BitReader br_;
  int dc_pred_[4] = {};
  int eobrun_ = 0;
  int restarts_to_go_ = 0;
  int next_restart_ = 0;

  int first_marker();
  int next_marker();
  int read_markers();
  void get_sof(int marker);
  void get_dht();
  void get_dqt();
  void get_dri();
  void get_app(int marker);
  void get_sos();
  void decode_scan();
  void process_restart();
  void resync_to_restart();
  void decode_block_sequential(int16_t* blk, int ci);
  void decode_dc_first(int16_t* blk, int ci);
  void decode_ac_first(int16_t* blk);
  void decode_dc_refine(int16_t* blk);
  void decode_ac_refine(int16_t* blk);
  void check_smoothing();
  void output(uint8_t* out);
  void parse_exif(const std::vector<uint8_t>& d);
};

int Decoder::first_marker() {
  const int c = src_.byte(), c2 = src_.byte();
  if (c != 0xFF || c2 != 0xD8) corrupt("not a JPEG file");
  return c2;
}

int Decoder::next_marker() {
  for (;;) {
    int c = src_.byte();
    while (c != 0xFF) c = src_.byte();
    do c = src_.byte(); while (c == 0xFF);
    if (c != 0) return c;
  }
}

// Processes markers until SOS (returns 0xDA, the scan header read) or EOI
// (0xD9).
int Decoder::read_markers() {
  for (;;) {
    int m;
    if (br_.marker) {
      m = br_.marker;
      br_.marker = 0;
    } else {
      m = next_marker();
    }
    switch (m) {
      case 0xD8:
        corrupt("duplicate SOI");
      case 0xC0:
      case 0xC1:
      case 0xC2:
        get_sof(m);
        break;
      case 0xC3:
        unsupported("lossless JPEG (SOF3)");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        unsupported("hierarchical JPEG (SOF5-7)");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCC:
        unsupported("arithmetic-coded JPEG");
      case 0xCD:
      case 0xCE:
      case 0xCF:
        unsupported("hierarchical arithmetic-coded JPEG (SOF13-15)");
      case 0xC8:
        corrupt("unsupported marker JPG");
      case 0xC4:
        get_dht();
        break;
      case 0xDB:
        get_dqt();
        break;
      case 0xDD:
        get_dri();
        break;
      case 0xDA:
        get_sos();
        return 0xDA;
      case 0xD9:
        return 0xD9;
      case 0xD0: case 0xD1: case 0xD2: case 0xD3:
      case 0xD4: case 0xD5: case 0xD6: case 0xD7:
      case 0x01:
        break;
      case 0xDC: {  // DNL: skipped, as libjpeg skips it
        const int len = src_.u16();
        src_.skip(len - 2);
        break;
      }
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          get_app(m);
        } else if (m == 0xFE) {
          const int len = src_.u16();
          src_.skip(len - 2);
        } else {
          corrupt("unknown marker");
        }
    }
  }
}

void Decoder::get_sof(int marker) {
  if (saw_sof_) corrupt("duplicate SOF");
  int length = src_.u16();
  const int precision = src_.byte();
  height_ = src_.u16();
  width_ = src_.u16();
  const int n = src_.byte();
  length -= 8;
  if (height_ <= 0 || width_ <= 0 || n <= 0) corrupt("empty image");
  if (length != n * 3) corrupt("bad SOF length");
  comps_.resize(n);
  for (auto& c : comps_) {
    c.id = src_.byte();
    const int hv = src_.byte();
    c.h = (hv >> 4) & 15;
    c.v = hv & 15;
    c.tq = src_.byte();
  }
  saw_sof_ = true;
  progressive_ = marker == 0xC2;
  if (precision != 8)
    unsupported(std::to_string(precision) + "-bit samples");
  if (n > 10) corrupt("too many components");
  if (height_ > 65500 || width_ > 65500) corrupt("image too big");
  if (static_cast<long>(height_) * width_ > (1L << 30))
    unsupported("more than 2^30 pixels (OpenCV refuses them too)");
  for (auto& c : comps_) {
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) corrupt("bad sampling");
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  if (n == 4) unsupported("4-component (CMYK / YCCK) JPEG");
  if (n != 1 && n != 3) unsupported(std::to_string(n) + "-component JPEG");
  for (auto& c : comps_) {
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    if (hmax_ % c.h || vmax_ % c.v || rh > 2 || rv > 2)
      unsupported("sampling factors other than 4:4:4, 4:2:2, 4:2:0 and "
                  "4:4:0");
  }
  mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
  for (auto& c : comps_) {
    c.bw = mcux_ * c.h;
    c.bh = mcuy_ * c.v;
    c.dw = static_cast<int>((static_cast<long>(width_) * c.h + hmax_ - 1) / hmax_);
    c.dh = static_cast<int>((static_cast<long>(height_) * c.v + vmax_ - 1) / vmax_);
    c.wib = (c.dw + 7) / 8;
    c.hib = (c.dh + 7) / 8;
    for (int& b : c.coef_bits) b = -1;
  }
}

void Decoder::get_dht() {
  int length = src_.u16() - 2;
  while (length > 16) {
    const int index = src_.byte();
    uint8_t bits[17] = {0};
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      bits[i] = static_cast<uint8_t>(src_.byte());
      count += bits[i];
    }
    length -= 17;
    if (count > 256 || count > length) corrupt("bad Huffman table");
    uint8_t vals[256] = {0};
    for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(src_.byte());
    length -= count;
    const int slot = index & ~0x10;
    if (slot < 0 || slot >= 4) corrupt("bad DHT index");
    ((index & 0x10) ? ac_ : dc_)[slot].set(bits, vals);
  }
  if (length != 0) corrupt("bad DHT length");
}

void Decoder::get_dqt() {
  int length = src_.u16() - 2;
  while (length > 0) {
    --length;
    int n = src_.byte();
    const int prec = n >> 4;
    n &= 15;
    if (n >= 4) corrupt("bad DQT index");
    for (int i = 0; i < 64; ++i)
      qt_[n][kNatural[i]] = static_cast<uint16_t>(prec ? src_.u16() : src_.byte());
    qt_defined_[n] = true;
    length -= prec ? 128 : 64;
  }
  if (length != 0) corrupt("bad DQT length");
}

void Decoder::get_dri() {
  if (src_.u16() != 4) corrupt("bad DRI length");
  restart_interval_ = src_.u16();
}

void Decoder::get_app(int marker) {
  const int length = src_.u16() - 2;
  if (length < 0) return;
  if (marker == 0xE1 && !saw_app1_ && scans_ == 0) {
    // OpenCV reads EXIF from the first APP1 segment before the first scan.
    saw_app1_ = true;
    std::vector<uint8_t> d(static_cast<size_t>(length));
    for (auto& b : d) b = static_cast<uint8_t>(src_.byte());
    parse_exif(d);
    return;
  }
  const int keep = std::min(length, 14);
  uint8_t d[14] = {0};
  for (int i = 0; i < keep; ++i) d[i] = static_cast<uint8_t>(src_.byte());
  src_.skip(length - keep);
  if (marker == 0xE0 && keep >= 14 && std::memcmp(d, "JFIF", 5) == 0)
    saw_jfif_ = true;
  if (marker == 0xEE && keep >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
    saw_adobe_ = true;
    adobe_transform_ = d[11];
  }
}

// The Orientation tag (0x0112) of IFD0, read as OpenCV's ExifReader reads
// it: the TIFF header 6 bytes into the segment, "II" little-endian and any
// other byte order big-endian, the tag's value a 16-bit word 8 bytes into
// its entry; the first entry with the tag wins.
void Decoder::parse_exif(const std::vector<uint8_t>& seg) {
  if (seg.size() <= 6) return;
  const uint8_t* d = seg.data() + 6;
  const size_t n = seg.size() - 6;
  const bool intel = n > 1 ? (d[0] == d[1] && d[0] == 'I') : (d[0] == 'I');
  auto u16 = [&](size_t off, uint32_t* v) {
    if (off + 2 > n) return false;
    *v = intel ? d[off] | (d[off + 1] << 8) : (d[off] << 8) | d[off + 1];
    return true;
  };
  auto u32 = [&](size_t off, uint32_t* v) {
    if (off + 4 > n) return false;
    *v = intel ? d[off] | (d[off + 1] << 8) | (d[off + 2] << 16) |
                     (static_cast<uint32_t>(d[off + 3]) << 24)
               : (static_cast<uint32_t>(d[off]) << 24) | (d[off + 1] << 16) |
                     (d[off + 2] << 8) | d[off + 3];
    return true;
  };
  uint32_t mark, offset, count;
  if (!u16(2, &mark) || mark != 0x2A || !u32(4, &offset) ||
      !u16(offset, &count))
    return;
  size_t off = static_cast<size_t>(offset) + 2;
  for (uint32_t i = 0; i < count; ++i, off += 12) {
    uint32_t tag, value;
    if (!u16(off, &tag)) return;
    if (tag == 0x0112) {
      if (u16(off + 8, &value)) orientation_ = static_cast<int>(value);
      return;
    }
  }
}

void Decoder::get_sos() {
  if (!saw_sof_) corrupt("SOS before SOF");
  const int length = src_.u16();
  const int n = src_.byte();
  if (length != n * 2 + 6 || n < 1 || n > 4) corrupt("bad SOS length");
  scan_.clear();
  for (int i = 0; i < n; ++i) {
    const int cc = src_.byte(), t = src_.byte();
    Component* found = nullptr;
    for (auto& c : comps_) {
      if (c.id == cc &&
          std::find(scan_.begin(), scan_.end(), &c) == scan_.end()) {
        found = &c;
        break;
      }
    }
    if (!found) corrupt("bad component id in SOS");
    found->dc_tbl = (t >> 4) & 15;
    found->ac_tbl = t & 15;
    scan_.push_back(found);
  }
  ss_ = src_.byte();
  se_ = src_.byte();
  const int a = src_.byte();
  ah_ = (a >> 4) & 15;
  al_ = a & 15;
  next_restart_ = 0;
  ++scans_;
}

void Decoder::header(int* height, int* width, int* orientation) {
  first_marker();
  if (read_markers() != 0xDA) corrupt("no image");
  *height = height_;
  *width = width_;
  *orientation = orientation_;
}

void Decoder::process_restart() {
  br_.reset_bits();
  if (!br_.marker) br_.marker = next_marker();
  if (br_.marker == 0xD0 + next_restart_) {
    br_.marker = 0;
  } else {
    resync_to_restart();
  }
  next_restart_ = (next_restart_ + 1) & 7;
  for (int& p : dc_pred_) p = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
  if (!br_.marker) br_.insufficient = false;
}

// jpeg_resync_to_restart: the marker found is not the expected RSTn.
void Decoder::resync_to_restart() {
  const int desired = next_restart_;
  for (;;) {
    const int m = br_.marker;
    int action;
    if (m < 0xC0) {
      action = 2;
    } else if (m < 0xD0 || m > 0xD7) {
      action = 3;
    } else if (m == 0xD0 + ((desired + 1) & 7) ||
               m == 0xD0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (m == 0xD0 + ((desired - 1) & 7) ||
               m == 0xD0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) {
      br_.marker = 0;
      return;
    }
    if (action == 3) return;
    br_.marker = next_marker();
  }
}

void Decoder::decode_block_sequential(int16_t* blk, int ci) {
  Component* c = scan_[ci];
  const Huffman& dc = dc_[c->dc_tbl];
  const Huffman& ac = ac_[c->ac_tbl];
  int s = br_.decode(dc);
  if (s) s = extend(br_.get(s), s);
  const int v = add32(s, dc_pred_[ci]);
  dc_pred_[ci] = v;
  blk[0] = static_cast<int16_t>(v);
  for (int k = 1; k < 64; ++k) {
    int rs = br_.decode(ac);
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = static_cast<int16_t>(extend(br_.get(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void Decoder::decode_dc_first(int16_t* blk, int ci) {
  Component* c = scan_[ci];
  int s = br_.decode(dc_[c->dc_tbl]);
  if (s) s = extend(br_.get(s), s);
  const int v = add32(s, dc_pred_[ci]);
  dc_pred_[ci] = v;
  blk[0] = static_cast<int16_t>(static_cast<uint32_t>(v) << al_);
}

void Decoder::decode_ac_first(int16_t* blk) {
  if (eobrun_ > 0) {
    --eobrun_;
    return;
  }
  const Huffman& ac = ac_[scan_[0]->ac_tbl];
  for (int k = ss_; k <= se_; ++k) {
    const int rs = br_.decode(ac);
    int r = rs >> 4;
    const int s = rs & 15;
    if (s) {
      k += r;
      const int v = extend(br_.get(s), s);
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al_);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun_ = 1 << r;
      if (r) eobrun_ += br_.get(r);
      --eobrun_;
      break;
    }
  }
}

void Decoder::decode_dc_refine(int16_t* blk) {
  if (br_.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
}

void Decoder::decode_ac_refine(int16_t* blk) {
  const int p1 = 1 << al_;
  const int m1 = -1 * (1 << al_);
  const Huffman& ac = ac_[scan_[0]->ac_tbl];
  auto correct = [&](int16_t* coef) {
    if (br_.get(1) && (*coef & p1) == 0)
      *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
  };
  int k = ss_;
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      const int rs = br_.decode(ac);
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        s = br_.get(1) ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += br_.get(r);
        break;
      }
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          correct(coef);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se_);
      if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0) correct(coef);
    }
    --eobrun_;
  }
}

void Decoder::decode_scan() {
  // Latch each component's quantization table at its first scan.
  for (Component* c : scan_) {
    if (c->latched) continue;
    if (c->tq >= 4 || !qt_defined_[c->tq]) corrupt("missing quantization table");
    for (int i = 0; i < 64; ++i) c->q[i] = static_cast<int16_t>(qt_[c->tq][i]);
    c->latched = true;
  }
  const bool dc_band = ss_ == 0;
  if (progressive_) {
    bool bad = false;
    if (dc_band) {
      bad = se_ != 0;
    } else {
      bad = ss_ > se_ || se_ >= 64 || scan_.size() != 1;
    }
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) corrupt("bad progression");
    for (Component* c : scan_)
      for (int k = ss_; k <= se_; ++k) c->coef_bits[k] = al_;
  }
  for (Component* c : scan_) {
    const bool need_dc = !progressive_ || (dc_band && ah_ == 0);
    const bool need_ac = !progressive_ || !dc_band;
    if (need_dc) {
      if (c->dc_tbl >= 4 || !dc_[c->dc_tbl].defined) corrupt("missing Huffman table");
      dc_[c->dc_tbl].derive(true);
    }
    if (need_ac) {
      if (c->ac_tbl >= 4 || !ac_[c->ac_tbl].defined) corrupt("missing Huffman table");
      ac_[c->ac_tbl].derive(false);
    }
  }
  br_.src = &src_;
  br_.reset_bits();
  br_.marker = 0;
  br_.insufficient = false;
  for (int& p : dc_pred_) p = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;

  const bool single = scan_.size() == 1;
  const int mcus_x = single ? scan_[0]->wib : mcux_;
  const int mcus_y = single ? scan_[0]->hib : mcuy_;
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval_) {
        if (restarts_to_go_ == 0) process_restart();
        --restarts_to_go_;
      }
      const bool skip_data = br_.insufficient &&
                             !(progressive_ && dc_band && ah_ != 0);
      if (skip_data) continue;   // out of data: the blocks stay as they are
      for (size_t ci = 0; ci < scan_.size(); ++ci) {
        Component* c = scan_[ci];
        const int nh = single ? 1 : c->h, nv = single ? 1 : c->v;
        for (int by = 0; by < nv; ++by) {
          for (int bx = 0; bx < nh; ++bx) {
            int16_t* blk = single ? c->block(my, mx)
                                  : c->block(my * c->v + by, mx * c->h + bx);
            if (!progressive_) {
              decode_block_sequential(blk, static_cast<int>(ci));
            } else if (dc_band) {
              if (ah_ == 0) decode_dc_first(blk, static_cast<int>(ci));
              else decode_dc_refine(blk);
            } else if (ah_ == 0) {
              decode_ac_first(blk);
            } else {
              decode_ac_refine(blk);
            }
          }
        }
      }
    }
  }
}

// libjpeg smooths the blocks of a progressive image whose scans left some
// of the first ten coefficients unrefined (a truncated file): not ported.
void Decoder::check_smoothing() {
  if (!progressive_) return;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (auto& c : comps_) {
    if (!c.latched) return;
    for (int p : kPos)
      if (c.q[p] == 0) return;
    if (c.coef_bits[0] < 0) return;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  if (useful)
    unsupported("an incomplete progressive JPEG (libjpeg's block smoothing)");
}

void Decoder::decode(uint8_t* out) {
  first_marker();
  int m = read_markers();
  if (m != 0xDA) corrupt("no image");
  for (auto& c : comps_)
    c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
  const bool rgb_file =
      comps_.size() == 3 &&
      (saw_jfif_ ? false
                 : saw_adobe_ ? adobe_transform_ == 0
                              : comps_[0].id == 'R' && comps_[1].id == 'G' &&
                                    comps_[2].id == 'B');
  if (rgb_file) unsupported("3-component RGB JPEG (no YCbCr transform)");
  multiscan_ = progressive_ || scan_.size() < comps_.size();
  // Standard tables fill slots 0 and 1 left empty when decoding starts.
  if (!dc_[0].defined) dc_[0].set(kStdDcLumBits, kStdDcVals);
  if (!dc_[1].defined) dc_[1].set(kStdDcChromBits, kStdDcVals);
  if (!ac_[0].defined) ac_[0].set(kStdAcLumBits, kStdAcLumVals);
  if (!ac_[1].defined) ac_[1].set(kStdAcChromBits, kStdAcChromVals);
  for (;;) {
    decode_scan();
    if (!multiscan_) break;
    m = read_markers();
    if (m == 0xD9) break;
  }
  // A component no scan reached keeps zero multipliers: grey, as libjpeg.
  for (auto& c : comps_)
    if (!c.latched) std::memset(c.q, 0, sizeof(c.q));
  check_smoothing();
  output(out);
}

// Upsamples each component as libjpeg-turbo does (fancy for a factor of
// 2, plain replication where the downsampled width is 2 or less) and
// converts YCbCr to BGR with its fixed-point tables.
void Decoder::output(uint8_t* out) {
  for (auto& c : comps_) {
    const size_t stride = static_cast<size_t>(c.wib) * 8;
    c.plane.assign(stride * c.hib * 8, 0);
    for (int by = 0; by < c.hib; ++by)
      for (int bx = 0; bx < c.wib; ++bx)
        idct_islow(c.block(by, bx), c.q, c.plane.data() + by * 8 * stride + bx * 8,
                   stride);
  }
  const int W = width_, H = height_;
  const int nc = static_cast<int>(comps_.size());
  std::vector<std::vector<uint8_t>> rows(nc, std::vector<uint8_t>(W + 2));
  std::vector<int> colsum(static_cast<size_t>(W) + 2);

  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = static_cast<int>((91881 * x + 32768) >> 16);
    cb_b[i] = static_cast<int>((116130 * x + 32768) >> 16);
    cr_g[i] = static_cast<int32_t>(-46802 * x);
    cb_g[i] = static_cast<int32_t>(-22554 * x + 32768);
  }
  auto clamp8 = [](int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
  };

  for (int y = 0; y < H; ++y) {
    const uint8_t* row[3] = {nullptr, nullptr, nullptr};
    for (int ci = 0; ci < nc; ++ci) {
      Component& c = comps_[ci];
      const size_t stride = static_cast<size_t>(c.wib) * 8;
      const int rh = hmax_ / c.h, rv = vmax_ / c.v;
      const bool fancy = c.dw > 2;
      uint8_t* dst = rows[ci].data();
      if (rh == 1 && rv == 1) {
        row[ci] = c.plane.data() + y * stride;
        continue;
      }
      if (rv == 1) {
        const uint8_t* in = c.plane.data() + y * stride;
        if (!fancy) {
          for (int x = 0; x < W; ++x) dst[x] = in[x >> 1];
        } else {   // h2v1_fancy_upsample
          const int dw = c.dw;
          dst[0] = in[0];
          dst[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
          for (int i = 1; i < dw - 1; ++i) {
            const int v = in[i] * 3;
            dst[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
            dst[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
          }
          dst[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
          dst[2 * dw - 1] = in[dw - 1];
        }
        row[ci] = dst;
        continue;
      }
      // rv == 2: the nearer input row and the one above (even output rows)
      // or below (odd), the image's first and last rows replicated.
      const int iy = y >> 1;
      const int fy = (y & 1) ? std::min(iy + 1, c.dh - 1) : std::max(iy - 1, 0);
      const uint8_t* in0 = c.plane.data() + iy * stride;
      const uint8_t* in1 = c.plane.data() + fy * stride;
      if (rh == 1) {       // h1v2_fancy_upsample
        const int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < c.dw; ++x)
          dst[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else if (!fancy) { // h2v2_upsample
        for (int x = 0; x < W; ++x) dst[x] = in0[x >> 1];
      } else {             // h2v2_fancy_upsample
        const int dw = c.dw;
        for (int i = 0; i < dw; ++i) colsum[i] = in0[i] * 3 + in1[i];
        dst[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
        dst[1] = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
        for (int i = 1; i < dw - 1; ++i) {
          const int v = colsum[i] * 3;
          dst[2 * i] = static_cast<uint8_t>((v + colsum[i - 1] + 8) >> 4);
          dst[2 * i + 1] = static_cast<uint8_t>((v + colsum[i + 1] + 7) >> 4);
        }
        dst[2 * dw - 2] = static_cast<uint8_t>((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
        dst[2 * dw - 1] = static_cast<uint8_t>((colsum[dw - 1] * 4 + 7) >> 4);
      }
      row[ci] = dst;
    }
    uint8_t* o = out + static_cast<size_t>(y) * W * 3;
    if (nc == 1) {
      for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[0][x];
      continue;
    }
    const uint8_t *py = row[0], *pcb = row[1], *pcr = row[2];
    for (int x = 0; x < W; ++x) {
      const int Y = py[x], cb = pcb[x], cr = pcr[x];
      o[3 * x] = clamp8(Y + cb_b[cb]);
      o[3 * x + 1] = clamp8(Y + ((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp8(Y + cr_r[cr]);
    }
  }
}

void report(const Failure& f, char* err, size_t err_size) {
  if (err && err_size) std::snprintf(err, err_size, "%s", f.what.c_str());
}

}  // namespace

extern "C" {

// Decodes the JPEG file `data` of `size` bytes. With out == NULL, reads the
// headers up to the first scan and returns its height and width and the
// EXIF orientation (0 when absent); with out, writes height * width * 3 BGR
// bytes (out_size at least that). Returns 0, 1 where cv2.imread returns
// None (the message in err), or 2 for a feature not supported (named in
// err).
int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out,
                size_t out_size, int* height, int* width, int* orientation,
                char* err, size_t err_size) {
  try {
    if (size == 0) corrupt("empty file");
    Decoder d(data, size);
    d.header(height, width, orientation);
    if (out == nullptr) return kOk;
    if (out_size < static_cast<size_t>(*height) * *width * 3)
      corrupt("output buffer too small");
    Decoder full(data, size);
    full.decode(out);
    return kOk;
  } catch (const Failure& f) {
    report(f, err, err_size);
    return f.code;
  } catch (const std::bad_alloc&) {
    report(Failure{kCorrupt, "out of memory"}, err, err_size);
    return kCorrupt;
  }
}

}  // extern "C"
