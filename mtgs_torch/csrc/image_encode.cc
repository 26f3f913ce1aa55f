// Host image encoding and 8-bit resampling for the port's eval and export
// layers: baseline JPEG encoding of RGB images and PIL's bilinear and
// bicubic resizes of uint8 images. A plain C interface, loaded with ctypes by
// mtgs_torch/data/image_io.py, which builds this file with the host C++
// compiler on first use.
//
// The encoder writes the bytes PIL (libjpeg-turbo) writes for
// `Image.fromarray(rgb).save(path, quality=q)` to a .jpg path, that is
// libjpeg's defaults at the given quality (75 when PIL is given none), step
// for step:
//   * the fixed-point RGB->YCbCr tables of jccolor.c (SCALEBITS 16, the
//     0.5 - epsilon rounding of Cb and Cr);
//   * h2v2 chroma downsampling (jcsample.c) with the bias alternating 1, 2
//     along each output row, the last column replicated to whole blocks,
//     an odd last row paired with itself, and the last downsampled row
//     replicated to whole iMCU rows (jcprepct.c);
//   * the accurate integer forward DCT of jfdctint.c (CONST_BITS 13,
//     PASS1_BITS 2, results scaled by 8);
//   * libjpeg-turbo's reciprocal quantization (jcdctmgr.c,
//     compute_reciprocal) by the standard tables scaled to the quality
//     (jpeg_quality_scaling, force_baseline);
//   * the dummy blocks of a partial MCU (jccoefct.c): zero AC, the DC of the
//     block before;
//   * the standard Huffman tables (jstdhuff.c), no restart markers, the
//     last byte padded with ones;
//   * the markers SOI, APP0 (JFIF 1.01, unit 0, density 1x1), two DQT,
//     SOF0 (components 1, 2, 3 at 2x2, 1x1, 1x1), four DHT (DC0, AC0, DC1,
//     AC1), SOS, EOI.
//
// The resize follows PIL's Resample.c for the bilinear filter (support 1)
// and the bicubic one (support 2, a = -0.5; Image.resize's default filter):
// double weights normalised per output pixel, converted to 22-bit fixed
// point with sign-aware rounding, a horizontal pass over the rows the
// vertical pass needs, then the vertical pass, each output rounded at 2^21
// and clipped to 8 bits; a pass whose size is unchanged is skipped.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c's standard tables, natural order
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: code counts by length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCode {
  uint16_t code[256] = {};
  uint8_t size[256] = {};

  HuffCode(const uint8_t* bits, const uint8_t* vals) {
    int code_ = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = static_cast<uint16_t>(code_++);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      code_ <<= 1;
    }
  }
};

// jcdctmgr.c's divisor of one quantizer step: the DCT's results carry a
// factor 8, so the divisor is 8 q, applied as (|x| + corr) * recip >> shift
// (libjpeg-turbo's compute_reciprocal, 16-bit DCTELEM).
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(int divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // floor(log2(divisor))
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    --r;
  } else if (fr <= uint32_t(divisor) / 2) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{fq, c, r};
}

// jcparam.c: jpeg_quality_scaling and jpeg_add_quant_table, force_baseline
void quant_table(const int* basic, int quality, int* out) {
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (long(basic[i]) * scale + 50L) / 100L;
    out[i] = int(std::min(std::max(t, 1L), 255L));
  }
}

// jfdctint.c's jpeg_fdct_islow
const int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270, F_0_899 = 7373,
              F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
              F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;
constexpr int kConstBits = 13, kPass1Bits = 2;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }

void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;    // along a row, then down a column
    const int next = pass == 0 ? 8 : 1;
    const int odd_bits = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int line = 0; line < 8; ++line) {
      int32_t* d = data + line * next;
      int32_t tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
      int32_t tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
      int32_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      int32_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        d[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        d[0] = descale(tmp10 + tmp11, kPass1Bits);
        d[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * F_0_541;
      d[2 * step] = descale(z1 + tmp13 * F_0_765, odd_bits);
      d[6 * step] = descale(z1 + tmp12 * -F_1_847, odd_bits);

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * F_1_175;
      tmp4 *= F_0_298;
      tmp5 *= F_2_053;
      tmp6 *= F_3_072;
      tmp7 *= F_1_501;
      z1 *= -F_0_899;
      z2 *= -F_2_562;
      z3 *= -F_1_961;
      z4 *= -F_0_390;
      z3 += z5;
      z4 += z5;
      d[7 * step] = descale(tmp4 + z1 + z3, odd_bits);
      d[5 * step] = descale(tmp5 + z2 + z4, odd_bits);
      d[3 * step] = descale(tmp6 + z2 + z3, odd_bits);
      d[step] = descale(tmp7 + z1 + z4, odd_bits);
    }
  }
}

// One 8x8 block of a plane (samples - 128) -> quantized coefficients,
// natural order.
void forward_block(const uint8_t* plane, int stride, int y0, int x0, const Divisor* div,
                   int16_t* coef) {
  int32_t ws[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) ws[y * 8 + x] = int32_t(plane[(y0 + y) * stride + x0 + x]) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int32_t t = ws[i];
    uint32_t a = uint32_t(t < 0 ? -t : t);
    int32_t q = int32_t(((a + div[i].corr) * div[i].recip) >> div[i].shift);
    coef[i] = int16_t(t < 0 ? -q : q);
  }
}

struct Writer {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t buf = 0;
  int nbits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (n < cap) out[n] = b; else overflow = true;
    ++n;
  }
  void word(int v) { byte(uint8_t(v >> 8)); byte(uint8_t(v & 0xFF)); }
  void bits(uint32_t v, int len) {  // entropy-coded data, 0xFF stuffed
    buf = (buf << len) | (v & ((uint32_t(1) << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      uint8_t b = uint8_t(buf >> (nbits - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush_ones() {
    if (nbits % 8) bits(0x7F, 8 - nbits % 8);
  }
};

void encode_block(Writer& w, const int16_t* coef, int& last_dc, const HuffCode& dc,
                  const HuffCode& ac) {
  int t = coef[0] - last_dc;
  last_dc = coef[0];
  int t2 = t;
  if (t < 0) { t = -t; --t2; }
  int nb = 0;
  while (t) { ++nb; t >>= 1; }
  w.bits(dc.code[nb], dc.size[nb]);
  if (nb) w.bits(uint32_t(t2), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNatural[k]];
    if (v == 0) { ++run; continue; }
    while (run > 15) { w.bits(ac.code[0xF0], ac.size[0xF0]); run -= 16; }
    int v2 = v;
    if (v < 0) { v = -v; --v2; }
    nb = 1;
    while (v >>= 1) ++nb;
    int sym = (run << 4) + nb;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits(uint32_t(v2), nb);
    run = 0;
  }
  if (run > 0) w.bits(ac.code[0], ac.size[0]);
}

void write_dht(Writer& w, int index, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  w.byte(0xFF); w.byte(0xC4); w.word(2 + 1 + 16 + n);
  w.byte(uint8_t(index));
  for (int i = 0; i < 16; ++i) w.byte(bits[i]);
  for (int i = 0; i < n; ++i) w.byte(vals[i]);
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// PIL's precompute_coeffs for the bilinear or bicubic filter, then
// normalize_coeffs_8bpc
int resample_coeffs(int in_size, int out_size, bool bicubic, std::vector<int>& bounds,
                    std::vector<int32_t>& kk) {
  double (*filter)(double) = bicubic ? bicubic_filter : bilinear_filter;
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = (bicubic ? 2.0 : 1.0) * filterscale;
  int ksize = int(std::ceil(support)) * 2 + 1;
  std::vector<double> pre(size_t(out_size) * ksize, 0.0);
  bounds.assign(size_t(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[size_t(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double v = filter((x + xmin - center + 0.5) * ss);
      k[x] = v;
      ww += v;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    bounds[size_t(xx) * 2] = xmin;
    bounds[size_t(xx) * 2 + 1] = xmax;
  }
  kk.resize(pre.size());
  const double one = double(1 << 22);
  for (size_t i = 0; i < pre.size(); ++i)
    kk[i] = pre[i] < 0 ? int32_t(-0.5 + pre[i] * one) : int32_t(0.5 + pre[i] * one);
  return ksize;
}

inline uint8_t clip8(int32_t v) {
  int32_t s = v >> 22;
  return uint8_t(s < 0 ? 0 : (s > 255 ? 255 : s));
}

}  // namespace

extern "C" {

// Upper bound of mtgs_jpeg_encode's output for an image of this size.
int64_t mtgs_jpeg_bound(int height, int width) {
  int64_t mcus = int64_t((height + 15) / 16) * ((width + 15) / 16);
  return 1024 + mcus * 6 * 420;  // every code at its longest, every byte stuffed
}

// RGB [height, width, 3] uint8 -> baseline JPEG bytes at `quality` (1..100)
// in `out`; returns the length, or -1 with a message in `err`.
int64_t mtgs_jpeg_encode(const uint8_t* rgb, int height, int width, int quality, uint8_t* out,
                         int64_t cap, char* err, int errlen) {
  if (quality < 1 || quality > 100) {
    set_error(err, errlen, "quality " + std::to_string(quality) + " outside 1..100");
    return -1;
  }
  if (height < 1 || width < 1 || height > 65535 || width > 65535) {
    set_error(err, errlen, "image size " + std::to_string(height) + "x" +
                               std::to_string(width) + " outside 1..65535");
    return -1;
  }
  const int mcu_rows = (height + 15) / 16, mcu_cols = (width + 15) / 16;
  const int y_bh = (height + 7) / 8, y_bw = (width + 7) / 8;  // real luma blocks
  const int ys = y_bw * 8, yh = mcu_rows * 16;                // luma plane
  const int cs = mcu_cols * 8, ch = mcu_rows * 8;             // chroma planes
  const int half_h = (height + 1) / 2;

  // jccolor.c rgb_ycc tables
  const int32_t one_half = 1 << 15, cbcr_offset = 128 << 16;
  auto fix = [](double x) { return int32_t(x * 65536.0 + 0.5); };
  std::vector<int32_t> tab(8 * 256);
  for (int i = 0; i < 256; ++i) {
    tab[i] = fix(0.29900) * i;
    tab[256 + i] = fix(0.58700) * i;
    tab[512 + i] = fix(0.11400) * i + one_half;
    tab[768 + i] = -fix(0.16874) * i;
    tab[1024 + i] = -fix(0.33126) * i;
    tab[1280 + i] = fix(0.50000) * i + cbcr_offset + one_half - 1;  // B->Cb and R->Cr
    tab[1536 + i] = -fix(0.41869) * i;
    tab[1792 + i] = -fix(0.08131) * i;
  }
  std::vector<uint8_t> Y(size_t(yh) * ys), cbf(size_t(height) * width),
      crf(size_t(height) * width);
  for (int y = 0; y < height; ++y) {
    const uint8_t* p = rgb + size_t(y) * width * 3;
    for (int x = 0; x < width; ++x, p += 3) {
      int r = p[0], g = p[1], b = p[2];
      Y[size_t(y) * ys + x] = uint8_t((tab[r] + tab[256 + g] + tab[512 + b]) >> 16);
      cbf[size_t(y) * width + x] =
          uint8_t((tab[768 + r] + tab[1024 + g] + tab[1280 + b]) >> 16);
      crf[size_t(y) * width + x] =
          uint8_t((tab[1280 + r] + tab[1536 + g] + tab[1792 + b]) >> 16);
    }
    for (int x = width; x < ys; ++x) Y[size_t(y) * ys + x] = Y[size_t(y) * ys + width - 1];
  }
  for (int y = height; y < yh; ++y)
    std::memcpy(&Y[size_t(y) * ys], &Y[size_t(height - 1) * ys], size_t(ys));

  std::vector<uint8_t> Cb(size_t(ch) * cs), Cr(size_t(ch) * cs);
  for (int r = 0; r < half_h; ++r) {
    const int y0 = 2 * r, y1 = std::min(2 * r + 1, height - 1);
    for (int plane = 0; plane < 2; ++plane) {
      const uint8_t* f = plane == 0 ? cbf.data() : crf.data();
      uint8_t* o = (plane == 0 ? Cb.data() : Cr.data()) + size_t(r) * cs;
      int bias = 1;
      for (int c = 0; c < cs; ++c) {
        const int x0 = std::min(2 * c, width - 1), x1 = std::min(2 * c + 1, width - 1);
        o[c] = uint8_t((f[size_t(y0) * width + x0] + f[size_t(y0) * width + x1] +
                        f[size_t(y1) * width + x0] + f[size_t(y1) * width + x1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  for (int r = half_h; r < ch; ++r) {
    std::memcpy(&Cb[size_t(r) * cs], &Cb[size_t(half_h - 1) * cs], size_t(cs));
    std::memcpy(&Cr[size_t(r) * cs], &Cr[size_t(half_h - 1) * cs], size_t(cs));
  }

  int qt[2][64];
  quant_table(kLumaQuant, quality, qt[0]);
  quant_table(kChromaQuant, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(qt[t][i] << 3);
  const HuffCode dc_luma(kDcLumaBits, kDcVals), ac_luma(kAcLumaBits, kAcLumaVals);
  const HuffCode dc_chroma(kDcChromaBits, kDcVals), ac_chroma(kAcChromaBits, kAcChromaVals);

  Writer w{out, cap};
  w.byte(0xFF); w.byte(0xD8);
  const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01,
                          0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (uint8_t b : app0) w.byte(b);
  for (int t = 0; t < 2; ++t) {
    w.byte(0xFF); w.byte(0xDB); w.word(67);
    w.byte(uint8_t(t));
    for (int i = 0; i < 64; ++i) w.byte(uint8_t(qt[t][kNatural[i]]));
  }
  w.byte(0xFF); w.byte(0xC0); w.word(17);
  w.byte(8); w.word(height); w.word(width); w.byte(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  for (uint8_t b : comps) w.byte(b);
  write_dht(w, 0x00, kDcLumaBits, kDcVals);
  write_dht(w, 0x10, kAcLumaBits, kAcLumaVals);
  write_dht(w, 0x01, kDcChromaBits, kDcVals);
  write_dht(w, 0x11, kAcChromaBits, kAcChromaVals);
  w.byte(0xFF); w.byte(0xDA); w.word(12);
  const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  for (uint8_t b : sos) w.byte(b);

  int last_dc[3] = {0, 0, 0};
  int16_t blk[4][64], cblk[64];
  for (int mr = 0; mr < mcu_rows; ++mr) {
    for (int mc = 0; mc < mcu_cols; ++mc) {
      for (int by = 0; by < 2; ++by) {
        for (int bx = 0; bx < 2; ++bx) {
          int16_t* b = blk[by * 2 + bx];
          const int br = mr * 2 + by, bc = mc * 2 + bx;
          if (br >= y_bh) {  // a dummy row: the DC of the previous row's last block
            std::memset(b, 0, sizeof(blk[0]));
            b[0] = blk[by * 2 - 1][0];
          } else if (bc >= y_bw) {  // a dummy column: the DC of the block to its left
            std::memset(b, 0, sizeof(blk[0]));
            b[0] = blk[by * 2 + bx - 1][0];
          } else {
            forward_block(Y.data(), ys, br * 8, bc * 8, div[0], b);
          }
        }
      }
      for (int i = 0; i < 4; ++i) encode_block(w, blk[i], last_dc[0], dc_luma, ac_luma);
      forward_block(Cb.data(), cs, mr * 8, mc * 8, div[1], cblk);
      encode_block(w, cblk, last_dc[1], dc_chroma, ac_chroma);
      forward_block(Cr.data(), cs, mr * 8, mc * 8, div[1], cblk);
      encode_block(w, cblk, last_dc[2], dc_chroma, ac_chroma);
    }
  }
  w.flush_ones();
  w.byte(0xFF); w.byte(0xD9);
  if (w.overflow) {
    set_error(err, errlen, "output buffer too small");
    return -1;
  }
  return w.n;
}

// uint8 [h, w, c] -> [oh, ow, c] by PIL's bilinear (bicubic = 0) or bicubic
// resample; 0 on success.
int mtgs_resize_u8(const uint8_t* in, int h, int w, int c, uint8_t* out, int oh, int ow,
                   int bicubic, char* err, int errlen) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1 || c < 1) {
    set_error(err, errlen, "empty image");
    return 1;
  }
  std::vector<int> hb, vb;
  std::vector<int32_t> hk, vk;
  const int hks = resample_coeffs(w, ow, bicubic != 0, hb, hk);
  const int vks = resample_coeffs(h, oh, bicubic != 0, vb, vk);
  const bool need_h = ow != w, need_v = oh != h;
  // the rows the vertical pass reads
  const int first = need_v ? vb[0] : 0;
  const int last = need_v ? vb[size_t(oh) * 2 - 2] + vb[size_t(oh) * 2 - 1] : h;
  const uint8_t* src = in;
  std::vector<uint8_t> tmp;
  if (need_h) {
    tmp.resize(size_t(last - first) * ow * c);
    for (int y = first; y < last; ++y) {
      const uint8_t* row = in + size_t(y) * w * c;
      uint8_t* o = &tmp[size_t(y - first) * ow * c];
      for (int xx = 0; xx < ow; ++xx) {
        const int xmin = hb[size_t(xx) * 2], xmax = hb[size_t(xx) * 2 + 1];
        const int32_t* k = &hk[size_t(xx) * hks];
        for (int ch = 0; ch < c; ++ch) {
          int32_t ss = 1 << 21;
          for (int x = 0; x < xmax; ++x) ss += int32_t(row[size_t(x + xmin) * c + ch]) * k[x];
          o[size_t(xx) * c + ch] = clip8(ss);
        }
      }
    }
    src = tmp.data();
  } else if (need_v) {
    src = in + size_t(first) * w * c;
  }
  const int sw = need_h ? ow : w;
  if (!need_v) {
    std::memcpy(out, src, size_t(oh) * ow * c);
    return 0;
  }
  for (int yy = 0; yy < oh; ++yy) {
    const int ymin = vb[size_t(yy) * 2] - first, ymax = vb[size_t(yy) * 2 + 1];
    const int32_t* k = &vk[size_t(yy) * vks];
    uint8_t* o = out + size_t(yy) * ow * c;
    for (int i = 0; i < sw * c; ++i) {
      int32_t ss = 1 << 21;
      for (int y = 0; y < ymax; ++y) ss += int32_t(src[size_t(y + ymin) * sw * c + i]) * k[y];
      o[i] = clip8(ss);
    }
  }
  return 0;
}

}  // extern "C"
