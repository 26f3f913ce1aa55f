// Host image decoding for the port's data layer: baseline JPEG and the PNG
// row filters. A plain C interface, loaded with ctypes by
// mtgs_torch/data/image_io.py, which builds this file with the host C++
// compiler on first use.
//
// The JPEG decoder follows libjpeg's integer arithmetic step for step, so
// its output is the one PIL (libjpeg-turbo) gives:
//   * the accurate integer IDCT of jidctint.c (jpeg_idct_islow: 13-bit
//     constants, PASS1_BITS 2, the post-IDCT range-limit table of
//     jdmaster.c::prepare_range_limit_table);
//   * the "fancy" triangle upsampling of jdsample.c (h2v1, h1v2 and h2v2,
//     with their rounding biases and edge columns; box replication where
//     libjpeg-turbo takes it: a component at most 2 samples wide, or other
//     integer ratios), context rows replicated at the component's real
//     top and bottom (jdmainct.c);
//   * the fixed-point YCbCr->RGB tables of jdcolor.c (SCALEBITS 16);
//   * the colour space libjpeg infers (JFIF, Adobe transform, component ids).
// Only baseline and extended sequential Huffman files with 8-bit samples
// (SOF0/SOF1), one or three components, are decoded; anything else returns
// an error message and no pixels.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // entries past 63 catch a corrupt run (libjpeg's safety margin)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool present = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valptr[17] = {};
  int32_t mincode[17] = {};
  static constexpr int kLookBits = 9;
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value; 0: longer code

  void build(const uint8_t* counts, const uint8_t* values, int n) {
    std::memcpy(vals, values, n);
    std::memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int fill = 0; fill < (1 << shift); ++fill)
            look[(code << shift) | fill] = static_cast<uint16_t>((len << 8) | values[k]);
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (code > (1 << len)) fail("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

// Entropy-coded segment reader: byte stuffing undone, a marker stops the
// input and zeros are fed after it; consuming past the real data is an error.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;
  int64_t real_bits = 0;
  int64_t used_bits = 0;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            b = 0xFF;
            p += 2;
            real_bits += 8;
          } else {
            at_marker = true;  // p stays on the marker's 0xFF
          }
        } else {
          b = *p++;
          real_bits += 8;
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  inline void need(int n) {
    if (cnt < n) fill();
  }
  inline uint32_t peek(int n) const { return static_cast<uint32_t>(buf >> (64 - n)); }
  inline void skip(int n) {
    buf <<= n;
    cnt -= n;
    used_bits += n;
  }
  inline int get(int n) {
    if (n == 0) return 0;
    need(n);
    int v = static_cast<int>(peek(n));
    skip(n);
    return v;
  }
  void check_overrun() const {
    if (used_bits > real_bits) fail("entropy-coded data ends early (truncated or corrupt file)");
  }
  // A restart marker RSTn: the buffered bits are the interval's padding.
  void restart(int expected) {
    check_overrun();
    buf = 0;
    cnt = 0;
    used_bits = real_bits = 0;
    const uint8_t* q = p;
    while (q < end && *q == 0xFF) ++q;
    if (q == p || q >= end || *q != 0xD0 + expected) {
      char m[96];
      std::snprintf(m, sizeof(m), "expected restart marker RST%d", expected);
      fail(m);
    }
    p = q + 1;
    at_marker = false;
  }
};

inline int decode_huff(BitReader& br, const Huffman& h) {
  br.need(16);
  uint16_t e = h.look[br.peek(Huffman::kLookBits)];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  int len = Huffman::kLookBits + 1;
  int32_t code = static_cast<int32_t>(br.peek(len));
  while (len <= 16 && code > h.maxcode[len]) {
    ++len;
    code = static_cast<int32_t>(br.peek(len));
  }
  if (len > 16) fail("corrupt Huffman code");
  br.skip(len);
  return h.vals[(h.valptr[len] + code - h.mincode[len]) & 0xFF];
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;           // coefficient grid, in blocks (whole MCUs)
  int dw = 0, dh = 0;           // real (downsampled) size in samples
  std::vector<int16_t> coef;    // bw * bh blocks of 64, natural order
  int dc_pred = 0;
  int td = 0, ta = 0;
};

// ----------------------------------------------------------- IDCT (islow)

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F_0_298631336 = 2446;
constexpr int32_t F_0_390180644 = 3196;
constexpr int32_t F_0_541196100 = 4433;
constexpr int32_t F_0_765366865 = 6270;
constexpr int32_t F_0_899976223 = 7373;
constexpr int32_t F_1_175875602 = 9633;
constexpr int32_t F_1_501321110 = 12299;
constexpr int32_t F_1_847759065 = 15137;
constexpr int32_t F_1_961570560 = 16069;
constexpr int32_t F_2_053119869 = 16819;
constexpr int32_t F_2_562915447 = 20995;
constexpr int32_t F_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jdmaster.c's post-IDCT table: index (x & 1023) of a value x centred on 0.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int x = i < 512 ? i : i - 1024;  // [-512, 511] after the wrap
      int s = x + 128;
      t[i] = static_cast<uint8_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int32_t dc = (int32_t(ip[0]) * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * (-F_1_847759065);
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = int32_t(descale(tmp10 + tmp3, n));
    wp[56] = int32_t(descale(tmp10 - tmp3, n));
    wp[8] = int32_t(descale(tmp11 + tmp2, n));
    wp[48] = int32_t(descale(tmp11 - tmp2, n));
    wp[16] = int32_t(descale(tmp12 + tmp1, n));
    wp[40] = int32_t(descale(tmp12 - tmp1, n));
    wp[24] = int32_t(descale(tmp13 + tmp0, n));
    wp[32] = int32_t(descale(tmp13 - tmp0, n));
  }
  const int n2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t dc = kRange.t[int(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * (-F_1_847759065);
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[int(descale(tmp10 + tmp3, n2)) & 1023];
    o[7] = kRange.t[int(descale(tmp10 - tmp3, n2)) & 1023];
    o[1] = kRange.t[int(descale(tmp11 + tmp2, n2)) & 1023];
    o[6] = kRange.t[int(descale(tmp11 - tmp2, n2)) & 1023];
    o[2] = kRange.t[int(descale(tmp12 + tmp1, n2)) & 1023];
    o[5] = kRange.t[int(descale(tmp12 - tmp1, n2)) & 1023];
    o[3] = kRange.t[int(descale(tmp13 + tmp0, n2)) & 1023];
    o[4] = kRange.t[int(descale(tmp13 - tmp0, n2)) & 1023];
  }
}

// ------------------------------------------------------------- JPEG parse

struct Jpeg {
  const uint8_t* data;
  size_t n;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  uint16_t qt[4][64] = {};  // natural order
  bool qt_present[4] = {};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false, saw_sof = false;
  int adobe_transform = -1;
  bool transform_rgb = false;  // colour space: RGB stored as is

  Jpeg(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u16(size_t at) const {
    if (at + 2 > n) fail("truncated file");
    return (data[at] << 8) | data[at + 1];
  }

  void parse_sof(size_t at, int len, int marker, bool allocate) {
    if (marker != 0xC0 && marker != 0xC1) {
      const char* why = marker == 0xC2 ? "progressive JPEG (SOF2)"
                        : marker == 0xC3 ? "lossless JPEG (SOF3)"
                        : marker >= 0xC9 ? "arithmetic-coded JPEG"
                                         : "hierarchical or unsupported JPEG frame";
      fail(std::string("unsupported: ") + why + "; only baseline Huffman JPEG is decoded");
    }
    if (len < 8) fail("bad SOF segment");
    int precision = data[at];
    if (precision != 8) fail("unsupported: " + std::to_string(precision) + "-bit samples");
    height = u16(at + 1);
    width = u16(at + 3);
    int nc = data[at + 5];
    if (width <= 0 || height <= 0) fail("bad image size (DNL-defined height is not supported)");
    if (nc != 1 && nc != 3)
      fail("unsupported: " + std::to_string(nc) + "-component JPEG (CMYK/YCCK or other)");
    if (len < 8 + 3 * nc) fail("bad SOF segment");
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = data[at + 6 + 3 * i];
      c.h = data[at + 7 + 3 * i] >> 4;
      c.v = data[at + 7 + 3 * i] & 15;
      c.tq = data[at + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      if (allocate) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    saw_sof = true;
  }

  void parse_dqt(size_t at, int len) {
    size_t end = at + len - 2;
    while (at < end) {
      int pq = data[at] >> 4, tq = data[at] & 15;
      if (tq > 3 || pq > 1) fail("bad DQT segment");
      ++at;
      for (int k = 0; k < 64; ++k) {
        int v;
        if (pq) {
          v = u16(at);
          at += 2;
        } else {
          if (at >= n) fail("truncated file");
          v = data[at++];
        }
        qt[tq][kZigzag[k]] = static_cast<uint16_t>(v);
      }
      qt_present[tq] = true;
    }
  }

  void parse_dht(size_t at, int len) {
    size_t end = at + len - 2;
    while (at < end) {
      if (at + 17 > n) fail("truncated file");
      int tc = data[at] >> 4, th = data[at] & 15;
      if (tc > 1 || th > 3) fail("bad DHT segment");
      const uint8_t* counts = data + at + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || at + 17 + total > n) fail("bad DHT segment");
      (tc ? ac[th] : dc[th]).build(counts, data + at + 17, total);
      at += 17 + total;
    }
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = decode_huff(br, hd);
    if (s > 15) fail("corrupt DC code");
    int diff = s ? extend(br.get(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64;) {
      int rs = decode_huff(br, ha);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) fail("corrupt AC run");
        blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  // One scan (SOS at `at`); returns the offset just past its entropy data.
  size_t decode_scan(size_t at, int len) {
    if (!saw_sof) fail("SOS before SOF");
    int ns = data[at];
    if (ns < 1 || ns > 4 || len < 6 + 2 * ns) fail("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int cid = data[at + 1 + 2 * i];
      Component* found = nullptr;
      for (Component& c : comps)
        if (c.id == cid) found = &c;
      if (!found) fail("SOS names an unknown component");
      found->td = data[at + 2 + 2 * i] >> 4;
      found->ta = data[at + 2 + 2 * i] & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].present || !ac[found->ta].present)
        fail("SOS uses a missing Huffman table");
      sc.push_back(found);
    }
    size_t p = at + 1 + 2 * ns;
    int ss = data[p], se = data[p + 1], ah = data[p + 2] >> 4, al = data[p + 2] & 15;
    if (ss != 0 || se != 63 || ah != 0 || al != 0) fail("unsupported: spectral selection");
    BitReader br;
    br.p = data + at + len - 2;
    br.end = data + n;
    for (Component* c : sc) c->dc_pred = 0;

    int units_x, units_y;
    if (ns == 1) {  // non-interleaved: one block a unit over the component's real blocks
      units_x = (sc[0]->dw + 7) / 8;
      units_y = (sc[0]->dh + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    int64_t total = int64_t(units_x) * units_y;
    int rst = 0;
    for (int64_t u = 0; u < total; ++u) {
      if (restart_interval && u > 0 && u % restart_interval == 0) {
        br.restart(rst);
        rst = (rst + 1) & 7;
        for (Component* c : sc) c->dc_pred = 0;
      }
      int ux = int(u % units_x), uy = int(u / units_x);
      if (ns == 1) {
        Component& c = *sc[0];
        decode_block(br, c, &c.coef[(size_t(uy) * c.bw + ux) * 64]);
      } else {
        for (Component* cp : sc) {
          Component& c = *cp;
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              int gx = ux * c.h + bx, gy = uy * c.v + by;
              decode_block(br, c, &c.coef[(size_t(gy) * c.bw + gx) * 64]);
            }
        }
      }
    }
    br.check_overrun();
    // the segment ends at the next marker (skip any stray bytes before it)
    const uint8_t* q = br.p;
    while (q + 1 < data + n && !(q[0] == 0xFF && q[1] != 0x00 && !(q[1] >= 0xD0 && q[1] <= 0xD7)))
      ++q;
    return size_t(q - data);
  }

  // The segments up to the end of the image; with header_only, up to the
  // frame header (SOF), which gives the size and the components.
  void parse(bool header_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    size_t at = 2;
    bool scanned = false;
    while (true) {
      while (at < n && data[at] != 0xFF) ++at;  // tolerate garbage between segments
      while (at < n && data[at] == 0xFF) ++at;
      if (at >= n) {
        if (scanned) return;
        fail("truncated file: no image data");
      }
      int marker = data[at++];
      if (marker == 0xD9) {
        if (!scanned) fail("no image data before EOI");
        return;
      }
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      int len = u16(at);
      if (len < 2 || at + len > n) fail("truncated file");
      size_t body = at + 2;
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          if (saw_sof) fail("more than one frame");
          parse_sof(body, len, marker, !header_only);
          if (header_only) return;
          at += len;
          break;
        case 0xC4:
          parse_dht(body, len);
          at += len;
          break;
        case 0xCC:
          fail("unsupported: arithmetic-coded JPEG");
        case 0xDB:
          parse_dqt(body, len);
          at += len;
          break;
        case 0xDD:
          if (len < 4) fail("bad DRI segment");
          restart_interval = u16(body);
          at += len;
          break;
        case 0xDA:
          at = decode_scan(body, len);
          scanned = true;
          break;
        case 0xE0:
          if (len >= 7 && std::memcmp(data + body, "JFIF\0", 5) == 0) saw_jfif = true;
          at += len;
          break;
        case 0xEE:
          if (len >= 14 && std::memcmp(data + body, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = data[body + 11];
          }
          at += len;
          break;
        case 0xDC:
          fail("unsupported: DNL marker");
        default:
          at += len;
      }
    }
  }

  void colour_space() {
    if (comps.size() != 3) return;
    if (saw_jfif) {
      transform_rgb = false;
    } else if (saw_adobe) {
      transform_rgb = adobe_transform == 0;
    } else {
      transform_rgb = comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
    }
  }
};

// One component's samples at full resolution (the upsampler of jdsample.c).
void upsample(const Component& c, const uint8_t* plane, int pstride, int hmax, int vmax,
              int width, int height, std::vector<uint8_t>& out) {
  out.assign(size_t(width) * height, 0);
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int r) { return plane + size_t(r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * pstride; };
  std::vector<int> colsum(dw);
  std::vector<uint8_t> line(size_t(dw) * 2 + 8);
  const bool hfull = c.h == hmax, vfull = c.v == vmax;
  const bool h2 = c.h * 2 == hmax, v2 = c.v * 2 == vmax;
  if (hfull && vfull) {
    for (int y = 0; y < height; ++y) std::memcpy(&out[size_t(y) * width], row(y), width);
  } else if (h2 && vfull) {
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y);
      uint8_t* o = line.data();
      if (dw > 2) {
        o[0] = in[0];
        o[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int iv = in[x] * 3;
          o[2 * x] = uint8_t((iv + in[x - 1] + 1) >> 2);
          o[2 * x + 1] = uint8_t((iv + in[x + 1] + 2) >> 2);
        }
        int x = dw - 1;
        o[2 * x] = uint8_t((in[x] * 3 + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = in[x];
      } else {
        for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = in[x];
      }
      std::memcpy(&out[size_t(y) * width], o, width);
    }
  } else if (hfull && v2) {
    for (int y = 0; y < height; ++y) {
      int r = y >> 1, v = y & 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(v ? r + 1 : r - 1);
      int bias = v ? 2 : 1;
      uint8_t* o = &out[size_t(y) * width];
      for (int x = 0; x < width; ++x) o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    }
  } else if (h2 && v2) {
    for (int y = 0; y < height; ++y) {
      int r = y >> 1, v = y & 1;
      const uint8_t* in0 = row(r);
      uint8_t* o = line.data();
      if (dw > 2) {
        const uint8_t* in1 = row(v ? r + 1 : r - 1);
        for (int x = 0; x < dw; ++x) colsum[x] = in0[x] * 3 + in1[x];
        o[0] = uint8_t((colsum[0] * 4 + 8) >> 4);
        o[1] = uint8_t((colsum[0] * 3 + colsum[1] + 7) >> 4);
        for (int x = 1; x < dw - 1; ++x) {
          o[2 * x] = uint8_t((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
          o[2 * x + 1] = uint8_t((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
        }
        int x = dw - 1;
        o[2 * x] = uint8_t((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
        o[2 * x + 1] = uint8_t((colsum[x] * 4 + 7) >> 4);
      } else {
        for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = in0[x];
      }
      std::memcpy(&out[size_t(y) * width], o, width);
    }
  } else if (hmax % c.h == 0 && vmax % c.v == 0) {
    int fx = hmax / c.h, fy = vmax / c.v;
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = plane + size_t(y / fy) * pstride;
      uint8_t* o = &out[size_t(y) * width];
      for (int x = 0; x < width; ++x) o[x] = in[x / fx];
    }
  } else {
    fail("unsupported: fractional sampling ratio");
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [&](double x) { return int64_t(x * double(int64_t(1) << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Reads a JPEG's header: width, height and channels of the decoded array
// (1 grey, 3 RGB). Returns 0, or 1 with a message in err.
int mtgs_jpeg_info(const uint8_t* data, int64_t n, int* width, int* height, int* channels,
                   char* err, int errlen) {
  try {
    Jpeg j(data, size_t(n));
    j.parse(true);
    *width = j.width;
    *height = j.height;
    *channels = int(j.comps.size());
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
    return 1;
  }
}

// Decodes a JPEG into out (height x width x channels uint8, row-major).
int mtgs_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size, char* err,
                     int errlen) {
  try {
    Jpeg j(data, size_t(n));
    j.parse(false);
    j.colour_space();
    const int W = j.width, H = j.height, nc = int(j.comps.size());
    if (out_size != int64_t(W) * H * nc) fail("output buffer has the wrong size");
    std::vector<std::vector<uint8_t>> full(nc);
    for (int ci = 0; ci < nc; ++ci) {
      Component& c = j.comps[ci];
      if (!j.qt_present[c.tq]) fail("missing quantization table");
      const int pstride = c.bw * 8;
      std::vector<uint8_t> plane(size_t(pstride) * c.bh * 8);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], j.qt[c.tq],
                     &plane[size_t(by) * 8 * pstride + size_t(bx) * 8], pstride);
      std::vector<int16_t>().swap(c.coef);
      upsample(c, plane.data(), pstride, j.hmax, j.vmax, W, H, full[ci]);
    }
    const size_t npix = size_t(W) * H;
    if (nc == 1) {
      std::memcpy(out, full[0].data(), npix);
    } else if (j.transform_rgb) {
      for (size_t i = 0; i < npix; ++i) {
        out[3 * i] = full[0][i];
        out[3 * i + 1] = full[1][i];
        out[3 * i + 2] = full[2][i];
      }
    } else {
      const uint8_t* Y = full[0].data();
      const uint8_t* Cb = full[1].data();
      const uint8_t* Cr = full[2].data();
      for (size_t i = 0; i < npix; ++i) {
        int y = Y[i], cb = Cb[i], cr = Cr[i];
        out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
        out[3 * i + 1] = clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
      }
    }
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 1;
  }
}

// Undoes the PNG row filters: raw holds height rows of (1 filter byte +
// stride bytes); out receives height x stride bytes. bpp is the filter's
// byte distance (bytes per complete pixel, at least 1). Returns 0, or 1
// with a message in err.
int mtgs_png_unfilter(const uint8_t* raw, int64_t raw_len, int height, int64_t stride, int bpp,
                      uint8_t* out, char* err, int errlen) {
  if (raw_len < int64_t(height) * (stride + 1)) {
    set_error(err, errlen, "image data ends early (truncated or corrupt file)");
    return 1;
  }
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = raw + int64_t(y) * (stride + 1);
    int filter = in[0];
    ++in;
    uint8_t* o = out + int64_t(y) * stride;
    switch (filter) {
      case 0:
        std::memcpy(o, in, size_t(stride));
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          o[x] = uint8_t(in[x] + (x >= bpp ? o[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x) o[x] = uint8_t(in[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
          o[x] = uint8_t(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
          int c = (x >= bpp && prev) ? prev[x - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[x] = uint8_t(in[x] + pred);
        }
        break;
      default:
        set_error(err, errlen, "bad row filter " + std::to_string(filter));
        return 1;
    }
    prev = o;
  }
  return 0;
}

}  // extern "C"
