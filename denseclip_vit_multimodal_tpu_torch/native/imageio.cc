// Host image I/O of the PyTorch port: a baseline JPEG decoder that gives
// libjpeg-turbo's pixels (as Pillow's `Image.open(...).convert("RGB")` returns
// them), and Pillow's BILINEAR and NEAREST `Image.resize`, computed as Pillow
// computes them.  Plain C entry points, bound by ctypes in `utils/imageio.py`
// (each call releases the GIL).  Built with -ffp-contract=off: the resize
// coefficients are doubles, and an FMA would change one on another host.
//
// Decoder scope: SOF0 / SOF1 at 8-bit precision, Huffman coding (tables
// given or optimised), DQT at 8 and 16 bits, DRI with RSTn markers, one
// component (gray, replicated to RGB) or three at 4:4:4, 4:2:2 or 4:2:0,
// interleaved or not.  It computes what libjpeg's v6b API computes by
// default: `jpeg_idct_islow` with its range limit, fancy upsampling for
// h2v1 and h2v2 (replication where the chroma is at most 2 samples wide),
// and `ycc_rgb_convert`'s fixed-point tables; JFIF, else an Adobe transform
// of 0, else component ids 'R','G','B' decide YCbCr against RGB as
// `default_decompress_parms` does.  Progressive, lossless, hierarchical and
// arithmetic-coded files, 12-bit samples, 4-component (CMYK / YCCK) files
// and other sampling factors return IMAGEIO_UNSUPPORTED with the mode named.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { IMAGEIO_OK = 0, IMAGEIO_UNSUPPORTED = 1, IMAGEIO_INVALID = 2 };

struct Error {
  int code;
  std::string message;
};

[[noreturn]] void fail(int code, const std::string& message) { throw Error{code, message}; }

void set_error(char* err, size_t errlen, const std::string& message) {
  if (err == nullptr || errlen == 0) return;
  size_t n = message.size() < errlen - 1 ? message.size() : errlen - 1;
  std::memcpy(err, message.data(), n);
  err[n] = '\0';
}

// ---------------------------------------------------------------- markers

constexpr int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // libjpeg's extra entries: a corrupt run past 63 lands on 63
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool present = false;
  uint8_t values[256] = {};
  int maxcode[18] = {};  // largest code of each length, -1 if none
  int valptr[17] = {};
  int mincode[17] = {};
  uint16_t fast[1 << 9] = {};  // 9-bit lookahead: (length << 8) | value, 0 = slow path
};

void build_huffman(Huffman& h, const uint8_t counts[16], const uint8_t* values, int nvalues) {
  h.present = true;
  std::memcpy(h.values, values, nvalues);
  std::memset(h.fast, 0, sizeof(h.fast));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    h.valptr[len] = k;
    h.mincode[len] = code;
    for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
      if (len <= 9) {
        int shift = 9 - len;
        for (int j = 0; j < (1 << shift); j++)
          h.fast[(code << shift) | j] = static_cast<uint16_t>((len << 8) | values[k]);
      }
    }
    h.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) fail(IMAGEIO_INVALID, "bad Huffman table");
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;          // Huffman tables of the current scan
  int bw = 0, bh = 0;          // coefficient blocks held (whole MCUs)
  int dw = 0, dh = 0;          // downsampled_width / _height
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  int pred = 0;
};

struct Jpeg {
  const uint8_t* data = nullptr;
  size_t size = 0, pos = 0;
  int width = 0, height = 0, precision = 8, ncomp = 0;
  std::string kind;  // "baseline", "extended", "progressive", ...
  Component comp[4];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  uint16_t qt[4][64] = {};
  bool qt_present[4] = {};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame_seen = false;

  int byte() {
    if (pos >= size) fail(IMAGEIO_INVALID, "truncated JPEG");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
};

std::string mode_of(const Jpeg& j) {
  std::string mode = j.kind;
  if (j.precision != 8) mode += " " + std::to_string(j.precision) + "-bit";
  return mode;
}

// The marker that follows, skipping fill bytes (0xFF runs).
int next_marker(Jpeg& j) {
  int c = j.byte();
  while (c != 0xFF) c = j.byte();  // libjpeg skips garbage before a marker too
  while (c == 0xFF) c = j.byte();
  return c;
}

void read_sof(Jpeg& j, int marker) {
  int len = j.word();
  size_t end = j.pos + len - 2;
  static const char* kinds[16] = {"baseline",    "extended",     "progressive", "lossless",
                                  "",            "hierarchical", "hierarchical", "hierarchical",
                                  "",            "arithmetic-coded", "arithmetic-coded", "arithmetic-coded",
                                  "",            "arithmetic-coded", "arithmetic-coded", "arithmetic-coded"};
  j.kind = kinds[marker - 0xC0];
  j.precision = j.byte();
  j.height = j.word();
  j.width = j.word();
  j.ncomp = j.byte();
  if (j.ncomp < 1 || j.ncomp > 4) fail(IMAGEIO_INVALID, "bad component count " + std::to_string(j.ncomp));
  for (int i = 0; i < j.ncomp; i++) {
    Component& c = j.comp[i];
    c.id = j.byte();
    int hv = j.byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = j.byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      fail(IMAGEIO_INVALID, "bad component parameters");
  }
  j.pos = end;
  j.frame_seen = true;
}

// Everything a decode refuses, by what the frame header says.
void check_supported(const Jpeg& j) {
  if (j.kind != "baseline" && j.kind != "extended")
    fail(IMAGEIO_UNSUPPORTED, mode_of(j) + " JPEG");
  if (j.precision != 8) fail(IMAGEIO_UNSUPPORTED, mode_of(j) + " JPEG");
  if (j.ncomp == 4) fail(IMAGEIO_UNSUPPORTED, "4-component (CMYK/YCCK) JPEG");
  if (j.ncomp != 1 && j.ncomp != 3)
    fail(IMAGEIO_UNSUPPORTED, std::to_string(j.ncomp) + "-component JPEG");
  if (j.width < 1 || j.height < 1) fail(IMAGEIO_INVALID, "JPEG of zero size (DNL is not read)");
  if (j.ncomp == 3) {
    const Component* c = j.comp;
    bool chroma_same = c[1].h == c[2].h && c[1].v == c[2].v;
    bool s444 = chroma_same && c[0].h == c[1].h && c[0].v == c[1].v;
    bool s422 = chroma_same && c[1].h == 1 && c[1].v == 1 && c[0].h == 2 && c[0].v == 1;
    bool s420 = chroma_same && c[1].h == 1 && c[1].v == 1 && c[0].h == 2 && c[0].v == 2;
    if (!(s444 || s422 || s420)) {
      char buf[96];
      std::snprintf(buf, sizeof buf, "JPEG sampling factors %dx%d,%dx%d,%dx%d", c[0].h, c[0].v,
                    c[1].h, c[1].v, c[2].h, c[2].v);
      fail(IMAGEIO_UNSUPPORTED, buf);
    }
  }
}

void read_dqt(Jpeg& j) {
  int len = j.word() - 2;
  while (len > 0) {
    int pq_tq = j.byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3 || pq > 1) fail(IMAGEIO_INVALID, "bad DQT");
    for (int k = 0; k < 64; k++) j.qt[tq][kZigzag[k]] = static_cast<uint16_t>(pq ? j.word() : j.byte());
    j.qt_present[tq] = true;
    len -= 1 + 64 * (pq ? 2 : 1);
  }
}

void read_dht(Jpeg& j) {
  int len = j.word() - 2;
  while (len > 0) {
    int tc_th = j.byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) fail(IMAGEIO_INVALID, "bad DHT");
    uint8_t counts[16];
    int total = 0;
    for (int i = 0; i < 16; i++) total += counts[i] = static_cast<uint8_t>(j.byte());
    if (total > 256) fail(IMAGEIO_INVALID, "bad DHT");
    uint8_t values[256];
    for (int i = 0; i < total; i++) values[i] = static_cast<uint8_t>(j.byte());
    build_huffman(tc ? j.ac[th] : j.dc[th], counts, values, total);
    len -= 17 + total;
  }
}

void read_app(Jpeg& j, int marker) {
  int len = j.word() - 2;
  if (len < 0 || j.pos + len > j.size) fail(IMAGEIO_INVALID, "truncated JPEG");
  const uint8_t* p = j.data + j.pos;
  if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) j.jfif = true;
  if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
    j.adobe = true;
    j.adobe_transform = p[11];
  }
  j.pos += len;
}

void skip_segment(Jpeg& j) {
  int len = j.word() - 2;
  if (len < 0 || j.pos + len > j.size) fail(IMAGEIO_INVALID, "truncated JPEG");
  j.pos += len;
}

// Reads markers up to and including the first SOF (header only) or up to SOS.
// Returns the marker it stopped at.
int read_markers(Jpeg& j, bool stop_at_sof) {
  for (;;) {
    int m = next_marker(j);
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // SOI, RSTn, TEM
    if (m == 0xD9) return m;
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (j.frame_seen) fail(IMAGEIO_INVALID, "two frame headers");
      read_sof(j, m);
      if (stop_at_sof) return m;
      continue;
    }
    switch (m) {
      case 0xC4: read_dht(j); break;
      case 0xCC: fail(IMAGEIO_UNSUPPORTED, "arithmetic-coded JPEG");
      case 0xDB: read_dqt(j); break;
      case 0xDD:
        j.word();
        j.restart_interval = j.word();
        break;
      case 0xDA: return m;
      default:
        if (m >= 0xE0 && m <= 0xEF) read_app(j, m);
        else skip_segment(j);  // COM, DNL, JPGn, ...
    }
  }
}

// ------------------------------------------------------------ entropy decode

struct BitReader {
  Jpeg& j;
  uint64_t acc = 0;
  int bits = 0;
  bool hit_marker = false;

  explicit BitReader(Jpeg& jpeg) : j(jpeg) {}

  void fill() {
    while (bits <= 56) {
      int c = 0;
      if (!hit_marker) {
        if (j.pos >= j.size) fail(IMAGEIO_INVALID, "truncated JPEG");
        c = j.data[j.pos];
        if (c == 0xFF) {
          int next = j.pos + 1 < j.size ? j.data[j.pos + 1] : -1;
          if (next == 0x00) {
            j.pos += 2;
          } else {
            hit_marker = true;  // leave the marker; feed zeros as libjpeg does
            c = 0;
          }
        } else {
          j.pos++;
        }
      }
      acc |= static_cast<uint64_t>(c) << (56 - bits);
      bits += 8;
    }
  }
  int peek(int n) {
    if (bits < n) fill();
    return static_cast<int>(acc >> (64 - n));
  }
  void skip(int n) {
    acc <<= n;
    bits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  int decode(const Huffman& h) {
    int look = peek(9);
    uint16_t f = h.fast[look];
    if (f) {
      skip(f >> 8);
      return f & 0xFF;
    }
    int code = get(9);
    int len = 9;
    while (code > h.maxcode[len]) {
      code = (code << 1) | get(1);
      if (++len > 16) fail(IMAGEIO_INVALID, "bad Huffman code");
    }
    if (h.maxcode[len] < 0) fail(IMAGEIO_INVALID, "bad Huffman code");
    return h.values[h.valptr[len] + code - h.mincode[len]];
  }
  int extend(int s) {
    int v = get(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  void restart() {
    acc = 0;
    bits = 0;
    // the marker, possibly after fill bytes: FF Dn
    for (;;) {
      if (j.pos + 1 >= j.size) fail(IMAGEIO_INVALID, "truncated JPEG");
      if (j.data[j.pos] == 0xFF && j.data[j.pos + 1] >= 0xD0 && j.data[j.pos + 1] <= 0xD7) {
        j.pos += 2;
        break;
      }
      if (j.data[j.pos] == 0xFF && j.data[j.pos + 1] != 0xFF && j.data[j.pos + 1] != 0x00)
        fail(IMAGEIO_INVALID, "missing restart marker");
      j.pos++;
    }
    hit_marker = false;
  }
};

void decode_block(BitReader& br, Component& c, const Huffman& dc, const Huffman& ac,
                  int16_t* block) {
  int t = br.decode(dc);
  int diff = t ? br.extend(t) : 0;
  c.pred += diff;
  block[0] = static_cast<int16_t>(c.pred);
  for (int k = 1; k < 64; k++) {
    int rs = br.decode(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      block[kZigzag[k]] = static_cast<int16_t>(br.extend(s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void read_scan(Jpeg& j) {
  int len = j.word();
  size_t end = j.pos + len - 2;
  int ns = j.byte();
  if (ns < 1 || ns > j.ncomp) fail(IMAGEIO_INVALID, "bad scan header");
  Component* sc[4];
  for (int i = 0; i < ns; i++) {
    int id = j.byte(), tables = j.byte();
    sc[i] = nullptr;
    for (int k = 0; k < j.ncomp; k++)
      if (j.comp[k].id == id) sc[i] = &j.comp[k];
    if (sc[i] == nullptr) fail(IMAGEIO_INVALID, "scan names an unknown component");
    sc[i]->td = tables >> 4;
    sc[i]->ta = tables & 15;
    if (sc[i]->td > 3 || sc[i]->ta > 3 || !j.dc[sc[i]->td].present || !j.ac[sc[i]->ta].present)
      fail(IMAGEIO_INVALID, "scan uses a missing Huffman table");
  }
  int ss = j.byte(), se = j.byte(), ahal = j.byte();
  if (ss != 0 || se != 63 || ahal != 0) fail(IMAGEIO_INVALID, "bad sequential scan");
  j.pos = end;

  BitReader br(j);
  for (int i = 0; i < ns; i++) sc[i]->pred = 0;
  int units_x, units_y;
  if (ns == 1) {  // non-interleaved: one block per MCU over the component's own extent
    units_x = (sc[0]->dw + 7) / 8;
    units_y = (sc[0]->dh + 7) / 8;
  } else {
    units_x = j.mcux;
    units_y = j.mcuy;
  }
  int todo = j.restart_interval;
  for (int my = 0; my < units_y; my++) {
    for (int mx = 0; mx < units_x; mx++) {
      if (j.restart_interval) {
        if (todo == 0) {
          br.restart();
          for (int i = 0; i < ns; i++) sc[i]->pred = 0;
          todo = j.restart_interval;
        }
        todo--;
      }
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; by++)
          for (int bx = 0; bx < bw; bx++) {
            int row = ns == 1 ? my : my * c.v + by;
            int col = ns == 1 ? mx : mx * c.h + bx;
            decode_block(br, c, j.dc[c.td], j.ac[c.ta], &c.coef[(size_t(row) * c.bw + col) * 64]);
          }
      }
    }
  }
  // leave the position at the marker after the entropy-coded data
  for (;;) {
    if (j.pos + 1 >= j.size) {
      j.pos = j.size;
      return;
    }
    if (j.data[j.pos] == 0xFF && j.data[j.pos + 1] != 0x00 &&
        !(j.data[j.pos + 1] >= 0xD0 && j.data[j.pos + 1] <= 0xD7))
      return;
    j.pos++;
  }
}

// --------------------------------------------------------------------- IDCT

// libjpeg's jidctint.c (jpeg_idct_islow), 8x8, with the sample range limit.
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) { return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n); }

// post-IDCT range limit: x in [-128, 127] -> x + 128, saturating, masked to 10 bits first
uint8_t g_idct_limit[1024];
uint8_t g_limit[1024 + 256];  // sample_range_limit[-256 .. 767], clamped

struct Tables {
  Tables() {
    for (int v = 0; v < 1024; v++) {
      int out;
      if (v < 128) out = v + 128;
      else if (v < 512) out = 255;
      else if (v < 896) out = 0;
      else out = v - 896;
      g_idct_limit[v] = static_cast<uint8_t>(out);
    }
    for (int i = 0; i < 1024 + 256; i++) {
      int x = i - 256;
      g_limit[i] = static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
    }
  }
} g_tables;

void idct_islow(const int16_t* in, const int16_t* quant, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = quant + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dc = (int32_t(ip[0]) * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = int32_t(ip[16]) * qp[16], z3 = int32_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(ip[0]) * qp[0];
    z3 = int32_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(ip[56]) * qp[56];
    tmp1 = int32_t(ip[40]) * qp[40];
    tmp2 = int32_t(ip[24]) * qp[24];
    tmp3 = int32_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = descale(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    wp[56] = descale(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    wp[8] = descale(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    wp[48] = descale(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    wp[16] = descale(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    wp[40] = descale(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    wp[24] = descale(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    wp[32] = descale(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* wp = ws + r * 8;
    uint8_t* op = out + size_t(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = g_idct_limit[descale(wp[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = CONST_BITS + PASS1_BITS + 3;
    op[0] = g_idct_limit[descale(tmp10 + tmp3, n) & 1023];
    op[7] = g_idct_limit[descale(tmp10 - tmp3, n) & 1023];
    op[1] = g_idct_limit[descale(tmp11 + tmp2, n) & 1023];
    op[6] = g_idct_limit[descale(tmp11 - tmp2, n) & 1023];
    op[2] = g_idct_limit[descale(tmp12 + tmp1, n) & 1023];
    op[5] = g_idct_limit[descale(tmp12 - tmp1, n) & 1023];
    op[3] = g_idct_limit[descale(tmp13 + tmp0, n) & 1023];
    op[4] = g_idct_limit[descale(tmp13 - tmp0, n) & 1023];
  }
}

// ------------------------------------------------------- upsample + convert

// One plane of a component at its downsampled extent.
struct Plane {
  int w = 0, h = 0, stride = 0;
  std::vector<uint8_t> px;
  const uint8_t* row(int y) const { return px.data() + size_t(y) * stride; }
};

Plane idct_component(const Jpeg& j, const Component& c) {
  Plane p;
  p.stride = c.bw * 8;
  p.w = c.dw;
  p.h = c.dh;
  int rows = (c.dh + 7) / 8, cols = (c.dw + 7) / 8;
  p.px.assign(size_t(rows) * 8 * p.stride, 0);
  int16_t quant[64];
  for (int k = 0; k < 64; k++) quant[k] = static_cast<int16_t>(j.qt[c.tq][k]);  // ISLOW_MULT_TYPE
  for (int by = 0; by < rows; by++)
    for (int bx = 0; bx < cols; bx++)
      idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], quant,
                 p.px.data() + size_t(by) * 8 * p.stride + bx * 8, p.stride);
  return p;
}

// Output row `y` of a chroma plane upsampled to `width` (libjpeg's h2v1 / h2v2
// fancy upsampling; replication where the plane is at most 2 samples wide).
void upsample_row(const Plane& p, int hf, int vf, int y, int width, uint8_t* out) {
  if (hf == 1 && vf == 1) {
    std::memcpy(out, p.row(y), width);
    return;
  }
  bool fancy = p.w > 2;
  if (!fancy) {
    const uint8_t* in = p.row(vf == 2 ? y >> 1 : y);
    for (int x = 0; x < width; x++) out[x] = in[x >> 1];
    return;
  }
  if (vf == 1) {  // h2v1
    const uint8_t* in = p.row(y);
    int last = p.w - 1;
    for (int x = 0; x < width; x++) {
      int c = x >> 1;
      int v = in[c] * 3;
      if (x & 1) out[x] = static_cast<uint8_t>((v + in[c < last ? c + 1 : last] + 2) >> 2);
      else out[x] = static_cast<uint8_t>((v + in[c > 0 ? c - 1 : 0] + 1) >> 2);
    }
    return;
  }
  // h2v2: the nearer row times 3 plus the farther one, then along the row
  int r = y >> 1;
  int other = (y & 1) ? (r + 1 < p.h ? r + 1 : p.h - 1) : (r > 0 ? r - 1 : 0);
  const uint8_t* in0 = p.row(r);
  const uint8_t* in1 = p.row(other);
  int last = p.w - 1;
  for (int x = 0; x < width; x++) {
    int c = x >> 1;
    int cs = in0[c] * 3 + in1[c];
    if (x & 1) {
      int n = c < last ? c + 1 : last;
      out[x] = static_cast<uint8_t>((cs * 3 + in0[n] * 3 + in1[n] + 7) >> 4);
    } else {
      int n = c > 0 ? c - 1 : 0;
      out[x] = static_cast<uint8_t>((cs * 3 + in0[n] * 3 + in1[n] + 8) >> 4);
    }
  }
}

void decode(Jpeg& j, uint8_t* out) {
  // frame geometry
  for (int i = 0; i < j.ncomp; i++) {
    j.hmax = std::max(j.hmax, j.comp[i].h);
    j.vmax = std::max(j.vmax, j.comp[i].v);
  }
  j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int i = 0; i < j.ncomp; i++) {
    Component& c = j.comp[i];
    c.dw = (j.width * c.h + j.hmax - 1) / j.hmax;
    c.dh = (j.height * c.v + j.vmax - 1) / j.vmax;
    c.bw = j.mcux * c.h;
    c.bh = j.mcuy * c.v;
    c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
  }
  // scans until EOI
  int m = 0xDA;
  bool any_scan = false;
  for (;;) {
    if (m == 0xDA) {
      read_scan(j);
      any_scan = true;
    } else if (m == 0xD9) {
      break;
    }
    if (j.pos >= j.size) break;  // no EOI after the data: what was read stands
    m = read_markers(j, false);
  }
  if (!any_scan) fail(IMAGEIO_INVALID, "JPEG without a scan");
  for (int i = 0; i < j.ncomp; i++)
    if (!j.qt_present[j.comp[i].tq]) fail(IMAGEIO_INVALID, "component uses a missing DQT");

  const int w = j.width, h = j.height;
  if (j.ncomp == 1) {
    Plane p = idct_component(j, j.comp[0]);
    for (int y = 0; y < h; y++) {
      const uint8_t* in = p.row(y);
      uint8_t* o = out + size_t(y) * w * 3;
      for (int x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
    }
    return;
  }
  bool rgb;
  if (j.jfif) rgb = false;
  else if (j.adobe) rgb = j.adobe_transform == 0;
  else rgb = j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B';

  Plane planes[3];
  for (int i = 0; i < 3; i++) planes[i] = idct_component(j, j.comp[i]);
  int hf[3], vf[3];
  for (int i = 0; i < 3; i++) {
    hf[i] = j.hmax / j.comp[i].h;
    vf[i] = j.vmax / j.comp[i].v;
  }
  // ycc_rgb_convert's tables
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  constexpr int SCALEBITS = 16;
  constexpr int32_t ONE_HALF = int32_t(1) << (SCALEBITS - 1);
  auto fix = [](double x) { return static_cast<int32_t>(x * (1L << SCALEBITS) + 0.5); };
  for (int i = 0, x = -128; i < 256; i++, x++) {
    cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = (-fix(0.71414)) * x;
    cb_g[i] = (-fix(0.34414)) * x + ONE_HALF;
  }
  const uint8_t* limit = g_limit + 256;
  std::vector<uint8_t> rows(size_t(3) * w);
  for (int y = 0; y < h; y++) {
    uint8_t* c[3] = {rows.data(), rows.data() + w, rows.data() + 2 * w};
    for (int i = 0; i < 3; i++) upsample_row(planes[i], hf[i], vf[i], y, w, c[i]);
    uint8_t* o = out + size_t(y) * w * 3;
    if (rgb) {
      for (int x = 0; x < w; x++) {
        o[3 * x] = c[0][x];
        o[3 * x + 1] = c[1][x];
        o[3 * x + 2] = c[2][x];
      }
      continue;
    }
    for (int x = 0; x < w; x++) {
      int yy = c[0][x], cb = c[1][x], cr = c[2][x];
      o[3 * x] = limit[yy + cr_r[cr]];
      o[3 * x + 1] = limit[yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS)];
      o[3 * x + 2] = limit[yy + cb_b[cb]];
    }
  }
}

void start(Jpeg& j, const uint8_t* data, size_t size) {
  j.data = data;
  j.size = size;
  j.pos = 0;
  if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail(IMAGEIO_INVALID, "not a JPEG");
}

// ------------------------------------------------------------------- resize

// Pillow's precompute_coeffs (resample.c) for the bilinear filter, then
// normalize_coeffs_8bpc: 22-bit fixed point.
constexpr int PRECISION_BITS = 32 - 8 - 2;

int bilinear_coeffs(int in_size, int out_size, std::vector<int>& bounds, std::vector<int32_t>& kk) {
  double in0 = 0.0, in1 = static_cast<float>(in_size);
  double scale = (in1 - in0) / out_size, filterscale = scale;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = 1.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> pre(size_t(out_size) * ksize, 0.0);
  bounds.assign(size_t(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[size_t(xx) * ksize];
    for (int x = 0; x < xmax; x++) {
      double t = (x + xmin - center + 0.5) * ss;
      if (t < 0.0) t = -t;
      double w = t < 1.0 ? 1.0 - t : 0.0;
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  kk.resize(pre.size());
  for (size_t i = 0; i < pre.size(); i++)
    kk[i] = pre[i] < 0 ? static_cast<int32_t>(-0.5 + pre[i] * (1 << PRECISION_BITS))
                       : static_cast<int32_t>(0.5 + pre[i] * (1 << PRECISION_BITS));
  return ksize;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> PRECISION_BITS);
}

}  // namespace

extern "C" {

// info: width, height, components, precision.  mode: the frame's kind.
int imageio_jpeg_header(const uint8_t* data, size_t size, int32_t* info, char* mode,
                        size_t modelen, char* err, size_t errlen) {
  try {
    Jpeg j;
    start(j, data, size);
    if (read_markers(j, true) == 0xD9 || !j.frame_seen) fail(IMAGEIO_INVALID, "JPEG without a frame header");
    info[0] = j.width;
    info[1] = j.height;
    info[2] = j.ncomp;
    info[3] = j.precision;
    set_error(mode, modelen, j.kind);
    return IMAGEIO_OK;
  } catch (const Error& e) {
    set_error(err, errlen, e.message);
    return e.code;
  }
}

// out: height * width * 3 bytes (the header's size).
int imageio_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size,
                        char* err, size_t errlen) {
  try {
    Jpeg j;
    start(j, data, size);
    int m = read_markers(j, false);
    if (!j.frame_seen) fail(IMAGEIO_INVALID, "JPEG without a frame header");
    check_supported(j);
    if (m != 0xDA) fail(IMAGEIO_INVALID, "JPEG without a scan");
    if (out_size != size_t(j.width) * j.height * 3) fail(IMAGEIO_INVALID, "output buffer size");
    decode(j, out);
    return IMAGEIO_OK;
  } catch (const Error& e) {
    set_error(err, errlen, e.message);
    return e.code;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return IMAGEIO_INVALID;
  }
}

// Pillow's Image.resize(..., BILINEAR) of a uint8 image with `channels`
// interleaved bands: the horizontal pass first, into uint8, over the rows the
// vertical pass reads; a pass whose size does not change is skipped.
int imageio_resize_bilinear_u8(const uint8_t* in, int in_w, int in_h, int channels,
                               uint8_t* out, int out_w, int out_h) {
  try {
    std::vector<int> hb, vb;
    std::vector<int32_t> hk, vk;
    bool need_h = out_w != in_w, need_v = out_h != in_h;
    const uint8_t* src = in;
    int src_w = in_w;
    std::vector<uint8_t> tmp;
    int ybox_first = 0;
    int vks = 0;
    if (need_v) vks = bilinear_coeffs(in_h, out_h, vb, vk);
    if (need_h) {
      int hks = bilinear_coeffs(in_w, out_w, hb, hk);
      int y0 = 0, y1 = in_h;
      if (need_v) {
        y0 = vb[0];
        y1 = vb[out_h * 2 - 2] + vb[out_h * 2 - 1];
      }
      ybox_first = y0;
      uint8_t* dst;
      if (need_v) {
        tmp.resize(size_t(y1 - y0) * out_w * channels);
        dst = tmp.data();
      } else {
        dst = out;
      }
      for (int y = y0; y < y1; y++) {
        const uint8_t* row = in + size_t(y) * in_w * channels;
        uint8_t* orow = dst + size_t(y - y0) * out_w * channels;
        for (int xx = 0; xx < out_w; xx++) {
          int xmin = hb[xx * 2], xmax = hb[xx * 2 + 1];
          const int32_t* k = &hk[size_t(xx) * hks];
          for (int c = 0; c < channels; c++) {
            int32_t ss = 1 << (PRECISION_BITS - 1);
            for (int x = 0; x < xmax; x++) ss += row[(x + xmin) * channels + c] * k[x];
            orow[xx * channels + c] = clip8(ss);
          }
        }
      }
      if (!need_v) return IMAGEIO_OK;
      src = tmp.data();
      src_w = out_w;
    }
    if (need_v) {
      for (int yy = 0; yy < out_h; yy++) {
        int ymin = vb[yy * 2] - ybox_first, ymax = vb[yy * 2 + 1];
        const int32_t* k = &vk[size_t(yy) * vks];
        uint8_t* orow = out + size_t(yy) * src_w * channels;
        for (int i = 0; i < src_w * channels; i++) {
          int32_t ss = 1 << (PRECISION_BITS - 1);
          for (int y = 0; y < ymax; y++) ss += src[size_t(y + ymin) * src_w * channels + i] * k[y];
          orow[i] = clip8(ss);
        }
      }
      return IMAGEIO_OK;
    }
    std::memcpy(out, in, size_t(in_w) * in_h * channels);
    return IMAGEIO_OK;
  } catch (const std::bad_alloc&) {
    return IMAGEIO_INVALID;
  }
}

// Pillow's Image.resize(..., NEAREST): its affine scale (ImagingScaleAffine),
// the source position accumulated in double from (scale / 2) by `scale` per
// pixel and truncated; a position outside the source leaves the fill (0).
// `pixel_bytes` bytes are copied per pixel, so any dtype and band count works.
int imageio_resize_nearest(const uint8_t* in, int in_w, int in_h, int pixel_bytes, uint8_t* out,
                           int out_w, int out_h) {
  try {
    double ax = static_cast<double>(static_cast<float>(in_w) - 0.0f) / out_w;
    double ay = static_cast<double>(static_cast<float>(in_h) - 0.0f) / out_h;
    std::vector<int> xin(out_w, -1);
    double xo = 0.0 + ax * 0.5;
    for (int x = 0; x < out_w; x++) {
      int xi = xo < 0.0 ? -1 : static_cast<int>(xo);
      if (xi >= 0 && xi < in_w) xin[x] = xi;
      xo += ax;
    }
    double yo = 0.0 + ay * 0.5;
    size_t orow_bytes = size_t(out_w) * pixel_bytes, irow_bytes = size_t(in_w) * pixel_bytes;
    for (int y = 0; y < out_h; y++) {
      int yi = yo < 0.0 ? -1 : static_cast<int>(yo);
      uint8_t* o = out + size_t(y) * orow_bytes;
      std::memset(o, 0, orow_bytes);
      if (yi >= 0 && yi < in_h) {
        const uint8_t* row = in + size_t(yi) * irow_bytes;
        for (int x = 0; x < out_w; x++)
          if (xin[x] >= 0) std::memcpy(o + size_t(x) * pixel_bytes, row + size_t(xin[x]) * pixel_bytes, pixel_bytes);
      }
      yo += ay;
    }
    return IMAGEIO_OK;
  } catch (const std::bad_alloc&) {
    return IMAGEIO_INVALID;
  }
}

}  // extern "C"
