// Baseline JPEG decode and encode with libjpeg-turbo's integer arithmetic, so
// that a decoded frame equals what cv2.imread returns bit for bit and an
// encoded one is what cv2.imwrite writes at its defaults.
//
// Decode: baseline (SOF0) and extended-sequential (SOF1) Huffman files, 8-bit,
// 1 or 3 components; with 3, the first component sampled 1x1, 2x1 or 2x2 and
// the other two 1x1. Interleaved and non-interleaved scans, restart intervals.
// The routines copy, one for one:
//   * jdhuff.c: the Huffman decode, DC prediction, the AC run/size decode
//     through jpeg_natural_order (with its 16 trailing 63s), zero bits and
//     zero MCUs once the entropy data is exhausted;
//   * jidctint.c jpeg_idct_islow: the slow-integer IDCT (CONST_BITS 13,
//     PASS1_BITS 2) and jdmaster.c's post-IDCT range-limit table (the
//     RANGE_MASK wrap);
//   * jdsample.c: h2v1_fancy_upsample and h2v2_fancy_upsample (the triangle
//     filter, with jdmainct.c's edge rows), and the box upsamplers for a
//     chroma component at most 2 samples wide;
//   * jdcolor.c: ycc_rgb_convert's fixed-point tables (SCALEBITS 16), written
//     as B, G, R (JCS_EXT_BGR), and gray_rgb_convert for one component;
//   * jdapimin.c default_decompress_parms: 3 components are YCbCr unless an
//     Adobe marker says transform 0 or the component ids are 'R', 'G', 'B'.
// Everything else (progressive, arithmetic, lossless, hierarchical, 12-bit,
// 2 or 4 components, other sampling) fails with a message naming the field.
// jpeg_header also returns the EXIF orientation as OpenCV's ExifReader reads
// it: the first APP1 segment, 6 bytes in, tag 0x0112 of IFD0.
//
// Encode: BGR in, YCbCr 4:2:0 out, at a quality 1..100:
//   * jcparam.c: the Annex K tables scaled by jpeg_quality_scaling, limited to
//     1..255 (force_baseline), the standard Huffman tables, JFIF 1.01;
//   * jccolor.c rgb_ycc_convert (SCALEBITS 16, the Cb/Cr 0.5-epsilon fudge);
//   * jcsample.c h2v2_downsample (bias 1, 2, 1, 2...) after jcprepct.c's and
//     jcsample.c's edge replication to whole MCUs;
//   * jfdctint.c jpeg_fdct_islow, then jcdctmgr.c's reciprocal quantizer
//     (compute_reciprocal with 16-bit DCTELEM, as in a SIMD build);
//   * jccoefct.c's dummy blocks past the right and bottom edges (zero AC, the
//     DC of the block before) and jchuff.c's encode_one_block, byte stuffing
//     and the final pad with 1 bits; jcmarker.c's marker order.
//
// C ABI for ctypes (data/host_build.py builds it with g++; data/jpeg.py loads
// it with ctypes.CDLL, which releases the GIL for the call). Every function is
// reentrant. On one core of the H100 machine's host a 480x640 4:2:0 frame at
// quality 95 decodes in 5.4-7.2 ms and encodes in 9.8-16.3 ms over five runs
// of chip_smoke.py's [fcos_apps] phase, which prints them.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

// ---------------------------------------------------------------- decoding

struct DHuff {
  bool defined = false;
  uint8_t bits[17];
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  int16_t look[1 << 9];  // (length << 8) | value, or 0 past 9 bits
};

void build_dhuff(DHuff& t) {
  // jdhuff.c jpeg_make_d_derived_tbl
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t.bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) fail("JPEG: bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      t.valoffset[l] = p - (int32_t)huffcode[p];
      p += t.bits[l];
      t.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 1; i <= t.bits[l]; ++i, ++p) {
      int lookbits = (int)(huffcode[p] << (9 - l));
      for (int ctr = 1 << (9 - l); ctr > 0; --ctr) t.look[lookbits++] = (int16_t)((l << 8) | t.vals[p]);
    }
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;       // blocks wide and high (width_in_blocks, height_in_blocks)
  int dw = 0, dh = 0;       // downsampled width and height
  int stride_blocks = 0;    // blocks per row of the coefficient buffer
  int rows_blocks = 0;
  std::vector<int16_t> coef;
  uint16_t quant[64];       // latched at the component's first scan (natural order)
  bool latched = false;
  int dc_pred = 0;
};

// The entropy-coded data of one scan: bytes with 0xFF00 stuffing, up to a marker.
struct BitReader {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t buf = 0;
  int bits = 0;
  bool at_marker = false;     // a marker (or the end) stopped the reader
  bool insufficient = false;  // a bit past the data was consumed

  void fill() {
    while (bits <= 56) {
      if (at_marker || pos >= n) {
        at_marker = true;
        return;
      }
      uint8_t c = d[pos];
      if (c == 0xFF) {
        if (pos + 1 >= n) {
          at_marker = true;
          return;
        }
        uint8_t c2 = d[pos + 1];
        if (c2 == 0x00) {
          pos += 2;
        } else if (c2 == 0xFF) {  // fill byte before a marker: skip one
          ++pos;
          continue;
        } else {
          at_marker = true;
          return;
        }
      } else {
        ++pos;
      }
      buf |= (uint64_t)c << (56 - bits);
      bits += 8;
    }
  }
  // peek n <= 16 bits; zeros past the data
  inline uint32_t peek(int k) {
    if (bits < k) fill();
    return (uint32_t)(buf >> (64 - k));
  }
  inline void skip(int k) {
    if (bits < k) {
      fill();
      if (bits < k) {
        insufficient = true;
        buf = 0;
        bits = 0;
        return;
      }
    }
    buf <<= k;
    bits -= k;
  }
  inline uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  void reset_bits() {
    buf = 0;
    bits = 0;
  }
};

inline int huff_extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

inline int huff_decode(BitReader& br, const DHuff& t) {
  uint32_t look = br.peek(9);
  int16_t e = t.look[look];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  // codes longer than 9 bits (jdhuff.c jpeg_huff_decode)
  uint32_t code16 = br.peek(16);
  int l = 10;
  int32_t code = (int32_t)(code16 >> 6);
  while (l <= 16 && code > t.maxcode[l]) {
    ++l;
    code = (int32_t)(code16 >> (16 - l));
  }
  if (l > 16) {
    br.skip(16);
    return 0;  // bad code: libjpeg fakes a zero
  }
  br.skip(l);
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

struct Frame {
  int width = 0, height = 0, ncomp = 0;
  int max_h = 1, max_v = 1;
  int mcus_x = 0, mcus_y = 0;
  Component comp[3];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  DHuff dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  bool seen_app1 = false;
  bool sof_seen = false;
};

inline uint16_t be16(const uint8_t* p) { return (uint16_t)((p[0] << 8) | p[1]); }

// OpenCV's ExifReader, for the one tag it applies: orientation (0x0112) of IFD0.
int exif_orientation(const uint8_t* p, int64_t n) {
  if (n < 8) return 1;
  bool le;
  if (p[0] == 'I' && p[1] == 'I') le = true;
  else if (p[0] == 'M' && p[1] == 'M') le = false;
  else return 1;
  auto u16 = [&](int64_t o) -> uint32_t {
    return le ? (uint32_t)(p[o] | (p[o + 1] << 8)) : (uint32_t)((p[o] << 8) | p[o + 1]);
  };
  auto u32 = [&](int64_t o) -> uint32_t {
    return le ? (uint32_t)p[o] | ((uint32_t)p[o + 1] << 8) | ((uint32_t)p[o + 2] << 16) |
                    ((uint32_t)p[o + 3] << 24)
              : ((uint32_t)p[o] << 24) | ((uint32_t)p[o + 1] << 16) | ((uint32_t)p[o + 2] << 8) |
                    (uint32_t)p[o + 3];
  };
  int64_t ifd = u32(4);
  if (ifd + 2 > n) return 1;
  uint32_t count = u16(ifd);
  for (uint32_t i = 0; i < count; ++i) {
    int64_t e = ifd + 2 + 12 * (int64_t)i;
    if (e + 12 > n) return 1;
    if (u16(e) == 0x0112) {
      uint32_t v = u16(e + 8);
      return (v >= 1 && v <= 8) ? (int)v : 1;
    }
  }
  return 1;
}

void check_frame(Frame& f) {
  if (f.ncomp == 1) {
    f.comp[0].h = f.comp[0].v = 1;  // one component: its sampling is moot
  } else {
    int h0 = f.comp[0].h, v0 = f.comp[0].v;
    bool ok = ((h0 == 1 && v0 == 1) || (h0 == 2 && v0 == 1) || (h0 == 2 && v0 == 2)) &&
              f.comp[1].h == 1 && f.comp[1].v == 1 && f.comp[2].h == 1 && f.comp[2].v == 1;
    if (!ok) {
      char m[160];
      std::snprintf(m, sizeof m,
                    "JPEG: sampling factors %dx%d,%dx%d,%dx%d (1x1, 2x1 or 2x2 luma and 1x1 "
                    "chroma are read)",
                    h0, v0, f.comp[1].h, f.comp[1].v, f.comp[2].h, f.comp[2].v);
      fail(m);
    }
  }
  f.max_h = f.max_v = 1;
  for (int c = 0; c < f.ncomp; ++c) {
    if (f.comp[c].h > f.max_h) f.max_h = f.comp[c].h;
    if (f.comp[c].v > f.max_v) f.max_v = f.comp[c].v;
  }
  f.mcus_x = (f.width + 8 * f.max_h - 1) / (8 * f.max_h);
  f.mcus_y = (f.height + 8 * f.max_v - 1) / (8 * f.max_v);
  for (int c = 0; c < f.ncomp; ++c) {
    Component& k = f.comp[c];
    k.dw = (int)(((int64_t)f.width * k.h + f.max_h - 1) / f.max_h);
    k.dh = (int)(((int64_t)f.height * k.v + f.max_v - 1) / f.max_v);
    k.bw = (k.dw + 7) / 8;
    k.bh = (k.dh + 7) / 8;
    k.stride_blocks = f.mcus_x * k.h;
    k.rows_blocks = f.mcus_y * k.v;
  }
}

void decode_scan(const uint8_t* d, int64_t n, int64_t& pos, Frame& f, const int* scomp, int ns,
                 const int* td, const int* ta) {
  for (int i = 0; i < ns; ++i) {
    Component& k = f.comp[scomp[i]];
    if (!k.latched) {
      if (!f.qt_defined[k.tq]) fail("JPEG: a component's quantization table is not defined");
      std::memcpy(k.quant, f.qt[k.tq], sizeof k.quant);
      k.latched = true;
    }
    if (!f.dc[td[i]].defined || !f.ac[ta[i]].defined) fail("JPEG: a scan's Huffman table is not defined");
    k.dc_pred = 0;
  }
  BitReader br{d, n, pos};
  int64_t mcu_total;
  int mcus_per_row;
  if (ns == 1) {
    const Component& k = f.comp[scomp[0]];
    mcus_per_row = k.bw;
    mcu_total = (int64_t)k.bw * k.bh;
  } else {
    mcus_per_row = f.mcus_x;
    mcu_total = (int64_t)f.mcus_x * f.mcus_y;
  }
  int restarts_to_go = f.restart_interval;
  for (int64_t m = 0; m < mcu_total; ++m) {
    if (f.restart_interval) {
      if (restarts_to_go == 0) {
        // jdhuff.c process_restart + jdmarker.c read_restart_marker
        br.reset_bits();
        if (!br.at_marker) {
          // skip to the next marker (next_marker discards garbage bytes)
          while (br.pos + 1 < n && !(d[br.pos] == 0xFF && d[br.pos + 1] != 0 && d[br.pos + 1] != 0xFF))
            ++br.pos;
        }
        while (br.pos + 1 < n && d[br.pos] == 0xFF && d[br.pos + 1] == 0xFF) ++br.pos;
        if (br.pos + 1 < n && d[br.pos] == 0xFF && d[br.pos + 1] >= 0xD0 && d[br.pos + 1] <= 0xD7) {
          br.pos += 2;
          br.at_marker = false;
          br.insufficient = false;
        } else {
          br.at_marker = true;  // another marker: an empty segment follows
        }
        for (int i = 0; i < ns; ++i) f.comp[scomp[i]].dc_pred = 0;
        restarts_to_go = f.restart_interval;
      }
    }
    int mx = (int)(m % mcus_per_row), my = (int)(m / mcus_per_row);
    // out of data: the rest of the segment is zero MCUs (jdhuff.c decode_mcu)
    const bool zero_mcu = br.insufficient;
    for (int i = 0; i < ns; ++i) {
      Component& k = f.comp[scomp[i]];
      int bh = ns == 1 ? 1 : k.h, bv = ns == 1 ? 1 : k.v;
      for (int yy = 0; yy < bv; ++yy) {
        for (int xx = 0; xx < bh; ++xx) {
          int bx = mx * bh + xx, by = my * bv + yy;
          int16_t* blk = &k.coef[((int64_t)by * k.stride_blocks + bx) * 64];
          if (zero_mcu) continue;
          const DHuff& dct = f.dc[td[i]];
          const DHuff& act = f.ac[ta[i]];
          int s = huff_decode(br, dct);
          if (s) {
            int r = (int)br.get(s);
            s = huff_extend(r, s);
          }
          k.dc_pred += s;
          blk[0] = (int16_t)k.dc_pred;
          for (int kk = 1; kk < 64; ++kk) {
            int rs = huff_decode(br, act);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              kk += r;
              int v = (int)br.get(s);
              blk[kNaturalOrder[kk]] = (int16_t)huff_extend(v, s);
            } else {
              if (r != 15) break;
              kk += 15;
            }
          }
        }
      }
    }
    if (f.restart_interval) --restarts_to_go;
  }
  pos = br.pos;
}

// Parse markers up to the first SOS (header_only) or through EOI, decoding
// every scan into the components' coefficient buffers.
void parse(const uint8_t* d, int64_t n, Frame& f, bool header_only) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("JPEG: no SOI marker");
  int64_t pos = 2;
  for (;;) {
    // next marker (skipping fill bytes and, like next_marker, garbage)
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) {
      if (f.sof_seen && !header_only) return;  // no EOI: libjpeg warns and stops
      fail("JPEG: data ends before the first scan");
    }
    uint8_t m = d[pos++];
    if (m == 0xD9) {  // EOI
      if (!f.sof_seen) fail("JPEG: EOI before a frame header");
      return;
    }
    if (m >= 0xD0 && m <= 0xD7) continue;  // stray RST
    if (m == 0x01 || m == 0x00) continue;  // TEM, or a stray stuffed byte
    if (pos + 2 > n) fail("JPEG: a marker segment is cut short");
    int64_t len = be16(d + pos);
    if (len < 2 || pos + len > n) fail("JPEG: a marker segment is cut short");
    const uint8_t* s = d + pos + 2;
    int64_t sl = len - 2;
    if (m == 0xC0 || m == 0xC1) {
      if (f.sof_seen) fail("JPEG: two frame headers");
      if (sl < 6) fail("JPEG: SOF too short");
      int prec = s[0];
      if (prec != 8) {
        char msg[96];
        std::snprintf(msg, sizeof msg, "JPEG: sample precision %d (only 8-bit is read)", prec);
        fail(msg);
      }
      f.height = be16(s + 1);
      f.width = be16(s + 3);
      f.ncomp = s[5];
      if (f.height == 0) fail("JPEG: image height 0 (a DNL marker is not read)");
      if (f.width == 0) fail("JPEG: image width 0");
      if (f.ncomp != 1 && f.ncomp != 3) {
        char msg[96];
        std::snprintf(msg, sizeof msg, "JPEG: %d components (1 or 3 are read)", f.ncomp);
        fail(msg);
      }
      if (sl < 6 + 3 * f.ncomp) fail("JPEG: SOF too short");
      for (int c = 0; c < f.ncomp; ++c) {
        f.comp[c].id = s[6 + 3 * c];
        f.comp[c].h = s[7 + 3 * c] >> 4;
        f.comp[c].v = s[7 + 3 * c] & 15;
        f.comp[c].tq = s[8 + 3 * c];
        if (f.comp[c].tq > 3) fail("JPEG: quantization table index above 3");
        if (f.comp[c].h < 1 || f.comp[c].h > 4 || f.comp[c].v < 1 || f.comp[c].v > 4)
          fail("JPEG: bad sampling factor");
      }
      check_frame(f);
      f.sof_seen = true;
    } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
      fail("JPEG: progressive frame (SOF2/6/10/14) is not read (baseline or extended sequential only)");
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      fail("JPEG: lossless frame (SOF3/7/11/15) is not read");
    } else if (m == 0xC5) {
      fail("JPEG: hierarchical frame (SOF5) is not read");
    } else if (m == 0xC9 || m == 0xCD) {
      fail("JPEG: arithmetic-coded frame (SOF9/13) is not read");
    } else if (m == 0xCC) {
      fail("JPEG: arithmetic coding conditioning (DAC) is not read");
    } else if (m == 0xC4) {  // DHT
      int64_t p = 0;
      while (p < sl) {
        if (p + 17 > sl) fail("JPEG: DHT too short");
        int tc = s[p] >> 4, th = s[p] & 15;
        if (tc > 1 || th > 3) fail("JPEG: bad DHT table class or index");
        DHuff& t = tc ? f.ac[th] : f.dc[th];
        int count = 0;
        t.bits[0] = 0;
        for (int i = 1; i <= 16; ++i) {
          t.bits[i] = s[p + i];
          count += t.bits[i];
        }
        if (count > 256 || p + 17 + count > sl) fail("JPEG: bad DHT table length");
        std::memset(t.vals, 0, sizeof t.vals);
        std::memcpy(t.vals, s + p + 17, count);
        build_dhuff(t);
        t.defined = true;
        p += 17 + count;
      }
    } else if (m == 0xDB) {  // DQT
      int64_t p = 0;
      while (p < sl) {
        int pq = s[p] >> 4, tq = s[p] & 15;
        if (tq > 3) fail("JPEG: quantization table index above 3");
        if (pq > 1) fail("JPEG: bad DQT precision");
        int need = pq ? 128 : 64;
        if (p + 1 + need > sl) fail("JPEG: DQT too short");
        for (int i = 0; i < 64; ++i)
          f.qt[tq][kNaturalOrder[i]] = pq ? be16(s + p + 1 + 2 * i) : s[p + 1 + i];
        f.qt_defined[tq] = true;
        p += 1 + need;
      }
    } else if (m == 0xDD) {  // DRI
      if (sl < 2) fail("JPEG: DRI too short");
      f.restart_interval = be16(s);
    } else if (m == 0xE0) {
      if (sl >= 14 && std::memcmp(s, "JFIF\0", 5) == 0) f.saw_jfif = true;
    } else if (m == 0xE1) {
      if (!f.seen_app1) {
        f.seen_app1 = true;
        if (sl > 6) f.orientation = exif_orientation(s + 6, sl - 6);
      }
    } else if (m == 0xEE) {
      if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        f.saw_adobe = true;
        f.adobe_transform = s[11];
      }
    } else if (m == 0xDA) {  // SOS
      if (!f.sof_seen) fail("JPEG: SOS before a frame header");
      if (header_only) return;
      int ns = s[0];
      if (ns < 1 || ns > f.ncomp || sl < 1 + 2 * ns + 3) fail("JPEG: bad SOS");
      int scomp[3], td[3], ta[3];
      for (int i = 0; i < ns; ++i) {
        int cid = s[1 + 2 * i];
        int c = -1;
        for (int j = 0; j < f.ncomp; ++j)
          if (f.comp[j].id == cid) c = j;
        if (c < 0) fail("JPEG: SOS names a component the frame lacks");
        scomp[i] = c;
        td[i] = s[2 + 2 * i] >> 4;
        ta[i] = s[2 + 2 * i] & 15;
        if (td[i] > 3 || ta[i] > 3) fail("JPEG: bad Huffman table index");
      }
      int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
      if (ss != 0 || se != 63 || ahal != 0) fail("JPEG: a scan with Ss/Se/Ah/Al of a progressive file");
      for (int i = 0; i < ns; ++i) {
        Component& k = f.comp[scomp[i]];
        if (k.coef.empty()) k.coef.assign((size_t)k.stride_blocks * k.rows_blocks * 64, 0);
      }
      int64_t p = pos + len;
      decode_scan(d, n, p, f, scomp, ns, td, ta);
      // past what the scan left: stuffed bytes, RSTs and fill, to the next marker
      while (p + 1 < n) {
        if (d[p] == 0xFF) {
          uint8_t c = d[p + 1];
          if (c == 0x00 || (c >= 0xD0 && c <= 0xD7)) {
            p += 2;
            continue;
          }
          if (c != 0xFF) break;
        }
        ++p;
      }
      pos = p;
      continue;
    }
    pos += len;
  }
}

// jidctint.c jpeg_idct_islow
const int kConstBits = 13, kPass1Bits = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t table[5 * 256 + 128];
  const uint8_t* simple;  // clamp for -256..511
  const uint8_t* idct;    // post-IDCT: index (value & 1023)
  RangeLimit() {
    uint8_t* t = table + 256;
    std::memset(table, 0, 256);
    for (int i = 0; i <= 255; ++i) t[i] = (uint8_t)i;
    simple = t;
    t += 128;
    for (int i = 128; i < 512; ++i) t[i] = 255;
    std::memset(t + 512, 0, 384);
    std::memcpy(t + 1024 - 128, simple, 128);
    idct = t;
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int64_t out_stride) {
  int ws[64];
  const uint8_t* rl = kRange.idct;
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      int dc = (int)((int64_t)ip[0] * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
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
    const int sh = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * out_stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t v = rl[(int)descale(wp[0], kPass1Bits + 3) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
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
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = rl[(int)descale(tmp10 + tmp3, sh) & 1023];
    op[7] = rl[(int)descale(tmp10 - tmp3, sh) & 1023];
    op[1] = rl[(int)descale(tmp11 + tmp2, sh) & 1023];
    op[6] = rl[(int)descale(tmp11 - tmp2, sh) & 1023];
    op[2] = rl[(int)descale(tmp12 + tmp1, sh) & 1023];
    op[5] = rl[(int)descale(tmp12 - tmp1, sh) & 1023];
    op[3] = rl[(int)descale(tmp13 + tmp0, sh) & 1023];
    op[4] = rl[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i <= 255; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const YccTables kYcc;

// One output row of an upsampled chroma plane (plane: dw x dh, stride ps),
// for output row y, into out[0 .. 2*dw) (or dw when h == 1).
void upsample_row(const uint8_t* plane, int64_t ps, int dw, int dh, int h, int v, int y,
                  uint8_t* out) {
  if (h == 1 && v == 1) {
    std::memcpy(out, plane + (int64_t)y * ps, dw);
    return;
  }
  bool fancy = dw > 2;
  if (v == 1) {  // h2v1
    const uint8_t* in = plane + (int64_t)y * ps;
    if (!fancy) {
      for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in[x];
      return;
    }
    int invalue = in[0];
    out[0] = (uint8_t)invalue;
    out[1] = (uint8_t)((invalue * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      invalue = in[x] * 3;
      out[2 * x] = (uint8_t)((invalue + in[x - 1] + 1) >> 2);
      out[2 * x + 1] = (uint8_t)((invalue + in[x + 1] + 2) >> 2);
    }
    invalue = in[dw - 1];
    out[2 * dw - 2] = (uint8_t)((invalue * 3 + in[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = (uint8_t)invalue;
    return;
  }
  // h2v2
  int r0 = y >> 1;
  if (r0 > dh - 1) r0 = dh - 1;
  const uint8_t* in0 = plane + (int64_t)r0 * ps;
  if (!fancy) {
    for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in0[x];
    return;
  }
  int r1 = (y & 1) ? r0 + 1 : r0 - 1;
  if (r1 < 0) r1 = 0;
  if (r1 > dh - 1) r1 = dh - 1;
  const uint8_t* in1 = plane + (int64_t)r1 * ps;
  int thiscolsum = in0[0] * 3 + in1[0];
  int nextcolsum = in0[1] * 3 + in1[1];
  int lastcolsum;
  out[0] = (uint8_t)((thiscolsum * 4 + 8) >> 4);
  out[1] = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
  lastcolsum = thiscolsum;
  thiscolsum = nextcolsum;
  for (int x = 1; x < dw - 1; ++x) {
    nextcolsum = in0[x + 1] * 3 + in1[x + 1];
    out[2 * x] = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
    out[2 * x + 1] = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
    lastcolsum = thiscolsum;
    thiscolsum = nextcolsum;
  }
  out[2 * dw - 2] = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
  out[2 * dw - 1] = (uint8_t)((thiscolsum * 4 + 7) >> 4);
}

void render(Frame& f, uint8_t* out) {
  // IDCT every block of every component into its sample plane
  std::vector<uint8_t> planes[3];
  int64_t ps[3];
  for (int c = 0; c < f.ncomp; ++c) {
    Component& k = f.comp[c];
    if (k.coef.empty()) k.coef.assign((size_t)k.stride_blocks * k.rows_blocks * 64, 0);
    if (!k.latched) {  // a component no scan carried: libjpeg outputs gray
      if (!f.qt_defined[k.tq]) fail("JPEG: no scan carries a component");
      std::memcpy(k.quant, f.qt[k.tq], sizeof k.quant);
    }
    ps[c] = (int64_t)k.bw * 8;
    planes[c].assign((size_t)ps[c] * k.bh * 8, 0);
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(&k.coef[((int64_t)by * k.stride_blocks + bx) * 64], k.quant,
                   planes[c].data() + (int64_t)by * 8 * ps[c] + bx * 8, ps[c]);
  }
  const int W = f.width, H = f.height;
  if (f.ncomp == 1) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = planes[0].data() + (int64_t)y * ps[0];
      uint8_t* o = out + (int64_t)y * W * 3;
      for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = in[x];
    }
    return;
  }
  // jdapimin.c default_decompress_parms: JFIF means YCbCr; else an Adobe
  // marker's transform 0, or component ids 'R', 'G', 'B', mean RGB
  bool rgb = !f.saw_jfif && (f.saw_adobe ? f.adobe_transform == 0
                                         : f.comp[0].id == 'R' && f.comp[1].id == 'G' &&
                                               f.comp[2].id == 'B');
  std::vector<uint8_t> rows(3 * ((size_t)W + 32));
  uint8_t* up[3] = {rows.data(), rows.data() + W + 32, rows.data() + 2 * (W + 32)};
  const uint8_t* rl = kRange.simple;
  for (int y = 0; y < H; ++y) {
    for (int c = 0; c < 3; ++c) {
      const Component& k = f.comp[c];
      // each component's upsampling factor against the largest
      int hf = f.max_h / k.h, vf = f.max_v / k.v;
      upsample_row(planes[c].data(), ps[c], k.dw, k.dh, hf, vf, y, up[c]);
    }
    uint8_t* o = out + (int64_t)y * W * 3;
    const uint8_t *Y = up[0], *Cb = up[1], *Cr = up[2];
    if (rgb) {
      for (int x = 0; x < W; ++x) {
        o[3 * x] = Cr[x];
        o[3 * x + 1] = Cb[x];
        o[3 * x + 2] = Y[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {
      int yy = Y[x], cb = Cb[x], cr = Cr[x];
      o[3 * x + 2] = rl[yy + kYcc.cr_r[cr]];
      o[3 * x + 1] = rl[yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)];
      o[3 * x] = rl[yy + kYcc.cb_b[cb]];
    }
  }
}

// ---------------------------------------------------------------- encoding

const uint8_t kStdLuma[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                              14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                              18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                                24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EHuff {
  uint32_t code[256];
  uint8_t size[256];
};

EHuff make_ehuff(const uint8_t* bits, const uint8_t* vals) {
  // jchuff.c jpeg_make_c_derived_tbl
  EHuff e;
  std::memset(e.size, 0, sizeof e.size);
  std::memset(e.code, 0, sizeof e.code);
  int p = 0;
  uint32_t code = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      e.code[vals[p]] = code++;
      e.size[vals[p]] = (uint8_t)l;
    }
    code <<= 1;
  }
  return e;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int bits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    bits += size;
    while (bits >= 8) {
      uint8_t c = (uint8_t)(buf >> (bits - 8));
      out.push_back(c);
      if (c == 0xFF) out.push_back(0);
      bits -= 8;
    }
  }
  void flush() {  // jchuff.c flush_bits: pad with 1 bits to a byte
    put(0x7F, 7);
    buf = 0;
    bits = 0;
  }
};

inline int nbits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const EHuff& dc, const EHuff& ac) {
  // jchuff.c encode_one_block
  int temp = blk[0] - last_dc, temp2 = temp;
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = nbits_of(temp);
  if (nbits > 11) fail("JPEG: DC coefficient out of range");
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put((uint32_t)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNaturalOrder[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = nbits_of(temp);
    if (nbits > 10) fail("JPEG: AC coefficient out of range");
    int i = (r << 4) + nbits;
    bw.put(ac.code[i], ac.size[i]);
    bw.put((uint32_t)temp2, nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
  last_dc = blk[0];
}

// jcdctmgr.c compute_reciprocal with 16-bit DCTELEM
struct Divisor {
  uint16_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  Divisor d;
  if (divisor == 1) {
    d.recip = 1;
    d.corr = 0;
    d.shift = -16;
    return d;
  }
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
  uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  d.recip = (uint16_t)fq;
  d.corr = (uint16_t)c;
  d.shift = r - 16;
  return d;
}

void fdct_islow(int* data) {
  // jfdctint.c jpeg_fdct_islow
  int* p = data;
  for (int r = 0; r < 8; ++r, p += 8) {
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int)((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = (int)((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = (int)descale(z1 + tmp13 * FIX_0_765366865, kConstBits - kPass1Bits);
    p[6] = (int)descale(z1 + tmp12 * (-FIX_1_847759065), kConstBits - kPass1Bits);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int)descale(tmp4 + z1 + z3, kConstBits - kPass1Bits);
    p[5] = (int)descale(tmp5 + z2 + z4, kConstBits - kPass1Bits);
    p[3] = (int)descale(tmp6 + z2 + z3, kConstBits - kPass1Bits);
    p[1] = (int)descale(tmp7 + z1 + z4, kConstBits - kPass1Bits);
  }
  p = data;
  for (int c = 0; c < 8; ++c, ++p) {
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int)descale(tmp10 + tmp11, kPass1Bits);
    p[32] = (int)descale(tmp10 - tmp11, kPass1Bits);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = (int)descale(z1 + tmp13 * FIX_0_765366865, kConstBits + kPass1Bits);
    p[48] = (int)descale(z1 + tmp12 * (-FIX_1_847759065), kConstBits + kPass1Bits);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int)descale(tmp4 + z1 + z3, kConstBits + kPass1Bits);
    p[40] = (int)descale(tmp5 + z2 + z4, kConstBits + kPass1Bits);
    p[24] = (int)descale(tmp6 + z2 + z3, kConstBits + kPass1Bits);
    p[8] = (int)descale(tmp7 + z1 + z4, kConstBits + kPass1Bits);
  }
}

// FDCT + quantize one 8x8 block of plane (stride ps) at (x0, y0)
void forward_block(const uint8_t* plane, int64_t ps, int64_t x0, int64_t y0, const Divisor* div,
                   int16_t* out) {
  int ws[64];
  for (int r = 0; r < 8; ++r) {
    const uint8_t* row = plane + (y0 + r) * ps + x0;
    for (int c = 0; c < 8; ++c) ws[8 * r + c] = (int)row[c] - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int temp = ws[i];
    const Divisor& d = div[i];
    bool neg = temp < 0;
    if (neg) temp = -temp;
    uint32_t product = (uint32_t)(temp + d.corr) * d.recip;
    product >>= d.shift + 16;
    temp = (int)(int16_t)product;
    out[i] = (int16_t)(neg ? -temp : temp);
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void emit_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits, const uint8_t* vals) {
  int count = 0;
  for (int i = 1; i <= 16; ++i) count += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, count + 2 + 1 + 16);
  o.push_back((uint8_t)index);
  for (int i = 1; i <= 16; ++i) o.push_back(bits[i]);
  for (int i = 0; i < count; ++i) o.push_back(vals[i]);
}

void encode(const uint8_t* img, int H, int W, int quality, std::vector<uint8_t>& o) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535) fail("JPEG: image size out of range (1..65535)");
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;  // jpeg_quality_scaling
  uint16_t qt[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) {
      long temp = ((long)(t ? kStdChroma : kStdLuma)[i] * scale + 50L) / 100L;
      if (temp <= 0L) temp = 1L;
      if (temp > 255L) temp = 255L;  // force_baseline
      qt[t][i] = (uint16_t)temp;
    }
  const int ncomp = 3;
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal((uint16_t)(qt[t][i] << 3));

  // markers: SOI, JFIF, DQT per table, SOF0, DHT DC0 AC0 [DC1 AC1], SOS
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), head, head + sizeof head);
  for (int t = 0; t < 2; ++t) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back((uint8_t)t);
    for (int i = 0; i < 64; ++i) o.push_back((uint8_t)qt[t][kNaturalOrder[i]]);
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * ncomp);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(c == 0 ? 0x22 : 0x11);
    o.push_back(c == 0 ? 0 : 1);
  }
  emit_dht(o, 0x00, kDcLumaBits, kDcVals);
  emit_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
  emit_dht(o, 0x01, kDcChromaBits, kDcVals);
  emit_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * ncomp);
  o.push_back((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(c == 0 ? 0x00 : 0x11);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  const EHuff dc0 = make_ehuff(kDcLumaBits, kDcVals), ac0 = make_ehuff(kAcLumaBits, kAcLumaVals);
  const EHuff dc1 = make_ehuff(kDcChromaBits, kDcVals), ac1 = make_ehuff(kAcChromaBits, kAcChromaVals);
  BitWriter bw(o);
  int16_t blk[64];

  // 3 components, 4:2:0: full-resolution Y, Cb, Cr padded by replication to
  // whole 16x16 MCUs (jcprepct.c/jcsample.c), the chroma then downsampled
  int mx = (W + 15) / 16, my = (H + 15) / 16;
  int64_t pw = (int64_t)mx * 16, ph = (int64_t)my * 16;
  std::vector<uint8_t> full[3];
  for (int c = 0; c < 3; ++c) full[c].resize((size_t)(pw * ph));
  // jccolor.c rgb_ycc_start
  static thread_local int64_t tab[8 * 256];
  static thread_local bool tab_ready = false;
  if (!tab_ready) {
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    const int64_t one_half = (int64_t)1 << 15, cbcr_offset = (int64_t)128 << 16;
    for (int i = 0; i < 256; ++i) {
      tab[i + 0 * 256] = fix(0.29900) * i;
      tab[i + 1 * 256] = fix(0.58700) * i;
      tab[i + 2 * 256] = fix(0.11400) * i + one_half;
      tab[i + 3 * 256] = -fix(0.16874) * i;
      tab[i + 4 * 256] = -fix(0.33126) * i;
      tab[i + 5 * 256] = fix(0.50000) * i + cbcr_offset + one_half - 1;  // B=>Cb, R=>Cr
      tab[i + 6 * 256] = -fix(0.41869) * i;
      tab[i + 7 * 256] = -fix(0.08131) * i;
    }
    tab_ready = true;
  }
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* src = img + y * (int64_t)W * 3;
    uint8_t* py = full[0].data() + y * pw;
    uint8_t* pb = full[1].data() + y * pw;
    uint8_t* pr = full[2].data() + y * pw;
    for (int x = 0; x < W; ++x) {
      int b = src[3 * x], g = src[3 * x + 1], r = src[3 * x + 2];
      py[x] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
      pb[x] = (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
      pr[x] = (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
    }
    for (int c = 0; c < 3; ++c) {
      uint8_t* row = full[c].data() + y * pw;
      std::memset(row + W, row[W - 1], pw - W);
    }
  }
  for (int c = 0; c < 3; ++c)
    for (int64_t y = H; y < ph; ++y)
      std::memcpy(full[c].data() + y * pw, full[c].data() + (H - 1) * pw, pw);
  // the chroma rows of the image (its height made even by replication), then
  // the last of them repeated to the MCU row's end (jcprepct.c pads the
  // downsampled rows, not the full-resolution ones)
  int64_t cw = pw / 2, ch = ph / 2, ch_real = ((int64_t)H + 1) / 2;
  std::vector<uint8_t> sub[2];
  for (int c = 0; c < 2; ++c) {
    sub[c].resize((size_t)(cw * ch));
    const uint8_t* src = full[c + 1].data();
    for (int64_t y = 0; y < ch_real; ++y) {
      const uint8_t* r0 = src + 2 * y * pw;
      const uint8_t* r1 = r0 + pw;
      uint8_t* dst = sub[c].data() + y * cw;
      int bias = 1;  // jcsample.c h2v2_downsample: 1, 2, 1, 2...
      for (int64_t x = 0; x < cw; ++x) {
        dst[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int64_t y = ch_real; y < ch; ++y)
      std::memcpy(sub[c].data() + y * cw, sub[c].data() + (ch_real - 1) * cw, cw);
  }
  int ybw = (W + 7) / 8, ybh = (H + 7) / 8;  // Y's real blocks
  int last[3] = {0, 0, 0};
  int16_t yblk[4][64];
  for (int m_y = 0; m_y < my; ++m_y) {
    for (int m_x = 0; m_x < mx; ++m_x) {
      // jccoefct.c compress_data: real blocks, then dummies at the right
      // (DC of the block to the left) and the bottom (DC of the block before)
      for (int yi = 0; yi < 2; ++yi) {
        int by = m_y * 2 + yi;
        for (int xi = 0; xi < 2; ++xi) {
          int bx = m_x * 2 + xi;
          int16_t* b = yblk[2 * yi + xi];
          if (by < ybh && bx < ybw) {
            forward_block(full[0].data(), pw, (int64_t)bx * 8, (int64_t)by * 8, div[0], b);
          } else {
            std::memset(b, 0, 64 * sizeof(int16_t));
            b[0] = yblk[2 * yi + xi - 1][0];
          }
        }
      }
      for (int i = 0; i < 4; ++i) encode_block(bw, yblk[i], last[0], dc0, ac0);
      for (int c = 0; c < 2; ++c) {
        forward_block(sub[c].data(), cw, (int64_t)m_x * 8, (int64_t)m_y * 8, div[1], blk);
        encode_block(bw, blk, last[c + 1], dc1, ac1);
      }
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
}

void set_err(char* err, int64_t errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// info: width, height, components, EXIF orientation (1..8). Returns 0, or 1
// with a message in err.
int64_t jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int64_t errlen) {
  try {
    Frame f;
    parse(data, n, f, true);
    info[0] = f.width;
    info[1] = f.height;
    info[2] = f.ncomp;
    info[3] = f.orientation;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("JPEG: ") + e.what());
  }
  return 1;
}

// out: height * width * 3 bytes, BGR, in file order (no orientation applied).
int64_t jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err, int64_t errlen) {
  try {
    Frame f;
    parse(data, n, f, false);
    render(f, out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("JPEG: ") + e.what());
  }
  return 1;
}

// img: height * width * 3 bytes in BGR order. Writes at most cap bytes to
// out; returns the file's length (which may be above cap: call again with a
// larger buffer), or -1 with a message in err.
int64_t jpeg_encode(const uint8_t* img, int64_t height, int64_t width, int64_t quality,
                    uint8_t* out, int64_t cap, char* err, int64_t errlen) {
  try {
    std::vector<uint8_t> o;
    o.reserve((size_t)(height * width * 3 / 4 + 1024));
    encode(img, (int)height, (int)width, (int)quality, o);
    if ((int64_t)o.size() <= cap) std::memcpy(out, o.data(), o.size());
    return (int64_t)o.size();
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, std::string("JPEG: ") + e.what());
  }
  return -1;
}

}  // extern "C"
