// imageio: the host decode path of the port's input pipeline, with no
// image library. Built with g++ at first use (data/fastio.py) and called
// through ctypes; it needs the C++ standard library alone.
//
// - an 8-bit JPEG decoder that gives what libjpeg-turbo's default decode
//   gives: sequential and progressive scans (spectral selection and
//   successive approximation, EOB runs), Huffman-coded (jdhuff.c,
//   jdphuff.c) or arithmetic-coded with DAC conditioning (jdarith.c,
//   ITU T.81 Annex D, F and G), restart markers, all into a whole-image
//   coefficient buffer; then, for a progressive file whose first
//   coefficients are not all exact (one cut short), libjpeg-turbo 2.1's
//   inter-block smoothing (jdcoefct.c), the JDCT_ISLOW integer IDCT
//   (jidctint.c), "fancy" h2v1, h1v2 and h2v2 chroma upsampling
//   (jdsample.c), jdcolor.c's fixed-point YCbCr -> RGB and YCCK -> CMYK,
//   and a truncated stream decoded as libjpeg decodes one from a memory
//   source ("Premature end of JPEG file": the missing bits are zeros, the
//   missing blocks gray, the missing EOI made up and the file flagged);
// - the JAX package's native resize (native/fastio.cpp): the float
//   triangle filter with the [-1, 1] normalisation, and its float nearest;
// - Pillow's resampling (Resample.c, Geometry.c): BILINEAR in 22-bit fixed
//   point with a rounding and a clip after each pass, and NEAREST;
// - PNG row unfiltering (None, Sub, Up, Average, Paeth);
// - Pillow's polygon fill (Draw.c) on a one-byte-a-pixel image.
//
// Every entry point returns 0 on success; a non-zero code comes with a
// message in `err`.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

// ---------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------

// zigzag -> natural order, with 16 extra entries so that a corrupt run
// past coefficient 63 lands on 63 (jutils.c's jpeg_natural_order)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ITU T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the
// fixed probability 0.5 bin
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

struct Huff {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t val[256];
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;        // blocks allocated (the MCU grid's)
  int wib = 0, hib = 0;      // width/height_in_blocks (libjpeg's)
  int dw = 0, dh = 0;        // downsampled width/height
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int last_dc = 0;
  int dc_context = 0;  // arithmetic DC conditioning (F.1.4.4.1.2)
  // progressive: the Al to which the first 10 coefficients (zigzag) are
  // known, -1 before any scan (jdinput's coef_bits), and as they stood
  // before this component's last scan
  int coef_bits[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
  int prev_bits[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
};

// libjpeg's bit reader over a memory source: past the end of the data
// the source yields a fake EOI marker (FF D9) again and again
struct Bits {
  const uint8_t* data;
  long len;
  long pos = 0;
  int fake = 0;
  bool past_end = false;  // a byte past the data was asked for
  uint64_t buf = 0;
  int left = 0;
  int unread_marker = 0;
  bool insufficient = false;

  int byte() {
    if (pos < len) return data[pos++];
    past_end = true;
    int b = fake ? 0xD9 : 0xFF;
    fake ^= 1;
    return b;
  }
  // jdhuff.c's jpeg_fill_bit_buffer with MIN_GET_BITS = 57
  void fill(int nbits) {
    if (unread_marker == 0) {
      while (left < 57) {
        int c = byte();
        if (c == 0xFF) {
          do {
            c = byte();
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            goto no_more;
          }
        }
        buf = (buf << 8) | static_cast<uint64_t>(c);
        left += 8;
      }
      return;
    }
  no_more:
    if (nbits > left) {
      insufficient = true;
      buf <<= 57 - left;  // zero bits
      left = 57;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    if (left < n) fill(n);
    left -= n;
    return static_cast<int>((buf >> left) & ((1ULL << n) - 1));
  }
  // jdhuff.c's jpeg_huff_decode, one bit at a time (the lookahead table
  // consumes the same bits)
  int decode(const Huff& h) {
    int l = 1;
    int32_t code = get(1);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero is the safest
    return h.val[(code + h.valoffset[l]) & 0xFF];
  }
};

inline int huff_extend(int x, int s) {
  return x < (1 << (s - 1)) ? x + (-(1 << s) + 1) : x;
}

struct Jpeg {
  const uint8_t* data;
  long len;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  std::vector<Comp> comp;
  bool frame = false;
  bool progressive = false, arith = false;
  int scans = 0;            // scans started
  long last_good = -1;      // last iMCU row a scan completed with its data
  bool truncated = false;  // a scan asked for a byte past the data
  int mcux = 0, mcuy = 0;
  // arithmetic coding, 16 tables of each kind: DAC conditioning (L, U of
  // the DC tables, K of the AC ones) and the statistics bins
  uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];

  Jpeg(const uint8_t* d, long n) : data(d), len(n) {
    std::memset(arith_dc_L, 0, 16);
    std::memset(arith_dc_U, 1, 16);
    std::memset(arith_ac_K, 5, 16);
  }

  // the marker reader: `pos` is the offset of the next byte
  long pos = 0;
  int rd() {
    if (pos >= len) fail("premature end of the JPEG header");
    return data[pos++];
  }
  int rd16() {
    int a = rd();
    return (a << 8) | rd();
  }
  // a byte of the scan header, which libjpeg's memory source reads past
  // the end of the data as its fake EOI marker (FF D9 ...)
  int past = 0;
  int rd_scan() {
    if (pos < len) return data[pos++];
    pos++;
    return (past++ & 1) ? 0xD9 : 0xFF;
  }

  // jdmarker.c next_marker: garbage and stuffed FF 00 pairs skipped; past
  // the end of the data, once a scan was read, the memory source's fake
  // EOI
  int next_marker(bool after_scan = false) {
    for (;;) {
      if (after_scan && pos >= len) return fake_eoi();
      int c = rd();
      while (c != 0xFF) {  // skip garbage
        if (after_scan && pos >= len) return fake_eoi();
        c = rd();
      }
      do {
        if (after_scan && pos >= len) return fake_eoi();
        c = rd();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }
  // the data ended before the EOI marker: libjpeg's memory source makes
  // one up and warns of a premature end, which PIL takes as truncation
  int fake_eoi() {
    truncated = true;
    return 0xD9;
  }

  void read_dqt(int length) {
    long end = pos + length - 2;
    while (pos < end) {
      int pq_tq = rd();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad quantization table index");
      for (int i = 0; i < 64; ++i) {
        int v = pq ? rd16() : rd();
        qt[tq][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qt_defined[tq] = true;
    }
    pos = end;
  }

  void read_dht(int length) {
    long end = pos + length - 2;
    while (pos < end) {
      int tc_th = rd();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (th > 3 || tc > 1) fail("bad Huffman table index");
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = static_cast<uint8_t>(rd());
        count += bits[i];
      }
      if (count > 256 || count > end - pos) fail("bad Huffman table");
      Huff& h = tc ? ac[th] : dc[th];
      std::memset(h.val, 0, sizeof(h.val));
      for (int i = 0; i < count; ++i) h.val[i] = static_cast<uint8_t>(rd());
      // jdhuff.c's jpeg_make_d_derived_tbl
      int huffsize[257], huffcode[257];
      int p = 0;
      for (int l = 1; l <= 16; ++l)
        for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
      huffsize[p] = 0;
      int code = 0, si = huffsize[0];
      p = 0;
      while (huffsize[p]) {
        while (huffsize[p] == si) {
          huffcode[p++] = code;
          code++;
        }
        if (code >= (1 << si)) fail("bad Huffman table");
        code <<= 1;
        si++;
      }
      p = 0;
      for (int l = 1; l <= 16; ++l) {
        if (bits[l]) {
          h.valoffset[l] = p - huffcode[p];
          p += bits[l];
          h.maxcode[l] = huffcode[p - 1];
        } else {
          h.maxcode[l] = -1;
        }
      }
      h.valoffset[17] = 0;
      h.maxcode[17] = 0xFFFFF;
      if (!tc)
        for (int i = 0; i < count; ++i)
          if (h.val[i] > 15) fail("bad Huffman table");
      h.defined = true;
    }
    pos = end;
  }

  void read_sof(int length, int marker) {
    if (frame) fail("two frames in one JPEG");
    // SOF0/1 sequential Huffman, SOF2 progressive Huffman, SOF9/10 the
    // same arithmetic-coded; lossless and hierarchical frames are refused
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2 &&
        marker != 0xC9 && marker != 0xCA)
      fail("unsupported JPEG process (SOF marker 0x" +
           std::to_string(marker) + ")");
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker >= 0xC9;
    int precision = rd();
    if (precision != 8) fail("only 8-bit JPEG is supported");
    height = rd16();
    width = rd16();
    ncomp = rd();
    if (width <= 0 || height <= 0) fail("empty JPEG image");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("unsupported number of JPEG components");
    if (length != 8 + 3 * ncomp) fail("bad SOF length");
    comp.resize(ncomp);
    for (auto& c : comp) {
      c.id = rd();
      int hv = rd();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = rd();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comp) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.wib = static_cast<int>(
          (static_cast<long>(width) * c.h + 8L * hmax - 1) / (8L * hmax));
      c.hib = static_cast<int>(
          (static_cast<long>(height) * c.v + 8L * vmax - 1) / (8L * vmax));
      c.dw = static_cast<int>(
          (static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>(
          (static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    frame = true;
  }

  void read_app(int marker, int length) {
    long end = pos + length - 2;
    if (marker == 0xE0 && length >= 7 && end <= len &&
        std::memcmp(data + pos, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && length >= 14 && end <= len &&
        std::memcmp(data + pos, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = data[pos + 11];
    }
    pos = end;
  }

  // ---- Huffman: sequential (jdhuff.c decode_mcu_slow) ----------------
  void decode_block(Bits& br, Comp& c, int16_t* blk) {
    const Huff& dct = dc[c.td];
    const Huff& act = ac[c.ta];
    int s = br.decode(dct);
    if (s) {
      int r = br.get(s);
      s = huff_extend(r, s);
    }
    s += c.last_dc;
    c.last_dc = s;
    blk[0] = static_cast<int16_t>(s);
    for (int k = 1; k < 64; ++k) {
      s = br.decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = br.get(s);
        s = huff_extend(r, s);
        blk[kNatural[k]] = static_cast<int16_t>(s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // ---- Huffman: progressive (jdphuff.c) ------------------------------
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  int eobrun = 0;

  void dc_first(Bits& br, Comp& c, int16_t* blk) {
    int s = br.decode(dc[c.td]);
    if (s) {
      int r = br.get(s);
      s = huff_extend(r, s);
    }
    s += c.last_dc;
    c.last_dc = s;
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(s) << Al);
  }

  void ac_first(Bits& br, Comp& c, int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huff& act = ac[c.ta];
    for (int k = Ss; k <= Se; ++k) {
      int s = br.decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = br.get(s);
        s = huff_extend(r, s);
        blk[kNatural[k]] =
            static_cast<int16_t>(static_cast<uint32_t>(s) << Al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  void ac_refine(Bits& br, Comp& c, int16_t* blk) {
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    const Huff& act = ac[c.ta];
    auto refine = [&](int16_t* coef) {
      if (br.get(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        int s = br.decode(act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = br.get(1) ? p1 : m1;  // s != 1 is only warned about
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            refine(coef);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) refine(coef);
      }
      eobrun--;
    }
  }

  // ---- arithmetic (jdarith.c) ----------------------------------------
  int64_t ac_c = 0, ac_a = 0;  // the C and A registers
  int ac_ct = -16;             // -16: 2 bytes to read; -1: an error
  uint8_t fixed_bin = 113;  // the fixed probability 0.5 bin

  int arith_decode(Bits& br, uint8_t* st) {
    while (ac_a < 0x8000) {
      if (--ac_ct < 0) {
        int data = 0;
        if (!br.unread_marker) {
          data = br.byte();
          if (data == 0xFF) {
            do {
              data = br.byte();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {  // a marker: zeros from here on
              br.unread_marker = data;
              data = 0;
            }
          }
        }
        ac_c = (ac_c << 8) | data;
        if ((ac_ct += 8) < 0)
          if (++ac_ct == 0) ac_a = 0x8000;  // 2 bytes in: A = 0x10000
      }
      ac_a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = ac_a - qe;
    ac_a = temp;
    temp <<= ac_ct;
    if (ac_c >= temp) {
      ac_c -= temp;
      if (ac_a < qe) {
        ac_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        ac_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a < 0x8000) {
      if (ac_a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // a DC difference (F.1.4.4.1, Figures F.19-F.24) added to c.last_dc;
  // false on a magnitude overflow
  bool arith_dc(Bits& br, Comp& c) {
    uint8_t* stats = dc_stats[c.td];
    uint8_t* st = stats + c.dc_context;
    if (arith_decode(br, st) == 0) {
      c.dc_context = 0;
      return true;
    }
    const int sign = arith_decode(br, st + 1);
    st += 2 + sign;
    int m = arith_decode(br, st);
    if (m != 0) {
      st = stats + 20;
      while (arith_decode(br, st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < ((1 << arith_dc_L[c.td]) >> 1))
      c.dc_context = 0;
    else if (m > ((1 << arith_dc_U[c.td]) >> 1))
      c.dc_context = 12 + sign * 4;
    else
      c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(br, st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c.last_dc = (c.last_dc + v) & 0xFFFF;
    return true;
  }

  // AC coefficients k0..k1 (F.1.4.4.2, Figure F.20), scaled by 2^al;
  // false on a spectral or magnitude overflow
  bool arith_ac(Bits& br, Comp& c, int16_t* blk, int k0, int k1, int al) {
    uint8_t* stats = ac_stats[c.ta];
    for (int k = k0; k <= k1; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (arith_decode(br, st)) break;  // EOB
      while (arith_decode(br, st + 1) == 0) {
        st += 3;
        if (++k > k1) return false;
      }
      const int sign = arith_decode(br, &fixed_bin);
      st += 2;
      int m = arith_decode(br, st);
      if (m != 0 && arith_decode(br, st)) {
        m <<= 1;
        st = stats + (k <= arith_ac_K[c.ta] ? 189 : 217);
        while (arith_decode(br, st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(br, st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
    return true;
  }

  bool arith_ac_refine(Bits& br, Comp& c, int16_t* blk) {
    uint8_t* stats = ac_stats[c.ta];
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    int kex = Se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && arith_decode(br, st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {  // previously nonzero
          if (arith_decode(br, st + 2))
            *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(br, st + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(arith_decode(br, &fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) return false;
      }
    }
    return true;
  }

  // one block of the scan, by process and pass
  void decode_any(Bits& br, Comp& c, int16_t* blk) {
    if (!arith) {
      if (!progressive) decode_block(br, c, blk);
      else if (Ss == 0 && Ah == 0) dc_first(br, c, blk);
      else if (Ss == 0) {
        if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << Al));
      } else if (Ah == 0) ac_first(br, c, blk);
      else ac_refine(br, c, blk);
      return;
    }
    if (ac_ct == -1) return;  // an earlier error: nothing more this scan
    bool ok = true;
    if (!progressive) {
      ok = arith_dc(br, c);
      if (ok) {
        blk[0] = static_cast<int16_t>(c.last_dc);
        ok = arith_ac(br, c, blk, 1, 63, 0);
      }
    } else if (Ss == 0 && Ah == 0) {
      ok = arith_dc(br, c);
      if (ok)
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.last_dc) << Al);
    } else if (Ss == 0) {
      if (arith_decode(br, &fixed_bin))
        blk[0] = static_cast<int16_t>(blk[0] | (1 << Al));
    } else if (Ah == 0) {
      ok = arith_ac(br, c, blk, Ss, Se, Al);
    } else {
      ok = arith_ac_refine(br, c, blk);
    }
    if (!ok) ac_ct = -1;
  }

  // jdmarker.c read_restart_marker with jpeg_resync_to_restart
  void read_restart_marker(Bits& br, int& next_rst) {
    if (br.unread_marker == 0) {
      // next_marker: skip to an FF, then past fill FFs
      int c;
      for (;;) {
        c = br.byte();
        while (c != 0xFF) c = br.byte();
        do {
          c = br.byte();
        } while (c == 0xFF);
        if (c != 0) break;  // FF 00 is stuffed data: keep scanning
      }
      br.unread_marker = c;
    }
    if (br.unread_marker == 0xD0 + next_rst) {
      br.unread_marker = 0;
    } else {
      for (;;) {
        int marker = br.unread_marker;
        int action;
        if (marker < 0xC0) {
          action = 2;
        } else if (marker < 0xD0 || marker > 0xD7) {
          action = 3;
        } else if (marker == 0xD0 + ((next_rst + 1) & 7) ||
                   marker == 0xD0 + ((next_rst + 2) & 7)) {
          action = 3;
        } else if (marker == 0xD0 + ((next_rst - 1) & 7) ||
                   marker == 0xD0 + ((next_rst - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          br.unread_marker = 0;
          break;
        }
        if (action == 3) break;
        int c;
        for (;;) {
          c = br.byte();
          while (c != 0xFF) c = br.byte();
          do {
            c = br.byte();
          } while (c == 0xFF);
          if (c != 0) break;
        }
        br.unread_marker = c;
      }
    }
    next_rst = (next_rst + 1) & 7;
  }

  // the statistics a scan (or a restart interval) starts from
  void reset_arith(Comp** sc, int ns) {
    for (int i = 0; i < ns; ++i) {
      if (!progressive || (Ss == 0 && Ah == 0)) {
        std::memset(dc_stats[sc[i]->td], 0, 64);
        sc[i]->last_dc = 0;
        sc[i]->dc_context = 0;
      }
      if (!progressive || Ss) std::memset(ac_stats[sc[i]->ta], 0, 256);
    }
    ac_c = 0;
    ac_a = 0;
    ac_ct = -16;
  }

  // jdhuff.c / jdphuff.c / jdarith.c process_restart
  void process_restart(Bits& br, Comp** sc, int ns, int& next_rst) {
    if (!arith) br.left = 0;
    read_restart_marker(br, next_rst);
    if (arith) {
      reset_arith(sc, ns);
      return;
    }
    for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
    eobrun = 0;
    if (br.unread_marker == 0) br.insufficient = false;
  }

  void read_scan(int length) {
    if (!frame) fail("JPEG scan before its frame");
    int ns = rd_scan();
    if (ns < 1 || ns > 4 || length != 6 + 2 * ns) fail("bad SOS");
    Comp* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = rd_scan();
      int t = rd_scan();
      sc[i] = nullptr;
      for (auto& c : comp)
        if (c.id == id) sc[i] = &c;
      if (!sc[i]) fail("SOS names an unknown component");
      sc[i]->td = t >> 4;
      sc[i]->ta = t & 15;
      if (sc[i]->td > (arith ? 15 : 3) || sc[i]->ta > (arith ? 15 : 3))
        fail("bad entropy table index");
      if (!qt_defined[sc[i]->tq]) fail("a quantization table is missing");
    }
    Ss = rd_scan();
    Se = rd_scan();
    const int ahal = rd_scan();
    Ah = ahal >> 4;
    Al = ahal & 15;
    if (progressive) {  // jdphuff.c / jdarith.c start_pass
      bool bad = false;
      if (Ss == 0) {
        bad = Se != 0;
      } else {
        bad = Ss > Se || Se > 63 || ns != 1;
      }
      if (Ah != 0 && Al != Ah - 1) bad = true;
      if (Al > 13) bad = true;
      if (bad) fail("bad progressive JPEG scan parameters");
      for (int i = 0; i < ns; ++i) {
        for (int k = std::min(Ss, 1); k <= std::max(Se, 9); ++k)
          if (k < 10) sc[i]->prev_bits[k] = scans > 0 ? sc[i]->coef_bits[k] : 0;
        for (int k = Ss; k <= Se && k < 10; ++k) sc[i]->coef_bits[k] = Al;
      }
    }
    scans++;
    // the Huffman tables the scan reads (a DC refinement reads none)
    if (!arith) {
      for (int i = 0; i < ns; ++i) {
        const bool need_dc = !progressive || (Ss == 0 && Ah == 0);
        const bool need_ac = !progressive || Ss != 0;
        if ((need_dc && !dc[sc[i]->td].defined) ||
            (need_ac && !ac[sc[i]->ta].defined))
          fail("a Huffman table the scan uses is not defined");
      }
    }
    // a sequential scan's Ss, Se, Ah/Al are only warned about
    for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
    eobrun = 0;
    if (arith) reset_arith(sc, ns);

    Bits br{data, len};
    br.pos = pos;
    br.fake = past & 1;
    br.past_end = pos > len;
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    long scan_good = -1;
    long nmcu;
    int mx, my;
    if (ns == 1) {
      mx = sc[0]->wib;
      my = sc[0]->hib;
    } else {
      mx = mcux;
      my = mcuy;
    }
    nmcu = static_cast<long>(mx) * my;
    // a DC refinement (Huffman) reads zeros, which change nothing, where
    // the data ran out, so it needs no check of its own
    for (long m = 0; m < nmcu; ++m) {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          process_restart(br, sc, ns, next_rst);
          restarts_to_go = restart_interval;
        }
      }
      if (!br.insufficient)  // this MCU's iMCU row is decoded from data
        scan_good = ns == 1 ? m / mx / sc[0]->v : m / mx;
      if (arith || !br.insufficient) {
        int mrow = static_cast<int>(m / mx), mcol = static_cast<int>(m % mx);
        if (ns == 1) {
          Comp& c = *sc[0];
          decode_any(br, c, &c.coef[(static_cast<size_t>(mrow) * c.bw +
                                     mcol) * 64]);
        } else {
          for (int i = 0; i < ns; ++i) {
            Comp& c = *sc[i];
            for (int yy = 0; yy < c.v; ++yy)
              for (int xx = 0; xx < c.h; ++xx) {
                size_t b = static_cast<size_t>(mrow * c.v + yy) * c.bw +
                           mcol * c.h + xx;
                decode_any(br, c, &c.coef[b * 64]);
              }
          }
        }
      }
      if (restart_interval) restarts_to_go--;
    }
    if (!br.insufficient)
      scan_good = ns == 1 ? (static_cast<long>(my) - 1) / sc[0]->v : my - 1L;
    last_good = scan_good;
    if (br.past_end) truncated = true;
    // resume the marker reader at the first byte the bit reader did not
    // take as data; a marker it stopped at is re-read from the stream
    pos = std::min(br.pos, len);
    if (br.unread_marker && br.pos <= len) {
      pos = br.pos - 2;
      while (pos > 0 && data[pos] != 0xFF) --pos;
    }
  }

  // a DHT segment cut short after a scan: libjpeg fills the rest with the
  // fake EOI's bytes, which break a table's index or counts (an error)
  // but only garble its values; the segment's last table's values are
  // the one place a cut leaves every table defined
  bool dht_cut_in_last_values(int length) const {
    const long end = pos + length - 2;
    for (long p = pos; p < end;) {
      if (p + 17 > len) return false;
      int count = 0;
      for (int i = 1; i <= 16; ++i) count += data[p + i];
      if (count > 256) return false;
      if (p + 17 + count > len) return p + 17 + count >= end;
      p += 17 + count;
    }
    return false;
  }

  // jdmarker.c get_dac
  void read_dac(int length) {
    long end = pos + length - 2;
    while (pos + 1 < end) {
      int index = rd(), val = rd();
      if (index >= 32) fail("bad DAC table index");
      if (index >= 16) {
        arith_ac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        arith_dc_L[index] = static_cast<uint8_t>(val & 15);
        arith_dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) fail("bad DAC value");
      }
    }
    pos = end;
  }

  void parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file");
    pos = 2;
    bool scanned = false;
    for (;;) {
      if (pos >= len) {
        if (scanned) {
          fake_eoi();
          return;
        }
        fail("premature end of the JPEG header");
      }
      int m = next_marker(scanned);
      if (m == 0xD9) return;
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (m == 0x01) continue;
      // after a scan, a segment cut short: libjpeg reads the source's
      // fake EOI bytes into it, which breaks a table, a frame or a
      // restart interval's length (an error) and is skipped in any other
      // segment
      const bool table = m == 0xC4 || m == 0xDB || m == 0xCC ||
                         (m >= 0xC0 && m <= 0xCF);
      if (scanned && pos + 2 > len && m != 0xDA) {
        if (table || m == 0xDD) fail("premature end of the JPEG header");
        fake_eoi();
        return;
      }
      int length = rd16();
      if (length < 2) fail("bad JPEG marker length");
      if (pos + length - 2 > len && m != 0xDA) {
        if (scanned && (!table || dht_cut_in_last_values(length))) {
          fake_eoi();
          return;
        }
        fail("premature end of the JPEG header");
      }
      if (m == 0xDB) {
        read_dqt(length);
      } else if (m == 0xC4) {
        read_dht(length);
      } else if (m == 0xCC) {
        read_dac(length);
      } else if (m >= 0xC0 && m <= 0xCF) {
        read_sof(length, m);
      } else if (m == 0xDD) {
        restart_interval = rd16();
      } else if (m == 0xDA) {
        read_scan(length);
        scanned = true;
        if (truncated) return;
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m, length);
      } else {
        pos += length - 2;
      }
    }
  }

  // the colour space libjpeg assigns (jdapimin.c default_decompress_parms):
  // 0 gray, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK
  int color_space() const {
    if (ncomp == 1) return 0;
    if (ncomp == 3) {
      if (jfif) return 1;
      if (adobe) return adobe_transform == 0 ? 2 : 1;
      if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return 1;
      if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66)
        return 2;
      return 1;
    }
    if (adobe) return adobe_transform == 0 ? 3 : 4;
    return 3;
  }
};

// libjpeg-turbo's JDCT_ISLOW as its x86 SIMD code computes it
// (jidctint-sse2.asm, jidctint-avx2.asm): jidctint.c's algorithm with the
// dequantised coefficients and the workspace in 16-bit lanes (products
// wrap to 16 bits, the sums z0 +- z4 and the odd part's pair sums too),
// the rotations as pairs of 16 x 16 -> 32-bit multiply-adds, each pass
// descaled and packed to 16 bits with saturation, and the result packed to
// 8 bits with saturation around 128. On any block a valid file carries
// this equals jidctint.c; on the wild blocks a stream that ends early
// decodes into, it is what the SIMD decode gives.
inline int16_t wrap16(int32_t v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v));
}
inline int16_t sat16(int32_t v) {
  return static_cast<int16_t>(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
// pmaddwd: a * ca + b * cb in 32 bits
inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) {
  return add32(a * ca, b * cb);
}

// one 1-D pass over 8 values (stride apart) of 16-bit inputs: the eight
// 32-bit results before the descale, in output order 0..7
void idct_1d_simd(const int16_t* v, int32_t* out) {
  const int32_t F029 = 2446, F039 = 3196, F054 = 4433, F076 = 6270,
                F089 = 7373, F117 = 9633, F150 = 12299, F184 = 15137,
                F196 = 16069, F205 = 16819, F256 = 20995, F307 = 25172;
  // even part
  int32_t tmp3 = madd(v[2], F054 + F076, v[6], F054);
  int32_t tmp2 = madd(v[2], F054, v[6], F054 - F184);
  int32_t tmp0 = static_cast<int32_t>(wrap16(v[0] + v[4])) * 8192;
  int32_t tmp1 = static_cast<int32_t>(wrap16(v[0] - v[4])) * 8192;
  int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  // odd part: v[7], v[5], v[3], v[1] are jidctint.c's tmp0..tmp3
  int16_t z3 = wrap16(v[7] + v[3]), z4 = wrap16(v[5] + v[1]);
  int32_t z3r = madd(z3, F117 - F196, z4, F117);
  int32_t z4r = madd(z3, F117, z4, F117 - F039);
  int32_t o0 = add32(madd(v[7], F029 - F089, v[1], -F089), z3r);
  int32_t o3 = add32(madd(v[7], -F089, v[1], F150 - F089), z4r);
  int32_t o1 = add32(madd(v[5], F205 - F256, v[3], -F256), z4r);
  int32_t o2 = add32(madd(v[5], -F256, v[3], F307 - F256), z3r);
  out[0] = add32(tmp10, o3);
  out[7] = sub32(tmp10, o3);
  out[1] = add32(tmp11, o2);
  out[6] = sub32(tmp11, o2);
  out[2] = add32(tmp12, o1);
  out[5] = sub32(tmp12, o1);
  out[3] = add32(tmp13, o0);
  out[4] = sub32(tmp13, o0);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int16_t ws[64];  // [row][col] after pass 1
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; ++i) ac_zero = in[i] == 0;
  if (ac_zero) {
    // "AC terms all zero" over the whole block: the DC row, shifted in
    // 16 bits
    for (int col = 0; col < 8; ++col) {
      int16_t dc = wrap16(static_cast<int32_t>(in[col]) *
                          static_cast<int16_t>(q[col]));
      int16_t v = wrap16(static_cast<int32_t>(dc) * 4);
      for (int r = 0; r < 8; ++r) ws[r * 8 + col] = v;
    }
  } else {
    for (int col = 0; col < 8; ++col) {
      int16_t v[8];
      for (int r = 0; r < 8; ++r)
        v[r] = wrap16(static_cast<int32_t>(in[r * 8 + col]) *
                      static_cast<int16_t>(q[r * 8 + col]));
      int32_t o[8];
      idct_1d_simd(v, o);
      for (int r = 0; r < 8; ++r)
        ws[r * 8 + col] = sat16(add32(o[r], 1 << 10) >> 11);
    }
  }
  for (int row = 0; row < 8; ++row) {
    int32_t o[8];
    idct_1d_simd(ws + row * 8, o);
    uint8_t* op = out + static_cast<size_t>(row) * stride;
    for (int c = 0; c < 8; ++c) {
      int32_t v = sat16(add32(o[c], 1 << 17) >> 18);
      v = v < -128 ? -128 : (v > 127 ? 127 : v);
      op[c] = static_cast<uint8_t>(v + 128);
    }
  }
}

// one component's samples upsampled to the image's full size (jdsample.c):
// out is height x width
void upsample(const Jpeg& j, const Comp& c, const std::vector<uint8_t>& pl,
              int pw, std::vector<uint8_t>* out) {
  const int W = j.width, H = j.height;
  out->assign(static_cast<size_t>(W) * H, 0);
  const int hf = j.hmax / c.h, vf = j.vmax / c.v;
  auto at = [&](int y, int x) -> int {
    return pl[static_cast<size_t>(y) * pw + x];
  };
  auto clampy = [&](int y) { return y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y); };
  if (hf == 1 && vf == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(out->data() + static_cast<size_t>(y) * W,
                  pl.data() + static_cast<size_t>(y) * pw, W);
    return;
  }
  const int dw = c.dw;
  std::vector<uint8_t> row(static_cast<size_t>(2 * dw + 2));
  if (hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; ++y) {
      uint8_t* o = row.data();
      int v = at(y, 0);
      *o++ = static_cast<uint8_t>(v);
      *o++ = static_cast<uint8_t>((v * 3 + at(y, 1) + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        v = at(y, x) * 3;
        *o++ = static_cast<uint8_t>((v + at(y, x - 1) + 1) >> 2);
        *o++ = static_cast<uint8_t>((v + at(y, x + 1) + 2) >> 2);
      }
      v = at(y, dw - 1);
      *o++ = static_cast<uint8_t>((v * 3 + at(y, dw - 2) + 1) >> 2);
      *o++ = static_cast<uint8_t>(v);
      std::memcpy(out->data() + static_cast<size_t>(y) * W, row.data(), W);
    }
    return;
  }
  if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      int r = y >> 1;
      int nb = (y & 1) ? clampy(r + 1) : clampy(r - 1);
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x)
        (*out)[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(
            (at(r, x) * 3 + at(nb, x) + bias) >> 2);
    }
    return;
  }
  if (hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      int r = y >> 1;
      int nb = (y & 1) ? clampy(r + 1) : clampy(r - 1);
      uint8_t* o = row.data();
      int thiscol = at(r, 0) * 3 + at(nb, 0);
      int nextcol = at(r, 1) * 3 + at(nb, 1);
      *o++ = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 2; x < dw; ++x) {
        nextcol = at(r, x) * 3 + at(nb, x);
        *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      *o++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
      std::memcpy(out->data() + static_cast<size_t>(y) * W, row.data(), W);
    }
    return;
  }
  // int_upsample (and h2v1/h2v2 on a component 2 samples wide or less):
  // each sample replicated hf x vf times
  for (int y = 0; y < H; ++y) {
    int r = y / vf;
    for (int x = 0; x < W; ++x)
      (*out)[static_cast<size_t>(y) * W + x] =
          static_cast<uint8_t>(at(r, x / hf));
  }
}

// libjpeg-turbo's inter-block smoothing of a progressive image whose
// low-frequency coefficients are not all known to full precision (a file
// cut short): jdcoefct.c smoothing_ok and decompress_smooth_data. Each
// block's first AC coefficients that are still 0 and not exact are
// estimated from the DC values of the 5 x 5 blocks around it; where no AC
// coefficient is known at all, the DC is smoothed too.
bool smoothing_ok(const Jpeg& j) {
  if (!j.progressive) return false;
  bool useful = false;
  for (const Comp& c : j.comp) {
    const uint16_t* q = j.qt[c.tq];
    for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
      if (q[pos] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// the coefficients the IDCT of component `c` reads after smoothing
std::vector<int16_t> smoothed(const Jpeg& j, const Comp& c) {
  std::vector<int16_t> out = c.coef;
  const uint16_t* q = j.qt[c.tq];
  const long Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9],
             Q02 = q[2], Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
  const int rows = j.mcuy;  // iMCU rows
  auto dc = [&](int r, int col) -> int {
    return c.coef[(static_cast<size_t>(r) * c.bw + col) * 64];
  };
  auto predict = [](long num, long qk, int al, bool limit) {
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
      if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
      if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return pred;
  };
  for (int oy = 0; oy < rows; ++oy) {
    int prev_latch[10];
    for (int k = 0; k < 10; ++k)
      prev_latch[k] = j.scans > 1 ? c.prev_bits[k] : -1;
    const int* bits = oy > j.last_good ? prev_latch : c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k) change_dc = change_dc && bits[k] == -1;
    int block_rows = c.v;
    if (oy == rows - 1) {
      block_rows = c.hib % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    // the rows above and below, as jdcoefct.c picks them: two rows away
    // only where the block row or the iMCU row allows it (with 2 block
    // rows an iMCU row, the second iMCU row's blocks take the row above
    // for the one two above, and the last but one's the row below)
    const int last_row = rows - 1;
    for (int br = 0; br < block_rows; ++br) {
      const int R = oy * c.v + br;
      const int pr = (br > 0 || oy > 0) ? R - 1 : R;
      const int ppr = (br > 1 || oy > 1) ? R - 2 : pr;
      const int nr = (br < block_rows - 1 || oy < last_row) ? R + 1 : R;
      const int nnr = (br < block_rows - 2 || oy + 1 < last_row) ? R + 2 : nr;
      int D[5][5];  // [row -2..2][column -2..2]
      const int rr[5] = {ppr, pr, R, nr, nnr};
      for (int a = 0; a < 5; ++a)
        for (int b = 0; b < 5; ++b) D[a][b] = dc(rr[a], 0);
      const int last = c.wib - 1;
      for (int bx = 0; bx < c.wib; ++bx) {
        if (bx == 0 && bx < last)
          for (int a = 0; a < 5; ++a) D[a][3] = dc(rr[a], 1);
        if (bx + 1 < last)
          for (int a = 0; a < 5; ++a) D[a][4] = dc(rr[a], bx + 2);
        int16_t* w = &out[(static_cast<size_t>(R) * c.bw + bx) * 64];
#define DCV(n) D[((n) - 1) / 5][((n) - 1) % 5]
        int al;
        if ((al = bits[1]) != 0 && w[1] == 0) {
          long num = Q00 * (change_dc ?
              (-DCV(1) - DCV(2) + DCV(4) + DCV(5) - 3 * DCV(6) + 13 * DCV(7) -
               13 * DCV(9) + 3 * DCV(10) - 3 * DCV(11) + 38 * DCV(12) -
               38 * DCV(14) + 3 * DCV(15) - 3 * DCV(16) + 13 * DCV(17) -
               13 * DCV(19) + 3 * DCV(20) - DCV(21) - DCV(22) + DCV(24) +
               DCV(25)) :
              (-7 * DCV(11) + 50 * DCV(12) - 50 * DCV(14) + 7 * DCV(15)));
          w[1] = static_cast<int16_t>(predict(num, Q01, al, true));
        }
        if ((al = bits[2]) != 0 && w[8] == 0) {
          long num = Q00 * (change_dc ?
              (-DCV(1) - 3 * DCV(2) - 3 * DCV(3) - 3 * DCV(4) - DCV(5) -
               DCV(6) + 13 * DCV(7) + 38 * DCV(8) + 13 * DCV(9) - DCV(10) +
               DCV(16) - 13 * DCV(17) - 38 * DCV(18) - 13 * DCV(19) +
               DCV(20) + DCV(21) + 3 * DCV(22) + 3 * DCV(23) + 3 * DCV(24) +
               DCV(25)) :
              (-7 * DCV(3) + 50 * DCV(8) - 50 * DCV(18) + 7 * DCV(23)));
          w[8] = static_cast<int16_t>(predict(num, Q10, al, true));
        }
        if ((al = bits[3]) != 0 && w[16] == 0) {
          long num = Q00 * (change_dc ?
              (DCV(3) + 2 * DCV(7) + 7 * DCV(8) + 2 * DCV(9) - 5 * DCV(12) -
               14 * DCV(13) - 5 * DCV(14) + 2 * DCV(17) + 7 * DCV(18) +
               2 * DCV(19) + DCV(23)) :
              (-DCV(3) + 13 * DCV(8) - 24 * DCV(13) + 13 * DCV(18) -
               DCV(23)));
          w[16] = static_cast<int16_t>(predict(num, Q20, al, true));
        }
        if ((al = bits[4]) != 0 && w[9] == 0) {
          long num = Q00 * (change_dc ?
              (-DCV(1) + DCV(5) + 9 * DCV(7) - 9 * DCV(9) - 9 * DCV(17) +
               9 * DCV(19) + DCV(21) - DCV(25)) :
              (DCV(10) + DCV(16) - 10 * DCV(17) + 10 * DCV(19) - DCV(2) -
               DCV(20) + DCV(22) - DCV(24) + DCV(4) - DCV(6) + 10 * DCV(7) -
               10 * DCV(9)));
          w[9] = static_cast<int16_t>(predict(num, Q11, al, true));
        }
        if ((al = bits[5]) != 0 && w[2] == 0) {
          long num = Q00 * (change_dc ?
              (2 * DCV(7) - 5 * DCV(8) + 2 * DCV(9) + DCV(11) + 7 * DCV(12) -
               14 * DCV(13) + 7 * DCV(14) + DCV(15) + 2 * DCV(17) -
               5 * DCV(18) + 2 * DCV(19)) :
              (-DCV(11) + 13 * DCV(12) - 24 * DCV(13) + 13 * DCV(14) -
               DCV(15)));
          w[2] = static_cast<int16_t>(predict(num, Q02, al, true));
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && w[3] == 0) {
            long num = Q00 * (DCV(7) - DCV(9) + 2 * DCV(12) - 2 * DCV(14) +
                              DCV(17) - DCV(19));
            w[3] = static_cast<int16_t>(predict(num, Q03, al, true));
          }
          if ((al = bits[7]) != 0 && w[10] == 0) {
            long num = Q00 * (DCV(7) - 3 * DCV(8) + DCV(9) - DCV(17) +
                              3 * DCV(18) - DCV(19));
            w[10] = static_cast<int16_t>(predict(num, Q12, al, true));
          }
          if ((al = bits[8]) != 0 && w[17] == 0) {
            long num = Q00 * (DCV(7) - DCV(9) - 3 * DCV(12) + 3 * DCV(14) +
                              DCV(17) - DCV(19));
            w[17] = static_cast<int16_t>(predict(num, Q21, al, true));
          }
          if ((al = bits[9]) != 0 && w[24] == 0) {
            long num = Q00 * (DCV(7) + 2 * DCV(8) + DCV(9) - DCV(17) -
                              2 * DCV(18) - DCV(19));
            w[24] = static_cast<int16_t>(predict(num, Q30, al, true));
          }
          long num = Q00 *
              (-2 * DCV(1) - 6 * DCV(2) - 8 * DCV(3) - 6 * DCV(4) -
               2 * DCV(5) - 6 * DCV(6) + 6 * DCV(7) + 42 * DCV(8) +
               6 * DCV(9) - 6 * DCV(10) - 8 * DCV(11) + 42 * DCV(12) +
               152 * DCV(13) + 42 * DCV(14) - 8 * DCV(15) - 6 * DCV(16) +
               6 * DCV(17) + 42 * DCV(18) + 6 * DCV(19) - 6 * DCV(20) -
               2 * DCV(21) - 6 * DCV(22) - 8 * DCV(23) - 6 * DCV(24) -
               2 * DCV(25));
          w[0] = static_cast<int16_t>(predict(num, Q00, 0, false));
        }
#undef DCV
        for (int a = 0; a < 5; ++a)
          for (int b = 0; b < 4; ++b) D[a][b] = D[a][b + 1];
      }
    }
  }
  return out;
}

// jdcolor.c's tables
struct ColorTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  ColorTables() {
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = 1 << 15;
    auto fix = [](double x) {
      return static_cast<int32_t>(x * (1L << 16) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + ONE_HALF;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Decode to pixels. `rgb`: libjpeg's out_color_space JCS_RGB (gray is
// replicated; CMYK and YCCK are refused with code 3), else the colour
// space PIL asks for (L, RGB, or CMYK inverted as PIL's "CMYK;I").
// -> 0, or 1 (error), 3 (no RGB output for CMYK/YCCK)
int decode_pixels(bool rgb, Jpeg* jp, std::vector<uint8_t>* px,
                  int* channels, std::string* msg) {
  Jpeg& j = *jp;
  try {
    j.parse();
  } catch (const JpegError& e) {
    *msg = e.msg;
    return 1;
  }
  if (!j.frame) {
    *msg = "JPEG file has no frame";
    return 1;
  }
  const int cs = j.color_space();
  if (rgb && (cs == 3 || cs == 4)) {
    *msg = "a CMYK or YCCK JPEG has no RGB decode";
    return 3;
  }
  const int W = j.width, H = j.height;
  const bool smooth = smoothing_ok(j);
  std::vector<std::vector<uint8_t>> full(j.ncomp);
  for (int ci = 0; ci < j.ncomp; ++ci) {
    const Comp& c = j.comp[ci];
    const int pw = c.bw * 8, ph = c.bh * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
    const uint16_t* q = j.qt[c.tq];
    const std::vector<int16_t> coef = smooth ? smoothed(j, c) : c.coef;
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&coef[(static_cast<size_t>(by) * c.bw + bx) * 64], q,
                   plane.data() + static_cast<size_t>(by) * 8 * pw + bx * 8,
                   pw);
    upsample(j, c, plane, pw, &full[ci]);
  }
  const size_t n = static_cast<size_t>(W) * H;
  if (cs == 0) {
    *channels = rgb ? 3 : 1;
    px->resize(n * *channels);
    for (size_t i = 0; i < n; ++i) {
      if (rgb) {
        (*px)[3 * i] = (*px)[3 * i + 1] = (*px)[3 * i + 2] = full[0][i];
      } else {
        (*px)[i] = full[0][i];
      }
    }
    return 0;
  }
  if (cs == 1 || cs == 2) {
    *channels = 3;
    px->resize(n * 3);
    for (size_t i = 0; i < n; ++i) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      if (cs == 2) {
        (*px)[3 * i] = static_cast<uint8_t>(y);
        (*px)[3 * i + 1] = static_cast<uint8_t>(cb);
        (*px)[3 * i + 2] = static_cast<uint8_t>(cr);
      } else {
        (*px)[3 * i] = clamp255(y + kColor.cr_r[cr]);
        (*px)[3 * i + 1] =
            clamp255(y + ((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
        (*px)[3 * i + 2] = clamp255(y + kColor.cb_b[cb]);
      }
    }
    return 0;
  }
  // CMYK (passed through) or YCCK (jdcolor.c ycck_cmyk_convert), then
  // inverted as PIL's "CMYK;I" raw mode
  *channels = 4;
  px->resize(n * 4);
  for (size_t i = 0; i < n; ++i) {
    int c0 = full[0][i], c1 = full[1][i], c2 = full[2][i], k = full[3][i];
    if (cs == 4) {
      int y = c0, cb = c1, cr = c2;
      c0 = clamp255(255 - (y + kColor.cr_r[cr]));
      c1 = clamp255(255 - (y + ((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16)));
      c2 = clamp255(255 - (y + kColor.cb_b[cb]));
    }
    (*px)[4 * i] = static_cast<uint8_t>(255 - c0);
    (*px)[4 * i + 1] = static_cast<uint8_t>(255 - c1);
    (*px)[4 * i + 2] = static_cast<uint8_t>(255 - c2);
    (*px)[4 * i + 3] = static_cast<uint8_t>(255 - k);
  }
  return 0;
}

// ---------------------------------------------------------------------
// Pillow's resampling
// ---------------------------------------------------------------------

const int kPrecisionBits = 32 - 8 - 2;

// Resample.c precompute_coeffs + normalize_coeffs_8bpc for the bilinear
// filter (support 1) -> ksize; bounds and int32 coefficients
int bilinear_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                    std::vector<int32_t>* kk) {
  double scale = static_cast<double>(static_cast<float>(in_size) -
                                     static_cast<float>(0)) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> pre(static_cast<size_t>(out_size) * ksize, 0.0);
  bounds->assign(static_cast<size_t>(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = 0.0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double t = (x + xmin - center + 0.5) * ss;
      if (t < 0.0) t = -t;
      double w = t < 1.0 ? 1.0 - t : 0.0;
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    (*bounds)[xx * 2] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  kk->resize(pre.size());
  for (size_t i = 0; i < pre.size(); ++i) {
    double v = pre[i] * (1 << kPrecisionBits);
    (*kk)[i] = static_cast<int32_t>(pre[i] < 0 ? -0.5 + v : 0.5 + v);
  }
  return ksize;
}

inline uint8_t clip8(int in) {
  int v = in >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// JPEG header: dims[0..3] = height, width, components, libjpeg colour
// space (0 gray, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK)
int imageio_jpeg_info(const uint8_t* buf, long len, int* dims, char* err,
                      int errlen) {
  Jpeg j(buf, len);
  // parse up to the frame header only
  try {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) fail("not a JPEG file");
    j.pos = 2;
    while (!j.frame) {
      int m = j.next_marker();
      if (m == 0xD9 || m == 0xDA) fail("JPEG file has no frame");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      int length = j.rd16();
      if (length < 2 || j.pos + length - 2 > len)
        fail("premature end of the JPEG header");
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        j.read_sof(length, m);
      } else if (m >= 0xE0 && m <= 0xEF) {
        j.read_app(m, length);
      } else {
        j.pos += length - 2;
      }
    }
  } catch (const JpegError& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
  dims[0] = j.height;
  dims[1] = j.width;
  dims[2] = j.ncomp;
  dims[3] = j.color_space();
  return 0;
}

// Decode a JPEG into `out` (h * w * channels bytes, the sizes from
// imageio_jpeg_info) in the colour space PIL asks for: L, RGB, or CMYK
// as PIL's inverted raw mode. status[0] = 1 where the data ended inside
// a scan (the rest decoded as libjpeg does). -> 0, or 1 on an error
int imageio_jpeg_decode(const uint8_t* buf, long len, uint8_t* out,
                        long out_len, int* status, char* err, int errlen) {
  Jpeg j(buf, len);
  std::vector<uint8_t> px;
  int channels = 0;
  std::string msg;
  int rc = decode_pixels(false, &j, &px, &channels, &msg);
  if (rc) {
    set_err(err, errlen, msg);
    return rc;
  }
  if (static_cast<long>(px.size()) != out_len) {
    set_err(err, errlen, "output buffer size mismatch");
    return 1;
  }
  std::memcpy(out, px.data(), px.size());
  status[0] = j.truncated ? 1 : 0;
  return 0;
}

// The JAX package's fastio_decode_jpeg_resize_norm on this decoder: JPEG
// -> RGB -> its float triangle-filter resize -> pixel * scale + shift, as
// float32 [oh, ow, 3]. -> 0, 1, or 3 (CMYK/YCCK, which it cannot decode)
int imageio_jpeg_resize_norm(const uint8_t* buf, long len, float* out,
                             int oh, int ow, float scale, float shift,
                             int* status, char* err, int errlen) {
  Jpeg j(buf, len);
  std::vector<uint8_t> px;
  int channels = 0;
  std::string msg;
  int rc = decode_pixels(true, &j, &px, &channels, &msg);
  if (rc) {
    set_err(err, errlen, msg);
    return rc;
  }
  status[0] = j.truncated ? 1 : 0;
  const int h = j.height, w = j.width;
  if (oh <= 0 || ow <= 0) {
    set_err(err, errlen, "empty output size");
    return 1;
  }
  if (h == oh && w == ow) {
    const long n = static_cast<long>(oh) * ow * 3;
    for (long i = 0; i < n; ++i)
      out[i] = static_cast<float>(px[i]) * scale + shift;
    return 0;
  }
  // native/fastio.cpp's separable triangle filter, operation for operation
  struct Tap {
    int start, n, woff;
  };
  auto build_taps = [](int in_size, int out_size, std::vector<Tap>* taps,
                       std::vector<float>* weights) {
    const float ratio = static_cast<float>(in_size) / out_size;
    const float support = ratio > 1.0f ? ratio : 1.0f;
    const int kmax = static_cast<int>(2.0f * support) + 2;
    taps->resize(out_size);
    weights->assign(static_cast<size_t>(out_size) * kmax, 0.0f);
    for (int o = 0; o < out_size; ++o) {
      const float center = (o + 0.5f) * ratio;
      int lo = static_cast<int>(center - support + 0.5f);
      int hi = static_cast<int>(center + support + 0.5f);
      if (lo < 0) lo = 0;
      if (hi > in_size) hi = in_size;
      float* wrow = weights->data() + static_cast<size_t>(o) * kmax;
      float total = 0.0f;
      for (int i = lo; i < hi; ++i) {
        float t = (i + 0.5f - center) / support;
        if (t < 0) t = -t;
        const float wgt = t < 1.0f ? 1.0f - t : 0.0f;
        wrow[i - lo] = wgt;
        total += wgt;
      }
      if (total > 0) {
        for (int i = 0; i < hi - lo; ++i) wrow[i] /= total;
      }
      (*taps)[o] = {lo, hi - lo, o * kmax};
    }
  };
  std::vector<Tap> xt, yt;
  std::vector<float> xw, yw;
  build_taps(w, ow, &xt, &xw);
  build_taps(h, oh, &yt, &yw);
  std::vector<float> tmp(static_cast<size_t>(h) * ow * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = px.data() + static_cast<size_t>(y) * w * 3;
    float* orow = tmp.data() + static_cast<size_t>(y) * ow * 3;
    for (int ox = 0; ox < ow; ++ox) {
      const Tap& t = xt[ox];
      const float* wrow = xw.data() + t.woff;
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int i = 0; i < t.n; ++i) {
        const uint8_t* p = row + (static_cast<size_t>(t.start) + i) * 3;
        const float wgt = wrow[i];
        acc[0] += wgt * p[0];
        acc[1] += wgt * p[1];
        acc[2] += wgt * p[2];
      }
      orow[ox * 3 + 0] = acc[0];
      orow[ox * 3 + 1] = acc[1];
      orow[ox * 3 + 2] = acc[2];
    }
  }
  for (int oy = 0; oy < oh; ++oy) {
    const Tap& t = yt[oy];
    const float* wcol = yw.data() + t.woff;
    float* orow = out + static_cast<size_t>(oy) * ow * 3;
    for (int jx = 0; jx < ow * 3; ++jx) orow[jx] = 0.0f;
    for (int i = 0; i < t.n; ++i) {
      const float wgt = wcol[i];
      const float* srow =
          tmp.data() + (static_cast<size_t>(t.start) + i) * ow * 3;
      for (int jx = 0; jx < ow * 3; ++jx) orow[jx] += wgt * srow[jx];
    }
    for (int jx = 0; jx < ow * 3; ++jx) orow[jx] = orow[jx] * scale + shift;
  }
  return 0;
}

// The JAX package's native nearest resize of a grayscale mask
// (fastio_decode_png_resize_nearest_u8's float32 sampling), uint8
void imageio_nearest_fastio_u8(const uint8_t* in, int h, int w, uint8_t* out,
                               int oh, int ow) {
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  for (int oy = 0; oy < oh; ++oy) {
    int y = static_cast<int>((oy + 0.5f) * sy);
    if (y >= h) y = h - 1;
    for (int ox = 0; ox < ow; ++ox) {
      int x = static_cast<int>((ox + 0.5f) * sx);
      if (x >= w) x = w - 1;
      out[static_cast<size_t>(oy) * ow + ox] =
          in[static_cast<size_t>(y) * w + x];
    }
  }
}

// Pillow's BILINEAR resize of a uint8 [h, w, c] image (ImagingResample:
// the horizontal pass over the rows the vertical pass reads, then the
// vertical pass, each rounded and clipped to 8 bits)
int imageio_resize_bilinear_u8(const uint8_t* in, int h, int w, int c,
                               uint8_t* out, int oh, int ow) {
  if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || c <= 0) return 1;
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  const bool need_h = ow != w, need_v = oh != h;
  const int ksh = bilinear_coeffs(w, ow, &bh, &kh);
  const int ksv = bilinear_coeffs(h, oh, &bv, &kv);
  const int yfirst = bv[0];
  const int ylast = bv[(oh - 1) * 2] + bv[(oh - 1) * 2 + 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int src_row0 = 0;
  if (need_h) {
    const int rows = ylast - yfirst;
    tmp.resize(static_cast<size_t>(rows) * ow * c);
    for (int yy = 0; yy < rows; ++yy) {
      const uint8_t* row = in + static_cast<size_t>(yy + yfirst) * w * c;
      uint8_t* orow = tmp.data() + static_cast<size_t>(yy) * ow * c;
      for (int xx = 0; xx < ow; ++xx) {
        const int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = &kh[static_cast<size_t>(xx) * ksh];
        for (int ch = 0; ch < c; ++ch) {
          int ss = 1 << (kPrecisionBits - 1);
          for (int x = 0; x < xmax; ++x)
            ss += row[static_cast<size_t>(x + xmin) * c + ch] * k[x];
          orow[static_cast<size_t>(xx) * c + ch] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    src_row0 = yfirst;
  }
  const int sw = need_h ? ow : w;
  if (!need_v) {
    std::memcpy(out, src, static_cast<size_t>(oh) * ow * c);
    return 0;
  }
  for (int yy = 0; yy < oh; ++yy) {
    const int ymin = bv[yy * 2] - src_row0, ymax = bv[yy * 2 + 1];
    const int32_t* k = &kv[static_cast<size_t>(yy) * ksv];
    uint8_t* orow = out + static_cast<size_t>(yy) * ow * c;
    for (int xx = 0; xx < ow * c; ++xx) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y)
        ss += src[static_cast<size_t>(y + ymin) * sw * c + xx] * k[y];
      orow[xx] = clip8(ss);
    }
  }
  return 0;
}

// Pillow's NEAREST resize (ImagingTransform's scale-only affine path,
// ImagingScaleAffine): elem bytes a pixel, any layout of those bytes
int imageio_resize_nearest(const uint8_t* in, int h, int w, int elem,
                           uint8_t* out, int oh, int ow) {
  if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || elem <= 0) return 1;
  const double a0 = static_cast<double>(static_cast<float>(w)) / ow;
  const double a4 = static_cast<double>(static_cast<float>(h)) / oh;
  std::vector<int> xin(ow, 0);
  int xmin = ow, xmax = 0;
  double xo = 0.0 + a0 * 0.5;
  for (int x = 0; x < ow; ++x) {
    int xi = xo < 0.0 ? -1 : static_cast<int>(xo);
    if (xi >= 0 && xi < w) {
      xmax = x + 1;
      if (x < xmin) xmin = x;
      xin[x] = xi;
    }
    xo += a0;
  }
  double yo = 0.0 + a4 * 0.5;
  for (int y = 0; y < oh; ++y) {
    int yi = yo < 0.0 ? -1 : static_cast<int>(yo);
    uint8_t* orow = out + static_cast<size_t>(y) * ow * elem;
    std::memset(orow, 0, static_cast<size_t>(ow) * elem);
    if (yi >= 0 && yi < h) {
      const uint8_t* irow = in + static_cast<size_t>(yi) * w * elem;
      for (int x = xmin; x < xmax; ++x)
        std::memcpy(orow + static_cast<size_t>(x) * elem,
                    irow + static_cast<size_t>(xin[x]) * elem, elem);
    }
    yo += a4;
  }
  return 0;
}

// Undo PNG row filters in place: `raw` holds `rows` rows of 1 + rowbytes
// bytes (filter type, then the filtered row); `out` gets rows * rowbytes
// bytes. bpp = bytes per complete pixel (at least 1). -> 0, or the row
// (1-based) whose filter type is unknown
int imageio_png_unfilter(const uint8_t* raw, int rows, int rowbytes, int bpp,
                         uint8_t* out) {
  std::vector<uint8_t> zero(static_cast<size_t>(rowbytes), 0);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* f = raw + static_cast<size_t>(r) * (rowbytes + 1);
    const int type = f[0];
    const uint8_t* s = f + 1;
    uint8_t* o = out + static_cast<size_t>(r) * rowbytes;
    const uint8_t* p =
        r ? out + static_cast<size_t>(r - 1) * rowbytes : zero.data();
    switch (type) {
      case 0:
        std::memcpy(o, s, rowbytes);
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i)
          o[i] = static_cast<uint8_t>(s[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i)
          o[i] = static_cast<uint8_t>(s[i] + p[i]);
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0;
          o[i] = static_cast<uint8_t>(s[i] + ((a + p[i]) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0;
          int b = p[i];
          int c = i >= bpp ? p[i - bpp] : 0;
          int pa = std::abs(b - c), pb = std::abs(a - c),
              pc = std::abs(a + b - 2 * c);
          int pr = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = static_cast<uint8_t>(s[i] + pr);
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

// Pillow's ImagingDrawPolygon with fill on an 8-bit image (Draw.c: the
// edge list, with a horizontal edge that continues another horizontal
// edge in the same direction merged into it, then polygon_generic's
// scanline fill), painting 1; xy holds n integer vertices
int imageio_polygon_fill(uint8_t* img, int h, int w, const int* xy, int n) {
  if (n <= 0) return 0;
  struct Edge {
    int x0, y0, xmin, ymin, xmax, ymax;
    float dx;
  };
  auto hline = [&](int x0, int y, int x1) {
    if (y < 0 || y >= h) return;
    if (x0 < 0) x0 = 0;
    else if (x0 >= w) return;
    if (x1 < 0) return;
    else if (x1 >= w) x1 = w - 1;
    if (x0 <= x1)
      std::memset(img + static_cast<size_t>(y) * w + x0, 1, x1 - x0 + 1);
  };
  auto add_edge = [](Edge* e, int x0, int y0, int x1, int y1) {
    e->xmin = std::min(x0, x1);
    e->xmax = std::max(x0, x1);
    e->ymin = std::min(y0, y1);
    e->ymax = std::max(y0, y1);
    e->dx = y0 == y1 ? 0.0f
                     : static_cast<float>(x1 - x0) / static_cast<float>(y1 - y0);
    e->x0 = x0;
    e->y0 = y0;
  };
  std::vector<Edge> e(n);
  int ne = 0, i;
  for (i = 0; i < n - 1; ++i) {
    int x0 = xy[i * 2], y0 = xy[i * 2 + 1];
    int x1 = xy[i * 2 + 2], y1 = xy[i * 2 + 3];
    if (y0 == y1 && i != 0 && y0 == xy[i * 2 - 1]) {
      Edge* last = &e[ne - 1];
      if (x1 > x0 && x0 > xy[i * 2 - 2]) {
        last->xmax = x1;
        continue;
      } else if (x1 < x0 && x0 < xy[i * 2 - 2]) {
        last->xmin = x1;
        continue;
      }
    }
    add_edge(&e[ne++], x0, y0, x1, y1);
  }
  if (xy[i * 2] != xy[0] || xy[i * 2 + 1] != xy[1])
    add_edge(&e[ne++], xy[i * 2], xy[i * 2 + 1], xy[0], xy[1]);

  std::vector<Edge*> table;
  int ymin = h - 1, ymax = 0;
  for (int k = 0; k < ne; ++k) {
    ymin = std::min(ymin, e[k].ymin);
    ymax = std::max(ymax, e[k].ymax);
    if (e[k].ymin == e[k].ymax) {
      hline(e[k].xmin, e[k].ymin, e[k].xmax);
      continue;
    }
    table.push_back(&e[k]);
  }
  if (ymin < 0) ymin = 0;
  if (ymax > h) ymax = h;
  const int ec = static_cast<int>(table.size());
  std::vector<float> xx(static_cast<size_t>(ec) * 2 + 2);
  // Draw.c's ROUND_UP and ROUND_DOWN (halves away from / toward zero)
  auto round_up = [](float f) {
    return static_cast<int>(f >= 0.0f ? std::floor(f + 0.5f)
                                      : -std::floor(std::fabs(f) + 0.5f));
  };
  auto round_down = [](float f) {
    return static_cast<int>(f >= 0.0f ? std::ceil(f - 0.5f)
                                      : -std::ceil(std::fabs(f) - 0.5f));
  };
  auto x_at = [](const Edge* e, int y) {
    return static_cast<float>(y - e->y0) * e->dx + static_cast<float>(e->x0);
  };
  for (int y = ymin; y <= ymax; ++y) {
    int j = 0;
    for (int i = 0; i < ec; ++i) {
      const Edge* cur = table[i];
      if (y < cur->ymin || y > cur->ymax) continue;
      xx[j++] = x_at(cur, y);
      if (y == cur->ymax && y < ymax) {
        // needed to draw consistent polygons
        xx[j] = xx[j - 1];
        j++;
      } else if (cur->dx != 0) {
        // connect discontiguous corners: the first earlier sloped edge
        // that starts (or ends) on this row at the same x, rounded, makes
        // a corner with this one; the vertex's span then reaches to the
        // pixel next to the span of the row beside it (the row below;
        // above, on the last row), rounded half up, where that widens it
        for (int k = 0; k < i; ++k) {
          const Edge* other = table[k];
          if (other->dx == 0) continue;
          if (!((y == cur->ymin && y == other->ymin) ||
                (y == cur->ymax && y == other->ymax)))
            continue;
          if (std::round(xx[j - 1]) != std::round(x_at(other, y))) continue;
          const int off = y == ymax ? -1 : 1;
          const float a = x_at(cur, y + off), b = x_at(other, y + off);
          const bool bottom = y == cur->ymax;
          const bool left = bottom ? cur->dx > 0 : cur->dx < 0;
          const float v =
              left ? std::floor(std::max(a, b) + 1.0f + 0.5f)
                   : std::floor(std::min(a, b) - 1.0f + 0.5f);
          if (left ? v < xx[j - 1] : v > xx[j - 1]) xx[j - 1] = v;
          break;
        }
      }
    }
    std::sort(xx.begin(), xx.begin() + j);
    for (int k = 1; k < j; k += 2)
      hline(round_up(xx[k - 1]), y, round_down(xx[k]));
  }
  return 0;
}

}  // extern "C"
