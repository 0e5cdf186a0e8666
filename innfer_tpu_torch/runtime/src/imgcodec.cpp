// Native image codec: PNG decode/encode on zlib alone, JPEG decode on
// libjpeg where it is built in; C ABI for ctypes.
//
// The counterpart of the JAX package's runtime/src/imgcodec.cpp, with the
// same entry points and the same results, without libpng: the machine the
// port runs on has zlib and no libpng, so the PNG container (chunks, CRCs,
// the five row filters, Adam7) is done here and zlib inflates and deflates.
//  - decode_png gives what libpng gives after the JAX package's transforms
//    (palette -> BGR, gray < 8 bits -> 8, tRNS -> alpha, RGB -> BGR,
//    interlacing undone; ancillary chunks other than tRNS ignored) and
//    refuses what libpng refuses with its default settings: a bad CRC on a
//    critical chunk, too little image data, an IHDR over 1,000,000 pixels
//    a side.  A 16-bit file answers IMG_ERR_UNSUPPORTED; decode_png16 reads
//    it as native-endian uint16 BGR(A).
//  - encode_png writes the bytes libpng 1.6 writes for the same call: its
//    zlib window for the image's size, its zlib header rewrite, 8192-byte
//    IDAT chunks, its per-image filter set and, at levels >= 2, its
//    minimum-sum-of-absolute-differences filter choice per row.
// JPEG (decode_jpeg) is compiled in with -DINNFER_WITH_JPEG and -ljpeg;
// without it decode_jpeg answers IMG_ERR_UNSUPPORTED and the Python layer
// takes OpenCV.  codec_has_jpeg says which build this is.
//
// The reference reaches native decode only through OpenCV (its
// utils/utils.py:68-95); this thin codec keeps the hot I/O path off
// cv2's Python layer and runs inside the prefetch loader (loader.cpp).

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>

#ifdef INNFER_WITH_JPEG
#include <jpeglib.h>
#include <csetjmp>
#endif

extern "C" {

// Error codes
enum {
  IMG_OK = 0,
  IMG_ERR_OPEN = -1,
  IMG_ERR_DECODE = -2,
  IMG_ERR_UNSUPPORTED = -3,
  IMG_ERR_ENCODE = -4,
};

}  // extern "C"

namespace {

constexpr uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
constexpr uint32_t kMaxSide = 1000000;   // libpng's PNG_USER_{WIDTH,HEIGHT}_MAX
constexpr uint32_t kZbufSize = 8192;     // libpng's PNG_ZBUF_SIZE: IDAT size written

constexpr uint32_t tag(const char* s) {
  return (uint32_t)(uint8_t)s[0] << 24 | (uint32_t)(uint8_t)s[1] << 16 |
         (uint32_t)(uint8_t)s[2] << 8 | (uint32_t)(uint8_t)s[3];
}
constexpr uint32_t kIHDR = tag("IHDR"), kPLTE = tag("PLTE"), kTRNS = tag("tRNS"),
                   kIDAT = tag("IDAT"), kIEND = tag("IEND");

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}
inline uint16_t be16(const uint8_t* p) { return (uint16_t)(p[0] << 8 | p[1]); }
inline void put32(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24); p[1] = (uint8_t)(v >> 16); p[2] = (uint8_t)(v >> 8); p[3] = (uint8_t)v;
}

struct FreeDeleter { void operator()(void* p) const { free(p); } };
struct FileCloser { void operator()(FILE* f) const { fclose(f); } };
using FilePtr = std::unique_ptr<FILE, FileCloser>;

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

struct Chunk {
  uint32_t type = 0, len = 0;
  const uint8_t* data = nullptr;
  bool crc_ok = false;
};

// The file in memory and a cursor over its chunks.
struct PngFile {
  std::unique_ptr<uint8_t[]> bytes;
  size_t size = 0, pos = 8;

  int load(const char* path) {
    FilePtr fp(fopen(path, "rb"));
    if (!fp) return IMG_ERR_OPEN;
    if (fseek(fp.get(), 0, SEEK_END) != 0) return IMG_ERR_DECODE;
    long n = ftell(fp.get());
    if (n < 8 || fseek(fp.get(), 0, SEEK_SET) != 0) return IMG_ERR_DECODE;
    size = (size_t)n;
    bytes.reset(new (std::nothrow) uint8_t[size]);
    if (!bytes || fread(bytes.get(), 1, size, fp.get()) != size) return IMG_ERR_DECODE;
    return memcmp(bytes.get(), kSignature, 8) == 0 ? IMG_OK : IMG_ERR_DECODE;
  }

  // The next chunk; false where the file ends inside it (libpng's "Read
  // Error") or its header is invalid (a length over 2^31 - 1, a type that
  // is not four letters).
  bool next(Chunk& ch) {
    if (size - pos < 8) return false;
    const uint8_t* p = bytes.get() + pos;
    ch.len = be32(p);
    ch.type = be32(p + 4);
    if (ch.len > 0x7fffffffu) return false;
    for (int i = 4; i < 8; ++i) {
      uint8_t b = p[i] | 0x20;
      if (b < 'a' || b > 'z') return false;
    }
    if (size - pos - 8 < (size_t)ch.len + 4) return false;
    ch.data = p + 8;
    ch.crc_ok = crc32(0, p + 4, 4 + ch.len) == be32(p + 8 + ch.len);
    pos += 12 + (size_t)ch.len;
    return true;
  }
};

inline bool critical(uint32_t type) { return (type & 0x20000000u) == 0; }

struct Header {
  uint32_t width = 0, height = 0;
  int depth = 0, color = 0, interlace = 0;
  int samples = 0;                 // samples per pixel in the file
  uint8_t palette[256 * 3] = {};   // libpng zero-fills the unused entries
  uint8_t palette_alpha[256];      // 255 beyond tRNS's entries
  size_t palette_n = 0;
  bool has_palette = false, has_trns = false;
  uint16_t trns[3] = {};           // gray, or R G B

  Header() { memset(palette_alpha, 255, sizeof palette_alpha); }

  int out_channels() const {
    switch (color) {
      case 0: return has_trns ? 2 : 1;
      case 2: return has_trns ? 4 : 3;
      case 3: return has_trns ? 4 : 3;
      case 4: return 2;
      default: return 4;
    }
  }
};

bool parse_ihdr(const Chunk& ch, Header& hd) {
  if (ch.len != 13 || !ch.crc_ok) return false;
  const uint8_t* d = ch.data;
  hd.width = be32(d);
  hd.height = be32(d + 4);
  hd.depth = d[8];
  hd.color = d[9];
  hd.interlace = d[12];
  if (hd.width == 0 || hd.height == 0 || hd.width > kMaxSide || hd.height > kMaxSide)
    return false;
  if (d[10] != 0 || d[11] != 0 || hd.interlace > 1) return false;  // compression, filter
  const int dp = hd.depth;
  switch (hd.color) {
    case 0: hd.samples = 1; if (dp != 1 && dp != 2 && dp != 4 && dp != 8 && dp != 16) return false; break;
    case 3: hd.samples = 1; if (dp != 1 && dp != 2 && dp != 4 && dp != 8) return false; break;
    case 2: hd.samples = 3; break;
    case 4: hd.samples = 2; break;
    case 6: hd.samples = 4; break;
    default: return false;
  }
  if (hd.color != 0 && hd.color != 3 && dp != 8 && dp != 16) return false;
  return true;
}

// Read IHDR and the chunks before the first IDAT, as png_read_info does;
// on success `ch` holds that IDAT.
int read_info(PngFile& f, Header& hd, Chunk& ch) {
  if (!f.next(ch) || ch.type != kIHDR || !parse_ihdr(ch, hd)) return IMG_ERR_DECODE;
  for (;;) {
    if (!f.next(ch)) return IMG_ERR_DECODE;
    if (critical(ch.type) && !ch.crc_ok) return IMG_ERR_DECODE;
    if (ch.type == kIDAT) break;
    if (ch.type == kPLTE) {
      if (hd.has_palette) return IMG_ERR_DECODE;  // duplicate
      if (hd.color == 0 || hd.color == 4) continue;  // ignored in a gray file
      if (ch.len > 768 || ch.len % 3 != 0 || ch.len == 0) {
        if (hd.color == 3) return IMG_ERR_DECODE;
        continue;
      }
      size_t n = ch.len / 3;
      if (hd.color == 3 && n > (size_t)1 << hd.depth) n = (size_t)1 << hd.depth;
      memcpy(hd.palette, ch.data, n * 3);
      hd.palette_n = n;
      hd.has_palette = true;
    } else if (ch.type == kTRNS) {
      // an invalid, misplaced, repeated or damaged tRNS is dropped, as
      // libpng drops it (a benign error)
      if (hd.has_trns || !ch.crc_ok) continue;
      if (hd.color == 3) {
        if (!hd.has_palette || ch.len == 0 || ch.len > hd.palette_n) continue;
        memcpy(hd.palette_alpha, ch.data, ch.len);
      } else if (hd.color == 0 && ch.len == 2) {
        hd.trns[0] = be16(ch.data);
      } else if (hd.color == 2 && ch.len == 6) {
        for (int i = 0; i < 3; ++i) hd.trns[i] = be16(ch.data + 2 * i);
      } else {
        continue;
      }
      hd.has_trns = true;
    } else if (ch.type == kIHDR || ch.type == kIEND || critical(ch.type)) {
      return IMG_ERR_DECODE;  // out of place, or an unknown critical chunk
    }
  }
  if (hd.color == 3 && !hd.has_palette) return IMG_ERR_DECODE;
  return IMG_OK;
}

// The zlib stream spread over consecutive IDAT chunks.
struct IdatStream {
  PngFile& f;
  z_stream zs{};
  bool inited = false, ended = false;

  explicit IdatStream(PngFile& file) : f(file) {}
  ~IdatStream() { if (inited) inflateEnd(&zs); }

  bool start(const Chunk& first) {
    // windowBits 0: the window the zlib header declares, as libpng asks
    if (inflateInit2(&zs, 0) != Z_OK) return false;
    inited = true;
    feed(first);
    return true;
  }
  void feed(const Chunk& ch) {
    zs.next_in = const_cast<Bytef*>(ch.data);
    zs.avail_in = ch.len;
  }
  // the next non-empty IDAT's data; false where the next chunk is not an
  // intact IDAT
  bool more() {
    Chunk ch;
    do {
      if (!f.next(ch) || ch.type != kIDAT || !ch.crc_ok) return false;
    } while (ch.len == 0);
    feed(ch);
    return true;
  }
  int inflate_some(int flush) {
    if (zs.total_in == 0 && zs.avail_in > 0 && (zs.next_in[0] >> 4) > 7)
      return Z_DATA_ERROR;  // libpng's "invalid window size"
    return inflate(&zs, flush);
  }
  // Fill out[0..n) with image data; false on any shortfall or zlib error.
  bool read(uint8_t* out, size_t n) {
    zs.next_out = out;
    zs.avail_out = (uInt)n;
    while (zs.avail_out > 0) {
      if (ended) return false;  // "Not enough image data"
      if (zs.avail_in == 0 && !more()) return false;
      int ret = inflate_some(Z_NO_FLUSH);
      if (ret == Z_STREAM_END) ended = true;
      else if (ret != Z_OK && !(ret == Z_BUF_ERROR && zs.avail_in == 0)) return false;
    }
    return true;
  }
  // After the last row, as png_read_finish_IDAT: give zlib one more look
  // at the stream's end; an error there is benign, but the end of the
  // data must not run into a chunk that is not an IDAT.
  bool finish() {
    if (ended) return true;
    if (zs.avail_in == 0 && !more()) return false;
    uint8_t tmp[1024];
    zs.next_out = tmp;
    zs.avail_out = sizeof tmp;
    inflate_some(Z_NO_FLUSH);
    return true;
  }
};

inline uint8_t paeth(int a, int b, int c) {
  int p = b - c, pc = a - c;
  int pa = p < 0 ? -p : p, pb = pc < 0 ? -pc : pc;
  pc = (p + pc) < 0 ? -(p + pc) : p + pc;
  return (uint8_t)((pa <= pb && pa <= pc) ? a : (pb <= pc) ? b : c);
}

// Undo one row's filter in place: row[0] is the filter byte, prev the
// previous unfiltered row of the same pass (zeros on its first row).
bool unfilter(uint8_t* row, const uint8_t* prev, size_t n, size_t bpp) {
  uint8_t* r = row + 1;
  const uint8_t* p = prev + 1;
  switch (row[0]) {
    case 0: break;
    case 1: for (size_t i = bpp; i < n; ++i) r[i] = (uint8_t)(r[i] + r[i - bpp]); break;
    case 2: for (size_t i = 0; i < n; ++i) r[i] = (uint8_t)(r[i] + p[i]); break;
    case 3:
      for (size_t i = 0; i < bpp && i < n; ++i) r[i] = (uint8_t)(r[i] + (p[i] >> 1));
      for (size_t i = bpp; i < n; ++i) r[i] = (uint8_t)(r[i] + ((r[i - bpp] + p[i]) >> 1));
      break;
    case 4:
      for (size_t i = 0; i < bpp && i < n; ++i) r[i] = (uint8_t)(r[i] + p[i]);
      for (size_t i = bpp; i < n; ++i) r[i] = (uint8_t)(r[i] + paeth(r[i - bpp], p[i], p[i - bpp]));
      break;
    default: return false;  // libpng: "bad adaptive filter value"
  }
  return true;
}

// One unfiltered file row of `count` pixels to output pixels `step`
// values apart, in the output's channel order (BGR(A), gray(+alpha)).
template <typename T>
void emit_row(const Header& hd, const uint8_t* raw, uint32_t count, T* out, size_t step) {
  const int oc = hd.out_channels();
  if (sizeof(T) == 2) {  // 16-bit: gray, gray+alpha, RGB, RGBA, big-endian samples
    for (uint32_t i = 0; i < count; ++i, out += step) {
      const uint8_t* s = raw + (size_t)i * hd.samples * 2;
      switch (hd.color) {
        case 0:
          out[0] = (T)be16(s);
          if (hd.has_trns) out[1] = (T)(be16(s) == hd.trns[0] ? 0 : 0xffff);
          break;
        case 4: out[0] = (T)be16(s); out[1] = (T)be16(s + 2); break;
        case 2: out[0] = (T)be16(s + 4); out[1] = (T)be16(s + 2); out[2] = (T)be16(s);
                if (hd.has_trns)
                  out[3] = (T)(be16(s) == hd.trns[0] && be16(s + 2) == hd.trns[1] &&
                               be16(s + 4) == hd.trns[2] ? 0 : 0xffff);
                break;
        default: out[0] = (T)be16(s + 4); out[1] = (T)be16(s + 2); out[2] = (T)be16(s);
                 out[3] = (T)be16(s + 6);
      }
    }
    return;
  }
  switch (hd.color) {
    case 0:
    case 3: {  // 1/2/4/8-bit indices or gray levels
      const int dp = hd.depth, mask = (1 << dp) - 1;
      const int scale = dp == 1 ? 255 : dp == 2 ? 85 : dp == 4 ? 17 : 1;
      const int tgray = hd.trns[0] & mask;
      for (uint32_t i = 0; i < count; ++i, out += step) {
        size_t bit = (size_t)i * dp;
        int v = dp == 8 ? raw[i] : (raw[bit >> 3] >> (8 - dp - (int)(bit & 7))) & mask;
        if (hd.color == 0) {
          out[0] = (T)(v * scale);
          if (hd.has_trns) out[1] = (T)(v == tgray ? 0 : 255);
        } else {
          const uint8_t* c = hd.palette + 3 * v;
          out[0] = c[2]; out[1] = c[1]; out[2] = c[0];
          if (oc == 4) out[3] = hd.palette_alpha[v];
        }
      }
      break;
    }
    case 2:
      if (hd.has_trns) {
        for (uint32_t i = 0; i < count; ++i, out += step, raw += 3) {
          out[0] = raw[2]; out[1] = raw[1]; out[2] = raw[0];
          out[3] = (T)(raw[0] == (hd.trns[0] & 0xff) && raw[1] == (hd.trns[1] & 0xff) &&
                       raw[2] == (hd.trns[2] & 0xff) ? 0 : 255);
        }
      } else {
        for (uint32_t i = 0; i < count; ++i, out += step, raw += 3) {
          out[0] = raw[2]; out[1] = raw[1]; out[2] = raw[0];
        }
      }
      break;
    case 4:
      for (uint32_t i = 0; i < count; ++i, out += step, raw += 2) { out[0] = raw[0]; out[1] = raw[1]; }
      break;
    default:
      for (uint32_t i = 0; i < count; ++i, out += step, raw += 4) {
        out[0] = raw[2]; out[1] = raw[1]; out[2] = raw[0]; out[3] = raw[3];
      }
  }
}

// Adam7: the first column and row of each pass, and the steps between them.
constexpr int kPassX0[7] = {0, 4, 0, 2, 0, 1, 0}, kPassDX[7] = {8, 8, 4, 4, 2, 2, 1};
constexpr int kPassY0[7] = {0, 0, 4, 0, 2, 0, 1}, kPassDY[7] = {8, 8, 8, 4, 4, 2, 2};

template <typename T>
int decode_png_into(const char* path, bool sixteen, T** out, int* h, int* w, int* c) {
  PngFile f;
  int rc = f.load(path);
  if (rc != IMG_OK) return rc;
  Header hd;
  Chunk ch;
  if (read_info(f, hd, ch) != IMG_OK) return IMG_ERR_DECODE;
  if ((hd.depth == 16) != sixteen) return IMG_ERR_UNSUPPORTED;  // the other entry point

  const int oc = hd.out_channels();
  const size_t bits = (size_t)hd.depth * hd.samples;   // bits per file pixel
  const size_t bpp = (bits + 7) / 8;                   // the filters' byte distance
  const size_t stride = (size_t)hd.width * oc;         // output values per row
  if (hd.height > SIZE_MAX / sizeof(T) / stride) return IMG_ERR_DECODE;
  const size_t max_row = ((size_t)hd.width * bits + 7) / 8;

  std::unique_ptr<T, FreeDeleter> img((T*)malloc((size_t)hd.height * stride * sizeof(T)));
  std::unique_ptr<uint8_t[]> rows(new (std::nothrow) uint8_t[2 * (max_row + 1)]);
  if (!img || !rows) return IMG_ERR_DECODE;
  IdatStream zs(f);
  if (!zs.start(ch)) return IMG_ERR_DECODE;

  const int passes = hd.interlace ? 7 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const uint32_t x0 = hd.interlace ? kPassX0[pass] : 0, dx = hd.interlace ? kPassDX[pass] : 1;
    const uint32_t y0 = hd.interlace ? kPassY0[pass] : 0, dy = hd.interlace ? kPassDY[pass] : 1;
    if (x0 >= hd.width || y0 >= hd.height) continue;  // an empty pass has no rows
    const uint32_t pw = (hd.width - x0 + dx - 1) / dx;
    const size_t n = ((size_t)pw * bits + 7) / 8;
    uint8_t* cur = rows.get();
    uint8_t* prev = rows.get() + max_row + 1;
    memset(prev, 0, n + 1);
    for (uint32_t y = y0; y < hd.height; y += dy) {
      if (!zs.read(cur, n + 1) || !unfilter(cur, prev, n, bpp)) return IMG_ERR_DECODE;
      emit_row<T>(hd, cur + 1, pw, img.get() + (size_t)y * stride + (size_t)x0 * oc,
                  (size_t)dx * oc);
      uint8_t* t = prev; prev = cur; cur = t;
    }
  }
  if (!zs.finish()) return IMG_ERR_DECODE;

  *out = img.release();
  *h = (int)hd.height;
  *w = (int)hd.width;
  *c = oc;
  return IMG_OK;
}

// ---------------------------------------------------------------------------
// PNG encode
// ---------------------------------------------------------------------------

// libpng's filter flags and the byte each filter writes before its row
enum { F_NONE = 0x08, F_SUB = 0x10, F_UP = 0x20, F_AVG = 0x40, F_PAETH = 0x80 };

inline size_t sad(uint8_t v) { return v < 128 ? v : 256 - v; }

struct PngWriter {
  FILE* fp;
  uint8_t zbuf[kZbufSize];
  bool wrote_idat = false;
  size_t image_size;  // png_image_size: (rowbytes + 1) * height, or 2^32 - 1

  bool chunk(uint32_t type, const uint8_t* data, uint32_t len) {
    uint8_t head[8], tail[4];
    put32(head, len);
    put32(head + 4, type);
    uLong crc = crc32(0, head + 4, 4);
    if (len > 0) crc = crc32(crc, data, len);  // crc32 of a null buffer is 0
    put32(tail, (uint32_t)crc);
    return fwrite(head, 1, 8, fp) == 8 && (len == 0 || fwrite(data, 1, len, fp) == len) &&
           fwrite(tail, 1, 4, fp) == 4;
  }

  // libpng's optimize_cmf: on the first IDAT, shrink the zlib header's
  // window to the smallest that covers the image data, and fix FCHECK.
  void optimize_cmf(uint8_t* data) {
    if (image_size > 16384) return;
    unsigned cmf = data[0];
    if ((cmf & 0x0f) != 8 || (cmf & 0xf0) > 0x70) return;
    unsigned cinfo = cmf >> 4, half = 1u << (cinfo + 7);
    if (image_size > half) return;
    do { half >>= 1; --cinfo; } while (cinfo > 0 && image_size <= half);
    cmf = (cmf & 0x0f) | (cinfo << 4);
    data[0] = (uint8_t)cmf;
    unsigned flg = data[1] & 0xe0;
    flg += 0x1f - ((cmf << 8) + flg) % 0x1f;
    data[1] = (uint8_t)flg;
  }

  bool idat(uint32_t len) {
    if (!wrote_idat) optimize_cmf(zbuf);
    wrote_idat = true;
    return chunk(kIDAT, zbuf, len);
  }

  // png_compress_IDAT: deflate `input` and write each full buffer as an
  // IDAT; at Z_FINISH also the rest.
  bool compress(z_stream& zs, const uint8_t* input, size_t len, int flush) {
    zs.next_in = const_cast<Bytef*>(input);
    zs.avail_in = (uInt)len;
    for (;;) {
      int ret = deflate(&zs, flush);
      if (zs.avail_out == 0) {
        if (!idat(kZbufSize)) return false;
        zs.next_out = zbuf;
        zs.avail_out = kZbufSize;
        if (ret == Z_OK && flush != Z_NO_FLUSH) continue;
      }
      if (ret == Z_OK) {
        if (zs.avail_in == 0) return flush == Z_NO_FLUSH;
      } else if (ret == Z_STREAM_END && flush == Z_FINISH) {
        uint32_t rest = kZbufSize - zs.avail_out;
        return rest == 0 || idat(rest);
      } else {
        return false;
      }
    }
  }
};

// libpng's png_write_find_filter: with one filter, that filter; with
// several, the one whose bytes (as signed) sum to the least absolute
// value, the earlier on a tie.  `row` and `prev` carry a byte before the
// pixels; the chosen row (filter byte first) is returned.
// One filter, k = 0..3 for SUB, UP, AVG, PAETH, into o[0..n).
void filter_row(int k, const uint8_t* r, const uint8_t* p, uint8_t* o, size_t n, size_t bpp) {
  switch (k) {
    case 0:
      for (size_t i = 0; i < bpp; ++i) o[i] = r[i];
      for (size_t i = bpp; i < n; ++i) o[i] = (uint8_t)(r[i] - r[i - bpp]);
      break;
    case 1:
      for (size_t i = 0; i < n; ++i) o[i] = (uint8_t)(r[i] - p[i]);
      break;
    case 2:
      for (size_t i = 0; i < bpp; ++i) o[i] = (uint8_t)(r[i] - (p[i] >> 1));
      for (size_t i = bpp; i < n; ++i) o[i] = (uint8_t)(r[i] - ((r[i - bpp] + p[i]) >> 1));
      break;
    default:
      for (size_t i = 0; i < bpp; ++i) o[i] = (uint8_t)(r[i] - p[i]);
      for (size_t i = bpp; i < n; ++i) o[i] = (uint8_t)(r[i] - paeth(r[i - bpp], p[i], p[i - bpp]));
  }
}

const uint8_t* choose_filter(int filters, const uint8_t* row, const uint8_t* prev,
                             size_t n, size_t bpp, uint8_t* const tries[4]) {
  const uint8_t* r = row + 1;
  const uint8_t* p = prev + 1;
  const uint8_t* best = row;  // row[0] == 0: the NONE filter
  if ((filters & (filters - 1)) == 0) {  // one filter: nothing to choose
    if (filters == F_NONE) return best;
    const int k = filters == F_SUB ? 0 : filters == F_UP ? 1 : filters == F_AVG ? 2 : 3;
    tries[k][0] = (uint8_t)(k + 1);
    filter_row(k, r, p, tries[k] + 1, n, bpp);
    return tries[k];
  }
  size_t mins = SIZE_MAX - 256;
  if (filters & F_NONE) {
    size_t sum = 0;
    for (size_t i = 0; i < n; ++i) sum += sad(r[i]);
    mins = sum;
  }
  for (int k = 0; k < 4; ++k) {
    const int flag = F_SUB << k;
    if (!(filters & flag)) continue;
    uint8_t* d = tries[k];
    d[0] = (uint8_t)(k + 1);
    uint8_t* o = d + 1;
    size_t sum = 0, i = 0;
    const size_t head = k == 1 ? 0 : bpp < n ? bpp : n;  // UP has no left neighbour part
    for (; i < head; ++i) {
      o[i] = (uint8_t)(k == 0 ? r[i] : k == 2 ? r[i] - (p[i] >> 1) : r[i] - p[i]);
      sum += sad(o[i]);
    }
    for (; i < n; ++i) {
      switch (k) {
        case 0: o[i] = (uint8_t)(r[i] - r[i - bpp]); break;
        case 1: o[i] = (uint8_t)(r[i] - p[i]); break;
        case 2: o[i] = (uint8_t)(r[i] - ((r[i - bpp] + p[i]) >> 1)); break;
        default: o[i] = (uint8_t)(r[i] - paeth(r[i - bpp], p[i], p[i - bpp]));
      }
      sum += sad(o[i]);
      if (sum > mins) break;  // already worse
    }
    if (sum < mins) { mins = sum; best = d; }
  }
  return best;
}

}  // namespace

extern "C" {

int decode_png(const char* path, uint8_t** out, int* h, int* w, int* c) {
  return decode_png_into<uint8_t>(path, false, out, h, w, c);
}

int decode_png16(const char* path, uint16_t** out, int* h, int* w, int* c) {
  return decode_png_into<uint16_t>(path, true, out, h, w, c);
}

// Encode 8-bit BGR/BGRA/gray as libpng does under the JAX package's
// settings.  Level <= 1: the UP filter on every row and Z_RLE, the JAX
// package's recipe (row filtering is what makes RLE compress photographic
// rows; UP runs one pass per row where the adaptive choice tries five).
// Levels >= 2: all five filters chosen per row and libpng's Z_FILTERED.
int encode_png(const char* path, const uint8_t* data, int h, int w, int c,
               int compression_level) {
  FilePtr fp(fopen(path, "wb"));
  if (!fp) return IMG_ERR_OPEN;
  const int color = c == 1 ? 0 : c == 3 ? 2 : c == 4 ? 6 : -1;
  if (color < 0) return IMG_ERR_UNSUPPORTED;
  if (h <= 0 || w <= 0 || (uint32_t)h > kMaxSide || (uint32_t)w > kMaxSide) return IMG_ERR_ENCODE;

  const size_t n = (size_t)w * c;
  // png_write_start_row: the filter set, less those a single row or a
  // single column makes pointless
  int filters = compression_level <= 1 ? F_UP : (F_NONE | F_SUB | F_UP | F_AVG | F_PAETH);
  if (h == 1) filters &= ~(F_UP | F_AVG | F_PAETH);
  if (w == 1) filters &= ~(F_SUB | F_AVG | F_PAETH);
  if (filters == 0) filters = F_NONE;
  // png_deflate_claim: the strategy, and the window for a small image
  const int strategy = compression_level <= 1 ? Z_RLE
                       : filters != F_NONE     ? Z_FILTERED
                                               : Z_DEFAULT_STRATEGY;
  PngWriter wr;
  wr.fp = fp.get();
  wr.image_size = n < 32768 && h < 32768 ? (n + 1) * (size_t)h : 0xffffffffu;
  int window_bits = 15;
  if (wr.image_size <= 16384) {
    unsigned half = 1u << (window_bits - 1);
    while (wr.image_size + 262 <= half) { half >>= 1; --window_bits; }
  }

  uint8_t ihdr[13];
  put32(ihdr, (uint32_t)w);
  put32(ihdr + 4, (uint32_t)h);
  ihdr[8] = 8; ihdr[9] = (uint8_t)color; ihdr[10] = ihdr[11] = ihdr[12] = 0;
  if (fwrite(kSignature, 1, 8, fp.get()) != 8 || !wr.chunk(kIHDR, ihdr, 13))
    return IMG_ERR_ENCODE;

  z_stream zs{};
  if (deflateInit2(&zs, compression_level, Z_DEFLATED, window_bits, 8, strategy) != Z_OK)
    return IMG_ERR_ENCODE;
  std::unique_ptr<z_stream, int (*)(z_stream*)> zguard(&zs, deflateEnd);
  zs.next_out = wr.zbuf;
  zs.avail_out = kZbufSize;

  // rows with their filter byte: the current and previous (RGB order, as
  // png_set_bgr leaves them), and one per filter tried
  std::unique_ptr<uint8_t[]> mem(new (std::nothrow) uint8_t[6 * (n + 1)]);
  if (!mem) return IMG_ERR_ENCODE;
  uint8_t* cur = mem.get();
  uint8_t* prev = cur + (n + 1);
  uint8_t* const tries[4] = {prev + (n + 1), prev + 2 * (n + 1), prev + 3 * (n + 1),
                             prev + 4 * (n + 1)};
  memset(prev, 0, n + 1);
  cur[0] = 0;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = data + (size_t)y * n;
    uint8_t* r = cur + 1;
    if (c == 1) {
      memcpy(r, src, n);
    } else if (c == 3) {
      for (size_t i = 0; i < n; i += 3) {
        r[i] = src[i + 2]; r[i + 1] = src[i + 1]; r[i + 2] = src[i];
      }
    } else {
      for (size_t i = 0; i < n; i += 4) {
        r[i] = src[i + 2]; r[i + 1] = src[i + 1]; r[i + 2] = src[i]; r[i + 3] = src[i + 3];
      }
    }
    const uint8_t* out = choose_filter(filters, cur, prev, n, (size_t)c, tries);
    if (!wr.compress(zs, out, n + 1, Z_NO_FLUSH)) return IMG_ERR_ENCODE;
    uint8_t* t = prev; prev = cur; cur = t;
  }
  if (!wr.compress(zs, nullptr, 0, Z_FINISH) || !wr.chunk(kIEND, nullptr, 0))
    return IMG_ERR_ENCODE;
  if (fclose(fp.release()) != 0) return IMG_ERR_ENCODE;
  return IMG_OK;
}

// ---------------------------------------------------------------------------
// JPEG decode (always 8-bit; grayscale or BGR), where libjpeg is built in
// ---------------------------------------------------------------------------

#ifdef INNFER_WITH_JPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = (JpegErr*)cinfo->err;
  longjmp(err->jb, 1);
}

int decode_jpeg(const char* path, uint8_t** out, int* h, int* w, int* c) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return IMG_ERR_OPEN;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  // volatile: assigned after setjmp, read in the handler — without it the
  // longjmp restores the setjmp-time nullptr and the scanline buffer leaks
  // on every corrupt file (formally UB to read otherwise)
  uint8_t* volatile buf = nullptr;

  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    free(buf);
    return IMG_ERR_DECODE;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
#ifdef JCS_EXTENSIONS
  cinfo.out_color_space = cinfo.num_components == 1 ? JCS_GRAYSCALE : JCS_EXT_BGR;
#endif
  jpeg_start_decompress(&cinfo);

  int height = (int)cinfo.output_height;
  int width = (int)cinfo.output_width;
  int channels = (int)cinfo.output_components;
  size_t stride = (size_t)width * channels;
  buf = (uint8_t*)malloc((size_t)height * stride);
  if (!buf) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return IMG_ERR_DECODE;
  }

  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);

#ifndef JCS_EXTENSIONS
  // plain libjpeg emits RGB; swap to BGR in place for cv2 parity
  if (channels == 3) {
    for (size_t i = 0; i + 2 < (size_t)height * stride; i += 3) {
      uint8_t t = buf[i];
      buf[i] = buf[i + 2];
      buf[i + 2] = t;
    }
  }
#endif

  *out = buf;
  *h = height;
  *w = width;
  *c = channels;
  return IMG_OK;
}

int codec_has_jpeg(void) { return 1; }

#else

int decode_jpeg(const char*, uint8_t**, int*, int*, int*) { return IMG_ERR_UNSUPPORTED; }

int codec_has_jpeg(void) { return 0; }

#endif  // INNFER_WITH_JPEG

// zlib's version at run time, for the library's version()
const char* codec_zlib_version(void) { return zlibVersion(); }

void free_image(uint8_t* p) { free(p); }

}  // extern "C"
