// Native image codec: PNG/JPEG decode + PNG encode, C ABI for ctypes.
// The port's copy of the JAX package's runtime/src/imgcodec.cpp, with the
// same entry points and the same results (bytes written included).
//
// The reference reaches native decode only through OpenCV (its
// utils/utils.py:68-95); this thin codec keeps the hot I/O path off
// cv2's Python layer and runs inside the prefetch loader (loader.cpp).
//
// Conventions match cv2.imread(IMREAD_UNCHANGED) for the supported subset:
// 8-bit PNG/JPEG -> HWC BGR(A) uint8 buffers, 16-bit PNG -> uint16 through
// decode_png16.  Other formats return a "not supported" code and the
// Python layer falls back to cv2.

#include <png.h>
#include <jpeglib.h>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Error codes
enum {
  IMG_OK = 0,
  IMG_ERR_OPEN = -1,
  IMG_ERR_DECODE = -2,
  IMG_ERR_UNSUPPORTED = -3,
  IMG_ERR_ENCODE = -4,
};

// ---------------------------------------------------------------------------
// PNG decode (8-bit only; 16-bit reported as unsupported for cv2 fallback)
// ---------------------------------------------------------------------------

int decode_png(const char* path, uint8_t** out, int* h, int* w, int* c) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return IMG_ERR_OPEN;

  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { fclose(fp); return IMG_ERR_DECODE; }
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); fclose(fp); return IMG_ERR_DECODE; }

  // volatile: assigned between setjmp and a potential longjmp (a truncated
  // file longjmps out of png_read_image) — the handler must see the final
  // values to free them, not leak per corrupt file
  uint8_t* volatile buf = nullptr;
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    free(rows);
    free(buf);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return IMG_ERR_DECODE;
  }

  png_init_io(png, fp);
  png_read_info(png, info);

  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);
  if (bit_depth == 16) {  // 16-bit path is decode_png16
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return IMG_ERR_UNSUPPORTED;
  }

  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  // match cv2: BGR channel order.  Palette images become RGB via
  // png_set_palette_to_rgb, so they need the swap too.
  if (color_type == PNG_COLOR_TYPE_RGB || color_type == PNG_COLOR_TYPE_RGB_ALPHA ||
      color_type == PNG_COLOR_TYPE_PALETTE)
    png_set_bgr(png);
  png_read_update_info(png, info);

  int height = (int)png_get_image_height(png, info);
  int width = (int)png_get_image_width(png, info);
  int channels = (int)png_get_channels(png, info);
  size_t stride = (size_t)width * channels;

  buf = (uint8_t*)malloc((size_t)height * stride);
  if (!buf) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return IMG_ERR_DECODE;
  }
  rows = (png_bytep*)malloc(sizeof(png_bytep) * height);
  if (!rows) {
    free(buf);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return IMG_ERR_DECODE;
  }
  for (int y = 0; y < height; ++y) rows[y] = buf + (size_t)y * stride;
  png_read_image(png, rows);
  free(rows);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);

  *out = buf;
  *h = height;
  *w = width;
  *c = channels;
  return IMG_OK;
}

// ---------------------------------------------------------------------------
// PNG 16-bit decode (cv2 IMREAD_UNCHANGED parity: HWC BGR(A) uint16,
// native little-endian byte order)
// ---------------------------------------------------------------------------

int decode_png16(const char* path, uint16_t** out, int* h, int* w, int* c) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return IMG_ERR_OPEN;

  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { fclose(fp); return IMG_ERR_DECODE; }
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); fclose(fp); return IMG_ERR_DECODE; }

  uint16_t* volatile buf = nullptr;  // see decode_png: freed on longjmp
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    free(rows);
    free(buf);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return IMG_ERR_DECODE;
  }

  png_init_io(png, fp);
  png_read_info(png, info);

  if (png_get_bit_depth(png, info) != 16) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return IMG_ERR_UNSUPPORTED;  // 8-bit path is decode_png
  }
  int color_type = png_get_color_type(png, info);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_RGB || color_type == PNG_COLOR_TYPE_RGB_ALPHA)
    png_set_bgr(png);
  png_set_swap(png);  // libpng yields big-endian 16-bit; we want native LE
  png_read_update_info(png, info);

  int height = (int)png_get_image_height(png, info);
  int width = (int)png_get_image_width(png, info);
  int channels = (int)png_get_channels(png, info);
  size_t stride = (size_t)width * channels * 2;

  buf = (uint16_t*)malloc((size_t)height * stride);
  if (!buf) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return IMG_ERR_DECODE;
  }
  rows = (png_bytep*)malloc(sizeof(png_bytep) * height);
  if (!rows) {
    free(buf);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return IMG_ERR_DECODE;
  }
  for (int y = 0; y < height; ++y)
    rows[y] = (png_bytep)((uint8_t*)buf + (size_t)y * stride);
  png_read_image(png, rows);
  free(rows);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);

  *out = buf;
  *h = height;
  *w = width;
  *c = channels;
  return IMG_OK;
}

// ---------------------------------------------------------------------------
// JPEG decode (always 8-bit; grayscale or BGR)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// PNG encode (8-bit BGR/BGRA/gray input, cv2-compatible)
// ---------------------------------------------------------------------------

int encode_png(const char* path, const uint8_t* data, int h, int w, int c,
               int compression_level) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return IMG_ERR_OPEN;

  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { fclose(fp); return IMG_ERR_ENCODE; }
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_write_struct(&png, nullptr); fclose(fp); return IMG_ERR_ENCODE; }

  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return IMG_ERR_ENCODE;
  }

  int color_type;
  switch (c) {
    case 1: color_type = PNG_COLOR_TYPE_GRAY; break;
    case 3: color_type = PNG_COLOR_TYPE_RGB; break;
    case 4: color_type = PNG_COLOR_TYPE_RGB_ALPHA; break;
    default:
      png_destroy_write_struct(&png, &info);
      fclose(fp);
      return IMG_ERR_UNSUPPORTED;
  }

  png_init_io(png, fp);
  png_set_IHDR(png, info, w, h, 8, color_type, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_set_compression_level(png, compression_level);
  if (compression_level <= 1) {
    // fast path: fixed UP row filter + Z_RLE at level 1, the JAX
    // package's recipe, so both packages write the same bytes.  Row
    // filtering is what makes RLE compress photographic rows (no filter
    // inflates natural images several times); UP alone runs one filter
    // pass per row where libpng's adaptive heuristic tries five (cv2's
    // default is level 1 + Z_RLE + adaptive).  Its time against cv2's on
    // the H100's host is in PERF.md.  Levels >= 2 keep adaptive filtering
    // and zlib's default strategy (density).
    png_set_filter(png, 0, PNG_FILTER_UP);
    png_set_compression_strategy(png, 3 /* Z_RLE */);
  }
  png_write_info(png, info);
  if (c >= 3) png_set_bgr(png);  // buffers are BGR like cv2

  size_t stride = (size_t)w * c;
  for (int y = 0; y < h; ++y) {
    png_write_row(png, (png_const_bytep)(data + (size_t)y * stride));
  }
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return IMG_OK;
}

void free_image(uint8_t* p) { free(p); }

}  // extern "C"
