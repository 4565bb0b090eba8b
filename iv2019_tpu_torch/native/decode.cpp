// Native JPEG/PNG decode for the host input pipeline (ctypes, GIL-free).
//
// The reference delegates image decode to TF's C++ runtime
// (input_cityscapes.py:38-62 tf.image.decode_image); here decode is the
// last GIL-holding stage of the host pipeline (PIL), so a many-core host
// cannot scale the decode pool past ~1 effective core. These kernels decode
// through the system libjpeg/libpng and are called via ctypes, which
// releases the GIL for the full call — the pipeline's thread pool then
// scales decode across cores like every other native stage in fastops.cpp.
//
// Output parity contract (tests/test_native.py oracle = PIL):
//   raw mode (force_rgb=0): exactly np.asarray(Image.open(buf)) for
//     8-bit images — gray -> 1ch, gray+alpha -> 2ch, palette -> 1ch of
//     indices (labels!), RGB -> 3ch, RGBA -> 4ch; JPEG gray -> 1ch,
//     color -> 3ch RGB.
//   rgb mode (force_rgb=1): 3-channel RGB — palette expanded, gray
//     replicated, alpha dropped (PIL convert("RGB") drops alpha the same
//     way for PNG).
// 16-bit PNGs and exotic spaces return an error -> caller falls back to
// PIL, so correctness never depends on this fast path.

#include <csetjmp>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE declared
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- PNG ----

struct MemReader {
  const uint8_t* data;
  size_t size;
  size_t off;
};

void png_mem_read(png_structp p, png_bytep out, png_size_t n) {
  MemReader* r = static_cast<MemReader*>(png_get_io_ptr(p));
  if (r->off + n > r->size) png_error(p, "unexpected EOF");
  std::memcpy(out, r->data + r->off, n);
  r->off += n;
}

// Shared info+decode: with out == nullptr only dimensions are computed.
int png_decode_impl(const uint8_t* data, int64_t len, int force_rgb, int* h,
                    int* w, int* c, uint8_t* out) {
  png_structp p =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!p) return 2;
  png_infop info = png_create_info_struct(p);
  if (!info) {
    png_destroy_read_struct(&p, nullptr, nullptr);
    return 2;
  }
  // libpng reports errors via longjmp; rows is outside the setjmp scope so
  // its destructor is not skipped on the error path
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(p))) {
    png_destroy_read_struct(&p, &info, nullptr);
    return 3;
  }
  MemReader r{data, static_cast<size_t>(len), 0};
  png_set_read_fn(p, &r, png_mem_read);
  png_read_info(p, info);

  png_uint_32 W = 0, H = 0;
  int bit_depth = 0, color_type = 0;
  png_get_IHDR(p, info, &W, &H, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (bit_depth == 16) {  // PIL yields uint16 here; defer to PIL
    png_destroy_read_struct(&p, &info, nullptr);
    return 4;
  }
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(p);
  if (bit_depth < 8) png_set_packing(p);  // 1/2/4-bit palette -> 8-bit index
  if (force_rgb) {
    if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(p);
    if (color_type == PNG_COLOR_TYPE_GRAY ||
        color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(p);
    png_set_strip_alpha(p);
  }
  int passes = png_set_interlace_handling(p);
  (void)passes;
  png_read_update_info(p, info);

  *h = static_cast<int>(H);
  *w = static_cast<int>(W);
  *c = png_get_channels(p, info);
  if (out) {
    const size_t rowbytes = png_get_rowbytes(p, info);
    rows.resize(H);
    for (png_uint_32 y = 0; y < H; ++y)
      rows[y] = out + static_cast<size_t>(y) * rowbytes;
    png_read_image(p, rows.data());
  }
  png_destroy_read_struct(&p, &info, nullptr);
  return 0;
}

// --------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(e->jb, 1);
}

int jpeg_decode_impl(const uint8_t* data, int64_t len, int force_rgb, int* h,
                     int* w, int* c, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  if (force_rgb) cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  *c = cinfo.output_components;
  if (out) {
    jpeg_start_decompress(&cinfo);
    const size_t stride =
        static_cast<size_t>(cinfo.output_width) * cinfo.output_components;
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int dispatch(const uint8_t* data, int64_t len, int force_rgb, int* h, int* w,
             int* c, uint8_t* out) {
  if (len >= 8 && !png_sig_cmp(data, 0, 8))
    return png_decode_impl(data, len, force_rgb, h, w, c, out);
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF)
    return jpeg_decode_impl(data, len, force_rgb, h, w, c, out);
  return 1;  // unknown format (ppm etc.) -> PIL fallback
}

}  // namespace

extern "C" {

// Header-only parse: fills (h, w, c) for the would-be decode. Returns 0 on
// success; any nonzero value means "use the PIL fallback".
int decode_info(const uint8_t* data, int64_t len, int force_rgb, int* h,
                int* w, int* c) {
  return dispatch(data, len, force_rgb, h, w, c, nullptr);
}

// Full decode into a caller-allocated (h, w, c) uint8 buffer sized from
// decode_info. Returns 0 on success.
int decode_u8(const uint8_t* data, int64_t len, int force_rgb, uint8_t* out) {
  int h, w, c;
  return dispatch(data, len, force_rgb, &h, &w, &c, out);
}

}  // extern "C"
