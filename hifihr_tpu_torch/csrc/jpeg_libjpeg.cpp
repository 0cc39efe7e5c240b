// JPEG decode to RGB uint8 through libjpeg, host side.
//
// The port's own copy of decode_jpeg in native/imgproc.cpp (lines 28-70
// there): the same decompression settings (JCS_RGB output, libjpeg's default
// IDCT and upsampling), so a build on one host gives the JAX package's bytes.
// One change: libjpeg's default error handler calls exit() on a corrupt
// stream; here it jumps back and decode_jpeg returns 3, so the caller raises.
// data/native.py builds it at first use with
// `g++ -O3 -march=native -shared -fPIC ... -ljpeg` where jpeglib.h and
// libjpeg are installed; elsewhere the loaders decode with Pillow.

#include <csetjmp>
#include <cstdio>  // jpeglib.h needs FILE declared first

#include <jpeglib.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrorJump {
  jpeg_error_mgr mgr;  // first member: libjpeg hands back a jpeg_error_mgr*
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  (*cinfo->err->output_message)(cinfo);
  longjmp(reinterpret_cast<ErrorJump*>(cinfo->err)->jump, 1);
}

}  // namespace

extern "C" {

// Decode one JPEG buffer to RGB uint8. Returns 0 on success, 1 for a bad
// header, 2 for an image larger than max_h x max_w, 3 for a corrupt stream.
// out must hold max_h*max_w*3 bytes; rows are written densely (stride w*3)
// and the actual dims go to *h/*w.
int decode_jpeg(const uint8_t* data, long size, uint8_t* out, int max_h,
                int max_w, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorJump jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = error_exit;
  // volatile: longjmp must not restore a stale register copy
  std::vector<uint8_t>* volatile row_holder = nullptr;
  if (setjmp(jerr.jump)) {
    delete row_holder;
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int H = cinfo.output_height, W = cinfo.output_width;
  if (H > max_h || W > max_w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *h = H;
  *w = W;
  row_holder = new std::vector<uint8_t>(W * cinfo.output_components);
  std::vector<uint8_t>& row = *row_holder;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rp = row.data();
    jpeg_read_scanlines(&cinfo, &rp, 1);
    int y = cinfo.output_scanline - 1;
    if (cinfo.output_components == 3) {
      std::memcpy(out + (size_t)y * W * 3, row.data(), W * 3);
    } else {  // grayscale -> replicate
      for (int x = 0; x < W; x++) {
        uint8_t v = row[x];
        out[((size_t)y * W + x) * 3 + 0] = v;
        out[((size_t)y * W + x) * 3 + 1] = v;
        out[((size_t)y * W + x) * 3 + 2] = v;
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  delete row_holder;
  return 0;
}

}  // extern "C"
