// Native ImageNet batch decoder of the port (mx_quantization_tpu_torch/
// native/dataloader.py): JPEG decode (libjpeg), a bilinear short-side
// resize to size / 0.875, a centre crop, the ImageNet normalization and
// the CHW layout, on a std::thread pool so that the host's decode overlaps
// the card's compute.  The same code as the JAX package's
// mx_quantization_tpu/native/dataloader.cpp, so the two decode every file
// to the same floats; a plain C interface loaded with ctypes.
//
// Build (native/build.py, at first use): g++ -O3 -shared -fPIC -std=c++17
//   dataloader.cpp -o libmxdataloader.so -lpthread -ljpeg

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file into an RGB8 buffer.  Returns false on failure.
bool decode_jpeg(const char* path, std::vector<uint8_t>* rgb, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear sample of channel c at float coords (x, y).
inline float bilinear(const uint8_t* img, int w, int h, float x, float y,
                      int c) {
  int x0 = (int)floorf(x), y0 = (int)floorf(y);
  int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
  int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
  if (x0 < 0) x0 = 0;
  if (y0 < 0) y0 = 0;
  float fx = x - x0, fy = y - y0;
  auto at = [&](int yy, int xx) {
    return (float)img[(size_t(yy) * w + xx) * 3 + c];
  };
  return at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy) +
         at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy;
}

// Decode one file -> normalized CHW float tensor (3, size, size).
bool load_one(const char* path, int size, const float* mean, const float* std,
              float* out) {
  std::vector<uint8_t> rgb;
  int w, h;
  if (!decode_jpeg(path, &rgb, &w, &h)) return false;

  // short side -> size/0.875, then center crop size x size (timm eval)
  int resize = (int)(size / 0.875f + 0.5f);
  float scale = (w < h) ? (float)resize / w : (float)resize / h;
  int nw = (int)(w * scale + 0.5f), nh = (int)(h * scale + 0.5f);
  float left = (nw - size) / 2.0f, top = (nh - size) / 2.0f;

  for (int c = 0; c < 3; ++c) {
    float inv_std = 1.0f / std[c];
    float* dst = out + size_t(c) * size * size;
    for (int y = 0; y < size; ++y) {
      float sy = (top + y + 0.5f) / scale - 0.5f;
      for (int x = 0; x < size; ++x) {
        float sx = (left + x + 0.5f) / scale - 0.5f;
        float v = bilinear(rgb.data(), w, h, sx, sy, c) / 255.0f;
        dst[size_t(y) * size + x] = (v - mean[c]) * inv_std;
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decode `n` files into out (n, 3, size, size) float32.  ok[i]=1 on success.
// Uses `threads` worker threads (0 => hardware concurrency).
void mx_decode_batch(const char** paths, int n, int size, const float* mean,
                     const float* std, float* out, uint8_t* ok, int threads) {
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  if (threads < 1) threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* dst = out + size_t(i) * 3 * size * size;
      ok[i] = load_one(paths[i], size, mean, std, dst) ? 1 : 0;
      if (!ok[i]) memset(dst, 0, sizeof(float) * 3 * size * size);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // extern "C"
