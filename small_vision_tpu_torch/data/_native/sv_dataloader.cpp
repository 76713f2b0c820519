// Native data-loader core: fused JPEG decode + inception crop + resize.
//
// The port's copy of small_vision_tpu/data/_native/sv_dataloader.cpp, the
// counterpart of TensorFlow's decode_and_crop_jpeg after
// sample_distorted_bounding_box, in libjpeg behind a C ABI for ctypes:
//
//   - reads the JPEG header only, samples the GoogLeNet-style random
//     area/aspect crop box in source coordinates;
//   - decodes at the largest libjpeg scale_denom (1/2/4/8) that keeps the
//     crop at least as large as the output, so a 500 px JPEG headed for a
//     64 px training image decodes about 8x smaller;
//   - crops the scaled box and bilinear-resizes to the target.
//
// Thread-safety: every call uses its own decompress struct and RNG; the
// Python callers release the GIL during the call, and the batch entry
// point fans out over its own threads.
//
// Build: g++ -O3 -shared -fPIC -pthread sv_dataloader.cpp -o <lib>.so -ljpeg

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize (HWC uint8), half-pixel centers.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::clamp(static_cast<int>(std::floor(fy)), 0, sh - 1);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = std::clamp(fy - y0, 0.0f, 1.0f);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = std::clamp(static_cast<int>(std::floor(fx)), 0, sw - 1);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = std::clamp(fx - x0, 0.0f, 1.0f);
      for (int c = 0; c < 3; ++c) {
        float top = src[(y0 * sw + x0) * 3 + c] * (1 - wx) +
                    src[(y0 * sw + x1) * 3 + c] * wx;
        float bot = src[(y1 * sw + x0) * 3 + c] * (1 - wx) +
                    src[(y1 * sw + x1) * 3 + c] * wx;
        dst[(y * dw + x) * 3 + c] =
            static_cast<uint8_t>(std::lround(top * (1 - wy) + bot * wy));
      }
    }
  }
}

struct Box {
  int y0, x0, h, w;
};

// Distribution-faithful port of tf.image.sample_distorted_bounding_box's
// GenerateRandomCrop (sample_distorted_bounding_box_op.cc): LINEAR-uniform
// aspect ratio, then a uniform INTEGER height between the min/max heights
// implied by the area bounds; fall back to the full image. Must stay in
// sync with pp/ops_image.py _sample_inception_box.
Box sample_box(std::mt19937_64& rng, int h, int w, double area_min,
               double area_max, double ar_lo, double ar_hi,
               int max_attempts) {
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  const double min_area = area_min * h * w;
  const double max_area = area_max * h * w;
  for (int i = 0; i < max_attempts; ++i) {
    const double ar = ar_lo + (ar_hi - ar_lo) * unif(rng);
    long height = std::lrint(std::sqrt(min_area / ar));
    long max_height = std::lrint(std::sqrt(max_area / ar));
    if (std::lrint(max_height * ar) > w) {
      max_height = static_cast<long>((w + 0.5 - 1e-7) / ar);
      if (std::lrint(max_height * ar) > w) max_height -= 1;
    }
    if (max_height > h) max_height = h;
    if (height > max_height) height = max_height;
    if (height < max_height) {
      height += static_cast<long>(unif(rng) * (max_height - height + 1));
      if (height > max_height) height = max_height;
    }
    long width = std::lrint(height * ar);
    if (static_cast<double>(width) * height < min_area) {
      height += 1;
      width = std::lrint(height * ar);
    }
    if (static_cast<double>(width) * height > max_area) {
      height -= 1;
      width = std::lrint(height * ar);
    }
    const double area = static_cast<double>(width) * height;
    if (area < min_area || area > max_area || width > w || height > h ||
        width <= 0 || height <= 0) {
      continue;
    }
    // TF quirk: Uniform(H - h) EXCLUDES the flush-to-edge placement.
    int y0 = height < h ? static_cast<int>(unif(rng) * (h - height)) : 0;
    int x0 = width < w ? static_cast<int>(unif(rng) * (w - width)) : 0;
    y0 = std::min<int>(y0, h - static_cast<int>(height) - 1 >= 0
                               ? h - static_cast<int>(height) - 1 : 0);
    x0 = std::min<int>(x0, w - static_cast<int>(width) - 1 >= 0
                               ? w - static_cast<int>(width) - 1 : 0);
    return {y0, x0, static_cast<int>(height), static_cast<int>(width)};
  }
  return {0, 0, h, w};
}

}  // namespace

extern "C" {

// Returns 0 on success. out must hold out_h*out_w*3 bytes.
int sv_decode_inception_crop(const unsigned char* data, size_t len,
                             int out_h, int out_w, double area_min,
                             double area_max, double ar_lo, double ar_hi,
                             int max_attempts, uint64_t seed,
                             unsigned char* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }

  const int full_h = cinfo.image_height, full_w = cinfo.image_width;
  std::mt19937_64 rng(seed);
  Box box = (area_max >= 1.0 && area_min >= 1.0)
                ? Box{0, 0, full_h, full_w}
                : sample_box(rng, full_h, full_w, area_min, area_max, ar_lo,
                             ar_hi, max_attempts);

  // Largest denom in {1,2,4,8} keeping the scaled crop >= output size.
  int denom = 1;
  for (int d : {8, 4, 2}) {
    if (box.h / d >= out_h && box.w / d >= out_w) {
      denom = d;
      break;
    }
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;  // INTEGER_ACCURATE, as TensorFlow.
  jpeg_start_decompress(&cinfo);

  const int sw = cinfo.output_width, sh = cinfo.output_height;
  std::vector<uint8_t> scaled(static_cast<size_t>(sh) * sw * 3);
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = scaled.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // Crop box in scaled coordinates (clamped).
  int cy0 = std::min(box.y0 / denom, sh - 1);
  int cx0 = std::min(box.x0 / denom, sw - 1);
  int ch = std::max(1, std::min(box.h / denom, sh - cy0));
  int cw = std::max(1, std::min(box.w / denom, sw - cx0));

  std::vector<uint8_t> crop(static_cast<size_t>(ch) * cw * 3);
  for (int y = 0; y < ch; ++y) {
    std::memcpy(crop.data() + static_cast<size_t>(y) * cw * 3,
                scaled.data() + (static_cast<size_t>(cy0 + y) * sw + cx0) * 3,
                static_cast<size_t>(cw) * 3);
  }
  resize_bilinear(crop.data(), ch, cw, out, out_h, out_w);
  return 0;
}

// Batch variant with an in-library thread pool: one GIL release (ctypes)
// covers the whole batch, and the fan-out happens in C++ (std::thread over
// an atomic work index), so scaling is not capped by Python call overhead.
// datas/lens/seeds are n-element arrays; out holds n*out_h*out_w*3 bytes;
// rcs[i] receives the per-image status (0 = ok). n_threads<=0 → hardware
// concurrency. Always returns 0.
int sv_decode_inception_crop_batch(const unsigned char* const* datas,
                                   const size_t* lens, int n, int out_h,
                                   int out_w, double area_min,
                                   double area_max, double ar_lo,
                                   double ar_hi, int max_attempts,
                                   const uint64_t* seeds, unsigned char* out,
                                   int* rcs, int n_threads) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  std::atomic<int> next{0};
  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      rcs[i] = sv_decode_inception_crop(datas[i], lens[i], out_h, out_w,
                                        area_min, area_max, ar_lo, ar_hi,
                                        max_attempts, seeds[i],
                                        out + stride * i);
    }
  };
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = n_threads > 0 ? n_threads : (hw > 0 ? hw : 8);
  nt = std::max(1, std::min(nt, n));
  if (nt == 1) {
    worker();
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

// Plain decode (full image) to a caller-allocated buffer of h*w*3; the
// caller first obtains dims via sv_jpeg_dims.
int sv_jpeg_dims(const unsigned char* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int sv_decode(const unsigned char* data, size_t len, unsigned char* out) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
