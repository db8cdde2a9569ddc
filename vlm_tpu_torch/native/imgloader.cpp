// Native image loading: threaded JPEG/PNG decode + antialiased bicubic
// resize/center-crop, exported over a C ABI for ctypes.
//
// A std::thread pool decodes and resizes straight into the caller's uint8
// batch buffer, with no Python in the loop, so that host decode overlaps
// device work when it runs on the prefetch thread of
// `vlm_tpu_torch.data.pipeline`. JPEGs decode through libjpeg with DCT
// prescaling, PNGs through libpng (grey, palette and interlaced images
// expand to RGB).
//
// Resampling follows PIL's convolution resampling (bicubic kernel a=-0.5,
// scale-aware support for antialiasing on downscale), so outputs track the
// PIL/HF preprocessing closely; the byte-exact PIL path stays available in
// `vlm_tpu_torch.ops.preprocess.host_resize`.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cctype>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------- JPEG decode -----------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG file to RGB. Uses libjpeg's DCT prescaling (1/2, 1/4, 1/8)
// when the target is much smaller than the source - decoding at reduced
// resolution is the single biggest win for thumbnail-style pipelines.
bool decode_jpeg(const char* path, int min_target, std::vector<uint8_t>* out,
                 int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // Prescale: keep the shorter decoded edge >= 2x the target so the
  // bicubic pass still has headroom for quality.
  if (min_target > 0) {
    int shorter = std::min(static_cast<int>(cinfo.image_width),
                           static_cast<int>(cinfo.image_height));
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    while (cinfo.scale_denom < 8 &&
           shorter / (cinfo.scale_denom * 2) >= 2 * min_target) {
      cinfo.scale_denom *= 2;
    }
  }

  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  // Decompression-bomb guard (PIL's MAX_IMAGE_PIXELS default): a corrupt
  // header declaring absurd dimensions must fail the file, not the process.
  if (*w <= 0 || *h <= 0 ||
      static_cast<int64_t>(*w) * *h > 178956970LL) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  const int stride = *w * 3;
  out->resize(static_cast<size_t>(stride) * *h);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
        static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// ----------------------------- PNG decode -----------------------------

// Decode a PNG file to 8-bit RGB (alpha stripped, palette/gray expanded).
bool decode_png(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  uint8_t sig[8];
  if (std::fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) {
    std::fclose(f);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) {
    std::fclose(f);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_set_expand(png);               // palette/gray/low-bit -> 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  // Interlaced PNGs need multiple row passes with png_read_row.
  const int passes = png_set_interlace_handling(png);
  png_read_update_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  if (*w <= 0 || *h <= 0 ||
      static_cast<int64_t>(*w) * *h > 178956970LL) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return false;
  }
  const size_t stride = static_cast<size_t>(*w) * 3;
  out->resize(stride * *h);
  // Row-by-row reads into the caller's buffer: no locals with non-trivial
  // destructors live between setjmp and a potential png_error longjmp
  // (jumping over such a local is UB and leaks its allocation).
  for (int p = 0; p < passes; ++p) {
    for (int y = 0; y < *h; ++y) {
      png_read_row(png, out->data() + y * stride, nullptr);
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  return true;
}

// ----------------------------- resampling -----------------------------

// PIL-style bicubic (Catmull-Rom family, a = -0.5), support 2.
inline double bicubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct WeightTable {
  std::vector<int> bounds;      // [out_size * 2]: (start, count)
  std::vector<double> weights;  // [out_size * ksize]
  int ksize;
};

// Precompute convolution weights for one axis (PIL's precompute_coeffs:
// scale-aware support => antialiasing on downscale).
WeightTable make_weights(int in_size, int out_size, double offset,
                         double span) {
  WeightTable t;
  double scale = span / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 2.0 * filterscale;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.bounds.resize(out_size * 2);
  t.weights.assign(static_cast<size_t>(out_size) * t.ksize, 0.0);

  for (int i = 0; i < out_size; ++i) {
    double center = offset + (i + 0.5) * scale;
    int xmin = std::max(0, static_cast<int>(center - support + 0.5));
    int xmax = std::min(in_size, static_cast<int>(center + support + 0.5));
    double* w = &t.weights[static_cast<size_t>(i) * t.ksize];
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double v = bicubic((x + 0.5 - center) / filterscale);
      w[x - xmin] = v;
      total += v;
    }
    if (total != 0.0) {
      for (int x = 0; x < xmax - xmin; ++x) w[x] /= total;
    }
    t.bounds[i * 2] = xmin;
    t.bounds[i * 2 + 1] = xmax - xmin;
  }
  return t;
}

inline uint8_t clip8(double v) {
  return static_cast<uint8_t>(std::min(255.0, std::max(0.0, v + 0.5)));
}

// Separable resize of an RGB image region to out_w x out_h.
// (box_x0, box_y0, box_w, box_h) selects the source region (for center crop
// fused into the resample, like PIL's resize(box=...)).
void resize_rgb(const uint8_t* src, int sw, int sh, double box_x0,
                double box_y0, double box_w, double box_h, uint8_t* dst,
                int out_w, int out_h) {
  WeightTable wx = make_weights(sw, out_w, box_x0, box_w);
  WeightTable wy = make_weights(sh, out_h, box_y0, box_h);

  // The vertical pass only reads source rows inside the crop box's
  // support; restrict the horizontal pass to those rows (PIL does the
  // same) — a tall source with a small center crop would otherwise burn
  // ~sh/box_h times the work.
  int y_lo = sh, y_hi = 0;
  for (int j = 0; j < out_h; ++j) {
    y_lo = std::min(y_lo, wy.bounds[j * 2]);
    y_hi = std::max(y_hi, wy.bounds[j * 2] + wy.bounds[j * 2 + 1]);
  }
  y_lo = std::max(0, y_lo);
  y_hi = std::min(sh, std::max(y_hi, y_lo));
  const int rows_used = y_hi - y_lo;

  // horizontal pass: src rows [y_lo, y_hi) -> tmp [rows_used, out_w, 3]
  std::vector<double> tmp(static_cast<size_t>(rows_used) * out_w * 3);
  for (int y = y_lo; y < y_hi; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    double* trow = &tmp[static_cast<size_t>(y - y_lo) * out_w * 3];
    for (int i = 0; i < out_w; ++i) {
      int xmin = wx.bounds[i * 2];
      int cnt = wx.bounds[i * 2 + 1];
      const double* w = &wx.weights[static_cast<size_t>(i) * wx.ksize];
      double r = 0, g = 0, b = 0;
      for (int k = 0; k < cnt; ++k) {
        const uint8_t* p = row + static_cast<size_t>(xmin + k) * 3;
        r += p[0] * w[k];
        g += p[1] * w[k];
        b += p[2] * w[k];
      }
      trow[i * 3] = r;
      trow[i * 3 + 1] = g;
      trow[i * 3 + 2] = b;
    }
  }
  // vertical pass: tmp -> dst [out_h, out_w, 3]
  for (int j = 0; j < out_h; ++j) {
    int ymin = wy.bounds[j * 2];
    int cnt = wy.bounds[j * 2 + 1];
    const double* w = &wy.weights[static_cast<size_t>(j) * wy.ksize];
    uint8_t* drow = dst + static_cast<size_t>(j) * out_w * 3;
    for (int i = 0; i < out_w; ++i) {
      double r = 0, g = 0, b = 0;
      for (int k = 0; k < cnt; ++k) {
        const double* p =
            &tmp[(static_cast<size_t>(ymin + k - y_lo) * out_w + i) * 3];
        r += p[0] * w[k];
        g += p[1] * w[k];
        b += p[2] * w[k];
      }
      drow[i * 3] = clip8(r);
      drow[i * 3 + 1] = clip8(g);
      drow[i * 3 + 2] = clip8(b);
    }
  }
}

// One image: decode + recipe resize into dst [size, size, 3].
// mode 0 = warp (SigLIP/BLIP-2), mode 1 = shortest-edge + center crop (CLIP).
bool has_suffix(const char* path, const char* suf) {
  const std::string s(path);
  std::string l(s);
  for (auto& c : l) c = std::tolower(c);
  const std::string t(suf);
  return l.size() >= t.size() && l.compare(l.size() - t.size(), t.size(), t) == 0;
}

bool load_one(const char* path, int size, int mode, uint8_t* dst) {
  std::vector<uint8_t> img;
  int w = 0, h = 0;
  bool ok = has_suffix(path, ".png")
                ? decode_png(path, &img, &w, &h)
                : decode_jpeg(path, size, &img, &w, &h);
  if (!ok) return false;
  if (mode == 0) {
    resize_rgb(img.data(), w, h, 0.0, 0.0, w, h, dst, size, size);
  } else {
    // scale shortest edge to `size`, crop the center square in source
    // coordinates and resample it directly (one pass).
    double short_edge = std::min(w, h);
    double box = short_edge;  // source square that maps onto size x size
    double x0 = (w - box) / 2.0;
    double y0 = (h - box) / 2.0;
    resize_rgb(img.data(), w, h, x0, y0, box, box, dst, size, size);
  }
  return true;
}

}  // namespace

extern "C" {

// Decode + preprocess a batch of JPEG files into out [n, size, size, 3]
// uint8 with `threads` workers. Returns the number of failures; failed
// slots are zero-filled and flagged in `ok` (len n) if non-null.
int vlm_load_batch(const char** paths, int n, int size, int mode,
                   int threads, uint8_t* out, uint8_t* ok) {
  const size_t stride = static_cast<size_t>(size) * size * 3;
  std::atomic<int> next(0), failures(0);
  threads = std::max(1, threads);
  std::vector<std::thread> pool;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      bool good;
      try {
        good = load_one(paths[i], size, mode, out + stride * i);
      } catch (...) {
        // An exception escaping a std::thread entry is std::terminate —
        // a single corrupt file (e.g. bad_alloc on absurd declared
        // dimensions) must flag its slot, not kill the process.
        good = false;
      }
      if (!good) {
        std::memset(out + stride * i, 0, stride);
        failures.fetch_add(1);
      }
      if (ok) ok[i] = good ? 1 : 0;
    }
  };
  int nt = std::min(threads, n);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
