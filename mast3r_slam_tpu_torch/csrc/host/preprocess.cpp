// Host-side frame ingest for the PyTorch/CUDA port: the JAX package's
// native/preprocess.cpp, kept as the port's own copy, plus the PNG row
// filters.  Three plain C entry points, bound with ctypes by
// mast3r_slam_tpu_torch/utils/native.py, which builds this file with the
// host C++ compiler at first use:
//
//   preprocess_frame  separable Lanczos-3 resize to the long side, centre
//                     crop to multiples of 16, fused [-1, 1] CHW
//                     normalisation (the 512 path of utils/image.resize_img);
//   remap_bilinear    cv2.remap-style bilinear undistortion (CV_32FC1 maps);
//   png_unfilter      undo the five PNG row filters of a non-interlaced
//                     8-bit image (data/png.py inflates, this reconstructs).
//
// The resize and remap run on up to 16 threads; the unfilter is serial
// (each row reads the one above it).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

inline double lanczos3(double x) {
  if (x == 0.0) return 1.0;
  if (x <= -3.0 || x >= 3.0) return 0.0;
  const double px = kPi * x;
  return 3.0 * std::sin(px) * std::sin(px / 3.0) / (px * px);
}

struct FilterBank {
  // For each output index: start input index + normalized weights.
  std::vector<int> start;
  std::vector<int> size;
  std::vector<float> weights;  // flattened [out][size]
  int max_size = 0;
};

// Separable resampling coefficients, support scaled for downscaling
// (standard Lanczos-3 resize, support*scale taps).
FilterBank build_filter(int in_size, int out_size) {
  FilterBank fb;
  fb.start.resize(out_size);
  fb.size.resize(out_size);
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 3.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  fb.weights.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  fb.max_size = ksize;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double sum = 0.0;
    float* w = &fb.weights[static_cast<size_t>(xx) * ksize];
    for (int x = xmin; x < xmax; ++x) {
      const double ww = lanczos3((x - center + 0.5) / filterscale);
      w[x - xmin] = static_cast<float>(ww);
      sum += ww;
    }
    if (sum != 0.0) {
      for (int x = 0; x < xmax - xmin; ++x) w[x] /= static_cast<float>(sum);
    }
    fb.start[xx] = xmin;
    fb.size[xx] = xmax - xmin;
  }
  return fb;
}

void parallel_for(int n, const std::function<void(int, int)>& fn) {
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const int n_threads = static_cast<int>(std::min<unsigned>(hw, 16));
  if (n_threads <= 1 || n < 64) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> workers;
  const int chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int lo = t * chunk;
    const int hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(fn, lo, hi);
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Resize an HxWx3 uint8 RGB image to outH x outW (Lanczos-3), then emit:
//   out_chw:  3 x cropH x cropW float32, normalized (v/255 - 0.5) / 0.5
//   out_rgb:  cropH x cropW x 3 uint8 (the "unnormalized" crop)
// where (cropH, cropW) are outH, outW rounded DOWN to multiples of 16 and the
// crop is centered (matching resize_img's crop rule for the 512 path).
// Returns 0 on success.
int preprocess_frame(const uint8_t* rgb, int H, int W,
                     int outH, int outW, int cropH, int cropW,
                     float* out_chw, uint8_t* out_rgb) {
  if (!rgb || !out_chw || !out_rgb) return 1;
  if (cropH > outH || cropW > outW) return 2;

  const FilterBank fx = build_filter(W, outW);
  const FilterBank fy = build_filter(H, outH);

  // horizontal pass: H x outW x 3 (double accumulate, like PIL's 2-pass)
  std::vector<float> tmp(static_cast<size_t>(H) * outW * 3);
  parallel_for(H, [&](int lo, int hi) {
    for (int y = lo; y < hi; ++y) {
      const uint8_t* row = rgb + static_cast<size_t>(y) * W * 3;
      float* orow = tmp.data() + static_cast<size_t>(y) * outW * 3;
      for (int x = 0; x < outW; ++x) {
        const int x0 = fx.start[x];
        const int n = fx.size[x];
        const float* w = &fx.weights[static_cast<size_t>(x) * fx.max_size];
        float acc0 = 0, acc1 = 0, acc2 = 0;
        for (int k = 0; k < n; ++k) {
          const uint8_t* px = row + static_cast<size_t>(x0 + k) * 3;
          acc0 += w[k] * px[0];
          acc1 += w[k] * px[1];
          acc2 += w[k] * px[2];
        }
        orow[x * 3 + 0] = acc0;
        orow[x * 3 + 1] = acc1;
        orow[x * 3 + 2] = acc2;
      }
    }
  });

  const int y_off = (outH - cropH) / 2;
  const int x_off = (outW - cropW) / 2;
  const size_t plane = static_cast<size_t>(cropH) * cropW;

  // vertical pass + crop + clamp + normalize, fused
  parallel_for(cropH, [&](int lo, int hi) {
    for (int yc = lo; yc < hi; ++yc) {
      const int y = yc + y_off;
      const int y0 = fy.start[y];
      const int n = fy.size[y];
      const float* w = &fy.weights[static_cast<size_t>(y) * fy.max_size];
      for (int xc = 0; xc < cropW; ++xc) {
        const int x = xc + x_off;
        float acc0 = 0, acc1 = 0, acc2 = 0;
        for (int k = 0; k < n; ++k) {
          const float* px =
              tmp.data() + (static_cast<size_t>(y0 + k) * outW + x) * 3;
          acc0 += w[k] * px[0];
          acc1 += w[k] * px[1];
          acc2 += w[k] * px[2];
        }
        const float v0 = std::clamp(acc0, 0.0f, 255.0f);
        const float v1 = std::clamp(acc1, 0.0f, 255.0f);
        const float v2 = std::clamp(acc2, 0.0f, 255.0f);
        const size_t pix = static_cast<size_t>(yc) * cropW + xc;
        out_chw[0 * plane + pix] = (v0 / 255.0f - 0.5f) / 0.5f;
        out_chw[1 * plane + pix] = (v1 / 255.0f - 0.5f) / 0.5f;
        out_chw[2 * plane + pix] = (v2 / 255.0f - 0.5f) / 0.5f;
        uint8_t* orgb = out_rgb + pix * 3;
        orgb[0] = static_cast<uint8_t>(std::lround(v0));
        orgb[1] = static_cast<uint8_t>(std::lround(v1));
        orgb[2] = static_cast<uint8_t>(std::lround(v2));
      }
    }
  });

  return 0;
}

// Bilinear undistortion remap (cv2.remap equivalent for CV_32FC1 maps).
int remap_bilinear(const uint8_t* rgb, int H, int W,
                   const float* mapx, const float* mapy,
                   uint8_t* out) {
  if (!rgb || !mapx || !mapy || !out) return 1;
  parallel_for(H, [&](int lo, int hi) {
    for (int y = lo; y < hi; ++y) {
      for (int x = 0; x < W; ++x) {
        const size_t i = static_cast<size_t>(y) * W + x;
        const float sx = mapx[i];
        const float sy = mapy[i];
        uint8_t* o = out + i * 3;
        if (sx < 0 || sy < 0 || sx > W - 1 || sy > H - 1) {
          o[0] = o[1] = o[2] = 0;
          continue;
        }
        const int x0 = static_cast<int>(sx);
        const int y0 = static_cast<int>(sy);
        const int x1 = std::min(x0 + 1, W - 1);
        const int y1 = std::min(y0 + 1, H - 1);
        const float dx = sx - x0;
        const float dy = sy - y0;
        for (int c = 0; c < 3; ++c) {
          const float tl = rgb[(static_cast<size_t>(y0) * W + x0) * 3 + c];
          const float tr = rgb[(static_cast<size_t>(y0) * W + x1) * 3 + c];
          const float bl = rgb[(static_cast<size_t>(y1) * W + x0) * 3 + c];
          const float br = rgb[(static_cast<size_t>(y1) * W + x1) * 3 + c];
          const float v = (1 - dy) * ((1 - dx) * tl + dx * tr) +
                          dy * ((1 - dx) * bl + dx * br);
          o[c] = static_cast<uint8_t>(std::lround(std::clamp(v, 0.0f, 255.0f)));
        }
      }
    }
  });
  return 0;
}

// Undo the PNG row filters (PNG spec section 9).  `raw` holds `height`
// rows of 1 + row_bytes bytes: a filter type (0 None, 1 Sub, 2 Up,
// 3 Average, 4 Paeth) and the filtered row.  `bpp` is the bytes a pixel
// (1..8; the "left" neighbour is bpp bytes back).  Writes height * row_bytes
// bytes to `out`.  Returns 0, 1 on a null pointer or bad size, and
// 10 + row on an unknown filter type.
int png_unfilter(const uint8_t* raw, int height, int row_bytes, int bpp,
                 uint8_t* out) {
  if (!raw || !out || height < 0 || row_bytes < 0 || bpp < 1 || bpp > 8) return 1;
  const size_t stride = static_cast<size_t>(row_bytes);
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = raw + static_cast<size_t>(y) * (stride + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* dst = out + static_cast<size_t>(y) * stride;
    const uint8_t* up = y > 0 ? dst - stride : nullptr;
    switch (type) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (size_t i = 0; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= static_cast<size_t>(bpp) ? dst[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= static_cast<size_t>(bpp) ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= static_cast<size_t>(bpp) ? dst[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= static_cast<size_t>(bpp)) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return 10 + y;
    }
  }
  return 0;
}

}  // extern "C"
