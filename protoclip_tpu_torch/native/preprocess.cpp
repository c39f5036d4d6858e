// Native host-side image preprocess: fused bicubic resize + center crop.
//
// Replaces the hot per-image host work of the CLIP eval transform
// (reference: torchvision Resize(bicubic) + CenterCrop via PIL,
// clip/clip.py:77-84) with a single C++ pass that computes ONLY the pixels
// the crop keeps.  Pixel-exact with PIL: same separable two-pass structure,
// same bicubic kernel (a = -0.5, support 2), same weight normalization and
// fixed-point accumulation (coefficients quantized to 1<<PRECISION_BITS,
// rounded by +half then arithmetic shift), so byte-for-byte outputs match
// Image.resize(..., BICUBIC) followed by the torchvision-arithmetic crop.
//
// Why fused: PIL materializes the full resized image, then the crop throws
// away all rows/columns outside the 224x224 window.  Here the vertical pass
// runs only over cropped output rows and the horizontal pass only over the
// source rows those need — for a tall 375x500 -> shorter-side-224 resize the
// crop keeps ~75% of rows; for panoramic/portrait inputs far less.
//
// The single-image entry points and their arithmetic are the JAX package's
// (protoclip_tpu/native/preprocess.cpp).  This copy adds one entry of its
// own, resize_shorter_center_crop_batch: a whole batch of crops (a scene's)
// in one call, spread over threads spawned and joined inside the call, each
// crop through the unchanged single-image entry.
//
// Built as a plain shared object (no Python.h, -pthread): the Python side
// binds via ctypes (protoclip_tpu_torch/native/__init__.py) and falls back to
// PIL when the toolchain or .so is unavailable.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // PIL's fixed-point precision
constexpr double kSupport = 2.0;            // bicubic filter support

// Bicubic kernel, a = -0.5 (Catmull-Rom), the BICUBIC filter PIL uses.
double bicubic(double x) {
  constexpr double a = -0.5;
  if (x < 0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

inline uint8_t clip8(int64_t v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

// Per-output-pixel filter table over [out_begin, out_end): source window
// bounds + normalized fixed-point coefficients.  Mirrors PIL's
// precompute_coeffs for a source box [in0, in1) mapped onto full_out output
// pixels (Resample.c: scale = (in1 - in0) / outSize, center = in0 +
// (xx + 0.5) * scale, windows clamped to the FULL image [0, in_size) — box
// edges do not clip the filter support), but evaluated only for the output
// slice the caller keeps.
struct Coeffs {
  std::vector<int> bounds_min;   // first source index per output pixel
  std::vector<int> bounds_size;  // window length per output pixel
  std::vector<std::vector<int32_t>> k;  // quantized weights per output pixel
  int max_size = 0;
};

Coeffs precompute(int in_size, double in0, double in1, int full_out,
                  int out_begin, int out_end) {
  Coeffs c;
  const double scale = (in1 - in0) / full_out;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  // PIL (Resample.c precompute_coeffs) divides by filterscale via a
  // precomputed reciprocal MULTIPLY (ss = 1.0/filterscale; w = f(x*ss)).
  // x/filterscale and x*(1.0/filterscale) can differ by 1 ulp, which can
  // flip a quantized coefficient — reproduce the multiply exactly.
  const double ss = 1.0 / filterscale;
  const double support = kSupport * filterscale;
  const int n = out_end - out_begin;
  c.bounds_min.resize(n);
  c.bounds_size.resize(n);
  c.k.resize(n);
  std::vector<double> w;
  for (int i = 0; i < n; ++i) {
    const int xx = out_begin + i;
    const double center = in0 + (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int size = xmax - xmin;
    w.assign(size, 0.0);
    double total = 0.0;
    for (int j = 0; j < size; ++j) {
      const double weight = bicubic((j + xmin - center + 0.5) * ss);
      w[j] = weight;
      total += weight;
    }
    c.k[i].resize(size);
    for (int j = 0; j < size; ++j) {
      const double normed = total == 0.0 ? 0.0 : w[j] / total;
      // PIL quantizes with round-half-away via floor(x + 0.5) semantics
      c.k[i][j] = static_cast<int32_t>(
          normed < 0 ? normed * (1 << kPrecisionBits) - 0.5
                     : normed * (1 << kPrecisionBits) + 0.5);
    }
    c.bounds_min[i] = xmin;
    c.bounds_size[i] = size;
    if (size > c.max_size) c.max_size = size;
  }
  return c;
}

}  // namespace

extern "C" {

// Fused shorter-side bicubic resize + center crop.
//
//   src:   (in_h, in_w, 3) uint8, C-contiguous
//   dst:   (crop, crop, 3) uint8, C-contiguous (written)
//
// Semantics match protoclip_tpu_torch.data.transforms:
//   resize_shorter: shorter side -> size, long side int(size*long/short)
//   center_crop:    offsets int(round((dim - size) / 2.0))
// Returns 0 on success, nonzero on invalid arguments.
int resize_shorter_center_crop(const uint8_t* src, int in_h, int in_w,
                               uint8_t* dst, int size, int crop) {
  if (in_h <= 0 || in_w <= 0 || size <= 0 || crop <= 0) return 1;

  // full resized geometry (truncating long-side arithmetic, matching
  // torchvision Resize int() semantics)
  int out_w, out_h;
  if (in_w <= in_h) {
    out_w = size;
    out_h = static_cast<int>(static_cast<int64_t>(size) * in_h / in_w);
    if (out_h < 1) out_h = 1;
  } else {
    out_h = size;
    out_w = static_cast<int>(static_cast<int64_t>(size) * in_w / in_h);
    if (out_w < 1) out_w = 1;
  }
  if (out_w < crop || out_h < crop) return 2;  // caller falls back to PIL

  // crop window in resized coordinates: int(round((dim - crop) / 2.0)) with
  // Python/torchvision round() semantics — HALF-TO-EVEN (banker's), so an
  // odd margin n rounds n/2 = k+.5 to k when k is even, k+1 when odd.
  const auto crop_offset = [](int margin) {
    const int k = margin / 2;
    return (margin % 2 == 0) ? k : k + (k & 1);
  };
  const int left = crop_offset(out_w - crop);
  const int top = crop_offset(out_h - crop);

  const Coeffs ch = precompute(in_w, 0.0, in_w, out_w, left, left + crop);
  const Coeffs cv = precompute(in_h, 0.0, in_h, out_h, top, top + crop);

  // source row range the vertical pass touches
  int ymin = cv.bounds_min[0];
  int ymax = cv.bounds_min[crop - 1] + cv.bounds_size[crop - 1];

  // pass 1: horizontal resample of rows [ymin, ymax) into int16-free
  // uint8 temp (PIL also materializes the horizontal pass as 8-bit)
  std::vector<uint8_t> tmp(static_cast<size_t>(ymax - ymin) * crop * 3);
  for (int y = ymin; y < ymax; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    uint8_t* out = tmp.data() + static_cast<size_t>(y - ymin) * crop * 3;
    for (int x = 0; x < crop; ++x) {
      const int xmin = ch.bounds_min[x];
      const int n = ch.bounds_size[x];
      const int32_t* k = ch.k[x].data();
      int64_t acc0 = 1 << (kPrecisionBits - 1);
      int64_t acc1 = acc0, acc2 = acc0;
      const uint8_t* px = row + static_cast<size_t>(xmin) * 3;
      for (int j = 0; j < n; ++j, px += 3) {
        const int64_t kk = k[j];
        acc0 += px[0] * kk;
        acc1 += px[1] * kk;
        acc2 += px[2] * kk;
      }
      out[x * 3 + 0] = clip8(acc0);
      out[x * 3 + 1] = clip8(acc1);
      out[x * 3 + 2] = clip8(acc2);
    }
  }

  // pass 2: vertical resample of the temp into the crop window
  for (int y = 0; y < crop; ++y) {
    const int src_min = cv.bounds_min[y] - ymin;
    const int n = cv.bounds_size[y];
    const int32_t* k = cv.k[y].data();
    uint8_t* out = dst + static_cast<size_t>(y) * crop * 3;
    for (int x = 0; x < crop * 3; ++x) {
      int64_t acc = 1 << (kPrecisionBits - 1);
      const uint8_t* px = tmp.data() + static_cast<size_t>(src_min) * crop * 3 + x;
      for (int j = 0; j < n; ++j, px += static_cast<size_t>(crop) * 3) {
        acc += *px * static_cast<int64_t>(k[j]);
      }
      out[x] = clip8(acc);
    }
  }
  return 0;
}

// A batch of crops through resize_shorter_center_crop, each byte for byte
// what the single call gives.
//
//   srcs[i]:  (in_h[i], in_w[i], 3) uint8, C-contiguous
//   dst:      (n, crop, crop, 3) uint8, C-contiguous (crop i written at i)
//   status:   n ints (written): crop i's return code from the single entry,
//             or 3 if its worker failed; a non-zero crop's slot is
//             unspecified and the caller serves it another way
//
// Up to `workers` threads take crops by an atomic index; the calling
// thread is one of them, so workers <= 1 spawns none.  The threads are
// spawned and joined inside the call: nothing outlives it.  A thread that
// cannot be spawned leaves its share to the others.  Returns 0, or 1 on
// invalid arguments (no crop written).
int resize_shorter_center_crop_batch(const uint8_t* const* srcs, const int* in_h,
                                     const int* in_w, int n, uint8_t* dst, int size,
                                     int crop, int workers, int* status) {
  if (n < 0 || crop <= 0) return 1;
  const size_t stride = static_cast<size_t>(crop) * crop * 3;
  std::atomic<int> next{0};
  const auto work = [&]() {
    for (int i; (i = next.fetch_add(1, std::memory_order_relaxed)) < n;) {
      try {
        status[i] = resize_shorter_center_crop(srcs[i], in_h[i], in_w[i],
                                               dst + i * stride, size, crop);
      } catch (...) {  // e.g. std::bad_alloc: this crop alone is declined
        status[i] = 3;
      }
    }
  };
  std::vector<std::thread> pool;
  const int spawn = (workers < n ? workers : n) - 1;
  for (int t = 0; t < spawn; ++t) {
    try {
      pool.emplace_back(work);
    } catch (const std::exception&) {  // no thread: the others take its crops
      break;
    }
  }
  work();
  for (auto& th : pool) th.join();
  return 0;
}

// Plain bicubic resize to (out_h, out_w), no crop — parity surface for
// tests and a building block for other callers.
int resize_bicubic(const uint8_t* src, int in_h, int in_w, uint8_t* dst,
                   int out_h, int out_w) {
  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0) return 1;
  const Coeffs ch = precompute(in_w, 0.0, in_w, out_w, 0, out_w);
  const Coeffs cv = precompute(in_h, 0.0, in_h, out_h, 0, out_h);

  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    uint8_t* out = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int xmin = ch.bounds_min[x];
      const int n = ch.bounds_size[x];
      const int32_t* k = ch.k[x].data();
      int64_t acc0 = 1 << (kPrecisionBits - 1);
      int64_t acc1 = acc0, acc2 = acc0;
      const uint8_t* px = row + static_cast<size_t>(xmin) * 3;
      for (int j = 0; j < n; ++j, px += 3) {
        const int64_t kk = k[j];
        acc0 += px[0] * kk;
        acc1 += px[1] * kk;
        acc2 += px[2] * kk;
      }
      out[x * 3 + 0] = clip8(acc0);
      out[x * 3 + 1] = clip8(acc1);
      out[x * 3 + 2] = clip8(acc2);
    }
  }
  for (int y = 0; y < out_h; ++y) {
    const int src_min = cv.bounds_min[y];
    const int n = cv.bounds_size[y];
    const int32_t* k = cv.k[y].data();
    uint8_t* out = dst + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      int64_t acc = 1 << (kPrecisionBits - 1);
      const uint8_t* px = tmp.data() + static_cast<size_t>(src_min) * out_w * 3 + x;
      for (int j = 0; j < n; ++j, px += static_cast<size_t>(out_w) * 3) {
        acc += *px * static_cast<int64_t>(k[j]);
      }
      out[x] = clip8(acc);
    }
  }
  return 0;
}

// Bicubic resize of a source BOX to (out_h, out_w), with optional fused
// horizontal flip — the train-time RandomResizedCrop(+HFlip) backend
// (reference transform: datasets/imagenet.py:8-23 via PIL
// img.resize((s, s), BICUBIC, box=(l, t, r, b)) [+ FLIP_LEFT_RIGHT]).
//
// Pixel-exact with PIL: coefficients use scale = (r - l) / out and
// center = l + (x + 0.5) * scale, with filter windows clamped to the FULL
// image (pixels outside the box but inside the image contribute, exactly as
// in Resample.c); the horizontal pass materializes only the source rows the
// vertical pass reads (PIL's ImagingResampleInner does the same row
// restriction for boxed resizes).  The flip is applied as an output column
// reversal, which commutes losslessly with the resize.
//
//   box_*: float box in source coordinates, 0 <= left < right <= in_w,
//          0 <= top < bottom <= in_h (PIL accepts float boxes; the Python
//          RandomResizedCrop always passes integers).
int resize_box(const uint8_t* src, int in_h, int in_w, uint8_t* dst,
               int out_h, int out_w, double box_left, double box_top,
               double box_right, double box_bottom, int flip) {
  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0) return 1;
  if (!(box_left >= 0.0 && box_left < box_right && box_right <= in_w)) return 1;
  if (!(box_top >= 0.0 && box_top < box_bottom && box_bottom <= in_h)) return 1;

  const Coeffs ch = precompute(in_w, box_left, box_right, out_w, 0, out_w);
  const Coeffs cv = precompute(in_h, box_top, box_bottom, out_h, 0, out_h);

  // source rows the vertical pass touches (bounds are nondecreasing in y)
  const int ymin = cv.bounds_min[0];
  const int ymax = cv.bounds_min[out_h - 1] + cv.bounds_size[out_h - 1];

  // pass 1: horizontal resample of rows [ymin, ymax)
  std::vector<uint8_t> tmp(static_cast<size_t>(ymax - ymin) * out_w * 3);
  for (int y = ymin; y < ymax; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    uint8_t* out = tmp.data() + static_cast<size_t>(y - ymin) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const int xmin = ch.bounds_min[x];
      const int n = ch.bounds_size[x];
      const int32_t* k = ch.k[x].data();
      int64_t acc0 = 1 << (kPrecisionBits - 1);
      int64_t acc1 = acc0, acc2 = acc0;
      const uint8_t* px = row + static_cast<size_t>(xmin) * 3;
      for (int j = 0; j < n; ++j, px += 3) {
        const int64_t kk = k[j];
        acc0 += px[0] * kk;
        acc1 += px[1] * kk;
        acc2 += px[2] * kk;
      }
      out[x * 3 + 0] = clip8(acc0);
      out[x * 3 + 1] = clip8(acc1);
      out[x * 3 + 2] = clip8(acc2);
    }
  }

  // pass 2: vertical resample into dst (linear over the row buffer)
  for (int y = 0; y < out_h; ++y) {
    const int src_min = cv.bounds_min[y] - ymin;
    const int n = cv.bounds_size[y];
    const int32_t* k = cv.k[y].data();
    uint8_t* out = dst + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      int64_t acc = 1 << (kPrecisionBits - 1);
      const uint8_t* px = tmp.data() + static_cast<size_t>(src_min) * out_w * 3 + x;
      for (int j = 0; j < n; ++j, px += static_cast<size_t>(out_w) * 3) {
        acc += *px * static_cast<int64_t>(k[j]);
      }
      out[x] = clip8(acc);
    }
    if (flip) {  // reverse the row's pixels in place (lossless)
      for (int a = 0, b = out_w - 1; a < b; ++a, --b) {
        for (int ccol = 0; ccol < 3; ++ccol) {
          const uint8_t t = out[a * 3 + ccol];
          out[a * 3 + ccol] = out[b * 3 + ccol];
          out[b * 3 + ccol] = t;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
