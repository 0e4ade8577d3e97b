// Native data-path core: image/label augmentation for the input
// pipeline (the port's own copy of adlm_tpu/native/augment.cc).
//
// The reference feeds its GPU from torch DataLoader workers running
// cv2/PIL python per sample (reference segmentation/dataset.py:119-173).
// This library performs the same per-sample transform chain —
// scale-jitter bilinear resize, nearest label resize, pad-to-window,
// crop, horizontal flip, normalize — in C++, callable via ctypes, so
// host-side preprocessing keeps up with the device at production batch
// sizes.  It runs on the host CPU; the card never sees it.
//
// Semantics:
//  * image resize: classic half-pixel-center bilinear (cv2.INTER_LINEAR
//    semantics — what the reference uses; NOT PIL's antialiased reduce)
//  * label resize: PIL NEAREST mapping src = floor((i + 0.5) * in/out)
//    (what the reference's resize_label uses)
//  * randomness stays in Python: scale / crop offsets / flip arrive as
//    arguments, keeping parity tests deterministic.
//
// Build: adlm_tpu_torch/native/__init__.py, at first use
// (g++ -O3 -shared -fPIC -ffp-contract=off).  -ffp-contract=off keeps
// every multiply and add separately rounded on hosts whose baseline
// has FMA (aarch64), so the numpy version augment_sample_plain and
// the JAX package's build compute the same floats.
//
// U-Noise's remap_* and gaussian_blur_f32 below are compiled but not
// bound yet: they come with the U-Noise slice.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Bilinear resize uint8 HWC -> float32 HWC, half-pixel centers,
// edge-clamped (cv2.INTER_LINEAR semantics).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        float* dst, int dh, int dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * scale_y - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), sh - 1);
    int y1c = std::min(std::max(y0 + 1, 0), sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * scale_x - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), sw - 1);
      int x1c = std::min(std::max(x0 + 1, 0), sw - 1);
      const uint8_t* p00 = src + (y0c * sw + x0c) * c;
      const uint8_t* p01 = src + (y0c * sw + x1c) * c;
      const uint8_t* p10 = src + (y1c * sw + x0c) * c;
      const uint8_t* p11 = src + (y1c * sw + x1c) * c;
      float* out = dst + (y * dw + x) * c;
      for (int ch = 0; ch < c; ++ch) {
        float top = p00[ch] * (1.0f - wx) + p01[ch] * wx;
        float bot = p10[ch] * (1.0f - wx) + p11[ch] * wx;
        out[ch] = top * (1.0f - wy) + bot * wy;
      }
    }
  }
}

// Nearest label resize: src = floor((i + 0.5) * in/out).  Matches PIL
// NEAREST except at exact-integer sampling centers, where PIL's pick
// depends on its internal float rounding (see ops/resize.py docstring).
void resize_nearest_i32(const int32_t* src, int sh, int sw,
                        int32_t* dst, int dh, int dw) {
  const double scale_y = static_cast<double>(sh) / dh;
  const double scale_x = static_cast<double>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    int sy = std::min(static_cast<int>((y + 0.5) * scale_y), sh - 1);
    for (int x = 0; x < dw; ++x) {
      int sx = std::min(static_cast<int>((x + 0.5) * scale_x), sw - 1);
      dst[y * dw + x] = src[sy * sw + sx];
    }
  }
}

// Full training-sample transform (reference dataset.py:119-173):
//   scaled = bilinear(img, round(h*scale), round(w*scale)) / 255 (or raw)
//   label  = nearest(label, same)
//   pad bottom/right to window with mean / 0
//   crop [start_h:start_h+wh, start_w:start_w+ww]
//   optional hflip
//   normalize (img - mean) / std   (skipped when `normalize` == 0)
// Caller passes scaled dims (sh2, sw2) explicitly (int(h*scale)).
void augment_sample(const uint8_t* img, const int32_t* label,
                    int h, int w, int channels,
                    int sh2, int sw2,
                    int window_h, int window_w,
                    int start_h, int start_w,
                    int flip, int cells, int normalize,
                    const float* mean, const float* stddev,
                    float* scratch_img, int32_t* scratch_label,
                    float* out_img, int32_t* out_label) {
  // 1. resize into scratch (sh2 x sw2); the reference resizes the
  // UINT8 image (cv2 rounds to uint8) before dividing by 255 —
  // replicate the quantization (round half-to-even like saturate_cast)
  resize_bilinear_u8(img, h, w, channels, scratch_img, sh2, sw2);
  for (int i = 0; i < sh2 * sw2 * channels; ++i) {
    float v = std::nearbyint(scratch_img[i]);
    scratch_img[i] = std::min(std::max(v, 0.0f), 255.0f);
  }
  resize_nearest_i32(label, h, w, scratch_label, sh2, sw2);
  const float inv255 = cells ? 1.0f : (1.0f / 255.0f);

  // 2-4. pad+crop+flip fused: walk output pixels, map to scratch coords
  for (int y = 0; y < window_h; ++y) {
    int sy = start_h + y;
    for (int x = 0; x < window_w; ++x) {
      int sx = start_w + x;
      int ox = flip ? (window_w - 1 - x) : x;
      float* out = out_img + (y * window_w + ox) * channels;
      int32_t* outl = out_label + y * window_w + ox;
      if (sy < sh2 && sx < sw2) {
        const float* in = scratch_img + (sy * sw2 + sx) * channels;
        for (int ch = 0; ch < channels; ++ch) {
          float v = in[ch] * inv255;
          out[ch] = normalize ? (v - mean[ch]) / stddev[ch] : v;
        }
        *outl = scratch_label[sy * sw2 + sx];
      } else {  // padding: image = dataset mean, label = 0
        for (int ch = 0; ch < channels; ++ch) {
          float v = mean[ch];
          out[ch] = normalize ? (v - mean[ch]) / stddev[ch] : v;
        }
        *outl = 0;
      }
    }
  }
}

// Fused variant of augment_sample: computes ONLY the window pixels,
// sampling the source image directly at the scaled coordinates the
// crop would have read — O(window²) work instead of O(scale²·H·W)
// (a 1024×2048 source at scale 1.5 resizes 4.7M pixels to produce a
// 263k-pixel window; this computes the 263k directly).  Per-pixel
// float math is IDENTICAL to the resize-then-crop path (same lerp
// expression, same nearbyint quantization), so outputs are
// bit-identical — asserted in tests/test_torch_data.py.
// `label` points at int32 (label_u8 == 0) or uint8 (label_u8 == 1)
// data — raw annotation ids.  `lut`/`lut_size` apply the class table's
// raw→train-id remap to the CROPPED pixels only (conversion commutes
// with nearest resampling; lut_size 0 = identity).  Padding writes
// train-id 0 (void) directly, matching the convert-then-pad order of
// the python path regardless of what lut[0] is.
void augment_sample_fused(const uint8_t* img, const void* label,
                          int label_u8,
                          int h, int w, int channels,
                          int sh2, int sw2,
                          int window_h, int window_w,
                          int start_h, int start_w,
                          int flip, int cells, int normalize,
                          const float* mean, const float* stddev,
                          const int32_t* lut, int lut_size,
                          float* out_img, int32_t* out_label) {
  const float scale_y = static_cast<float>(h) / sh2;
  const float scale_x = static_cast<float>(w) / sw2;
  const double dscale_y = static_cast<double>(h) / sh2;
  const double dscale_x = static_cast<double>(w) / sw2;
  const float inv255 = cells ? 1.0f : (1.0f / 255.0f);
  const int32_t* label_i32 = static_cast<const int32_t*>(label);
  const uint8_t* label_u8p = static_cast<const uint8_t*>(label);

  // column tables: x-dependent sampling state is constant across rows
  const int in_w =
      std::max(std::min(window_w, sw2 - start_w), 0);  // in-bounds cols
  int* x0c = new int[window_w > 0 ? window_w : 1];
  int* x1c = new int[window_w > 0 ? window_w : 1];
  float* wx = new float[window_w > 0 ? window_w : 1];
  int* lsx = new int[window_w > 0 ? window_w : 1];
  for (int x = 0; x < in_w; ++x) {
    const int sx = start_w + x;
    const float fx = (sx + 0.5f) * scale_x - 0.5f;
    const int x0 = static_cast<int>(std::floor(fx));
    wx[x] = fx - x0;
    x0c[x] = std::min(std::max(x0, 0), w - 1);
    x1c[x] = std::min(std::max(x0 + 1, 0), w - 1);
    lsx[x] = std::min(static_cast<int>((sx + 0.5) * dscale_x), w - 1);
  }

  for (int y = 0; y < window_h; ++y) {
    const int sy = start_h + y;
    const bool in_y = sy < sh2;
    int y0c = 0, y1c = 0, lsy = 0;
    float wy = 0.0f;
    if (in_y) {
      const float fy = (sy + 0.5f) * scale_y - 0.5f;
      const int y0 = static_cast<int>(std::floor(fy));
      wy = fy - y0;
      y0c = std::min(std::max(y0, 0), h - 1);
      y1c = std::min(std::max(y0 + 1, 0), h - 1);
      lsy = std::min(static_cast<int>((sy + 0.5) * dscale_y), h - 1);
    }
    const uint8_t* row0 = img + y0c * w * channels;
    const uint8_t* row1 = img + y1c * w * channels;
    const int cols = in_y ? in_w : 0;
    for (int x = 0; x < cols; ++x) {
      const int ox = flip ? (window_w - 1 - x) : x;
      float* out = out_img + (y * window_w + ox) * channels;
      const float wxv = wx[x];
      const uint8_t* p00 = row0 + x0c[x] * channels;
      const uint8_t* p01 = row0 + x1c[x] * channels;
      const uint8_t* p10 = row1 + x0c[x] * channels;
      const uint8_t* p11 = row1 + x1c[x] * channels;
      for (int ch = 0; ch < channels; ++ch) {
        const float top = p00[ch] * (1.0f - wxv) + p01[ch] * wxv;
        const float bot = p10[ch] * (1.0f - wxv) + p11[ch] * wxv;
        float v = std::nearbyint(top * (1.0f - wy) + bot * wy);
        v = std::min(std::max(v, 0.0f), 255.0f) * inv255;
        out[ch] = normalize ? (v - mean[ch]) / stddev[ch] : v;
      }
      int32_t raw = label_u8 ? label_u8p[lsy * w + lsx[x]]
                             : label_i32[lsy * w + lsx[x]];
      if (lut_size > 0) {
        raw = lut[std::min(std::max(raw, 0), lut_size - 1)];
      }
      out_label[y * window_w + ox] = raw;
    }
    for (int x = cols; x < window_w; ++x) {  // padding
      const int ox = flip ? (window_w - 1 - x) : x;
      float* out = out_img + (y * window_w + ox) * channels;
      for (int ch = 0; ch < channels; ++ch) {
        const float v = mean[ch];
        out[ch] = normalize ? (v - mean[ch]) / stddev[ch] : v;
      }
      out_label[y * window_w + ox] = 0;
    }
  }
  delete[] x0c;
  delete[] x1c;
  delete[] wx;
  delete[] lsx;
}

// ---------------------------------------------------------------------
// U-Noise geometric warps (data/warps.py fast path): cv2.remap-style
// coordinate resampling with BORDER_REFLECT_101 and a separable
// gaussian blur (scipy gaussian_filter mode="constant" semantics) for
// the elastic displacement field.
// ---------------------------------------------------------------------

static inline int reflect101(int p, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  p = std::abs(p) % period;
  return p >= n ? period - p : p;
}

// Bilinear remap float32 (H, W, C) at float coords, reflect-101 edges.
void remap_bilinear_f32(const float* img, int h, int w, int c,
                        const float* map_y, const float* map_x,
                        int oh, int ow, float* out) {
  for (int i = 0; i < oh * ow; ++i) {
    const float my = map_y[i];
    const float mx = map_x[i];
    const int y0 = static_cast<int>(std::floor(my));
    const int x0 = static_cast<int>(std::floor(mx));
    const float fy = my - y0;
    const float fx = mx - x0;
    const int y0r = reflect101(y0, h);
    const int y1r = reflect101(y0 + 1, h);
    const int x0r = reflect101(x0, w);
    const int x1r = reflect101(x0 + 1, w);
    const float* p00 = img + (y0r * w + x0r) * c;
    const float* p01 = img + (y0r * w + x1r) * c;
    const float* p10 = img + (y1r * w + x0r) * c;
    const float* p11 = img + (y1r * w + x1r) * c;
    float* o = out + i * c;
    for (int ch = 0; ch < c; ++ch) {
      const float top = p00[ch] * (1.0f - fx) + p01[ch] * fx;
      const float bot = p10[ch] * (1.0f - fx) + p11[ch] * fx;
      o[ch] = top * (1.0f - fy) + bot * fy;
    }
  }
}

// Nearest remap float32 (masks): round-half-to-even like np.round.
void remap_nearest_f32(const float* img, int h, int w,
                       const float* map_y, const float* map_x,
                       int oh, int ow, float* out) {
  for (int i = 0; i < oh * ow; ++i) {
    const int y = reflect101(
        static_cast<int>(std::nearbyintf(map_y[i])), h);
    const int x = reflect101(
        static_cast<int>(std::nearbyintf(map_x[i])), w);
    out[i] = img[y * w + x];
  }
}

// Separable gaussian blur, zero ("constant") borders — matches
// scipy.ndimage.gaussian_filter(mode="constant", cval=0, truncate=4).
// `tmp` is a caller-provided (h*w) scratch buffer.
void gaussian_blur_f32(const float* src, int h, int w, float sigma,
                       float* tmp, float* dst) {
  const int radius = static_cast<int>(4.0f * sigma + 0.5f);
  const int ksize = 2 * radius + 1;
  double* kern = new double[ksize];
  double ksum = 0.0;
  for (int i = -radius; i <= radius; ++i) {
    const double v = std::exp(-0.5 * (double)i * i / (sigma * sigma));
    kern[i + radius] = v;
    ksum += v;
  }
  for (int i = 0; i < ksize; ++i) kern[i] /= ksum;

  // horizontal pass: src -> tmp
  for (int y = 0; y < h; ++y) {
    const float* row = src + y * w;
    for (int x = 0; x < w; ++x) {
      double acc = 0.0;
      const int lo = std::max(-radius, -x);
      const int hi = std::min(radius, w - 1 - x);
      for (int k = lo; k <= hi; ++k) acc += row[x + k] * kern[k + radius];
      tmp[y * w + x] = static_cast<float>(acc);
    }
  }
  // vertical pass: tmp -> dst
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      double acc = 0.0;
      const int lo = std::max(-radius, -y);
      const int hi = std::min(radius, h - 1 - y);
      for (int k = lo; k <= hi; ++k)
        acc += tmp[(y + k) * w + x] * kern[k + radius];
      dst[y * w + x] = static_cast<float>(acc);
    }
  }
  delete[] kern;
}

}  // extern "C"
