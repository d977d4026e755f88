// Native host-side input packer for the data pipeline.
//
// The reference's input path is PIL + Albumentations in DataLoader worker
// processes (reference: code/utils.py:757-779, code/config.py:89-113). Here
// the eval/serving hot loop -- bilinear letterbox resize + center pad +
// /255 normalization + NHWC batch assembly -- is a single C++ call,
// multithreaded with std::thread, writing straight into the pinned numpy
// buffer that jax.device_put ships to the device. No Python byte shuffling,
// no per-image allocations.
//
// Geometry matches data/augment.py::letterbox: scale = size / max(h, w),
// rounded target dims, centered padding (top = (size - nh) / 2).
// Resampling is classic half-pixel-center bilinear; PIL's downscale filter
// adds antialiasing, so pixels differ slightly from the Python path --
// acceptable for the eval path (boxes/metrics are resolution-level).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Half-pixel-center bilinear coefficient table for one axis.
struct AxisTab {
  std::vector<int> i0, i1;
  std::vector<float> w;  // weight of i1; (1 - w) of i0
};

AxisTab make_axis(int src, int dst) {
  AxisTab t;
  t.i0.resize(dst);
  t.i1.resize(dst);
  t.w.resize(dst);
  const float s = static_cast<float>(src) / dst;
  for (int x = 0; x < dst; ++x) {
    float f = (x + 0.5f) * s - 0.5f;
    f = std::max(0.0f, std::min(f, static_cast<float>(src - 1)));
    t.i0[x] = static_cast<int>(f);
    t.i1[x] = std::min(t.i0[x] + 1, src - 1);
    t.w[x] = f - t.i0[x];
  }
  return t;
}

// Letterbox one HWC uint8 image into a float32 (size, size, 3) canvas.
// Separable two-pass resize: horizontal u8->f32 (work sh*nw), then vertical
// blend + /255 straight into the padded destination (work nh*nw). Sequential
// access, precomputed tables -- an order of magnitude over naive per-pixel
// sampling.
void letterbox_one(const uint8_t* src, int sh, int sw, float* dst, int size,
                   float pad_value) {
  // double + nearbyint (round-half-to-even) to match Python round() in
  // data/augment.py::letterbox_box_geometry -- lround would round half away
  // from zero and misalign image vs box geometry by 1px at exact .5
  const double dscale = static_cast<double>(size) / std::max(sh, sw);
  const int nh = std::max(1, static_cast<int>(std::nearbyint(sh * dscale)));
  const int nw = std::max(1, static_cast<int>(std::nearbyint(sw * dscale)));
  const int top = (size - nh) / 2;
  const int left = (size - nw) / 2;
  const size_t plane = static_cast<size_t>(size) * size * 3;
  std::fill(dst, dst + plane, pad_value);
  constexpr float kInv255 = 1.0f / 255.0f;

  if (nh == sh && nw == sw) {
    for (int y = 0; y < nh; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
      float* out = dst + (static_cast<size_t>(top + y) * size + left) * 3;
      for (int i = 0; i < nw * 3; ++i) out[i] = row[i] * kInv255;
    }
    return;
  }

  const AxisTab tx = make_axis(sw, nw);
  const AxisTab ty = make_axis(sh, nh);

  // Pass 1: horizontal resample of every source row into f32 (sh, nw, 3).
  std::vector<float> tmp(static_cast<size_t>(sh) * nw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * 3;
    float* out = tmp.data() + static_cast<size_t>(y) * nw * 3;
    for (int x = 0; x < nw; ++x) {
      const uint8_t* p0 = row + tx.i0[x] * 3;
      const uint8_t* p1 = row + tx.i1[x] * 3;
      const float w = tx.w[x];
      out[x * 3 + 0] = p0[0] + (p1[0] - p0[0]) * w;
      out[x * 3 + 1] = p0[1] + (p1[1] - p0[1]) * w;
      out[x * 3 + 2] = p0[2] + (p1[2] - p0[2]) * w;
    }
  }

  // Pass 2: vertical blend + normalize into the letterboxed window.
  for (int y = 0; y < nh; ++y) {
    const float* r0 = tmp.data() + static_cast<size_t>(ty.i0[y]) * nw * 3;
    const float* r1 = tmp.data() + static_cast<size_t>(ty.i1[y]) * nw * 3;
    const float w = ty.w[y];
    float* out = dst + (static_cast<size_t>(top + y) * size + left) * 3;
    for (int i = 0; i < nw * 3; ++i) {
      out[i] = (r0[i] + (r1[i] - r0[i]) * w) * kInv255;
    }
  }
}

// Generalized per-axis map for a composed affine: output pixel x -> source
// coordinate a*x + b (half-pixel centers). Marks out-of-range outputs so the
// sampler can write the pad value (PIL AFFINE fills outside the source).
struct AffineAxisTab {
  std::vector<int> i0, i1;
  std::vector<float> w;
  std::vector<uint8_t> in_range;
};

AffineAxisTab make_affine_axis(int src, int dst, float a, float b) {
  AffineAxisTab t;
  t.i0.resize(dst);
  t.i1.resize(dst);
  t.w.resize(dst);
  t.in_range.resize(dst);
  for (int x = 0; x < dst; ++x) {
    const float f = a * (x + 0.5f) + b - 0.5f;
    const bool ok = f > -1.0f && f < static_cast<float>(src);
    const float fc = std::max(0.0f, std::min(f, static_cast<float>(src - 1)));
    t.i0[x] = static_cast<int>(fc);
    t.i1[x] = std::min(t.i0[x] + 1, src - 1);
    t.w[x] = fc - t.i0[x];
    t.in_range[x] = ok ? 1 : 0;
  }
  return t;
}

// One RGB pixel (0..1 floats) through an HSV shift. Matches the numpy
// fallback's math (data/augment.py::hsv_jitter): hue wraps, sat/val clip.
inline void hsv_shift_px(float& r, float& g, float& b, float dh, float ds,
                         float dv) {
  const float mx = std::max(r, std::max(g, b));
  const float mn = std::min(r, std::min(g, b));
  const float d = mx - mn;
  float h = 0.0f;
  if (d > 0.0f) {
    if (mx == r)
      h = (g - b) / d;
    else if (mx == g)
      h = 2.0f + (b - r) / d;
    else
      h = 4.0f + (r - g) / d;
    h /= 6.0f;
    if (h < 0.0f) h += 1.0f;
  }
  const float s = mx > 0.0f ? d / mx : 0.0f;
  float v = mx;

  h += dh;
  h -= std::floor(h);
  float s2 = std::max(0.0f, std::min(1.0f, s + ds));
  v = std::max(0.0f, std::min(1.0f, v + dv));

  const float i = std::floor(h * 6.0f);
  const float f = h * 6.0f - i;
  const float p = v * (1.0f - s2);
  const float q = v * (1.0f - s2 * f);
  const float t = v * (1.0f - s2 * (1.0f - f));
  switch (static_cast<int>(i) % 6) {
    case 0: r = v; g = t; b = p; break;
    case 1: r = q; g = v; b = p; break;
    case 2: r = p; g = v; b = t; break;
    case 3: r = p; g = q; b = v; break;
    case 4: r = t; g = p; b = v; break;
    default: r = v; g = p; b = q; break;
  }
}

// Fused train-time augmentation for one image, single resample pass:
// letterbox INTO a shift-scale affine INTO an optional hflip, then HSV
// jitter + /255 on the sampled pixels. Replaces the Python chain
// letterbox -> hsv -> shift_scale -> flip (data/augment.py::Transform),
// which resamples twice and runs matplotlib HSV (~79 ms/img). Box geometry
// is computed by the Python caller with the SAME parameters, so labels stay
// exactly consistent with the fallback path; pixel-level differences
// (single vs double resample, HSV after instead of before the affine, pad
// pixels left at 0) are within augmentation noise by design.
//
// params layout (9 floats per image):
//   [do_affine, scale, dx, dy, flip, do_hsv, dh, ds, dv]
void train_augment_one(const uint8_t* src, int sh, int sw, float* dst,
                       int size, const float* p) {
  const bool do_affine = p[0] > 0.5f;
  const float s = do_affine ? p[1] : 1.0f;
  const float dx = do_affine ? p[2] : 0.0f;
  const float dy = do_affine ? p[3] : 0.0f;
  const bool flip = p[4] > 0.5f;
  const bool do_hsv = p[5] > 0.5f;
  const float dh = p[6], ds = p[7], dv = p[8];

  // letterbox geometry (matches letterbox_one / data/augment.py::letterbox;
  // half-to-even in double, see letterbox_one)
  const double dr = static_cast<double>(size) / std::max(sh, sw);
  const int nh = std::max(1, static_cast<int>(std::nearbyint(sh * dr)));
  const int nw = std::max(1, static_cast<int>(std::nearbyint(sw * dr)));
  const int top = (size - nh) / 2;
  const int left = (size - nw) / 2;

  // Compose inverse maps, output -> source, in half-pixel-center coords.
  // flip:    xc = size - xo            (coordinate of the pre-flip canvas)
  // affine:  xa = (xc - c - dx*size)/s + c   with c = size/2
  //          (forward: x' = (x - c) * s + c + dx*size; shift_scale math)
  // letterbox: xs = (xa - left_offset) / r_x with r_x = nw / sw
  //          (resized pixel grid starts at `left` in canvas coords)
  const float c = size * 0.5f;
  // affine as xa = xc/s + ba
  const float ba_x = c - (c + dx * size) / s;
  const float ba_y = c - (c + dy * size) / s;
  const float rx = static_cast<float>(nw) / sw;
  const float ry = static_cast<float>(nh) / sh;
  // letterbox inverse: xs = (xa - left) / rx
  // composed: xs = (xc/s + ba - left) / rx = xc * (1/(s*rx)) + (ba-left)/rx
  float ax = 1.0f / (s * rx);
  float bx = (ba_x - left) / rx;
  const float ay = 1.0f / (s * ry);
  const float by = (ba_y - top) / ry;
  // flip folds into the x map: xc = size - xo, i.e. in half-pixel centers
  // xc_center = (size - 1) - xo_center => f(xo) = ax*(size - xo) + bx
  //   = -ax*xo + (ax*size + bx)
  if (flip) {
    bx = ax * size + bx;
    ax = -ax;
  }

  const AffineAxisTab tx = make_affine_axis(sw, size, ax, bx);
  const AffineAxisTab ty = make_affine_axis(sh, size, ay, by);

  constexpr float kInv255 = 1.0f / 255.0f;
  for (int y = 0; y < size; ++y) {
    float* out = dst + static_cast<size_t>(y) * size * 3;
    if (!ty.in_range[y]) {
      std::fill(out, out + static_cast<size_t>(size) * 3, 0.0f);
      continue;
    }
    const uint8_t* r0 = src + static_cast<size_t>(ty.i0[y]) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(ty.i1[y]) * sw * 3;
    const float wy = ty.w[y];
    for (int x = 0; x < size; ++x) {
      if (!tx.in_range[x]) {
        out[x * 3 + 0] = out[x * 3 + 1] = out[x * 3 + 2] = 0.0f;
        continue;
      }
      const int x0 = tx.i0[x] * 3, x1 = tx.i1[x] * 3;
      const float wx = tx.w[x];
      float rgb[3];
      for (int ch = 0; ch < 3; ++ch) {
        const float t0 = r0[x0 + ch] + (r0[x1 + ch] - r0[x0 + ch]) * wx;
        const float t1 = r1[x0 + ch] + (r1[x1 + ch] - r1[x0 + ch]) * wx;
        rgb[ch] = (t0 + (t1 - t0) * wy) * kInv255;
      }
      if (do_hsv) hsv_shift_px(rgb[0], rgb[1], rgb[2], dh, ds, dv);
      out[x * 3 + 0] = rgb[0];
      out[x * 3 + 1] = rgb[1];
      out[x * 3 + 2] = rgb[2];
    }
  }
}

// Mosaic cutout compose: sample ONLY the (size, size) cutout window of the
// 2x2 mosaic canvas, straight from the 4 source images. The reference (and
// the numpy fallback, data/mosaic.py) resizes all 4 images and composes the
// full (2*size)^2 canvas before slicing a (size)^2 window out of it
// (reference: code/utils.py:566-604) -- 3/4 of that resample work never
// reaches the output. Quadrant q (row-major: 0 TL, 1 TR, 2 BL, 3 BR) holds
// srcs[q] resized to (nhs[q], nws[q]), top-left anchored at
// (oy, ox) = (size*(q/2), size*(q%2)); canvas pixels no image covers are
// 255. Output pixel (y, x) is canvas pixel (yp + y, xp + x). Resampling is
// the same half-pixel-center bilinear as letterbox_one (PIL's downscale
// adds antialiasing; pixel deltas are augmentation-noise level, and box
// geometry stays in Python, identical for both paths).
void mosaic_cutout_impl(const uint8_t** srcs, const int* shs, const int* sws,
                        const int* nhs, const int* nws, int size, int yp,
                        int xp, uint8_t* dst) {
  std::memset(dst, 255, static_cast<size_t>(size) * size * 3);
  for (int q = 0; q < 4; ++q) {
    const int oy = size * (q / 2);
    const int ox = size * (q % 2);
    const int nh = nhs[q], nw = nws[q];
    // overlap of the cutout window with this quadrant's image, in canvas
    // coordinates
    const int gy0 = std::max(yp, oy), gy1 = std::min(yp + size, oy + nh);
    const int gx0 = std::max(xp, ox), gx1 = std::min(xp + size, ox + nw);
    if (gy0 >= gy1 || gx0 >= gx1) continue;
    const int sh = shs[q], sw = sws[q];
    const uint8_t* src = srcs[q];
    if (nh == sh && nw == sw) {  // no resize: direct copy rows
      for (int gy = gy0; gy < gy1; ++gy) {
        const uint8_t* row = src + static_cast<size_t>(gy - oy) * sw * 3;
        uint8_t* out =
            dst + (static_cast<size_t>(gy - yp) * size + (gx0 - xp)) * 3;
        std::memcpy(out, row + static_cast<size_t>(gx0 - ox) * 3,
                    static_cast<size_t>(gx1 - gx0) * 3);
      }
      continue;
    }
    const AxisTab tx = make_axis(sw, nw);
    const AxisTab ty = make_axis(sh, nh);
    for (int gy = gy0; gy < gy1; ++gy) {
      const int ly = gy - oy;
      const uint8_t* r0 = src + static_cast<size_t>(ty.i0[ly]) * sw * 3;
      const uint8_t* r1 = src + static_cast<size_t>(ty.i1[ly]) * sw * 3;
      const float wy = ty.w[ly];
      uint8_t* out =
          dst + (static_cast<size_t>(gy - yp) * size + (gx0 - xp)) * 3;
      for (int gx = gx0; gx < gx1; ++gx) {
        const int lx = gx - ox;
        const int x0 = tx.i0[lx] * 3, x1 = tx.i1[lx] * 3;
        const float wx = tx.w[lx];
        for (int ch = 0; ch < 3; ++ch) {
          const float t0 = r0[x0 + ch] + (r0[x1 + ch] - r0[x0 + ch]) * wx;
          const float t1 = r1[x0 + ch] + (r1[x1 + ch] - r1[x0 + ch]) * wx;
          const float v = t0 + (t1 - t0) * wy;
          out[(gx - gx0) * 3 + ch] = static_cast<uint8_t>(v + 0.5f);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Mosaic cutout (see mosaic_cutout_impl). dst: uint8 (size, size, 3).
void mosaic_cutout(const uint8_t** srcs, const int* shs, const int* sws,
                   const int* nhs, const int* nws, int size, int yp, int xp,
                   uint8_t* dst) {
  mosaic_cutout_impl(srcs, shs, sws, nhs, nws, size, yp, xp, dst);
}

// Batched fused train augmentation: n images -> float32 (n, size, size, 3),
// per-image 9-float param rows (see train_augment_one). Threaded across
// images like batch_letterbox_normalize.
void batch_train_augment(const uint8_t** srcs, const int* shs, const int* sws,
                         int n, const float* params, float* dst, int size,
                         int num_threads) {
  const size_t plane = static_cast<size_t>(size) * size * 3;
  num_threads = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([=]() {
      for (int i = t; i < n; i += num_threads) {
        train_augment_one(srcs[i], shs[i], sws[i], dst + i * plane, size,
                          params + static_cast<size_t>(i) * 9);
      }
    });
  }
  for (auto& w : workers) w.join();
}

// Batch letterbox+normalize: n images (pointer + dims arrays) into a
// preallocated float32 (n, size, size, 3) buffer. Threaded across images.
void batch_letterbox_normalize(const uint8_t** srcs, const int* shs,
                               const int* sws, int n, float* dst, int size,
                               float pad_value, int num_threads) {
  const size_t plane = static_cast<size_t>(size) * size * 3;
  num_threads = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([=]() {
      for (int i = t; i < n; i += num_threads) {
        letterbox_one(srcs[i], shs[i], sws[i], dst + i * plane, size,
                      pad_value);
      }
    });
  }
  for (auto& w : workers) w.join();
}

// Single-image entry (for tests / one-off inference).
void letterbox_normalize(const uint8_t* src, int sh, int sw, float* dst,
                         int size, float pad_value) {
  letterbox_one(src, sh, sw, dst, size, pad_value);
}

}  // extern "C"
