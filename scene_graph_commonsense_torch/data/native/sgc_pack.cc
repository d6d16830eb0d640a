// Native batch packer for the scene-graph input pipeline.
//
// The host-side hot loop of the input pipeline — reading per-image records
// and expanding the lower-triangular relation annotation into the padded
// (N, N) directed grid — is O(B * N^2) Python work per batch in the naive
// loader.  This library does it in C++ with one thread per record.
//
// Record format "SGRC" v1/v2 (little-endian), written by
// scene_graph_commonsense_torch.data.native.write_sgrec (and byte for byte
// the same by the JAX package's writer, so both packages read one set):
//   int32 magic 0x43524753 ("SGRC")
//   int32 version (1 or 2)
//   int32 num_objects N_rec
//   int32 feature_size S
//   int32 num_super K
//   float32 depth[S*S]
//   int32 cats[N_rec]
//   float32 boxes[N_rec*4]          (x_min, x_max, y_min, y_max)
//   uint8 super_mh[N_rec*K]
//   int32 rel_lower[N_rec*(N_rec-1)/2]    row-major, row i has i entries
//   float32 dir_lower[N_rec*(N_rec-1)/2]  1=subject, 0=object, -1=none
// v2 appends the raw image so TRAINING batches (which need the
// per-epoch stochastic contrastive view) can be assembled natively:
//   int32 height H, int32 width W
//   uint8 rgb[H*W*3]
//
// Exposed C ABI:
//   sgc_pack_batch       — annotation-only packing (eval path): padded
//     arrays cats (B,N) int32, boxes (B,N,4) f32, rel (B,N,N) int32,
//     valid (B,N) u8, super_mh (B,N,K) f32, depth (B,S,S) f32.  Records
//     with fewer than 2 or more than N objects are rejected (slot left
//     invalid), mirroring the dataset filter (reference
//     dataloader.py:119).  Returns packed count, or -1 on arg errors.
//   sgc_pack_train_batch — v1 payload PLUS the contrastive image views
//     from the embedded v2 image: applies the host-supplied ColorJitter
//     sample (torchvision blend semantics, matching
//     data.dataset.apply_color_jitter), truncates to uint8, resizes with
//     Pillow's exact fixed-point triangle resampling (what the Python
//     path's PIL.Image.resize(BILINEAR) does), and normalizes to the
//     [0,1]-minus-BGR-mean convention of data.dataset.square_image
//     (reference dataloader.py:43-51,101-104).  One worker thread per
//     record, like the eval packer.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int32_t kMagic = 0x43524753;  // "SGRC"

struct PackArgs {
  int max_objects;
  int feature_size;
  int num_super;
  int32_t* cats;
  float* boxes;
  int32_t* rel;
  uint8_t* valid;
  float* super_mh;
  float* depth;
};

bool read_exact(FILE* f, void* dst, size_t bytes) {
  return fread(dst, 1, bytes, f) == bytes;
}

// Packs one record into batch slot b; returns true on success.  When
// `image` is non-null the record must be v2 and the embedded raw RGB
// image is returned through image/img_h/img_w.
bool pack_one(const char* path, int b, const PackArgs& a,
              std::vector<uint8_t>* image = nullptr, int* img_h = nullptr,
              int* img_w = nullptr) {
  const int n_max = a.max_objects;
  const int s = a.feature_size;
  const int k = a.num_super;

  int32_t* cats = a.cats + static_cast<size_t>(b) * n_max;
  float* boxes = a.boxes + static_cast<size_t>(b) * n_max * 4;
  int32_t* rel = a.rel + static_cast<size_t>(b) * n_max * n_max;
  uint8_t* valid = a.valid + static_cast<size_t>(b) * n_max;
  float* super_mh = a.super_mh + static_cast<size_t>(b) * n_max * k;
  float* depth = a.depth + static_cast<size_t>(b) * s * s;

  // zero-initialize the slot (padding contract of the Python loader)
  std::memset(cats, 0, sizeof(int32_t) * n_max);
  std::memset(boxes, 0, sizeof(float) * n_max * 4);
  for (int i = 0; i < n_max * n_max; ++i) rel[i] = -1;
  std::memset(valid, 0, n_max);
  std::memset(super_mh, 0, sizeof(float) * n_max * k);
  std::memset(depth, 0, sizeof(float) * s * s);

  FILE* f = fopen(path, "rb");
  if (f == nullptr) return false;

  int32_t header[5];
  bool ok = read_exact(f, header, sizeof(header)) && header[0] == kMagic &&
            (header[1] == 1 || header[1] == 2) && header[3] == s &&
            header[4] == k;
  if (image != nullptr) ok = ok && header[1] == 2;
  const int n = ok ? header[2] : 0;
  ok = ok && n > 1 && n <= n_max;

  std::vector<int32_t> rec_cats(ok ? n : 0);
  std::vector<float> rec_boxes(ok ? n * 4 : 0);
  std::vector<uint8_t> rec_super(ok ? n * k : 0);
  const int tri = ok ? n * (n - 1) / 2 : 0;
  std::vector<int32_t> rel_lower(tri);
  std::vector<float> dir_lower(tri);

  ok = ok && read_exact(f, depth, sizeof(float) * s * s);
  ok = ok && read_exact(f, rec_cats.data(), sizeof(int32_t) * n);
  ok = ok && read_exact(f, rec_boxes.data(), sizeof(float) * n * 4);
  ok = ok && read_exact(f, rec_super.data(), n * k);
  ok = ok && read_exact(f, rel_lower.data(), sizeof(int32_t) * tri);
  ok = ok && read_exact(f, dir_lower.data(), sizeof(float) * tri);
  if (ok && image != nullptr) {
    int32_t hw[2];
    ok = read_exact(f, hw, sizeof(hw)) && hw[0] > 0 && hw[1] > 0 &&
         hw[0] <= 1 << 14 && hw[1] <= 1 << 14;
    if (ok) {
      *img_h = hw[0];
      *img_w = hw[1];
      image->resize(static_cast<size_t>(hw[0]) * hw[1] * 3);
      ok = read_exact(f, image->data(), image->size());
    }
  }
  fclose(f);
  if (!ok) {
    std::memset(depth, 0, sizeof(float) * s * s);
    return false;
  }

  std::memcpy(cats, rec_cats.data(), sizeof(int32_t) * n);
  std::memcpy(boxes, rec_boxes.data(), sizeof(float) * n * 4);
  for (int i = 0; i < n; ++i) {
    valid[i] = 1;
    for (int j = 0; j < k; ++j)
      super_mh[i * k + j] = static_cast<float>(rec_super[i * k + j]);
  }
  // lower-triangular annotation -> directed (N, N) grid
  // (same semantics as ops.pairs.directed_rel_from_lower)
  int idx = 0;
  for (int i = 1; i < n; ++i) {
    for (int j = 0; j < i; ++j, ++idx) {
      const float d = dir_lower[idx];
      const int32_t r = rel_lower[idx];
      if (d == 1.0f) {
        rel[i * n_max + j] = r;
      } else if (d == 0.0f) {
        rel[j * n_max + i] = r;
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------
// Pillow-exact triangle (BILINEAR) resampling for uint8 RGB.
//
// Replicates Pillow's Resample.c fixed-point pipeline bit for bit:
// per-axis coefficient windows with support scaled by the downscale
// ratio, coefficients quantized to 1<<22 fixed point, horizontal pass
// first into a uint8 intermediate, then the vertical pass — so the
// native aug view equals PIL.Image.resize((S,S), BILINEAR) exactly and
// converted-checkpoint parity is preserved through the native loader.
// ---------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int64_t v) {
  if (v >= (1LL << (kPrecisionBits + 8))) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Per-output-pixel integer coefficient windows for one axis.
void precompute_coeffs(int in_size, int out_size, int* ksize_out,
                       std::vector<int>& bounds,
                       std::vector<int32_t>& kk) {
  double filterscale = static_cast<double>(in_size) / out_size;
  double scale = filterscale;
  if (filterscale < 1.0) filterscale = 1.0;
  const double support = 1.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  *ksize_out = ksize;
  bounds.assign(out_size * 2, 0);
  std::vector<double> prekk(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &prekk[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      const double w = triangle_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    bounds[xx * 2 + 0] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  kk.assign(prekk.size(), 0);
  for (size_t i = 0; i < prekk.size(); ++i) {
    const double p = prekk[i] * (1 << kPrecisionBits);
    kk[i] = static_cast<int32_t>(p < 0 ? p - 0.5 : p + 0.5);
  }
}

// uint8 RGB (h, w) -> (out_h, out_w), Pillow BILINEAR semantics.
void resize_bilinear_u8(const uint8_t* src, int h, int w, int out_h,
                        int out_w, uint8_t* dst) {
  // horizontal pass: (h, w) -> (h, out_w)
  int ksize_h = 0;
  std::vector<int> bounds_h;
  std::vector<int32_t> kk_h;
  precompute_coeffs(w, out_w, &ksize_h, bounds_h, kk_h);
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * out_w * 3);
  const int64_t half = 1LL << (kPrecisionBits - 1);
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = src + static_cast<size_t>(yy) * w * 3;
    uint8_t* orow = tmp.data() + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = bounds_h[xx * 2], xmax = bounds_h[xx * 2 + 1];
      const int32_t* k = &kk_h[static_cast<size_t>(xx) * ksize_h];
      int64_t ss0 = half, ss1 = half, ss2 = half;
      for (int x = 0; x < xmax; ++x) {
        const uint8_t* p = row + static_cast<size_t>(x + xmin) * 3;
        ss0 += static_cast<int64_t>(p[0]) * k[x];
        ss1 += static_cast<int64_t>(p[1]) * k[x];
        ss2 += static_cast<int64_t>(p[2]) * k[x];
      }
      orow[xx * 3 + 0] = clip8(ss0);
      orow[xx * 3 + 1] = clip8(ss1);
      orow[xx * 3 + 2] = clip8(ss2);
    }
  }
  // vertical pass: (h, out_w) -> (out_h, out_w)
  int ksize_v = 0;
  std::vector<int> bounds_v;
  std::vector<int32_t> kk_v;
  precompute_coeffs(h, out_h, &ksize_v, bounds_v, kk_v);
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = bounds_v[yy * 2], ymax = bounds_v[yy * 2 + 1];
    const int32_t* k = &kk_v[static_cast<size_t>(yy) * ksize_v];
    uint8_t* orow = dst + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      int64_t ss0 = half, ss1 = half, ss2 = half;
      for (int y = 0; y < ymax; ++y) {
        const uint8_t* p =
            tmp.data() + (static_cast<size_t>(y + ymin) * out_w + xx) * 3;
        ss0 += static_cast<int64_t>(p[0]) * k[y];
        ss1 += static_cast<int64_t>(p[1]) * k[y];
        ss2 += static_cast<int64_t>(p[2]) * k[y];
      }
      orow[xx * 3 + 0] = clip8(ss0);
      orow[xx * 3 + 1] = clip8(ss1);
      orow[xx * 3 + 2] = clip8(ss2);
    }
  }
}

// ---------------------------------------------------------------------
// ColorJitter application (data.dataset.apply_color_jitter semantics:
// torchvision blend math on a float RGB image in 0..255).  The random
// sample (apply flag, op order, factors) is drawn host-side by
// data.dataset.color_jitter_params so the RNG stream stays in Python.
// ---------------------------------------------------------------------

constexpr float kLuma[3] = {0.2989f, 0.587f, 0.114f};

void jitter_apply(float* img, size_t npix, const float* jit) {
  // jit layout: [apply, o0, o1, o2, o3, f_bright, f_contrast, f_sat, f_hue]
  if (jit[0] < 0.5f) return;
  for (int step = 0; step < 4; ++step) {
    const int op = static_cast<int>(jit[1 + step]);
    if (op == 0) {                                   // brightness
      const float f = jit[5];
      for (size_t i = 0; i < npix * 3; ++i) img[i] *= f;
    } else if (op == 1) {                            // contrast
      const float f = jit[6];
      double acc = 0.0;
      for (size_t i = 0; i < npix; ++i)
        acc += img[i * 3] * kLuma[0] + img[i * 3 + 1] * kLuma[1] +
               img[i * 3 + 2] * kLuma[2];
      const float mean = static_cast<float>(acc / npix) * (1.0f - f);
      for (size_t i = 0; i < npix * 3; ++i) img[i] = img[i] * f + mean;
    } else if (op == 2) {                            // saturation
      const float f = jit[7];
      for (size_t i = 0; i < npix; ++i) {
        const float gray =
            (img[i * 3] * kLuma[0] + img[i * 3 + 1] * kLuma[1] +
             img[i * 3 + 2] * kLuma[2]) * (1.0f - f);
        img[i * 3] = img[i * 3] * f + gray;
        img[i * 3 + 1] = img[i * 3 + 1] * f + gray;
        img[i * 3 + 2] = img[i * 3 + 2] * f + gray;
      }
    } else {                                         // hue (HSV rotation)
      const float hf = jit[8];
      for (size_t i = 0; i < npix; ++i) {
        float r = img[i * 3], g = img[i * 3 + 1], b = img[i * 3 + 2];
        r = (r < 0 ? 0 : (r > 255 ? 255 : r)) / 255.0f;
        g = (g < 0 ? 0 : (g > 255 ? 255 : g)) / 255.0f;
        b = (b < 0 ? 0 : (b > 255 ? 255 : b)) / 255.0f;
        const float maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
        const float minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
        const float v = maxc;
        const float deltac = maxc - minc;
        const float s = maxc > 0 ? deltac / (maxc > 1e-12f ? maxc : 1e-12f)
                                 : 0.0f;
        const float dc = deltac > 0 ? deltac : 1.0f;
        const float rc = (maxc - r) / dc;
        const float gc = (maxc - g) / dc;
        const float bc = (maxc - b) / dc;
        float hch = r == maxc ? bc - gc
                              : (g == maxc ? 2.0f + rc - bc
                                           : 4.0f + gc - rc);
        hch = deltac > 0 ? std::fmod(hch / 6.0f, 1.0f) : 0.0f;
        if (hch < 0) hch += 1.0f;
        hch = std::fmod(hch + hf, 1.0f);
        if (hch < 0) hch += 1.0f;
        const float i6 = std::floor(hch * 6.0f);
        const float frac = hch * 6.0f - i6;
        const float p = v * (1.0f - s);
        const float q = v * (1.0f - s * frac);
        const float t = v * (1.0f - s * (1.0f - frac));
        float ro, go, bo;
        switch (static_cast<int>(i6) % 6) {
          case 0: ro = v; go = t; bo = p; break;
          case 1: ro = q; go = v; bo = p; break;
          case 2: ro = p; go = v; bo = t; break;
          case 3: ro = p; go = q; bo = v; break;
          case 4: ro = t; go = p; bo = v; break;
          default: ro = v; go = p; bo = q; break;
        }
        img[i * 3] = ro * 255.0f;
        img[i * 3 + 1] = go * 255.0f;
        img[i * 3 + 2] = bo * 255.0f;
      }
    }
  }
}

constexpr float kBgrMean[3] = {102.9801f, 115.9465f, 122.7717f};

// jittered/plain square views of one record's embedded image.
// aug/plain are (image_size, image_size, 3) float32 buffers (plain may
// be null when features are cached host-side).
bool train_views_one(const std::vector<uint8_t>& raw, int h, int w,
                     int image_size, const float* jit, float* aug,
                     float* plain) {
  const size_t npix = static_cast<size_t>(h) * w;
  const size_t out_elems =
      static_cast<size_t>(image_size) * image_size * 3;
  std::vector<uint8_t> resized(out_elems);
  if (plain != nullptr) {
    resize_bilinear_u8(raw.data(), h, w, image_size, image_size,
                       resized.data());
    for (size_t i = 0; i < out_elems; ++i)
      plain[i] = resized[i] / 255.0f - kBgrMean[i % 3];
  }
  // aug: float jitter -> clip -> truncate to uint8 (numpy astype) ->
  // PIL resize -> [0,1] minus BGR mean (data.dataset square view quirk)
  std::vector<float> fimg(npix * 3);
  for (size_t i = 0; i < npix * 3; ++i)
    fimg[i] = static_cast<float>(raw[i]);
  jitter_apply(fimg.data(), npix, jit);
  std::vector<uint8_t> ju8(npix * 3);
  for (size_t i = 0; i < npix * 3; ++i) {
    float v = fimg[i];
    v = v < 0 ? 0 : (v > 255 ? 255 : v);
    ju8[i] = static_cast<uint8_t>(v);   // truncation, like astype(uint8)
  }
  resize_bilinear_u8(ju8.data(), h, w, image_size, image_size,
                     resized.data());
  for (size_t i = 0; i < out_elems; ++i)
    aug[i] = resized[i] / 255.0f - kBgrMean[i % 3];
  return true;
}

}  // namespace

extern "C" {

int sgc_pack_batch(const char** paths, int batch, int max_objects,
                   int feature_size, int num_super, int32_t* cats,
                   float* boxes, int32_t* rel, uint8_t* valid,
                   float* super_mh, float* depth, uint8_t* ok_flags,
                   int num_threads) {
  if (paths == nullptr || batch <= 0 || max_objects <= 1) return -1;
  PackArgs args{max_objects, feature_size, num_super, cats,
                boxes,       rel,          valid,     super_mh, depth};
  if (num_threads <= 1 || batch == 1) {
    int packed = 0;
    for (int b = 0; b < batch; ++b) {
      const bool ok = pack_one(paths[b], b, args);
      ok_flags[b] = ok ? 1 : 0;
      packed += ok ? 1 : 0;
    }
    return packed;
  }
  std::vector<std::thread> threads;
  const int workers = num_threads < batch ? num_threads : batch;
  std::vector<int> counts(workers, 0);
  for (int w = 0; w < workers; ++w) {
    threads.emplace_back([&, w]() {
      for (int b = w; b < batch; b += workers) {
        const bool ok = pack_one(paths[b], b, args);
        ok_flags[b] = ok ? 1 : 0;
        counts[w] += ok ? 1 : 0;
      }
    });
  }
  int packed = 0;
  for (int w = 0; w < workers; ++w) {
    threads[w].join();
    packed += counts[w];
  }
  return packed;
}

// Training batch: v1 annotation payload + the contrastive image views
// from v2 records.  jitter is (batch, 9) float32 rows
// [apply, o0, o1, o2, o3, f_bright, f_contrast, f_sat, f_hue] drawn by
// data.dataset.color_jitter_params; image_aug is
// (batch, image_size, image_size, 3) float32; image_plain may be null
// when the main view comes from the feature cache.
int sgc_pack_train_batch(const char** paths, int batch, int max_objects,
                         int feature_size, int num_super, int image_size,
                         const float* jitter, int32_t* cats, float* boxes,
                         int32_t* rel, uint8_t* valid, float* super_mh,
                         float* depth, float* image_aug, float* image_plain,
                         uint8_t* ok_flags, int num_threads) {
  if (paths == nullptr || batch <= 0 || max_objects <= 1 ||
      image_size <= 0 || jitter == nullptr || image_aug == nullptr)
    return -1;
  PackArgs args{max_objects, feature_size, num_super, cats,
                boxes,       rel,          valid,     super_mh, depth};
  const size_t view = static_cast<size_t>(image_size) * image_size * 3;

  auto work_one = [&](int b) -> bool {
    std::vector<uint8_t> raw;
    int h = 0, w = 0;
    std::memset(image_aug + b * view, 0, sizeof(float) * view);
    if (image_plain != nullptr)
      std::memset(image_plain + b * view, 0, sizeof(float) * view);
    if (!pack_one(paths[b], b, args, &raw, &h, &w)) return false;
    return train_views_one(
        raw, h, w, image_size, jitter + b * 9, image_aug + b * view,
        image_plain == nullptr ? nullptr : image_plain + b * view);
  };

  if (num_threads <= 1 || batch == 1) {
    int packed = 0;
    for (int b = 0; b < batch; ++b) {
      const bool ok = work_one(b);
      ok_flags[b] = ok ? 1 : 0;
      packed += ok ? 1 : 0;
    }
    return packed;
  }
  std::vector<std::thread> threads;
  const int workers = num_threads < batch ? num_threads : batch;
  std::vector<int> counts(workers, 0);
  for (int t = 0; t < workers; ++t) {
    threads.emplace_back([&, t]() {
      for (int b = t; b < batch; b += workers) {
        const bool ok = work_one(b);
        ok_flags[b] = ok ? 1 : 0;
        counts[t] += ok ? 1 : 0;
      }
    });
  }
  int packed = 0;
  for (int t = 0; t < workers; ++t) {
    threads[t].join();
    packed += counts[t];
  }
  return packed;
}

}  // extern "C"
