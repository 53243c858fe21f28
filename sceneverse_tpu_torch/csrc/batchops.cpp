// Native host-side batch assembly for the data loader hot loop.
//
// The per-object work of ScanBase._obj_processing_post (random subsample to
// num_points, center + unit-sphere normalize, loc/box computation — reference
// data/datasets/base.py:697-740) runs per item inside dataloader workers.
// This library vectorizes it in C++ across a whole batch of ragged objects,
// the analog of the reference's native (CUDA/C++) data-path components.
//
// The port's own copy of the JAX package's native/batchops.cpp, unchanged
// below this header. Built by sceneverse_tpu_torch/data/native.py with
// g++ -O3 -shared -fPIC -std=c++17 -pthread into build/native/ and loaded
// via ctypes there; the numpy path stays the
// RNG-parity reference implementation.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// xorshift128+ per-object RNG (deterministic given the seed)
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 init
    uint64_t z = seed + 0x9E3779B97F4A7C15ULL;
    auto mix = [&z]() {
      z += 0x9E3779B97F4A7C15ULL;
      uint64_t x = z;
      x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
      x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
      return x ^ (x >> 31);
    };
    s0 = mix();
    s1 = mix();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return next() % n; }
};

// Per-object core shared by obj_processing_post (prefix-offset batches) and
// assemble_objects (explicit slot scatter for whole-batch assembly).
static void process_object(const float* src, int64_t n, int64_t C,
                           int64_t num_points, const float* rot, Rng& rng,
                           float* dst, float* locs6, float* boxes6) {
  // pass 1: rotated extents + mean over the FULL object (matches the
  // reference computing loc/box before subsampling)
  double mean[3] = {0, 0, 0};
  float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i) {
    const float* p = src + i * C;
    float v[3] = {p[0], p[1], p[2]};
    if (rot) {
      float r[3];
      for (int a = 0; a < 3; ++a)
        r[a] = rot[a * 3 + 0] * v[0] + rot[a * 3 + 1] * v[1] +
               rot[a * 3 + 2] * v[2];
      v[0] = r[0]; v[1] = r[1]; v[2] = r[2];
    }
    for (int a = 0; a < 3; ++a) {
      mean[a] += v[a];
      if (v[a] < mn[a]) mn[a] = v[a];
      if (v[a] > mx[a]) mx[a] = v[a];
    }
  }
  for (int a = 0; a < 3; ++a) {
    locs6[a] = static_cast<float>(mean[a] / n);
    locs6[3 + a] = mx[a] - mn[a];
    boxes6[a] = (mx[a] + mn[a]) * 0.5f;
    boxes6[3 + a] = mx[a] - mn[a];
  }

  // pass 2: subsample, rotate, write
  double smean[3] = {0, 0, 0};
  for (int64_t j = 0; j < num_points; ++j) {
    const int64_t idx = static_cast<int64_t>(rng.below(n));
    const float* p = src + idx * C;
    float* q = dst + j * C;
    float v[3] = {p[0], p[1], p[2]};
    if (rot) {
      float r[3];
      for (int a = 0; a < 3; ++a)
        r[a] = rot[a * 3 + 0] * v[0] + rot[a * 3 + 1] * v[1] +
               rot[a * 3 + 2] * v[2];
      v[0] = r[0]; v[1] = r[1]; v[2] = r[2];
    }
    q[0] = v[0]; q[1] = v[1]; q[2] = v[2];
    for (int64_t ch = 3; ch < C; ++ch) q[ch] = p[ch];
    for (int a = 0; a < 3; ++a) smean[a] += v[a];
  }
  // center + unit-sphere normalize the SAMPLE (reference :723-728)
  float c[3];
  for (int a = 0; a < 3; ++a)
    c[a] = static_cast<float>(smean[a] / num_points);
  float max_d = 0.0f;
  for (int64_t j = 0; j < num_points; ++j) {
    float* q = dst + j * C;
    for (int a = 0; a < 3; ++a) q[a] -= c[a];
    const float d = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
    if (d > max_d) max_d = d;
  }
  if (max_d < 1e-6f) max_d = 1.0f;
  const float inv = 1.0f / max_d;
  for (int64_t j = 0; j < num_points; ++j) {
    float* q = dst + j * C;
    q[0] *= inv; q[1] *= inv; q[2] *= inv;
  }
}

// Whole-batch assembly over a materialized point store (mmap-able).
//
//   pts:      (total_points, C) float32 store
//   off/cnt:  (n_sel) per-selected-object start row / row count into pts
//   slots:    (n_sel) destination object slot (row of out_fts / out_locs /
//             out_boxes); padding slots are untouched (caller prefills)
//   rots:     (n_sel, 9) per-object row-major rotation or nullptr
//   seed:     per-batch; per-object streams derived from the slot index
//   n_threads: worker threads (<=1 -> inline)
// Outputs: out_fts (n_slots, P, C), out_locs/out_boxes (n_slots, 6).
void assemble_objects(const float* pts, const int64_t* off,
                      const int64_t* cnt, const int64_t* slots, int64_t n_sel,
                      int64_t C, int64_t num_points, const float* rots,
                      uint64_t seed, int64_t n_threads, float* out_fts,
                      float* out_locs, float* out_boxes) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t s = slots[i];
      Rng rng(seed + static_cast<uint64_t>(s) * 0x9E3779B9ULL);
      process_object(pts + off[i] * C, cnt[i], C, num_points,
                     rots ? rots + i * 9 : nullptr, rng,
                     out_fts + s * num_points * C, out_locs + s * 6,
                     out_boxes + s * 6);
    }
  };
  if (n_threads <= 1) {
    work(0, n_sel);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (n_sel + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    if (lo >= n_sel) break;
    const int64_t hi = lo + chunk < n_sel ? lo + chunk : n_sel;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// Subsample+normalize WITHOUT the full-cloud stats pass: used by the
// materialized fast path, which derives locs/boxes from offline per-object
// stats in closed form (90-degree z-rotations map axis-aligned boxes
// exactly). Halves the reads vs process_object.
static void sample_object(const float* src, int64_t n, int64_t C,
                          int64_t num_points, const float* rot, Rng& rng,
                          float* dst) {
  double smean[3] = {0, 0, 0};
  for (int64_t j = 0; j < num_points; ++j) {
    const int64_t idx = static_cast<int64_t>(rng.below(n));
    const float* p = src + idx * C;
    float* q = dst + j * C;
    float v[3] = {p[0], p[1], p[2]};
    if (rot) {
      float r[3];
      for (int a = 0; a < 3; ++a)
        r[a] = rot[a * 3 + 0] * v[0] + rot[a * 3 + 1] * v[1] +
               rot[a * 3 + 2] * v[2];
      v[0] = r[0]; v[1] = r[1]; v[2] = r[2];
    }
    q[0] = v[0]; q[1] = v[1]; q[2] = v[2];
    for (int64_t ch = 3; ch < C; ++ch) q[ch] = p[ch];
    for (int a = 0; a < 3; ++a) smean[a] += v[a];
  }
  float c[3];
  for (int a = 0; a < 3; ++a)
    c[a] = static_cast<float>(smean[a] / num_points);
  float max_d = 0.0f;
  for (int64_t j = 0; j < num_points; ++j) {
    float* q = dst + j * C;
    for (int a = 0; a < 3; ++a) q[a] -= c[a];
    const float d = std::sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
    if (d > max_d) max_d = d;
  }
  if (max_d < 1e-6f) max_d = 1.0f;
  const float inv = 1.0f / max_d;
  for (int64_t j = 0; j < num_points; ++j) {
    float* q = dst + j * C;
    q[0] *= inv; q[1] *= inv; q[2] *= inv;
  }
}

// Sample-only variant of assemble_objects (locs/boxes computed by the caller
// from offline stats). Same scatter/threading contract.
void sample_objects(const float* pts, const int64_t* off, const int64_t* cnt,
                    const int64_t* slots, int64_t n_sel, int64_t C,
                    int64_t num_points, const float* rots, uint64_t seed,
                    int64_t n_threads, float* out_fts) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t s = slots[i];
      Rng rng(seed + static_cast<uint64_t>(s) * 0x9E3779B9ULL);
      sample_object(pts + off[i] * C, cnt[i], C, num_points,
                    rots ? rots + i * 9 : nullptr, rng,
                    out_fts + s * num_points * C);
    }
  };
  if (n_threads <= 1) {
    work(0, n_sel);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (n_sel + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    if (lo >= n_sel) break;
    const int64_t hi = lo + chunk < n_sel ? lo + chunk : n_sel;
    pool.emplace_back(work, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// Process one ragged batch of objects.
//   pts:       concatenated (sum_n_i, C) float32 point clouds
//   offsets:   (n_obj + 1) int64 prefix offsets into pts
//   C:         channels (>= 3; first 3 are xyz)
//   num_points: target sample count P
//   rot:       (9) float32 row-major z-rotation matrix or nullptr
//   seed:      RNG seed (per-batch; per-object streams derived)
// Outputs:
//   out_fts:   (n_obj, P, C) subsampled + xyz-normalized
//   out_locs:  (n_obj, 6) center(mean) + size(max-min), pre-normalization
//   out_boxes: (n_obj, 6) box center + size
void obj_processing_post(const float* pts, const int64_t* offsets,
                         int64_t n_obj, int64_t C, int64_t num_points,
                         const float* rot, uint64_t seed, float* out_fts,
                         float* out_locs, float* out_boxes) {
  for (int64_t o = 0; o < n_obj; ++o) {
    const int64_t beg = offsets[o], end = offsets[o + 1];
    Rng rng(seed + static_cast<uint64_t>(o) * 0x9E3779B9ULL);
    process_object(pts + beg * C, end - beg, C, num_points, rot, rng,
                   out_fts + o * num_points * C, out_locs + o * 6,
                   out_boxes + o * 6);
  }
}

}  // extern "C"
