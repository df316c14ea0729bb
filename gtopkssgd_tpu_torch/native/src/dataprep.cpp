// Host-side data prep of the PyTorch port (its own copy of
// gtopkssgd_tpu/native/src/dataprep.cpp): the per-pixel CIFAR
// augmentation and the Levenshtein distance of the AN4 decode, in C++
// behind ctypes, so per-image Python loops do not hold the card back.
//
// Design: the caller (numpy side) draws all randomness (crop offsets, flip
// coins) so the Python and C++ paths are bit-identical and unit-testable;
// C++ only does the deterministic heavy loops, threaded across the batch.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (native/__init__.py);
// no external deps.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kH = 32, kW = 32, kC = 3, kPad = 4;
constexpr int kPH = kH + 2 * kPad, kPW = kW + 2 * kPad;

// Reflect-pad one HWC image into a padded buffer (mode='reflect', matching
// numpy: index mirrors without repeating the edge pixel).
void reflect_pad(const uint8_t* in, uint8_t* out) {
  auto src = [&](int y, int x, int c) -> uint8_t {
    return in[(y * kW + x) * kC + c];
  };
  for (int y = 0; y < kPH; ++y) {
    int sy = y - kPad;
    if (sy < 0) sy = -sy;
    if (sy >= kH) sy = 2 * kH - 2 - sy;
    for (int x = 0; x < kPW; ++x) {
      int sx = x - kPad;
      if (sx < 0) sx = -sx;
      if (sx >= kW) sx = 2 * kW - 2 - sx;
      for (int c = 0; c < kC; ++c)
        out[(y * kPW + x) * kC + c] = src(sy, sx, c);
    }
  }
}

// uint8 end to end: images stay raw pixels through augmentation (the wire
// format is uint8, 4x fewer host-to-device bytes, and the mean/std
// normalization runs on the device).
void augment_one(const uint8_t* in, uint8_t* out, int y0, int x0,
                 bool flip) {
  uint8_t padded[kPH * kPW * kC];
  reflect_pad(in, padded);
  for (int y = 0; y < kH; ++y) {
    for (int x = 0; x < kW; ++x) {
      int sx = flip ? (x0 + kW - 1 - x) : (x0 + x);
      const uint8_t* p = &padded[((y0 + y) * kPW + sx) * kC];
      uint8_t* q = &out[(y * kW + x) * kC];
      for (int c = 0; c < kC; ++c) q[c] = p[c];
    }
  }
}

void parallel_for(int n, const std::function<void(int, int)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = std::max(1, std::min<int>(hw ? (int)hw : 1, n));
  if (nt == 1) { fn(0, n); return; }
  std::vector<std::thread> ts;
  int per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// in/out: u8[B,32,32,3]; ys/xs: i32[B] crop offsets in [0,8]; flips:
// u8[B]. Fused reflect-pad(4) + crop + hflip, raw pixels in and out.
void cifar_augment_batch(const uint8_t* in, uint8_t* out, int b,
                         const int* ys, const int* xs,
                         const uint8_t* flips) {
  parallel_for(b, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i)
      augment_one(in + (size_t)i * kH * kW * kC,
                  out + (size_t)i * kH * kW * kC, ys[i], xs[i],
                  flips[i] != 0);
  });
}

// Levenshtein distance between int sequences (CER/WER eval hot loop).
int edit_distance(const int32_t* a, int la, const int32_t* b, int lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  std::vector<int> prev(lb + 1), cur(lb + 1);
  for (int j = 0; j <= lb; ++j) prev[j] = j;
  for (int i = 1; i <= la; ++i) {
    cur[0] = i;
    for (int j = 1; j <= lb; ++j)
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1] ? 1 : 0)});
    std::swap(prev, cur);
  }
  return prev[lb];
}

}  // extern "C"
