// rten_tpu_torch native host-side kernels (C ABI, loaded via ctypes): the
// port's own copy of rten_tpu/native/rten_native.cpp. Host C++ only; it has
// nothing to do with CUDA.
//
// The host-side hot loops around the model: tokenizer BPE merges
// (reference: rten-text/src/bpe.rs), CTC beam search (reference:
// src/ctc.rs:170), and contour tracing (reference:
// rten-imageproc/src/contours.rs). Each has a Python path in the package
// (text/models.py, ctc.py, image/contours.py) that runs where no compiler
// is found; parity is enforced by tests/test_torch_native.py.
//
// Build: python -m rten_tpu_torch.native.build   (g++ -O2 -shared -fPIC,
// into rten_tpu_torch/_build/native-<hash>/)

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BPE merge loop
// ---------------------------------------------------------------------------

struct BpeModel {
  // (left_id << 32 | right_id) -> (rank, merged_id)
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> merges;
};

void* bpe_new(int32_t n_merges, const int32_t* left, const int32_t* right,
              const int32_t* merged, const int32_t* ranks) {
  auto* m = new BpeModel();
  m->merges.reserve(static_cast<size_t>(n_merges) * 2);
  for (int32_t i = 0; i < n_merges; i++) {
    uint64_t key = (static_cast<uint64_t>(static_cast<uint32_t>(left[i])) << 32) |
                   static_cast<uint32_t>(right[i]);
    m->merges.emplace(key, std::make_pair(ranks[i], merged[i]));
  }
  return m;
}

void bpe_free(void* handle) { delete static_cast<BpeModel*>(handle); }

// Apply merges to `ids[0..n)`; writes result to `out` (capacity >= n),
// returns the output length.
int32_t bpe_apply(void* handle, const int32_t* ids, int32_t n, int32_t* out) {
  auto* m = static_cast<BpeModel*>(handle);
  std::vector<int32_t> parts(ids, ids + n);
  while (parts.size() > 1) {
    int32_t best_rank = std::numeric_limits<int32_t>::max();
    size_t best_i = 0;
    int32_t best_merged = -1;
    for (size_t i = 0; i + 1 < parts.size(); i++) {
      uint64_t key =
          (static_cast<uint64_t>(static_cast<uint32_t>(parts[i])) << 32) |
          static_cast<uint32_t>(parts[i + 1]);
      auto it = m->merges.find(key);
      if (it != m->merges.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_i = i;
        best_merged = it->second.second;
      }
    }
    if (best_merged < 0) break;
    parts[best_i] = best_merged;
    parts.erase(parts.begin() + static_cast<ptrdiff_t>(best_i) + 1);
  }
  std::memcpy(out, parts.data(), parts.size() * sizeof(int32_t));
  return static_cast<int32_t>(parts.size());
}

// ---------------------------------------------------------------------------
// CTC prefix beam search (log domain). Matches rten_tpu_torch/ctc.py semantics.
// ---------------------------------------------------------------------------

static inline double log_add(double a, double b) {
  if (a == -INFINITY) return b;
  if (b == -INFINITY) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

struct Prefix {
  std::vector<int32_t> labels;
  std::vector<int32_t> times;
};

// log_probs: [n_steps, n_classes] row-major. Returns number of labels
// written into out_labels/out_times (capacity n_steps). out_score gets the
// winning hypothesis' log prob. blank label = `blank`.
int32_t ctc_beam_search(const float* log_probs, int32_t n_steps,
                        int32_t n_classes, int32_t beam_size, int32_t blank,
                        int32_t* out_labels, int32_t* out_times,
                        double* out_score) {
  struct Entry {
    Prefix prefix;
    double pb;   // prob ending in blank
    double pnb;  // prob ending in non-blank
  };
  std::vector<Entry> beams{{Prefix{}, 0.0, -INFINITY}};

  std::vector<int32_t> top(static_cast<size_t>(n_classes));
  const int32_t n_top = std::min<int32_t>(n_classes, std::max(beam_size, 8));

  for (int32_t t = 0; t < n_steps; t++) {
    const float* row = log_probs + static_cast<size_t>(t) * n_classes;
    for (int32_t c = 0; c < n_classes; c++) top[static_cast<size_t>(c)] = c;
    std::partial_sort(top.begin(), top.begin() + n_top, top.end(),
                      [&](int32_t a, int32_t b) { return row[a] > row[b]; });

    // key: labels joined; we use a map keyed on the label vector.
    std::map<std::vector<int32_t>, Entry> next;
    auto add = [&](const Prefix& p, double pb, double pnb) {
      auto it = next.find(p.labels);
      if (it == next.end()) {
        next.emplace(p.labels, Entry{p, pb, pnb});
      } else {
        it->second.pb = log_add(it->second.pb, pb);
        it->second.pnb = log_add(it->second.pnb, pnb);
      }
    };

    for (auto& e : beams) {
      double total = log_add(e.pb, e.pnb);
      for (int32_t k = 0; k < n_top; k++) {
        int32_t c = top[static_cast<size_t>(k)];
        double p = row[c];
        if (p == -INFINITY) continue;
        if (c == blank) {
          add(e.prefix, total + p, -INFINITY);
        } else if (!e.prefix.labels.empty() && e.prefix.labels.back() == c) {
          add(e.prefix, -INFINITY, e.pnb + p);
          Prefix ext = e.prefix;
          ext.labels.push_back(c);
          ext.times.push_back(t);
          add(ext, -INFINITY, e.pb + p);
        } else {
          Prefix ext = e.prefix;
          ext.labels.push_back(c);
          ext.times.push_back(t);
          add(ext, -INFINITY, total + p);
        }
      }
    }

    std::vector<Entry> ranked;
    ranked.reserve(next.size());
    for (auto& kv : next) ranked.push_back(std::move(kv.second));
    std::sort(ranked.begin(), ranked.end(), [](const Entry& a, const Entry& b) {
      return log_add(a.pb, a.pnb) > log_add(b.pb, b.pnb);
    });
    if (static_cast<int32_t>(ranked.size()) > beam_size)
      ranked.resize(static_cast<size_t>(beam_size));
    beams = std::move(ranked);
  }

  const Entry* best = nullptr;
  double best_score = -INFINITY;
  for (auto& e : beams) {
    double s = log_add(e.pb, e.pnb);
    if (s > best_score) {
      best_score = s;
      best = &e;
    }
  }
  if (!best) return 0;
  int32_t n = static_cast<int32_t>(best->prefix.labels.size());
  std::memcpy(out_labels, best->prefix.labels.data(), static_cast<size_t>(n) * 4);
  std::memcpy(out_times, best->prefix.times.data(), static_cast<size_t>(n) * 4);
  *out_score = best_score;
  return n;
}

// ---------------------------------------------------------------------------
// Contour tracing (Moore border following; matches image/contours.py)
// ---------------------------------------------------------------------------

static const int8_t NB[8][2] = {{0, 1},  {1, 1},   {1, 0},  {1, -1},
                                {0, -1}, {-1, -1}, {-1, 0}, {-1, 1}};

// mask: [h, w] uint8 (0/1). Outputs flattened contours:
//   out_points: (y, x) pairs, capacity cap_points
//   out_sizes:  per-contour point counts, capacity cap_contours
// Returns the number of contours (or -1 if capacity exceeded).
int32_t find_contours(const uint8_t* mask, int32_t h, int32_t w,
                      int32_t* out_points, int64_t cap_points,
                      int32_t* out_sizes, int32_t cap_contours) {
  std::vector<uint8_t> visited(static_cast<size_t>(h) * w, 0);
  int64_t pt_cursor = 0;
  int32_t n_contours = 0;

  auto at = [&](int32_t y, int32_t x) -> bool {
    return y >= 0 && y < h && x >= 0 && x < w &&
           mask[static_cast<size_t>(y) * w + x] != 0;
  };

  for (int32_t y = 0; y < h; y++) {
    for (int32_t x = 0; x < w; x++) {
      size_t idx = static_cast<size_t>(y) * w + x;
      if (!mask[idx] || visited[idx]) continue;
      if (x > 0 && mask[idx - 1]) continue;  // not a left-border start

      if (n_contours >= cap_contours) return -1;
      int32_t count = 0;
      int32_t cy = y, cx = x;
      int32_t prev_dir = 4;  // entered from the west
      int64_t max_steps = static_cast<int64_t>(h) * w * 4 + 4;
      for (int64_t step = 0; step < max_steps; step++) {
        if (pt_cursor + 2 > cap_points) return -1;
        out_points[pt_cursor++] = cy;
        out_points[pt_cursor++] = cx;
        visited[static_cast<size_t>(cy) * w + cx] = 1;
        count++;

        bool found = false;
        for (int32_t i = 1; i <= 8; i++) {
          int32_t d = (prev_dir + i) % 8;
          int32_t ny = cy + NB[d][0];
          int32_t nx = cx + NB[d][1];
          if (at(ny, nx)) {
            prev_dir = (d + 4) % 8;
            cy = ny;
            cx = nx;
            found = true;
            break;
          }
        }
        if (!found) break;                      // isolated pixel
        if (cy == y && cx == x) break;          // closed the loop
      }
      out_sizes[n_contours++] = count;
    }
  }
  return n_contours;
}

}  // extern "C"
