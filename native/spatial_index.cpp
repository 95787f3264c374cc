// Host-side 2D spatial index for vslam_jax.
//
// Capability parity with the reference's KDTree (reference src/KDTree.cpp,
// include/KDTree.h) — arena-allocated median-split k-d tree with exact
// nearest-neighbor, radius search, and the k-nearest query the reference
// declared but never implemented (KDTree.h:74-77) — plus a uniform grid
// index, which is the better structure at SLAM's point counts.
//
// On the device the equivalent queries are batched dense kernels
// (vslam_jax/matching, SURVEY.md §2 C5 note); this native index serves the
// host-side paths: dataset preprocessing, viz picking, and CPU fallback.
//
// Exposed through a plain C API for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Node {
  float x, y;
  int32_t index;    // index into the original point array
  int32_t left;     // node-array offsets, -1 = leaf
  int32_t right;
};

struct KDTree {
  std::vector<Node> nodes;  // arena; root at 0 (mirrors the single-malloc
                            // arena of the reference, KDTree.cpp:30)
  int32_t root = -1;
};

struct Grid {
  float min_x, min_y, inv_cell;
  int32_t nx, ny;
  std::vector<int32_t> cell_start;  // CSR layout
  std::vector<int32_t> entries;
  std::vector<float> xs, ys;
};

int32_t build_rec(KDTree* t, std::vector<int32_t>& idx, const float* pts,
                  int lo, int hi, int axis) {
  if (lo >= hi) return -1;
  int mid = (lo + hi) / 2;
  std::nth_element(
      idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
      [&](int32_t a, int32_t b) { return pts[2 * a + axis] < pts[2 * b + axis]; });
  int32_t me = (int32_t)t->nodes.size();
  t->nodes.push_back({pts[2 * idx[mid]], pts[2 * idx[mid] + 1], idx[mid], -1, -1});
  int32_t l = build_rec(t, idx, pts, lo, mid, 1 - axis);
  int32_t r = build_rec(t, idx, pts, mid + 1, hi, 1 - axis);
  t->nodes[me].left = l;
  t->nodes[me].right = r;
  return me;
}

void nearest_rec(const KDTree* t, int32_t ni, float qx, float qy, int axis,
                 float* best_d2, int32_t* best_i) {
  if (ni < 0) return;
  const Node& n = t->nodes[ni];
  float dx = qx - n.x, dy = qy - n.y;
  float d2 = dx * dx + dy * dy;
  if (d2 < *best_d2) { *best_d2 = d2; *best_i = n.index; }
  float delta = axis == 0 ? dx : dy;
  int32_t near = delta < 0 ? n.left : n.right;
  int32_t far = delta < 0 ? n.right : n.left;
  nearest_rec(t, near, qx, qy, 1 - axis, best_d2, best_i);
  if (delta * delta < *best_d2)
    nearest_rec(t, far, qx, qy, 1 - axis, best_d2, best_i);
}

void radius_rec(const KDTree* t, int32_t ni, float qx, float qy, float r2,
                int axis, int32_t* out, int32_t cap, int32_t* count) {
  if (ni < 0) return;
  const Node& n = t->nodes[ni];
  float dx = qx - n.x, dy = qy - n.y;
  if (dx * dx + dy * dy <= r2) {
    if (*count < cap) out[*count] = n.index;
    (*count)++;
  }
  float delta = axis == 0 ? dx : dy;
  int32_t near = delta < 0 ? n.left : n.right;
  int32_t far = delta < 0 ? n.right : n.left;
  radius_rec(t, near, qx, qy, r2, 1 - axis, out, cap, count);
  if (delta * delta <= r2)
    radius_rec(t, far, qx, qy, r2, 1 - axis, out, cap, count);
}

void knearest_rec(const KDTree* t, int32_t ni, float qx, float qy, int axis,
                  int k, float* heap_d2, int32_t* heap_i, int* heap_n) {
  if (ni < 0) return;
  const Node& n = t->nodes[ni];
  float dx = qx - n.x, dy = qy - n.y;
  float d2 = dx * dx + dy * dy;
  // max-heap of the k best
  if (*heap_n < k) {
    heap_d2[*heap_n] = d2; heap_i[*heap_n] = n.index; (*heap_n)++;
    std::push_heap(heap_d2, heap_d2 + *heap_n);
    // keep indices aligned: re-sync via full sort of pairs (k is small)
    // simpler approach: sort both arrays by d2
    for (int i = *heap_n - 1; i > 0; --i)
      if (heap_d2[i] > heap_d2[i - 1]) {
        std::swap(heap_d2[i], heap_d2[i - 1]);
        std::swap(heap_i[i], heap_i[i - 1]);
      }
  } else if (d2 < heap_d2[0]) {
    heap_d2[0] = d2; heap_i[0] = n.index;
    for (int i = 0; i + 1 < k; ++i)
      if (heap_d2[i] < heap_d2[i + 1]) {
        std::swap(heap_d2[i], heap_d2[i + 1]);
        std::swap(heap_i[i], heap_i[i + 1]);
      }
  }
  float worst = (*heap_n < k) ? INFINITY : heap_d2[0];
  float delta = axis == 0 ? dx : dy;
  int32_t near = delta < 0 ? n.left : n.right;
  int32_t far = delta < 0 ? n.right : n.left;
  knearest_rec(t, near, qx, qy, 1 - axis, k, heap_d2, heap_i, heap_n);
  worst = (*heap_n < k) ? INFINITY : heap_d2[0];
  if (delta * delta < worst)
    knearest_rec(t, far, qx, qy, 1 - axis, k, heap_d2, heap_i, heap_n);
}

}  // namespace

extern "C" {

void* kdtree_build(const float* pts_xy, int32_t n) {
  KDTree* t = new KDTree();
  t->nodes.reserve(n);
  std::vector<int32_t> idx(n);
  for (int32_t i = 0; i < n; ++i) idx[i] = i;
  t->root = build_rec(t, idx, pts_xy, 0, n, 0);
  return t;
}

void kdtree_free(void* h) { delete (KDTree*)h; }

int32_t kdtree_nearest(void* h, float qx, float qy, float* out_d2) {
  KDTree* t = (KDTree*)h;
  float best = INFINITY;
  int32_t bi = -1;
  nearest_rec(t, t->root, qx, qy, 0, &best, &bi);
  if (out_d2) *out_d2 = best;
  return bi;
}

// Returns total matches (may exceed cap; out holds the first cap).
int32_t kdtree_radius(void* h, float qx, float qy, float radius,
                      int32_t* out, int32_t cap) {
  KDTree* t = (KDTree*)h;
  int32_t count = 0;
  radius_rec(t, t->root, qx, qy, radius * radius, 0, out, cap, &count);
  return count;
}

// out_idx/out_d2 must hold k entries; returns number found. Results are
// sorted by ascending distance.
int32_t kdtree_knearest(void* h, float qx, float qy, int32_t k,
                        int32_t* out_idx, float* out_d2) {
  KDTree* t = (KDTree*)h;
  int n = 0;
  knearest_rec(t, t->root, qx, qy, 0, k, out_d2, out_idx, &n);
  // stored descending (max first); reverse to ascending
  for (int i = 0; i < n / 2; ++i) {
    std::swap(out_d2[i], out_d2[n - 1 - i]);
    std::swap(out_idx[i], out_idx[n - 1 - i]);
  }
  return n;
}

// ---- uniform grid index ---------------------------------------------------

void* grid_build(const float* pts_xy, int32_t n, float cell_size) {
  Grid* g = new Grid();
  float min_x = INFINITY, min_y = INFINITY, max_x = -INFINITY, max_y = -INFINITY;
  for (int32_t i = 0; i < n; ++i) {
    min_x = std::min(min_x, pts_xy[2 * i]);
    max_x = std::max(max_x, pts_xy[2 * i]);
    min_y = std::min(min_y, pts_xy[2 * i + 1]);
    max_y = std::max(max_y, pts_xy[2 * i + 1]);
  }
  if (n == 0) { min_x = min_y = 0; max_x = max_y = 1; }
  g->min_x = min_x; g->min_y = min_y;
  g->inv_cell = 1.0f / cell_size;
  g->nx = std::max(1, (int32_t)std::floor((max_x - min_x) * g->inv_cell) + 1);
  g->ny = std::max(1, (int32_t)std::floor((max_y - min_y) * g->inv_cell) + 1);
  g->xs.assign(pts_xy, pts_xy + 2 * n);  // interleaved; reuse xs as storage
  std::vector<int32_t> counts(g->nx * g->ny + 1, 0);
  auto cell_of = [&](int32_t i) {
    int32_t cx = (int32_t)((pts_xy[2 * i] - g->min_x) * g->inv_cell);
    int32_t cy = (int32_t)((pts_xy[2 * i + 1] - g->min_y) * g->inv_cell);
    return cy * g->nx + cx;
  };
  for (int32_t i = 0; i < n; ++i) counts[cell_of(i) + 1]++;
  for (size_t c = 1; c < counts.size(); ++c) counts[c] += counts[c - 1];
  g->cell_start = counts;
  g->entries.resize(n);
  std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
  for (int32_t i = 0; i < n; ++i) g->entries[cursor[cell_of(i)]++] = i;
  return g;
}

void grid_free(void* h) { delete (Grid*)h; }

int32_t grid_radius(void* h, float qx, float qy, float radius,
                    int32_t* out, int32_t cap) {
  Grid* g = (Grid*)h;
  float r2 = radius * radius;
  int32_t cx0 = (int32_t)std::floor((qx - radius - g->min_x) * g->inv_cell);
  int32_t cx1 = (int32_t)std::floor((qx + radius - g->min_x) * g->inv_cell);
  int32_t cy0 = (int32_t)std::floor((qy - radius - g->min_y) * g->inv_cell);
  int32_t cy1 = (int32_t)std::floor((qy + radius - g->min_y) * g->inv_cell);
  cx0 = std::max(cx0, 0); cy0 = std::max(cy0, 0);
  cx1 = std::min(cx1, g->nx - 1); cy1 = std::min(cy1, g->ny - 1);
  int32_t count = 0;
  for (int32_t cy = cy0; cy <= cy1; ++cy)
    for (int32_t cx = cx0; cx <= cx1; ++cx) {
      int32_t c = cy * g->nx + cx;
      for (int32_t e = g->cell_start[c]; e < g->cell_start[c + 1]; ++e) {
        int32_t i = g->entries[e];
        float dx = qx - g->xs[2 * i], dy = qy - g->xs[2 * i + 1];
        if (dx * dx + dy * dy <= r2) {
          if (count < cap) out[count] = i;
          count++;
        }
      }
    }
  return count;
}

}  // extern "C"
