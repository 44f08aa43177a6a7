// Binned-SAH BVH builder (C++), the native fast path for scene build.
//
// Same algorithm and output layout as ops/bvh.py (which mirrors the
// reference's BVHAccel SAH build + LinearBVHNode flatten,
// ref: src/accelerators/bvh.cpp:184-236, :640): depth-first node order,
// first child at i+1, second child index in node_right, leaf prim ranges
// contiguous under prim_order.  Exposed through a C ABI for ctypes.
//
// Built by native/bvh_native.py: g++ -O3 -march=native -shared -fPIC
// into build/native/ (file name hashed on the source and flags).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBuckets = 12;
constexpr int kMaxLeaf = 4;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Bounds {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
  void grow(const Bounds &b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
  Vec3 centroid() const {
    return {0.5f * (lo.x + hi.x), 0.5f * (lo.y + hi.y), 0.5f * (lo.z + hi.z)};
  }
};

struct BuildState {
  std::vector<Bounds> prim_bounds;
  std::vector<Vec3> centroids;
  std::vector<int64_t> order;
  // output
  float *node_min;
  float *node_max;
  int32_t *node_right;
  int32_t *node_count;
  int32_t *node_axis;
  int32_t node_ptr = 0;
  int32_t max_depth = 0;
};

struct StackEntry {
  int64_t start, end;
  int32_t depth, parent_slot;  // parent_slot < 0 -> no patch (left child)
};

void build(BuildState &st, int64_t n_prims) {
  std::vector<StackEntry> stack;
  stack.push_back({0, n_prims, 0, -1});
  while (!stack.empty()) {
    StackEntry e = stack.back();
    stack.pop_back();
    int32_t idx = st.node_ptr++;
    if (e.parent_slot >= 0) st.node_right[e.parent_slot] = idx;
    st.max_depth = std::max(st.max_depth, e.depth);

    Bounds nb;
    Bounds cb;
    for (int64_t i = e.start; i < e.end; i++) {
      nb.grow(st.prim_bounds[st.order[i]]);
      cb.grow(st.centroids[st.order[i]]);
    }
    st.node_min[3 * idx] = nb.lo.x;
    st.node_min[3 * idx + 1] = nb.lo.y;
    st.node_min[3 * idx + 2] = nb.lo.z;
    st.node_max[3 * idx] = nb.hi.x;
    st.node_max[3 * idx + 1] = nb.hi.y;
    st.node_max[3 * idx + 2] = nb.hi.z;

    int64_t n = e.end - e.start;
    if (n <= 1) {
      st.node_right[idx] = (int32_t)e.start;
      st.node_count[idx] = (int32_t)n;
      st.node_axis[idx] = 0;
      continue;
    }

    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    st.node_axis[idx] = axis;

    int64_t mid;
    if (ext[axis] < 1e-12f) {
      if (n <= kMaxLeaf * 4) {
        st.node_right[idx] = (int32_t)e.start;
        st.node_count[idx] = (int32_t)n;
        continue;
      }
      mid = e.start + n / 2;
    } else {
      const float lo_a = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
      const float inv = (float)kBuckets / ext[axis];
      Bounds bb[kBuckets];
      int64_t cnt[kBuckets] = {0};
      auto bucket_of = [&](int64_t prim) {
        const Vec3 &c = st.centroids[prim];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = (int)((v - lo_a) * inv);
        return std::min(std::max(b, 0), kBuckets - 1);
      };
      for (int64_t i = e.start; i < e.end; i++) {
        int b = bucket_of(st.order[i]);
        bb[b].grow(st.prim_bounds[st.order[i]]);
        cnt[b]++;
      }
      // SAH cost of split after bucket k
      float best_cost = std::numeric_limits<float>::infinity();
      int best = -1;
      float total_area = std::max(nb.area(), 1e-20f);
      for (int k = 0; k < kBuckets - 1; k++) {
        Bounds bl, br;
        int64_t cl = 0, cr = 0;
        for (int j = 0; j <= k; j++) {
          bl.grow(bb[j]);
          cl += cnt[j];
        }
        for (int j = k + 1; j < kBuckets; j++) {
          br.grow(bb[j]);
          cr += cnt[j];
        }
        if (cl == 0 || cr == 0) continue;
        float cost = 1.f + (bl.area() * cl + br.area() * cr) / total_area;
        if (cost < best_cost) {
          best_cost = cost;
          best = k;
        }
      }
      if (best < 0) {
        mid = e.start + n / 2;
        std::nth_element(
            st.order.begin() + e.start, st.order.begin() + mid,
            st.order.begin() + e.end, [&](int64_t a, int64_t b) {
              const Vec3 &ca = st.centroids[a];
              const Vec3 &cb2 = st.centroids[b];
              float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
              float vb = axis == 0 ? cb2.x : (axis == 1 ? cb2.y : cb2.z);
              return va < vb;
            });
      } else {
        float leaf_cost = (float)n;
        if (n <= kMaxLeaf && leaf_cost <= best_cost) {
          st.node_right[idx] = (int32_t)e.start;
          st.node_count[idx] = (int32_t)n;
          continue;
        }
        auto it = std::partition(
            st.order.begin() + e.start, st.order.begin() + e.end,
            [&](int64_t prim) { return bucket_of(prim) <= best; });
        mid = it - st.order.begin();
        if (mid == e.start || mid == e.end) mid = e.start + n / 2;
      }
    }

    st.node_count[idx] = 0;
    // push right first so left pops next (left child = idx+1 implicitly)
    stack.push_back({mid, e.end, e.depth + 1, idx});
    stack.push_back({e.start, mid, e.depth + 1, -1});
  }
}

}  // namespace

extern "C" {

// tri_p: (n_tris, 3, 3) float32.  Outputs must be preallocated:
// node_min/max: (2*n_tris, 3) f32; node_right/count/axis: (2*n_tris,) i32;
// prim_order: (n_tris,) i64.  Returns number of nodes; max depth written
// to *out_max_depth.
int64_t bvh_build(const float *tri_p, int64_t n_tris, float *node_min,
                  float *node_max, int32_t *node_right, int32_t *node_count,
                  int32_t *node_axis, int64_t *prim_order,
                  int32_t *out_max_depth) {
  BuildState st;
  st.prim_bounds.resize(n_tris);
  st.centroids.resize(n_tris);
  st.order.resize(n_tris);
  for (int64_t i = 0; i < n_tris; i++) {
    Bounds b;
    for (int v = 0; v < 3; v++) {
      Vec3 p{tri_p[9 * i + 3 * v], tri_p[9 * i + 3 * v + 1],
             tri_p[9 * i + 3 * v + 2]};
      b.grow(p);
    }
    st.prim_bounds[i] = b;
    st.centroids[i] = b.centroid();
    st.order[i] = i;
  }
  st.node_min = node_min;
  st.node_max = node_max;
  st.node_right = node_right;
  st.node_count = node_count;
  st.node_axis = node_axis;
  build(st, n_tris);
  std::memcpy(prim_order, st.order.data(), n_tris * sizeof(int64_t));
  *out_max_depth = st.max_depth;
  return st.node_ptr;
}
}
