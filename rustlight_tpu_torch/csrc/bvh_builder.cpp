// Native BVH builder: binned SAH over triangle AABBs.
//
// The reference's acceleration layer is native (Rust BVHAccel with a full SAH
// sweep, src/accel.rs:79-344, plus the optional Embree C++ backend). This is
// the TPU framework's native equivalent: the host-side build is C++ (called
// via ctypes), the traversal runs on-device (accel/bvh.py).
//
// Output layout (flattened, depth-first preorder, stackless skip links):
//   nodes[i] = { bbox_min[3], bbox_max[3], skip, prim_start, prim_count }
// Internal nodes have prim_count == 0 and their hit-successor is i+1; on a
// miss traversal jumps to `skip` (-1 = traversal done). Leaves store a range
// into the reordered primitive index array.
//
// Build: binned SAH (16 bins on the widest centroid axis), leaf size <=
// `max_leaf`, median-split fallback when SAH degenerates.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Aabb {
  float lo[3] = {1e30f, 1e30f, 1e30f};
  float hi[3] = {-1e30f, -1e30f, -1e30f};
  void grow(const Aabb& o) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], o.lo[k]);
      hi[k] = std::max(hi[k], o.hi[k]);
    }
  }
  void grow_point(const float* p) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], p[k]);
      hi[k] = std::max(hi[k], p[k]);
    }
  }
  float area() const {
    float d[3] = {std::max(hi[0] - lo[0], 0.f), std::max(hi[1] - lo[1], 0.f),
                  std::max(hi[2] - lo[2], 0.f)};
    return 2.f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
  }
};

struct Node {
  float lo[3], hi[3];
  int32_t skip = -1;
  int32_t prim_start = 0;  // internal: right-child index during build
  int32_t prim_count = 0;  // 0 for internal nodes
};

struct Builder {
  const float* aabbs;  // [n, 6] lo(3) + hi(3)
  int n;
  int max_leaf;
  std::vector<int32_t> order;
  std::vector<Node> nodes;
  std::vector<float> centroids;

  void build() {
    order.resize(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    centroids.resize(3 * size_t(n));
    for (int i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k)
        centroids[3 * size_t(i) + k] =
            0.5f * (aabbs[6 * size_t(i) + k] + aabbs[6 * size_t(i) + 3 + k]);
    nodes.reserve(size_t(2) * n);
    recurse(0, n);
    fix_skips(0, -1);
  }

  Aabb prim_aabb(int32_t p) const {
    Aabb b;
    for (int k = 0; k < 3; ++k) {
      b.lo[k] = aabbs[6 * size_t(p) + k];
      b.hi[k] = aabbs[6 * size_t(p) + 3 + k];
    }
    return b;
  }

  int recurse(int begin, int end) {
    int idx = int(nodes.size());
    nodes.push_back(Node{});
    Aabb bounds, cbounds;
    for (int i = begin; i < end; ++i) {
      bounds.grow(prim_aabb(order[i]));
      cbounds.grow_point(&centroids[3 * size_t(order[i])]);
    }
    std::memcpy(nodes[idx].lo, bounds.lo, sizeof bounds.lo);
    std::memcpy(nodes[idx].hi, bounds.hi, sizeof bounds.hi);

    int count = end - begin;
    if (count <= max_leaf) {
      nodes[idx].prim_start = begin;
      nodes[idx].prim_count = count;
      return idx;
    }

    int axis = 0;
    float ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = cbounds.hi[k] - cbounds.lo[k];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid = begin + count / 2;
    if (ext[axis] > 1e-12f) {
      constexpr int kBins = 16;
      Aabb bin_bounds[kBins];
      int bin_count[kBins] = {0};
      const float k1 = kBins * (1.f - 1e-6f) / ext[axis];
      auto bin_of = [&](int32_t p) {
        int b = int(k1 * (centroids[3 * size_t(p) + axis] - cbounds.lo[axis]));
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int i = begin; i < end; ++i) {
        int b = bin_of(order[i]);
        bin_count[b]++;
        bin_bounds[b].grow(prim_aabb(order[i]));
      }
      float right_area[kBins];
      Aabb acc;
      for (int b = kBins - 1; b >= 1; --b) {
        acc.grow(bin_bounds[b]);
        right_area[b] = acc.area();
      }
      acc = Aabb();
      float best_cost = 1e30f;
      int best_bin = -1, nleft = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        acc.grow(bin_bounds[b]);
        nleft += bin_count[b];
        if (nleft == 0 || nleft == count) continue;
        float cost = acc.area() * nleft + right_area[b + 1] * (count - nleft);
        if (cost < best_cost) {
          best_cost = cost;
          best_bin = b;
        }
      }
      if (best_bin >= 0) {
        auto it = std::partition(order.begin() + begin, order.begin() + end,
                                 [&](int32_t p) { return bin_of(p) <= best_bin; });
        mid = int(it - order.begin());
      }
      if (mid == begin || mid == end) mid = begin + count / 2;
    }
    if (mid == begin + count / 2) {
      std::nth_element(order.begin() + begin, order.begin() + mid,
                       order.begin() + end, [&](int32_t a, int32_t b) {
                         return centroids[3 * size_t(a) + axis] <
                                centroids[3 * size_t(b) + axis];
                       });
    }

    recurse(begin, mid);
    int right = recurse(mid, end);
    nodes[idx].prim_start = right;  // stash right child for fix_skips
    nodes[idx].prim_count = 0;
    return idx;
  }

  void fix_skips(int idx, int32_t skip) {
    Node& nd = nodes[idx];
    nd.skip = skip;
    if (nd.prim_count > 0) return;  // leaf
    int right = nd.prim_start;
    nd.prim_start = 0;
    fix_skips(idx + 1, right);  // left subtree misses -> right child
    fix_skips(right, skip);     // right subtree misses -> our own skip
  }
};

// Full sweep-SAH builder (the reference's algorithm, src/accel.rs:115-199:
// sort by centroid on each axis, prefix/suffix surface areas, best split
// over every axis x position). Textbook 3-sorted-arrays variant: each axis
// keeps a persistent centroid-sorted index array; a chosen split partitions
// all three arrays stably by membership, so no per-node re-sorting —
// O(n log n) total, usable at multi-M-triangle scale.
struct SweepBuilder {
  const float* aabbs;
  int n;
  int max_leaf;
  std::vector<int32_t> axis_order[3];  // prim ids sorted by centroid, per axis
  std::vector<uint8_t> in_left;        // partition scratch
  std::vector<float> right_area;       // suffix-area scratch
  std::vector<int32_t> tmp;
  std::vector<float> centroids;
  std::vector<Node> nodes;
  std::vector<int32_t> order;          // final preorder prim layout

  Aabb prim_aabb(int32_t p) const {
    Aabb b;
    for (int k = 0; k < 3; ++k) {
      b.lo[k] = aabbs[6 * size_t(p) + k];
      b.hi[k] = aabbs[6 * size_t(p) + 3 + k];
    }
    return b;
  }

  void build() {
    centroids.resize(3 * size_t(n));
    for (int i = 0; i < n; ++i)
      for (int k = 0; k < 3; ++k)
        centroids[3 * size_t(i) + k] =
            0.5f * (aabbs[6 * size_t(i) + k] + aabbs[6 * size_t(i) + 3 + k]);
    for (int a = 0; a < 3; ++a) {
      axis_order[a].resize(n);
      for (int i = 0; i < n; ++i) axis_order[a][i] = i;
      std::stable_sort(axis_order[a].begin(), axis_order[a].end(),
                       [&](int32_t x, int32_t y) {
                         return centroids[3 * size_t(x) + a] <
                                centroids[3 * size_t(y) + a];
                       });
    }
    in_left.resize(n);
    right_area.resize(size_t(n) + 1);
    tmp.resize(n);
    nodes.reserve(size_t(2) * n);
    order.reserve(n);
    recurse(0, n);
    fix_skips(0, -1);
  }

  int recurse(int begin, int end) {
    int idx = int(nodes.size());
    nodes.push_back(Node{});
    Aabb bounds;
    for (int i = begin; i < end; ++i) bounds.grow(prim_aabb(axis_order[0][i]));
    std::memcpy(nodes[idx].lo, bounds.lo, sizeof bounds.lo);
    std::memcpy(nodes[idx].hi, bounds.hi, sizeof bounds.hi);

    int count = end - begin;
    if (count <= max_leaf) {
      nodes[idx].prim_start = int32_t(order.size());
      nodes[idx].prim_count = count;
      for (int i = begin; i < end; ++i) order.push_back(axis_order[0][i]);
      return idx;
    }

    // sweep every axis: cost(i) = SA(L_i)*i + SA(R_i)*(count-i), split
    // after the i leftmost prims in that axis's centroid order
    float best_cost = 1e30f;
    int best_axis = -1, best_i = count / 2;
    for (int a = 0; a < 3; ++a) {
      const int32_t* ids = axis_order[a].data() + begin;
      Aabb acc;
      for (int i = count - 1; i >= 1; --i) {
        acc.grow(prim_aabb(ids[i]));
        right_area[i] = acc.area();
      }
      acc = Aabb();
      for (int i = 1; i < count; ++i) {
        acc.grow(prim_aabb(ids[i - 1]));
        float cost = acc.area() * i + right_area[i] * (count - i);
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = a;
          best_i = i;
        }
      }
    }
    if (best_axis < 0) best_axis = 0;  // degenerate: median on axis 0

    // membership flags from the winning axis's order, then stable-partition
    // the other two arrays so every axis keeps its sort within both halves
    for (int i = begin; i < end; ++i)
      in_left[axis_order[best_axis][i]] = uint8_t(i - begin < best_i);
    for (int a = 0; a < 3; ++a) {
      if (a == best_axis) continue;
      int32_t* ids = axis_order[a].data();
      int l = begin, r = begin + best_i;
      for (int i = begin; i < end; ++i) {
        int32_t p = ids[i];
        if (in_left[p]) tmp[l++] = p; else tmp[r++] = p;
      }
      std::memcpy(ids + begin, tmp.data() + begin,
                  size_t(count) * sizeof(int32_t));
    }

    recurse(begin, begin + best_i);
    int right = recurse(begin + best_i, end);
    nodes[idx].prim_start = right;
    nodes[idx].prim_count = 0;
    return idx;
  }

  void fix_skips(int idx, int32_t skip) {
    Node& nd = nodes[idx];
    nd.skip = skip;
    if (nd.prim_count > 0) return;
    int right = nd.prim_start;
    nd.prim_start = 0;
    // leaves already recorded their prim_start into `order` during recurse;
    // restore it: left child is idx+1, leaf starts were stashed correctly
    fix_skips(idx + 1, right);
    fix_skips(right, skip);
  }
};

}  // namespace

extern "C" {

// Returns node count. nodes_out must hold 2*n rows of 9 floats
// (bbox lo/hi + 3 int32 reinterpreted as float bits); order_out n int32s.
int rl_build_bvh(const float* aabbs, int n, int max_leaf, float* nodes_out,
                 int32_t* order_out) {
  if (n <= 0) return 0;
  Builder b{aabbs, n, max_leaf};
  b.build();
  for (size_t i = 0; i < b.nodes.size(); ++i) {
    const Node& nd = b.nodes[i];
    float* row = nodes_out + i * 9;
    std::memcpy(row, nd.lo, 3 * sizeof(float));
    std::memcpy(row + 3, nd.hi, 3 * sizeof(float));
    int32_t ints[3] = {nd.skip, nd.prim_start, nd.prim_count};
    std::memcpy(row + 6, ints, 3 * sizeof(int32_t));
  }
  std::memcpy(order_out, b.order.data(), size_t(n) * sizeof(int32_t));
  return int(b.nodes.size());
}

// Full sweep-SAH build (reference src/accel.rs:115-199 semantics). Same
// output layout as rl_build_bvh.
int rl_build_bvh_sweep(const float* aabbs, int n, int max_leaf,
                       float* nodes_out, int32_t* order_out) {
  if (n <= 0) return 0;
  SweepBuilder b;
  b.aabbs = aabbs;
  b.n = n;
  b.max_leaf = max_leaf;
  b.build();
  for (size_t i = 0; i < b.nodes.size(); ++i) {
    const Node& nd = b.nodes[i];
    float* row = nodes_out + i * 9;
    std::memcpy(row, nd.lo, 3 * sizeof(float));
    std::memcpy(row + 3, nd.hi, 3 * sizeof(float));
    int32_t ints[3] = {nd.skip, nd.prim_start, nd.prim_count};
    std::memcpy(row + 6, ints, 3 * sizeof(int32_t));
  }
  std::memcpy(order_out, b.order.data(), size_t(n) * sizeof(int32_t));
  return int(b.nodes.size());
}
}
