// Native BVH builder: binned-SAH construction -> flattened LinearBVHNode SoA.
//
// The port's own copy of native/bvh_builder.cpp (the JAX package's builder),
// unchanged in its arithmetic.  The serial host-side hot spot of scene
// compilation (pbrt's BVHAccel build, accelerators/bvh.cpp:183-658,
// re-expressed iteratively).  Semantics match pbrt_tpu_torch/accel/build.py's
// numpy builder exactly (12-bucket SAH, leaf cost = nPrims, EqualCounts
// fallback for n<=2 and degenerate splits, depth-first flattened layout with
// the first child adjacent); the numpy builder is the test oracle.
//
// Build: at first use, pbrt_tpu_torch/native.py compiles this file with
// `g++ -O3 -fPIC -shared -std=c++17` (no -march=native, so the library runs
// on any x86-64 host) into build/ and loads it with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBuckets = 12;
constexpr float kTraversalCost = 1.0f;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float surface_area(const Vec3 &mn, const Vec3 &mx) {
  float dx = std::max(mx.x - mn.x, 0.f);
  float dy = std::max(mx.y - mn.y, 0.f);
  float dz = std::max(mx.z - mn.z, 0.f);
  return 2.f * (dx * dy + dx * dz + dy * dz);
}

struct Builder {
  const double *bmin, *bmax;  // [P,3] float64 (matches numpy builder math)
  int max_prims;
  std::vector<double> cx, cy, cz;  // centroids
  // outputs
  std::vector<float> nodes_min, nodes_max;
  std::vector<int32_t> offset, nprims, axis;
  std::vector<int32_t> order;

  double centroid(int i, int d) const {
    return d == 0 ? cx[i] : (d == 1 ? cy[i] : cz[i]);
  }

  void emit_leaf(const int32_t *idx, int n, const double *mn,
                 const double *mx) {
    for (int d = 0; d < 3; ++d) {
      nodes_min.push_back((float)mn[d]);
      nodes_max.push_back((float)mx[d]);
    }
    offset.push_back((int32_t)order.size());
    nprims.push_back(n);
    axis.push_back(0);
    order.insert(order.end(), idx, idx + n);
  }

  // Returns node id of the subtree root.
  int build_range(int32_t *idx, int n) {
    int node_id = (int)nprims.size();
    double mn[3] = {1e300, 1e300, 1e300}, mx[3] = {-1e300, -1e300, -1e300};
    double cmn[3] = {1e300, 1e300, 1e300}, cmx[3] = {-1e300, -1e300, -1e300};
    for (int k = 0; k < n; ++k) {
      int i = idx[k];
      for (int d = 0; d < 3; ++d) {
        mn[d] = std::min(mn[d], bmin[3 * i + d]);
        mx[d] = std::max(mx[d], bmax[3 * i + d]);
        double c = centroid(i, d);
        cmn[d] = std::min(cmn[d], c);
        cmx[d] = std::max(cmx[d], c);
      }
    }
    if (n <= 1) {
      emit_leaf(idx, n, mn, mx);
      return node_id;
    }
    int dim = 0;
    double ext = cmx[0] - cmn[0];
    for (int d = 1; d < 3; ++d)
      if (cmx[d] - cmn[d] > ext) {
        ext = cmx[d] - cmn[d];
        dim = d;
      }
    if (cmx[dim] == cmn[dim]) {
      // Degenerate centroids: keep leaves <= max_prims (packed-leaf slots).
      if (n <= max_prims) {
        emit_leaf(idx, n, mn, mx);
        return node_id;
      }
      for (int d = 0; d < 3; ++d) {
        nodes_min.push_back((float)mn[d]);
        nodes_max.push_back((float)mx[d]);
      }
      offset.push_back(-1);
      nprims.push_back(0);
      axis.push_back(dim);
      build_range(idx, n / 2);
      offset[node_id] = build_range(idx + n / 2, n - n / 2);
      return node_id;
    }

    int mid = n / 2;
    if (n <= 2) {
      std::stable_sort(idx, idx + n, [&](int a, int b) {
        return centroid(a, dim) < centroid(b, dim);
      });
    } else {
      // Binned SAH (bvh.cpp:320-383).
      int counts[kBuckets] = {0};
      double b_min[kBuckets][3], b_max[kBuckets][3];
      for (int k = 0; k < kBuckets; ++k)
        for (int d = 0; d < 3; ++d) {
          b_min[k][d] = 1e300;
          b_max[k][d] = -1e300;
        }
      double inv = kBuckets / (cmx[dim] - cmn[dim]);
      for (int k = 0; k < n; ++k) {
        int i = idx[k];
        int b = std::min((int)((centroid(i, dim) - cmn[dim]) * inv),
                         kBuckets - 1);
        counts[b]++;
        for (int d = 0; d < 3; ++d) {
          b_min[b][d] = std::min(b_min[b][d], bmin[3 * i + d]);
          b_max[b][d] = std::max(b_max[b][d], bmax[3 * i + d]);
        }
      }
      double lmn[kBuckets][3], lmx[kBuckets][3];
      double rmn[kBuckets][3], rmx[kBuckets][3];
      int lcount[kBuckets], rcount[kBuckets];
      for (int d = 0; d < 3; ++d) {
        lmn[0][d] = b_min[0][d];
        lmx[0][d] = b_max[0][d];
        rmn[kBuckets - 1][d] = b_min[kBuckets - 1][d];
        rmx[kBuckets - 1][d] = b_max[kBuckets - 1][d];
      }
      lcount[0] = counts[0];
      rcount[kBuckets - 1] = counts[kBuckets - 1];
      for (int k = 1; k < kBuckets; ++k) {
        lcount[k] = lcount[k - 1] + counts[k];
        for (int d = 0; d < 3; ++d) {
          lmn[k][d] = std::min(lmn[k - 1][d], b_min[k][d]);
          lmx[k][d] = std::max(lmx[k - 1][d], b_max[k][d]);
        }
      }
      for (int k = kBuckets - 2; k >= 0; --k) {
        rcount[k] = rcount[k + 1] + counts[k];
        for (int d = 0; d < 3; ++d) {
          rmn[k][d] = std::min(rmn[k + 1][d], b_min[k][d]);
          rmx[k][d] = std::max(rmx[k + 1][d], b_max[k][d]);
        }
      }
      auto area = [](const double m0[3], const double m1[3]) {
        double dx = std::max(m1[0] - m0[0], 0.0);
        double dy = std::max(m1[1] - m0[1], 0.0);
        double dz = std::max(m1[2] - m0[2], 0.0);
        return 2.0 * (dx * dy + dx * dz + dy * dz);
      };
      double total_area = std::max(area(mn, mx), 1e-30);
      double best_cost = std::numeric_limits<double>::infinity();
      int best = -1;
      for (int k = 0; k < kBuckets - 1; ++k) {
        if (lcount[k] == 0 || rcount[k + 1] == 0) continue;
        double cost = kTraversalCost +
                      (lcount[k] * area(lmn[k], lmx[k]) +
                       rcount[k + 1] * area(rmn[k + 1], rmx[k + 1])) /
                          total_area;
        if (cost < best_cost) {
          best_cost = cost;
          best = k;
        }
      }
      double leaf_cost = (double)n;
      if (best >= 0 && (n > max_prims || best_cost < leaf_cost)) {
        auto pivot = std::stable_partition(idx, idx + n, [&](int i) {
          int b = std::min((int)((centroid(i, dim) - cmn[dim]) * inv),
                           kBuckets - 1);
          return b <= best;
        });
        mid = (int)(pivot - idx);
        if (mid == 0 || mid == n) {
          std::stable_sort(idx, idx + n, [&](int a, int b) {
            return centroid(a, dim) < centroid(b, dim);
          });
          mid = n / 2;
        }
      } else {
        emit_leaf(idx, n, mn, mx);
        return node_id;
      }
    }

    // Interior: reserve slot, recurse depth-first.
    for (int d = 0; d < 3; ++d) {
      nodes_min.push_back((float)mn[d]);
      nodes_max.push_back((float)mx[d]);
    }
    offset.push_back(-1);
    nprims.push_back(0);
    axis.push_back(dim);
    build_range(idx, mid);
    offset[node_id] = build_range(idx + mid, n - mid);
    return node_id;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes, or -1 on overflow of the output buffers.
// bounds are float64 [P,3]; outputs preallocated to max_nodes / n_prims.
int32_t bvh_build(const double *bounds_min, const double *bounds_max,
                  int32_t n_prims, int32_t max_prims_in_node,
                  int32_t max_nodes, float *out_nodes_min,
                  float *out_nodes_max, int32_t *out_offset,
                  int32_t *out_nprims, int32_t *out_axis,
                  int32_t *out_order) {
  Builder b;
  b.bmin = bounds_min;
  b.bmax = bounds_max;
  b.max_prims = max_prims_in_node;
  b.cx.resize(n_prims);
  b.cy.resize(n_prims);
  b.cz.resize(n_prims);
  for (int i = 0; i < n_prims; ++i) {
    b.cx[i] = 0.5 * (bounds_min[3 * i] + bounds_max[3 * i]);
    b.cy[i] = 0.5 * (bounds_min[3 * i + 1] + bounds_max[3 * i + 1]);
    b.cz[i] = 0.5 * (bounds_min[3 * i + 2] + bounds_max[3 * i + 2]);
  }
  b.nodes_min.reserve(6 * (size_t)n_prims);
  std::vector<int32_t> idx(n_prims);
  for (int i = 0; i < n_prims; ++i) idx[i] = i;
  b.build_range(idx.data(), n_prims);

  int32_t n_nodes = (int32_t)b.nprims.size();
  if (n_nodes > max_nodes) return -1;
  std::memcpy(out_nodes_min, b.nodes_min.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_nodes_max, b.nodes_max.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_offset, b.offset.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(out_nprims, b.nprims.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(out_axis, b.axis.data(), sizeof(int32_t) * n_nodes);
  std::memcpy(out_order, b.order.data(), sizeof(int32_t) * n_prims);
  return n_nodes;
}
}
