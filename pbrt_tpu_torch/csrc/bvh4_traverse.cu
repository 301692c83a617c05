// Closest-hit / any-hit traversal of a 4-wide BVH, one thread per ray.
//
// Replaces the Pallas kernel pbrt_tpu/ops/pallas_bvh.py:_make_kernel4
// (launched by _run_packets4) with the same contract: for each ray
// (o, d, t_max, mode) it returns (t f32, prim i32), prim = -1 on a miss.
//   * Triangle test: Moller-Trumbore with the constants of _tri_hit
//     (pallas_bvh.py:197-227): hit iff |det| > 1e-12, u >= 0, w >= 0,
//     u + w <= 1, t > 1e-4 and t < t_best.  The watertight test stays in
//     hit_record, which re-derives the hit from the prim id.
//   * Slab test: the far bound is scaled by 1.0000004; a child is entered
//     iff t_near <= t_far, t_far > 0 and t_near < t_best.
//   * Lanes with mode > 0 are any-hit: they stop at their first hit and
//     return t = -1e30.  Lanes with t_max <= 0 are dead: t = t_max,
//     prim = -1, no visit.
//   * Leaf records whose type is not 0 (quadrics) are skipped; the caller
//     tests quadrics in a separate pass.
//   * Thread j traces ray order[j] (order may be null: the identity) and
//     writes its result at order[j].  order must be a permutation of
//     0..n-1; a ray's result depends on nothing but its own inputs, so the
//     order changes the speed, never a bit of the results.
//
// Layout (built by pbrt_tpu_torch/ops/bvh.py:build_bvh4_table):
//   nodes: one 128-byte row per 4-wide node: 4 child boxes (6 f32 each),
//          4 int32 refs, 4 int32 counts (-1 empty, 0 interior, >0 leaf).
//          A leaf ref is the first primitive of the leaf in BVH order.
//   tris:  three float4 per primitive, in BVH order: (v0, type), (e1, 0),
//          (e2, 0) with e1 = v1 - v0 and e2 = v2 - v0.  The primitive's
//          index in this table is its prim id.
//
// What bounds it on an H100: the node rows and triangle records read per ray
// (128 B per node visit, 48 B per triangle test) from L2 and device memory,
// and the latency of those dependent loads.  The design keeps each node visit
// to one 128-byte line (8 float4 loads through the read-only path), visits
// children nearest first by the ray's own t_near so closest-hit rays cull
// early, and stops any-hit rays at their first hit.  The caller sorts rays by
// (dead, direction octant, origin Morton code) and passes the permutation as
// `order`: neighbouring threads walk similar paths through the tree, dead
// rays fill whole warps at the end of the grid, and no gather or scatter
// pass runs around the launch.  Persistent warps fetching from a counter,
// the stack in shared memory and the top rows of the tree in shared memory
// were each measured slower on an H100 with the main scene's tables in L2
// (PERF.md); the likely reason is that shared memory is carved out of the
// L1 that, through the read-only path, already keeps the top of the tree
// and the touched part of each local stack.
//
// Stack: STACK_SIZE entries per thread.  An interior visit pushes at most 3
// entries, so a tree of depth D needs at most 3 * D; the host wrapper checks
// that against bvh4_traverse_stack_size() and refuses deeper trees.  The
// kernel traps rather than overflow silently.
//
// Built with -fmad=false so its float arithmetic rounds exactly as the plain
// PyTorch version in ops/bvh.py does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStackSize = 128;
constexpr uint32_t kLeafFlag = 0x80000000u;
constexpr int kBlock = 128;

__device__ __forceinline__ int as_int(float x) { return __float_as_int(x); }

__global__ void __launch_bounds__(kBlock)
bvh4_traverse_kernel(const float4 *__restrict__ nodes,
                     const float4 *__restrict__ tris,
                     const float *__restrict__ o, const float *__restrict__ d,
                     const float *__restrict__ t_max,
                     const float *__restrict__ mode,
                     const int *__restrict__ order, float *__restrict__ t_out,
                     int *__restrict__ prim_out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int i = order ? order[j] : j;
  float t_best = t_max[i];
  // A dead lane (nothing can satisfy 1e-4 < t < t_max) reads nothing else:
  // through `order` each of its reads would be a scattered sector.
  if (!(t_best > 0.f)) {
    t_out[i] = t_best;
    prim_out[i] = -1;
    return;
  }
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const bool any_hit = mode[i] > 0.f;
  int prim = -1;
  const float inv_dx = 1.f / (dx == 0.f ? 1e-30f : dx);
  const float inv_dy = 1.f / (dy == 0.f ? 1e-30f : dy);
  const float inv_dz = 1.f / (dz == 0.f ? 1e-30f : dz);

  uint32_t stack[kStackSize];
  int sp = 0;
  uint32_t entry = 0;  // the root node
  bool done = false;
  while (true) {
    if (entry & kLeafFlag) {
      const int first = (int)(entry & 0xFFFFFFu);
      const int count = (int)((entry >> 24) & 0x7Fu);
      for (int k = 0; k < count; ++k) {
        const float4 a = __ldg(&tris[3 * (first + k)]);
        if (a.w != 0.f) continue;  // not a triangle
        const float4 e1 = __ldg(&tris[3 * (first + k) + 1]);
        const float4 e2 = __ldg(&tris[3 * (first + k) + 2]);
        const float px = dy * e2.z - dz * e2.y;
        const float py = dz * e2.x - dx * e2.z;
        const float pz = dx * e2.y - dy * e2.x;
        const float det = e1.x * px + e1.y * py + e1.z * pz;
        const float inv_det = 1.f / (fabsf(det) < 1e-12f ? 1e-12f : det);
        const float tx = ox - a.x, ty = oy - a.y, tz = oz - a.z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1.z - tz * e1.y;
        const float qy = tz * e1.x - tx * e1.z;
        const float qz = tx * e1.y - ty * e1.x;
        const float w = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
        if (fabsf(det) > 1e-12f && u >= 0.f && w >= 0.f && u + w <= 1.f &&
            t > 1e-4f && t < t_best) {
          t_best = t;
          prim = first + k;
          if (any_hit) {
            t_best = -1e30f;
            done = true;
            break;
          }
        }
      }
      if (done) break;
    } else {
      const float4 *row = nodes + 8 * (size_t)entry;
      float f[32];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = __ldg(&row[q]);
        f[4 * q] = v.x;
        f[4 * q + 1] = v.y;
        f[4 * q + 2] = v.z;
        f[4 * q + 3] = v.w;
      }
      float key[4];
      uint32_t ref[4];
      int slot[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cnt = as_int(f[28 + c]);
        const float t0x = (f[6 * c] - ox) * inv_dx;
        const float t1x = (f[6 * c + 3] - ox) * inv_dx;
        const float t0y = (f[6 * c + 1] - oy) * inv_dy;
        const float t1y = (f[6 * c + 4] - oy) * inv_dy;
        const float t0z = (f[6 * c + 2] - oz) * inv_dz;
        const float t1z = (f[6 * c + 5] - oz) * inv_dz;
        const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                               fminf(t0z, t1z));
        const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fmaxf(t0z, t1z)) * 1.0000004f;
        const bool hit = cnt >= 0 && tn <= tf && tf > 0.f && tn < t_best;
        key[c] = hit ? tn : __int_as_float(0x7f800000);  // +inf = miss
        const uint32_t r = (uint32_t)as_int(f[24 + c]);
        ref[c] = cnt > 0 ? (kLeafFlag | ((uint32_t)cnt << 24) | r) : r;
        slot[c] = c;
      }
      // Sort the 4 children by (t_near, slot): a 5-comparator network.
#define CSWAP(a, b)                                                        \
  if (key[a] > key[b] || (key[a] == key[b] && slot[a] > slot[b])) {        \
    float tk = key[a]; key[a] = key[b]; key[b] = tk;                       \
    uint32_t tr = ref[a]; ref[a] = ref[b]; ref[b] = tr;                    \
    int ts = slot[a]; slot[a] = slot[b]; slot[b] = ts;                     \
  }
      CSWAP(0, 1) CSWAP(2, 3) CSWAP(0, 2) CSWAP(1, 3) CSWAP(1, 2)
#undef CSWAP
      // Push the farther hit children, farthest first; descend the nearest.
#pragma unroll
      for (int c = 3; c >= 1; --c) {
        if (key[c] != __int_as_float(0x7f800000)) {
          if (sp >= kStackSize) __trap();
          stack[sp++] = ref[c];
        }
      }
      if (key[0] != __int_as_float(0x7f800000)) {
        entry = ref[0];
        continue;
      }
    }
    if (sp == 0) break;
    entry = stack[--sp];
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
}

}  // namespace

extern "C" {

int bvh4_traverse_stack_size() { return kStackSize; }

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
// `order` (may be null: the identity) lists the rays to trace.
int bvh4_traverse(const void *nodes, const void *tris, const void *o,
                  const void *d, const void *t_max, const void *mode,
                  const void *order, void *t_out, void *prim_out, int n,
                  void *stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  bvh4_traverse_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float4 *)nodes, (const float4 *)tris, (const float *)o,
      (const float *)d, (const float *)t_max, (const float *)mode,
      (const int *)order, (float *)t_out, (int *)prim_out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
