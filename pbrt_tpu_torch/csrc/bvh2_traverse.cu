// Closest-hit / any-hit traversal of a binary BVH, one thread per ray.
//
// Replaces the Pallas kernel pbrt_tpu/ops/pallas_bvh.py:_make_kernel
// (pallas_bvh.py:230, launched by _run_packets, chosen there by
// PBRT_TPU_BVH4=0) with the same contract as bvh4_traverse.cu: for each ray
// (o, d, t_max, mode) it returns (t f32, prim i32), prim = -1 on a miss.
//   * Triangle test: Moller-Trumbore with the constants of _tri_hit
//     (pallas_bvh.py:197-227): hit iff |det| > 1e-12, u >= 0, w >= 0,
//     u + w <= 1, t > 1e-4 and t < t_best.
//   * Slab test: the far bound is scaled by 1.0000004; a child is entered
//     iff t_near <= t_far, t_far > 0 and t_near < t_best.
//   * Lanes with mode > 0 are any-hit: they stop at their first hit and
//     return t = -1e30.  Lanes with t_max <= 0 are dead: they read only
//     their t_max and return t = t_max, prim = -1.
//   * Leaf records whose type is not 0 (quadrics) are skipped; the caller
//     tests quadrics in a separate pass.
//   * Thread j traces ray order[j] (order may be null: the identity) and
//     writes its result at order[j], so the caller's ray sort needs no
//     gather or scatter pass around the launch.
//
// Layout (built by pbrt_tpu_torch/ops/bvh.py:build_bvh2_table): one 64-byte
// row per interior node that holds both of its children: child 0's box
// (min xyz, max xyz), child 1's box, then int32 ref0, ref1, count0 |
// axis << 16, count1 (count -1 empty, 0 interior with the ref a row id,
// > 0 a leaf with the ref its first primitive).  Row 0 is a virtual parent
// whose child 0 is the root and child 1 empty, so a root that is a leaf
// needs no case of its own.  Leaves have no rows: they read the same
// triangle records as bvh4_traverse.cu (three float4 per primitive in BVH
// order), so a prim id means the same in both kernels.
//
// What bounds it on an H100: the latency of the chain of dependent loads
// each ray walks, not bytes.  With one row per node (pbrt-v3's 32-byte
// LinearBVHNode, this kernel's earlier design) a ray had to fetch a child
// before it could reject it: every child of every entered node was a
// fetch, about four times the 4-wide kernel's visits, each one more link
// in the chain, and the later bounces' few live rays took 10x their bytes'
// time.  Here a row holds the children's boxes, so one fetch (four float4
// loads through the read-only path, issued together: two 32-byte sectors
// of one line) tests both children; a miss costs nothing more, and a leaf
// child goes straight to its triangles.  A ray makes about half the
// fetches, each twice the bytes, so the chain halves and the bytes stay.
// The visit order is pbrt-v3's (the near child by the ray's own
// dirIsNeg[axis]), and a pushed child keeps its t_near, tested against
// t_best when popped: the test the one-row-per-node design made on
// fetching it then, so both test the same leaves in the same order and
// return the same bits.  The caller
// sorts rays by (dead, direction octant, origin Morton code) so
// neighbouring threads walk similar paths.
//
// Stack: kStackSize (ref, count, t_near) entries per thread in local
// memory (pbrt's todo[64]; shared-memory stacks measured slower on the
// H100 for bvh4_traverse, PERF.md).  A row pushes at most one entry and a
// ray only enters rows of interior nodes, so a tree whose deepest node has
// level D needs at most D; the host wrapper checks D against
// bvh2_traverse_stack_size() and refuses deeper trees.  The kernel traps
// rather than overflow silently.
//
// Built with -fmad=false so its float arithmetic rounds exactly as the plain
// PyTorch version (ops/bvh.py:bvh2_traverse_plain) does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStackSize = 64;
constexpr int kBlock = 128;

// Slab test of one box; the same operation order as ops/bvh.py:_slab.
__device__ __forceinline__ bool slab(float lx, float ly, float lz, float hx,
                                     float hy, float hz, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float t_best, float &tn) {
  const float t0x = (lx - ox) * ix, t1x = (hx - ox) * ix;
  const float t0y = (ly - oy) * iy, t1y = (hy - oy) * iy;
  const float t0z = (lz - oz) * iz, t1z = (hz - oz) * iz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z)) * 1.0000004f;
  return tn <= tf && tf > 0.f && tn < t_best;
}

__global__ void __launch_bounds__(kBlock)
bvh2_traverse_kernel(const float4 *__restrict__ nodes,
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
  if (!(t_best > 0.f)) {  // dead lane: nothing can satisfy 1e-4 < t < t_max
    t_out[i] = t_best;
    prim_out[i] = -1;
    return;
  }
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const bool any_hit = mode[i] > 0.f;
  int prim = -1;
  const float ix = 1.f / (dx == 0.f ? 1e-30f : dx);
  const float iy = 1.f / (dy == 0.f ? 1e-30f : dy);
  const float iz = 1.f / (dz == 0.f ? 1e-30f : dz);
  const bool neg_x = ix < 0.f, neg_y = iy < 0.f, neg_z = iz < 0.f;

  int2 stack[kStackSize];  // (ref, count) of a pushed child
  float stack_tn[kStackSize];  // its t_near
  int sp = 0;
  int ref = 0, count = 0;  // the current item: row `ref`, or a leaf
  while (true) {
    if (count == 0) {
      const float4 *row = nodes + 4 * (size_t)ref;
      const float4 a = __ldg(row), b = __ldg(row + 1);
      const float4 c = __ldg(row + 2), m = __ldg(row + 3);
      // a = c0 (lo x, lo y, lo z, hi x), b = c0 (hi y, hi z), c1 (lo x, lo y)
      // c = c1 (lo z, hi x, hi y, hi z), m = ref0, ref1, count0 | axis, count1
      float tn0, tn1;
      const bool hit0 = slab(a.x, a.y, a.z, a.w, b.x, b.y, ox, oy, oz, ix, iy,
                             iz, t_best, tn0);
      const int count1 = __float_as_int(m.w);
      const bool hit1 = slab(b.z, b.w, c.x, c.y, c.z, c.w, ox, oy, oz, ix, iy,
                             iz, t_best, tn1) && count1 >= 0;
      const int meta0 = __float_as_int(m.z);
      const int count0 = meta0 & 0xFFFF;
      const int ref0 = __float_as_int(m.x), ref1 = __float_as_int(m.y);
      if (hit0 && hit1) {
        const int axis = (meta0 >> 16) & 3;
        const bool neg = axis == 0 ? neg_x : (axis == 1 ? neg_y : neg_z);
        if (sp >= kStackSize) __trap();
        stack[sp] = neg ? make_int2(ref0, count0) : make_int2(ref1, count1);
        stack_tn[sp] = neg ? tn0 : tn1;
        ++sp;
        ref = neg ? ref1 : ref0;
        count = neg ? count1 : count0;
        continue;
      }
      if (hit0 || hit1) {
        ref = hit0 ? ref0 : ref1;
        count = hit0 ? count0 : count1;
        continue;
      }
    } else {
      bool done = false;
      for (int k = 0; k < count; ++k) {
        const int p = ref + k;
        const float4 v0 = __ldg(&tris[3 * (size_t)p]);
        if (v0.w != 0.f) continue;  // not a triangle
        const float4 e1 = __ldg(&tris[3 * (size_t)p + 1]);
        const float4 e2 = __ldg(&tris[3 * (size_t)p + 2]);
        const float px = dy * e2.z - dz * e2.y;
        const float py = dz * e2.x - dx * e2.z;
        const float pz = dx * e2.y - dy * e2.x;
        const float det = e1.x * px + e1.y * py + e1.z * pz;
        const float inv_det = 1.f / (fabsf(det) < 1e-12f ? 1e-12f : det);
        const float tx = ox - v0.x, ty = oy - v0.y, tz = oz - v0.z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1.z - tz * e1.y;
        const float qy = tz * e1.x - tx * e1.z;
        const float qz = tx * e1.y - ty * e1.x;
        const float w = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
        if (fabsf(det) > 1e-12f && u >= 0.f && w >= 0.f && u + w <= 1.f &&
            t > 1e-4f && t < t_best) {
          t_best = t;
          prim = p;
          if (any_hit) {
            t_best = -1e30f;
            done = true;
            break;
          }
        }
      }
      if (done) break;
    }
    // Pop the next child still nearer than t_best; the others cost no fetch.
    while (sp > 0 && !(stack_tn[sp - 1] < t_best)) --sp;
    if (sp == 0) break;
    --sp;
    ref = stack[sp].x;
    count = stack[sp].y;
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
}

}  // namespace

extern "C" {

int bvh2_traverse_stack_size() { return kStackSize; }

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
// `order` (may be null: the identity) lists the rays to trace.
int bvh2_traverse(const void *nodes, const void *tris, const void *o,
                  const void *d, const void *t_max, const void *mode,
                  const void *order, void *t_out, void *prim_out, int n,
                  void *stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  bvh2_traverse_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float4 *)nodes, (const float4 *)tris, (const float *)o,
      (const float *)d, (const float *)t_max, (const float *)mode,
      (const int *)order, (float *)t_out, (int *)prim_out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
