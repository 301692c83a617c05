// Closest-hit / any-hit traversal of a binary BVH, one thread per ray.
//
// Replaces the Pallas kernel pbrt_tpu/ops/pallas_bvh.py:_make_kernel
// (launched by _run_packets, chosen there by PBRT_TPU_BVH4=0) with the same
// contract as bvh4_traverse.cu: for each ray (o, d, t_max, mode) it returns
// (t f32, prim i32), prim = -1 on a miss.
//   * Triangle test: Moller-Trumbore with the constants of _tri_hit
//     (pallas_bvh.py:197-227): hit iff |det| > 1e-12, u >= 0, w >= 0,
//     u + w <= 1, t > 1e-4 and t < t_best.
//   * Slab test: the far bound is scaled by 1.0000004; a node is entered
//     iff t_near <= t_far, t_far > 0 and t_near < t_best.
//   * Lanes with mode > 0 are any-hit: they stop at their first hit and
//     return t = -1e30.  Lanes with t_max <= 0 exit at the root.
//   * Leaf records whose type is not 0 (quadrics) are skipped; the caller
//     tests quadrics in a separate pass.
//
// Layout (built by pbrt_tpu_torch/ops/bvh.py:build_bvh2_table): one 32-byte
// row per node, pbrt-v3's LinearBVHNode: min xyz, max xyz (f32), then the
// int32 offset (second child of an interior node, first primitive of a
// leaf) and the int32 n_prims | axis << 16.  The first child of an interior
// node is the next row.  Leaves read the same triangle records as
// bvh4_traverse.cu (three float4 per primitive in BVH order), so a prim id
// means the same in both kernels.
//
// What bounds it on an H100: one 32-byte line per node visit (two float4
// loads through the read-only path) and 48 B per triangle test, from L2 and
// device memory, and the latency of those dependent loads; a binary tree
// takes about twice the visits of the 4-wide one for a quarter of the bytes
// each.  The TPU kernel walked 4096-ray packets with one shared stack and a
// majority vote on the direction sign, because a TPU cannot gather per
// lane.  Hopper can: each thread walks its own ray and descends to the near
// child first by the ray's own dirIsNeg[axis], as pbrt-v3's
// BVHAccel::Intersect does, so closest-hit rays cull early.  The caller
// sorts rays by (direction octant, origin Morton code) so neighbouring
// threads walk similar paths.
//
// Stack: kStackSize entries per thread (pbrt's todo[64]).  A visit pushes at
// most one entry, so a tree whose deepest node has level D needs at most D;
// the host wrapper checks D against bvh2_traverse_stack_size() and refuses
// deeper trees.  The kernel traps rather than overflow silently.
//
// Built with -fmad=false so its float arithmetic rounds exactly as the plain
// PyTorch version (ops/bvh.py:bvh2_traverse_plain) does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStackSize = 64;
constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
bvh2_traverse_kernel(const float4 *__restrict__ nodes,
                     const float4 *__restrict__ tris,
                     const float *__restrict__ o, const float *__restrict__ d,
                     const float *__restrict__ t_max,
                     const float *__restrict__ mode, float *__restrict__ t_out,
                     int *__restrict__ prim_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float t_best = t_max[i];
  const bool any_hit = mode[i] > 0.f;
  int prim = -1;
  if (!(t_best > 0.f)) {  // dead lane: nothing can satisfy 1e-4 < t < t_max
    t_out[i] = t_best;
    prim_out[i] = -1;
    return;
  }
  const float inv_dx = 1.f / (dx == 0.f ? 1e-30f : dx);
  const float inv_dy = 1.f / (dy == 0.f ? 1e-30f : dy);
  const float inv_dz = 1.f / (dz == 0.f ? 1e-30f : dz);
  const bool neg_x = inv_dx < 0.f, neg_y = inv_dy < 0.f, neg_z = inv_dz < 0.f;

  int stack[kStackSize];
  int sp = 0;
  int node = 0;
  while (true) {
    const float4 a = __ldg(&nodes[2 * (size_t)node]);
    const float4 b = __ldg(&nodes[2 * (size_t)node + 1]);
    // a = (min x, min y, min z, max x), b = (max y, max z, offset, meta)
    const float t0x = (a.x - ox) * inv_dx;
    const float t1x = (a.w - ox) * inv_dx;
    const float t0y = (a.y - oy) * inv_dy;
    const float t1y = (b.x - oy) * inv_dy;
    const float t0z = (a.z - oz) * inv_dz;
    const float t1z = (b.y - oz) * inv_dz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z)) * 1.0000004f;
    if (tn <= tf && tf > 0.f && tn < t_best) {
      const int offset = __float_as_int(b.z);
      const int meta = __float_as_int(b.w);
      const int count = meta & 0xFFFF;
      if (count > 0) {
        bool done = false;
        for (int k = 0; k < count; ++k) {
          const int p = offset + k;
          const float4 v0 = __ldg(&tris[3 * p]);
          if (v0.w != 0.f) continue;  // not a triangle
          const float4 e1 = __ldg(&tris[3 * p + 1]);
          const float4 e2 = __ldg(&tris[3 * p + 2]);
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
      } else {
        const int axis = (meta >> 16) & 3;
        const bool neg = axis == 0 ? neg_x : (axis == 1 ? neg_y : neg_z);
        if (sp >= kStackSize) __trap();
        stack[sp++] = neg ? node + 1 : offset;
        node = neg ? offset : node + 1;
        continue;
      }
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
}

}  // namespace

extern "C" {

int bvh2_traverse_stack_size() { return kStackSize; }

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError().
int bvh2_traverse(const void *nodes, const void *tris, const void *o,
                  const void *d, const void *t_max, const void *mode,
                  void *t_out, void *prim_out, int n, void *stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  bvh2_traverse_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float4 *)nodes, (const float4 *)tris, (const float *)o,
      (const float *)d, (const float *)t_max, (const float *)mode,
      (float *)t_out, (int *)prim_out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
