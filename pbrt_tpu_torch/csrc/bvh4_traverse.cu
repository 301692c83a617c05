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
//   * The triangle-only build (entry point bvh4_traverse) skips leaf records
//     whose type is not 0; the caller tests the scene's few quadrics in a
//     separate pass.  The typed build (entry point bvh4_traverse_typed,
//     the same template with kTyped = true) tests every record by its
//     type, for the scenes past the JAX package's gate (more than 64
//     quadrics, curves, object instances):
//       - 0 triangle: as above;
//       - 8 instanced triangle: the record holds the shared object-space
//         triangle and, in word 7, its instance's row of inst_xf; the ray
//         is moved into object space by the row's w2i (48 B), d not
//         renormalised so t stays in world units, and meets the same
//         Moller-Trumbore test;
//       - 1-6 quadric (sphere, cylinder, disk, cone, paraboloid,
//         hyperboloid): word 4 holds its q_packed row (96 B: w2o, then the
//         parameters); the ray goes to object space and meets that type's
//         test of pbrt_tpu_torch/shapes/quadrics.py, the discriminant in
//         double-single arithmetic as there;
//       - 7 curve: word 4 holds its curve_packed row (112 B); the 16-window
//         sweep of pbrt_tpu_torch/shapes/curve.py's curve_intersect.
//     A typed record is taken iff it hits with t < t_best.  Every typed
//     test repeats the plain version's float operations in the same order,
//     with the same libdevice sqrtf, atan2f and sinf and torch's NaN rules
//     for minimum, maximum and clamp, so the typed build equals
//     bvh4_traverse_plain(typed=...) on the card bit for bit, as the
//     triangle-only build equals bvh4_traverse_plain.
//   * Thread j traces ray order[j] (order may be null: the identity) and
//     writes its result at order[j].  order must be a permutation of
//     0..n-1; a ray's result depends on nothing but its own inputs, so the
//     order changes the speed, never a bit of the results.
//   * A ray's (t, prim) depends on the order of its visits: a record is
//     taken only at t < t_best, so on a tie (a ray through a mesh's shared
//     edge or vertex) the first record tested wins.  Children are visited
//     nearest first by (t_near, slot) and a leaf's records in index order,
//     as in the plain version; the design below changes when each row and
//     record is loaded, never which ones a ray visits or in what order.
//
// Layout (built by pbrt_tpu_torch/ops/bvh.py:build_bvh4_table):
//   nodes: one 128-byte row per 4-wide node: 4 child boxes (6 f32 each),
//          4 int32 refs, 4 int32 counts (-1 empty, 0 interior, >0 leaf).
//          A leaf ref is the first primitive of the leaf in BVH order.
//   tris:  three float4 per primitive, in BVH order: (v0, type), (e1, 0),
//          (e2, 0) with e1 = v1 - v0 and e2 = v2 - v0.  The primitive's
//          index in this table is its prim id.  Other types: see above
//          (build_prim_records).
//   q_packed [Q, 24], curve_packed [C, 28], inst_xf [I, 24] float32 rows
//          (the typed build only).
//
// What bounds it on an H100.  Not bandwidth: the main scene's tables (27
// MB) sit in the 50 MB L2, and even counting every node row (128 B) and
// record (48 B) a ray reads as read from HBM, the main path's batches take
// 1.5-8x that visit bound.  What bounds them is the latency of each walk's
// chain of dependent loads (row -> slab tests and sort -> next row; record
// -> test -> next record), and the tail: a 160,000-lane launch is a single
// wave (every block resident at once), so once the short walks end the
// launch lasts as long as its slowest warps' chains, with nothing left to
// hide their latency.  Warps run at 0.32-0.85 of their lanes' work (mean
// over a warp's lanes of visits plus tests, over its slowest lane's).
//
// The design (PERF.md §6, PR 14; the times are the main path's per-spp sum
// of kernel ms, the parent kernel against each part in turns in one call,
// on an "NVIDIA H100 80GB HBM3, 700.00 W"):
//   * A leaf's records are loaded together and a record ahead.  The parent
//     loaded a record's edges only after reading its type word: two round
//     trips a record.  The triangle-only build issues a record's three
//     float4 together and the next record's before it tests this one
//     (predicated on there being one), so a leaf of k records costs about
//     one round trip instead of 2k.  Kept: main's per-spp sum 0.842-0.853x
//     the parent's, the bdpt connection batch 0.84-0.86x, mesh1M (tables
//     past the L2) 0.84-0.86x.  The typed build issues a record's three
//     float4 together but holds no next record: with the look-ahead its
//     typed loop spilled 48 B at 80 registers and the instances' typed
//     batches took 1.00-1.02x the parent's; without it 0.955x.
//   * Launch bounds per build: at least 9 blocks of 128 resident on each SM
//     for the triangle-only build (56 registers, none spilled; 60 and 8
//     blocks without the bound), 6 for the typed build (80 registers, the
//     parent's occupancy; 101 and 4 blocks without).  Kept for the
//     occupancy; the times move within the turns' spread.
//   * Tried and lost (main's per-spp sum against the parent's in the same
//     call unless named): the new stack top's row prefetched into L1 after
//     each descent 1.012x, and after each pop too 1.070x; a leaf's record
//     lines prefetched into L1 on entry, on top of the leaf loads, 0.883x
//     against 0.848x without; the top 4 (or 8) stack entries in registers,
//     shifted on each push and pop, 1.142x (1.145x); a register copy of
//     the stack top alone 0.906x against 0.886x without; the typed tests
//     out of line: the instances' typed per-spp 1.044x, and with the typed
//     build held to 64 registers 1.210x (216 B spilled); the triangle build
//     held to 48 registers (10 blocks) 1.148x (spills); two records ahead
//     0.903x against 0.849x for one; the leaf unrolled by two (no register
//     moves) 0.886x against 0.848x; blocks of 64 0.862x and of 256 0.883x
//     against 0.848x; while-while loops (interior nodes until a leaf, then
//     the leaf) 0.993x against 0.886x; persistent warps fetching 32 rays
//     from a counter 0.965x against 0.886x, and idle lanes refilled from
//     the counter whenever 4, 8 or 16 lanes of a warp are idle 1.14-1.16x;
//     the object-space ray of the last instance kept in registers (typed)
//     1.044x against 1.006x.  Earlier (PR 3): persistent warps, the stack
//     in shared memory and the top rows of the tree in shared memory were
//     each slower with the main scene's tables in L2, shared memory being
//     carved out of the L1 that keeps the top of the tree and the touched
//     part of each local stack.
//
// The caller sorts rays by (dead, direction octant, origin Morton code) and
// passes the permutation as `order`: neighbouring threads walk similar
// paths through the tree, dead rays fill whole warps at the end of the
// grid, and no gather or scatter pass runs around the launch.
//
// Stack: STACK_SIZE entries per thread, in local memory.  An interior visit
// pushes at most 3 entries, so a tree of depth D needs at most 3 * D; the
// host wrapper checks that against bvh4_traverse_stack_size() and refuses
// deeper trees.  The kernel traps rather than overflow silently.
//
// Built with -fmad=false so its float arithmetic rounds exactly as the plain
// PyTorch version in ops/bvh.py does.


#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStackSize = 128;
constexpr uint32_t kLeafFlag = 0x80000000u;
constexpr int kBlock = 128;
constexpr float kTwoPi = 6.28318530717958647692f;  // float(2 * math.pi)

__device__ __forceinline__ int as_int(float x) { return __float_as_int(x); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// torch's NaN rules: minimum/maximum give NaN if either is NaN, clamp
// keeps a NaN input.
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Moller-Trumbore with the constants of pallas_bvh.py:_tri_hit.
__device__ __forceinline__ bool mt_test(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float4 a, float4 e1, float4 e2,
                                        float t_best, float &t) {
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
  t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  return fabsf(det) > 1e-12f && u >= 0.f && w >= 0.f && u + w <= 1.f &&
         t > 1e-4f && t < t_best;
}

// ---- the typed leaves: quadrics (shapes/quadrics.py) --------------------

struct Ray3 {
  float ox, oy, oz, dx, dy, dz;
};

// xform_point / xform_vector of core/vecmath.py with 3x4 rows m.
__device__ __forceinline__ Ray3 to_object(const float *m, const Ray3 &r) {
  Ray3 q;
  q.ox = m[0] * r.ox + m[1] * r.oy + m[2] * r.oz + m[3];
  q.oy = m[4] * r.ox + m[5] * r.oy + m[6] * r.oz + m[7];
  q.oz = m[8] * r.ox + m[9] * r.oy + m[10] * r.oz + m[11];
  q.dx = m[0] * r.dx + m[1] * r.dy + m[2] * r.dz;
  q.dy = m[4] * r.dx + m[5] * r.dy + m[6] * r.dz;
  q.dz = m[8] * r.dx + m[9] * r.dy + m[10] * r.dz;
  return q;
}

// core/dsfloat.py, operation for operation.
__device__ __forceinline__ void two_sum(float a, float b, float &s, float &e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}
__device__ __forceinline__ void fast_two_sum(float a, float b, float &s,
                                             float &e) {
  s = a + b;
  e = b - (s - a);
}
__device__ __forceinline__ void split(float a, float &hi, float &lo) {
  const float c = 4097.f * a;
  hi = c - (c - a);
  lo = a - hi;
}
__device__ __forceinline__ void two_prod(float a, float b, float &p, float &e) {
  p = a * b;
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl;
}
__device__ __forceinline__ void dd_sub(float xh, float xl, float yh, float yl,
                                       float &h, float &l) {
  float sh, sl;
  two_sum(xh, -yh, sh, sl);
  sl = sl + (xl + -yl);
  fast_two_sum(sh, sl, h, l);
}

// _quadratic: returns ok; t0 <= t1.
__device__ __forceinline__ bool quadratic(float a, float b, float c, float &t0,
                                          float &t1) {
  float b2h, b2l, ach, acl, dh, dl;
  two_prod(b, b, b2h, b2l);
  two_prod(a, c, ach, acl);
  dd_sub(b2h, b2l, 4.f * ach, 4.f * acl, dh, dl);
  const bool ok = !((dh < 0.f) || ((dh == 0.f) && (dl < 0.f)));
  // dd_sqrt_to_f32
  const bool pos = dh > 0.f;
  float s = sqrtf(pos ? dh : 1.f);
  const bool refine = dh > 1e-30f;
  float s2h, s2l, rh, rl;
  two_prod(s, s, s2h, s2l);
  dd_sub(dh, dl, s2h, s2l, rh, rl);
  s = s + (refine ? rh : 0.f) / (2.f * (refine ? s : 1.f));
  const float root = pos ? s : 0.f;
  const float q = b < 0.f ? -0.5f * (b - root) : -0.5f * (b + root);
  const float r0 = q / (a == 0.f ? 1.f : a);
  const float r1 = c / (q == 0.f ? 1.f : q);
  t0 = tmin(r0, r1);
  t1 = tmax(r0, r1);
  return ok;
}

__device__ __forceinline__ float phi_of(float x, float y) {
  const bool zero = (x == 0.f) && (y == 0.f);
  float phi = atan2f(zero ? 0.f : y, zero ? 1.f : x);
  return phi < 0.f ? phi + kTwoPi : phi;
}

// pick the nearer root that passes `clip` (the plain's valid0 / valid1)
template <class Clip>
__device__ __forceinline__ bool roots_hit(bool ok, float t0, float t1,
                                          float t_max, Clip clip, float &t) {
  const bool v0 = ok && t0 > 0.f && t0 < t_max && clip(t0);
  const bool v1 = ok && t1 > 0.f && t1 < t_max && clip(t1);
  t = v0 ? t0 : t1;
  return v0 || v1;
}

__device__ bool quadric_test(int type, const float *par, const Ray3 &r,
                             float t_max, float &t) {
  float t0, t1;
  bool ok;
  switch (type) {
    case 1: {  // sphere: radius, z_min, z_max, phi_max
      const float rad = par[0], zmin = par[1], zmax = par[2], pm = par[3];
      const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
      const float b = 2.f * (r.ox * r.dx + r.oy * r.dy + r.oz * r.dz);
      const float c = (r.ox * r.ox + r.oy * r.oy + r.oz * r.oz) - rad * rad;
      ok = quadratic(a, b, c, t0, t1);
      auto clip = [&](float tt) {
        const float px = r.ox + tt * r.dx, py = r.oy + tt * r.dy;
        const float pz = r.oz + tt * r.dz;
        const bool lo = zmin > -rad ? pz >= zmin : true;
        const bool hi = zmax < rad ? pz <= zmax : true;
        return lo && hi && phi_of(px, py) <= pm;
      };
      return roots_hit(ok, t0, t1, t_max, clip, t);
    }
    case 2: {  // cylinder: radius, z_min, z_max, phi_max
      const float rad = par[0], zmin = par[1], zmax = par[2], pm = par[3];
      const float a = r.dx * r.dx + r.dy * r.dy;
      const float b = 2.f * (r.dx * r.ox + r.dy * r.oy);
      const float c = (r.ox * r.ox + r.oy * r.oy) - rad * rad;
      ok = quadratic(a, b, c, t0, t1);
      auto clip = [&](float tt) {
        const float px = r.ox + tt * r.dx, py = r.oy + tt * r.dy;
        const float pz = r.oz + tt * r.dz;
        return pz >= zmin && pz <= zmax && phi_of(px, py) <= pm;
      };
      return roots_hit(ok, t0, t1, t_max, clip, t);
    }
    case 3: {  // disk: radius, inner radius, height, phi_max
      const float rad = par[0], ri = par[1], h = par[2], pm = par[3];
      const float dz = r.dz == 0.f ? 1e-20f : r.dz;
      t = (h - r.oz) / dz;
      const float px = r.ox + t * r.dx, py = r.oy + t * r.dy;
      const float dist2 = px * px + py * py;
      return r.dz != 0.f && t > 0.f && t < t_max && dist2 <= rad * rad &&
             dist2 >= ri * ri && phi_of(px, py) <= pm;
    }
    case 4: {  // cone: radius, height, phi_max
      const float rad = par[0], h = par[1], pm = par[2];
      const float kq = rad / (h == 0.f ? 1e-12f : h);
      const float k = kq * kq;
      const float ozh = r.oz - h;
      const float a = (r.dx * r.dx + r.dy * r.dy) - k * (r.dz * r.dz);
      const float b =
          2.f * ((r.dx * r.ox + r.dy * r.oy) - k * r.dz * ozh);
      const float c = (r.ox * r.ox + r.oy * r.oy) - k * ozh * ozh;
      ok = quadratic(a, b, c, t0, t1);
      auto clip = [&](float tt) {
        const float px = r.ox + tt * r.dx, py = r.oy + tt * r.dy;
        const float pz = r.oz + tt * r.dz;
        return pz >= 0.f && pz <= h && phi_of(px, py) <= pm;
      };
      return roots_hit(ok, t0, t1, t_max, clip, t);
    }
    case 5: {  // paraboloid: radius, z_min, z_max, phi_max
      const float rad = par[0], zmin = par[1], zmax = par[2], pm = par[3];
      const float k = zmax / clamp_min(rad * rad, 1e-20f);
      const float a = k * (r.dx * r.dx + r.dy * r.dy);
      const float b = 2.f * k * (r.dx * r.ox + r.dy * r.oy) - r.dz;
      const float c = k * (r.ox * r.ox + r.oy * r.oy) - r.oz;
      ok = quadratic(a, b, c, t0, t1);
      auto clip = [&](float tt) {
        const float px = r.ox + tt * r.dx, py = r.oy + tt * r.dy;
        const float pz = r.oz + tt * r.dz;
        return pz >= zmin && pz <= zmax && phi_of(px, py) <= pm;
      };
      return roots_hit(ok, t0, t1, t_max, clip, t);
    }
    default: {  // 6 hyperboloid: ah, ch, z_min, z_max, phi_max, p1, p2
      const float ah = par[0], ch = par[1], zmin = par[2], zmax = par[3];
      const float pm = par[4];
      const float a = ah * (r.dx * r.dx + r.dy * r.dy) - ch * (r.dz * r.dz);
      const float b =
          2.f * (ah * (r.dx * r.ox + r.dy * r.oy) - ch * r.dz * r.oz);
      const float c = ah * (r.ox * r.ox + r.oy * r.oy) - ch * (r.oz * r.oz) - 1.f;
      ok = quadratic(a, b, c, t0, t1);
      const float z1 = par[7], z2 = par[10];
      const float dzp = z2 - z1;
      const float den = fabsf(dzp) < 1e-12f ? 1e-12f : dzp;
      auto clip = [&](float tt) {
        const float px = r.ox + tt * r.dx, py = r.oy + tt * r.dy;
        const float pz = r.oz + tt * r.dz;
        const float v = (pz - z1) / den;
        const float xr = (1.f - v) * par[5] + v * par[8];
        const float yr = (1.f - v) * par[6] + v * par[9];
        const float phi = phi_of(px * xr + py * yr, py * xr - px * yr);
        return pz >= zmin && pz <= zmax && phi <= pm;
      };
      return roots_hit(ok, t0, t1, t_max, clip, t);
    }
  }
}

// ---- the typed leaves: curves (shapes/curve.py curve_intersect) ---------

__device__ __forceinline__ float lerpf(float t, float a, float b) {
  return (1.f - t) * a + t * b;
}

__device__ __forceinline__ float blossom(const float *c, float u0, float u1,
                                         float u2) {
  const float a0 = lerpf(u0, c[0], c[1]);
  const float a1 = lerpf(u0, c[1], c[2]);
  const float a2 = lerpf(u0, c[2], c[3]);
  const float b0 = lerpf(u1, a0, a1);
  const float b1 = lerpf(u1, a1, a2);
  return lerpf(u2, b0, b1);
}

__device__ __forceinline__ float bezier(const float *c, float u) {
  const float a0 = lerpf(u, c[0], c[1]);
  const float a1 = lerpf(u, c[1], c[2]);
  const float a2 = lerpf(u, c[2], c[3]);
  const float b0 = lerpf(u, a0, a1);
  const float b1 = lerpf(u, a1, a2);
  return lerpf(u, b0, b1);
}

__device__ __forceinline__ bool box_miss(const float *x, float mw, float zmax) {
  const float mx = tmax(tmax(x[0], x[1]), tmax(x[2], x[3]));
  const float mn = tmin(tmin(x[0], x[1]), tmin(x[2], x[3]));
  return (mx + 0.5f * mw < 0.f) || (mn - 0.5f * mw > zmax);
}

__device__ bool curve_test(const float *__restrict__ row, const Ray3 &r,
                           float t_max, float &t_hit) {
  float f[25];
#pragma unroll
  for (int q = 0; q < 25; ++q) f[q] = __ldg(&row[q]);
  const float w0 = f[12], w1 = f[13], u0g = f[14], u1g = f[15];
  // the ray's frame (ray_frame)
  const float sx = f[9] - f[0], sy = f[10] - f[1], sz = f[11] - f[2];
  float upx = r.dy * sz - r.dz * sy;
  float upy = r.dz * sx - r.dx * sz;
  float upz = r.dx * sy - r.dy * sx;
  if (upx * upx + upy * upy + upz * upz < 1e-20f) {
    // coordinate_system(d)'s first vector
    const bool c1 = fabsf(r.dx) > fabsf(r.dy);
    const float sum_a = r.dx * r.dx + r.dz * r.dz;
    const float sum_b = r.dy * r.dy + r.dz * r.dz;
    const float inv_a = 1.f / sqrtf(clamp_min(c1 ? sum_a : sum_b, 1e-30f));
    upx = c1 ? -r.dz * inv_a : 0.f;
    upy = c1 ? 0.f : r.dz * inv_a;
    upz = c1 ? r.dx * inv_a : -r.dy * inv_a;
  }
  const float upl = sqrtf(clamp_min(upx * upx + upy * upy + upz * upz, 1e-30f));
  const float ux = upx / upl, uy = upy / upl, uz = upz / upl;
  const float r0x = uy * r.dz - uz * r.dy;
  const float r0y = uz * r.dx - ux * r.dz;
  const float r0z = ux * r.dy - uy * r.dx;
  const float rl = sqrtf(clamp_min(r0x * r0x + r0y * r0y + r0z * r0z, 1e-30f));
  const float rx = r0x / rl, ry = r0y / rl, rz = r0z / rl;
  const float nx = r.dy * rz - r.dz * ry;
  const float ny = r.dz * rx - r.dx * rz;
  const float nz = r.dx * ry - r.dy * rx;
  float cx[4], cy[4], cz[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float qx = f[3 * i] - r.ox, qy = f[3 * i + 1] - r.oy;
    const float qz = f[3 * i + 2] - r.oz;
    cx[i] = rx * qx + ry * qy + rz * qz;
    cy[i] = nx * qx + ny * qy + nz * qz;
    cz[i] = r.dx * qx + r.dy * qy + r.dz * qz;
  }
  const float zmax = t_max;
  const float max_width = tmax(lerpf(u0g, w0, w1), lerpf(u1g, w0, w1));
  if (box_miss(cy, max_width, 0.f) || box_miss(cx, max_width, 0.f) ||
      box_miss(cz, max_width, zmax))
    return false;
  // the ray's refinement depth
  float l0 = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l0 = tmax(l0, tmax(tmax(fabsf(cx[i] - 2.f * cx[i + 1] + cx[i + 2]),
                            fabsf(cy[i] - 2.f * cy[i + 1] + cy[i + 2])),
                       fabsf(cz[i] - 2.f * cz[i + 1] + cz[i + 2])));
  }
  const float eps = tmax(w0, w1) * 0.05f;
  const float lv = 8.48528137422f * l0 / (8.f * clamp_min(eps, 1e-20f));
  const int bits = __float_as_int(lv);
  int lg = (bits >> 23) - 127 + ((bits & (1 << 22)) != 0 ? 1 : 0);
  if (lv < 1.f) lg = 0;
  const int r0 = lg >= 0 ? lg / 2 : -((1 - lg) / 2);
  const int depth = min(max(r0, 0), 10);
  const int d_eff = min(depth, 4);
  const int stride = 1 << (4 - d_eff);
  const float s_step = (float)stride * 0.0625f;
  const int ctype = (int)f[24];
  const bool ribbon = ctype == 2;
  bool hit = false;
  float t_out = 0.f;
  for (int wdx = 0; wdx < 16; wdx += stride) {
    const float s0 = (float)wdx * 0.0625f;
    const float s1 = s0 + s_step;
    float qx[4], qy[4], qz[4];
    qx[0] = blossom(cx, s0, s0, s0);
    qx[1] = blossom(cx, s0, s0, s1);
    qx[2] = blossom(cx, s0, s1, s1);
    qx[3] = blossom(cx, s1, s1, s1);
    qy[0] = blossom(cy, s0, s0, s0);
    qy[1] = blossom(cy, s0, s0, s1);
    qy[2] = blossom(cy, s0, s1, s1);
    qy[3] = blossom(cy, s1, s1, s1);
    qz[0] = blossom(cz, s0, s0, s0);
    qz[1] = blossom(cz, s0, s0, s1);
    qz[2] = blossom(cz, s0, s1, s1);
    qz[3] = blossom(cz, s1, s1, s1);
    const float uw0 = lerpf(s0, u0g, u1g);
    const float uw1 = lerpf(clamp_max(s1, 1.f), u0g, u1g);
    const float mw = tmax(lerpf(uw0, w0, w1), lerpf(uw1, w0, w1));
    if (box_miss(qy, mw, 0.f) || box_miss(qx, mw, 0.f) ||
        box_miss(qz, mw, zmax))
      continue;
    const float edge0 = (qy[1] - qy[0]) * (-qy[0]) + qx[0] * (qx[0] - qx[1]);
    const float edge1 = (qy[2] - qy[3]) * (-qy[3]) + qx[3] * (qx[3] - qx[2]);
    const float sdx = qx[3] - qx[0];
    const float sdy = qy[3] - qy[0];
    const float denom = sdx * sdx + sdy * sdy;
    const float wseg =
        ((-qx[0]) * sdx + (-qy[0]) * sdy) / (denom == 0.f ? 1.f : denom);
    const float u_hit = tmin(tmax(lerpf(wseg, uw0, uw1), uw0), uw1);
    float hit_width = lerpf(u_hit, w0, w1);
    if (ribbon) {
      float hx, hy, hz;
      if (f[22] < 1e-6f) {
        hx = lerpf(u_hit, f[16], f[19]);
        hy = lerpf(u_hit, f[17], f[20]);
        hz = lerpf(u_hit, f[18], f[21]);
      } else {
        const float sin0 = sinf((1.f - u_hit) * f[22]) * f[23];
        const float sin1 = sinf(u_hit * f[22]) * f[23];
        hx = sin0 * f[16] + sin1 * f[19];
        hy = sin0 * f[17] + sin1 * f[20];
        hz = sin0 * f[18] + sin1 * f[21];
      }
      hit_width = hit_width * fabsf(hx * r.dx + hy * r.dy + hz * r.dz);
    }
    const float wc = clamp2(wseg, 0.f, 1.f);
    const float pcx = bezier(qx, wc);
    const float pcy = bezier(qy, wc);
    const float pcz = bezier(qz, wc);
    const float dist2 = pcx * pcx + pcy * pcy;
    if (edge0 >= 0.f && edge1 >= 0.f && denom != 0.f &&
        dist2 <= hit_width * hit_width * 0.25f && pcz >= 0.f && pcz <= zmax) {
      hit = true;
      t_out = pcz;
    }
  }
  t_hit = t_out;
  return hit;
}

// One typed record (type != 0): its t if it is taken (t < t_best), else NaN.
__device__ float typed_test(int type, float4 a, float4 e1, float4 e2,
                            const float *__restrict__ q_packed,
                            const float *__restrict__ curve_packed,
                            const float *__restrict__ inst_xf, Ray3 ray,
                            float t_best) {
  bool hit;
  float t;
  if (type == 8) {
    const float *w2i = inst_xf + 24 * (size_t)as_int(e1.w);
    float m[12];
#pragma unroll
    for (int q = 0; q < 12; ++q) m[q] = __ldg(&w2i[q]);
    const Ray3 r = to_object(m, ray);
    hit = mt_test(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, a, e1, e2, t_best, t);
  } else {
    const int row = as_int(e1.x);
    if (type == 7) {
      hit = curve_test(curve_packed + 28 * (size_t)row, ray, t_best, t);
    } else {
      const float *q = q_packed + 24 * (size_t)row;
      float m[24];
#pragma unroll
      for (int k = 0; k < 24; ++k) m[k] = __ldg(&q[k]);
      hit = quadric_test(type, m + 12, to_object(m, ray), t_best, t);
    }
  }
  return hit && t < t_best ? t : nan_f();
}

// ---- the walk -------------------------------------------------------------

struct Tables {
  const float4 *__restrict__ nodes;
  const float4 *__restrict__ tris;
  const float *__restrict__ q_packed;
  const float *__restrict__ curve_packed;
  const float *__restrict__ inst_xf;
};

// One ray's walk: the ray, its best hit so far, the entry it is at and its
// stack depth (the stack itself is the thread's local array).
struct Walk {
  float ox, oy, oz, dx, dy, dz, inv_dx, inv_dy, inv_dz, t_best;
  int i, prim, sp;
  uint32_t entry;
  bool any_hit;
};

// Start the walk of ray order[j]; false (its result written) for a dead
// lane: nothing can satisfy 1e-4 < t < t_max, and through `order` each of
// its reads would be a scattered sector.
__device__ __forceinline__ bool start_walk(
    int j, const float *__restrict__ o, const float *__restrict__ d,
    const float *__restrict__ t_max, const float *__restrict__ mode,
    const int *__restrict__ order, float *__restrict__ t_out,
    int *__restrict__ prim_out, Walk &w) {
  const int i = order ? order[j] : j;
  const float tm = t_max[i];
  if (!(tm > 0.f)) {
    t_out[i] = tm;
    prim_out[i] = -1;
    return false;
  }
  w.i = i;
  w.t_best = tm;
  w.ox = o[3 * i];
  w.oy = o[3 * i + 1];
  w.oz = o[3 * i + 2];
  w.dx = d[3 * i];
  w.dy = d[3 * i + 1];
  w.dz = d[3 * i + 2];
  w.any_hit = mode[i] > 0.f;
  w.prim = -1;
  w.inv_dx = 1.f / (w.dx == 0.f ? 1e-30f : w.dx);
  w.inv_dy = 1.f / (w.dy == 0.f ? 1e-30f : w.dy);
  w.inv_dz = 1.f / (w.dz == 0.f ? 1e-30f : w.dz);
  w.sp = 0;
  w.entry = 0;  // the root node
  return true;
}

// Take the next stack entry; false if the stack is empty (the walk ends).
__device__ __forceinline__ bool pop(Walk &w, const uint32_t *stack) {
  if (w.sp == 0) return false;
  w.entry = stack[--w.sp];
  return true;
}

// Test one record; true if the walk is done (an any-hit lane's first hit).
template <bool kTyped>
__device__ __forceinline__ bool test_record(Walk &w, const Tables &tb,
                                            float4 a, float4 e1, float4 e2,
                                            int id) {
  float t = 0.f;
  bool take = false;
  if (a.w != 0.f) {  // not a triangle: the triangle-only build skips it
    if (kTyped) {
      t = typed_test((int)a.w, a, e1, e2, tb.q_packed, tb.curve_packed,
                     tb.inst_xf, Ray3{w.ox, w.oy, w.oz, w.dx, w.dy, w.dz},
                     w.t_best);
      take = t < w.t_best;
    }
  } else {
    take = mt_test(w.ox, w.oy, w.oz, w.dx, w.dy, w.dz, a, e1, e2, w.t_best, t);
  }
  if (take) {
    w.t_best = t;
    w.prim = id;
    if (w.any_hit) {
      w.t_best = -1e30f;
      return true;
    }
  }
  return false;
}

// The leaf w.entry, its records in index order, then the pop; true when the
// walk is finished.  A record's three float4 are loaded together.  The
// triangle-only build also loads the next record's before it tests this
// one, so the loads run a record ahead and the tests stay in order; the
// typed build does not (holding the next record would push its 80
// registers into spills).
template <bool kTyped>
__device__ __forceinline__ bool leaf_step(Walk &w, const uint32_t *stack,
                                          const Tables &tb) {
  const int first = (int)(w.entry & 0xFFFFFFu);
  const int count = (int)((w.entry >> 24) & 0x7Fu);
  const float4 *rec = tb.tris + 3 * (size_t)first;
  if (kTyped) {
    for (int k = 0; k < count; ++k) {
      if (test_record<kTyped>(w, tb, __ldg(rec + 3 * k), __ldg(rec + 3 * k + 1),
                              __ldg(rec + 3 * k + 2), first + k))
        return true;
    }
    return !pop(w, stack);
  }
  float4 a = __ldg(rec), e1 = __ldg(rec + 1), e2 = __ldg(rec + 2);
  for (int k = 0; k < count; ++k) {
    float4 na = a, ne1 = e1, ne2 = e2;
    if (k + 1 < count) {
      na = __ldg(rec + 3 * k + 3);
      ne1 = __ldg(rec + 3 * k + 4);
      ne2 = __ldg(rec + 3 * k + 5);
    }
    if (test_record<kTyped>(w, tb, a, e1, e2, first + k)) return true;
    a = na;
    e1 = ne1;
    e2 = ne2;
  }
  return !pop(w, stack);
}

// The interior node w.entry: descend into its nearest hit child, pushing
// the farther hit children, or pop.  True when the walk is finished.
__device__ __forceinline__ bool node_step(Walk &w, uint32_t *stack,
                                          const Tables &tb) {
  const float4 *row = tb.nodes + 8 * (size_t)w.entry;
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
    const float t0x = (f[6 * c] - w.ox) * w.inv_dx;
    const float t1x = (f[6 * c + 3] - w.ox) * w.inv_dx;
    const float t0y = (f[6 * c + 1] - w.oy) * w.inv_dy;
    const float t1y = (f[6 * c + 4] - w.oy) * w.inv_dy;
    const float t0z = (f[6 * c + 2] - w.oz) * w.inv_dz;
    const float t1z = (f[6 * c + 5] - w.oz) * w.inv_dz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z)) * 1.0000004f;
    const bool hit = cnt >= 0 && tn <= tf && tf > 0.f && tn < w.t_best;
    key[c] = hit ? tn : inf_f();  // +inf = miss
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
    if (key[c] != inf_f()) {
      if (w.sp >= kStackSize) __trap();
      stack[w.sp++] = ref[c];
    }
  }
  if (key[0] != inf_f()) {
    w.entry = ref[0];
    return false;
  }
  return !pop(w, stack);
}

// At least 9 blocks of 128 resident on each SM for the triangle-only build
// (ptxas then keeps it to 56 registers), 6 for the typed build (80): see
// the design above.
template <bool kTyped>
__global__ void __launch_bounds__(kBlock, kTyped ? 6 : 9)
bvh4_traverse_kernel(const float4 *__restrict__ nodes,
                     const float4 *__restrict__ tris,
                     const float *__restrict__ q_packed,
                     const float *__restrict__ curve_packed,
                     const float *__restrict__ inst_xf,
                     const float *__restrict__ o, const float *__restrict__ d,
                     const float *__restrict__ t_max,
                     const float *__restrict__ mode,
                     const int *__restrict__ order, float *__restrict__ t_out,
                     int *__restrict__ prim_out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Walk w;
  if (!start_walk(j, o, d, t_max, mode, order, t_out, prim_out, w)) return;
  const Tables tb{nodes, tris, q_packed, curve_packed, inst_xf};
  uint32_t stack[kStackSize];
  while (!((w.entry & kLeafFlag) ? leaf_step<kTyped>(w, stack, tb)
                                 : node_step(w, stack, tb))) {
  }
  t_out[w.i] = w.t_best;
  prim_out[w.i] = w.prim;
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
  bvh4_traverse_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float4 *)nodes, (const float4 *)tris, nullptr, nullptr, nullptr,
      (const float *)o, (const float *)d, (const float *)t_max,
      (const float *)mode, (const int *)order, (float *)t_out,
      (int *)prim_out, n);
  return (int)cudaGetLastError();
}

// The typed build: also q_packed [Q, 24], curve_packed [C, 28] and
// inst_xf [I, 24] (float32 rows; a placeholder row when a table is empty).
int bvh4_traverse_typed(const void *nodes, const void *tris,
                        const void *q_packed, const void *curve_packed,
                        const void *inst_xf, const void *o, const void *d,
                        const void *t_max, const void *mode, const void *order,
                        void *t_out, void *prim_out, int n, void *stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  bvh4_traverse_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float4 *)nodes, (const float4 *)tris, (const float *)q_packed,
      (const float *)curve_packed, (const float *)inst_xf, (const float *)o,
      (const float *)d, (const float *)t_max, (const float *)mode,
      (const int *)order, (float *)t_out, (int *)prim_out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
