// Watertight ray-triangle test shared by the kernels of this directory
// (closest_hit.cu, wide_bvh.cu, packet_bvh.cu): translate to the ray
// origin, permute axes so |d| is largest in z, shear, signed edge functions
// with a zero snap, conservative delta_t error bound.  Same function, operation for
// operation, as ops/intersect.py::_watertight_one, in two parts: the
// candidate tests every pair pays, and the tail (division, delta_t,
// barycentrics) that only a candidate can need.
//
// Exactness: a shared edge must give e == 0 for both triangles, which needs
// the two products of the edge function rounded separately.  The edge
// function uses __fmul_rn/__fsub_rn, which are never contracted, and the
// files are built with --fmad=false and without fast-math so that every
// other expression also rounds as the plain PyTorch version does (IEEE
// division).

#pragma once

#include <cuda_runtime.h>

namespace gnx {

constexpr double kEps = 5.9604644775390625e-08;  // float32 epsilon / 2
constexpr float kGamma2 = (float)((2 * kEps) / (1.0 - 2 * kEps));
constexpr float kGamma3 = (float)((3 * kEps) / (1.0 - 3 * kEps));
constexpr float kGamma5 = (float)((5 * kEps) / (1.0 - 5 * kEps));
constexpr float kEdgeEps = (float)(4.0 * 1.1920929e-07);

__device__ __forceinline__ float edge_fn(float ax, float ay, float bx, float by) {
  const float p = __fmul_rn(ax, by);
  const float q = __fmul_rn(ay, bx);
  const float e = __fsub_rn(p, q);
  const bool tiny = fabsf(e) <= __fmul_rn(kEdgeEps, __fadd_rn(fabsf(p), fabsf(q)));
  return tiny ? 0.0f : e;
}

__device__ __forceinline__ float max3abs(float a, float b, float c) {
  return fmaxf(fmaxf(fabsf(a), fabsf(b)), fabsf(c));
}

// Per-ray frame: origin, permutation masks (kz = first largest |d|
// component) and shear.  Computed once per ray.
struct RayFrame {
  float ox, oy, oz;
  bool m0, m1;
  float sx, sy, sz;
};

__device__ __forceinline__ RayFrame make_ray_frame(float ox, float oy, float oz,
                                                   float dx, float dy, float dz) {
  RayFrame f;
  f.ox = ox; f.oy = oy; f.oz = oz;
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  f.m0 = (adx >= ady) && (adx >= adz);
  f.m1 = (!f.m0) && (ady >= adz);
  const float dzp = f.m0 ? dx : (f.m1 ? dy : dz);
  const float dxp = f.m0 ? dy : (f.m1 ? dz : dx);
  const float dyp = f.m0 ? dz : (f.m1 ? dx : dy);
  f.sx = -dxp / dzp;
  f.sy = -dyp / dzp;
  f.sz = 1.0f / dzp;
  return f;
}

// A triangle in the ray's sheared frame and what the cheap tests of the
// watertight test leave for its tail.
struct Sheared {
  float x0, x1, x2, y0, y1, y2;
  float z0, z1, z2;  // scaled by sz
  float e0, e1, e2, det, t_scaled;
};

// The cheap tests every pair pays, in two steps.  The edges: the three
// zero-snapped edge functions, the sign test and det != 0, on the
// translated, permuted and sheared vertices x, y.
__device__ __forceinline__ bool watertight_edges(const float x[3],
                                                 const float y[3],
                                                 Sheared& s) {
  s.x0 = x[0]; s.x1 = x[1]; s.x2 = x[2];
  s.y0 = y[0]; s.y1 = y[1]; s.y2 = y[2];
  s.e0 = edge_fn(x[1], y[1], x[2], y[2]);
  s.e1 = edge_fn(x[2], y[2], x[0], y[0]);
  s.e2 = edge_fn(x[0], y[0], x[1], y[1]);
  const bool neg = (s.e0 < 0.f) || (s.e1 < 0.f) || (s.e2 < 0.f);
  const bool pos = (s.e0 > 0.f) || (s.e1 > 0.f) || (s.e2 > 0.f);
  s.det = (s.e0 + s.e1) + s.e2;
  return !(neg && pos) && (s.det != 0.f);
}

// The range: z scaling of the vertices' zp and the test 0 < t <= t_limit
// on t_scaled against t_limit * det.  A pair that passes both steps is a
// candidate; only a candidate can be valid.
__device__ __forceinline__ bool watertight_range(const float zp[3], float sz,
                                                 float t_limit, Sheared& s) {
  s.z0 = sz * zp[0];
  s.z1 = sz * zp[1];
  s.z2 = sz * zp[2];
  s.t_scaled = (s.e0 * s.z0 + s.e1 * s.z1) + s.e2 * s.z2;
  const float lim = t_limit * s.det;
  const bool bad = (s.det < 0.f)
      ? ((s.t_scaled >= 0.f) || (s.t_scaled < lim))
      : ((s.t_scaled <= 0.f) || (s.t_scaled > lim));
  return !bad;
}

// The tail: the IEEE division, t, the conservative delta_t bound and the
// barycentrics (b_k = e_k / det).  Returns t > delta_t: a candidate is
// valid when this holds.
__device__ __forceinline__ bool watertight_tail(const Sheared& s, float& t,
                                                float& b0, float& b1,
                                                float& b2) {
  const float inv_det = (s.det != 0.f) ? (1.0f / s.det) : 0.0f;
  t = s.t_scaled * inv_det;
  const float max_zt = max3abs(s.z0, s.z1, s.z2);
  const float max_xt = max3abs(s.x0, s.x1, s.x2);
  const float max_yt = max3abs(s.y0, s.y1, s.y2);
  const float delta_x = kGamma5 * (max_xt + max_zt);
  const float delta_y = kGamma5 * (max_yt + max_zt);
  const float delta_e = 2.0f * ((kGamma2 * max_xt * max_yt + delta_y * max_xt)
                                + delta_x * max_yt);
  const float max_e = max3abs(s.e0, s.e1, s.e2);
  const float delta_t = 3.0f * ((kGamma3 * max_e * max_zt + delta_e * max_zt)
                                + kGamma3 * max_zt * max_e) * fabsf(inv_det);
  b0 = s.e0 * inv_det;
  b1 = s.e1 * inv_det;
  b2 = s.e2 * inv_det;
  return t > delta_t;
}

// The translated, permuted and sheared vertices of the triangle row
// q[0..8] = p0|p1|p2 under a RayFrame (z not yet scaled).
__device__ __forceinline__ void frame_vertices(const RayFrame& f,
                                               const float* q, float x[3],
                                               float y[3], float z[3]) {
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float px = q[3 * v + 0] - f.ox;
    const float py = q[3 * v + 1] - f.oy;
    const float pz = q[3 * v + 2] - f.oz;
    const float xp = f.m0 ? py : (f.m1 ? pz : px);
    const float yp = f.m0 ? pz : (f.m1 ? px : py);
    const float zp = f.m0 ? px : (f.m1 ? py : pz);
    x[v] = xp + f.sx * zp;
    y[v] = yp + f.sy * zp;
    z[v] = zp;
  }
}

// One triangle q[0..8] = p0|p1|p2 against the ray, accepting 0 < t <=
// t_limit.  On a hit returns true with t and the barycentrics b0, b1, b2;
// the caller decides whether it improves on its best.  Every step runs for
// every pair (the wide kernel tests few pairs a ray, from registers).
__device__ __forceinline__ bool watertight_hit(const RayFrame& f, const float* q,
                                               float t_limit, float& t,
                                               float& b0, float& b1, float& b2) {
  float x[3], y[3], z[3];
  frame_vertices(f, q, x, y, z);
  Sheared s;
  const bool edges = watertight_edges(x, y, s);
  const bool range = watertight_range(z, f.sz, t_limit, s);
  const bool tail = watertight_tail(s, t, b0, b1, b2);
  return edges && range && tail;
}

// The brute-force kernels' frame (csrc/closest_hit.cu): the permutation as
// three word offsets into a vertex (kx, ky, kz), chosen once a ray, and the
// origin permuted by them, so a pair reads its nine coordinates already
// permuted instead of selecting each one from three.  The same floats go
// into the same operations: results equal watertight_hit's.
struct PermFrame {
  int kx, ky, kz;
  float ox, oy, oz;  // o[kx], o[ky], o[kz]
  float sx, sy, sz;
};

__device__ __forceinline__ PermFrame make_perm_frame(float ox, float oy,
                                                     float oz, float dx,
                                                     float dy, float dz) {
  const RayFrame r = make_ray_frame(ox, oy, oz, dx, dy, dz);
  PermFrame f;
  f.kx = r.m0 ? 1 : (r.m1 ? 2 : 0);
  f.ky = r.m0 ? 2 : (r.m1 ? 0 : 1);
  f.kz = r.m0 ? 0 : (r.m1 ? 1 : 2);
  f.ox = r.m0 ? oy : (r.m1 ? oz : ox);
  f.oy = r.m0 ? oz : (r.m1 ? ox : oy);
  f.oz = r.m0 ? ox : (r.m1 ? oy : oz);
  f.sx = r.sx; f.sy = r.sy; f.sz = r.sz;
  return f;
}

// The translated, permuted and sheared vertices of the triangle row
// q[0..8] under a PermFrame (zp not yet scaled).
__device__ __forceinline__ void perm_vertices(const PermFrame& f,
                                              const float* q, float x[3],
                                              float y[3], float zp[3]) {
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    zp[v] = q[3 * v + f.kz] - f.oz;
    x[v] = (q[3 * v + f.kx] - f.ox) + f.sx * zp[v];
    y[v] = (q[3 * v + f.ky] - f.oy) + f.sy * zp[v];
  }
}

}  // namespace gnx
