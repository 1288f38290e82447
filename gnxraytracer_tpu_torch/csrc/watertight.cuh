// Watertight ray-triangle test shared by the kernels of this directory
// (closest_hit.cu, wide_bvh.cu): translate to the ray origin, permute axes
// so |d| is largest in z, shear, signed edge functions with a zero snap,
// conservative delta_t error bound.  Same function, operation for
// operation, as ops/intersect.py::_watertight_one.
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

// One triangle q[0..8] = p0|p1|p2 against the ray, accepting 0 < t <=
// t_limit.  On a hit returns true with t and the barycentrics b0, b1, b2
// (b_k = e_k / det); the caller decides whether it improves on its best.
__device__ __forceinline__ bool watertight_hit(const RayFrame& f, const float* q,
                                               float t_limit, float& t,
                                               float& b0, float& b1, float& b2) {
  float x[3], y[3], z[3];
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
  const float e0 = edge_fn(x[1], y[1], x[2], y[2]);
  const float e1 = edge_fn(x[2], y[2], x[0], y[0]);
  const float e2 = edge_fn(x[0], y[0], x[1], y[1]);
  const bool neg = (e0 < 0.f) || (e1 < 0.f) || (e2 < 0.f);
  const bool pos = (e0 > 0.f) || (e1 > 0.f) || (e2 > 0.f);
  const float det = (e0 + e1) + e2;
  bool valid = !(neg && pos) && (det != 0.f);
  const float z0 = f.sz * z[0];
  const float z1 = f.sz * z[1];
  const float z2 = f.sz * z[2];
  const float t_scaled = (e0 * z0 + e1 * z1) + e2 * z2;
  const float lim = t_limit * det;
  const bool bad = (det < 0.f)
      ? ((t_scaled >= 0.f) || (t_scaled < lim))
      : ((t_scaled <= 0.f) || (t_scaled > lim));
  valid = valid && !bad;
  const float inv_det = (det != 0.f) ? (1.0f / det) : 0.0f;
  t = t_scaled * inv_det;
  // conservative delta_t bound
  const float max_zt = max3abs(z0, z1, z2);
  const float max_xt = max3abs(x[0], x[1], x[2]);
  const float max_yt = max3abs(y[0], y[1], y[2]);
  const float delta_x = kGamma5 * (max_xt + max_zt);
  const float delta_y = kGamma5 * (max_yt + max_zt);
  const float delta_e = 2.0f * ((kGamma2 * max_xt * max_yt + delta_y * max_xt)
                                + delta_x * max_yt);
  const float max_e = max3abs(e0, e1, e2);
  const float delta_t = 3.0f * ((kGamma3 * max_e * max_zt + delta_e * max_zt)
                                + kGamma3 * max_zt * max_e) * fabsf(inv_det);
  valid = valid && (t > delta_t);
  b0 = e0 * inv_det;
  b1 = e1 * inv_det;
  b2 = e2 * inv_det;
  return valid;
}

}  // namespace gnx
