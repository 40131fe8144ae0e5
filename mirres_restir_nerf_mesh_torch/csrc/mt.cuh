// Ray/box and ray/triangle arithmetic shared by the tracer kernels
// (tile_trace.cu, dense_hit.cu).
//
// Built with --fmad=false and without fast math: every product and sum
// rounds on its own, in the order written, and 1/x is the IEEE quotient.
// That is how the plain PyTorch versions (ops/tile_tracer.py,
// ops/dense_tracer.py) and the JAX reference evaluate the same expressions,
// so hits and tie-breaks agree bit for bit where the inputs do.
#pragma once

#define MIRRES_BIG 1e30f

// 1 / c with tiny components pushed to +1e-12 (the reference's `inv`).
__device__ __forceinline__ float mirres_safe_inv(float c) {
  return 1.0f / (fabsf(c) < 1e-12f ? 1e-12f : c);
}

// Slab test of a ray against an AABB. Writes the entry/exit parameters
// (t0 may be negative when the origin lies inside the box).
__device__ __forceinline__ void mirres_slab(
    float ox, float oy, float oz, float ix, float iy, float iz,
    float bnx, float bny, float bnz, float bxx, float bxy, float bxz,
    float* t0, float* t1) {
  const float lox = (bnx - ox) * ix, hix = (bxx - ox) * ix;
  const float loy = (bny - oy) * iy, hiy = (bxy - oy) * iy;
  const float loz = (bnz - oz) * iz, hiz = (bxz - oz) * iz;
  *t0 = fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)), fminf(loz, hiz));
  *t1 = fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)), fmaxf(loz, hiz));
}

// Moeller-Trumbore against one triangle given as v0, e1 = v1 - v0,
// e2 = v2 - v0 and its primitive id (negative = padding). Returns whether
// the hit counts (t_min < t < t_max) and writes t, u, v.
__device__ __forceinline__ bool mirres_mt(
    float ox, float oy, float oz, float dx, float dy, float dz,
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float prim, float t_min, float t_max,
    float* t_out, float* u_out, float* v_out) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float dinv = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
  const float tx = ox - v0x;
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * dinv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * dinv;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * dinv;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t > t_min && t < t_max && prim >= 0.0f;
}
