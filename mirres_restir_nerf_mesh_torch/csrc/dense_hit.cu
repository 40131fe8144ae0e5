// Dense tracer kernels: every ray against every triangle of a small mesh.
//
// Replaces the TPU kernel mirres_restir_nerf_mesh_tpu/ops/pallas_tracer.py
// `_kernel` (:40-103, via `pallas_dense_hit`): a rays x triangle-blocks grid
// whose triangle axis runs in order and accumulates into one VMEM block.
// Two entries here:
// - closest hit (`dense_hit_launch`): first minimal (t, index) with
//   t_min < t, prim >= 0, no t_max; rows (t, index, u, v);
// - any hit (`dense_occluded_launch`): whether some triangle has
//   t_min < t < t_max[ray]; a ray with t_max <= t_min is never traced.
//   The reference gets the same mask from the closest hit (prim >= 0 after
//   the t_max cut); any hit stops at the first triangle that qualifies.
//
// Bound on this card: operations. A (ray, triangle) test is ~45 fp32
// operations (csrc/mt.cuh); the triangles are read once per block of rays.
// The yardstick's 67 TFLOP/s counts an FMA as two operations, but this code
// is built with --fmad=false, so each operation is its own instruction: at
// most 128 lanes an SM a clock, ~33.5 T instructions/s at 1.98 GHz, half
// that rate, before the IEEE division, the compares and the selects. That
// issue floor of the whole work (every ray against every triangle) was what
// the first kernel (one thread a ray, 10 scalar shared loads a test) ran
// into; this one skips most of the work instead, so it can run under both.
//
// Design for Hopper:
// - Warp-bundle cull: a warp holds 32 neighbouring rays (the route sorts
//   large incoherent batches by octant and origin). Their origins span a ball and
//   their directions a cone; per group of 4 staged triangles a lane tests
//   the group's bounding ball against the swept ball and against the rays'
//   distance limit (the best t so far, or t_max), and the warp runs the
//   exact tests only on the groups some ray may reach. A group is dropped
//   only with a margin far past the rounding of the test, so no hit is.
//   The cull assumes hits ahead of the origin, so it runs only for
//   t_min >= 0; with t_min < 0 every group is tested.
// - Culling without a division: the numerators of u, v and t share their
//   sign with det's, so a test is dropped before 1 / det when a numerator
//   has the wrong sign, u + v exceeds det, or t lies beyond the ray's
//   limit, each with a margin that covers the rounding of the exact
//   expressions; the tests that remain evaluate mirres_mt's expressions in
//   its order, so every hit, t, u and v is the plain version's bit for bit.
// - Loads: a group of 4 triangles is read as 10 16-byte vectors (4
//   triangles of one component each, the same address in every lane: a
//   broadcast), one load for 4 tests where the first kernel issued 10 for
//   one. A thread holds one ray: two or four rays a thread were slower in
//   the first version of this kernel, before the bundle cull (more
//   registers); this kernel was not tried that way.
// - Split: the wrapper cuts the triangle range of every block of 128 rays
//   into `split` parts (more where the rays alone do not fill the card,
//   and parts of at most 4 staged blocks, since the cull makes a block's
//   work depend on its rays), each walking its part in increasing index
//   with strict <. The parts meet in one 64-bit key per ray:
//   order-preserving bits of t (any sign; -0 folded onto +0), then the
//   triangle index. atomicMin keeps the smallest (t, index), the sequential
//   answer (the first minimal index); a finish kernel recomputes t, u, v of
//   the winner with mirres_mt. With split 1 the kernel writes the rows.
// - cp.async: the next block of triangles is copied into the second of two
//   shared buffers while the current one is tested, 16 bytes a copy where
//   the rows allow it; the kernel reads any row-strided table (the cluster
//   SoA [10, C*S] or the padded [16, Mpad]) and masks the ragged end itself.
// - Any hit, the same kernel and layout (a template flag): a ray's limit
//   starts at its t_max, so the distance cull drops what lies beyond it
//   from the start; a dead lane (t_max <= t_min) is not live and adds
//   nothing to its warp's bundle; a ray is done at its first hit, a warp
//   skips its tests once all its rays are done, a block leaves once all its
//   warps are. A done lane waits for the rest of its warp, but on the
//   frames' launches under 0.5% of the rays are occluded: the t_max limit
//   pays, not the exit. A block-level ray queue that refilled done and dead
//   lanes was slower on the 1M-ray and spatial launches and faster only on
//   small unsorted shadow batches (PERF.md). Parts (split) OR their hits
//   into the mask; no keys, no finish kernel.
//
// Layouts: tris rows 0-8 v0/e1/e2, 9 prim (as float, < 0 = padding), row
// stride `ld` floats, M columns; rays_o/rays_d [N, 3]; closest out [4, N]
// rows (t, index as float, u, v), keys [N] uint64 (split > 1); any hit
// t_max [N], occ [N] uint8 zeroed by the caller.
#include <cuda_runtime.h>

#include "mt.cuh"

#define DENSE_BM 256    // triangles a staged block (multiple of 4)
#define DENSE_THREADS 128
#define FULL_MASK 0xffffffffu
#define NO_KEY 0xffffffffffffffffULL

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

// Start copying triangle block `c` (columns c*BM ...) into dst [10][BM];
// columns at or past M get prim = -1. vec: rows start on 16 bytes.
__device__ __forceinline__ void stage(float* dst, const float* tris, int ld,
                                      int M, int c, bool vec) {
  const int j0 = c * DENSE_BM;
  for (int i = threadIdx.x; i < 10 * (DENSE_BM / 4); i += blockDim.x) {
    const int row = i / (DENSE_BM / 4), col = 4 * (i % (DENSE_BM / 4));
    float* d = dst + row * DENSE_BM + col;
    const float* s = tris + (size_t)row * ld + j0 + col;
    if (vec && j0 + col + 4 <= M) {
      cp_async16(d, s);
    } else {
      for (int k = 0; k < 4; ++k) {
        if (j0 + col + k < M)
          cp_async4(d + k, s + k);
        else
          d[k] = row == 9 ? -1.0f : 0.0f;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// mirres_mt(o, d, tri, t_min, t_lim): the same result (t written only when
// true), with the culls of the header note before the division. pos_tmin:
// t_min >= 0, so t <= 0 never counts.
__device__ __forceinline__ bool cull_mt(
    float ox, float oy, float oz, float dx, float dy, float dz,
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float prim, float t_min, float t_lim,
    bool pos_tmin, float* t_out) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float adet = fabsf(det);
  const float sg = copysignf(1.0f, det);
  const float tx = ox - v0x;
  const float ty = oy - v0y;
  const float tz = oz - v0z;
  const float un = tx * px + ty * py + tz * pz;
  const float us = un * sg;  // exact: the sign of u
  // |u| > 1e-40 cannot round to 0, so u < 0
  if (us < -1e-20f && adet < 1e20f) return false;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float vn = dx * qx + dy * qy + dz * qz;
  const float vs = vn * sg;
  if (vs < -1e-20f && adet < 1e20f) return false;
  // u + v > 1 (u, v carry at most 2 roundings each, the sum one more)
  if (us >= 0.0f && vs >= 0.0f && us + vs > adet * 1.000001f) return false;
  const float tn = e2x * qx + e2y * qy + e2z * qz;
  const float ts = tn * sg;
  if (pos_tmin && ts <= 0.0f) return false;
  // t >= t_lim: t is ts / adet within 2 roundings
  if (ts > fmaxf(t_lim * adet, 1e-30f) * 1.000001f) return false;
  const float dinv = adet < 1e-12f ? 0.0f : 1.0f / det;
  const float u = un * dinv;
  const float v = vn * dinv;
  const float t = tn * dinv;
  *t_out = t;
  return adet > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t > t_min && t < t_lim && prim >= 0.0f;
}

// Order-preserving bits of a float (-0 folded onto +0), then the index.
__device__ __forceinline__ unsigned long long hit_key(float t, int idx) {
  unsigned b = __float_as_uint(t);
  if (b == 0x80000000u) b = 0u;
  b ^= (b & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  return ((unsigned long long)b << 32) | (unsigned)idx;
}

// The row of ray i for winner idx (-1 = miss): t, u, v recomputed with
// mirres_mt, as the sequential walk found them.
__device__ __forceinline__ void write_row(const float* __restrict__ tris,
                                          int ld, const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          float t_min, int idx, int i, int N,
                                          float* __restrict__ out) {
  float t = MIRRES_BIG, u = 0.0f, v = 0.0f;
  if (idx >= 0) {
    const float* g = tris + idx;
    mirres_mt(o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
              d[3 * i + 2], g[0], g[(size_t)ld], g[2 * (size_t)ld],
              g[3 * (size_t)ld], g[4 * (size_t)ld], g[5 * (size_t)ld],
              g[6 * (size_t)ld], g[7 * (size_t)ld], g[8 * (size_t)ld],
              g[9 * (size_t)ld], t_min, INFINITY, &t, &u, &v);
  }
  out[i] = t;
  out[(size_t)N + i] = (float)idx;
  out[2 * (size_t)N + i] = u;
  out[3 * (size_t)N + i] = v;
}

// What a warp's live rays span: origins in a ball (o, rho), unit directions
// in a cone (axis a, cos c, sin s; cone = false when it is too wide or not
// finite), hit distances below lim (the largest t limit x |d|). Every
// bound is padded well past its rounding.
struct Bundle {
  float ox, oy, oz, rho, ax, ay, az, c, s, lim;
  bool cone, live;
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}
__device__ __forceinline__ float warp_min(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, off));
  return x;
}

// Every lane of the warp calls this; lanes with live = false add nothing.
__device__ __forceinline__ Bundle warp_bundle(bool live, float ox, float oy,
                                              float oz, float dx, float dy,
                                              float dz, float lim) {
  Bundle b;
  b.live = __any_sync(FULL_MASK, live);
  const float dn = sqrtf(dx * dx + dy * dy + dz * dz);
  const float hx = dx / dn, hy = dy / dn, hz = dz / dn;
  const float sx = warp_sum(live ? hx : 0.0f);
  const float sy = warp_sum(live ? hy : 0.0f);
  const float sz = warp_sum(live ? hz : 0.0f);
  const float sn = sqrtf(sx * sx + sy * sy + sz * sz);
  b.ax = sx / sn;
  b.ay = sy / sn;
  b.az = sz / sn;
  const float cosd = hx * b.ax + hy * b.ay + hz * b.az;
  b.c = warp_min(live ? cosd : 1.0f) - 2e-6f;
  b.cone = b.live && b.c > 0.05f && isfinite(b.ax + b.ay + b.az);
  b.s = sqrtf(fmaxf(0.0f, 1.0f - b.c * b.c));
  const float lx = warp_min(live ? ox : INFINITY);
  const float ly = warp_min(live ? oy : INFINITY);
  const float lz = warp_min(live ? oz : INFINITY);
  const float ux = warp_max(live ? ox : -INFINITY);
  const float uy = warp_max(live ? oy : -INFINITY);
  const float uz = warp_max(live ? oz : -INFINITY);
  b.ox = 0.5f * (lx + ux);
  b.oy = 0.5f * (ly + uy);
  b.oz = 0.5f * (lz + uz);
  const float ex = ux - lx, ey = uy - ly, ez = uz - lz;
  b.rho = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez) * 1.0001f +
          1e-6f * (fabsf(b.ox) + fabsf(b.oy) + fabsf(b.oz));
  b.lim = warp_max(live ? lim * dn : -INFINITY) * 1.0001f;
  return b;
}

// Whether some ray of the bundle may hit one of the 4 staged triangles
// s..s+3: their box's ball (padding columns left out) against the origin
// ball swept along the direction cone and cut at lim. False only when no
// ray can reach the ball: the margin (1e-4 x the distances, 1e-6 x the
// coordinates) covers the rounding of the box, the ball and the hit point.
__device__ __forceinline__ bool group_maybe(const float* g, int s,
                                            const Bundle& b) {
  float lx = INFINITY, ly = INFINITY, lz = INFINITY;
  float ux = -INFINITY, uy = -INFINITY, uz = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!(g[9 * DENSE_BM + s + j] >= 0.0f)) continue;
    const float x = g[s + j], y = g[DENSE_BM + s + j], z = g[2 * DENSE_BM + s + j];
    const float x1 = x + g[3 * DENSE_BM + s + j], x2 = x + g[6 * DENSE_BM + s + j];
    const float y1 = y + g[4 * DENSE_BM + s + j], y2 = y + g[7 * DENSE_BM + s + j];
    const float z1 = z + g[5 * DENSE_BM + s + j], z2 = z + g[8 * DENSE_BM + s + j];
    lx = fminf(lx, fminf(x, fminf(x1, x2)));
    ly = fminf(ly, fminf(y, fminf(y1, y2)));
    lz = fminf(lz, fminf(z, fminf(z1, z2)));
    ux = fmaxf(ux, fmaxf(x, fmaxf(x1, x2)));
    uy = fmaxf(uy, fmaxf(y, fmaxf(y1, y2)));
    uz = fmaxf(uz, fmaxf(z, fmaxf(z1, z2)));
  }
  if (lx > ux) return false;  // only padding
  const float ex = ux - lx, ey = uy - ly, ez = uz - lz;
  const float R = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez) + b.rho;
  const float px = 0.5f * (lx + ux) - b.ox;
  const float py = 0.5f * (ly + uy) - b.oy;
  const float pz = 0.5f * (lz + uz) - b.oz;
  const float pl = sqrtf(px * px + py * py + pz * pz);
  const float scale = fmaxf(fmaxf(fmaxf(fabsf(lx), fabsf(ux)), fmaxf(fabsf(ly), fabsf(uy))),
                            fmaxf(fabsf(lz), fabsf(uz)));
  const float margin = 1e-4f * (pl + R) + 1e-6f * scale;
  if (pl - R - margin > b.lim) return false;  // beyond every ray's limit
  if (!b.cone) return true;
  const float pa = px * b.ax + py * b.ay + pz * b.az;
  const float cx = py * b.az - pz * b.ay, cy = pz * b.ax - px * b.az,
              cz = px * b.ay - py * b.ax;
  const float pc = sqrtf(cx * cx + cy * cy + cz * cz);  // |p| sin(angle)
  if (pa >= pl * b.c) return true;                     // inside the cone
  // distance from the cone: |p| sin(angle - theta), or |p| past 90 degrees
  const float dist = pa * b.c + pc * b.s <= 0.0f ? pl : pc * b.c - pa * b.s;
  return !(dist - R > margin);
}

// The 4 staged triangles s..s+3 as float4 columns of the 10 rows.
#define LOAD_GROUP(r, g, s)                                         \
  float4 r[10];                                                     \
  _Pragma("unroll") for (int q = 0; q < 10; ++q) r[q] =             \
      *reinterpret_cast<const float4*>((g) + q * DENSE_BM + (s))
#define COMP(r, q, j) \
  ((j) == 0 ? r[q].x : (j) == 1 ? r[q].y : (j) == 2 ? r[q].z : r[q].w)
#define TRI(r, j)                                                        \
  COMP(r, 0, j), COMP(r, 1, j), COMP(r, 2, j), COMP(r, 3, j),            \
      COMP(r, 4, j), COMP(r, 5, j), COMP(r, 6, j), COMP(r, 7, j),        \
      COMP(r, 8, j), COMP(r, 9, j)

// Blocks of 128 rays (a warp: 32 neighbouring rays) x `split` parts of the
// staged triangle blocks.  Closest hit (ANY false): rows or keys.  Any hit
// (ANY true): a ray's limit starts at its t_max (dead at t_max <= t_min), it
// is done at its first hit, a warp skips its tests once all its rays are
// done and a block leaves once all its warps are; occ[i] = 1 on a hit.
template <bool ANY>
__global__ void __launch_bounds__(DENSE_THREADS) dense_hit_kernel(
    const float* __restrict__ tris, int ld, int M, int vec,
    const float* __restrict__ rays_o, const float* __restrict__ rays_d, int N,
    float t_min, const float* __restrict__ t_max, int split,
    float* __restrict__ out, unsigned long long* __restrict__ keys,
    unsigned char* __restrict__ occ) {
  __shared__ __align__(16) float gbuf[2][10 * DENSE_BM];
  const int rb = blockIdx.x / split, part = blockIdx.x - rb * split;
  const int n_blk = (M + DENSE_BM - 1) / DENSE_BM;
  const int c0 = (int)((long long)part * n_blk / split);
  const int c1 = (int)((long long)(part + 1) * n_blk / split);
  const int lane = threadIdx.x & 31;
  const int i = rb * DENSE_THREADS + threadIdx.x;
  // the bundle cull assumes hits ahead of the origin: only for t_min >= 0
  const bool pos_tmin = t_min >= 0.0f;
  const int ic = min(i, N - 1);
  const float ox = rays_o[3 * ic], oy = rays_o[3 * ic + 1],
              oz = rays_o[3 * ic + 2];
  const float dx = rays_d[3 * ic], dy = rays_d[3 * ic + 1],
              dz = rays_d[3 * ic + 2];
  const float dn = sqrtf(dx * dx + dy * dy + dz * dz);
  float best = ANY ? t_max[ic] : MIRRES_BIG;
  const bool live = i < N && (!ANY || best > t_min);
  bool done = false;  // any hit: found
  int bi = -1;
  Bundle b = warp_bundle(live, ox, oy, oz, dx, dy, dz, best);

  if (c0 < c1) stage(gbuf[0], tris, ld, M, c0, vec);
  for (int c = c0, buf = 0; c < c1; ++c, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // block c landed; every warp is done with block c - 1
    if (ANY) {
      if (__syncthreads_or(live && !done) == 0) break;
    } else {
      __syncthreads();
    }
    if (c + 1 < c1) stage(gbuf[buf ^ 1], tris, ld, M, c + 1, vec);
    const float* g = gbuf[buf];
    const int m = min(DENSE_BM, M - c * DENSE_BM);
    const int j0 = c * DENSE_BM;
    for (int s0 = 0; s0 < m; s0 += 128) {
      const bool active = live && !done;
      if (!__any_sync(FULL_MASK, active)) break;
      b.lim = warp_max(active ? best * dn : -INFINITY) * 1.0001f;
      const bool cull = pos_tmin && (b.cone || b.lim < 1e29f);
      const int sl = s0 + 4 * lane;
      unsigned todo = __ballot_sync(
          FULL_MASK, sl < m && (!cull || group_maybe(g, sl, b)));
      while (todo) {
        const int sg = s0 + 4 * (__ffs(todo) - 1);
        todo &= todo - 1;
        if (!live || done) continue;
        LOAD_GROUP(r, g, sg);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t;
          if (cull_mt(ox, oy, oz, dx, dy, dz, TRI(r, j), t_min, best,
                      pos_tmin, &t)) {
            best = t;
            bi = j0 + sg + j;
          }
        }
        done = ANY && bi >= 0;
      }
    }
  }

  if (i >= N) return;
  if (ANY) {
    if (bi >= 0) occ[i] = 1;
  } else if (keys) {
    if (bi >= 0) atomicMin(keys + i, hit_key(best, bi));
  } else {
    write_row(tris, ld, rays_o, rays_d, t_min, bi, i, N, out);
  }
}

__global__ void dense_hit_finish(const float* __restrict__ tris, int ld,
                                 const float* __restrict__ rays_o,
                                 const float* __restrict__ rays_d, int N,
                                 float t_min,
                                 const unsigned long long* __restrict__ keys,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const unsigned long long kv = keys[i];
  write_row(tris, ld, rays_o, rays_d, t_min,
            kv == NO_KEY ? -1 : (int)(kv & 0xffffffffu), i, N, out);
}

// Launch on `stream` (split > 1: `keys` is [N] scratch, set here, and a
// finish kernel follows); returns cudaGetLastError() (0 = launched).
extern "C" int dense_hit_launch(const float* tris, int ld, int M, int vec,
                                const float* rays_o, const float* rays_d,
                                int N, float t_min, int split, float* out,
                                unsigned long long* keys, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (split < 1) split = 1;
  if (split > 1) {
    const cudaError_t e = cudaMemsetAsync(
        keys, 0xff, sizeof(unsigned long long) * (size_t)N, st);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks =
      (unsigned)((N + DENSE_THREADS - 1) / DENSE_THREADS) * split;
  dense_hit_kernel<false><<<blocks, DENSE_THREADS, 0, st>>>(
      tris, ld, M, vec, rays_o, rays_d, N, t_min, nullptr, split, out,
      split > 1 ? keys : nullptr, nullptr);
  if (split > 1)
    dense_hit_finish<<<(N + 255) / 256, 256, 0, st>>>(tris, ld, rays_o, rays_d,
                                                      N, t_min, keys, out);
  return (int)cudaGetLastError();
}

// `occ` [N] must be zeroed by the caller; the parts OR their hits into it.
extern "C" int dense_occluded_launch(const float* tris, int ld, int M,
                                     int vec, const float* rays_o,
                                     const float* rays_d, const float* t_max,
                                     int N, float t_min, int split,
                                     unsigned char* occ, void* stream) {
  if (split < 1) split = 1;
  const unsigned blocks =
      (unsigned)((N + DENSE_THREADS - 1) / DENSE_THREADS) * split;
  dense_hit_kernel<true><<<blocks, DENSE_THREADS, 0, (cudaStream_t)stream>>>(
      tris, ld, M, vec, rays_o, rays_d, N, t_min, t_max, split, nullptr,
      nullptr, occ);
  return (int)cudaGetLastError();
}
