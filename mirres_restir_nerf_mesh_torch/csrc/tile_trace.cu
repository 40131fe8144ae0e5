// Tile tracer kernel: rays of one tile x that tile's candidate clusters.
//
// Replaces the TPU kernel mirres_restir_nerf_mesh_tpu/ops/tile_tracer.py
// `_queue_kernel` (a flat work queue of (tile, candidate) grid steps with
// fresh/copy flags carrying a tile's state across queue chunks).
//
// Design for Hopper: one block per ray tile, one thread per ray (R = 512).
// The block walks its tile's first n_active[tile] candidates in entry
// order, which folds the TPU's queue and its chunk flags into a loop: those
// exist only to avoid the TPU's per-grid-step overhead. Each candidate's
// geometry block [16, S] (8 KB at S = 128) is staged in shared memory once
// and read by every ray as a broadcast. A block-wide vote skips the
// triangle tests of a cluster no ray of the tile can use.
//
// Bound on this card: arithmetic. Each useful (ray, cluster) pair costs S
// Moeller-Trumbore tests of ~45 fp32 operations; the geometry bytes are
// small and reused by 512 rays. The vote and the per-ray `entry < best`
// cull keep the tests to pairs that can still change the answer; the
// divergence of partly useful warps is the open cost.
//
// Semantics (as the reference): closest hit walks slots in increasing
// order with strict `<`, so the first slot wins ties inside a cluster and
// the earlier candidate wins ties across clusters. Any hit writes t = 0 and
// stops testing a found ray.
//
// Layouts: geom [C, 16, S] (rows 0-8 v0/e1/e2, 9 prim, 10-12 box min,
// 13-15 box max), rays [T, 8, R] (o, d, t_max, pad), cand/octs [T, K]
// int32, n_active [T] int32, out [T, 5, R] rows (t, slot, u, v, cluster).
#include <cuda_runtime.h>

#include "mt.cuh"

__global__ void __launch_bounds__(1024) tile_trace_kernel(
    const float* __restrict__ geom, const float* __restrict__ rays,
    const int* __restrict__ cand, const int* __restrict__ octs,
    const int* __restrict__ n_active, float* __restrict__ out, int K, int S,
    float t_min, int any_hit) {
  extern __shared__ float g[];  // [16, S] of the current candidate
  const int ti = blockIdx.x;
  const int R = blockDim.x;
  const int r = threadIdx.x;

  const float* ray = rays + (size_t)ti * 8 * R;
  const float ox = ray[0 * R + r], oy = ray[1 * R + r], oz = ray[2 * R + r];
  const float dx = ray[3 * R + r], dy = ray[4 * R + r], dz = ray[5 * R + r];
  const float tmax = ray[6 * R + r];
  const float ix = mirres_safe_inv(dx);
  const float iy = mirres_safe_inv(dy);
  const float iz = mirres_safe_inv(dz);
  const int ray_oct = (dx > 0.0f) + 2 * (dy > 0.0f) + 4 * (dz > 0.0f);

  float best = MIRRES_BIG, best_slot = 0.0f, best_u = 0.0f, best_v = 0.0f;
  float best_cid = 0.0f;

  const int n = n_active[ti];
  for (int k = 0; k < n; ++k) {
    const int c = cand[(size_t)ti * K + k];
    const int oct = octs[(size_t)ti * K + k];
    __syncthreads();  // every ray is done with the previous block
    const float* src = geom + (size_t)c * 16 * S;
    for (int i = r; i < 16 * S; i += R) g[i] = src[i];
    __syncthreads();

    float t0, t1;
    mirres_slab(ox, oy, oz, ix, iy, iz, g[10 * S], g[11 * S], g[12 * S],
                g[13 * S], g[14 * S], g[15 * S], &t0, &t1);
    const float entry = fmaxf(t0, 0.0f);
    bool useful = ((oct >> ray_oct) & 1) == 1 && t1 >= fmaxf(t0, t_min) &&
                  t0 <= tmax && entry < best;
    if (any_hit) useful = useful && best >= MIRRES_BIG;
    if (!__syncthreads_or(useful) || !useful) continue;

    for (int s = 0; s < S; ++s) {
      float t, u, v;
      const bool ok = mirres_mt(
          ox, oy, oz, dx, dy, dz, g[0 * S + s], g[1 * S + s], g[2 * S + s],
          g[3 * S + s], g[4 * S + s], g[5 * S + s], g[6 * S + s],
          g[7 * S + s], g[8 * S + s], g[9 * S + s], t_min, tmax, &t, &u, &v);
      if (any_hit) {
        if (ok) {
          best = 0.0f;
          break;
        }
      } else if (ok && t < best) {
        best = t;
        best_slot = (float)s;
        best_u = u;
        best_v = v;
        best_cid = (float)c;
      }
    }
  }

  float* o = out + (size_t)ti * 5 * R;
  o[0 * R + r] = best;
  o[1 * R + r] = best_slot;
  o[2 * R + r] = best_u;
  o[3 * R + r] = best_v;
  o[4 * R + r] = best_cid;
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int tile_trace_launch(const float* geom, const float* rays,
                                 const int* cand, const int* octs,
                                 const int* n_active, float* out, int T, int K,
                                 int S, int R, float t_min, int any_hit,
                                 void* stream) {
  const size_t smem = sizeof(float) * 16 * (size_t)S;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tile_trace_kernel<<<T, R, smem, (cudaStream_t)stream>>>(
      geom, rays, cand, octs, n_active, out, K, S, t_min, any_hit);
  return (int)cudaGetLastError();
}
