// Dense tracer kernel: closest hit of every ray against every triangle.
//
// Replaces the TPU kernel mirres_restir_nerf_mesh_tpu/ops/pallas_tracer.py
// `_kernel` (a rays x triangle-blocks grid accumulating into a VMEM block).
//
// Design for Hopper: one thread per ray; the block streams the triangle
// table through shared memory in blocks of BM triangles (10 rows x BM
// floats, 20 KB), and every thread walks the staged block in increasing
// index with strict `<`, so the first minimal index wins ties, as in the
// reference. Padding triangles carry prim = -1 and never hit. There is no
// t_max here: the caller applies it.
//
// Bound on this card: arithmetic, ~45 fp32 operations for every (ray,
// triangle) pair (the path only takes it for meshes of at most a few
// thousand triangles). The triangle bytes are read once per block of rays
// and broadcast from shared memory.
//
// Layouts: tris [16, M] (rows 0-8 v0/e1/e2, 9 prim as float, rest unused),
// rays_o/rays_d [N, 3], out [4, N] rows (t, index as float, u, v).
#include <cuda_runtime.h>

#include "mt.cuh"

#define DENSE_BM 512

__global__ void __launch_bounds__(256) dense_hit_kernel(
    const float* __restrict__ tris, int M, const float* __restrict__ rays_o,
    const float* __restrict__ rays_d, int N, float t_min,
    float* __restrict__ out) {
  __shared__ float g[10][DENSE_BM];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < N;
  const int j = live ? i : 0;
  const float ox = rays_o[3 * j + 0], oy = rays_o[3 * j + 1],
              oz = rays_o[3 * j + 2];
  const float dx = rays_d[3 * j + 0], dy = rays_d[3 * j + 1],
              dz = rays_d[3 * j + 2];

  float best = MIRRES_BIG, best_lin = -1.0f, best_u = 0.0f, best_v = 0.0f;
  for (int j0 = 0; j0 < M; j0 += DENSE_BM) {
    const int m = min(DENSE_BM, M - j0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < 10 * DENSE_BM; idx += blockDim.x) {
      const int row = idx / DENSE_BM, col = idx % DENSE_BM;
      g[row][col] = col < m ? tris[(size_t)row * M + j0 + col]
                            : (row == 9 ? -1.0f : 0.0f);
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < m; ++s) {
      float t, u, v;
      const bool ok = mirres_mt(ox, oy, oz, dx, dy, dz, g[0][s], g[1][s],
                                g[2][s], g[3][s], g[4][s], g[5][s], g[6][s],
                                g[7][s], g[8][s], g[9][s], t_min, INFINITY,
                                &t, &u, &v);
      if (ok && t < best) {
        best = t;
        best_lin = (float)(j0 + s);
        best_u = u;
        best_v = v;
      }
    }
  }
  if (live) {
    out[0 * (size_t)N + i] = best;
    out[1 * (size_t)N + i] = best_lin;
    out[2 * (size_t)N + i] = best_u;
    out[3 * (size_t)N + i] = best_v;
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int dense_hit_launch(const float* tris, int M, const float* rays_o,
                                const float* rays_d, int N, float t_min,
                                float* out, void* stream) {
  const int threads = 256;
  const int blocks = (N + threads - 1) / threads;
  dense_hit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tris, M, rays_o, rays_d, N, t_min, out);
  return (int)cudaGetLastError();
}
