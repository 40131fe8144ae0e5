// Tile tracer kernel: rays of one tile x that tile's candidate clusters.
//
// Replaces two TPU kernels of mirres_restir_nerf_mesh_tpu/ops/tile_tracer.py
// with one body and one launcher, `tile_trace_launch`, each tile walking its
// first n_run[tile] candidates:
// - K1 `_queue_kernel` (a flat work queue of (tile, candidate) grid steps
//   with fresh/copy flags carrying a tile's state across queue chunks):
//   n_run is n_active, the count left by the work budget;
// - K2 `_kernel` (the dense (tile, k_cap) grid of `tile_trace(queue=False)`,
//   whose steps past counts[tile] do nothing): n_run is counts, no budget.
// The TPU's queue and chunk flags exist only to avoid its per-grid-step
// overhead; here a block walks its candidates in a loop.
//
// Bound on this card: arithmetic on the useful (ray, cluster) pairs. Each
// costs S Moeller-Trumbore tests of ~45 fp32 operations; every (ray,
// cluster) item costs one 22-operation slab test. The geometry bytes are
// small and reused by a whole tile. What kept the first kernel (one thread
// per ray, a serial loop over the S triangles) at 50-500x that bound: a warp
// with one useful ray ran the whole triangle loop with 31 idle lanes (~90%
// of the lane-iterations wasted on the small launches), launches of 58
// tiles left most of the 132 SMs idle while each block walked ~130
// candidates in a row, and each candidate's copy was exposed.
//
// Design for Hopper, per block (one tile of R rays, threads = rays):
// - Per candidate, each thread runs its ray's slab and cull test; the
//   useful rays are compacted into a shared list (per-warp ballot, popc
//   offsets). Warps then take rays from the list, and the 32 lanes of a
//   warp test the S triangles of one ray, S / 32 each at slots lane + 32 j.
//   A lane keeps its smallest (t, slot) key (strict < in increasing j); a
//   warp shuffle reduction over the packed key gives the first minimal
//   slot: the serial loop's answer, since every (ray, triangle) test is the
//   same mirres_mt call. Any hit stops at the first j where a lane hits.
// - Small launches split each tile's candidates over `split` blocks (the
//   wrapper picks it from the SM count): block p walks k = p, p + split, ...
//   and all blocks of a tile meet in one 64-bit key per ray: the float bits
//   of t (t > t_min >= 0, so they order like the float), then k * S + slot.
//   atomicMin keeps the smallest (t, k, slot), which is the sequential
//   answer (earlier candidate first on ties across clusters, first slot
//   within one); blocks also cull against a relaxed read of the key. A
//   finish kernel decodes (k, slot), looks up the cluster and recomputes u,
//   v with the same mirres_mt. Any hit stores key 0.
// - The next candidate's geometry block [16, S] (8 KB at S = 128) is
//   copied with cp.async into the second of two shared buffers while the
//   current one is tested.
//
// Semantics (as the reference): closest hit walks slots in increasing
// order with strict `<`, so the first slot wins ties inside a cluster and
// the earlier candidate wins ties across clusters. Any hit writes t = 0 and
// stops testing a found ray.
//
// Layouts: geom [C, 16, S] (rows 0-8 v0/e1/e2, 9 prim, 10-12 box min,
// 13-15 box max), rays [T, 8, R] (o, d, t_max, pad), cand/octs [T, K]
// int32, n_run [T] int32, out [T, 5, R] rows (t, slot, u, v, cluster),
// keys [T, R] uint64 (split > 1 only). S % 32 == 0, R % 32 == 0.
#include <cuda_runtime.h>

#include "mt.cuh"

#define FULL_MASK 0xffffffffu
#define NO_KEY 0xffffffffffffffffULL

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

// Start copying one candidate's [16, S] block (4 S chunks of 16 bytes).
__device__ __forceinline__ void stage(float* dst, const float* src, int S) {
  for (int i = threadIdx.x; i < 4 * S; i += blockDim.x)
    cp_async16(dst + 4 * i, src + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long hit_key(float t, unsigned pos) {
  return ((unsigned long long)__float_as_uint(t) << 32) | pos;
}

// Shared floats the kernel needs: two geometry buffers, then per ray o, d,
// t_max and the best (t, u, v, slot, cluster), the useful list, 32 counts.
static size_t smem_bytes(int S, int R) {
  return sizeof(float) * (32 * (size_t)S + 13 * (size_t)R + 32);
}

__global__ void __launch_bounds__(1024) tile_trace_kernel(
    const float* __restrict__ geom, const float* __restrict__ rays,
    const int* __restrict__ cand, const int* __restrict__ octs,
    const int* __restrict__ n_run, float* __restrict__ out,
    unsigned long long* __restrict__ keys, int K, int S, int split,
    float t_min, int any_hit) {
  extern __shared__ float sm[];
  const int R = blockDim.x;
  float* gbuf = sm;                 // [2][16 S]
  float* s_ray = gbuf + 32 * S;     // [7][R]: ox oy oz dx dy dz t_max
  float* s_bt = s_ray + 7 * R;      // best t
  float* s_bu = s_bt + R;
  float* s_bv = s_bu + R;
  int* s_bs = reinterpret_cast<int*>(s_bv + R);  // best slot
  int* s_bc = s_bs + R;                          // best cluster
  int* s_list = s_bc + R;                        // useful rays
  int* s_wc = s_list + R;                        // useful rays per warp

  const int ti = blockIdx.x / split;
  const int part = blockIdx.x - ti * split;
  const int r = threadIdx.x, lane = r & 31, warp = r >> 5;
  const int n_warps = R >> 5;

  const float* ray = rays + (size_t)ti * 8 * R;
  const float ox = ray[0 * R + r], oy = ray[1 * R + r], oz = ray[2 * R + r];
  const float dx = ray[3 * R + r], dy = ray[4 * R + r], dz = ray[5 * R + r];
  const float tmax = ray[6 * R + r];
  for (int i = 0; i < 7; ++i) s_ray[i * R + r] = ray[i * R + r];
  const float ix = mirres_safe_inv(dx);
  const float iy = mirres_safe_inv(dy);
  const float iz = mirres_safe_inv(dz);
  const int ray_oct = (dx > 0.0f) + 2 * (dy > 0.0f) + 4 * (dz > 0.0f);
  s_bt[r] = MIRRES_BIG;
  s_bu[r] = 0.0f;
  s_bv[r] = 0.0f;
  s_bs[r] = 0;
  s_bc[r] = 0;
  unsigned long long* key = keys ? keys + (size_t)ti * R : nullptr;

  const int n = n_run[ti];
  const int* cand_t = cand + (size_t)ti * K;
  const int* octs_t = octs + (size_t)ti * K;
  if (part < n) stage(gbuf, geom + (size_t)cand_t[part] * 16 * S, S);
  int buf = 0;
  for (int k = part; k < n; k += split, buf ^= 1) {
    const float* g = gbuf + buf * 16 * S;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // every copy of this candidate has landed and every warp is done with
    // the previous one (its buffer, the list, the best values)
    __syncthreads();
    if (k + split < n)
      stage(gbuf + (buf ^ 1) * 16 * S,
            geom + (size_t)cand_t[k + split] * 16 * S, S);
    const int c = cand_t[k];
    const int oct = octs_t[k];

    float t0, t1;
    mirres_slab(ox, oy, oz, ix, iy, iz, g[10 * S], g[11 * S], g[12 * S],
                g[13 * S], g[14 * S], g[15 * S], &t0, &t1);
    const float entry = fmaxf(t0, 0.0f);
    const float best = s_bt[r];
    bool useful = ((oct >> ray_oct) & 1) == 1 && t1 >= fmaxf(t0, t_min) &&
                  t0 <= tmax && entry < best;
    if (any_hit) useful = useful && best >= MIRRES_BIG;
    if (useful && key) {  // another block of the tile may have done better
      const unsigned long long kv =
          *reinterpret_cast<volatile unsigned long long*>(key + r);
      useful = kv == NO_KEY ||
               (!any_hit && entry <= __uint_as_float((unsigned)(kv >> 32)));
    }
    const unsigned ballot = __ballot_sync(FULL_MASK, useful);
    if (lane == 0) s_wc[warp] = __popc(ballot);
    const int total = __syncthreads_count(useful);
    if (total == 0) continue;
    if (useful) {
      int off = __popc(ballot & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) off += s_wc[w];
      s_list[off] = r;
    }
    __syncthreads();

    for (int i = warp; i < total; i += n_warps) {
      const int q = s_list[i];
      const float qox = s_ray[0 * R + q], qoy = s_ray[1 * R + q];
      const float qoz = s_ray[2 * R + q], qdx = s_ray[3 * R + q];
      const float qdy = s_ray[4 * R + q], qdz = s_ray[5 * R + q];
      const float qtm = s_ray[6 * R + q];
      if (any_hit) {
        bool found = false;
        for (int s = lane; s < S; s += 32) {
          float t, u, v;
          const bool ok = mirres_mt(
              qox, qoy, qoz, qdx, qdy, qdz, g[0 * S + s], g[1 * S + s],
              g[2 * S + s], g[3 * S + s], g[4 * S + s], g[5 * S + s],
              g[6 * S + s], g[7 * S + s], g[8 * S + s], g[9 * S + s], t_min,
              qtm, &t, &u, &v);
          if (__any_sync(FULL_MASK, ok)) {
            found = true;
            break;
          }
        }
        if (found && lane == 0) {
          s_bt[q] = 0.0f;
          if (key) key[q] = 0ULL;
        }
        continue;
      }
      unsigned long long kk = NO_KEY;
      float lu = 0.0f, lv = 0.0f;
      for (int s = lane; s < S; s += 32) {
        float t, u, v;
        const bool ok = mirres_mt(
            qox, qoy, qoz, qdx, qdy, qdz, g[0 * S + s], g[1 * S + s],
            g[2 * S + s], g[3 * S + s], g[4 * S + s], g[5 * S + s],
            g[6 * S + s], g[7 * S + s], g[8 * S + s], g[9 * S + s], t_min,
            qtm, &t, &u, &v);
        const unsigned long long hk = hit_key(t, (unsigned)s);
        if (ok && hk < kk) {
          kk = hk;
          lu = u;
          lv = v;
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        kk = min(kk, __shfl_xor_sync(FULL_MASK, kk, off));
      const int slot = (int)(kk & 0xffffffffu);
      const int src = kk == NO_KEY ? 0 : (slot & 31);
      const float wu = __shfl_sync(FULL_MASK, lu, src);
      const float wv = __shfl_sync(FULL_MASK, lv, src);
      const float t = __uint_as_float((unsigned)(kk >> 32));
      if (kk != NO_KEY && t < s_bt[q] && lane == 0) {
        s_bt[q] = t;
        s_bs[q] = slot;
        s_bu[q] = wu;
        s_bv[q] = wv;
        s_bc[q] = c;
        if (key) atomicMin(key + q, hit_key(t, (unsigned)(k * S + slot)));
      }
    }
  }
  if (key) return;  // the finish kernel writes the tile's rows

  __syncthreads();
  float* o = out + (size_t)ti * 5 * R;
  o[0 * R + r] = s_bt[r];
  o[1 * R + r] = (float)s_bs[r];
  o[2 * R + r] = s_bu[r];
  o[3 * R + r] = s_bv[r];
  o[4 * R + r] = (float)s_bc[r];
}

// Split launches: each ray's key -> its out rows. Closest hit recomputes u,
// v of the winning (candidate, slot) with the same mirres_mt.
__global__ void tile_trace_finish(const float* __restrict__ geom,
                                  const float* __restrict__ rays,
                                  const int* __restrict__ cand,
                                  const unsigned long long* __restrict__ keys,
                                  float* __restrict__ out, int T, int K, int S,
                                  int R, float t_min, int any_hit) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * R) return;
  const int ti = (int)(i / R), r = (int)(i - (long long)ti * R);
  const unsigned long long kv = keys[i];
  float t = MIRRES_BIG, slot = 0.0f, u = 0.0f, v = 0.0f, cid = 0.0f;
  if (kv != NO_KEY) {
    if (any_hit) {
      t = 0.0f;
    } else {
      const unsigned pos = (unsigned)(kv & 0xffffffffu);
      const int k = (int)(pos / S), s = (int)(pos - (unsigned)k * S);
      const int c = cand[(size_t)ti * K + k];
      const float* g = geom + (size_t)c * 16 * S;
      const float* ray = rays + (size_t)ti * 8 * R;
      float tt;
      mirres_mt(ray[0 * R + r], ray[1 * R + r], ray[2 * R + r],
                ray[3 * R + r], ray[4 * R + r], ray[5 * R + r], g[0 * S + s],
                g[1 * S + s], g[2 * S + s], g[3 * S + s], g[4 * S + s],
                g[5 * S + s], g[6 * S + s], g[7 * S + s], g[8 * S + s],
                g[9 * S + s], t_min, ray[6 * R + r], &tt, &u, &v);
      t = __uint_as_float((unsigned)(kv >> 32));
      slot = (float)s;
      cid = (float)c;
    }
  }
  float* o = out + (size_t)ti * 5 * R;
  o[0 * R + r] = t;
  o[1 * R + r] = slot;
  o[2 * R + r] = u;
  o[3 * R + r] = v;
  o[4 * R + r] = cid;
}

// Launches on `stream` (split > 1: `keys` is [T, R] scratch, set here, and
// a finish kernel follows); returns cudaGetLastError() (0 = launched).
extern "C" int tile_trace_launch(const float* geom, const float* rays,
                                 const int* cand, const int* octs,
                                 const int* n_run, float* out,
                                 unsigned long long* keys, int T, int K,
                                 int S, int R, int split, float t_min,
                                 int any_hit, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(S, R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (split > 1) {
    const cudaError_t e = cudaMemsetAsync(
        keys, 0xff, sizeof(unsigned long long) * (size_t)T * R, st);
    if (e != cudaSuccess) return (int)e;
  }
  tile_trace_kernel<<<T * split, R, smem, st>>>(geom, rays, cand, octs, n_run,
                                                out, split > 1 ? keys : nullptr,
                                                K, S, split, t_min, any_hit);
  if (split > 1) {
    const long long n = (long long)T * R;
    tile_trace_finish<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        geom, rays, cand, keys, out, T, K, S, R, t_min, any_hit);
  }
  return (int)cudaGetLastError();
}
