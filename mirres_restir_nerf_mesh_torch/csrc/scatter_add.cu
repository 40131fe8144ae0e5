// Scatter-add of update rows into a zeroed table: the hash-grid backward.
//
// Replaces the TPU kernel mirres_restir_nerf_mesh_tpu/ops/pallas_scatter.py
// `_kernel`, which turns the accumulation into one-hot matrix products on
// the MXU (bf16 operands, a [rows/128, 128*C] block resident in VMEM) only
// because random writes are slow on a TPU. This kernel computes what that
// kernel means, in fp32: out[idx[i], c] += upd[i, c] for every i with
// 0 <= idx[i] < rows (idx -1 marks padding; out-of-range rows are dropped,
// as the reference's scatter drops them).
//
// Bound on this card: bytes. At one material encode's backward (3,770,880
// updates of C = 2 into 6,328,848 rows) the kernel must read 15 MB of
// indices and 30 MB of updates and the table (50.6 MB) must be written once:
// 96 MB at 3.35 TB/s, 0.0286 ms. The wrapper zeroes the table; the kernel
// reads the inputs once, coalesced, and its only other traffic is the
// reductions into L2.
//
// Design for Hopper. The updates of an encode come point-major: idx is
// [N, Kc] with Kc = 8 corners x L levels, so one row of idx holds one
// point's corners across all levels, and equal table rows (the coarse dense
// levels: level 0 of the material grid has 4,920 rows for ~29k updates per
// corner) lie in the same column of neighbouring points.
// - A block takes P consecutive points x all Kc columns, loads their
//   indices and updates into shared memory with 16-byte loads.
// - It then walks column-wise: a warp takes one column for 32 points.
//   __match_any_sync groups the lanes whose rows are equal; the group's
//   lowest lane sums the group's values (in lane order) and issues one
//   reduction per distinct row, for C = 2 one vector reduction
//   (red.global.add.v2.f32) where the earlier kernel issued two scalar
//   atomics per update. Rows of the fine hashed levels are distinct within
//   a warp and cost one vector reduction each.
// - A 1-D caller (no column layout) is the case Kc = 1: a warp then groups
//   32 consecutive updates, and the block takes P = 2048 of them.
// Reductions sum in an arbitrary order across warps: the result matches a
// sequential sum within rounding, not bit for bit.
//
// Layouts: idx [N, Kc] int32, upd [N, Kc, C] fp32 row-major, out [rows, C]
// fp32.
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

// One block: points [p0, p0 + P) x Kc columns. Shared memory: idx
// [P, Kc | 1] int32, then upd [P, Kc | 1, C] fp32 (an odd row stride, so
// that the 32 lanes reading one column hit 32 banks).
__global__ void __launch_bounds__(256) scatter_add_cols_kernel(
    const int* __restrict__ idx, const float* __restrict__ upd, long long N,
    int Kc, int C, int P, int rows, float* __restrict__ out) {
  extern __shared__ int smem[];
  const int ld = Kc | 1;
  int* sidx = smem;
  float* supd = reinterpret_cast<float*>(smem + (size_t)P * ld);

  const long long p0 = (long long)blockIdx.x * P;
  const int np = (int)min((long long)P, N - p0);
  const int n_el = np * Kc;
  const long long base = p0 * Kc;

  // coalesced loads: 16 bytes a thread where the layout allows it
  if ((Kc & 3) == 0) {
    const int4* src = reinterpret_cast<const int4*>(idx + base);
    for (int i = threadIdx.x; i < n_el / 4; i += blockDim.x) {
      const int4 q = src[i];
      const int e = 4 * i, j = e / Kc, c = e - j * Kc;
      int* d = sidx + j * ld + c;
      d[0] = q.x, d[1] = q.y, d[2] = q.z, d[3] = q.w;
    }
  } else {
    for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
      const int j = e / Kc;
      sidx[j * ld + e - j * Kc] = idx[base + e];
    }
  }
  if (C == 2) {
    const float4* src = reinterpret_cast<const float4*>(upd + base * 2);
    for (int i = threadIdx.x; i < n_el / 2; i += blockDim.x) {
      const float4 q = src[i];
      const int e = 2 * i, j = e / Kc, c = e - j * Kc;
      float* d = supd + (size_t)(j * ld + c) * 2;
      d[0] = q.x, d[1] = q.y;
      const int e1 = e + 1, j1 = e1 / Kc;   // may start the next point
      float* d1 = supd + (size_t)(j1 * ld + e1 - j1 * Kc) * 2;
      d1[0] = q.z, d1[1] = q.w;
    }
    if ((n_el & 1) && threadIdx.x == 0) {
      const int e = n_el - 1, j = e / Kc;
      float* d = supd + (size_t)(j * ld + e - j * Kc) * 2;
      d[0] = upd[(base + e) * 2], d[1] = upd[(base + e) * 2 + 1];
    }
  } else {
    for (int f = threadIdx.x; f < n_el * C; f += blockDim.x) {
      const int e = f / C, ch = f - e * C, j = e / Kc;
      supd[(size_t)(j * ld + e - j * Kc) * C + ch] = upd[base * C + f];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_items = Kc * ((np + 31) >> 5);
  for (int it = warp; it < n_items; it += n_warps) {
    const int c = it % Kc;
    const int j = (it / Kc) * 32 + lane;
    int r = j < np ? sidx[j * ld + c] : -1;
    if (r >= rows) r = -1;
    const unsigned group = __match_any_sync(FULL_MASK, r);
    if (r < 0 || lane != __ffs(group) - 1) continue;
    float* dst = out + (size_t)r * C;
    if (C == 2) {
      float sx = 0.0f, sy = 0.0f;
      for (unsigned m = group; m; m &= m - 1) {
        const int jj = (j - lane) + __ffs(m) - 1;
        const float* s = supd + (size_t)(jj * ld + c) * 2;
        sx += s[0];
        sy += s[1];
      }
      // return value unused: one vector reduction (REDG ... F32x2)
      atomicAdd(reinterpret_cast<float2*>(dst), make_float2(sx, sy));
    } else {
      for (int ch = 0; ch < C; ++ch) {
        float s = 0.0f;
        for (unsigned m = group; m; m &= m - 1) {
          const int jj = (j - lane) + __ffs(m) - 1;
          s += supd[(size_t)(jj * ld + c) * C + ch];
        }
        atomicAdd(dst + ch, s);
      }
    }
  }
}

// Points per block for Kc columns: 32 points at Kc >= 64, up to 2048 at
// Kc = 1 (about 2k-4k updates a block).
static int points_per_block(int Kc) {
  int groups = 2048 / (32 * Kc);
  if (groups < 1) groups = 1;
  return 32 * groups;
}

// Shared memory bytes one block of scatter_add_launch needs (0 = the
// shape does not fit a block).
extern "C" long long scatter_add_smem(int Kc, int C) {
  const long long P = points_per_block(Kc);
  const long long bytes = P * (Kc | 1) * 4LL * (1 + C);
  return bytes <= 227 * 1024 ? bytes : 0;
}

// idx [N, Kc], upd [N, Kc, C]; launches on `stream`, returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue when the
// shape does not fit a block.
extern "C" int scatter_add_launch(const int* idx, const float* upd,
                                  long long N, int Kc, int C, int rows,
                                  float* out, void* stream) {
  const long long smem = scatter_add_smem(Kc, C);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scatter_add_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int P = points_per_block(Kc);
  const long long blocks = (N + P - 1) / P;
  scatter_add_cols_kernel<<<(unsigned)blocks, 256, (size_t)smem,
                            (cudaStream_t)stream>>>(idx, upd, N, Kc, C, P,
                                                    rows, out);
  return (int)cudaGetLastError();
}
