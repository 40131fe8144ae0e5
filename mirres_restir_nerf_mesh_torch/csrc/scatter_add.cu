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
// Design for Hopper: one thread per update row (grid-stride); a thread
// reads its index and its C values (one float2 load for C = 2) and issues
// one fp32 atomicAdd per channel, return value unused, so each compiles to
// a fire-and-forget reduction in L2. The wrapper zeroes the table. Atomics
// sum in an arbitrary order: the result matches a sequential sum within
// rounding, not bit for bit.
//
// Bound on this card: bytes. Each update reads 4 + 4*C bytes and the table
// is written once (rows * C * 4); there is no arithmetic to speak of.
// Contention on the small dense levels of a grid (level 0 of the material
// grid has 4,920 rows and takes ~29k updates per corner) serialises the
// atomics on those rows; warp aggregation or sorting is later work.
//
// Layouts: idx [M] int32, upd [M, C] fp32 row-major, out [rows, C] fp32.
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) scatter_add_kernel(
    const int* __restrict__ idx, const float* __restrict__ upd, long long M,
    int rows, int C, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += stride) {
    const int r = idx[i];
    if (r < 0 || r >= rows) continue;
    float* dst = out + (long long)r * C;
    if (C == 2) {
      const float2 p = reinterpret_cast<const float2*>(upd)[i];
      atomicAdd(dst, p.x);
      atomicAdd(dst + 1, p.y);
    } else {
      for (int c = 0; c < C; ++c) atomicAdd(dst + c, upd[i * C + c]);
    }
  }
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int scatter_add_launch(const int* idx, const float* upd,
                                  long long M, int rows, int C, float* out,
                                  void* stream) {
  const int threads = 256;
  long long blocks = (M + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  scatter_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      idx, upd, M, rows, C, out);
  return (int)cudaGetLastError();
}
