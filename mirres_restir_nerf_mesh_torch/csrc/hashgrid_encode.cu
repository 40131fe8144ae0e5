// One-corner (stochastic) hash-grid encode of every level in one launch:
// kernel K5, the forward of ops/hashgrid.py ``OneCornerEncode``.
//
// Replaces no TPU kernel: the JAX package forms the encode's rows with XLA
// operators, and the port's plain version (``encode_rows`` with
// ``stochastic_u`` followed by a row gather) dispatches about 22 operators
// per level from the host, ~350 for 16 levels, plus a [P, L] int64
// intermediate per step of the loop. This kernel computes the same rows and
// features, bit for bit, in one launch:
//   x01 = clamp((x + bound) / (2 bound), 0, 1)            per axis, fp32
//   pos = x01 * scale_l + 0.5 (rounded apart), g = floor(pos)
//   c   = g + (u < pos - g)                               the corner picked
//   idx = c0 + c1 R1 + c2 R1^2 (dense level) or
//         c0 ^ c1 * 2654435761 ^ c2 * 805459861 (hashed), wrapping uint32
//   row = offset_l + idx % size_l;  feats[p, l] = table[row] (C = 2)
// Products, sums and the quotient are the explicitly rounded intrinsics, so
// no contraction can change a bit whatever the flags.
//
// Bound on this card: bytes. At the stage-0 step (262,144 points, 16
// levels, rows written for the backward) x, u, 16 gathered rows of 8 B, the
// rows (int32) and the features (fp32) are 344 B a point, 90.2 MB, 0.027 ms
// at 3.35 TB/s; without rows (the occupancy update, 2,097,152 points) 280 B
// a point. The coarse dense levels stay in L2; the fine hashed levels read
// one random 32-byte sector per row.
//
// Design: a thread owns one level (threadIdx.x mod L, the block a multiple
// of L) for the whole launch and keeps that level's constants in registers,
// striding over points; a warp covers 32 / L points x L levels, so its
// stores of rows and float2 features are contiguous and its loads of x and u
// are broadcasts. The levels' constants travel by value in the launch's
// parameters (``LevelBlock``, read in place through __grid_constant__): no
// upload, no synchronization, nothing cached on the card.
//
// Layouts: x, u [P, 3] fp32, table [R, 2] fp32 (8-byte aligned), feats
// [P, L, 2] fp32, rows [P, L] int32 or null (not written).
#include <cuda_runtime.h>

#define MAX_LEVELS 32
#define THREADS 256
// blocks stride over the points: 4096 blocks of 256 threads are about four
// times what the card's 132 SMs hold at once
#define MAX_BLOCKS 4096

// The per-level constants (ops/hashgrid.py ``_LevelBlock`` mirrors it).
struct LevelBlock {
  int num_levels;
  unsigned dense;                // bit l set: level l is dense
  float scale[MAX_LEVELS];       // the level's scale, rounded to fp32
  unsigned offset[MAX_LEVELS];   // its first absolute row
  unsigned size[MAX_LEVELS];     // its rows
  unsigned mult[MAX_LEVELS][3];  // (1, R1, R1^2) dense, the primes hashed
};

__global__ void __launch_bounds__(THREADS) hashgrid_encode_kernel(
    const float* __restrict__ x, const float* __restrict__ u,
    const float2* __restrict__ table, long long P, float bound, float width,
    const __grid_constant__ LevelBlock lv, float2* __restrict__ feats,
    int* __restrict__ rows) {
  const int L = lv.num_levels;
  const int per_block = blockDim.x / L;
  const int lvl = threadIdx.x % L;
  const float scale = lv.scale[lvl];
  const unsigned offset = lv.offset[lvl], size = lv.size[lvl];
  const unsigned m0 = lv.mult[lvl][0], m1 = lv.mult[lvl][1], m2 = lv.mult[lvl][2];
  const bool dense = (lv.dense >> lvl) & 1u;
  const long long stride = (long long)gridDim.x * per_block;
  for (long long p = (long long)blockIdx.x * per_block + threadIdx.x / L; p < P;
       p += stride) {
    unsigned c[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float v = __fdiv_rn(__fadd_rn(__ldg(x + 3 * p + d), bound), width);
      v = fminf(fmaxf(v, 0.0f), 1.0f);
      const float pos = __fadd_rn(__fmul_rn(v, scale), 0.5f);
      const float g = floorf(pos);
      c[d] = (unsigned)g + (__ldg(u + 3 * p + d) < __fsub_rn(pos, g) ? 1u : 0u);
    }
    const unsigned a = c[0] * m0, b = c[1] * m1, e = c[2] * m2;
    const unsigned row = offset + (dense ? a + b + e : a ^ b ^ e) % size;
    const long long o = p * L + lvl;
    feats[o] = __ldg(table + row);
    if (rows) rows[o] = (int)row;
  }
}

// x, u [P, 3], table [R, 2], feats [P, L, 2], rows [P, L] or null; launches
// on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a level count outside [1, 32].
extern "C" int hashgrid_encode_launch(const float* x, const float* u,
                                      const float* table, long long P,
                                      float bound, float width,
                                      const LevelBlock* levels, float* feats,
                                      int* rows, void* stream) {
  const int L = levels->num_levels;
  if (L < 1 || L > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  const int per_block = THREADS / L;
  long long blocks = (P + per_block - 1) / per_block;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  hashgrid_encode_kernel<<<(unsigned)blocks, per_block * L, 0,
                           (cudaStream_t)stream>>>(
      x, u, reinterpret_cast<const float2*>(table), P, bound, width, *levels,
      reinterpret_cast<float2*>(feats), rows);
  return (int)cudaGetLastError();
}
