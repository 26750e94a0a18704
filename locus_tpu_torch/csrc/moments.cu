// Box-pruned exact radius moments (kernel B1 of the port).
//
// Replaces the TPU kernel locus_tpu/ops/pallas/moments.py::
// _moments_kernel_visits (pallas_call in _moments_visits). For each query
// it sums, over the targets of the visited chunks that pass the gate
//     (|t|^2 - 2 q.t) + |q|^2 <= r^2,
// the ten raw moments [x, y, z, xx, yy, zz, xy, xz, yz, 1] of the target.
// The Python wrapper (ops/kernels/moments.py) builds the visit lists by
// box pruning and turns the sums into mean and covariance.
//
// Bound on the H100: arithmetic. Each visited (query, target) pair costs
// 3 multiplies, 4 adds and a compare; each pair inside the radius adds 6
// products and 10 float64 sums. A staged chunk is read once per tile from device
// memory (or L2) and served from shared memory to all of the tile's
// queries.
//
// Design:
// - One block per tile of BQ = 64 queries, SPLIT = 4 threads per query:
//   256 threads. Thread s of a query scans the chunk targets k = s mod 4
//   (neighbouring lanes read neighbouring 16-byte words: no bank
//   conflicts) and keeps its 10 sums in registers.
// - Each visited chunk (MBT = 512 float4 words, 8 KB) is staged in shared
//   memory by the whole block.
// - The 4 partial sums of a query merge by a fixed butterfly of shuffles,
//   so the result does not depend on the schedule. No atomics.
// - Each feature is the f32 product the JAX package precomputes
//   (__fmul_rn: one rounding, no FMA contraction), and the sums run in
//   float64, where adding f32 values of a neighbourhood is exact in all
//   but extreme spreads of magnitude. So the result is the same for any
//   order of summation: the kernel agrees with its plain version (a
//   float64 matrix product) bit for bit, and the split over 4 lanes
//   changes nothing. The sums are rounded to f32 once, on output.
// - The gate is evaluated with the plain version's rounding steps, so the
//   two count the same neighbours, boundary cases included.
// - The radius, the visit count and the chunk ids come from device
//   memory, so a launch needs no host synchronisation.
//
// Operands: q (n_pad, 4) float4 [x, y, z, |q|^2]; t (m_pad, 4) float4
// [x, y, z, |t|^2], padding rows |t|^2 = 1e12 (fail every gate);
// cnt (G,) int32; ids (G * C,) int32, prefix-packed per tile; r2 (1,) f32.
// Output: (n_pad, 10) f32 raw sums.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int SPLIT = 4;
constexpr int THREADS = BQ * SPLIT;
constexpr int NM = 10;

template <int BT>
__global__ void __launch_bounds__(THREADS)
moments_visits_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                      const int* __restrict__ cnt, const int* __restrict__ ids,
                      const float* __restrict__ r2p, int num_chunks,
                      float* __restrict__ out) {
  __shared__ float4 chunk[BT];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lq = tid / SPLIT;
  const int s = tid % SPLIT;
  const int row = g * BQ + lq;
  const float4 qv = q[row];
  const float r2 = *r2p;

  double a[NM];
#pragma unroll
  for (int c = 0; c < NM; ++c) a[c] = 0.0;

  const int nv = cnt[g];
  const int* my_ids = ids + (size_t)g * num_chunks;
  for (int v = 0; v < nv; ++v) {
    const float4* src = t + (size_t)my_ids[v] * BT;
    __syncthreads();  // the previous chunk is fully consumed
    for (int k = tid; k < BT; k += THREADS) chunk[k] = src[k];
    __syncthreads();
    for (int k = s; k < BT; k += SPLIT) {
      const float4 tv = chunk[k];
      // ((|t|^2 + qx(-2x)) + qy(-2y)) + qz(-2z), each step rounded as
      // in the plain version (no FMA contraction), then + |q|^2
      float sc = __fadd_rn(tv.w, __fmul_rn(qv.x, -2.0f * tv.x));
      sc = __fadd_rn(sc, __fmul_rn(qv.y, -2.0f * tv.y));
      sc = __fadd_rn(sc, __fmul_rn(qv.z, -2.0f * tv.z));
      if (__fadd_rn(sc, qv.w) <= r2) {
        a[0] += tv.x;
        a[1] += tv.y;
        a[2] += tv.z;
        a[3] += __fmul_rn(tv.x, tv.x);
        a[4] += __fmul_rn(tv.y, tv.y);
        a[5] += __fmul_rn(tv.z, tv.z);
        a[6] += __fmul_rn(tv.x, tv.y);
        a[7] += __fmul_rn(tv.x, tv.z);
        a[8] += __fmul_rn(tv.y, tv.z);
        a[9] += 1.0;
      }
    }
  }
  // fixed butterfly over the SPLIT lanes of each query
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1) {
#pragma unroll
    for (int c = 0; c < NM; ++c) {
      a[c] += __shfl_xor_sync(0xffffffffu, a[c], off);
    }
  }
  if (s == 0) {
#pragma unroll
    for (int c = 0; c < NM; ++c) out[(size_t)row * NM + c] = static_cast<float>(a[c]);
  }
}

}  // namespace

extern "C" int locus_moments_visits(const void* q, const void* t,
                                    const void* cnt, const void* ids,
                                    const void* r2, int num_tiles,
                                    int num_chunks, int bt, void* out,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(num_tiles), block(THREADS);
  if (bt != 512) return static_cast<int>(cudaErrorInvalidValue);
  moments_visits_kernel<512><<<grid, block, 0, st>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(t),
      static_cast<const int*>(cnt), static_cast<const int*>(ids),
      static_cast<const float*>(r2), num_chunks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
