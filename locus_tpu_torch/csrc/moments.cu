// Exact radius moments (kernels B1, B4, B5 and B6 of the port).
//
// Replaces the TPU kernels of locus_tpu/ops/pallas/moments.py:
//   B1 _moments_kernel_visits          box-pruned (pallas_call in _moments_visits)
//   B4 _moments_kernel_visits_batched  B1 per batch member (its custom-vmap rule)
//   B5 _moments_kernel                 dense, every chunk (pallas_call in _moments_call)
//   B6 _moments_kernel_batched         B5 per batch member (its custom-vmap rule)
// For each query it sums, over the targets that pass the gate
//     (|t|^2 - 2 q.t) + |q|^2 <= r^2,
// the ten raw moments [x, y, z, xx, yy, zz, xy, xz, yz, 1] of the target.
// The pruned kernels visit only the chunks on each tile's visit list; the
// dense ones visit every chunk. The Python wrapper (ops/kernels/moments.py)
// builds the visit lists by box pruning and turns the sums into mean and
// covariance.
//
// Batching: blockIdx.y is the batch member, whose operands, visit lists,
// radius and outputs start at per-member offsets. The single entries
// launch one member; the batched ones B members in one launch. A member's
// thread arithmetic does not depend on the batch.
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
// - Each visited chunk (BT float4 words: 8 KB at the pruned MBT = 512,
//   16 KB at the dense 1024) is staged in shared memory by the whole block.
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
// Operands, per member (members contiguous): q (n_pad, 4) float4
// [x, y, z, |q|^2]; t (m_pad, 4) float4 [x, y, z, |t|^2], padding rows
// |t|^2 = 1e12 (fail every gate); cnt (G,) int32; ids (G * C,) int32,
// prefix-packed per tile; r2 one f32 per member. Output: (n_pad, 10) f32
// raw sums.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int SPLIT = 4;
constexpr int THREADS = BQ * SPLIT;
constexpr int NM = 10;

// Stage chunk `src` (BT targets) in shared memory and add the moments of
// the targets within the radius to this thread's sums.
template <int BT>
__device__ __forceinline__ void accumulate_chunk(float4* chunk, const float4* __restrict__ src,
                                                 float4 qv, float r2, int tid, int s,
                                                 double* a) {
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

// Fixed butterfly over the SPLIT lanes of each query, then one f32
// rounding per sum.
__device__ __forceinline__ void write_sums(double* a, int s, float* __restrict__ out) {
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1) {
#pragma unroll
    for (int c = 0; c < NM; ++c) {
      a[c] += __shfl_xor_sync(0xffffffffu, a[c], off);
    }
  }
  if (s == 0) {
#pragma unroll
    for (int c = 0; c < NM; ++c) out[c] = static_cast<float>(a[c]);
  }
}

// Pruned: the chunks on the tile's visit list (B1, B4).
template <int BT>
__global__ void __launch_bounds__(THREADS)
moments_visits_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                      const int* __restrict__ cnt, const int* __restrict__ ids,
                      const float* __restrict__ r2p, int num_tiles, int num_chunks,
                      float* __restrict__ out) {
  __shared__ float4 chunk[BT];
  const size_t b = blockIdx.y;
  const size_t n_pad = (size_t)num_tiles * BQ;
  q += b * n_pad;
  t += b * (size_t)num_chunks * BT;
  cnt += b * num_tiles;
  ids += b * num_tiles * (size_t)num_chunks;
  out += b * n_pad * NM;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = tid % SPLIT;
  const int row = g * BQ + tid / SPLIT;
  const float4 qv = q[row];
  const float r2 = r2p[b];

  double a[NM];
#pragma unroll
  for (int c = 0; c < NM; ++c) a[c] = 0.0;
  const int nv = cnt[g];
  const int* my_ids = ids + (size_t)g * num_chunks;
  for (int v = 0; v < nv; ++v) {
    accumulate_chunk<BT>(chunk, t + (size_t)my_ids[v] * BT, qv, r2, tid, s, a);
  }
  write_sums(a, s, out + (size_t)row * NM);
}

// Dense: every chunk, in order (B5, B6).
template <int BT>
__global__ void __launch_bounds__(THREADS)
moments_dense_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                     const float* __restrict__ r2p, int num_tiles, int num_chunks,
                     float* __restrict__ out) {
  __shared__ float4 chunk[BT];
  const size_t b = blockIdx.y;
  const size_t n_pad = (size_t)num_tiles * BQ;
  q += b * n_pad;
  t += b * (size_t)num_chunks * BT;
  out += b * n_pad * NM;

  const int tid = threadIdx.x;
  const int s = tid % SPLIT;
  const int row = blockIdx.x * BQ + tid / SPLIT;
  const float4 qv = q[row];
  const float r2 = r2p[b];

  double a[NM];
#pragma unroll
  for (int c = 0; c < NM; ++c) a[c] = 0.0;
  for (int c = 0; c < num_chunks; ++c) {
    accumulate_chunk<BT>(chunk, t + (size_t)c * BT, qv, r2, tid, s, a);
  }
  write_sums(a, s, out + (size_t)row * NM);
}

constexpr int MBT = 512;     // pruned chunk
constexpr int DENSE_BT = 1024;  // dense chunk (the JAX package's BT)

int launch_visits(const void* q, const void* t, const void* cnt, const void* ids,
                  const void* r2, int batch, int num_tiles, int num_chunks, int bt,
                  void* out, void* stream) {
  if (bt != MBT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(num_tiles, batch), block(THREADS);
  moments_visits_kernel<MBT><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(t),
      static_cast<const int*>(cnt), static_cast<const int*>(ids),
      static_cast<const float*>(r2), num_tiles, num_chunks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int launch_dense(const void* q, const void* t, const void* r2, int batch, int num_tiles,
                 int num_chunks, int bt, void* out, void* stream) {
  if (bt != DENSE_BT) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(num_tiles, batch), block(THREADS);
  moments_dense_kernel<DENSE_BT><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(t),
      static_cast<const float*>(r2), num_tiles, num_chunks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel B1: one member, visit lists.
extern "C" int locus_moments_visits(const void* q, const void* t,
                                    const void* cnt, const void* ids,
                                    const void* r2, int num_tiles,
                                    int num_chunks, int bt, void* out,
                                    void* stream) {
  return launch_visits(q, t, cnt, ids, r2, 1, num_tiles, num_chunks, bt, out, stream);
}

// Kernel B4: `batch` members, visit lists, one radius per member.
extern "C" int locus_moments_visits_batched(const void* q, const void* t,
                                            const void* cnt, const void* ids,
                                            const void* r2, int batch,
                                            int num_tiles, int num_chunks,
                                            int bt, void* out, void* stream) {
  return launch_visits(q, t, cnt, ids, r2, batch, num_tiles, num_chunks, bt, out, stream);
}

// Kernel B5: one member, every chunk.
extern "C" int locus_moments_dense(const void* q, const void* t, const void* r2,
                                   int num_tiles, int num_chunks, int bt,
                                   void* out, void* stream) {
  return launch_dense(q, t, r2, 1, num_tiles, num_chunks, bt, out, stream);
}

// Kernel B6: `batch` members, every chunk, one radius per member.
extern "C" int locus_moments_dense_batched(const void* q, const void* t,
                                           const void* r2, int batch,
                                           int num_tiles, int num_chunks,
                                           int bt, void* out, void* stream) {
  return launch_dense(q, t, r2, batch, num_tiles, num_chunks, bt, out, stream);
}
