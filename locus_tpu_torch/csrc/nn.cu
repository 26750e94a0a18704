// Visit-list exact 1-NN (kernels B2 and B3 of the port).
//
// Replaces the TPU kernels locus_tpu/ops/pallas/nn.py::_nn_kernel_visits
// (pallas_call in _visits_nn_single; B2) and ::_nn_kernel_visits_batched
// (pallas_call in _visits_nn_batched, the custom-vmap rule of _visits_nn;
// B3). For each query tile it scans the target chunks on the tile's visit
// list and keeps, per query, the lowest score |t|^2 - 2 q.t, which shares
// its argmin with the true squared distance. The Python wrapper
// (ops/kernels/nn.py) builds the visit lists by box pruning and recomputes
// the exact distance of each winner.
//
// One kernel serves both: blockIdx.y is the batch member, whose operands,
// visit lists and outputs start at per-member offsets. The single path
// (B2, locus_nn_visits) launches it with one member; the batched replay
// (B3, locus_nn_visits_batched) with B members, one launch for all of them.
// A member's thread arithmetic does not depend on the batch, so a batched
// launch gives each member the bits of its single launch.
//
// Bound on the H100: arithmetic, not bytes. Each visited (query, target)
// pair costs 3 multiplies, 3 adds and a compare, while a staged chunk is read once from
// device memory (or L2) per tile and then served from shared memory to all
// of the tile's queries. With a contraction depth of 3 the tensor cores
// offer nothing; plain fp32 arithmetic it is. The score is rounded step by
// step as the plain version rounds it (no FMA contraction), so kernel and
// plain version pick the same winner, ties included.
//
// Design:
// - One block per tile of BQ = 64 queries of one member, SPLIT = 4 threads
//   per query: 256 threads. Thread s of a query scans the chunk targets
//   k = s mod 4, so neighbouring lanes read neighbouring 16-byte words of
//   the staged chunk (no bank conflicts; the 8 queries of a warp share them
//   by broadcast).
// - Each visited chunk (BT float4 words: 8 KB at BT=512, 32 KB at 2048)
//   is staged in shared memory by the whole block.
// - A running minimum per thread with strict '<' over ascending target
//   indices; the 4 lanes of a query then merge by (score, index)
//   lexicographic minimum. The result is the lowest index among the
//   minimal scores, independent of the schedule. No atomics.
// - The visit count and the chunk ids come from device memory, so a launch
//   needs no host synchronisation.
//
// Operands, per member (members contiguous): q (n_pad, 4) float4
// [x, y, z, unused]; t (m_pad, 4) float4 [-2x, -2y, -2z, |t|^2], padding
// rows |t|^2 = +inf; cnt (G,) int32; ids (G * C,) int32 with each tile's
// chunk ids packed to the front of its row. Outputs: best score (n_pad,)
// f32 and its member-local index (n_pad,) int32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int SPLIT = 4;
constexpr int THREADS = BQ * SPLIT;

template <int BT>
__global__ void __launch_bounds__(THREADS)
nn_visits_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                 const int* __restrict__ cnt, const int* __restrict__ ids,
                 int num_tiles, int num_chunks, float* __restrict__ d_out,
                 int* __restrict__ i_out) {
  __shared__ float4 chunk[BT];
  const size_t b = blockIdx.y;
  const size_t n_pad = (size_t)num_tiles * BQ;
  q += b * n_pad;
  t += b * (size_t)num_chunks * BT;
  cnt += b * num_tiles;
  ids += b * num_tiles * (size_t)num_chunks;
  d_out += b * n_pad;
  i_out += b * n_pad;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lq = tid / SPLIT;
  const int s = tid % SPLIT;
  const int row = g * BQ + lq;
  const float4 qv = q[row];

  float best_d = INFINITY;
  int best_i = 0;
  const int nv = cnt[g];
  const int* my_ids = ids + (size_t)g * num_chunks;
  for (int v = 0; v < nv; ++v) {
    const int c = my_ids[v];
    const float4* src = t + (size_t)c * BT;
    __syncthreads();  // the previous chunk is fully consumed
    for (int k = tid; k < BT; k += THREADS) chunk[k] = src[k];
    __syncthreads();
    const int base = c * BT;
#pragma unroll 4
    for (int k = s; k < BT; k += SPLIT) {
      const float4 tv = chunk[k];
      // ((|t|^2 + qx tx) + qy ty) + qz tz, each step rounded as in the
      // plain version (no FMA contraction): the two agree bit for bit
      float sc = __fadd_rn(tv.w, __fmul_rn(qv.x, tv.x));
      sc = __fadd_rn(sc, __fmul_rn(qv.y, tv.y));
      sc = __fadd_rn(sc, __fmul_rn(qv.z, tv.z));
      if (sc < best_d) {
        best_d = sc;
        best_i = base + k;
      }
    }
  }
  // merge the SPLIT lanes of each query: (score, index) lexicographic min
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best_d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (od < best_d || (od == best_d && oi < best_i)) {
      best_d = od;
      best_i = oi;
    }
  }
  if (s == 0) {
    d_out[row] = best_d;
    i_out[row] = best_i;
  }
}

int launch(const void* q, const void* t, const void* cnt, const void* ids,
           int batch, int num_tiles, int num_chunks, int bt, void* d_out,
           void* i_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(num_tiles, batch), block(THREADS);
  const auto* qp = static_cast<const float4*>(q);
  const auto* tp = static_cast<const float4*>(t);
  const auto* cp = static_cast<const int*>(cnt);
  const auto* ip = static_cast<const int*>(ids);
  auto* dp = static_cast<float*>(d_out);
  auto* op = static_cast<int*>(i_out);
  switch (bt) {
    case 512:
      nn_visits_kernel<512><<<grid, block, 0, st>>>(qp, tp, cp, ip, num_tiles, num_chunks, dp, op);
      break;
    case 2048:
      nn_visits_kernel<2048><<<grid, block, 0, st>>>(qp, tp, cp, ip, num_tiles, num_chunks, dp, op);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel B2: one member.
extern "C" int locus_nn_visits(const void* q, const void* t, const void* cnt,
                               const void* ids, int num_tiles, int num_chunks,
                               int bt, void* d_out, void* i_out,
                               void* stream) {
  return launch(q, t, cnt, ids, 1, num_tiles, num_chunks, bt, d_out, i_out, stream);
}

// Kernel B3: `batch` members in one launch.
extern "C" int locus_nn_visits_batched(const void* q, const void* t,
                                       const void* cnt, const void* ids,
                                       int batch, int num_tiles,
                                       int num_chunks, int bt, void* d_out,
                                       void* i_out, void* stream) {
  return launch(q, t, cnt, ids, batch, num_tiles, num_chunks, bt, d_out, i_out, stream);
}
