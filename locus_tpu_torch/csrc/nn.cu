// Visit-list exact 1-NN (kernels B2 and B3 of the port).
//
// Replaces the TPU kernels locus_tpu/ops/pallas/nn.py::_nn_kernel_visits
// (pallas_call in _visits_nn_single; B2) and ::_nn_kernel_visits_batched
// (pallas_call in _visits_nn_batched, the custom-vmap rule of _visits_nn;
// B3). For each packed query it scans the target chunks on its tile's
// visit list and keeps the lowest score |t|^2 - 2 q.t, which shares its
// argmin with the true squared distance, and that target's index. The
// Python wrapper (ops/kernels/nn.py) builds the visit lists by box pruning
// and recomputes the exact distance of each winner.
//
// One kernel serves both: blockIdx.y is the batch member, whose operands,
// visit lists, scratch and outputs start at per-member offsets. The single
// path (B2, locus_nn_visits) launches it with one member; the batched
// replay (B3, locus_nn_visits_batched) with B members, one launch for all.
//
// Bound on the H100: operations, not bytes. Each visited (query, target)
// pair costs 3 multiplies, 3 adds and a compare, while a staged slice is
// read once from device memory (or L2) per block and then served from
// shared memory to the block's queries. The multiplies and adds are issued
// unfused (__fmul_rn/__fadd_rn, so that the score rounds step by step as
// the plain version's does and the two pick the same winner), and an
// unfused fp32 multiply, add or compare issues at half the FMA rate:
// 33.5e12/s on the H100 SXM, not the 67e12 that counts an FMA as two
// operations. With a contraction depth of 3 the tensor cores offer
// nothing. In instructions a pair costs 9 (3 FMUL, 3 FADD, FSETP, FSEL,
// SEL) plus a share of a 16-byte shared load.
//
// Design:
// - A slice is SUB = 512 consecutive targets of one visited chunk; tile g
//   of a member has cnt[g] * bt/SUB slices. The grid is (tile parts,
//   members, S): a tile's 64 queries are split over qs = 1, 2 or 4 blocks
//   (64, 32 or 16 queries each), and block j of a tile part takes slices
//   j, j+S, j+2S, ... The wrapper picks qs and S from the shapes alone
//   (never from cnt, so there is no host synchronisation): splitting the
//   queries needs no merge, splitting the slices (the map) does. A block
//   that finds no slice of its own exits at once; the splits vary slowest,
//   so every tile's first blocks are scheduled first.
// - 128 threads: groups of LANES = 8, 16 or 32 threads share 4 queries
//   (64, 32 or 16 queries a block). Thread s of a group scans the slice's
//   targets k = s mod LANES, each loaded once from shared memory and scored
//   against its 4 queries: 4 independent running minima, so consecutive
//   compare-selects do not wait on each other. Each minimum uses a strict
//   '<' over ascending indices; the slices, the lanes and the blocks of a
//   tile part are then merged by (score, index) lexicographic minimum.
//   That merge is associative and commutative, so any split gives the
//   lowest index among the minimal scores: the bits of the plain version.
// - Slices are staged with 16-byte cp.async into two shared buffers
//   (8 KB each): the next slice of a block loads while the current one is
//   scanned, and the chunk id of the one after is read meanwhile.
// - Merge in the same launch: when a tile part has more than one active
//   block, each writes its partial (score, index) pairs to scratch and
//   increments an int counter of its (member, tile part) with one acq_rel
//   atomic after a block barrier. The block that arrives last reads the
//   partials through the L2 (__ldcg), writes the outputs and resets the
//   counter to 0, so every launch leaves the counters at 0 (a CUDA graph may
//   replay a call). Integer atomics only. Two streams must not share a
//   counter buffer: launches that may overlap would count into the same
//   slots. A tile part whose work fits one block writes its outputs
//   directly; a tile with cnt = 0 gets (+inf, 0), as in the plain version.
// - The visit count and the chunk ids come from device memory. The kernel
//   allocates nothing: the wrapper passes the scratch (per call) and the
//   counters (zeroed once per device).
//
// Operands, per member (members contiguous): q (n_pad, 4) float4
// [x, y, z, 1]; t (m_pad, 4) float4 [-2x, -2y, -2z, |t|^2], padding rows
// |t|^2 = +inf; cnt (G,) int32; ids (G * C,) int32 with each tile's chunk
// ids packed to the front of its row. Scratch: partial (B, G * qs, S,
// 64 / qs) int2; counters (B * G * qs,) uint32, all 0. Outputs: best score
// (n_pad,) f32 and its member-local index (n_pad,) int32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // queries of a tile (a visit list)
constexpr int SUB = 512;      // targets of a slice
constexpr int THREADS = 128;
constexpr int QPT = 4;        // queries of a thread

__device__ __forceinline__ void take_min(float& bd, int& bi, float d, int i) {
  if (d < bd || (d == bd && i < bi)) {
    bd = d;
    bi = i;
  }
}

// (score, index) lexicographic minimum over the LANES lanes of a query
// group (LANES consecutive threads of one warp), per query
template <int LANES>
__device__ __forceinline__ void merge_lanes(float (&bd)[QPT], int (&bi)[QPT]) {
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
#pragma unroll
    for (int r = 0; r < QPT; ++r) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[r], off);
      take_min(bd[r], bi[r], od, oi);
    }
  }
}

// Stage one slice (SUB float4) into shared memory: 16-byte cp.async, four
// per thread, as one commit group.
__device__ __forceinline__ void stage(float4* dst, const float4* src, int tid) {
#pragma unroll
  for (int k = 0; k < SUB / THREADS; ++k) {
    const int e = tid + k * THREADS;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + e));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + e) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Block (x, b, j): part x % qs of tile x / qs of member b (BQ / qs
// queries: THREADS / LANES groups of QPT queries, LANES threads a group),
// slices j, j + S, ... of the tile.
template <int LANES>
__global__ void __launch_bounds__(THREADS)
nn_visits_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                 const int* __restrict__ cnt, const int* __restrict__ ids,
                 int num_tiles, int num_chunks, int spc, int2* __restrict__ partial,
                 unsigned* __restrict__ counters, float* __restrict__ d_out,
                 int* __restrict__ i_out) {
  constexpr int QPB = THREADS / LANES * QPT;  // queries of a block
  constexpr int STEPS = SUB / LANES;          // targets of a slice per thread
  __shared__ __align__(16) float4 buf[2][SUB];
  __shared__ int last;
  const int x = blockIdx.x;
  const int g = x / (BQ / QPB);
  const size_t b = blockIdx.y;
  const int j = blockIdx.z;
  const int S = gridDim.z;
  const int bt = spc * SUB;
  const size_t n_pad = (size_t)num_tiles * BQ;
  q += b * n_pad;
  t += b * (size_t)num_chunks * bt;
  cnt += b * num_tiles;
  ids += (b * num_tiles + g) * (size_t)num_chunks;
  d_out += b * n_pad;
  i_out += b * n_pad;

  // the visit count and, before it is known, the chunks of slices j and
  // j + S (the wrapper keeps S <= num_chunks * spc, so j lies in the
  // tile's row)
  const int nslices = cnt[g] * spc;
  int c = ids[j / spc];
  int cn = j + S < num_chunks * spc ? ids[(j + S) / spc] : 0;
  const int nact = min(S, nslices);  // blocks of this tile part with work
  if (j >= max(nact, 1)) return;     // block 0 stays for cnt = 0: (+inf, 0)

  const int tid = threadIdx.x;
  const int s = tid % LANES;
  const int lrow = x * QPB - g * BQ + (tid / LANES) * QPT;  // first query of this thread in the tile
  const int row0 = g * BQ + lrow;
  float qx[QPT], qy[QPT], qz[QPT];
  float bd[QPT];
  int bi[QPT];
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const float4 qv = q[row0 + r];
    qx[r] = qv.x;
    qy[r] = qv.y;
    qz[r] = qv.z;
    bd[r] = INFINITY;
    bi[r] = 0;
  }

  if (j < nslices) stage(buf[0], t + (size_t)c * bt + (j % spc) * SUB, tid);
  int n = 0;
  for (int k = j; k < nslices; k += S, ++n) {
    const int base = c * bt + (k % spc) * SUB;
    const int kn = k + S;
    if (kn < nslices) {
      stage(buf[(n + 1) & 1], t + (size_t)cn * bt + (kn % spc) * SUB, tid);
      c = cn;
      if (kn + S < nslices) cn = ids[(kn + S) / spc];  // loads while this slice is scanned
      wait_staged<1>();
    } else {
      wait_staged<0>();
    }
    __syncthreads();  // slice k is in buf[n & 1] for every thread
    const float4* sl = buf[n & 1];
    float cd[QPT];
    int ci[QPT];
#pragma unroll
    for (int r = 0; r < QPT; ++r) {
      cd[r] = INFINITY;
      ci[r] = 0;
    }
#pragma unroll 8
    for (int m = 0; m < STEPS; ++m) {
      const int kk = m * LANES + s;
      const float4 tv = sl[kk];
#pragma unroll
      for (int r = 0; r < QPT; ++r) {
        // ((|t|^2 + qx tx) + qy ty) + qz tz, each step rounded as in the
        // plain version (no FMA contraction): the two agree bit for bit
        float sc = __fadd_rn(tv.w, __fmul_rn(qx[r], tv.x));
        sc = __fadd_rn(sc, __fmul_rn(qy[r], tv.y));
        sc = __fadd_rn(sc, __fmul_rn(qz[r], tv.z));
        if (sc < cd[r]) {
          cd[r] = sc;
          ci[r] = kk;
        }
      }
    }
    // a query that found nothing in the slice holds (+inf, base), which
    // never beats the block's (+inf, 0)
#pragma unroll
    for (int r = 0; r < QPT; ++r) take_min(bd[r], bi[r], cd[r], base + ci[r]);
    __syncthreads();  // buf[n & 1] is consumed before it is staged again
  }
  merge_lanes<LANES>(bd, bi);

  if (nact <= 1) {  // this block alone covers its queries
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < QPT; ++r) {
        d_out[row0 + r] = bd[r];
        i_out[row0 + r] = bi[r];
      }
    }
    return;
  }
  const size_t unit = b * gridDim.x + x;  // (member, tile part): one counter each
  int2* part = partial + unit * S * QPB + (tid / LANES) * QPT;
  if (s == 0) {
#pragma unroll
    for (int r = 0; r < QPT; ++r) part[j * QPB + r] = make_int2(__float_as_int(bd[r]), bi[r]);
  }
  __syncthreads();  // the block's partials are written
  if (tid == 0) {
    unsigned prev;
    // acq_rel at device scope: releases this block's partials (ordered
    // before it by the barrier) and acquires those of the blocks that
    // counted earlier
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(prev) : "l"(counters + unit) : "memory");
    last = prev == static_cast<unsigned>(nact - 1);
    if (last) counters[unit] = 0;  // every block has counted: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    bd[r] = INFINITY;
    bi[r] = 0;
    for (int jj = s; jj < nact; jj += LANES) {
      const int2 p = __ldcg(part + jj * QPB + r);  // through the L2, never a stale L1 line
      take_min(bd[r], bi[r], __int_as_float(p.x), p.y);
    }
  }
  merge_lanes<LANES>(bd, bi);
  if (s == 0) {
#pragma unroll
    for (int r = 0; r < QPT; ++r) {
      d_out[row0 + r] = bd[r];
      i_out[row0 + r] = bi[r];
    }
  }
}

int launch(const void* q, const void* t, const void* cnt, const void* ids,
           int batch, int num_tiles, int num_chunks, int bt, int query_splits,
           int splits, void* partial, void* counters, void* d_out, void* i_out,
           void* stream) {
  if (batch < 1 || batch > 65535 || num_tiles < 1 || num_chunks < 1 || bt < SUB || bt % SUB
      || splits < 1 || splits > 65535 || splits > num_chunks * (bt / SUB)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the splits vary slowest, so that every tile's first blocks are
  // scheduled before the blocks that may find no work
  const dim3 grid(num_tiles * query_splits, batch, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float4*>(q);
  const auto* tp = static_cast<const float4*>(t);
  const auto* cp = static_cast<const int*>(cnt);
  const auto* ip = static_cast<const int*>(ids);
  auto* pp = static_cast<int2*>(partial);
  auto* kp = static_cast<unsigned*>(counters);
  auto* dp = static_cast<float*>(d_out);
  auto* op = static_cast<int*>(i_out);
  const int spc = bt / SUB;
  switch (query_splits) {  // 64, 32 or 16 queries a block: 8, 16 or 32 threads a group
    case 1:
      nn_visits_kernel<8><<<grid, THREADS, 0, st>>>(qp, tp, cp, ip, num_tiles, num_chunks, spc, pp, kp, dp, op);
      break;
    case 2:
      nn_visits_kernel<16><<<grid, THREADS, 0, st>>>(qp, tp, cp, ip, num_tiles, num_chunks, spc, pp, kp, dp, op);
      break;
    case 4:
      nn_visits_kernel<32><<<grid, THREADS, 0, st>>>(qp, tp, cp, ip, num_tiles, num_chunks, spc, pp, kp, dp, op);
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
                               int bt, int query_splits, int splits, void* partial,
                               void* counters, void* d_out, void* i_out, void* stream) {
  return launch(q, t, cnt, ids, 1, num_tiles, num_chunks, bt, query_splits, splits,
                partial, counters, d_out, i_out, stream);
}

// Kernel B3: `batch` members in one launch.
extern "C" int locus_nn_visits_batched(const void* q, const void* t,
                                       const void* cnt, const void* ids,
                                       int batch, int num_tiles,
                                       int num_chunks, int bt, int query_splits,
                                       int splits, void* partial, void* counters,
                                       void* d_out, void* i_out, void* stream) {
  return launch(q, t, cnt, ids, batch, num_tiles, num_chunks, bt, query_splits,
                splits, partial, counters, d_out, i_out, stream);
}
