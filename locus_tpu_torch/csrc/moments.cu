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
// products and 10 float64 sums. A staged chunk is read once per block from
// device memory (or L2) and served from shared memory to the block's
// queries.
//
// The pruned kernels (B1, B4) have their own design, described above
// moments_visits_kernel below. The dense ones (B5, B6), on no path:
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
// Both designs:
// - The gate is evaluated with the plain version's rounding steps, so the
//   two count the same neighbours, boundary cases included.
// - The radius, the visit count and the chunk ids come from device
//   memory, so a launch needs no host synchronisation. No atomics.
//
// Operands, per member (members contiguous): q (n_pad, 4) float4
// [x, y, z, |q|^2]; t (m_pad, 4) float4 [x, y, z, |t|^2], padding rows
// |t|^2 = 1e12 (fail every gate); cnt (G,) int32; ids (G * C,) int32,
// prefix-packed per tile; r2 one f32 per member. Output: (n_pad, 10) f32
// raw sums.
#include <cuda_runtime.h>
#include <math.h>

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

constexpr int DENSE_BT = 1024;  // dense chunk (the JAX package's BT)

// ---------------------------------------------------------------------------
// Pruned kernel (B1, B4).
//
// Grid (tile parts, members): a tile's 64 queries go to qs blocks (query
// splits need no merge); a block has 4 P warps, P for each quarter (128
// targets) of a chunk, and each warp OCT octets of 8 queries. B1/B4 launch
// (qs, P) = (2, 4), 512 threads, one octet a warp: the fastest instance at
// B1's and B4's shapes on the H100. The other instances are compiled only
// into the sweep build (-DLOCUS_MOMENTS_SWEEP, tools/torch_moments_ab.py).
// A block walks its tile's visited chunks
// in list order. Each chunk is copied with 16-byte cp.async into one of
// two float4 buffers (the next chunk loads while this one is summed, and
// the chunk id after it is read meanwhile). Then, once per target: its
// nine f32 features (__fmul_rn, as in the plain version) as float64 rows,
// its gate operand [-2x, -2y, -2z, |t|^2] over the coordinates, and the
// box of each group of 32 targets (warp integer min/max reductions).
//
// Pruning inside the tile: a warp skips a group of 32 targets for an
// octet whose box lies farther from the group's box than the radius plus
// a margin that bounds the f32 gate's rounding (`apart`), so it skips only
// pairs the gate rejects: most pairs of a visited chunk, whose neighbours
// (a few % of its pairs) lie in a few groups.
//
// Order of the sums: warp (w, .) sums, for each of its queries, targets
// 128w .. 128w + 127 of each visited chunk, in list order, and the four
// quarter partials combine as ((P0 + P1) + (P2 + P3)) before the one f32
// rounding. That order depends on the visit list alone, never on qs, P or
// the batch, so a member of B4 gets the bits of B1 even where a float64
// sum rounds.
//
// Sums on the FP64 tensor cores: the product W F of the 0/1 gate matrix
// (queries x targets) and the feature matrix (targets x 16, float64: the
// nine staged features, the count's constant 1, six zero columns) on
// mma.sync m8n8k4 f64. Lane (i, k) of a warp gates query i of an octet
// against target k of a quad of four targets (its A element, from the
// warp's ballot); its B elements are features i and 8 + i of target k.
// Each product is 1.0 * f or 0 and each sum runs in float64. An (octet,
// quad) whose 32 gates all fail skips its two mma: adding zeros would
// leave the sums' bits as they are (they start at +0). On the H100 these
// mma issue far below the FP64 tensor-core peak, so the pruning, not the
// mma, is what keeps the sums cheap. Launch bounds hold the kernel to 42
// registers (three 512-thread blocks an SM).
// ---------------------------------------------------------------------------
constexpr int MBT = 512;          // pruned chunk
constexpr int QUARTER = MBT / 4;  // targets of a warp's partial
constexpr int NF = 9;             // staged feature rows: x y z xx yy zz xy xz yz
constexpr int FS = MBT + 4;       // feature row stride (float64): conflict-free B loads
constexpr float PAD_T2 = 1e12f;   // |t|^2 of a padding row (at the origin): fails every gate

// Dynamic shared memory of a pruned block: two float4 chunk buffers and
// the feature rows (the four warps' partials go over the features once they
// are consumed).
constexpr size_t VISITS_SMEM = 2 * MBT * sizeof(float4) + NF * FS * sizeof(double);
static_assert(4 * BQ * NM <= NF * FS, "the partials fit in the feature rows");

// One chunk (MBT float4) into shared memory by NT threads: 16-byte
// cp.async, one commit group.
template <int NT>
__device__ __forceinline__ void stage(float4* dst, const float4* src, int tid) {
#pragma unroll
  for (int e = tid; e < MBT; e += NT) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + e));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + e) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// d = a b + d on the FP64 tensor cores: A 8x4 and B 4x8, one element a
// lane; C/D 8x8, two a lane
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// The gate with the plain version's rounding steps: ((|t|^2 + qx(-2x)) +
// qy(-2y)) + qz(-2z), then + |q|^2 <= r^2; m = [-2x, -2y, -2z, |t|^2]
// (-2x is exact).
__device__ __forceinline__ bool inside(float4 qv, float4 m, float r2) {
  float sc = __fadd_rn(m.w, __fmul_rn(qv.x, m.x));
  sc = __fadd_rn(sc, __fmul_rn(qv.y, m.y));
  sc = __fadd_rn(sc, __fmul_rn(qv.z, m.z));
  return __fadd_rn(sc, qv.w) <= r2;
}

// The box (lo, hi) and largest |q|^2 (n2) of an octet's 8 queries, whose
// lanes (i, k) differ in i: a butterfly over lane bits 2-4, so every lane
// gets the result.
__device__ __forceinline__ void octet_box(float3& lo, float3& hi, float& n2) {
#pragma unroll
  for (unsigned off = 4; off < 32; off <<= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(0xffffffffu, lo.x, off));
    lo.y = fminf(lo.y, __shfl_xor_sync(0xffffffffu, lo.y, off));
    lo.z = fminf(lo.z, __shfl_xor_sync(0xffffffffu, lo.z, off));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(0xffffffffu, hi.x, off));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(0xffffffffu, hi.y, off));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(0xffffffffu, hi.z, off));
    n2 = fmaxf(n2, __shfl_xor_sync(0xffffffffu, n2, off));
  }
}

// A float's bits as an unsigned key in the float's order, and back (for
// the warp's integer min / max reductions; no NaN here)
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7FFFFFFFu : ~k);
}

// True when no query of a box (lo, hi, largest |q|^2 q2) can pass the gate
// against any target of a group box (glo, ghi, largest |t|^2 in glo.w). The
// gate's f32 score differs from the squared distance by at most
// 14 * 2^-24 (|q|^2 + |t|^2) (five rounded operations, and |q|^2, |t|^2
// each rounded from three squares); the margin is twice that, and the
// f32 box gap is discounted for its own rounding. So a skipped pair always
// fails the gate, and skipping changes no sum.
__device__ __forceinline__ bool apart(float3 lo, float3 hi, float q2, float4 glo, float4 ghi, float r2) {
  const float gx = fmaxf(fmaxf(glo.x - hi.x, lo.x - ghi.x), 0.0f);
  const float gy = fmaxf(fmaxf(glo.y - hi.y, lo.y - ghi.y), 0.0f);
  const float gz = fmaxf(fmaxf(glo.z - hi.z, lo.z - ghi.z), 0.0f);
  const float gap2 = gx * gx + gy * gy + gz * gz;
  return gap2 * (1.0f - 0x1p-20f) > r2 + 0x1p-19f * (q2 + glo.w);
}

// Block (x, b): queries x * QB .. x * QB + QB - 1 of member b, over every
// visited chunk of their tile; P warps a quarter, OCT octets a warp.
template <int OCT, int P>
__global__ void __launch_bounds__(128 * P, 1536 / (128 * P))
moments_visits_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                      const int* __restrict__ cnt, const int* __restrict__ ids,
                      const float* __restrict__ r2p, int num_tiles, int num_chunks,
                      float* __restrict__ out) {
  constexpr int NT = 128 * P;     // threads
  constexpr int QB = 8 * OCT * P;  // queries
  extern __shared__ float4 smem[];
  float4* raw = smem;                                         // [2][MBT]
  double* feat = reinterpret_cast<double*>(smem + 2 * MBT);   // [NF][FS]
  double* part = feat;  // [4][QB][NM] partials, over the consumed features
  __shared__ float4 gbox[MBT / 32][2];  // per 32 targets: (lo, largest |t|^2), (hi, 0)
  const int x = blockIdx.x;
  const int g = x / (BQ / QB);
  const size_t b = blockIdx.y;
  const size_t n_pad = (size_t)num_tiles * BQ;
  q += b * n_pad;
  t += b * (size_t)num_chunks * MBT;
  ids += (b * num_tiles + g) * (size_t)num_chunks;
  out += b * n_pad * NM;

  // the count and the first chunk id load together (slot 0 always holds a
  // chunk id), then the first chunk, and the queries meanwhile
  const int nv = cnt[b * num_tiles + g];
  const int c = ids[0];
  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5 & 3;  // quarter w
  const int i = lane >> 2, k = lane & 3;
  const int row0 = x * QB;
  const int ob = (tid >> 7) * OCT;  // the warp's first octet in the block
  if (nv > 0) stage<NT>(raw, t + (size_t)c * MBT, tid);
  int cn = nv > 1 ? ids[1] : 0;
  float4 qv[OCT];
#pragma unroll
  for (int o = 0; o < OCT; ++o) qv[o] = q[row0 + 8 * (ob + o) + i];
  const float r2 = r2p[b];
  // each octet's box and largest |q|^2, over its 8 query rows as given
  float3 olo[OCT], ohi[OCT];
  float oq2[OCT];
#pragma unroll
  for (int o = 0; o < OCT; ++o) {
    olo[o] = ohi[o] = make_float3(qv[o].x, qv[o].y, qv[o].z);
    oq2[o] = qv[o].w;
    octet_box(olo[o], ohi[o], oq2[o]);
  }

  // query i of each octet: sums 2k, 2k + 1 (c0) and 8 + 2k, 9 + 2k (c1)
  double c0[OCT][2], c1[OCT][2];
#pragma unroll
  for (int o = 0; o < OCT; ++o) c0[o][0] = c0[o][1] = c1[o][0] = c1[o][1] = 0.0;

  for (int v = 0; v < nv; ++v) {
    float4* cur = raw + (v & 1) * MBT;
    wait_staged<0>();
    __syncthreads();  // chunk v is staged; chunk v - 1 is consumed
    if (v + 1 < nv) {  // into chunk v - 1's buffer, while chunk v is summed
      stage<NT>(raw + ((v + 1) & 1) * MBT, t + (size_t)cn * MBT, tid);
      if (v + 2 < nv) cn = ids[v + 2];
    }
    // per target: the features, the gate operand [-2x, -2y, -2z, |t|^2]
    // in place of the coordinates, and the box of its group of 32 (the
    // warp's 32 consecutive targets; padding rows left out, sentinel rows
    // kept: two sentinels pass the gate against each other)
#pragma unroll
    for (int mm = 0; mm < (MBT + NT - 1) / NT; ++mm) {
      const int e = tid + mm * NT;
      if (NT > MBT && e >= MBT) break;
      const float4 tv = cur[e];
      feat[0 * FS + e] = tv.x;
      feat[1 * FS + e] = tv.y;
      feat[2 * FS + e] = tv.z;
      feat[3 * FS + e] = __fmul_rn(tv.x, tv.x);
      feat[4 * FS + e] = __fmul_rn(tv.y, tv.y);
      feat[5 * FS + e] = __fmul_rn(tv.z, tv.z);
      feat[6 * FS + e] = __fmul_rn(tv.x, tv.y);
      feat[7 * FS + e] = __fmul_rn(tv.x, tv.z);
      feat[8 * FS + e] = __fmul_rn(tv.y, tv.z);
      cur[e] = make_float4(-2.0f * tv.x, -2.0f * tv.y, -2.0f * tv.z, tv.w);
      // (a group of padding rows only gets lo = +inf, hi = -inf: apart from
      // every query)
      const bool real = tv.w != PAD_T2;
      const unsigned lo_pad = ordered(INFINITY), hi_pad = ordered(-INFINITY);
      const unsigned lx = __reduce_min_sync(0xffffffffu, real ? ordered(tv.x) : lo_pad);
      const unsigned ly = __reduce_min_sync(0xffffffffu, real ? ordered(tv.y) : lo_pad);
      const unsigned lz = __reduce_min_sync(0xffffffffu, real ? ordered(tv.z) : lo_pad);
      const unsigned hx = __reduce_max_sync(0xffffffffu, real ? ordered(tv.x) : hi_pad);
      const unsigned hy = __reduce_max_sync(0xffffffffu, real ? ordered(tv.y) : hi_pad);
      const unsigned hz = __reduce_max_sync(0xffffffffu, real ? ordered(tv.z) : hi_pad);
      const unsigned n2 = __reduce_max_sync(0xffffffffu, real ? __float_as_uint(tv.w) : 0u);  // |t|^2 >= 0
      if (lane == 0) {
        gbox[e / 32][0] = make_float4(unordered(lx), unordered(ly), unordered(lz), __uint_as_float(n2));
        gbox[e / 32][1] = make_float4(unordered(hx), unordered(hy), unordered(hz), 0.0f);
      }
    }
    __syncthreads();  // the chunk's features, gate operands and boxes are staged
    const float4* tq = cur + w * QUARTER;
    const double* fq = feat + w * QUARTER;
    for (int m = 0; m < QUARTER / 32; ++m) {  // a group of 32 targets: 8 quads
      const float4 glo = gbox[w * 4 + m][0], ghi = gbox[w * 4 + m][1];
      bool near[OCT];  // warp-uniform
      bool any = false;
#pragma unroll
      for (int o = 0; o < OCT; ++o) {
        near[o] = !apart(olo[o], ohi[o], oq2[o], glo, ghi, r2);
        any |= near[o];
      }
      if (!any) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int e = 32 * m + 4 * jj + k;
        const float4 tv = tq[e];
        // every near octet's gates first (independent: they pipeline), then
        // the sums; bit 4i' + k' of a ballot is query i' against target k'
        unsigned hit[OCT];
#pragma unroll
        for (int o = 0; o < OCT; ++o) hit[o] = near[o] ? __ballot_sync(0xffffffffu, inside(qv[o], tv, r2)) : 0u;
        const double b0 = fq[i * FS + e];
        const double b1 = i == 0 ? fq[8 * FS + e] : (i == 1 ? 1.0 : 0.0);
#pragma unroll
        for (int o = 0; o < OCT; ++o) {
          // most quads hold no neighbour of the octet: their products are
          // all zero, and adding a zero leaves every sum's bits as they are
          if (hit[o]) {
            const double a = hit[o] >> lane & 1u ? 1.0 : 0.0;
            mma_f64(c0[o], a, b0);
            mma_f64(c1[o], a, b1);
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the features
#pragma unroll
  for (int o = 0; o < OCT; ++o) {
    double* p = part + (w * QB + 8 * (ob + o) + i) * NM;
    p[2 * k] = c0[o][0];
    p[2 * k + 1] = c0[o][1];
    if (k == 0) {
      p[8] = c1[o][0];
      p[9] = c1[o][1];
    }
  }
  __syncthreads();
  for (int e = tid; e < QB * NM; e += NT) {
    const double s = (part[e] + part[QB * NM + e]) + (part[2 * QB * NM + e] + part[3 * QB * NM + e]);
    out[(size_t)row0 * NM + e] = static_cast<float>(s);
  }
}

template <int OCT, int P>
int launch_visits_t(const void* q, const void* t, const void* cnt, const void* ids,
                    const void* r2, int batch, int num_tiles, int num_chunks, int bt,
                    void* out, void* stream) {
  if (bt != MBT || batch < 1 || batch > 65535 || num_tiles < 1 || num_chunks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // more than 48 KB of dynamic shared memory needs an opt-in, once per device
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(moments_visits_kernel<OCT, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(VISITS_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) configured |= 1u << dev;
  }
  const dim3 grid(num_tiles * (BQ / (8 * OCT * P)), batch);
  moments_visits_kernel<OCT, P><<<grid, 128 * P, VISITS_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(t), static_cast<const int*>(cnt),
      static_cast<const int*>(ids), static_cast<const float*>(r2), num_tiles, num_chunks,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The instance B1/B4 launch: 2 blocks a tile, 4 warps a quarter (one octet
// of queries a warp)
constexpr int QUERY_SPLITS = 2, WARPS = 4;
constexpr auto launch_visits = launch_visits_t<BQ / QUERY_SPLITS / 8 / WARPS, WARPS>;

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
                                    int num_chunks, int bt, void* out, void* stream) {
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

#ifdef LOCUS_MOMENTS_SWEEP
// Sweep build only: B4 (B1 at batch 1) at any instance, `query_splits`
// blocks a tile and `warps` warps a quarter of a chunk, leaving one or two
// octets of queries a warp. Every instance sums in the same order, so all
// give the bits of the one above.
extern "C" int locus_moments_visits_sweep(const void* q, const void* t,
                                          const void* cnt, const void* ids,
                                          const void* r2, int batch,
                                          int num_tiles, int num_chunks, int bt,
                                          int query_splits, int warps, void* out,
                                          void* stream) {
#define LOCUS_VISITS(QS, P)                                                                       \
  if (query_splits == QS && warps == P) {                                                         \
    return launch_visits_t<BQ / QS / 8 / P, P>(q, t, cnt, ids, r2, batch, num_tiles, num_chunks, \
                                               bt, out, stream);                                  \
  }
  LOCUS_VISITS(1, 4) LOCUS_VISITS(1, 8)
  LOCUS_VISITS(2, 2) LOCUS_VISITS(2, 4)
  LOCUS_VISITS(4, 1) LOCUS_VISITS(4, 2)
  LOCUS_VISITS(8, 1)
#undef LOCUS_VISITS
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

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
