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
// dense ones visit every target. The Python wrapper (ops/kernels/moments.py)
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
// products and 10 float64 sums. A staged slice is read once per block from
// device memory (or L2) and served from shared memory to the block's
// queries.
//
// Each kernel has its own design, described above it below: the pruned
// one (B1, B4) above moments_visits_kernel, the dense one (B5, B6, on no
// path) above moments_dense_split_kernel. Both:
// - Stage the targets 512 at a time (a slice: a pruned chunk, or 128
//   quads of a dense block's targets) with 16-byte cp.async into two
//   shared buffers (the next slice loads while this one is summed), and
//   each target's nine f32 features (__fmul_rn: one rounding, no FMA
//   contraction, as the JAX package precomputes them) once a block, as
//   float64 rows.
// - Gate a warp's 8 queries (an octet) against 4 targets (a quad) at once,
//   lane (i, k) query i against target k, with the plain version's
//   rounding steps, so the two count the same neighbours, boundary cases
//   included; and sum the moments of the pairs inside, on the FP64 tensor
//   cores where a quad holds one, skipping a quad whose 32 gates all fail
//   (adding zeros would leave the sums' bits as they are).
// - Sum in float64, where adding f32 values of a neighbourhood is exact in
//   all but extreme spreads of magnitude, in an order fixed by the shapes
//   (never by the schedule), and round to f32 once, on output. So a kernel
//   agrees with its plain version (a float64 matrix product) bit for bit,
//   and a member of a batched launch gets the bits of its single launch.
// - Take the radius (and the visit lists) from device memory, so a launch
//   needs no host synchronisation. No float atomics.
//
// Operands, per member (members contiguous): q (n_pad, 4) float4
// [x, y, z, |q|^2]; t (m_pad, 4) float4 [x, y, z, |t|^2], padding rows
// |t|^2 = 1e12 (fail every gate); cnt (G,) int32; ids (G * C,) int32,
// prefix-packed per tile; r2 one f32 per member. Output: (n_pad, 10) f32
// raw sums. The dense kernels also take scratch for their split partials
// and the int counters of their merge (see moments_dense_split_kernel).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;  // queries of a tile (a visit list)
constexpr int NM = 10;

constexpr int MBT = 512;          // a staged slice: a pruned chunk, half a dense one
constexpr int QUARTER = MBT / 4;  // targets of a warp's partial
constexpr int NF = 9;             // staged feature rows: x y z xx yy zz xy xz yz
constexpr int FS = MBT + 4;       // feature row stride (float64): conflict-free B loads
constexpr float PAD_T2 = 1e12f;   // |t|^2 of a padding row (at the origin): fails every gate

// Dynamic shared memory of a block: two float4 slice buffers and the
// feature rows (the four quarters' partials go over the features once they
// are consumed).
constexpr size_t STAGE_SMEM = 2 * MBT * sizeof(float4) + NF * FS * sizeof(double);
static_assert(4 * BQ * NM <= NF * FS, "the partials fit in the feature rows");

// The first n (<= MBT) float4 of a slice into shared memory by NT threads,
// with 16-byte cp.async in one commit group: quad e / 4 (4 float4) from
// src + (e / 4) * STRIDE. The defaults copy one contiguous pruned chunk.
template <int NT, int STRIDE = 4>
__device__ __forceinline__ void stage(float4* dst, const float4* src, int tid, int n = MBT) {
#pragma unroll
  for (int e = tid; e < n; e += NT) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + e));
    const int k = (e >> 2) * STRIDE + (e & 3);  // e itself at STRIDE 4
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src + k) : "memory");
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

// Target e of a staged slice: its nine f32 features (__fmul_rn, as in the
// plain version) into the float64 rows, and its gate operand [-2x, -2y,
// -2z, |t|^2] over its coordinates. Returns the coordinates.
__device__ __forceinline__ float4 stage_features(float4* cur, double* feat, int e) {
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
  return tv;
}

// More than 48 KB of dynamic shared memory needs an opt-in, once per device
// and kernel (`configured`: one bit per device done)
template <typename Kernel>
cudaError_t allow_stage_smem(Kernel* kernel, unsigned& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && configured & (1u << dev))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(STAGE_SMEM));
  if (err == cudaSuccess && dev < 32) configured |= 1u << dev;
  return err;
}

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
      const float4 tv = stage_features(cur, feat, e);
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
  static unsigned configured = 0;
  const cudaError_t err = allow_stage_smem(moments_visits_kernel<OCT, P>, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(num_tiles * (BQ / (8 * OCT * P)), batch);
  moments_visits_kernel<OCT, P><<<grid, 128 * P, STAGE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(t), static_cast<const int*>(cnt),
      static_cast<const int*>(ids), static_cast<const float*>(r2), num_tiles, num_chunks,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The instance B1/B4 launch: 2 blocks a tile, 4 warps a quarter (one octet
// of queries a warp)
constexpr int QUERY_SPLITS = 2, WARPS = 4;
constexpr auto launch_visits = launch_visits_t<BQ / QUERY_SPLITS / 8 / WARPS, WARPS>;

// ---------------------------------------------------------------------------
// Dense kernel (B5, B6): the independent check of B1/B4's pruning, so it
// evaluates every (query, target) gate: no visit list, no box test.
//
// Grid (tiles, members, S = DENSE_SPLITS), fixed by the shapes: block j of
// a tile takes quads j, j + S, j + 2S, ... of the member's targets (a quad:
// 4 consecutive targets), 128 quads (MBT targets) a slice, and warp column
// w of the block every fourth quad of each slice, from the w-th. The pairs
// inside the radius cluster (all ~1000 sentinel rows of a padded scan pass
// the gate against each other), and summing them is the costly part of a
// pair; interleaved so, they spread evenly over the blocks of a tile and
// the warps of a block instead of piling onto a few warps, whose serial
// chain of tensor-core sums would be the launch's critical path. S
// divides the 256 quads of a 1024-point chunk, so every block has the same
// number of quads and none is idle, whatever the target count.
// A block holds the tile's 64 queries: 4 x 8 / OCT warps, warp (w, h)
// gating octets h OCT .. h OCT + OCT - 1 against its column's quads, each
// target against its OCT octets. B5/B6 launch (S, OCT) = (8, 4): 512
// blocks of 256 threads at B5's 64 tiles, all resident at once (4 an SM:
// launch bounds hold the kernel to 64 registers). Other instances (S,
// OCT) are compiled only into the sweep build.
//
// Sums: a quad in which no pair passes costs one vote and nothing else.
// Otherwise, for each octet with a pair inside: features 0-7 on the FP64
// tensor cores (W F as in B1, one mma.sync m8n8k4), and yz and the count
// by a float64 and an int add in each lane whose gate passes (on the H100
// faster at B5's and B6's shapes than float64 adds of all ten sums).
//
// Order of the sums, fixed by the shapes: per query, a partial for each
// column over its quads in order (the four lanes of a query merged by a
// fixed butterfly where each holds part of it); the block's partial
// ((Q0 + Q1) + (Q2 + Q3)); then the partials of splits 0, 1, ... added in
// that order, and one f32 rounding. A member of B6 so gets the bits of B5
// on its inputs.
//
// Merge in the same launch: each block writes its 64 x 10 float64 partial
// to scratch and, after a block barrier, counts itself on an int counter of
// its (member, tile) with one acq_rel atomic. The block that counts last
// reads the partials through the L2 (__ldcg), all splits' at once, adds
// them in split order, writes the outputs and resets the counter to 0, so
// every launch leaves the counters at 0 (as in nn.cu; a CUDA graph may
// replay a call). Integer atomics only. Launches that may run at once (on
// two streams) must not share a counter buffer.
//
// Scratch, per call: partial (B, G, S, 64, 10) float64.
// Counters: (B * G,) uint32, all 0, zeroed once per buffer.
// ---------------------------------------------------------------------------
constexpr int DENSE_BT = 1024;  // dense chunk (the JAX package's BT)

// Block (g, b, j): split j of tile g of member b; S splits a tile, OCT
// octets a warp.
template <int S, int OCT>
__global__ void __launch_bounds__(1024 / OCT, OCT)
moments_dense_split_kernel(const float4* __restrict__ q, const float4* __restrict__ t,
                           const float* __restrict__ r2p, int num_tiles, int num_chunks,
                           double* __restrict__ partial, unsigned* __restrict__ counters,
                           float* __restrict__ out) {
  // S divides a chunk's 256 quads: every block has whole 64-target parts of a slice
  static_assert((DENSE_BT / 4) % S == 0, "target splits divide a chunk's quads");
  constexpr int NT = 1024 / OCT;  // 4 columns x 8 / OCT warps
  extern __shared__ float4 smem[];
  float4* raw = smem;                                        // [2][MBT]
  double* feat = reinterpret_cast<double*>(smem + 2 * MBT);  // [NF][FS]
  double* part = feat;  // [4][BQ][NM] column partials, over the consumed features
  __shared__ bool last;
  const int g = blockIdx.x, j = blockIdx.z;
  const size_t b = blockIdx.y;
  const size_t n_pad = (size_t)num_tiles * BQ;
  const size_t unit = b * num_tiles + g;  // (member, tile): one counter each
  q += b * n_pad;
  t += b * (size_t)num_chunks * DENSE_BT + 4 * j;  // quad j: the block's first
  out += b * n_pad * NM;
  partial += unit * S * (BQ * NM);

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5 & 3;  // column w
  const int i = lane >> 2, k = lane & 3;
  const int row0 = g * BQ;
  const int ob = (tid >> 7) * OCT;                 // the warp's first octet
  const int nt = num_chunks * (DENSE_BT / S);      // the block's targets (4 a quad)
  const int ns = (nt + MBT - 1) / MBT;             // slices
  constexpr int stride = 4 * S;                    // from one of the block's quads to the next
  stage<NT, stride>(raw, t, tid, min(nt, MBT));
  float4 qv[OCT];
#pragma unroll
  for (int o = 0; o < OCT; ++o) qv[o] = q[row0 + 8 * (ob + o) + i];
  const float r2 = r2p[b];

  // query i of each octet: sums 2k, 2k + 1 (c0), and yz and the count over
  // this lane's targets
  double c0[OCT][2], yz[OCT];
  int cnt[OCT];
#pragma unroll
  for (int o = 0; o < OCT; ++o) {
    c0[o][0] = c0[o][1] = yz[o] = 0.0;
    cnt[o] = 0;
  }

  for (int v = 0; v < ns; ++v) {
    float4* cur = raw + (v & 1) * MBT;
    const int n = min(nt - v * MBT, MBT);  // targets of slice v: a multiple of 64
    wait_staged<0>();
    __syncthreads();  // slice v is staged; slice v - 1 is consumed
    if (v + 1 < ns) {
      stage<NT, stride>(raw + ((v + 1) & 1) * MBT, t + (size_t)(v + 1) * (MBT / 4) * stride, tid,
                        min(nt - (v + 1) * MBT, MBT));
    }
#pragma unroll
    for (int e = tid; e < MBT; e += NT) {
      if (e < n) stage_features(cur, feat, e);
    }
    __syncthreads();  // the slice's features and gate operands are staged
    // lane (i, k) of column w: target k of quads w, w + 4, ... of the slice,
    // n / 16 of them (a multiple of 4: four a step, no remainder)
    const float4* tq = cur + 4 * w + k;
    const double* fq = feat + 4 * w + k;
    for (int u0 = 0; u0 < n / 16; u0 += 4) {
#pragma unroll
      for (int u = u0; u < u0 + 4; ++u) {
        const float4 tv = tq[16 * u];
        bool in[OCT];
        bool any = false;
#pragma unroll
        for (int o = 0; o < OCT; ++o) {
          in[o] = inside(qv[o], tv, r2);
          any |= in[o];
        }
        // most quads hold no pair inside: one vote, and nothing to add
        if (!__any_sync(0xffffffffu, any)) continue;
        const double b0 = fq[i * FS + 16 * u], f8 = fq[8 * FS + 16 * u];
#pragma unroll
        for (int o = 0; o < OCT; ++o) {
          if (__any_sync(0xffffffffu, in[o])) {
            mma_f64(c0[o], in[o] ? 1.0 : 0.0, b0);
            if (in[o]) {
              yz[o] += f8;
              ++cnt[o];
            }
          }
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the features
#pragma unroll
  for (int o = 0; o < OCT; ++o) {
    double* p = part + (w * BQ + 8 * (ob + o) + i) * NM;
    // the four lanes of query i: a fixed butterfly
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      yz[o] += __shfl_xor_sync(0xffffffffu, yz[o], off);
      cnt[o] += __shfl_xor_sync(0xffffffffu, cnt[o], off);
    }
    p[2 * k] = c0[o][0];
    p[2 * k + 1] = c0[o][1];
    if (k == 0) {
      p[8] = yz[o];
      p[9] = cnt[o];
    }
  }
  __syncthreads();
  for (int e = tid; e < BQ * NM; e += NT) {
    partial[j * (BQ * NM) + e] = (part[e] + part[BQ * NM + e]) + (part[2 * BQ * NM + e] + part[3 * BQ * NM + e]);
  }
  __syncthreads();  // the block's partial is written
  if (tid == 0) {
    unsigned prev;
    // acq_rel at device scope: releases this block's partial (ordered
    // before it by the barrier) and acquires those of the blocks that
    // counted earlier
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(prev) : "l"(counters + unit) : "memory");
    last = prev == static_cast<unsigned>(S - 1);
    if (last) counters[unit] = 0;  // every block has counted: ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  for (int e = tid; e < BQ * NM; e += NT) {
    double p[S];  // every split's partial in flight at once
#pragma unroll
    for (int jj = 0; jj < S; ++jj) p[jj] = __ldcg(partial + jj * (BQ * NM) + e);  // through the L2, never a stale L1 line
    double s = p[0];
#pragma unroll
    for (int jj = 1; jj < S; ++jj) s += p[jj];
    out[(size_t)row0 * NM + e] = static_cast<float>(s);
  }
}

template <int S, int OCT>
int launch_dense_t(const void* q, const void* t, const void* r2, int batch, int num_tiles,
                   int num_chunks, int bt, void* partial, void* counters, void* out, void* stream) {
  if (bt != DENSE_BT || batch < 1 || batch > 65535 || num_tiles < 1 || num_chunks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static unsigned configured = 0;
  const cudaError_t err = allow_stage_smem(moments_dense_split_kernel<S, OCT>, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(num_tiles, batch, S);
  moments_dense_split_kernel<S, OCT><<<grid, 1024 / OCT, STAGE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(q), static_cast<const float4*>(t), static_cast<const float*>(r2),
      num_tiles, num_chunks, static_cast<double*>(partial), static_cast<unsigned*>(counters),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The instance B5/B6 launch: each tile's quads over 8 blocks, 4 octets of
// queries a warp (256 threads), features 0-7 summed on the tensor cores
constexpr int DENSE_SPLITS = 8, DENSE_OCTETS = 4;
constexpr auto launch_dense = launch_dense_t<DENSE_SPLITS, DENSE_OCTETS>;

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

#ifdef LOCUS_MOMENTS_SWEEP
// Sweep build only: B6 (B5 at batch 1) at any instance, `splits` blocks a
// tile and `octets` octets of queries a warp; the scratch holds `splits`
// partials a tile. tools/torch_moments_ab.py holds each instance to the
// plain version.
extern "C" int locus_moments_dense_sweep(const void* q, const void* t, const void* r2,
                                         int batch, int num_tiles, int num_chunks, int bt,
                                         int splits, int octets, void* partial, void* counters,
                                         void* out, void* stream) {
#define LOCUS_DENSE(S, OCT)                                                                       \
  if (splits == S && octets == OCT) {                                                            \
    return launch_dense_t<S, OCT>(q, t, r2, batch, num_tiles, num_chunks, bt, partial, counters, \
                                  out, stream);                                                  \
  }
  LOCUS_DENSE(4, 4) LOCUS_DENSE(8, 2) LOCUS_DENSE(8, 4) LOCUS_DENSE(16, 4)
#undef LOCUS_DENSE
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

// Kernel B5: one member, every target. `partial` is scratch of
// DENSE_SPLITS x 64 x 10 float64 a tile; `counters` (one a tile) are 0.
extern "C" int locus_moments_dense(const void* q, const void* t, const void* r2,
                                   int num_tiles, int num_chunks, int bt,
                                   void* partial, void* counters, void* out, void* stream) {
  return launch_dense(q, t, r2, 1, num_tiles, num_chunks, bt, partial, counters, out, stream);
}

// Kernel B6: `batch` members, every target, one radius per member; scratch
// and counters as B5's for each member's tiles.
extern "C" int locus_moments_dense_batched(const void* q, const void* t,
                                           const void* r2, int batch,
                                           int num_tiles, int num_chunks,
                                           int bt, void* partial, void* counters,
                                           void* out, void* stream) {
  return launch_dense(q, t, r2, batch, num_tiles, num_chunks, bt, partial, counters, out, stream);
}
