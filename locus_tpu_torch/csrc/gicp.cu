// One GICP trip after its 1-NN (kernel B7 of the port).
//
// Replaces no TPU kernel: on the TPU the JAX package's trip (the body of
// the lax.while_loop in locus_tpu/registration/gicp.py) is fused by XLA.
// On the card its plain version (registration/gicp.py, `trip`) is some 700
// elementwise kernels of 1-2 us each for under 1 MFLOP and 200 KB; this
// kernel is everything of a trip on the disk-covariance path after the
// 1-NN kernel (B2/B3) returns its indices, in one launch:
//   1. the winner's index (clamped), its exact squared distance and the
//      radius gate; the correspondence weight w;
//   2. the target point and normal of each correspondence, the summed disk
//      covariances and their adjugate inverse M;
//   3. each of `inner` Gauss-Newton steps: the 27 per-point terms of
//      J^T M J and J^T M r, their column sums, the trace ridge, the 6x6
//      Cholesky solve (float64), se3_exp and the composition;
//   4. the Gram-Schmidt re-orthonormalisation, the scaled convergence
//      metric, the fitness and correspondence count;
//   5. the per-member carry writes (T, it, delta, fitness, ncorr, j_fin,
//      d2_fin) and the flag the next trip's gate reads.
//
// Bound on the H100: one SM's instruction rate and latency. A trip is ~150
// flops and ~60 bytes a point at 4,096 points, on one SM a member. What
// costs is the chain of dependent steps (sum, solve, update, next sum), so
// the design keeps the whole trip of a member in one block, its sums in
// shared memory and its 6x6 step in one thread, with no launch and no
// device-memory round trip between the steps. The gathers and the disk
// inverses are done once a trip: each point's record (its target point,
// M w and source point: four float4, in four planes of the scratch) is
// written and read back by the inner steps in whole 512-byte warp rows.
//
// Bits: the kernel rounds as the plain version does on the card, so that
// the two agree bit for bit and a batch member as its single call.
// - Elementwise arithmetic in float32, with nothing contracted into an
//   FMA (the build passes -fmad=false for this source): every product
//   and sum rounds as PyTorch's separate kernels round it. Where PyTorch's
//   own kernel contracts (torch.linalg.cross: fma(a, b, -(c * d))), the
//   kernel calls the same __fmaf_rn. A division by a Python number is a
//   multiply by its float reciprocal, as PyTorch's CUDA kernel computes it.
// - The column sums reproduce utils/linalg.py::tree_sum: pairwise halving
//   of the points zero-padded to a power of two P. A block has 1024
//   threads; thread t owns the points t + W k (W = min(P, 1024), k <
//   K = P / W <= 32). Its own points are halved first, in tree_sum's pairs
//   (for four: 0+2 and 1+3, then the two), each left half waiting in a
//   register (the level below the top) or in its word of the column in
//   shared memory (the top level); then one warp a column halves across
//   threads from W down to 32 in shared memory and the last five with
//   __shfl_down_sync. The two correspondence sums ride with the first
//   step's 27 (29 columns, 29 warps). At K >= 8 the lower levels exceed
//   the registers and spill to local memory: capacities above 4096 run,
//   more slowly.
// - The 6x6 step: Cholesky and the two triangular solves in float64 in one
//   thread, rounded to float32 once (utils/linalg.py::chol_solve). Its
//   float64 bits may differ from cuSOLVER's in the last places, which the
//   rounding to float32 almost always hides.
//
// Grid: one block a member (members contiguous); an inactive member (its
// loop stopped) writes nothing but its flag. With one member the block
// writes the gate's flag itself; with more, each writes its member's flag
// and a second launch of one warp (gicp_any_kernel) reduces them.
// `enable` (nullable) is the predicate of the enclosing gates in masked
// mode: where it is false nothing is written, as `graph.assign` would.
// The kernel allocates nothing and reads nothing on the host, so a trip
// can sit in a CUDA graph's conditional body.
//
// Operands, per member: p (n, 3) the query points (the source at the
// carried transform), nn_idx (nn_stride,) int32 the 1-NN winners, src
// (n, 3) the guess-warped source, src_n (n, 3) its rotated normals,
// src_mask (n,) bool; tgt (m, 3), tgt_n (m, 3), tgt_mask (m,) bool. Carry:
// T (4, 4) f32, it int32, delta f32, fitness f32, ncorr int32, j_fin (n,)
// int64, d2_fin (n,) f32. Scratch: rec (4, n) float4.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;   // a block: one member
constexpr int MAX_LEAVES = 32;  // points a thread owns (capacity up to 32768)
constexpr int TERMS = 27;       // the Gauss-Newton step's column sums
constexpr int COLUMNS = TERMS + 2;  // and the correspondences' two

struct Params {
  const float* p;  // the inputs, read-only for the kernel (loaded with __ldg)
  const int* nn_idx;
  const float* src;
  const float* src_n;
  const unsigned char* src_mask;
  const float* tgt;
  const float* tgt_n;
  const unsigned char* tgt_mask;
  float* T;
  int* it;
  float* delta;
  float* fitness;
  int* ncorr;
  int64_t* j_fin;
  float* d2_fin;
  bool* alive;  // per member, with more than one member; else null
  bool* go;
  const bool* enable;
  float4* rec;
  int nn_stride, n, m, width, iterations, inner;
  float r2, k, lm, rot_scale, tf_scale;
};

__host__ __device__ constexpr int log2_of(int k) { return k <= 1 ? 0 : 1 + log2_of(k >> 1); }

// Position `pos` of a thread's K leaves -> the leaf: pos's bits reversed
// (0, 2, 1, 3 for four). tree_sum's first halving pairs leaf k with
// k + K / 2, so in this order each level's pairs are neighbours.
__host__ __device__ constexpr int leaf_at(int pos, int K) {
  int leaf = 0;
  for (int bit = 1; bit < K; bit <<= 1, pos >>= 1) leaf = (leaf << 1) | (pos & 1);
  return leaf;
}

__host__ __device__ constexpr int trailing_ones(int pos) { return pos & 1 ? 1 + trailing_ones(pos >> 1) : 0; }

// A thread's share of C column sums over its K leaves: its word of each
// column in shared memory (columns THREADS apart), where the top level's
// left half waits and the thread's total ends, and registers for the
// lower levels' left halves. Every index is known at compile time once
// the loop over a thread's leaves is unrolled.
template <int C, int K>
struct Sums {
  static constexpr int LEVELS = log2_of(K);   // the halvings inside a thread
  float* col;
  float acc[LEVELS > 1 ? LEVELS - 1 : 1][C];

  // where the left half of `level` waits
  __device__ __forceinline__ float& slot(int c, int level) {
    return level >= 1 && level == LEVELS - 1 ? col[c * THREADS] : acc[level][c];
  }

  // The leaf at position pos: as in a binary counter it is added, as the
  // right half, to the left halves waiting at the levels where pos has a
  // 1, then waits at the next level, or is the thread's total.
  __device__ __forceinline__ void put(int c, float v, int pos) {
    const int ones = trailing_ones(pos);
#pragma unroll
    for (int level = 0; level < LEVELS; ++level) {
      if (level < ones) v = slot(c, level) + v;
    }
    if (ones == LEVELS) {
      col[c * THREADS] = v;
    } else {
      slot(c, ones) = v;
    }
  }
};

// The sums over threads of C <= 32 columns (each thread's total in its
// word of the column), halving from `width` as tree_sum does, warp c on
// column c; out[c] in shared memory. Every thread of the block calls it.
template <int C>
__device__ void reduce(float* sm, int width, float* out) {
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < C) {
    float* col = sm + warp * THREADS;
    for (int s = width >> 1; s >= 32; s >>= 1) {
#pragma unroll 4
      for (int u = lane; u < s; u += 32) col[u] = col[u] + col[u + s];
      __syncwarp();
    }
    float v = lane < width ? col[lane] : 0.0f;
    for (int off = min(width, 32) >> 1; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) out[warp] = v;
  }
  __syncthreads();
}

// se3.rotate_vectors / transform_points of one point by a row-major 4x4.
__device__ __forceinline__ void rotate(const float* T, float x, float y, float z, float* o) {
#pragma unroll
  for (int r = 0; r < 3; ++r) o[r] = (x * T[4 * r] + y * T[4 * r + 1]) + z * T[4 * r + 2];
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return (x != x || x >= lo) ? x : lo; }

__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }

// M = inverse(C_target + R C_source R^T) for two disks (gicp.py:
// _sym3_two_disks, then _inv_sym3), as six components.
__device__ __forceinline__ void disk_inverse(const float* a, const float* b, float k, float* M) {
  const float nk = -k;
  const float A0 = 2.0f - (a[0] * a[0] + b[0] * b[0]) * k;
  const float A1 = (a[0] * a[1] + b[0] * b[1]) * nk;
  const float A2 = (a[0] * a[2] + b[0] * b[2]) * nk;
  const float A3 = 2.0f - (a[1] * a[1] + b[1] * b[1]) * k;
  const float A4 = (a[1] * a[2] + b[1] * b[2]) * nk;
  const float A5 = 2.0f - (a[2] * a[2] + b[2] * b[2]) * k;
  const float ridge = static_cast<float>(1e-6);
  const float pa = A0 + ridge, pb = A1, pc = A2, pd = A3 + ridge, pe = A4, pf = A5 + ridge;
  const float co00 = pd * pf - pe * pe;
  const float co01 = pc * pe - pb * pf;
  const float co02 = pb * pe - pc * pd;
  const float co11 = pa * pf - pc * pc;
  const float co12 = pb * pc - pa * pe;
  const float co22 = pa * pd - pb * pb;
  const float det = (pa * co00 + pb * co01) + pc * co02;
  const float tiny = static_cast<float>(1e-20);
  const float inv = 1.0f / (fabsf(det) < tiny ? tiny : det);
  M[0] = co00 * inv;
  M[1] = co01 * inv;
  M[2] = co02 * inv;
  M[3] = co11 * inv;
  M[4] = co12 * inv;
  M[5] = co22 * inv;
}

// Point i of member b: its winner j (clamped) and gated distance, written
// to the carry, its weight's two sums put, and its record
// for the inner steps: (q, mask), (m00, m01, m02, m11), (m12, m22, s0,
// s1), (s2, 0, 0, 0) with m = M w (gicp.py: the trip's head, its disk
// covariances and _inv_sym3) and s the guess-warped source point.
template <int K>
__device__ __forceinline__ void correspond(const Params& P, int b, int i, const float* Tc, Sums<2, K>& sums,
                                           int pos) {
  const int64_t row = static_cast<int64_t>(b) * P.n + i, first = static_cast<int64_t>(b) * P.m;
  const int raw = __ldg(P.nn_idx + static_cast<int64_t>(b) * P.nn_stride + i);
  const int64_t j = first + (raw < 0 ? 0 : (raw > P.m - 1 ? P.m - 1 : raw));
  float pq[3], q[3], sn[3], tn[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pq[k] = __ldg(P.p + 3 * row + k);
    sn[k] = __ldg(P.src_n + 3 * row + k);
    s[k] = __ldg(P.src + 3 * row + k);
    q[k] = __ldg(P.tgt + 3 * j + k);
    tn[k] = __ldg(P.tgt_n + 3 * j + k);
  }
  const bool valid = __ldg(P.src_mask + row) != 0, target = __ldg(P.tgt_mask + j) != 0;
  const float dx = pq[0] - q[0], dy = pq[1] - q[1], dz = pq[2] - q[2];
  float d2 = (dx * dx + dy * dy) + dz * dz;
  d2 = d2 <= P.r2 ? d2 : static_cast<float>(1e12);
  const float w = (valid && target && d2 <= P.r2) ? 1.0f : 0.0f;
  sums.put(0, w, pos);
  sums.put(1, d2 * w, pos);
  float a[3], M[6];
  rotate(Tc, sn[0], sn[1], sn[2], a);
  disk_inverse(a, tn, P.k, M);
  P.j_fin[row] = j - first;
  P.d2_fin[row] = d2;
  float4* r = P.rec + static_cast<int64_t>(b) * 4 * P.n + i;
  r[0] = make_float4(q[0], q[1], q[2], valid ? 1.0f : 0.0f);
  r[P.n] = make_float4(M[0] * w, M[1] * w, M[2] * w, M[3] * w);
  r[2 * P.n] = make_float4(M[4] * w, M[5] * w, s[0], s[1]);
  r[3 * P.n] = make_float4(s[2], 0.0f, 0.0f, 0.0f);
}

// The 27 terms of point i at the iterate Tn (gicp.py:
// _gauss_newton_step_comps), each put into the thread's sums.
template <int K>
__device__ __forceinline__ void gn_terms(const Params& P, int b, int i, const float* Tn, Sums<TERMS, K>& sums,
                                         int pos) {
  const float4* r = P.rec + static_cast<int64_t>(b) * 4 * P.n + i;
  const float4 r0 = r[0], r1 = r[P.n], r2 = r[2 * P.n], r3 = r[3 * P.n];
  float p[3];
  if (r0.w != 0.0f) {
    rotate(Tn, r2.z, r2.w, r3.x, p);
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = p[k] + Tn[4 * k + 3];
  } else {
    p[0] = r0.x;  // zero-residual pads
    p[1] = r0.y;
    p[2] = r0.z;
  }
  const float px = p[0], py = p[1], pz = p[2];
  const float rx = px - r0.x, ry = py - r0.y, rz = pz - r0.z;
  const float m00 = r1.x, m01 = r1.y, m02 = r1.z, m11 = r1.w, m12 = r2.x, m22 = r2.y;
  sums.put(0, m00, pos);
  sums.put(1, m01, pos);
  sums.put(2, m02, pos);
  sums.put(3, m11, pos);
  sums.put(4, m12, pos);
  sums.put(5, m22, pos);
  // B = M @ skew(p)
  const float b00 = m01 * pz - m02 * py;
  const float b10 = m11 * pz - m12 * py;
  const float b20 = m12 * pz - m22 * py;
  const float b01 = -m00 * pz + m02 * px;
  const float b11 = -m01 * pz + m12 * px;
  const float b21 = -m02 * pz + m22 * px;
  const float b02 = m00 * py - m01 * px;
  const float b12 = m01 * py - m11 * px;
  const float b22 = m02 * py - m12 * px;
  sums.put(6, b00, pos);
  sums.put(7, b01, pos);
  sums.put(8, b02, pos);
  sums.put(9, b10, pos);
  sums.put(10, b11, pos);
  sums.put(11, b12, pos);
  sums.put(12, b20, pos);
  sums.put(13, b21, pos);
  sums.put(14, b22, pos);
  // C = -skew(p) @ B
  sums.put(15, -(-pz * b10 + py * b20), pos);
  sums.put(16, -(-pz * b11 + py * b21), pos);
  sums.put(17, -(-pz * b12 + py * b22), pos);
  sums.put(18, -(pz * b01 - px * b21), pos);
  sums.put(19, -(pz * b02 - px * b22), pos);
  sums.put(20, -(-py * b02 + px * b12), pos);
  const float mr0 = (m00 * rx + m01 * ry) + m02 * rz;
  const float mr1 = (m01 * rx + m11 * ry) + m12 * rz;
  const float mr2 = (m02 * rx + m12 * ry) + m22 * rz;
  sums.put(21, mr0, pos);
  sums.put(22, mr1, pos);
  sums.put(23, mr2, pos);
  sums.put(24, -pz * mr1 + py * mr2, pos);
  sums.put(25, pz * mr0 - px * mr2, pos);
  sums.put(26, -py * mr0 + px * mr1, pos);
}

// H dx = -g from the 27 sums (gicp.py: the end of
// _gauss_newton_step_comps; utils/linalg.py::chol_solve in float64).
__device__ void gn_solve(const float* s, float lm, float* dx) {
  float H[6][6];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      H[r][3 + c] = -s[6 + 3 * r + c];
      H[3 + c][r] = -s[6 + 3 * r + c];
    }
  }
  const int tt[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    H[q / 3][q % 3] = s[tt[q]];
    H[3 + q / 3][3 + q % 3] = s[15 + tt[q]];
  }
  float trace = H[0][0];
#pragma unroll
  for (int d = 1; d < 6; ++d) trace = trace + H[d][d];
  const float ridge = (clamp_min(trace * (1.0f / 6.0f), 1.0f) * lm) * static_cast<float>(1e-6);
  double L[6][6], y[6], x[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = 0; c < 6; ++c) L[r][c] = static_cast<double>(H[r][c] + (r == c ? 1.0f : 0.0f) * ridge);
  }
  // Cholesky, lower, in place: column by column
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    double d = L[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) d = d - L[j][q] * L[j][q];
    d = sqrt(d);
    L[j][j] = d;
#pragma unroll
    for (int r = j + 1; r < 6; ++r) {
      double v = L[r][j];
#pragma unroll
      for (int q = 0; q < j; ++q) v = v - L[r][q] * L[j][q];
      L[r][j] = v / d;
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    double v = static_cast<double>(s[21 + r]);
#pragma unroll
    for (int q = 0; q < r; ++q) v = v - L[r][q] * y[q];
    y[r] = v / L[r][r];
  }
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    double v = y[r];
#pragma unroll
    for (int q = r + 1; q < 6; ++q) v = v - L[q][r] * x[q];
    x[r] = v / L[r][r];
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) dx[r] = -static_cast<float>(x[r]);
}

// A 3x3 product written out (se3.matmul): rows of A, columns of B.
__device__ __forceinline__ void mat3(const float A[3][3], const float B[3][3], float O[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) O[r][c] = (A[r][0] * B[0][c] + A[r][1] * B[1][c]) + A[r][2] * B[2][c];
  }
}

// se3.se3_exp of the twist [v, w] as a row-major 4x4.
__device__ void se3_exp(const float* xi, float* E) {
  const float eps = static_cast<float>(1e-9);
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float theta = sqrtf(theta2 + eps);
  const bool small = theta2 < static_cast<float>(1e-4);
  const float a = small ? 1.0f - theta2 * (1.0f / 6.0f) : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 * (1.0f / 24.0f) : (1.0f - cosf(theta)) / (theta2 + eps);
  const float c = small ? static_cast<float>(1.0 / 6.0) - theta2 * (1.0f / 120.0f) : (1.0f - a) / (theta2 + eps);
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float W2[3][3];
  mat3(W, W, W2);
  float V[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float eye = r == q ? 1.0f : 0.0f;
      E[4 * r + q] = (eye + a * W[r][q]) + b * W2[r][q];
      V[r][q] = (eye + b * W[r][q]) + c * W2[r][q];
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) E[4 * r + 3] = (V[r][0] * xi[0] + V[r][1] * xi[1]) + V[r][2] * xi[2];
  E[12] = E[13] = E[14] = 0.0f;
  E[15] = 1.0f;
}

// O = A @ B for row-major 4x4s (se3.compose), O distinct from both.
__device__ __forceinline__ void mat4(const float* A, const float* B, float* O) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      O[4 * r + c] = ((A[4 * r] * B[c] + A[4 * r + 1] * B[4 + c]) + A[4 * r + 2] * B[8 + c]) + A[4 * r + 3] * B[12 + c];
    }
  }
}

// make_transform(orthonormalize(rotation(T)), translation(T)) (se3.py).
__device__ void orthonormalize(const float* T, float* O) {
  const float eps = static_cast<float>(1e-9);
  float x[3] = {T[0], T[4], T[8]}, y[3] = {T[1], T[5], T[9]}, z[3];
  const float nx = clamp_min(sqrtf((x[0] * x[0] + x[1] * x[1]) + x[2] * x[2]), eps);
#pragma unroll
  for (int r = 0; r < 3; ++r) x[r] = x[r] / nx;
  const float d = (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) y[r] = y[r] - d * x[r];
  const float ny = clamp_min(sqrtf((y[0] * y[0] + y[1] * y[1]) + y[2] * y[2]), eps);
#pragma unroll
  for (int r = 0; r < 3; ++r) y[r] = y[r] / ny;
  // torch.linalg.cross on the card: fma(a, b, -(c * d))
  z[0] = __fmaf_rn(x[1], y[2], -(x[2] * y[1]));
  z[1] = __fmaf_rn(x[2], y[0], -(x[0] * y[2]));
  z[2] = __fmaf_rn(x[0], y[1], -(x[1] * y[0]));
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    O[4 * r] = x[r];
    O[4 * r + 1] = y[r];
    O[4 * r + 2] = z[r];
    O[4 * r + 3] = T[4 * r + 3];
  }
  O[12] = O[13] = O[14] = 0.0f;
  O[15] = 1.0f;
}

// K: the points a thread owns (a power of two up to MAX_LEAVES), so that
// each leaf's way into the sums is known at compile time.
template <int K>
__global__ void __launch_bounds__(THREADS, 1) gicp_trip_kernel(Params P) {
  extern __shared__ float sm[];   // the sums' columns: [COLUMNS][THREADS] floats
  __shared__ float Tc[16], Tn[16], E[16], sums[COLUMNS], fit[2];
  const int b = blockIdx.x, t = threadIdx.x;
  if (P.enable != nullptr && !*P.enable) return;
  bool* flag = P.alive != nullptr ? P.alive + b : P.go;
  if (!(P.it[b] < P.iterations && P.delta[b] >= 1.0f)) {  // this member has stopped
    if (t == 0) *flag = false;
    return;
  }
  if (t < 16) {
    Tc[t] = P.T[16 * b + t];
    Tn[t] = Tc[t];
  }
  __syncthreads();
  const bool owner = t < P.width;

  // the correspondences: j, d2 (written to the carry), their weights'
  // sums, each point's record (the loops over a thread's leaves unroll, so
  // each leaf's way into the sums is a constant)
  if (owner) {
    Sums<2, K> fits{sm + TERMS * THREADS + t};
#pragma unroll
    for (int pos = 0; pos < K; ++pos) {
      const int i = t + P.width * leaf_at(pos, K);
      if (i < P.n) {
        correspond(P, b, i, Tc, fits, pos);
      } else {
        fits.put(0, 0.0f, pos);
        fits.put(1, 0.0f, pos);
      }
    }
  }

  for (int step = 0; step < P.inner; ++step) {
    if (owner) {
      Sums<TERMS, K> terms{sm + t};
#pragma unroll
      for (int pos = 0; pos < K; ++pos) {
        const int i = t + P.width * leaf_at(pos, K);
        if (i < P.n) {
          gn_terms(P, b, i, Tn, terms, pos);
        } else {
#pragma unroll
          for (int c = 0; c < TERMS; ++c) terms.put(c, 0.0f, pos);
        }
      }
    }
    if (step == 0) {
      reduce<COLUMNS>(sm, P.width, sums);
    } else {
      reduce<TERMS>(sm, P.width, sums);
    }
    if (t == 0) {
      if (step == 0) {
        fit[0] = sums[TERMS];
        fit[1] = sums[TERMS + 1];
      }
      float dx[6], O[16];
      gn_solve(sums, P.lm, dx);
      se3_exp(dx, E);
      mat4(E, Tn, O);
#pragma unroll
      for (int q = 0; q < 16; ++q) Tn[q] = O[q];
    }
    __syncthreads();
  }

  if (P.inner == 0) reduce<COLUMNS>(sm, P.width, sums);   // its first 27 columns unused
  if (t != 0) return;
  if (P.inner == 0) {
    fit[0] = sums[TERMS];
    fit[1] = sums[TERMS + 1];
  }
  float Tf[16];
  orthonormalize(Tn, Tf);
  float nd = -INFINITY;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float scale = (q < 12 && (q & 3) < 3) ? P.rot_scale : P.tf_scale;
    nd = max_nan(nd, fabsf(Tc[q] - Tf[q]) * scale);
  }
  const int it = P.it[b] + 1;
  const float wsum = fit[0];
  P.fitness[b] = fit[1] / clamp_min(wsum, 1.0f);
  P.ncorr[b] = static_cast<int>(wsum);
#pragma unroll
  for (int q = 0; q < 16; ++q) P.T[16 * b + q] = Tf[q];
  P.delta[b] = nd;
  P.it[b] = it;
  *flag = it < P.iterations && nd >= 1.0f;
}

// The gate's flag of a batch: any member still iterating.
__global__ void gicp_any_kernel(const bool* alive, int batch, bool* go, const bool* enable) {
  if (enable != nullptr && !*enable) return;
  bool any = false;
  for (int b = threadIdx.x; b < batch; b += 32) any = any || alive[b];
  any = __any_sync(0xffffffffu, any);
  if (threadIdx.x == 0) *go = any;
}

}  // namespace

// Kernel B7: one trip of `batch` members (one block each). alive is
// scratch of `batch` bools where batch > 1 (ignored for one member); rec
// scratch of batch * n * 16 floats.
extern "C" int locus_gicp_trip(const void* p, const void* nn_idx, int nn_stride, const void* src,
                               const void* src_n, const void* src_mask, const void* tgt, const void* tgt_n,
                               const void* tgt_mask, int batch, int n, int m, void* T, void* it, void* delta,
                               void* fitness, void* ncorr, void* j_fin, void* d2_fin, void* alive, void* go,
                               const void* enable, void* rec, int iterations, int inner, float r2, float k,
                               float lm, float rot_scale, float tf_scale, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || n > THREADS * MAX_LEAVES || m < 1 || nn_stride < n || inner < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB of dynamic shared memory once a device, before any capture
  static unsigned long long configured = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(configured >> device & 1ull)) {
    const int most = COLUMNS * THREADS * static_cast<int>(sizeof(float));
    void (*const instances[])(Params) = {gicp_trip_kernel<1>, gicp_trip_kernel<2>, gicp_trip_kernel<4>,
                                         gicp_trip_kernel<8>, gicp_trip_kernel<16>, gicp_trip_kernel<32>};
    for (auto* kernel : instances) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    configured |= 1ull << device;
  }
  Params P;
  P.p = static_cast<const float*>(p);
  P.nn_idx = static_cast<const int*>(nn_idx);
  P.src = static_cast<const float*>(src);
  P.src_n = static_cast<const float*>(src_n);
  P.src_mask = static_cast<const unsigned char*>(src_mask);
  P.tgt = static_cast<const float*>(tgt);
  P.tgt_n = static_cast<const float*>(tgt_n);
  P.tgt_mask = static_cast<const unsigned char*>(tgt_mask);
  P.T = static_cast<float*>(T);
  P.it = static_cast<int*>(it);
  P.delta = static_cast<float*>(delta);
  P.fitness = static_cast<float*>(fitness);
  P.ncorr = static_cast<int*>(ncorr);
  P.j_fin = static_cast<int64_t*>(j_fin);
  P.d2_fin = static_cast<float*>(d2_fin);
  P.alive = batch > 1 ? static_cast<bool*>(alive) : nullptr;
  P.go = static_cast<bool*>(go);
  P.enable = static_cast<const bool*>(enable);
  P.rec = static_cast<float4*>(rec);
  P.nn_stride = nn_stride;
  P.n = n;
  P.m = m;
  int size = 1;  // the sums' power of two
  while (size < n) size <<= 1;
  P.width = size < THREADS ? size : THREADS;
  const int leaves = size / P.width;
  P.iterations = iterations;
  P.inner = inner;
  P.r2 = r2;
  P.k = k;
  P.lm = lm;
  P.rot_scale = rot_scale;
  P.tf_scale = tf_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = COLUMNS * THREADS * sizeof(float);
  switch (leaves) {
    case 1: gicp_trip_kernel<1><<<batch, THREADS, bytes, st>>>(P); break;
    case 2: gicp_trip_kernel<2><<<batch, THREADS, bytes, st>>>(P); break;
    case 4: gicp_trip_kernel<4><<<batch, THREADS, bytes, st>>>(P); break;
    case 8: gicp_trip_kernel<8><<<batch, THREADS, bytes, st>>>(P); break;
    case 16: gicp_trip_kernel<16><<<batch, THREADS, bytes, st>>>(P); break;
    default: gicp_trip_kernel<32><<<batch, THREADS, bytes, st>>>(P); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || batch == 1) return static_cast<int>(err);
  gicp_any_kernel<<<1, 32, 0, st>>>(P.alive, batch, P.go, P.enable);
  return static_cast<int>(cudaGetLastError());
}
