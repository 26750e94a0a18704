// The float64 6x6 Jacobi eigendecomposition of the covariance's Ap, in one
// launch (kernel B8 of the port).
//
// Replaces no TPU kernel: on the TPU the JAX package's jacobi_eigh
// (locus_tpu/utils/linalg.py) is fused by XLA. On the card its plain
// version (locus_tpu_torch/utils/linalg.py::jacobi_eigh) is ~1,245 graph
// nodes a call: 6 sweeps of 5 circle-method rounds, each round ~41 PyTorch
// kernels (the pivots' gathers, the rotation's elementwise ops, G built by
// index-puts, three cuBLAS double GEMMs for G^T M G and V G), then the
// diagonal, the argsort and the gathers. Each node does almost no work.
//
// Bound on the H100: latency. A call is 36 doubles and 30 dependent rounds,
// each a chain of two square roots and three divisions (the rotation) and
// two dependent products. The design keeps a member in one warp's
// registers, with every (p, q) of a round a compile-time constant: lane r
// (r < 6) holds row r of M and row r of V. A round reads its three pivots
// by __shfl_sync, every lane computes the three rotations itself (no
// broadcast), the row mix of G^T M takes the partner row by __shfl_sync,
// and the column mixes of M G and V G stay in the lane's registers. No
// shared memory, no atomics; members are independent warps.
//
// Bits: the kernel rounds as the plain version does on the card for a
// batch of two or more, so that the two agree bit for bit there, and a
// batch member as its single call.
// - The rotation in float64, each operation rounded on its own as
//   PyTorch's separate kernels round it (the build passes -fmad=false for
//   this source): tau = (aqq - app) / (2 apq'), apq' = 1e-30 where |apq| <
//   1e-30; t = sign(tau) / (|tau| + sqrt(1 + tau tau)) with sign(0) = 0,
//   so equal diagonals give t = 0; t = 0 where |apq| < 1e-12 (|app| +
//   |aqq| + 1e-30); c = 1 / sqrt(1 + t t), s = t c.
// - The products: cuBLAS's batched double GEMM at 6x6x6 takes each entry
//   as an FMA chain over k = 0..5 from +0 (measured on the H100, every
//   entry of G^T M, (G^T M) G and V G). G has two non-zero entries a
//   column, at k = p < q, so an entry is fma(x_q, g_q, fma(x_p, g_p, 0)):
//   the zero terms add nothing to a finite sum. (cuBLAS takes a batch of
//   one, as the single step's (6, 6) Ap, through another kernel, which
//   sums k = 0..2 and 3..5 apart and adds the halves; its bits differ in
//   the last places, and this kernel does not follow it, so that a single
//   call and a batch member agree.)
// - A non-finite entry of Ap makes every output NaN: in the plain version
//   the dense products' 0 x inf spread it over M within one round and
//   over V within two.
// - The eigenvalues (the final diagonal) in ascending order, stable, NaN
//   last, as torch.argsort(stable=True) orders them; the eigenvectors'
//   columns in the same order.
//
// Grid: WARPS members a block of 32 x WARPS threads; lanes 6-31 of a warp
// and warps past the last member return at once. Operands, per member
// (contiguous): ap (6, 6) float64 in; w (6,) and v (6, 6) float64 out.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N = 6;
constexpr int SWEEPS = 6;
constexpr int WARPS = 4;          // members a block
constexpr unsigned ROWS = 0x3fu;  // lanes 0-5: a row each

struct Rotation {
  double c, s;
};

// c and s of one pair, from its pivots, as utils/linalg.py::jacobi_eigh
// computes them (each operation rounded on its own)
__device__ __forceinline__ Rotation rotation(double app, double aqq, double apq) {
  const double tau = (aqq - app) / (2.0 * (fabs(apq) < 1e-30 ? 1e-30 : apq));
  const double sign = static_cast<double>(static_cast<int>(0.0 < tau) - static_cast<int>(tau < 0.0));
  double t = sign / (fabs(tau) + sqrt(1.0 + tau * tau));
  if (fabs(apq) < 1e-12 * (fabs(app) + fabs(aqq) + 1e-30)) t = 0.0;
  const double c = 1.0 / sqrt(1.0 + t * t);
  return {c, t * c};
}

// the two-term FMA chain of one entry of a product by G (k = p, then q)
__device__ __forceinline__ double mix(double xp, double gp, double xq, double gq) {
  return fma(xq, gq, fma(xp, gp, 0.0));
}

// columns p and q of a row times G: (x_p, x_q) <- (x_p c - x_q s, x_p s + x_q c)
template <int P, int Q>
__device__ __forceinline__ void mix_columns(double (&x)[N], Rotation r) {
  const double xp = x[P], xq = x[Q];
  x[P] = mix(xp, r.c, xq, -r.s);
  x[Q] = mix(xp, r.s, xq, r.c);
}

// One round: the three disjoint rotations (P0, Q0), (P1, Q1), (P2, Q2)
// applied as one G: M <- G^T M G, and V <- V G on u, the lane's row of V.
template <int P0, int Q0, int P1, int Q1, int P2, int Q2>
__device__ __forceinline__ void jacobi_round(double (&m)[N], double (&u)[N], int lane) {
  const Rotation r0 = rotation(__shfl_sync(ROWS, m[P0], P0), __shfl_sync(ROWS, m[Q0], Q0),
                               __shfl_sync(ROWS, m[Q0], P0));
  const Rotation r1 = rotation(__shfl_sync(ROWS, m[P1], P1), __shfl_sync(ROWS, m[Q1], Q1),
                               __shfl_sync(ROWS, m[Q1], P1));
  const Rotation r2 = rotation(__shfl_sync(ROWS, m[P2], P2), __shfl_sync(ROWS, m[Q2], Q2),
                               __shfl_sync(ROWS, m[Q2], P2));
  // this lane's pair: row p of G^T M is c m_p - s m_q, row q is s m_p + c m_q
  const bool in0 = lane == P0 || lane == Q0, in1 = lane == P1 || lane == Q1;
  const Rotation r = in0 ? r0 : in1 ? r1 : r2;
  const int p = in0 ? P0 : in1 ? P1 : P2, q = in0 ? Q0 : in1 ? Q1 : Q2;
  const bool low = lane == p;
  const int partner = low ? q : p;
  const double gp = low ? r.c : r.s, gq = low ? -r.s : r.c;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double other = __shfl_sync(ROWS, m[j], partner);
    m[j] = low ? mix(m[j], gp, other, gq) : mix(other, gp, m[j], gq);
  }
  mix_columns<P0, Q0>(m, r0);
  mix_columns<P1, Q1>(m, r1);
  mix_columns<P2, Q2>(m, r2);
  mix_columns<P0, Q0>(u, r0);
  mix_columns<P1, Q1>(u, r1);
  mix_columns<P2, Q2>(u, r2);
}

// a before b in torch.sort's ascending order (NaN after every number)
__device__ __forceinline__ bool less(double a, double b) { return a < b || (isnan(b) && !isnan(a)); }

__global__ void __launch_bounds__(32 * WARPS) eigh6_kernel(const double* __restrict__ ap, double* __restrict__ w,
                                                           double* __restrict__ v, int batch) {
  const int lane = threadIdx.x & 31;
  const int member = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (member >= batch || lane >= N) return;
  const double* a = ap + static_cast<int64_t>(member) * N * N;

  // M = 0.5 (S + S^T), S = 0.5 (Ap + Ap^T): the wrapper's and jacobi_eigh's
  double m[N], u[N];  // the lane's rows of M and V
  bool finite = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const double s = 0.5 * (a[lane * N + j] + a[j * N + lane]);
    m[j] = 0.5 * (s + s);
    u[j] = lane == j ? 1.0 : 0.0;
    finite = finite && isfinite(m[j]);
  }
  double* wm = w + static_cast<int64_t>(member) * N;
  double* vm = v + static_cast<int64_t>(member) * N * N;
  if (__any_sync(ROWS, !finite)) {
    const double nan = __longlong_as_double(0x7ff8000000000000ll);
    wm[lane] = nan;
#pragma unroll
    for (int j = 0; j < N; ++j) vm[lane * N + j] = nan;
    return;
  }

  // utils/linalg.py::_round_robin_rounds(6)
#pragma unroll 1
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
    jacobi_round<0, 5, 1, 4, 2, 3>(m, u, lane);
    jacobi_round<0, 4, 3, 5, 1, 2>(m, u, lane);
    jacobi_round<0, 3, 2, 4, 1, 5>(m, u, lane);
    jacobi_round<0, 2, 1, 3, 4, 5>(m, u, lane);
    jacobi_round<0, 1, 2, 5, 3, 4>(m, u, lane);
  }

  // the diagonal, every lane all six, and each one's place in the order
  double own = m[0];
#pragma unroll
  for (int j = 1; j < N; ++j) own = lane == j ? m[j] : own;
  double d[N];
#pragma unroll
  for (int j = 0; j < N; ++j) d[j] = __shfl_sync(ROWS, own, j);
  int rank[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      r += less(d[j], d[k]) || (j < k && !less(d[k], d[j]));
    }
    rank[k] = r;
  }
  int place = rank[0];
#pragma unroll
  for (int j = 1; j < N; ++j) place = lane == j ? rank[j] : place;
  wm[place] = own;
#pragma unroll
  for (int j = 0; j < N; ++j) vm[lane * N + rank[j]] = u[j];
}

}  // namespace

extern "C" int locus_eigh6(const void* ap, void* w, void* v, int batch, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + WARPS - 1) / WARPS;
  eigh6_kernel<<<blocks, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(ap), static_cast<double*>(w), static_cast<double*>(v), batch);
  return static_cast<int>(cudaGetLastError());
}
