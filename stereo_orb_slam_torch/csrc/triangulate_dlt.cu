// Batched DLT triangulation: the null vector of each 4x4 system by a
// one-sided Jacobi SVD in float64, four lanes per correspondence.
//
// A hand kernel with no Pallas counterpart. It computes the function of the
// JAX package's geometry/camera.py::triangulate_dlt (cv::triangulatePoints,
// ref src/camera_model.cpp:123-152): per correspondence the system
//   A = [u1 P1^3 - P1^1; v1 P1^3 - P1^2; u2 P2^3 - P2^1; v2 P2^3 - P2^2]
// (P^i the i-th row of a [3, 4] projection), the right singular vector X of
// A's smallest singular value, and X[:3] / X[3] with |X[3]| < 1e-12 taken
// as 1e-12. The JAX package takes the vector from jnp.linalg.svd (its
// geometry/camera.py:185), XLA's own solver inside its jitted program.
// The port's plain version takes it from torch.linalg.svd, which on the
// card is cuSOLVER's batched Jacobi SVD: it syncs the host twice per call,
// and a sync is illegal inside a captured CUDA graph, so the general rig's
// front end could not be captured. This kernel computes the same vector
// with no host sync.
//
// Method: A is built in float64 from the float32 inputs and scaled by a
// power of two (exact: every later value scales exactly, so the result is
// that of A itself) to |A|_F^2 in [0.5, 4). One-sided (Hestenes) Jacobi
// rotates pairs of A's columns until they are mutually orthogonal,
// accumulating the rotations in V (A V = U S): then column j of A has norm
// sigma_j and column j of V is its right singular vector. A pair is rotated
// when |a_p . a_q| > 1e-15 |a_p| |a_q| and |a_p . a_q| > 1e-30 |A|_F^2
// (columns at rounding level of A are left alone, so rank-deficient systems
// stop too); a point stops after a sweep with no rotation, or after 16
// sweeps. V's column of the smallest column norm of A is the null vector
// (the first on a tie), dehomogenised in float64 and rounded once to
// float32. Working on A itself, not on A^T A, keeps A's condition number
// instead of squaring it, and float64 makes the result the float64 DLT's
// rounded once, whatever the rotation order; its sign is arbitrary and
// cancels in the division. Degenerate systems (all-zero or duplicated rows,
// as invalid slots hold) give finite output: V stays orthonormal, and the
// |w| guard bounds the division.
//
// What bounds it on an H100: at the front end's N = 1024 neither bytes nor
// operations. It reads 16 bytes and writes 12 per point (28 KB) and does
// about 2,000 float64 operations per point (2 MFLOP, 0.06 us at half the
// float32 rate). The time is the launch plus one point's chain of
// dependent float64 steps, the pair tests and rotations of its sweeps, with
// one warp on each SM sub-partition: latency, not throughput. The first
// design (one thread a point, the cyclic order (0,1) (0,2) (0,3) (1,2)
// (1,3) (2,3)) chained about 30 rotation tests a point, each behind two
// divisions, a sqrt and an rsqrt in float64 (a sequence of instructions
// each on this card), on 16 of the 132 SMs at N = 1024. Where the points
// fill the card (tens of thousands, the loop edges at a large E_pad) the
// float64 pipe bounds it instead, and there this design does about twice
// the first one's instructions a point: both lanes of a pair compute its
// angle, and a warp holds 8 points, not 32.
//
// This design:
// - Four lanes a point: lane g holds column g of A and of V (8 doubles in
//   registers), blocks of 128 threads (32 points) along x and problems
//   along y, so N = 1024 spreads over 32 SMs and no index needs a division.
// - Round-robin order: a sweep is three rounds, {(0,1),(2,3)},
//   {(0,2),(1,3)}, {(0,3),(1,2)}; in round m lane g pairs with lane g ^ m,
//   whose column (and its squared norm) comes by __shfl_xor_sync, and the
//   two rotations of a round run at once on disjoint columns (so they
//   commute). A sweep's chain is 3 steps, not 6. Both lanes of a pair
//   compute the dot product (a 4-row sum as two products summed pairwise),
//   c and s in the same order, so they agree exactly; the lower index
//   plays P.
// - No division and no sqrt in a rotation: with d = beta - alpha and
//   num = sign(d) 2 gamma, t = tan(theta) = num / den with den = |d| +
//   sqrt(d^2 + num^2), so c = den / sqrt(den^2 + num^2) and s = num /
//   sqrt(den^2 + num^2). Each root starts from the hardware's seed
//   (MUFU.RSQ64H, about 2^-22), in place of CUDA's rsqrt and sqrt with
//   their range checks; the first design took two divisions, a sqrt and an
//   rsqrt. den takes one Newton step (1.5 x 2^-44 low at most): its error
//   only tilts the angle, which the next sweep absorbs. The common factor
//   1 / sqrt(den^2 + num^2) of c and s is corrected to second order in the
//   seed's error (`refine`, folded into c and s so that the chain is no
//   longer than with a Newton step), which keeps every rotation orthogonal
//   to float64 rounding. With the seed alone V drifts from orthogonal by
//   the seed's error at every rotation, which took the smoke's far points
//   past its float64 bound; after one Newton step c^2 + s^2 would still
//   fall short of 1 by up to 1.7e-13 a rotation, one-signed. The scaling
//   above keeps den^2 + num^2 inside float64's range.
// - Straight-line rounds: a pair that does not rotate takes c = 1, s = 0.
//   A warp's 8 points sweep together until all are done (the loop's
//   condition is a warp vote), so no lane diverges; a done point rotates
//   nothing more, and its counts stop.
// - The smallest column norm is picked by a shuffle reduction (the first
//   index on a tie), and lanes 0-2 each write one coordinate.
//
// Layout: `batch` problems of n points. Point k of problem b reads
// uv1[b * s1b + k * s1n + {0, 1}] and likewise uv2 (strides in floats, so
// the [E, N, 4] banks' column slices are read in place), projections
// p1/p2[b * 12 ...] when p_per_batch is set (a stacked rig) and p1/p2[0 ...]
// otherwise, and writes out[(b * n + k) * 3 ...]. With `work` non-null,
// work[(b * n + k) * 2 ...] gets the point's sweeps and rotations (for the
// operation count of the roofline bound).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;   // threads a block: 32 points of 4 lanes
constexpr int kPoints = kBlock / 4;
constexpr int kMaxGridY = 65535;
constexpr int kMaxSweeps = 16;
constexpr double kRelTol = 1e-15;
constexpr double kAbsTol = 1e-30;
constexpr unsigned kWarp = 0xffffffffu;

// x . y over a column's 4 rows, as two products summed pairwise: the same
// value whichever lane of a pair computes it (products and FMAs commute in
// their factors).
__device__ __forceinline__ double dot4(const double (&x)[4], const double (&y)[4]) {
  return fma(x[1], y[1], x[0] * y[0]) + fma(x[3], y[3], x[2] * y[2]);
}

// MUFU.RSQ64H alone: 1/sqrt(x) from x's upper word, to about 2^-22 (x > 0;
// +inf for x = 0). Each use below takes one Newton step after it.
__device__ __forceinline__ double rsqrt_seed(double x) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  return y;
}

// x (1 + e / 2 + 3 e^2 / 8) + add: x, a multiple of the rsqrt seed q of t
// that is off the true root by the seed's factor 1 + delta, corrected to
// second order. With e = 1 - t q^2 = 1 - (1 + delta)^2 the true value is
// x (1 - e)^(-1/2), so this leaves 2.5 delta^3 relative, below float64
// rounding for |delta| up to about 2^-18; one Newton step, x (1 + e / 2),
// leaves 1.5 delta^2, always low.
__device__ __forceinline__ double refine(double x, double e, double add) {
  return fma(x * e, fma(0.375, e, 0.5), add);
}

// Round M of a sweep: lane g pairs with lane g ^ M, the lower plays P.
// Rotates the lane's column of a and of v when its pair passes the test
// (and its point is active); returns whether it did. Straight-line code:
// a pair that does not rotate takes c = 1, s = 0 and keeps its columns.
template <int M>
__device__ __forceinline__ bool jacobi_round(double (&a)[4], double (&v)[4], int g, bool active,
                                             double abs_tol) {
  const double own = dot4(a, a);
  double pa[4], pv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) pa[r] = __shfl_xor_sync(kWarp, a[r], M);
  const double other = __shfl_xor_sync(kWarp, own, M);
#pragma unroll
  for (int r = 0; r < 4; ++r) pv[r] = __shfl_xor_sync(kWarp, v[r], M);
  const double gamma = dot4(a, pa);
  const bool low = g < (g ^ M);
  const double alpha = low ? own : other, beta = low ? other : own;
  const double d = beta - alpha, g2 = gamma * gamma;
  const bool rotate = active & (g2 > kRelTol * kRelTol * alpha * beta) & (fabs(gamma) > abs_tol);
  // den = |d| + sqrt(d^2 + 4 gamma^2), the seed's sqrt after one Newton step.
  const double root2 = fma(g2, 4.0, d * d);
  const double y = rsqrt_seed(root2), h = root2 * y;
  const double den = fma(0.5 * h, fma(-h, y, 1.0), h + fabs(d));
  // c, s = (den, num) / sqrt(den^2 + num^2): the seed q of the common
  // factor, corrected to second order in c and s themselves.
  const double z = fma(den, den, 4.0 * g2);
  const double q = rsqrt_seed(z);
  const double num = gamma * (d < 0.0 ? -2.0 : 2.0);
  const double e = fma(-z * q, q, 1.0);
  const double dq = den * q, nq = (low ? -num : num) * q;
  const double c = rotate ? refine(dq, e, dq) : 1.0, s = rotate ? refine(nq, e, nq) : 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r] = fma(s, pa[r], c * a[r]);
    v[r] = fma(s, pv[r], c * v[r]);
  }
  return rotate;
}

// Point k of problem b in blocks of kPoints points along x, problems along
// y (and z past kMaxGridY): no division in the index.
__global__ void __launch_bounds__(kBlock)
triangulate_dlt_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                       int p_per_batch, const float* __restrict__ uv1, long long s1b,
                       long long s1n, const float* __restrict__ uv2, long long s2b,
                       long long s2n, int batch, int n, float* __restrict__ out,
                       int* __restrict__ work) {
  const int lane = threadIdx.x & 31, g = lane & 3;
  const long long b = static_cast<long long>(blockIdx.z) * kMaxGridY + blockIdx.y;
  const int k = blockIdx.x * kPoints + (threadIdx.x >> 2);
  const bool in_range = k < n && b < batch;
  // Lanes past the last point take part in the shuffles with A = 0.
  double a[4] = {0.0, 0.0, 0.0, 0.0}, v[4];
  if (in_range) {
    const float* P1 = p1 + (p_per_batch ? b * 12 : 0);
    const float* P2 = p2 + (p_per_batch ? b * 12 : 0);
    const float* x1 = uv1 + b * s1b + k * s1n;
    const float* x2 = uv2 + b * s2b + k * s2n;
    const double p13 = P1[8 + g], p23 = P2[8 + g];
    a[0] = static_cast<double>(x1[0]) * p13 - static_cast<double>(P1[g]);
    a[1] = static_cast<double>(x1[1]) * p13 - static_cast<double>(P1[4 + g]);
    a[2] = static_cast<double>(x2[0]) * p23 - static_cast<double>(P2[g]);
    a[3] = static_cast<double>(x2[1]) * p23 - static_cast<double>(P2[4 + g]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = r == g ? 1.0 : 0.0;

  // |A|_F^2, the same on the point's four lanes, and A scaled by
  // 2^-floor(e / 2), e = frexp's exponent of |A|_F^2 (from the bits: the
  // biased exponent less 1022), to |A|_F^2 in [0.5, 4).
  double frob = dot4(a, a);
  frob += __shfl_xor_sync(kWarp, frob, 1);
  frob += __shfl_xor_sync(kWarp, frob, 2);
  const int e = ((__double2hiint(frob) >> 20) & 0x7ff) - 1022;
  const double scale = __hiloint2double((1023 - (e >> 1)) << 20, 0);
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] *= scale;
  const double abs_tol = kAbsTol * (frob * scale * scale);

  bool active = in_range;
  int sweeps = 0, rotations = 0;   // rotations: the pairs this lane played P in
  for (int sweep = 0; sweep < kMaxSweeps && __any_sync(kWarp, active); ++sweep) {
    sweeps += active;
    const bool r1 = jacobi_round<1>(a, v, g, active, abs_tol);
    const bool r2 = jacobi_round<2>(a, v, g, active, abs_tol);
    const bool r3 = jacobi_round<3>(a, v, g, active, abs_tol);
    rotations += (r1 && g < (g ^ 1)) + (r2 && g < (g ^ 2)) + (r3 && g < (g ^ 3));
    const unsigned rotated = __ballot_sync(kWarp, r1 || r2 || r3);
    active = active && ((rotated >> (lane & ~3)) & 0xfu) != 0u;
  }
  rotations += __shfl_xor_sync(kWarp, rotations, 1);
  rotations += __shfl_xor_sync(kWarp, rotations, 2);

  // V's column of the smallest column norm of A (the first on a tie).
  double best = dot4(a, a);
  int arg = g;
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const double other = __shfl_xor_sync(kWarp, best, m);
    const int other_arg = __shfl_xor_sync(kWarp, arg, m);
    if (other < best || (other == best && other_arg < arg)) {
      best = other;
      arg = other_arg;
    }
  }
  const int src = (lane & ~3) | arg;
  double x[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) x[r] = __shfl_sync(kWarp, v[r], src);
  if (!in_range) return;
  const double safe_w = fabs(x[3]) < 1e-12 ? 1e-12 : x[3];
  const long long i = b * n + k;
  if (g < 3) {
    out[i * 3 + g] = static_cast<float>((g == 0 ? x[0] : g == 1 ? x[1] : x[2]) / safe_w);
  } else if (work != nullptr) {
    work[i * 2] = sweeps;
    work[i * 2 + 1] = rotations;
  }
}

}  // namespace

// `batch` problems of n correspondences (uv1, uv2 with strides s*b, s*n in
// floats, the innermost stride 1), projections [batch, 3, 4] when
// p_per_batch is set and [3, 4] otherwise, into out [batch, n, 3] and, when
// work is non-null, work [batch, n, 2] (sweeps, rotations). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int triangulate_dlt_launch(const void* p1, const void* p2, int p_per_batch,
                                      const void* uv1, long long s1b, long long s1n,
                                      const void* uv2, long long s2b, long long s2n,
                                      int batch, int n, void* out, void* work, void* stream) {
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kPoints - 1) / kPoints, batch < kMaxGridY ? batch : kMaxGridY,
                  (batch + kMaxGridY - 1) / kMaxGridY);
  triangulate_dlt_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2), p_per_batch,
      static_cast<const float*>(uv1), s1b, s1n, static_cast<const float*>(uv2), s2b, s2n, batch,
      n, static_cast<float*>(out), static_cast<int*>(work));
  return static_cast<int>(cudaGetLastError());
}
