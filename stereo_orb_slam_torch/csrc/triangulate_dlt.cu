// Batched DLT triangulation: the null vector of each 4x4 system by a
// one-sided Jacobi SVD in float64, one thread per correspondence.
//
// A hand kernel with no Pallas counterpart. It computes the function of the
// JAX package's geometry/camera.py::triangulate_dlt (cv::triangulatePoints,
// ref src/camera_model.cpp:123-152): per correspondence the system
//   A = [u1 P1^3 - P1^1; v1 P1^3 - P1^2; u2 P2^3 - P2^1; v2 P2^3 - P2^2]
// (P^i the i-th row of a [3, 4] projection), the right singular vector X of
// A's smallest singular value, and X[:3] / X[3] with |X[3]| < 1e-12 taken
// as 1e-12. The JAX package takes the vector from jnp.linalg.svd, XLA's own
// solver inside its jitted program. The port's plain version takes it from
// torch.linalg.svd, which on the card is cuSOLVER's batched Jacobi SVD: it
// syncs the host twice per call, and a sync is illegal inside a captured
// CUDA graph, so the general rig's front end could not be captured. This
// kernel computes the same vector with no host sync.
//
// Method: A is built in float64 from the float32 inputs. One-sided
// (Hestenes) Jacobi rotates pairs of A's columns until they are mutually
// orthogonal, accumulating the rotations in V (A V = U S): then column j of
// A has norm sigma_j and column j of V is its right singular vector. Pairs
// are visited in the cyclic order (0,1) (0,2) (0,3) (1,2) (1,3) (2,3); a
// pair is rotated when |a_p . a_q| > 1e-15 |a_p| |a_q| and |a_p . a_q| >
// 1e-30 |A|_F^2 (columns at rounding level of A are left alone, so rank-
// deficient systems stop too); a thread stops after a sweep with no
// rotation, or after 16 sweeps. V's column of the smallest column norm of A
// is the null vector (the first on a tie), dehomogenised in float64 and
// rounded once to float32. Working on A itself, not on A^T A, keeps A's
// condition number instead of squaring it, and float64 makes the result the
// float64 DLT's rounded once, whatever the rotation order; its sign is
// arbitrary and cancels in the division. Degenerate systems (all-zero or
// duplicated rows, as invalid slots hold) give finite output: V stays
// orthonormal, and the |w| guard bounds the division.
//
// What bounds it on an H100: at the front end's N = 1024 neither bytes nor
// operations. It reads 16 bytes and writes 12 per point (28 KB) and does
// about 2,000 float64 operations per point (5 sweeps, 19 rotations: 2 MFLOP,
// 0.06 us at half the float32 rate), so the time is one thread's chain of
// dependent float64 divisions and square roots (about 30 rotation tests)
// on a few warps per SM. The design keeps everything in registers (A and V
// are 32 doubles, every index a compile-time constant) and launches no
// second pass.
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

constexpr int kMaxSweeps = 16;
constexpr double kRelTol = 1e-15;
constexpr double kAbsTol = 1e-30;

// One Jacobi rotation of columns P < Q of a (and of v); returns 1 if the pair
// was rotated. Every index is a compile-time constant, so a and v stay in
// registers.
template <int P, int Q>
__device__ __forceinline__ int rotate(double (&a)[4][4], double (&v)[4][4], double abs_tol) {
  double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    alpha += a[r][P] * a[r][P];
    beta += a[r][Q] * a[r][Q];
    gamma += a[r][P] * a[r][Q];
  }
  if (!(gamma * gamma > kRelTol * kRelTol * alpha * beta && fabs(gamma) > abs_tol)) return 0;
  const double zeta = (beta - alpha) / (2.0 * gamma);
  const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
  const double c = rsqrt(1.0 + t * t);
  const double s = c * t;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const double ap = a[r][P], aq = a[r][Q];
    a[r][P] = c * ap - s * aq;
    a[r][Q] = s * ap + c * aq;
    const double vp = v[r][P], vq = v[r][Q];
    v[r][P] = c * vp - s * vq;
    v[r][Q] = s * vp + c * vq;
  }
  return 1;
}

__global__ void __launch_bounds__(64)
triangulate_dlt_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                       int p_per_batch, const float* __restrict__ uv1, long long s1b,
                       long long s1n, const float* __restrict__ uv2, long long s2b,
                       long long s2n, int batch, int n, float* __restrict__ out,
                       int* __restrict__ work) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(batch) * n) return;
  const long long b = i / n, k = i % n;
  const float* P1 = p1 + (p_per_batch ? b * 12 : 0);
  const float* P2 = p2 + (p_per_batch ? b * 12 : 0);
  const float* x1 = uv1 + b * s1b + k * s1n;
  const float* x2 = uv2 + b * s2b + k * s2n;
  const double u1 = x1[0], v1 = x1[1], u2 = x2[0], v2 = x2[1];

  double a[4][4], v[4][4];
  double frob = 0.0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[0][c] = u1 * static_cast<double>(P1[8 + c]) - static_cast<double>(P1[c]);
    a[1][c] = v1 * static_cast<double>(P1[8 + c]) - static_cast<double>(P1[4 + c]);
    a[2][c] = u2 * static_cast<double>(P2[8 + c]) - static_cast<double>(P2[c]);
    a[3][c] = v2 * static_cast<double>(P2[8 + c]) - static_cast<double>(P2[4 + c]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v[r][c] = r == c ? 1.0 : 0.0;
      frob += a[r][c] * a[r][c];
    }
  }
  const double abs_tol = kAbsTol * frob;

  int sweeps = 0, rotations = 0;
  while (sweeps < kMaxSweeps) {
    ++sweeps;
    const int r = rotate<0, 1>(a, v, abs_tol) + rotate<0, 2>(a, v, abs_tol) +
                  rotate<0, 3>(a, v, abs_tol) + rotate<1, 2>(a, v, abs_tol) +
                  rotate<1, 3>(a, v, abs_tol) + rotate<2, 3>(a, v, abs_tol);
    rotations += r;
    if (r == 0) break;
  }

  // V's column of the smallest column norm of A (the first on a tie).
  double norm[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    norm[c] = a[0][c] * a[0][c] + a[1][c] * a[1][c] + a[2][c] * a[2][c] + a[3][c] * a[3][c];
  }
  double best = norm[0], x = v[0][0], y = v[1][0], z = v[2][0], w = v[3][0];
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    if (norm[c] < best) {
      best = norm[c];
      x = v[0][c];
      y = v[1][c];
      z = v[2][c];
      w = v[3][c];
    }
  }
  const double safe_w = fabs(w) < 1e-12 ? 1e-12 : w;
  float* o = out + i * 3;
  o[0] = static_cast<float>(x / safe_w);
  o[1] = static_cast<float>(y / safe_w);
  o[2] = static_cast<float>(z / safe_w);
  if (work != nullptr) {
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
  const long long total = static_cast<long long>(batch) * n;
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int block = 64;
  const long long grid = (total + block - 1) / block;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  triangulate_dlt_kernel<<<static_cast<unsigned>(grid), block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p1), static_cast<const float*>(p2), p_per_batch,
      static_cast<const float*>(uv1), s1b, s1n, static_cast<const float*>(uv2), s2b, s2n,
      batch, n, static_cast<float*>(out), static_cast<int*>(work));
  return static_cast<int>(cudaGetLastError());
}
