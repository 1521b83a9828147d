// Oriented (rotation-steered) ORB descriptors straight from the padded
// image: the patch cut, the intensity-centroid angle, the soft-binned
// steered sampling, the 256 comparisons and the bit packing in one kernel.
//
// Replaces, on the oriented path (FrontendConfig(oriented=True)), the TPU
// kernel `extract_patches_pallas` of the JAX package's
// ops/pallas/patches.py together with what its caller does with the
// patches (ops/orb.py of the JAX package, `_compute_descriptors_impl`: the
// bf16 cast, the moments product, atan2, and 30 masked per-bin
// [N, 1024] x [1024, 512] sampling products, the compare and `pack_bits`).
// Same function, for corner i:
//  1. start (y_i, x_i) = round-half-to-even of (y, x), placed as
//     lax.dynamic_slice places a start (a negative start counts from the
//     end, then it is clamped into the image); the 32 x 32 window p of the
//     padded smoothed image is rounded to bf16;
//  2. m10 = sum dx * p, m01 = sum dy * p over the disc dx^2 + dy^2 <= r^2
//     centred at (15, 15) (r = orientation_radius, a runtime argument);
//  3. theta = atan2f(m01, m10); bin_f = theta * f32(30 / 2 pi);
//     k0 = floor(bin_f) mod 30, k1 = (k0 + 1) mod 30,
//     frac = bin_f - floor(bin_f), w0 = bf16(1 - frac), w1 = bf16(frac);
//  4. sample s = sum over the taps of bin k0 of bf16(p * w0) * t
//              + sum over the taps of bin k1 of bf16(p * w1) * t;
//  5. bit j of word w = sample[32w + j] < sample[256 + 32w + j]; invalid
//     corners get 0 words; theta is written for every corner, valid or not.
//
// Arithmetic, and where it could part from the plain chain (the dense
// products of ops/kernels/describe.py::orb_describe_oriented_plain):
//  - FMA contraction: nvcc would contract theta * c - floor(theta * c)
//    into one fma and 1 - frac into the neighbouring ops, which moves frac
//    by an ulp and can flip a bf16 bin weight. The bin arithmetic is
//    written with __fmul_rn / __fsub_rn, which nvcc never contracts, and
//    the build has no --use_fast_math.
//  - atan2f against torch's atan2: atan2f(0, 0) = 0, so a flat window
//    (whose moments cancel exactly to +0) gets theta 0 as on the CPU. A
//    negative bin_f is floored and then taken mod 30 onto [0, 30), as
//    torch.remainder does for a negative integer. atan2f is within 2 ulp;
//    so theta may differ from the CPU's by a few ulp.
//  - The wrap pair k0 = 29, k1 = 0: the JAX chain adds the bins' products
//    in ascending k (bin 0 first), this kernel adds bin k0's sum and then
//    bin k1's. Every other bin contributes an exact zero, so both chains
//    add the same two nonzero terms once, and float addition of two terms
//    is commutative: the order is harmless.
//  - Tap order inside a bin: each sample's <= 4 products of a bf16 value
//    with a bf16 table weight are exact in float32 and are added with fmaf
//    from 0 in ascending pixel index. cuBLAS and the CPU's GEMM add them in
//    their own order, so a pair tied to the last bit could flip: at most
//    1e-4 of the bits may differ (0 expected), as for the upright describe.
//  - The moments' order: each lane adds its column's products from 0 down
//    the rows (exact products, one rounding per add), then a butterfly of
//    __shfl_xor_sync over offsets 16, 8, 4, 2, 1 adds the lanes. Float
//    addition is commutative, so after the butterfly every lane holds the
//    same bits and computes the same theta and bins itself: no broadcast
//    is needed. The plain chain's product adds in another order, so theta
//    may differ by a few ulp (held to 1e-5 rad); rarely that rounds a bin
//    weight the other way. tests/test_torch_orb_oriented.py repeats this
//    order on the CPU.
//
// What bounds it on an H100: bytes. At N = 1024 on a 406 x 1271 image the
// function reads the padded image once (2.06 MB), the steered tap table
// (30 bins x 512 samples x 4 taps of an int16 index and a bf16 weight,
// 0.25 MB) and 9 bytes per corner, and writes 36 bytes per corner: 2.36 MB,
// 0.70 us at 3.35 TB/s. Its arithmetic is about 1024 x (4 x 709 + 512 x 2
// x 4 x 3) = 15.5 MFLOP of float32, 0.23 us at 67 TFLOP/s. The dense chain
// it replaces writes and reads a 2 MB patch tensor, and its 30 products
// (1.07 GFLOP each) multiply by zero 99.6 % of the time.
//
// Design: one warp per corner, 8 corners per block. The warp copies its
// window into shared memory as bf16-rounded floats (lane x reads column x
// of each row, so each row is one coalesced 128-byte segment) and adds its
// column's moment products on the way. Then lane j computes bit j of every
// word: samples 32w + j and 256 + 32w + j, 4 taps of each of the two bins,
// and `__ballot_sync` assembles each word; lanes 0-7 write the 8 words.
// The tap table ([30, 512, 4] int16 indices and [30, 512, 4] bf16 weights,
// 240 KB together) stays in L2; each warp reads its two bins' 16 KB
// through __ldg (the read-only path), each record once. Staging bins in
// shared memory would not pay off: a warp reads each record of its two
// bins exactly once, and the 8 corners of a block have unrelated angles,
// so a shared copy adds a write and a read for no reuse (the whole table
// does not fit a block's 227 KB either). Sorting corners by bin so that a
// block shares its bins, and persistent blocks, are left to a later change
// and only if a measurement shows the L2 reads set the time.
//
// Batch: B images of one shape in one launch (gridDim.y is the image). Image
// b is img[b * h * w ...], its corners xy[b * n * 2 ...] and valid[b * n
// ...], its words out[b * n * 8 ...] and angles theta[b * n ...]. B = 1 is
// the unbatched launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 32;
constexpr int kPixels = kPatch * kPatch;
constexpr int kCentre = 15;  // PATCH_R: the disc's centre in the window
constexpr int kTests = 256;
constexpr int kSamples = 2 * kTests;
constexpr int kWords = kTests / 32;
constexpr int kBins = 30;
// f32(30 / 2 pi): the constant the plain chain multiplies by (a Python
// float rounded to float32).
constexpr float kBinScale = static_cast<float>(30.0 / (2.0 * 3.14159265358979323846));
constexpr int kWarps = 8;  // corners per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The bf16 weights of a packed pair: the low half is the first tap.
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// One bin's part of a sample: bf16(p * wbin) times each tap weight (both
// bf16, so the product is exact in float32), added from 0 in ascending
// pixel index. __fmul_rn keeps p * wbin out of an fma with the bf16 round.
__device__ __forceinline__ float bin_sample(const float* win, short4 idx, uint2 t, float wbin) {
  float acc = 0.0f;
  acc = fmaf(bf16_round(__fmul_rn(win[idx.x], wbin)), bf16_lo(t.x), acc);
  acc = fmaf(bf16_round(__fmul_rn(win[idx.y], wbin)), bf16_hi(t.x), acc);
  acc = fmaf(bf16_round(__fmul_rn(win[idx.z], wbin)), bf16_lo(t.y), acc);
  acc = fmaf(bf16_round(__fmul_rn(win[idx.w], wbin)), bf16_hi(t.y), acc);
  return acc;
}

__global__ void __launch_bounds__(kWarps * 32)
orb_describe_oriented_kernel(const float* __restrict__ img, int h, int w,
                             const float* __restrict__ xy, const uint8_t* __restrict__ valid,
                             int n, int radius2, const short4* __restrict__ tap_idx,
                             const uint2* __restrict__ tap_w, int* __restrict__ out,
                             float* __restrict__ theta_out) {
  __shared__ float s_win[kWarps][kPixels];

  const size_t image = blockIdx.y;
  img += image * h * w;
  xy += image * n * 2;
  valid += image * n;
  out += image * n * kWords;
  theta_out += image * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // uniform over the warp; no block-wide barrier follows
  float* win = s_win[warp];

  int xs = __float2int_rn(xy[2 * i]);
  int ys = __float2int_rn(xy[2 * i + 1]);
  ys = ys < 0 ? ys + h : ys;
  xs = xs < 0 ? xs + w : xs;
  const int y0 = min(max(ys, 0), h - kPatch);
  const int x0 = min(max(xs, 0), w - kPatch);
  const float* src = img + (size_t)y0 * w + x0 + lane;

  // Stage the window and add this column's moment products down the rows.
  const int dx = lane - kCentre;
  float m10 = 0.0f;
  float m01 = 0.0f;
#pragma unroll 8
  for (int r = 0; r < kPatch; ++r) {
    const float p = bf16_round(__ldg(src + (size_t)r * w));
    win[r * kPatch + lane] = p;
    const int dy = r - kCentre;
    const bool disc = dx * dx + dy * dy <= radius2;
    m10 = fmaf(disc ? static_cast<float>(dx) : 0.0f, p, m10);
    m01 = fmaf(disc ? static_cast<float>(dy) : 0.0f, p, m01);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(kFull, m10, off));
    m01 = __fadd_rn(m01, __shfl_xor_sync(kFull, m01, off));
  }
  __syncwarp();  // the window is visible to the whole warp

  const float theta = atan2f(m01, m10);
  if (lane == 0) theta_out[i] = theta;
  if (!valid[i]) {
    if (lane < kWords) out[(size_t)i * kWords + lane] = 0;
    return;
  }
  const float bin_f = __fmul_rn(theta, kBinScale);
  const float k0f = floorf(bin_f);
  const float frac = __fsub_rn(bin_f, k0f);
  int k0 = static_cast<int>(k0f) % kBins;
  k0 = k0 < 0 ? k0 + kBins : k0;
  const int k1 = k0 + 1 == kBins ? 0 : k0 + 1;
  const float w0 = bf16_round(__fsub_rn(1.0f, frac));
  const float w1 = bf16_round(frac);
  const short4* idx0 = tap_idx + (size_t)k0 * kSamples;
  const short4* idx1 = tap_idx + (size_t)k1 * kSamples;
  const uint2* tw0 = tap_w + (size_t)k0 * kSamples;
  const uint2* tw1 = tap_w + (size_t)k1 * kSamples;

  uint32_t mine = 0;
#pragma unroll
  for (int word = 0; word < kWords; ++word) {
    const int a = word * 32 + lane;
    const int b = a + kTests;
    const float va = __fadd_rn(bin_sample(win, __ldg(idx0 + a), __ldg(tw0 + a), w0),
                               bin_sample(win, __ldg(idx1 + a), __ldg(tw1 + a), w1));
    const float vb = __fadd_rn(bin_sample(win, __ldg(idx0 + b), __ldg(tw0 + b), w0),
                               bin_sample(win, __ldg(idx1 + b), __ldg(tw1 + b), w1));
    const uint32_t bits = __ballot_sync(kFull, va < vb);
    if (lane == word) mine = bits;
  }
  if (lane < kWords) out[(size_t)i * kWords + lane] = static_cast<int>(mine);
}

}  // namespace

// `batch` images [batch, h, w] with n corners each: xy [batch, n, 2],
// valid [batch, n], out [batch, n, 8], theta [batch, n]. radius2 is the
// squared orientation radius. Returns the cudaError_t of the launch (0 on
// success). n and batch must be > 0, the image at least 32 x 32, the tap
// tables [30, 512, 4] (int16 and bf16).
extern "C" int orb_describe_oriented_launch(const void* img, int batch, int h, int w,
                                            const void* xy, const void* valid, int n,
                                            int radius2, const void* tap_idx,
                                            const void* tap_w, void* out, void* theta,
                                            void* stream) {
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((n + kWarps - 1) / kWarps, batch);
  orb_describe_oriented_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, static_cast<const float*>(xy),
      static_cast<const uint8_t*>(valid), n, radius2, static_cast<const short4*>(tap_idx),
      static_cast<const uint2*>(tap_w), static_cast<int*>(out), static_cast<float*>(theta));
  return static_cast<int>(cudaGetLastError());
}
