// Upright ORB (BRIEF) descriptors straight from the padded image: the patch
// cut, the bilinear sampling, the 256 comparisons and the bit packing in
// one kernel.
//
// Replaces, on the upright path, the TPU kernel `extract_patches_pallas`
// of the JAX package's ops/pallas/patches.py together with what its caller
// does with the patches (ops/orb.py of the JAX package: the bf16 cast, the
// [N, 1024] x [1024, 512] sampling product, the compare and `pack_bits`).
// Same function: for corner i with start (y_i, x_i) = round-half-to-even
// of (y, x), placed as lax.dynamic_slice places a start (a negative start
// counts from the end, then it is clamped into the image), the 32 x 32
// window of the padded smoothed image is rounded to bf16; sample s is
// sum_k bf16(window[p_k]) * w_k over the nonzero entries of column s of the
// upright sampling table; bit j of word w is set when
// sample[32w + j] < sample[256 + 32w + j]. Invalid corners get 0 words.
//
// Arithmetic: every product of two bf16 values is exact in float32, and
// the products are added with fmaf, starting from 0, in ascending pixel
// index: the order of a sequential dot product over the table's rows.
//
// What bounds it on an H100: bytes. The function reads the padded image
// (2.06 MB at 406 x 1271; neighbouring windows overlap and hit in L2) and
// writes 32 bytes per corner. Its arithmetic is 1024 x 512 x 4 FMAs at
// N = 1024, far below that. The sampling product it replaces multiplies by
// zero 99.6 % of the time, and the patches it never writes are 2 MB.
//
// Design: each column of the upright table has at most 4 nonzero bilinear
// weights, so a compact tap table (int16 pixel index and float32 weight,
// [512, 4], unused taps at weight 0) replaces the [1024, 512] table; a
// block stages it in shared memory (12 KB). One warp per corner, 8 corners
// per block: the warp copies its window into shared memory as bf16-rounded
// floats (lane x reads column x of each row, so each row is one coalesced
// segment), then lane j computes bit j of every word (samples 32w + j and
// 256 + 32w + j, 4 taps each), and `__ballot_sync` assembles each word;
// lanes 0-7 write the 8 words.
//
// Batch: B images of one shape in one launch (gridDim.y is the image; a
// multi-sequence step describes all its left, then all its right images
// this way). Image b is img[b * h * w ...], its corners xy[b * n * 2 ...]
// and valid[b * n ...], its words out[b * n * 8 ...]. B = 1 is the
// unbatched launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 32;
constexpr int kPixels = kPatch * kPatch;
constexpr int kTests = 256;
constexpr int kSamples = 2 * kTests;
constexpr int kWords = kTests / 32;
constexpr int kWarps = 8;  // corners per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sample(const float* win, short4 idx, float4 w) {
  float acc = 0.0f;
  acc = fmaf(win[idx.x], w.x, acc);
  acc = fmaf(win[idx.y], w.y, acc);
  acc = fmaf(win[idx.z], w.z, acc);
  acc = fmaf(win[idx.w], w.w, acc);
  return acc;
}

__global__ void __launch_bounds__(kWarps * 32)
orb_describe_kernel(const float* __restrict__ img, int h, int w,
                    const float* __restrict__ xy, const uint8_t* __restrict__ valid, int n,
                    const short4* __restrict__ tap_idx, const float4* __restrict__ tap_w,
                    int* __restrict__ out) {
  __shared__ short4 s_idx[kSamples];
  __shared__ float4 s_w[kSamples];
  __shared__ float s_win[kWarps][kPixels];

  for (int s = threadIdx.x; s < kSamples; s += blockDim.x) {
    s_idx[s] = tap_idx[s];
    s_w[s] = tap_w[s];
  }
  const size_t image = blockIdx.y;
  img += image * h * w;
  xy += image * n * 2;
  valid += image * n;
  out += image * n * kWords;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;
  const bool live = i < n && valid[i];  // uniform over the warp
  float* win = s_win[warp];
  if (live) {
    int xs = __float2int_rn(xy[2 * i]);
    int ys = __float2int_rn(xy[2 * i + 1]);
    ys = ys < 0 ? ys + h : ys;
    xs = xs < 0 ? xs + w : xs;
    const int y0 = min(max(ys, 0), h - kPatch);
    const int x0 = min(max(xs, 0), w - kPatch);
    const float* src = img + (size_t)y0 * w + x0 + lane;
#pragma unroll 8
    for (int r = 0; r < kPatch; ++r) {
      win[r * kPatch + lane] = __bfloat162float(__float2bfloat16_rn(src[(size_t)r * w]));
    }
  }
  __syncthreads();  // the tap table and the windows are staged
  if (i >= n) return;

  uint32_t mine = 0;
#pragma unroll
  for (int word = 0; word < kWords; ++word) {
    const int s = word * 32 + lane;
    bool bit = false;
    if (live) {
      bit = sample(win, s_idx[s], s_w[s]) < sample(win, s_idx[s + kTests], s_w[s + kTests]);
    }
    const uint32_t bits = __ballot_sync(kFull, bit);
    if (lane == word) mine = bits;
  }
  if (lane < kWords) out[(size_t)i * kWords + lane] = static_cast<int>(mine);
}

}  // namespace

// `batch` images [batch, h, w] with n corners each: xy [batch, n, 2],
// valid [batch, n], out [batch, n, 8]. Returns the cudaError_t of the
// launch (0 on success). n and batch must be > 0, the image at least
// 32 x 32, the tap tables [512, 4] (int16 and float32).
extern "C" int orb_describe_launch(const void* img, int batch, int h, int w,
                                   const void* xy, const void* valid, int n,
                                   const void* tap_idx, const void* tap_w, void* out,
                                   void* stream) {
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((n + kWarps - 1) / kWarps, batch);
  orb_describe_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, static_cast<const float*>(xy),
      static_cast<const uint8_t*>(valid), n, static_cast<const short4*>(tap_idx),
      static_cast<const float4*>(tap_w), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
