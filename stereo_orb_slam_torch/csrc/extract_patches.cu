// Batched patch cut at per-corner offsets, fused with the bf16 cast.
//
// Replaces the TPU kernel `extract_patches_pallas` (body `_kernel`) of
// the JAX package's ops/pallas/patches.py, together with the bf16 cast
// its caller applies (ops/orb.py:262 of the JAX package). Same function:
// out[i] = bf16(img[y_i : y_i + P, x_i : x_i + P]) for the smoothed image
// padded by PATCH_R. Start offsets are placed as lax.dynamic_slice places
// them: a negative start counts from the end, then it is clamped to
// [0, H - P] and [0, W - P]. The TPU kernel's aligned window, lane roll
// and sublane switch were workarounds for the TPU compiler and have no
// counterpart here.
//
// What bounds it on an H100: bytes. At N = 1024, P = 32 it reads 4 MB of
// f32 windows (at most; neighbouring windows overlap and hit in L2) and
// writes 2 MB of bf16, a few microseconds at 3.35 TB/s. There is no
// arithmetic beyond the cast.
//
// Design: one block per patch, a 32 x 8 thread block. Lane x reads column x
// of a window row, so each warp reads one 128-byte row segment and writes
// 64 contiguous bytes. The cast rounds to nearest even (__float2bfloat16_rn),
// as torch's and XLA's float -> bf16 conversions do.
//
// No path of the port launches it: the upright and the oriented describe
// each fuse the cut into their own kernel (orb_describe.cu,
// orb_describe_oriented.cu). It stays as the direct port of the TPU kernel,
// held against its plain version by the card tests and chip_smoke.py.
//
// Batch: B images of one shape in one launch (gridDim.y is the image).
// Image b is img[b * h * w ...], its starts ys/xs[b * n ...], its patches
// out[b * n * P * P ...]. B = 1 is the unbatched launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
extract_patches_kernel(const float* __restrict__ img, int h, int w,
                       const int* __restrict__ ys, const int* __restrict__ xs,
                       int patch, __nv_bfloat16* __restrict__ out) {
  const size_t image = blockIdx.y;
  img += image * h * w;
  ys += image * gridDim.x;
  xs += image * gridDim.x;
  out += image * gridDim.x * patch * patch;
  const int i = blockIdx.x;
  const int ys_i = ys[i] < 0 ? ys[i] + h : ys[i];
  const int xs_i = xs[i] < 0 ? xs[i] + w : xs[i];
  const int y0 = min(max(ys_i, 0), h - patch);
  const int x0 = min(max(xs_i, 0), w - patch);
  __nv_bfloat16* dst = out + (size_t)i * patch * patch;
  for (int r = threadIdx.y; r < patch; r += blockDim.y) {
    const float* src = img + (size_t)(y0 + r) * w + x0;
    for (int c = threadIdx.x; c < patch; c += blockDim.x) {
      dst[r * patch + c] = __float2bfloat16_rn(src[c]);
    }
  }
}

}  // namespace

// `batch` images [batch, h, w] with n starts each (ys, xs [batch, n]) into
// out [batch, n, patch, patch]. Returns the cudaError_t of the launch (0 on
// success). n and batch must be > 0 and the image at least patch x patch.
extern "C" int extract_patches_launch(const void* img, int batch, int h, int w,
                                      const void* ys, const void* xs, int n, int patch,
                                      void* out, void* stream) {
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n, batch);
  const dim3 block(32, 8);
  extract_patches_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), h, w, static_cast<const int*>(ys),
      static_cast<const int*>(xs), patch, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
