// Shi-Tomasi corner detection in three kernels around one sort: the
// min-eigenvalue response, the window NMS with each tile's maximum, and the
// per-slot subpixel refine.
//
// Replaces no TPU kernel: the JAX package computes this function, its
// ops/detect.py::detect_corners, as XLA ops (no Pallas kernel). Its plain
// PyTorch version, ops/detect.py::detect_corners_plain, builds every filter
// from shifted copies of the whole image, one torch.cat at a time: about
// 290 kernels and 0.8 GB of device traffic for one frame's two images. Same function, same float32 arithmetic in the
// same order, every value bit for bit (ops/kernels/detect.py holds the
// caller's side):
//
//   ix, iy    Sobel x/y as separable passes, sy = (I[y-1] + 2 I[y]) + I[y+1],
//             ix = (sy[x+1] - sy[x-1]) * 0.125, and the transpose for iy;
//   box       the k x k window sum of each product, rows then columns, each
//             pass adding (acc + v[+d]) + v[-d] for d = 1..k/2, times the
//             float32 1/k^2;
//   response  0.5 (ixx + iyy) - sqrt(max(0.25 (diff diff) + ixy ixy, 0));
//   jitter    resp + hash(y, x) * (1e-5 max(peak, 1e-12)), with
//             hash = ((7919 y + 104729 x) mod 65521) * float32(1/65521);
//   NMS       keep = resp >= the maximum of the (2 r + 1)^2 window clipped
//             to the image;
//   tiles     each tile x tile block's maximum of the jittered response
//             where kept and inside the border (-inf elsewhere and in the
//             padding) and its first argmax in row-major order;
//   refine    the 3 x 3 quadratic fit on the jittered response, clamped.
//
// Every edge is replicated: a pixel's neighbour outside the image is read
// at the clamped coordinate, which is what the shifted copies hold. Each
// operation is an IEEE round-to-nearest intrinsic (__fadd_rn, __fmul_rn,
// ...), which nvcc never contracts into an FMA; sqrt and the division are
// correctly rounded, as torch.sqrt and torch.div are on the card.
//
// What bounds it on an H100: bytes. The response reads each image once
// (1.44 MB at 480 x 752) and writes the raw response once; the NMS kernel
// reads it once more; the refine reads 9 values per slot. The arithmetic
// is a few hundred float32 operations a pixel, far below the byte time.
// Design: every intermediate stays on chip. The response kernel loads a
// 32 x 32 tile with a halo of 1 + k/2 into shared memory and keeps the
// three products and their column sums there; the NMS kernel loads a tile
// of the raw response with a halo of the NMS radius, forms the jittered
// response as it loads, takes the clipped window maximum separably and
// reduces each detection tile to its maximum and argmax in shared memory.
// The image's peak and its largest kept raw response are maxima over the
// whole image: each block writes its own, and the next kernel's blocks
// reduce those few hundred partial maxima (no atomics, no scratch to
// clear; a maximum is exact in any order).
//
// The sort of the tile maxima stays torch.sort (stable, descending: ties
// to the lower tile), between the NMS and the refine launches.
//
// Batch: S images of one shape (gridDim.z, or gridDim.y for the refine).
// Image s is img[s * h * w ...]; its tiles tile_max/tile_arg[s * n_tiles ...];
// its slots at row s of the sorted values and indices (row stride given)
// and of xy [S, n, 2], scores [S, n], valid [S, n].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;       // the response kernel's output tile, square
constexpr int kThreads = 256;
constexpr int kRefineThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// The block's maximum of each thread's v, in every thread (blockDim.x a
// multiple of 32, at most 1024).
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[32];
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  __syncthreads();  // warp_max may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_max[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) v = fmaxf(v, warp_max[i]);
  return v;
}

// The maximum of an image's n partial maxima, in every thread of the block.
__device__ __forceinline__ float parts_max(const float* parts, int n, float v) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) v = fmaxf(v, parts[i]);
  return block_max(v);
}

// The jittered response at (y, x), from the raw response.
__device__ __forceinline__ float jittered(float raw, int y, int x, float scale,
                                          float inv_mod) {
  const int hash = (y * 7919 + x * 104729) % 65521;
  return __fadd_rn(raw, __fmul_rn(__fmul_rn(static_cast<float>(hash), inv_mod), scale));
}

__device__ __forceinline__ float jitter_scale(float peak) {
  return __fmul_rn(1e-5f, fmaxf(peak, 1e-12f));
}

// Shared memory: the image tile with a halo of r + 1, the three products
// with a halo of r, their column sums over the tile's rows. Writes the
// block's maximum to part[image][block].
__global__ void __launch_bounds__(kThreads)
detect_response_kernel(const float* __restrict__ img, int h, int w, int r, float inv_area,
                       float* __restrict__ resp, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int n_in = kTile + 2 * (r + 1);
  const int n_p = kTile + 2 * r;
  float* s_img = smem;
  float* s_p = s_img + n_in * n_in;          // ixx, iyy, ixy products: 3 x [n_p][n_p]
  float* s_v = s_p + 3 * n_p * n_p;          // their column sums: 3 x [kTile][n_p]
  const size_t image = blockIdx.z;
  img += image * h * w;
  resp += image * h * w;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const int iy0 = y0 - r - 1, ix0 = x0 - r - 1;   // s_img's origin
  const int py0 = y0 - r, px0 = x0 - r;           // s_p's origin

  for (int i = threadIdx.x; i < n_in * n_in; i += kThreads) {
    const int ly = i / n_in, lx = i % n_in;
    s_img[i] = img[(size_t)clampi(iy0 + ly, 0, h - 1) * w + clampi(ix0 + lx, 0, w - 1)];
  }
  __syncthreads();

  // Pixel (y, x) of the image, in-image coordinates.
  auto pix = [&](int y, int x) { return s_img[(y - iy0) * n_in + (x - ix0)]; };
  for (int i = threadIdx.x; i < n_p * n_p; i += kThreads) {
    const int y = clampi(py0 + i / n_p, 0, h - 1), x = clampi(px0 + i % n_p, 0, w - 1);
    const int ya = max(y - 1, 0), yb = min(y + 1, h - 1);
    const int xa = max(x - 1, 0), xb = min(x + 1, w - 1);
    const float sy_b = __fadd_rn(__fadd_rn(pix(ya, xb), __fmul_rn(2.0f, pix(y, xb))), pix(yb, xb));
    const float sy_a = __fadd_rn(__fadd_rn(pix(ya, xa), __fmul_rn(2.0f, pix(y, xa))), pix(yb, xa));
    const float sx_b = __fadd_rn(__fadd_rn(pix(yb, xa), __fmul_rn(2.0f, pix(yb, x))), pix(yb, xb));
    const float sx_a = __fadd_rn(__fadd_rn(pix(ya, xa), __fmul_rn(2.0f, pix(ya, x))), pix(ya, xb));
    const float gx = __fmul_rn(__fsub_rn(sy_b, sy_a), 0.125f);
    const float gy = __fmul_rn(__fsub_rn(sx_b, sx_a), 0.125f);
    s_p[i] = __fmul_rn(gx, gx);
    s_p[n_p * n_p + i] = __fmul_rn(gy, gy);
    s_p[2 * n_p * n_p + i] = __fmul_rn(gx, gy);
  }
  __syncthreads();

  // Column sums: rows y, y + 1, y - 1, y + 2, y - 2, ... (clamped).
  for (int i = threadIdx.x; i < kTile * n_p; i += kThreads) {
    const int ty = i / n_p, px = i % n_p;
    const int y = min(y0 + ty, h - 1);
    for (int c = 0; c < 3; ++c) {
      const float* p = s_p + c * n_p * n_p + px;
      float acc = p[(y - py0) * n_p];
      for (int d = 1; d <= r; ++d) {
        acc = __fadd_rn(acc, p[(min(y + d, h - 1) - py0) * n_p]);
        acc = __fadd_rn(acc, p[(max(y - d, 0) - py0) * n_p]);
      }
      s_v[c * kTile * n_p + i] = acc;
    }
  }
  __syncthreads();

  float top = -INFINITY;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y < h && x < w) {
      float m[3];
      for (int c = 0; c < 3; ++c) {
        const float* v = s_v + c * kTile * n_p + ty * n_p;
        float acc = v[x - px0];
        for (int d = 1; d <= r; ++d) {
          acc = __fadd_rn(acc, v[min(x + d, w - 1) - px0]);
          acc = __fadd_rn(acc, v[max(x - d, 0) - px0]);
        }
        m[c] = __fmul_rn(acc, inv_area);
      }
      const float tr_half = __fmul_rn(0.5f, __fadd_rn(m[0], m[1]));
      const float diff = __fsub_rn(m[0], m[1]);
      const float disc = __fadd_rn(__fmul_rn(0.25f, __fmul_rn(diff, diff)), __fmul_rn(m[2], m[2]));
      const float out = __fsub_rn(tr_half, __fsqrt_rn(fmaxf(disc, 0.0f)));
      resp[(size_t)y * w + x] = out;
      top = fmaxf(top, out);
    }
  }
  top = block_max(top);
  if (threadIdx.x == 0) part[(image * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = top;
}

// Shared memory: the jittered response with a halo of the NMS radius nr,
// its column maxima over the block's rows, the masked response of the
// block. `side` is the block's side in pixels, a multiple of `tile`. Reads
// the response kernel's n_peak partial maxima an image (block 0 writes the
// peak); writes the block's largest kept raw response, at least 0, to
// part[image][block].
__global__ void __launch_bounds__(kThreads)
detect_nms_kernel(const float* __restrict__ resp, int h, int w, int nr, int tile, int side,
                  int border, float inv_mod, const float* __restrict__ peak_part, int n_peak,
                  float* __restrict__ peak, float* __restrict__ part,
                  float* __restrict__ tile_max, int* __restrict__ tile_arg, int n_th,
                  int n_tw) {
  extern __shared__ float smem[];
  const int n_j = side + 2 * nr;
  float* s_j = smem;                   // [n_j][n_j]
  float* s_c = s_j + n_j * n_j;        // [side][n_j]
  float* s_m = s_c + side * n_j;       // [side][side]
  const size_t image = blockIdx.z;
  resp += image * h * w;
  const int y0 = blockIdx.y * side, x0 = blockIdx.x * side;
  const float top_all = parts_max(peak_part + image * n_peak, n_peak, -INFINITY);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) peak[image] = top_all;
  const float scale = jitter_scale(top_all);

  for (int i = threadIdx.x; i < n_j * n_j; i += kThreads) {
    const int y = clampi(y0 - nr + i / n_j, 0, h - 1), x = clampi(x0 - nr + i % n_j, 0, w - 1);
    s_j[i] = jittered(resp[(size_t)y * w + x], y, x, scale, inv_mod);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < side * n_j; i += kThreads) {
    const float* col = s_j + (i / n_j) * n_j + i % n_j;   // rows ty .. ty + 2 nr
    float m = col[0];
    for (int d = 1; d <= 2 * nr; ++d) m = fmaxf(m, col[d * n_j]);
    s_c[i] = m;
  }
  __syncthreads();
  float top = 0.0f;
  for (int i = threadIdx.x; i < side * side; i += kThreads) {
    const int ty = i / side, tx = i % side;
    const int y = y0 + ty, x = x0 + tx;
    const float* row = s_c + ty * n_j + tx;                 // columns tx .. tx + 2 nr
    float pooled = row[0];
    for (int d = 1; d <= 2 * nr; ++d) pooled = fmaxf(pooled, row[d]);
    const float v = s_j[(ty + nr) * n_j + tx + nr];
    const bool kept = v >= pooled && y >= border && y < h - border && x >= border &&
                      x < w - border;
    s_m[i] = kept ? v : -INFINITY;
    if (kept) top = fmaxf(top, resp[(size_t)y * w + x]);
  }
  top = block_max(top);   // its barriers also publish s_m
  if (threadIdx.x == 0) part[(image * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = top;

  const int per_side = side / tile;
  for (int t = threadIdx.x; t < per_side * per_side; t += kThreads) {
    const int a = t / per_side, b = t % per_side;
    const int ty = blockIdx.y * per_side + a, tx = blockIdx.x * per_side + b;
    if (ty >= n_th || tx >= n_tw) continue;
    const float* m = s_m + a * tile * side + b * tile;
    float best = m[0];
    int arg = 0;
    for (int k = 1; k < tile * tile; ++k) {
      const float v = m[(k / tile) * side + k % tile];
      if (v > best) {
        best = v;
        arg = k;
      }
    }
    const size_t o = image * n_th * n_tw + (size_t)ty * n_tw + tx;
    tile_max[o] = best;
    tile_arg[o] = arg;
  }
}

// Reads the NMS kernel's n_part partial maxima an image; thread 0 of an
// image writes its largest kept raw response to max_resp.
__global__ void __launch_bounds__(kRefineThreads)
detect_refine_kernel(const float* __restrict__ resp, int h, int w,
                     const float* __restrict__ peak, const float* __restrict__ part,
                     int n_part, const float* __restrict__ top_vals,
                     const int64_t* __restrict__ top_idx, int64_t row_stride, int n,
                     const int* __restrict__ tile_arg, int tile, int n_tiles, int n_tw,
                     float quality, int subpix, float inv_mod, float* __restrict__ xy,
                     float* __restrict__ scores, bool* __restrict__ valid,
                     float* __restrict__ max_resp) {
  const size_t image = blockIdx.y;
  const int j = blockIdx.x * kRefineThreads + threadIdx.x;
  const float top = parts_max(part + image * n_part, n_part, 0.0f);
  if (j == 0) max_resp[image] = top;
  if (j >= n) return;
  resp += image * h * w;
  const float val = top_vals[image * row_stride + j];
  const int64_t t = top_idx[image * row_stride + j];
  const int within = tile_arg[image * n_tiles + t];
  const int ys = static_cast<int>(t / n_tw) * tile + within / tile;
  const int xs = static_cast<int>(t % n_tw) * tile + within % tile;
  const float score = resp[(size_t)ys * w + xs];
  const bool ok_slot = isfinite(val) && score > __fmul_rn(quality, top) && score > 1e-6f &&
                       top > 0.0f;
  float dx = 0.0f, dy = 0.0f;
  if (subpix) {
    const float scale = jitter_scale(peak[image]);
    const int yc = clampi(ys, 1, h - 2), xc = clampi(xs, 1, w - 2);
    float at[3][3];
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) {
        const int y = yc + a - 1, x = xc + b - 1;
        at[a][b] = jittered(resp[(size_t)y * w + x], y, x, scale, inv_mod);
      }
    }
    const float gx = __fmul_rn(0.5f, __fsub_rn(at[1][2], at[1][0]));
    const float gy = __fmul_rn(0.5f, __fsub_rn(at[2][1], at[0][1]));
    const float c2 = __fmul_rn(2.0f, at[1][1]);
    const float gxx = __fadd_rn(__fsub_rn(at[1][2], c2), at[1][0]);
    const float gyy = __fadd_rn(__fsub_rn(at[2][1], c2), at[0][1]);
    const float gxy = __fmul_rn(
        0.25f, __fadd_rn(__fsub_rn(__fsub_rn(at[2][2], at[2][0]), at[0][2]), at[0][0]));
    const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
    const float safe = fabsf(det) < 1e-12f ? 1e-12f : det;
    const float ox = __fdiv_rn(-__fsub_rn(__fmul_rn(gyy, gx), __fmul_rn(gxy, gy)), safe);
    const float oy = __fdiv_rn(-__fsub_rn(__fmul_rn(gxx, gy), __fmul_rn(gxy, gx)), safe);
    if (fabsf(det) > 1e-12f && fabsf(ox) <= 1.0f && fabsf(oy) <= 1.0f) {
      dx = fminf(fmaxf(ox, -0.5f), 0.5f);
      dy = fminf(fmaxf(oy, -0.5f), 0.5f);
    }
  }
  const size_t o = image * n + j;
  xy[2 * o] = ok_slot ? __fadd_rn(static_cast<float>(xs), dx) : 0.0f;
  xy[2 * o + 1] = ok_slot ? __fadd_rn(static_cast<float>(ys), dy) : 0.0f;
  scores[o] = ok_slot ? score : 0.0f;
  valid[o] = ok_slot;
}

float inv_hash_mod() { return static_cast<float>(1.0 / 65521.0); }

// Shared memory bytes a block of the two image kernels takes
// (ops/kernels/detect.py::shared_bytes mirrors them).
int response_smem(int r) {
  const int n_in = kTile + 2 * (r + 1), n_p = kTile + 2 * r;
  return static_cast<int>(sizeof(float)) * (n_in * n_in + 3 * n_p * n_p + 3 * kTile * n_p);
}

int nms_smem(int nr, int side) {
  const int n_j = side + 2 * nr;
  return static_cast<int>(sizeof(float)) * (n_j * n_j + side * n_j + side * side);
}

// A block's dynamic shared memory: the 48 KiB it gets without opt-in, less
// block_max's static buffer.
constexpr int kMaxSmem = 48 * 1024 - 32 * static_cast<int>(sizeof(float));

}  // namespace

// The response and the NMS of `batch` images [batch, h, w]: writes resp
// [batch, h, w], peak [batch], tile_max / tile_arg [batch, n_th * n_tw] and
// the NMS blocks' partial maxima part_n [batch, nms_blocks(...)], through
// the response blocks' part_r [batch, response_blocks(h, w)]. Two kernel
// launches. Returns the first cudaError_t (0 on success).
extern "C" int detect_response_nms_launch(const void* img, int batch, int h, int w, int r,
                                          float inv_area, int nr, int tile, int side,
                                          int border, void* resp, void* part_r, void* peak,
                                          void* part_n, void* tile_max, void* tile_arg,
                                          int n_th, int n_tw, void* stream) {
  if (batch < 1 || batch > 65535 || response_smem(r) > kMaxSmem ||
      nms_smem(nr, side) > kMaxSmem || side % tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid_r((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, batch);
  detect_response_kernel<<<grid_r, kThreads, response_smem(r), s>>>(
      static_cast<const float*>(img), h, w, r, inv_area, static_cast<float*>(resp),
      static_cast<float*>(part_r));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_n((w + side - 1) / side, (h + side - 1) / side, batch);
  detect_nms_kernel<<<grid_n, kThreads, nms_smem(nr, side), s>>>(
      static_cast<const float*>(resp), h, w, nr, tile, side, border, inv_hash_mod(),
      static_cast<const float*>(part_r), grid_r.x * grid_r.y, static_cast<float*>(peak),
      static_cast<float*>(part_n), static_cast<float*>(tile_max),
      static_cast<int*>(tile_arg), n_th, n_tw);
  return static_cast<int>(cudaGetLastError());
}

// The refine of the n best tiles of each image: top_vals (float32) and
// top_idx (int64) rows of stride row_stride, sorted; writes xy [batch, n, 2],
// scores [batch, n], valid [batch, n] (bool) and max_resp [batch], the
// largest kept raw response (at least 0) from the NMS blocks' n_part partial
// maxima an image. One kernel launch.
extern "C" int detect_refine_launch(const void* resp, int batch, int h, int w,
                                    const void* peak, const void* part_n, int n_part,
                                    const void* top_vals, const void* top_idx,
                                    long long row_stride, int n, const void* tile_arg,
                                    int tile, int n_tiles, int n_tw, float quality, int subpix,
                                    void* xy, void* scores, void* valid, void* max_resp,
                                    void* stream) {
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((max(n, 1) + kRefineThreads - 1) / kRefineThreads, batch);
  detect_refine_kernel<<<grid, kRefineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(resp), h, w, static_cast<const float*>(peak),
      static_cast<const float*>(part_n), n_part, static_cast<const float*>(top_vals),
      static_cast<const int64_t*>(top_idx), row_stride, n, static_cast<const int*>(tile_arg),
      tile, n_tiles, n_tw, quality, subpix, inv_hash_mod(), static_cast<float*>(xy),
      static_cast<float*>(scores), static_cast<bool*>(valid), static_cast<float*>(max_resp));
  return static_cast<int>(cudaGetLastError());
}
