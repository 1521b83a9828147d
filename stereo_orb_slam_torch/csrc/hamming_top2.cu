// Hamming distance + running top-2 over packed 256-bit descriptors, on the
// tensor cores, for one query set against one or two train sets per launch,
// for a batch of B such problems (B sequences of a multi-sequence step).
//
// Replaces the TPU kernel `hamming_top2` (body `_kernel`) of
// the JAX package's ops/pallas/hamming.py. Same function: for every query
// row, the smallest and second-smallest Hamming distance to the train rows
// (a multiset top-2, so d2 == d1 when the best distance repeats) and the
// lowest train index attaining the smallest. Invalid train rows take part
// at distance 257; outputs are clamped to 257, so an all-invalid or empty
// train set gives (257, 0, 257). Query validity is the caller's. With two
// train sets (the stereo and the temporal match of a frame, which share
// their query set) the launch computes both results; neither depends on
// the other.
//
// What bounds it on an H100: at N = M = 1024 and two sets the function is
// 2 x 2*N*M*256 bit operations, about half a microsecond at the int8 tensor
// rate, and it moves about 100 KB. A launch costs more than either, so the
// design aims at one short wave of blocks.
//
// Design: `mma.sync.m16n8k256.b1.and.popc` gives popc(q & t) for a 16 x 8
// tile of query x train rows at the full depth of 256 bits in one
// instruction, and the distance is popc(q) + popc(t) - 2 popc(q & t), with
// the query rows' popcounts taken once per block and a train row's once
// per tile. (`.and` is used, not `.xor`, which not every recent target
// offers.) A
// popcount ignores the order of the bits, so the only layout rule is that
// A and B hold the same descriptor word for the same k-chunk: a lane with
// groupID g and thread-in-group c holds words c and c + 4 of query rows g
// and g + 8 (A) and of train row g of the tile (B).
// A block takes 16 query rows of one set (gridDim.y is the set) of one
// batch entry (gridDim.z is the batch) and all of that set's train rows;
// its 8 warps take the 8-row tiles in turn (warp w takes tiles w, w + 8,
// ...). Each train word is read by one warp of a block only, so the tiles
// are loaded straight into registers, 16 tiles' loads issued together to
// cover the L2 latency, and not staged in shared memory. At N = 1024 and
// two sets that is 128 blocks, one wave on 132 SMs; a batch of B is B
// times that, in the same launch. The batch entries are independent and
// stored one after another: entry b of the queries starts at row b * n,
// of set s's train rows and mask at row b * m_s, and its results are row
// s * B + b of the [sets * B, n] outputs. B = 1 is the unbatched launch.
// The epilogue keeps a running (d1, i1, d2) per lane for its two
// accumulator rows, visiting its columns in ascending order with strict
// `<`; the 4 lanes of a quad merge with shuffles and the 8 warps through
// shared memory, ties going to the lower index. The [N, M] matrix never
// exists.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;     // 32-bit words per descriptor
constexpr int kRows = 16;     // query rows per block: the MMA's M
constexpr int kCols = 8;      // train rows per tile: the MMA's N
constexpr int kWarps = 8;
constexpr int kBatch = 16;    // tiles per warp whose loads are issued together
constexpr int kMaxSets = 2;
constexpr int kBig = 257;     // distance of an invalid train row
constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

struct Top2 {
  int d1, i1, d2;
};

struct TrainSets {
  const uint32_t* t[kMaxSets];
  const uint8_t* valid[kMaxSets];
  int m[kMaxSets];
};

// Merge two top-2 states over disjoint column sets; ties go to the lower
// index, and an equal best distance makes the second equal to it.
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  if (b.d1 < a.d1) {
    return Top2{b.d1, b.i1, min(a.d1, b.d2)};
  }
  if (b.d1 == a.d1) {
    return Top2{a.d1, min(a.i1, b.i1), a.d1};
  }
  return Top2{a.d1, a.i1, min(a.d2, b.d1)};
}

__device__ __forceinline__ Top2 merge_lanes(Top2 s, int offset) {
  Top2 o{__shfl_xor_sync(kFull, s.d1, offset), __shfl_xor_sync(kFull, s.i1, offset),
         __shfl_xor_sync(kFull, s.d2, offset)};
  return merge(s, o);
}

// Columns arrive in ascending order, so strict `<` keeps the lowest index.
__device__ __forceinline__ void push(Top2& s, int d, int i) {
  if (d < s.d1) {
    s.d2 = s.d1;
    s.d1 = d;
    s.i1 = i;
  } else if (d < s.d2) {
    s.d2 = d;
  }
}

// c = popc(a & b) for the 16 x 8 tile, depth 256.
__device__ __forceinline__ void mma_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0), "r"(0),
        "r"(0), "r"(0));
}

__global__ void __launch_bounds__(kWarps * 32)
hamming_top2_kernel(const uint32_t* __restrict__ q, int n, TrainSets sets,
                    float* __restrict__ d1_out, int* __restrict__ i1_out,
                    float* __restrict__ d2_out) {
  __shared__ Top2 part[kWarps][kRows];

  // Selected, not indexed by blockIdx.y, so the parameters stay out of
  // local memory.
  const int set = blockIdx.y;
  const int batch = blockIdx.z;
  const int m = set == 0 ? sets.m[0] : sets.m[1];
  const uint32_t* __restrict__ t =
      (set == 0 ? sets.t[0] : sets.t[1]) + (size_t)batch * m * kWords;
  const uint8_t* __restrict__ valid =
      (set == 0 ? sets.valid[0] : sets.valid[1]) + (size_t)batch * m;
  q += (size_t)batch * n * kWords;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // groupID
  const int c = lane % 4;  // thread in group
  const int row_a = blockIdx.x * kRows + g;
  const int row_b = row_a + 8;

  uint32_t a[4];
  a[0] = row_a < n ? q[(size_t)row_a * kWords + c] : 0u;
  a[1] = row_b < n ? q[(size_t)row_b * kWords + c] : 0u;
  a[2] = row_a < n ? q[(size_t)row_a * kWords + c + 4] : 0u;
  a[3] = row_b < n ? q[(size_t)row_b * kWords + c + 4] : 0u;
  int pop_a = __popc(a[0]) + __popc(a[2]);
  int pop_b = __popc(a[1]) + __popc(a[3]);
  pop_a += __shfl_xor_sync(kFull, pop_a, 1);
  pop_a += __shfl_xor_sync(kFull, pop_a, 2);
  pop_b += __shfl_xor_sync(kFull, pop_b, 1);
  pop_b += __shfl_xor_sync(kFull, pop_b, 2);

  Top2 sa{kInf, 0, kInf};
  Top2 sb{kInf, 0, kInf};
  const int tiles = (m + kCols - 1) / kCols;
  for (int first = warp; first < tiles; first += kWarps * kBatch) {
    uint32_t b[kBatch][2];
    bool ok[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int col = (first + k * kWarps) * kCols + g;
      const bool in = col < m;
      b[k][0] = in ? t[(size_t)col * kWords + c] : 0u;
      b[k][1] = in ? t[(size_t)col * kWords + c + 4] : 0u;
      ok[k] = in && valid[col];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int tile = first + k * kWarps;
      if (tile >= tiles) break;  // uniform over the warp
      int acc[4];
      mma_and_popc(acc, a, b[k][0], b[k][1]);
      // Popcount of train row g of the tile (-1 if invalid), then the
      // values of the two columns this lane's accumulators hold.
      int pop_t = __popc(b[k][0]) + __popc(b[k][1]);
      pop_t += __shfl_xor_sync(kFull, pop_t, 1);
      pop_t += __shfl_xor_sync(kFull, pop_t, 2);
      pop_t = ok[k] ? pop_t : -1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cj = 2 * c + j;
        const int p = __shfl_sync(kFull, pop_t, cj * 4);
        const int col = tile * kCols + cj;
        if (col < m) {
          push(sa, p < 0 ? kBig : pop_a + p - 2 * acc[j], col);
          push(sb, p < 0 ? kBig : pop_b + p - 2 * acc[2 + j], col);
        }
      }
    }
  }

  sa = merge_lanes(merge_lanes(sa, 1), 2);
  sb = merge_lanes(merge_lanes(sb, 1), 2);
  if (c == 0) {
    part[warp][g] = sa;
    part[warp][g + 8] = sb;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int row = blockIdx.x * kRows + threadIdx.x;
    if (row < n) {
      Top2 r = part[0][threadIdx.x];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) r = merge(r, part[k][threadIdx.x]);
      const size_t o = ((size_t)set * gridDim.z + batch) * n + row;
      d1_out[o] = (float)min(r.d1, kBig);
      i1_out[o] = r.i1;
      d2_out[o] = (float)min(r.d2, kBig);
    }
  }
}

}  // namespace

// One launch for `num_sets` (1 or 2) train sets against the same n query
// rows, for `batch` independent problems: queries [batch, n, 8], set s's
// train rows [batch, m_s, 8] and mask [batch, m_s]; outputs are
// [num_sets, batch, n], set-major. Set 1's pointers are ignored when
// num_sets is 1. Returns the cudaError_t of the launch (0 on success).
// n and batch must be > 0.
extern "C" int hamming_top2_launch(const void* q, int n, int batch, int num_sets,
                                   const void* t0, const void* valid0, int m0,
                                   const void* t1, const void* valid1, int m1, void* d1,
                                   void* i1, void* d2, void* stream) {
  if (num_sets < 1 || num_sets > kMaxSets || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TrainSets sets;
  sets.t[0] = static_cast<const uint32_t*>(t0);
  sets.valid[0] = static_cast<const uint8_t*>(valid0);
  sets.m[0] = m0;
  sets.t[1] = static_cast<const uint32_t*>(t1);
  sets.valid[1] = static_cast<const uint8_t*>(valid1);
  sets.m[1] = m1;
  dim3 grid((n + kRows - 1) / kRows, num_sets, batch);
  hamming_top2_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), n, sets, static_cast<float*>(d1),
      static_cast<int*>(i1), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}
