// Grouped f32 matrix product over the experts held on one card, for
// Hopper (sm_90a), CUDA C++: the dropless expert layer of AFMoE
// (src/repro_torch/models/moe.py::apply_routed_moe).
//
//     y[rows of g]  = x[rows of g] · w[g]        (grouped_mm_fwd<false>)
//     dx[rows of g] = dy[rows of g] · w[g]ᵀ      (grouped_mm_fwd<true>)
//     dw[g]         = x[rows of g]ᵀ · dy[rows of g]   (grouped_mm_wgrad)
//
// for the G groups, group g being rows [offs[g], offs[g+1]) of x, with the
// offsets an int32 array on the card, non-decreasing: the host never
// learns a group's size.  Rows outside every group ([0, offs[0]) and
// [offs[G], M)) are written as 0, and so is the weight gradient of an
// empty group.
//
// It ports no Pallas kernel: the JAX package's MoE multiplies a capacity
// buffer (E, C, d) by einsum and drops the tokens past capacity.  Without
// this kernel, dropless routing would need each expert's count on the host
// in every expert layer of every worker pass.
//
// What bounds it: f32 arithmetic outside the tensor cores (IEEE products,
// no TF32, as the configuration's dtype asks).  At the AFMoE cell's shapes
// (about 256 rows a group, d 2048, width 1024) a group's product does some
// 90 FLOPs a byte, above the ~20 at which the H100's f32 rate (67 TFLOP/s)
// and not HBM (3.35 TB/s) is the limit.  What the design does about it:
//
//  * A block of 256 threads owns a 128 x 128 tile of the output; a thread
//    owns 8 x 8 of it in registers (two 4-row by two 4-column quarters, so
//    that its shared-memory reads are 16 bytes and free of conflicts), and
//    does 64 fused multiply-adds for every four 16-byte shared loads.
//  * The K loop steps 8 at a time through two shared-memory stages: the
//    next step's tiles are loaded from device memory into registers while
//    the current stage is multiplied, then stored to the other stage.
//    Every operand is read with 16-byte loads; a row-major operand whose
//    contiguous axis is the reduction is transposed on its way to shared
//    memory (rows padded by 4 floats so that the stores do not conflict).
//  * The forward and dx grid is fixed by the shapes alone: blockIdx.y is a
//    slot, and a block finds its (group, 128-row tile) by walking the
//    offsets, ceil(rows / 128) tiles a group; the slots past the last
//    group's tiles zero the rows outside every group, and the rest exit.
//    ceil(M / 128) + G + 2 slots cover any offsets.
//  * dx reads w[g] in place as its transpose (no copy).
//  * The weights' gradient runs one block a 128 x 128 tile of one group's
//    dw (blockIdx.z the group), its K loop over the group's rows.
//
// Arguments: every operand f32 with rows 16-byte aligned (row strides and
// the widths K and N multiples of 4, 16-byte aligned pointers), the inner
// axis contiguous; offs G + 1 int32.  A launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;          // output rows a block
constexpr int BN = 128;          // output columns a block
constexpr int BK = 8;            // reduction step
constexpr int PAD = 4;           // floats a shared row is padded by

struct Stage {
  float a[BK][BM + PAD];
  float b[BK][BN + PAD];
};

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// One operand's (BK x 128) tile, element (k, i) of the step.  ROWS_ARE_I:
// the source holds it at src[i * ld + k] (row i, the reduction contiguous),
// so a thread loads 4 k of one i and stores them transposed; otherwise at
// src[k * ld + i], a thread loads 4 i of one k.  Valid where i < ni and
// k < nk; zero elsewhere.
template <bool ROWS_ARE_I>
struct Tile {
  const float* src;
  int64_t ld;
  int ni;
  int nk;

  __device__ __forceinline__ float4 fetch(int k0) const {
    const int t = threadIdx.x;
    if constexpr (ROWS_ARE_I) {
      const int i = t >> 1, k = k0 + (t & 1) * 4;
      return load4(src + i * ld + k, i < ni && k < nk);
    } else {
      const int k = k0 + (t >> 5), i = (t & 31) * 4;
      return load4(src + static_cast<int64_t>(k) * ld + i, i < ni && k < nk);
    }
  }

  __device__ __forceinline__ void put(float (*s)[BM + PAD], float4 v) const {
    const int t = threadIdx.x;
    if constexpr (ROWS_ARE_I) {
      const int i = t >> 1, k = (t & 1) * 4;
      s[k][i] = v.x;
      s[k + 1][i] = v.y;
      s[k + 2][i] = v.z;
      s[k + 3][i] = v.w;
    } else {
      *reinterpret_cast<float4*>(&s[t >> 5][(t & 31) * 4]) = v;
    }
  }
};

// acc (the thread's 8 x 8) = A (128 x nk) · B (nk x 128) over the reduction
// nk, both read through Tile.
template <bool A_ROWS, bool B_ROWS>
__device__ __forceinline__ void mainloop(const Tile<A_ROWS>& A, const Tile<B_ROWS>& B, int nk,
                                         Stage* st, float (&acc)[8][8]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (nk <= 0) return;
  float4 ra = A.fetch(0), rb = B.fetch(0);
  A.put(st[0].a, ra);
  B.put(st[0].b, rb);
  __syncthreads();
  const int steps = (nk + BK - 1) / BK;
  for (int s = 0; s < steps; ++s) {
    const Stage& cur = st[s & 1];
    const bool more = s + 1 < steps;
    if (more) {
      ra = A.fetch((s + 1) * BK);
      rb = B.fetch((s + 1) * BK);
    }
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&cur.a[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&cur.a[k][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&cur.b[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&cur.b[k][tx * 4 + 64]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      A.put(st[(s + 1) & 1].a, ra);
      B.put(st[(s + 1) & 1].b, rb);
    }
    __syncthreads();
  }
}

// Stores the thread's 8 x 8 (zeros when acc is null) into out (row stride
// ld) where row < nrows and column < ncols.
__device__ __forceinline__ void store_tile(float* out, int64_t ld, int nrows, int ncols,
                                           const float (*acc)[8]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 4 + (i & 3) + (i >> 2) * 64;
    if (r >= nrows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = tx * 4 + h * 64;
      if (c >= ncols) continue;
      const float4 v = acc ? make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                         acc[i][4 * h + 3])
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(out + r * ld + c) = v;
    }
  }
}

}  // namespace

// y (M, N) = x (M, K) · w[g] by groups of rows.  TRANS_W false: w[g] is
// (K, N) at w + g * swg, row stride ldw; true: w[g] is (N, K) and is read
// as its transpose.  Grid (ceil(N / BN), ceil(M / BM) + G + 2).
template <bool TRANS_W>
__global__ void __launch_bounds__(THREADS, 2)
    grouped_mm_fwd(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, const int* __restrict__ offs, int M, int K, int N,
                   int G, int64_t ldx, int64_t swg, int64_t ldw, int64_t ldy) {
  __shared__ __align__(16) Stage st[2];
  const int slot = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  int seen = 0, g = -1, row0 = 0, rows = 0;
  for (int e = 0; e < G; ++e) {
    const int lo = offs[e], hi = offs[e + 1];
    const int tiles = hi > lo ? (hi - lo + BM - 1) / BM : 0;
    if (slot < seen + tiles) {
      g = e;
      row0 = lo + (slot - seen) * BM;
      rows = min(BM, hi - row0);
      break;
    }
    seen += tiles;
  }
  if (g < 0) {
    // the rows outside every group: [0, offs[0]) then [offs[G], M)
    const int first = offs[0], last = offs[G];
    const int z = slot - seen, head = (first + BM - 1) / BM;
    if (z < head) {
      row0 = z * BM;
      rows = min(BM, first - row0);
    } else {
      row0 = last + (z - head) * BM;
      rows = min(BM, M - row0);
    }
    if (rows > 0) store_tile(y + row0 * ldy + n0, ldy, rows, N - n0, nullptr);
    return;
  }
  const Tile<true> A{x + row0 * ldx, ldx, rows, K};
  float acc[8][8];
  if constexpr (TRANS_W) {
    const Tile<true> B{w + g * swg + n0 * ldw, ldw, N - n0, K};
    mainloop(A, B, K, st, acc);
  } else {
    const Tile<false> B{w + g * swg + n0, ldw, N - n0, K};
    mainloop(A, B, K, st, acc);
  }
  store_tile(y + row0 * ldy + n0, ldy, rows, N - n0, acc);
}

// dw (G, K, N), contiguous: dw[g] = x[rows of g]ᵀ · dy[rows of g].  Grid
// (ceil(N / BN), ceil(K / BM), G).
__global__ void __launch_bounds__(THREADS, 2)
    grouped_mm_wgrad(const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ dw, const int* __restrict__ offs, int K, int N,
                     int64_t ldx, int64_t ldd) {
  __shared__ __align__(16) Stage st[2];
  const int g = blockIdx.z;
  const int k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lo = offs[g], rows = max(0, offs[g + 1] - lo);
  const Tile<false> A{x + lo * ldx + k0, ldx, K - k0, rows};
  const Tile<false> B{dy + lo * ldd + n0, ldd, N - n0, rows};
  float acc[8][8];
  mainloop(A, B, rows, st, acc);
  store_tile(dw + (static_cast<int64_t>(g) * K + k0) * N + n0, N, K - k0, N - n0, acc);
}

extern "C" int grouped_mm_launch(const void* x, const void* w, void* y, const void* offs,
                                 int M, int K, int N, int G, long long ldx, long long swg,
                                 long long ldw, long long ldy, int trans_w, void* stream) {
  if (M < 0 || K < 0 || N < 0 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM + G + 2);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const int* o = static_cast<const int*>(offs);
  if (trans_w)
    grouped_mm_fwd<true><<<grid, THREADS, 0, s>>>(xf, wf, static_cast<float*>(y), o, M, K, N, G,
                                                  ldx, swg, ldw, ldy);
  else
    grouped_mm_fwd<false><<<grid, THREADS, 0, s>>>(xf, wf, static_cast<float*>(y), o, M, K, N,
                                                   G, ldx, swg, ldw, ldy);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grouped_mm_wgrad_launch(const void* x, const void* dy, void* dw, const void* offs,
                                       int K, int N, int G, long long ldx, long long ldd,
                                       void* stream) {
  if (K < 0 || N < 0 || G < 1 || G > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (K + BM - 1) / BM, G);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  grouped_mm_wgrad<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dw),
      static_cast<const int*>(offs), K, N, ldx, ldd);
  return static_cast<int>(cudaGetLastError());
}
