// Backward of causal GQA flash attention with an optional sliding window,
// for Hopper (sm_90a), CUDA C++.
//
// Replaces the reference's gradient of attention: XLA's autodiff of
// src/repro/models/attention.py::blocked_attention (the Pallas kernel
// flash_attention has no backward).  q, o, do: (B, S, H, hd); k, v: (B, S,
// KV, hd) with H % KV == 0, query head h reading kv head h / (H / KV); f32
// or bf16, hd 32, 64 or 128, read in their strides (the head dim
// contiguous).  With s = scale q k^T under the forward's masks (k <= q when
// causal, k > q - window when window > 0, positions 0..S-1), the
// FlashAttention-2 backward:
//
//     L_i = logsumexp_j s_ij,   D_i = dO_i . O_i,   P = exp(s - L)
//     dV = P^T dO,   dP = dO V^T,   dS = P . (dP - D),
//     dK = scale dS^T Q,   dQ = scale dS K,
//
// dK and dV summed over the H / KV query heads of each kv head.  dq (B, S,
// H, hd) and dk, dv (B, S, KV, hd) come out in q's type.  L comes from the
// forward (flash_attention.cu writes it when given a pointer); without it
// a pre-pass rebuilds it by streaming K again.  D is a pre-pass bound by
// bytes.  No float atomics and no (S, S) tensor in device memory: every
// sum runs in a fixed order, so two calls on the same inputs give the same
// bits.  Rows and keys past S are zeros and masked, so S need not be a
// multiple of a tile.
//
// What bounds it on this card: the causal pairs need five products of
// 2 hd flops each (Q K^T, dO V^T, dV, dK, dQ; the first two run in both
// kernels below, the price of having no atomics).  At phi4-mini's prefill,
// (4, 1024, 24, 8, 128) in bf16, 6.4e10 flops are 65 us at the 989 TFLOP/s
// tensor-core rate, against 67 MB of q, k, v, o, do and the gradients,
// 20 us at 3.35 TB/s; at its train shape (2, 512, 24, 8, 128) in f32,
// 8.1e9 flops are 0.12 ms at the 67 TFLOP/s FMA rate.  Operations bound
// both, so bf16 must run on the tensor cores and f32 must keep the FMA
// pipe fed.  Two bodies; the route is the forward's, a fixed function of
// (dtype, hd) chosen by the wrapper, with no fallback between them:
//
//   bf16, hd 64 or 128 -> tc:: (wgmma + TMA);
//   f32 at any hd, bf16 at hd 32 -> simt:: (f32 FMAs on the CUDA cores;
//   the train path runs f32 with TF32 off, so no tensor cores there).
//
// tc::dkdv_kernel and tc::dq_kernel, what the design does:
//  * A block owns 128 rows (two consumer warpgroups of 64, wgmma's M) and
//    a producer warpgroup streams 64-row tiles through a ring of four
//    shared-memory stages, each with a full and an empty mbarrier, by TMA
//    (the forward's 4-d maps over (hd, heads, S, B), 128-byte swizzle).
//    384 threads start at 168 registers; the producer gives all but 24
//    back (setmaxnreg) and each consumer thread takes 240.
//  * dK/dV: a block per (128-row k tile, kv head, batch), K and V loaded
//    once; the stream covers each head of the GQA group and each q tile
//    that reaches the k tile (from the diagonal down when causal, a band
//    under a window), with the tile's rows of L (times log2 e) and D,
//    which a second producer warp copies in.  Each warpgroup works in the
//    transposed frame: S^T = K Q^T and dP^T = V dO^T (m64n64k16, both
//    operands K-major), P^T = 2^(S^T scale log2e - L log2e) masked, dS^T =
//    P^T (dP^T - D), then dV += P^T dO and dK += dS^T Q (m64n{hd}k16) with
//    P^T and dS^T in bf16 as the A operand straight from registers (the
//    accumulator layout is the A-register layout, as in the forward's
//    P V) and dO, Q as N-major B operands (transpose bit set).  The sum
//    over the group stays in registers; k tile 0, which the most q tiles
//    reach, is handed out first.
//  * dQ: a block per (128-row q tile, head, batch), Q and dO loaded once,
//    K/V tiles streamed: S = Q K^T, dP = dO V^T, dS, then dQ += dS K with
//    K as the N-major B operand.  Longest q tiles first.
//  * Each product is its own commit group, so the elementwise work runs
//    under the next product: the exponentials of P under dP's product,
//    and (dK/dV) dS under dV += P^T dO.  At the prefill shape this took
//    the two kernels from 0.287 to 0.258 ms (CUDA-graph replays, H100).
//  * Only tiles on the diagonal, at the window's edge or past S run the
//    mask; a warpgroup skips a tile wholly masked for its rows.  A wait on
//    an mbarrier that spins for about 10 s traps.
//
// simt::grad_kernel (dkdv_block, dq_block), what the design does:
//  * 128 threads; thread (ty, tx) = (tid / 8, tid % 8) holds a 4 x 4 score
//    tile (rows ty + 16 i, columns tx + 8 j) of the block's 64 x 32 tile,
//    and rows ty + 16 i, columns 4 tx + 32 c .. + 3 of its 64 x hd
//    accumulators, so every shared-memory read is a float4 and a product
//    step issues two FMAs a load or more.
//  * Shared-memory tiles are f32 with an unpadded pitch and the float4
//    groups of row r permuted by r & 7 (an XOR swizzle): the reads above
//    are free of bank conflicts, and each block fits in 113 KB, so two
//    blocks share an SM.
//  * dK/dV: a block per (64-row k tile, query head, batch), not per kv
//    head: three times the blocks, each a third as long, handed out
//    longest first (a block per kv head at the train shape made 128 blocks
//    for 132 SMs, the longest 1.8x the mean).  Each writes its head's dK
//    and dV in f32, and a small pass sums the group's heads in a fixed
//    order (with one head a group the block writes the result itself).
//    Q is pre-scaled.
//  * dQ: a block per (64-row q tile, head, batch), longest first.
//  * The dK/dV blocks and then the dQ blocks run as one launch, so the
//    dQ blocks fill the SMs the dK/dV blocks' tail leaves idle.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

struct Strides {
  long long b, s, h;   // elements; the head dim is contiguous
};

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Mask {
  int S, causal, window;
  __device__ __forceinline__ bool ok(int qi, int kj) const {
    return qi < S && kj < S && (!causal || kj <= qi) &&
           (window <= 0 || kj > qi - window);
  }
  // the first and one past the last k position a q tile of `rows` reaches
  // (the first rounded down to a multiple of `step`)
  __device__ __forceinline__ int k_begin(int q0, int step) const {
    return window > 0 ? max(0, q0 - window + 1) / step * step : 0;
  }
  __device__ __forceinline__ int k_end(int q0, int rows) const {
    return causal ? min(S, q0 + rows) : S;
  }
  // the first and one past the last q position that reaches a k tile
  __device__ __forceinline__ int q_begin(int k0) const {
    return causal ? k0 : 0;
  }
  __device__ __forceinline__ int q_end(int k0, int rows) const {
    return window > 0 ? min(S, k0 + rows - 1 + window) : S;
  }
};

// ==========================================================================
// Pre-passes: D, or L and D
// ==========================================================================

// D (B, H, S) = rowsum(dO . O) in f32: one warp a (b, s, h) row, lanes over
// the head dim, a fixed shuffle tree.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
attn_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ D, int S, int H, Strides so, Strides sdo,
               long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int h = static_cast<int>(row % H);
  const int s = static_cast<int>((row / H) % S);
  const long long b = row / H / S;
  const T* op = o + b * so.b + s * so.s + h * so.h;
  const T* dp = dout + b * sdo.b + s * sdo.s + h * sdo.h;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32)
    acc = fmaf(to_f32(op[c]), to_f32(dp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[(b * H + h) * S + s] = acc;
}

// L and D when the caller has no L from the forward: one block of 256
// threads per (64-row q tile, head, batch) streams the k tiles that reach
// its rows, as the forward does, for each row's online max and sum.
namespace lse_pass {

constexpr int BT = 64, THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr int smem_bytes() { return 2 * BT * (HD + 4) * 4; }

// A 64 x HD tile of rows row0.. of one head into shared memory (pitch
// HD + 4) in f32, times `mul`; rows past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int S, float mul) {
  for (int idx = threadIdx.x; idx < BT * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD, g = row0 + r;
    dst[r * (HD + 4) + c] = g < S ? to_f32(src[g * row_stride + c]) * mul
                                  : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_bwd_pre(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ L, float* __restrict__ D, int H, int groups,
             Strides sq, Strides sk, Strides so, Strides sdo, Mask mask,
             float scale) {
  constexpr int P = HD + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BT * P;
  const int S = mask.S;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + b * sk.b + (h / groups) * sk.h;
  load_tile<T, HD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);

  {   // D: four threads a row over o and do
    const int r = tid >> 2, part = tid & 3, qi = q0 + r;
    float acc = 0.f;
    if (qi < S) {
      const T* op = o + b * so.b + h * so.h + qi * so.s;
      const T* dp = dout + b * sdo.b + h * sdo.h + qi * sdo.s;
      for (int c = part; c < HD; c += 4)
        acc = fmaf(to_f32(op[c]), to_f32(dp[c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (qi < S && part == 0) D[((long long)b * H + h) * S + qi] = acc;
  }

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = NEG_INF; l[i] = 0.f; }
  for (int k0 = mask.k_begin(q0, BT); k0 < mask.k_end(q0, BT); k0 += BT) {
    __syncthreads();              // the last tile's reads are done
    load_tile<T, HD>(Ks, kb, sk.s, k0, S, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 b4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b4[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * P + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * P + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a.x, b4[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, b4[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, b4[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, b4[j].w, s[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = mask.ok(qi, k0 + tx + 16 * j);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[j]) sum += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < S && tx == 0)
      L[((long long)b * H + h) * S + qi] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

}  // namespace lse_pass

// Everything a launch needs, as the entries receive it.
struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  const float* lse;        // the forward's L, or null
  float *L, *D;            // L: scratch when lse is null; D: scratch
  int B, S, H, KV;
  Strides sq, sk, sv, so, sdo;
  Mask mask;
  float scale;
};

template <typename K>
int allow_smem(K kern, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(e);
}

// D, and L where the forward gave none; returns the L to use.
template <typename T, int HD>
int pre_pass(const Args& a, const float** L, cudaStream_t stream) {
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  if (a.lse != nullptr) {
    const long long rows = static_cast<long long>(a.B) * a.S * a.H;
    attn_bwd_delta<T, HD><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                            stream>>>(o, dout, a.D, a.S, a.H, a.so, a.sdo,
                                      rows);
    *L = a.lse;
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int bytes = lse_pass::smem_bytes<HD>();
  static bool attr_set = false;      // once per instance
  if (!attr_set) {
    const int e = allow_smem(lse_pass::attn_bwd_pre<T, HD>, bytes);
    if (e != 0) return e;
    attr_set = true;
  }
  const int tiles = (a.S + lse_pass::BT - 1) / lse_pass::BT;
  lse_pass::attn_bwd_pre<T, HD>
      <<<dim3(tiles, a.H, a.B), lse_pass::THREADS, bytes, stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), o, dout,
          a.L, a.D, a.H, a.H / a.KV, a.sq, a.sk, a.so, a.sdo, a.mask,
          a.scale);
  *L = a.L;
  return static_cast<int>(cudaGetLastError());
}

// ==========================================================================
// simt: f32 at any hd, bf16 at hd 32
// ==========================================================================

namespace simt {

constexpr int THREADS = 128;
constexpr int OWN = 64;       // rows a block owns: k rows (dK/dV), q (dQ)
constexpr int STREAM = 32;    // rows of a streamed tile

// Offset of element (r, c) in a swizzled f32 tile of pitch W: the float4
// group c / 4 of row r sits at group (c / 4) ^ (r & 7).
template <int W>
__device__ __forceinline__ int sw(int r, int c) {
  return r * W + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p, bool vec);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                       __high2float(hi));
  }
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}

// ROWS x HD rows row0.. of one head into a swizzled f32 tile, times `mul`;
// rows past S are zeros.  `vec`: every group of four elements is aligned
// for one vector load.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int S, float mul, bool vec) {
  constexpr int G = HD / 4;
  for (int idx = threadIdx.x; idx < ROWS * G; idx += THREADS) {
    const int r = idx / G, g = idx % G, gr = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < S) {
      x = load4<T>(src + gr * row_stride + 4 * g, vec);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    *reinterpret_cast<float4*>(&dst[r * HD + ((g ^ (r & 7)) << 2)]) = x;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] B[tx + 8 j][d]: A (OWN rows) and B
// (STREAM rows) swizzled tiles of pitch HD.
template <int HD>
__device__ __forceinline__ void nt_product(float (&acc)[4][4], const float* A,
                                           const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int g = 0; g < HD / 4; ++g) {
    float4 b4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)      // (tx + 8 j) & 7 == tx
      b4[j] = *reinterpret_cast<const float4*>(
          &B[(tx + 8 * j) * HD + ((g ^ tx) << 2)]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {    // (ty + 16 i) & 7 == ty & 7
      const float4 a = *reinterpret_cast<const float4*>(
          &A[(ty + 16 * i) * HD + ((g ^ (ty & 7)) << 2)]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a.x, b4[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b4[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b4[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b4[j].w, acc[i][j]);
      }
    }
  }
}

// acc[i][c] (columns 4 tx + 32 c .. + 3) += sum_r A[ty + 16 i][r] B[r][..]:
// A an OWN x STREAM swizzled tile, B a STREAM x HD swizzled tile.
template <int HD>
__device__ __forceinline__ void nn_accumulate(float4 (&acc)[4][HD / 32],
                                              const float* A, const float* B,
                                              int ty, int tx) {
#pragma unroll 2
  for (int g = 0; g < STREAM / 4; ++g) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(
          &A[(ty + 16 * i) * STREAM + ((g ^ (ty & 7)) << 2)]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 4 * g + u;
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(
            &B[r * HD + (((tx + 8 * c) ^ (r & 7)) << 2)]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = u == 0 ? a[i].x : u == 1 ? a[i].y
                        : u == 2 ? a[i].z : a[i].w;
          acc[i][c].x = fmaf(w, b.x, acc[i][c].x);
          acc[i][c].y = fmaf(w, b.y, acc[i][c].y);
          acc[i][c].z = fmaf(w, b.z, acc[i][c].z);
          acc[i][c].w = fmaf(w, b.w, acc[i][c].w);
        }
      }
    }
  }
}

template <int HD>
constexpr int dkdv_bytes() {
  return 4 * (2 * OWN * HD + 2 * STREAM * HD + 2 * OWN * STREAM + 2 * STREAM);
}
template <int HD>
constexpr int dq_bytes() {
  return 4 * (2 * OWN * HD + 2 * STREAM * HD + OWN * STREAM + 2 * OWN);
}

// Rows ty + 16 i of a 64-row accumulator pair into out (B, S, heads, hd),
// packed, at head `head`, for rows < S; times `mul`.
template <typename O, int HD>
__device__ __forceinline__ void store_rows(O* __restrict__ out,
                                           const float4 (&acc)[4][HD / 32],
                                           int b, int S, int heads, int head,
                                           int row0, float mul, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= S) continue;
    O* p = out + ((static_cast<long long>(b) * S + r) * heads + head) * HD;
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) {
      const int col = 4 * tx + 32 * c;
      p[col] = from_f32<O>(acc[i][c].x * mul);
      p[col + 1] = from_f32<O>(acc[i][c].y * mul);
      p[col + 2] = from_f32<O>(acc[i][c].z * mul);
      p[col + 3] = from_f32<O>(acc[i][c].w * mul);
    }
  }
}

// dK and dV of one head h for one 64-row k tile (block `blk` of the
// dK/dV blocks): written to (dk, dv) at head out_head of out_heads, in O
// (the result when the group has one head; f32 partials for the group sum
// otherwise).
template <typename T, int HD, typename O>
__device__ __forceinline__ void dkdv_block(
    int blk, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ L, const float* __restrict__ D,
    O* __restrict__ dk, O* __restrict__ dv, int B, int H, int KV,
    int partial, Strides sq, Strides sk, Strides sv, Strides sdo, Mask mask,
    float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + OWN * HD;
  float* Qs = Vs + OWN * HD;
  float* dOs = Qs + STREAM * HD;
  float* Pt = dOs + STREAM * HD;
  float* dSt = Pt + OWN * STREAM;
  float* Ls = dSt + OWN * STREAM;
  float* Ds = Ls + STREAM;
  const int S = mask.S, groups = H / KV;
  // k tile 0, which the most q tiles reach under a causal mask, first
  const int kt = blk / (B * H), bh = blk % (B * H);
  const int b = bh / H, h = bh % H, kvh = h / groups;
  const int k0 = kt * OWN;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  load_tile<T, HD, OWN>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S, 1.f,
                        vec);
  load_tile<T, HD, OWN>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S, 1.f,
                        vec);
  const T* qh = q + b * sq.b + h * sq.h;
  const T* doh = dout + b * sdo.b + h * sdo.h;
  const float* Lh = L + (static_cast<long long>(b) * H + h) * S;
  const float* Dh = D + (static_cast<long long>(b) * H + h) * S;

  float4 adv[4][HD / 32], adk[4][HD / 32];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 32; ++c)
      adv[i][c] = adk[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int qe = mask.q_end(k0, OWN);
  for (int q0 = mask.q_begin(k0); q0 < qe; q0 += STREAM) {
    __syncthreads();            // the last turn's reads are done
    load_tile<T, HD, STREAM>(Qs, qh, sq.s, q0, S, scale, vec);
    load_tile<T, HD, STREAM>(dOs, doh, sdo.s, q0, S, 1.f, vec);
    if (tid < STREAM) {
      const int qi = q0 + tid;
      Ls[tid] = qi < S ? Lh[qi] : 0.f;
      Ds[tid] = qi < S ? Dh[qi] : 0.f;
    }
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T: rows k0 + ty + 16 i, columns (q)
    // q0 + tx + 8 j
    float s[4][4], dp[4][4];
    nt_product<HD>(s, Ks, Qs, ty, tx);
    nt_product<HD>(dp, Vs, dOs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        const float p =
            mask.ok(q0 + c, k0 + r) ? expf(s[i][j] - Ls[c]) : 0.f;
        Pt[sw<STREAM>(r, c)] = p;
        dSt[sw<STREAM>(r, c)] = p * (dp[i][j] - Ds[c]);
      }
    }
    __syncthreads();
    nn_accumulate<HD>(adv, Pt, dOs, ty, tx);
    nn_accumulate<HD>(adk, dSt, Qs, ty, tx);
  }
  const int heads = partial ? H : KV, head = partial ? h : kvh;
  store_rows<O, HD>(dk, adk, b, S, heads, head, k0, 1.f, ty, tx);
  store_rows<O, HD>(dv, adv, b, S, heads, head, k0, 1.f, ty, tx);
}

// out (B, S, KV, hd) = the sum over g < groups, in order, of part (B, S,
// H, hd) at head kvh * groups + g; blockIdx.y picks dK or dV.
template <typename T>
__global__ void __launch_bounds__(256)
group_sum(const float* __restrict__ pk, const float* __restrict__ pv,
          T* __restrict__ dk, T* __restrict__ dv, long long quads,
          int groups, int hd) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= quads) return;
  const float* part = blockIdx.y == 0 ? pk : pv;
  T* out = blockIdx.y == 0 ? dk : dv;
  const int qpr = hd / 4;                    // quads a (b, s, kvh) row
  const long long row = i / qpr;             // (b, s, kvh)
  const float4* src = reinterpret_cast<const float4*>(part) +
                      row * groups * qpr + i % qpr;
  float4 acc = src[0];
  for (int g = 1; g < groups; ++g) {
    const float4 x = src[g * qpr];
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  T* o = out + 4 * i;
  o[0] = from_f32<T>(acc.x);
  o[1] = from_f32<T>(acc.y);
  o[2] = from_f32<T>(acc.z);
  o[3] = from_f32<T>(acc.w);
}

// dQ of one head for one 64-row q tile (block `blk` of the dQ blocks).
template <typename T, int HD>
__device__ __forceinline__ void dq_block(
    int blk, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ L, const float* __restrict__ D,
    T* __restrict__ dq, int B, int H, int groups, Strides sq, Strides sk,
    Strides sv, Strides sdo, Mask mask, float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + OWN * HD;
  float* Ks = dOs + OWN * HD;
  float* Vs = Ks + STREAM * HD;
  float* dSs = Vs + STREAM * HD;
  float* Ls = dSs + OWN * STREAM;
  float* Ds = Ls + OWN;
  const int S = mask.S;
  const int n_qt = (S + OWN - 1) / OWN;
  // the longest q tiles first
  const int qt = n_qt - 1 - blk / (B * H);
  const int bh = blk % (B * H);
  const int b = bh / H, h = bh % H, kvh = h / groups;
  const int q0 = qt * OWN;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  load_tile<T, HD, OWN>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale,
                        vec);
  load_tile<T, HD, OWN>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                        1.f, vec);
  if (tid < OWN) {
    const int qi = q0 + tid;
    const long long at = (static_cast<long long>(b) * H + h) * S + qi;
    Ls[tid] = qi < S ? L[at] : 0.f;
    Ds[tid] = qi < S ? D[at] : 0.f;
  }
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  float4 acc[4][HD / 32];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 32; ++c)
      acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int ke = mask.k_end(q0, OWN);
  for (int k0 = mask.k_begin(q0, STREAM); k0 < ke; k0 += STREAM) {
    __syncthreads();              // the last tile's reads are done
    load_tile<T, HD, STREAM>(Ks, kb, sk.s, k0, S, 1.f, vec);
    load_tile<T, HD, STREAM>(Vs, vb, sv.s, k0, S, 1.f, vec);
    __syncthreads();
    float s[4][4], dp[4][4];
    nt_product<HD>(s, Qs, Ks, ty, tx);
    nt_product<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        const float p =
            mask.ok(q0 + r, k0 + c) ? expf(s[i][j] - Ls[r]) : 0.f;
        dSs[sw<STREAM>(r, c)] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();
    nn_accumulate<HD>(acc, dSs, Ks, ty, tx);
  }
  store_rows<T, HD>(dq, acc, b, S, H, h, q0, scale, ty, tx);
}

// The dK/dV blocks, then the dQ blocks, each longest first, in one launch:
// the dQ blocks take the SMs that the dK/dV blocks' tail leaves idle.
template <typename T, int HD, typename O>
__global__ void __launch_bounds__(THREADS, 2)
grad_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ L, const float* __restrict__ D,
            O* __restrict__ dk, O* __restrict__ dv, T* __restrict__ dq,
            int B, int H, int KV, int partial, Strides sq, Strides sk,
            Strides sv, Strides sdo, Mask mask, float scale, int vec,
            int kv_blocks) {
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < kv_blocks)
    dkdv_block<T, HD, O>(blk, q, k, v, dout, L, D, dk, dv, B, H, KV, partial,
                         sq, sk, sv, sdo, mask, scale, vec);
  else
    dq_block<T, HD>(blk - kv_blocks, q, k, v, dout, L, D, dq, B, H, H / KV,
                    sq, sk, sv, sdo, mask, scale, vec);
}

template <typename T, int HD>
int launch(const Args& a, float* pk, float* pv, int vec,
           cudaStream_t stream) {
  const float* L = nullptr;
  int e = pre_pass<T, HD>(a, &L, stream);
  if (e != 0) return e;
  constexpr int bytes = dkdv_bytes<HD>() > dq_bytes<HD>() ? dkdv_bytes<HD>()
                                                          : dq_bytes<HD>();
  const bool partial = a.H != a.KV;
  static bool attr_set = false;      // once per instance
  if (!attr_set) {
    e = allow_smem(grad_kernel<T, HD, float>, bytes);
    if (e == 0) e = allow_smem(grad_kernel<T, HD, T>, bytes);
    if (e != 0) return e;
    attr_set = true;
  }
  const int S = a.mask.S, tiles = (S + OWN - 1) / OWN;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  const int blocks = tiles * a.B * a.H;     // of each kind
  const unsigned grid = 2u * static_cast<unsigned>(blocks);
  if (partial) {
    if (pk == nullptr || pv == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    grad_kernel<T, HD, float><<<grid, THREADS, bytes, stream>>>(
        q, k, v, dout, L, a.D, pk, pv, dq, a.B, a.H, a.KV, 1, a.sq, a.sk,
        a.sv, a.sdo, a.mask, a.scale, vec, blocks);
    e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
    const long long quads = static_cast<long long>(a.B) * S * a.KV * HD / 4;
    group_sum<T><<<dim3(static_cast<unsigned>((quads + 255) / 256), 2), 256,
                   0, stream>>>(pk, pv, static_cast<T*>(a.dk),
                                static_cast<T*>(a.dv), quads, a.H / a.KV,
                                HD);
  } else {
    grad_kernel<T, HD, T><<<grid, THREADS, bytes, stream>>>(
        q, k, v, dout, L, a.D, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        dq, a.B, a.H, a.KV, 0, a.sq, a.sk, a.sv, a.sdo, a.mask, a.scale, vec,
        blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ==========================================================================
// tc: bf16 at hd 64 and 128, wgmma + TMA
// ==========================================================================

namespace tc {

using namespace tma;
using namespace tcore;

constexpr int OWN = 128;             // rows a block owns: two warpgroups
constexpr int STREAM = 64;           // rows of a streamed tile
constexpr int STAGES = 4;            // ring depth
constexpr int BOX_COLS = 64;         // 128 bytes of bf16: the swizzle span
constexpr int ROW_BYTES = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // + a producer warpgroup
// registers a thread after the hand-over (setmaxnreg): 384 threads start
// at 168; the producer warpgroup gives back 128 x 144, which lets the two
// consumer warpgroups take 256 x 72 more
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

template <int HD>
struct Layout {                      // shared memory, in bytes
  static constexpr int BOXES = HD / BOX_COLS;        // 64-column regions
  static constexpr int OWN_BYTES = BOXES * OWN * ROW_BYTES;     // a tensor
  static constexpr int TILE_BYTES = BOXES * STREAM * ROW_BYTES;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  // each stage's rows of L and D (dK/dV only)
  static constexpr int ROWS_OFFSET = 2 * OWN_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = ROWS_OFFSET + STAGES * 2 * STREAM * 4;
  // + the barriers, + slack to align the base to the 1024-byte period of
  // the 128-byte swizzle
  static constexpr int BYTES = BAR_OFFSET + (2 * STAGES + 1) * 8 + 1024;
};

// S (64 x 64) = A B^T over hd: A 64 rows of a 128-row owned tile, B a
// 64-row streamed tile, both K-major in 64-column boxes.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss_n64(s, desc_sw128(a + (kk / 4) * OWN * ROW_BYTES + step, 16,
                               1024),
                 desc_sw128(b + (kk / 4) * STREAM * ROW_BYTES + step, 16,
                            1024),
                 kk > 0);
  }
}

// acc (64 x hd) += A (64 x 64, bf16 in registers) B (64 x hd): B a
// streamed tile read N-major, its 16-row steps 2048 bytes apart, its two
// 64-column boxes (hd 128) one tile region apart.
template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2],
                                         const uint32_t (&a)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < STREAM / 16; ++kk)
    wgmma_rs<HD>(acc, &a[4 * kk],
                 desc_sw128(b + kk * 16 * ROW_BYTES, STREAM * ROW_BYTES,
                            1024));
}

// One dK/dV turn of a warpgroup on one (q tile, head): rows kr0, kr1 (k),
// columns qc + 8 t + {0, 1} (q) of the accumulator layout.  rows: the
// tile's L log2 e (+inf past S) and, STREAM floats on, its D.  Four commit
// groups, so each elementwise step runs under the next product: P^T's
// exponentials under dP^T = V dO^T, dS^T under dV += P^T dO.
template <int HD>
__device__ __forceinline__ void dkdv_turn(
    float (&dk)[HD / 2], float (&dv)[HD / 2], uint32_t k_a, uint32_t v_a,
    uint32_t q_b, uint32_t do_b, const float* rows, bool masked, int kr0,
    int kr1, int qc, int cq, const Mask& mask, float scale_log2) {
  float st[32], dpt[32];
  fence_regs(dk);
  fence_regs(dv);
  wgmma_fence();
  issue_scores<HD>(st, k_a, q_b);
  wgmma_commit();
  issue_scores<HD>(dpt, v_a, do_b);
  wgmma_commit();
  wgmma_wait<1>();                     // S^T is in
  fence_regs(st);
  uint32_t pp[16];
#pragma unroll
  for (int t = 0; t < 8; ++t) {        // P^T, kept in st for dS^T
    const float2 l2 = *reinterpret_cast<const float2*>(&rows[8 * t + cq]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = st[4 * t + e];
      if (masked && !mask.ok(qc + 8 * t + (e & 1), (e & 2) ? kr1 : kr0))
        x = -INFINITY;
      st[4 * t + e] = fast_exp2(fmaf(x, scale_log2,
                                     -((e & 1) ? l2.y : l2.x)));
    }
    pp[2 * t] = pack_bf16(st[4 * t], st[4 * t + 1]);
    pp[2 * t + 1] = pack_bf16(st[4 * t + 2], st[4 * t + 3]);
  }
  fence_regs(pp);
  wgmma_fence();
  issue_rs<HD>(dv, pp, do_b);
  wgmma_commit();
  wgmma_wait<1>();                     // dP^T is in; dV still running
  fence_regs(dpt);
  uint32_t dsp[16];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float2 d2 =
        *reinterpret_cast<const float2*>(&rows[STREAM + 8 * t + cq]);
    dsp[2 * t] = pack_bf16(st[4 * t] * (dpt[4 * t] - d2.x),
                           st[4 * t + 1] * (dpt[4 * t + 1] - d2.y));
    dsp[2 * t + 1] = pack_bf16(st[4 * t + 2] * (dpt[4 * t + 2] - d2.x),
                               st[4 * t + 3] * (dpt[4 * t + 3] - d2.y));
  }
  fence_regs(dsp);
  wgmma_fence();
  issue_rs<HD>(dk, dsp, q_b);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(pp);
  fence_regs(dk);
  fence_regs(dv);
}

// Rows r0, r1 (< S) of a warpgroup's accumulator, times `mul`, as bf16
// pairs into out (B, S, heads, hd) at head `head`.
template <int HD>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ out,
                                          const float (&acc)[HD / 2], int b,
                                          int S, int heads, int head, int r0,
                                          int r1, int cq, float mul) {
  const long long rs = static_cast<long long>(heads) * HD;
  __nv_bfloat16* base = out + static_cast<long long>(b) * S * rs +
                        static_cast<long long>(head) * HD + cq;
  if (r0 < S) {
#pragma unroll
    for (int t = 0; t < HD / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(base + r0 * rs + 8 * t) =
          __floats2bfloat162_rn(acc[4 * t] * mul, acc[4 * t + 1] * mul);
  }
  if (r1 < S) {
#pragma unroll
    for (int t = 0; t < HD / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(base + r1 * rs + 8 * t) =
          __floats2bfloat162_rn(acc[4 * t + 2] * mul, acc[4 * t + 3] * mul);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tmq,
            const __grid_constant__ CUtensorMap tmdo,
            const __grid_constant__ CUtensorMap tmk,
            const __grid_constant__ CUtensorMap tmv,
            const float* __restrict__ L, const float* __restrict__ D,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int B, int H, int KV, Mask mask, float scale, float scale_log2) {
  using Lay = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = smem;
  uint8_t* sV = smem + Lay::OWN_BYTES;
  uint8_t* sStage = smem + 2 * Lay::OWN_BYTES;   // stage s: Q, then dO
  float* sRows = reinterpret_cast<float*>(smem + Lay::ROWS_OFFSET);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int S = mask.S, groups = H / KV;
  // k tile 0, which the most q tiles reach under a causal mask, first
  const int kt = static_cast<int>(blockIdx.x / (B * KV));
  const int bk = static_cast<int>(blockIdx.x % (B * KV));
  const int b = bk / KV, kvh = bk % KV;
  const int k0 = kt * OWN;
  const int q_begin = mask.q_begin(k0);
  const int n_q = (mask.q_end(k0, OWN) - q_begin + STREAM - 1) / STREAM;
  const int n_turns = groups * n_q;     // (head, q tile), head-major

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);     // the TMA thread and the rows warp
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {            // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(kvbar, 2 * Lay::OWN_BYTES);
      for (int c = 0; c < Lay::BOXES; ++c) {
        tma_load(sK + c * OWN * ROW_BYTES, &tmk, kvbar, c * BOX_COLS, kvh, k0,
                 b);
        tma_load(sV + c * OWN * ROW_BYTES, &tmv, kvbar, c * BOX_COLS, kvh, k0,
                 b);
      }
      for (int j = 0; j < n_turns; ++j) {
        const int s = j % STAGES, h = kvh * groups + j / n_q;
        const int q0 = q_begin + (j % n_q) * STREAM;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], Lay::STAGE_BYTES);
        uint8_t* st = sStage + s * Lay::STAGE_BYTES;
        for (int c = 0; c < Lay::BOXES; ++c) {
          tma_load(st + c * STREAM * ROW_BYTES, &tmq, &full[s], c * BOX_COLS,
                   h, q0, b);
          tma_load(st + Lay::TILE_BYTES + c * STREAM * ROW_BYTES, &tmdo,
                   &full[s], c * BOX_COLS, h, q0, b);
        }
      }
    } else if (warp == CONSUMER_WARPS + 1) {     // rows of L and D
      for (int j = 0; j < n_turns; ++j) {
        const int s = j % STAGES, h = kvh * groups + j / n_q;
        const int q0 = q_begin + (j % n_q) * STREAM;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        const long long at = (static_cast<long long>(b) * H + h) * S;
        float* rows = sRows + s * 2 * STREAM;
        for (int r = lane; r < STREAM; r += 32) {
          const int qi = q0 + r;
          rows[r] = qi < S ? L[at + qi] * LOG2E : INFINITY;
          rows[STREAM + r] = qi < S ? D[at + qi] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg owns k rows k_lo .. k_lo + 63; this thread
  // holds rows kr0 and kr0 + 8, columns 8 t + cq and 8 t + cq + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
  const int wg = warp / 4;
  const int k_lo = k0 + 64 * wg, k_hi = k_lo + 63;
  const int kr0 = k_lo + 16 * (warp % 4) + lane / 4, kr1 = kr0 + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t k_a = smem_u32(sK) + 64 * wg * ROW_BYTES;
  const uint32_t v_a = smem_u32(sV) + 64 * wg * ROW_BYTES;
  const int causal = mask.causal, window = mask.window;

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(kvbar, 0);
  for (int j = 0; j < n_turns; ++j) {
    const int s = j % STAGES;
    const int q0 = q_begin + (j % n_q) * STREAM;
    // some (k, q) pair of the tile is kept for these rows
    const bool run = k_lo < S && !(causal && q0 + STREAM - 1 < k_lo) &&
                     !(window > 0 && q0 - k_hi >= window);
    mbar_wait(&full[s], (j / STAGES) & 1);
    if (run) {
      const bool masked = q0 + STREAM > S || (causal && k_hi > q0) ||
                          (window > 0 && q0 + STREAM - 1 - k_lo >= window);
      const uint32_t q_b = smem_u32(sStage + s * Lay::STAGE_BYTES);
      dkdv_turn<HD>(dk_acc, dv_acc, k_a, v_a, q_b, q_b + Lay::TILE_BYTES,
                    sRows + s * 2 * STREAM, masked, kr0, kr1, q0 + cq, cq,
                    mask, scale_log2);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_acc<HD>(dk, dk_acc, b, S, KV, kvh, kr0, kr1, cq, scale);
  store_acc<HD>(dv, dv_acc, b, S, KV, kvh, kr0, kr1, cq, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tmq,
          const __grid_constant__ CUtensorMap tmdo,
          const __grid_constant__ CUtensorMap tmk,
          const __grid_constant__ CUtensorMap tmv,
          const float* __restrict__ L, const float* __restrict__ D,
          __nv_bfloat16* __restrict__ dq, int B, int H, int KV, Mask mask,
          float scale, float scale_log2) {
  using Lay = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint8_t* sdO = smem + Lay::OWN_BYTES;
  uint8_t* sStage = smem + 2 * Lay::OWN_BYTES;   // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int S = mask.S, groups = H / KV;
  // the longest q tiles first; the query heads of one kv head side by side
  const int n_qt = (S + OWN - 1) / OWN;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / (B * H));
  const int bh = static_cast<int>(blockIdx.x % (B * H));
  const int b = bh / H, h = bh % H, kvh = h / groups;
  const int q0 = qt * OWN;
  const int kv_begin = mask.k_begin(q0, STREAM);
  const int n_tiles =
      (mask.k_end(q0, OWN) - kv_begin + STREAM - 1) / STREAM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {            // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      mbar_expect_tx(qbar, 2 * Lay::OWN_BYTES);
      for (int c = 0; c < Lay::BOXES; ++c) {
        tma_load(sQ + c * OWN * ROW_BYTES, &tmq, qbar, c * BOX_COLS, h, q0,
                 b);
        tma_load(sdO + c * OWN * ROW_BYTES, &tmdo, qbar, c * BOX_COLS, h, q0,
                 b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, k0 = kv_begin + j * STREAM;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], Lay::STAGE_BYTES);
        uint8_t* st = sStage + s * Lay::STAGE_BYTES;
        for (int c = 0; c < Lay::BOXES; ++c) {
          tma_load(st + c * STREAM * ROW_BYTES, &tmk, &full[s], c * BOX_COLS,
                   kvh, k0, b);
          tma_load(st + Lay::TILE_BYTES + c * STREAM * ROW_BYTES, &tmv,
                   &full[s], c * BOX_COLS, kvh, k0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns q rows row_lo .. row_lo + 63; this thread
  // holds rows r0 and r0 + 8, columns 8 t + cq and 8 t + cq + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
  const int wg = warp / 4;
  const int row_lo = q0 + 64 * wg, row_hi = row_lo + 63;
  const int r0 = row_lo + 16 * (warp % 4) + lane / 4, r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t q_a = smem_u32(sQ) + 64 * wg * ROW_BYTES;
  const uint32_t do_a = smem_u32(sdO) + 64 * wg * ROW_BYTES;
  const int causal = mask.causal, window = mask.window;
  const long long at = (static_cast<long long>(b) * H + h) * S;
  const float l0 = r0 < S ? L[at + r0] * LOG2E : INFINITY;
  const float l1 = r1 < S ? L[at + r1] * LOG2E : INFINITY;
  const float d0 = r0 < S ? D[at + r0] : 0.f;
  const float d1 = r1 < S ? D[at + r1] : 0.f;

  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
  mbar_wait(qbar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES, k0 = kv_begin + j * STREAM;
    const bool run = row_lo < S && !(causal && k0 > row_hi) &&
                     !(window > 0 && k0 + STREAM - 1 <= row_lo - window);
    mbar_wait(&full[s], (j / STAGES) & 1);
    if (run) {
      const bool masked = k0 + STREAM > S ||
                          (causal && k0 + STREAM - 1 > row_lo) ||
                          (window > 0 && k0 <= row_hi - window);
      const uint32_t k_b = smem_u32(sStage + s * Lay::STAGE_BYTES);
      // S, then dP, as two commit groups: P's exponentials run under
      // dP = dO V^T
      float sc[32], dp[32];
      fence_regs(dq_acc);
      wgmma_fence();
      issue_scores<HD>(sc, q_a, k_b);
      wgmma_commit();
      issue_scores<HD>(dp, do_a, k_b + Lay::TILE_BYTES);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i];
        const int row = (i & 2) ? r1 : r0;
        if (masked && !mask.ok(row, k0 + cq + 8 * (i / 4) + (i & 1)))
          x = -INFINITY;
        sc[i] = fast_exp2(fmaf(x, scale_log2, -((i & 2) ? l1 : l0)));
      }
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t dsp[16];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = sc[4 * t + e] * (dp[4 * t + e] - ((e & 2) ? d1 : d0));
        dsp[2 * t] = pack_bf16(ds[0], ds[1]);
        dsp[2 * t + 1] = pack_bf16(ds[2], ds[3]);
      }
      fence_regs(dsp);
      wgmma_fence();
      issue_rs<HD>(dq_acc, dsp, k_b);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_acc<HD>(dq, dq_acc, b, S, H, h, r0, r1, cq, scale);
}

// A map's arguments, as the wrapper computes them (flash_attention.py,
// tensor_map_args): dims (hd, heads, S, B), byte strides of heads, S and
// B, box (64, 1, rows, 1); each kernel sets the box's rows it loads.
struct MapArgs {
  long long dim[4], stride[3], box[4];
};
static_assert(sizeof(MapArgs) == 11 * sizeof(long long), "11 values");

constexpr int ENCODE_ERROR = 10000;   // + the driver's CUresult

bool map_matches(const MapArgs& a, int hd, int heads, int S, int B) {
  return a.dim[0] == hd && a.dim[1] == heads && a.dim[2] == S &&
         a.dim[3] == B && a.box[0] == BOX_COLS && a.box[1] == 1 &&
         a.box[3] == 1;
}

int encode(CUtensorMap* map, const void* base, const MapArgs& a, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cuuint64_t dim[4], stride[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dim[i] = static_cast<cuuint64_t>(a.dim[i]);
    box[i] = static_cast<cuuint32_t>(a.box[i]);
  }
  box[2] = static_cast<cuuint32_t>(rows);
  for (int i = 0; i < 3; ++i) stride[i] = static_cast<cuuint64_t>(a.stride[i]);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dim, stride, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(r);
}

template <int HD>
int launch(const Args& a, const MapArgs& mq, const MapArgs& mk,
           const MapArgs& mv, const MapArgs& mdo, cudaStream_t stream) {
  const int S = a.mask.S;
  if (!map_matches(mq, HD, a.H, S, a.B) || !map_matches(mdo, HD, a.H, S, a.B)
      || !map_matches(mk, HD, a.KV, S, a.B) ||
      !map_matches(mv, HD, a.KV, S, a.B))
    return static_cast<int>(cudaErrorInvalidValue);
  // owned tiles of OWN rows, streamed tiles of STREAM rows
  CUtensorMap q_own, do_own, k_own, v_own, q_str, do_str, k_str, v_str;
  int err = encode(&q_own, a.q, mq, OWN);
  if (err == 0) err = encode(&do_own, a.dout, mdo, OWN);
  if (err == 0) err = encode(&k_own, a.k, mk, OWN);
  if (err == 0) err = encode(&v_own, a.v, mv, OWN);
  if (err == 0) err = encode(&q_str, a.q, mq, STREAM);
  if (err == 0) err = encode(&do_str, a.dout, mdo, STREAM);
  if (err == 0) err = encode(&k_str, a.k, mk, STREAM);
  if (err == 0) err = encode(&v_str, a.v, mv, STREAM);
  if (err != 0) return err;
  constexpr int bytes = Layout<HD>::BYTES;
  static bool attr_set = false;      // once per instantiation
  if (!attr_set) {
    err = allow_smem(dkdv_kernel<HD>, bytes);
    if (err == 0) err = allow_smem(dq_kernel<HD>, bytes);
    if (err != 0) return err;
    attr_set = true;
  }
  const float* L = nullptr;
  err = pre_pass<__nv_bfloat16, HD>(a, &L, stream);
  if (err != 0) return err;
  const long long kv_blocks =
      static_cast<long long>((S + OWN - 1) / OWN) * a.B * a.KV;
  const long long q_blocks =
      static_cast<long long>((S + OWN - 1) / OWN) * a.B * a.H;
  if (q_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = a.scale * LOG2E;
  dkdv_kernel<HD><<<static_cast<unsigned>(kv_blocks), THREADS, bytes,
                    stream>>>(
      q_str, do_str, k_own, v_own, L, a.D,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.B, a.H, a.KV, a.mask, a.scale, scale_log2);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  dq_kernel<HD><<<static_cast<unsigned>(q_blocks), THREADS, bytes, stream>>>(
      q_own, do_own, k_str, v_str, L, a.D,
      static_cast<__nv_bfloat16*>(a.dq), a.B, a.H, a.KV, a.mask, a.scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv,
               const void* lse, void* L, void* D, int B, int S, int H,
               int KV, int causal, int window, float scale,
               const long long* st) {
  return Args{q, k, v, o, dout, dq, dk, dv,
              static_cast<const float*>(lse), static_cast<float*>(L),
              static_cast<float*>(D), B, S, H, KV,
              {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
              {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
              {st[12], st[13], st[14]}, {S, causal, window}, scale};
}

}  // namespace

// Both entries launch on `stream` without synchronising: the pre-pass (D,
// or L and D when `lse` is null), then dK/dV and dQ (the simt body: one
// launch of both; with a group of several heads, per-head f32 partials
// and then their sum).  They
// return cudaGetLastError() after the launches, cudaErrorInvalidValue for
// a shape or type they do not take, or (tc) 10000 + the driver's CUresult
// when a tensor map cannot be encoded.  lse: the forward's (B, H, S) f32
// log-sum-exp, or null; L, D: (B, H, S) f32 scratch (L unused when lse is
// given).  dq (B, S, H, hd), dk and dv (B, S, KV, hd) packed; strides: the
// batch, sequence and head strides of q, k, v, o, do in elements, in that
// order (15 values).

// The SIMT body.  dtype: 0 = f32, 1 = bf16.  pk, pv: (B, S, H, hd) f32
// scratch when H != KV, else null.  vec: every group of four elements of
// q, k, v, do lies aligned for one vector load.
extern "C" int flash_attention_bwd_simt_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* L, void* D, void* pk, void* pv, int B, int S, int H, int KV,
    int hd, int dtype, int causal, int window, float scale, int vec,
    const long long* strides, void* stream) {
  const Args a = make_args(q, k, v, o, dout, dq, dk, dv, lse, L, D, B, S, H,
                           KV, causal, window, scale, strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fk = static_cast<float*>(pk);
  float* fv = static_cast<float*>(pv);
  if (dtype == 0) {
    switch (hd) {
      case 32: return simt::launch<float, 32>(a, fk, fv, vec, st);
      case 64: return simt::launch<float, 64>(a, fk, fv, vec, st);
      case 128: return simt::launch<float, 128>(a, fk, fv, vec, st);
    }
  } else if (dtype == 1 && hd == 32) {
    return simt::launch<__nv_bfloat16, 32>(a, fk, fv, vec, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core body, bf16 at hd 64 and 128; q_map, k_map, v_map,
// do_map each hold 11 values: dims[4], byte strides[3], box[4] (see
// MapArgs; the box's rows are set per kernel).
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* L, void* D, int B, int S, int H, int KV, int hd, int causal,
    int window, float scale, const long long* strides,
    const long long* q_map, const long long* k_map, const long long* v_map,
    const long long* do_map, void* stream) {
  const Args a = make_args(q, k, v, o, dout, dq, dk, dv, lse, L, D, B, S, H,
                           KV, causal, window, scale, strides);
  tc::MapArgs mq, mk, mv, mdo;
  memcpy(&mq, q_map, sizeof mq);
  memcpy(&mk, k_map, sizeof mk);
  memcpy(&mv, v_map, sizeof mv);
  memcpy(&mdo, do_map, sizeof mdo);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return tc::launch<64>(a, mq, mk, mv, mdo, st);
    case 128: return tc::launch<128>(a, mq, mk, mv, mdo, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
