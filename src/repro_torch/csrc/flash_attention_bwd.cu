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
// H, hd) and dk, dv (B, S, KV, hd) come out in q's type; all arithmetic is
// f32 FMAs on the CUDA cores.
//
// What bounds it on this card.  At phi4-mini's train shape (2, 512, 24, 8,
// 128) in f32 the causal pairs need 5 products of 2 hd flops each (Q K^T
// and dO V^T in both kernels below but counted once, dV, dK, dQ): about
// 8.1 GFLOP, 0.12 ms at the 67 TFLOP/s f32 rate, against 67 MB of q, k, v,
// o, do, dq, dk, dv, 20 us at 3.35 TB/s: operations bound it.  This first
// version keeps them on the CUDA cores in f32 for both types (no wgmma):
// a right, deterministic kernel first.  What the design does:
//
//  * Three launches.  attn_bwd_pre, one block per (64-row q tile, head,
//    batch), streams over the k tiles the masks let reach its rows, as the
//    forward does, for each row's L (online max and sum), and computes D
//    from o and do.  The forward's bodies and the serve path's K3 time are
//    left alone.
//  * attn_bwd_dkdv, one block per (64-row k tile, kv head, batch): K and V
//    stay in shared memory while the block loops over all H / KV query
//    heads of the group and, for each, over the q tiles that reach the k
//    tile (from the diagonal down when causal, a band when windowed), so
//    GQA's sum over the group happens in the block's registers.  Each
//    turn recomputes s = Q K^T and P = exp(s - L), then dP = dO V^T and dS,
//    stores P^T and dS^T in shared memory and adds dV += P^T dO and dK +=
//    dS^T Q (Q pre-scaled).  k tile 0, which the most q tiles reach, is
//    block 0.
//  * attn_bwd_dq, one block per (64-row q tile, head, batch), tiles handed
//    out last-first: loops over the reachable k tiles, recomputes s, P, dP
//    and dS and adds dQ += dS K.
//  * No float atomics and no (S, S) tensor in device memory; nothing is
//    repeated to H width.  Every sum runs in a fixed order, so two calls
//    on the same inputs give the same bits.
//  * 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16
//    i (i < 4) of a 64 x 64 score tile at columns tx + 16 j (j < 4), and
//    rows ty + 16 i of a 64 x hd accumulator at columns tx + 16 c.  Row
//    strides in shared memory are padded by 4 floats, so 16-byte reads of
//    rows are free of bank conflicts.  Rows and keys past S are zeros and
//    masked, so S need not be a multiple of a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, s, h;   // elements; the head dim is contiguous
};

constexpr int BT = 64;                // rows of a q or k tile
constexpr int THREADS = 256;
constexpr int TP = BT + 4;            // pitch of a 64 x 64 tile
constexpr float NEG_INF = -1e30f;

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
  // the first and one past the last k tile position a q tile reaches
  __device__ __forceinline__ int k_begin(int q0) const {
    return window > 0 ? max(0, q0 - window + 1) / BT * BT : 0;
  }
  __device__ __forceinline__ int k_end(int q0) const {
    return causal ? min(S, q0 + BT) : S;
  }
  // the first and one past the last q position that reaches a k tile
  __device__ __forceinline__ int q_begin(int k0) const {
    return causal ? k0 : 0;
  }
  __device__ __forceinline__ int q_end(int k0) const {
    return window > 0 ? min(S, k0 + BT - 1 + window) : S;
  }
};

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

// acc[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d], both tiles 64 x HD.
template <int HD>
__device__ __forceinline__ void nt_product(float (&acc)[4][4],
                                           const float* A, const float* B,
                                           int ty, int tx) {
  constexpr int P = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 b4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b4[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * P + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * P + d]);
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

// acc[i][c] += sum_r A[ty + 16 i][r] B[r][tx + 16 c]: A 64 x 64 (pitch
// TP), B 64 x HD (pitch HD + 4).
template <int HD>
__device__ __forceinline__ void nn_accumulate(float (&acc)[4][HD / 16],
                                              const float* A, const float* B,
                                              int ty, int tx) {
  constexpr int P = HD + 4, NC = HD / 16;
#pragma unroll 2
  for (int r = 0; r < BT; r += 4) {
    float bv[4][NC];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) bv[u][c] = B[(r + u) * P + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * TP + r]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c] = fmaf(a.x, bv[0][c], acc[i][c]);
        acc[i][c] = fmaf(a.y, bv[1][c], acc[i][c]);
        acc[i][c] = fmaf(a.z, bv[2][c], acc[i][c]);
        acc[i][c] = fmaf(a.w, bv[3][c], acc[i][c]);
      }
    }
  }
}

template <int HD>
constexpr int pre_floats() { return 2 * BT * (HD + 4); }
template <int HD>
constexpr int dkdv_floats() {
  return 4 * BT * (HD + 4) + 2 * BT * TP + 2 * BT;
}
template <int HD>
constexpr int dq_floats() { return 4 * BT * (HD + 4) + BT * TP + 2 * BT; }

// L (B, H, S) and D (B, H, S), f32.
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

  // D: four threads a row over o and do
  {
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
  for (int k0 = mask.k_begin(q0); k0 < mask.k_end(q0); k0 += BT) {
    __syncthreads();              // the last tile's reads are done
    load_tile<T, HD>(Ks, kb, sk.s, k0, S, 1.f);
    __syncthreads();
    float s[4][4];
    nt_product<HD>(s, Qs, Ks, ty, tx);
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

// P and dS of one (q tile, k tile) pair: p[i][j], ds[i][j] at rows q0 + ty
// + 16 i, keys k0 + tx + 16 j; Ls and Ds hold the q tile's L and D.
template <int HD>
__device__ __forceinline__ void scores(float (&p)[4][4], float (&ds)[4][4],
                                       const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* Ls, const float* Ds,
                                       int q0, int k0, const Mask& mask,
                                       int ty, int tx) {
  float dp[4][4];
  nt_product<HD>(p, Qs, Ks, ty, tx);
  nt_product<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = mask.ok(q0 + r, k0 + tx + 16 * j);
      p[i][j] = ok ? expf(p[i][j] - Ls[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - Ds[r]);
    }
  }
}

// L and D of a q tile into shared memory (zeros past S).
__device__ __forceinline__ void load_rows(float* Ls, float* Ds,
                                          const float* L, const float* D,
                                          int q0, int S) {
  for (int r = threadIdx.x; r < BT; r += THREADS) {
    const int qi = q0 + r;
    Ls[r] = qi < S ? L[qi] : 0.f;
    Ds[r] = qi < S ? D[qi] : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ L, const float* __restrict__ D,
              T* __restrict__ dk, T* __restrict__ dv, int H, int KV,
              Strides sq, Strides sk, Strides sv, Strides sdo, Mask mask,
              float scale) {
  constexpr int P = HD + 4, NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BT * P;
  float* Qs = Vs + BT * P;
  float* dOs = Qs + BT * P;
  float* Pt = dOs + BT * P;
  float* dSt = Pt + BT * TP;
  float* Ls = dSt + BT * TP;
  float* Ds = Ls + BT;
  const int S = mask.S, groups = H / KV;
  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_tile<T, HD>(Ks, k + b * sk.b + kvh * sk.h, sk.s, k0, S, 1.f);
  load_tile<T, HD>(Vs, v + b * sv.b + kvh * sv.h, sv.s, k0, S, 1.f);

  float adv[4][NC], adk[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adv[i][c] = adk[i][c] = 0.f;

  const int qb = mask.q_begin(k0) / BT * BT, qe = mask.q_end(k0);
  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    const float* Lh = L + ((long long)b * H + h) * S;
    const float* Dh = D + ((long long)b * H + h) * S;
    for (int q0 = qb; q0 < qe; q0 += BT) {
      __syncthreads();            // the last turn's reads are done
      load_tile<T, HD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);
      load_tile<T, HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                       1.f);
      load_rows(Ls, Ds, Lh, Dh, q0, S);
      __syncthreads();
      float p[4][4], ds[4][4];
      scores<HD>(p, ds, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, mask, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Pt[(tx + 16 * j) * TP + ty + 16 * i] = p[i][j];
          dSt[(tx + 16 * j) * TP + ty + 16 * i] = ds[i][j];
        }
      __syncthreads();
      nn_accumulate<HD>(adv, Pt, dOs, ty, tx);
      nn_accumulate<HD>(adk, dSt, Qs, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj < S) {
      const long long at = (((long long)b * S + kj) * KV + kvh) * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dk[at + tx + 16 * c] = from_f32<T>(adk[i][c]);
        dv[at + tx + 16 * c] = from_f32<T>(adv[i][c]);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ L, const float* __restrict__ D,
            T* __restrict__ dq, int H, int groups, Strides sq, Strides sk,
            Strides sv, Strides sdo, Mask mask, float scale) {
  constexpr int P = HD + 4, NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BT * P;
  float* Ks = dOs + BT * P;
  float* Vs = Ks + BT * P;
  float* dSs = Vs + BT * P;
  float* Ls = dSs + BT * TP;
  float* Ds = Ls + BT;
  const int S = mask.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / groups;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_tile<T, HD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);
  load_tile<T, HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, 1.f);
  load_rows(Ls, Ds, L + ((long long)b * H + h) * S,
            D + ((long long)b * H + h) * S, q0, S);
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int k0 = mask.k_begin(q0); k0 < mask.k_end(q0); k0 += BT) {
    __syncthreads();              // the last tile's reads are done
    load_tile<T, HD>(Ks, kb, sk.s, k0, S, 1.f);
    load_tile<T, HD>(Vs, vb, sv.s, k0, S, 1.f);
    __syncthreads();
    float p[4][4], ds[4][4];
    scores<HD>(p, ds, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, mask, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * i) * TP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    nn_accumulate<HD>(acc, dSs, Ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < S) {
      const long long at = (((long long)b * S + qi) * H + h) * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        dq[at + tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv, *L, *D;
  int B, H, KV;
  Strides sq, sk, sv, so, sdo;
  Mask mask;
  float scale;
};

template <typename K>
int allow_smem(K kern, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int pre = pre_floats<HD>() * 4, kv = dkdv_floats<HD>() * 4,
                qb = dq_floats<HD>() * 4;
  static bool attr_set = false;      // once per instance
  if (!attr_set) {
    int e = allow_smem(attn_bwd_pre<T, HD>, pre);
    if (e == 0) e = allow_smem(attn_bwd_dkdv<T, HD>, kv);
    if (e == 0) e = allow_smem(attn_bwd_dq<T, HD>, qb);
    if (e != 0) return e;
    attr_set = true;
  }
  const int S = a.mask.S, tiles = (S + BT - 1) / BT, groups = a.H / a.KV;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  float* L = static_cast<float*>(a.L);
  float* D = static_cast<float*>(a.D);
  attn_bwd_pre<T, HD><<<dim3(tiles, a.H, a.B), THREADS, pre, stream>>>(
      q, k, static_cast<const T*>(a.o), dout, L, D, a.H, groups, a.sq, a.sk,
      a.so, a.sdo, a.mask, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkdv<T, HD><<<dim3(tiles, a.KV, a.B), THREADS, kv, stream>>>(
      q, k, v, dout, L, D, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.H, a.KV, a.sq, a.sk, a.sv, a.sdo, a.mask, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dq<T, HD><<<dim3(tiles, a.H, a.B), THREADS, qb, stream>>>(
      q, k, v, dout, L, D, static_cast<T*>(a.dq), a.H, groups, a.sq, a.sk,
      a.sv, a.sdo, a.mask, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` without synchronising (the L/D pre-pass, then dK/dV,
// then dQ); returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for an unsupported hd or dtype.  dtype: 0 = f32,
// 1 = bf16 for q, k, v, o, do, dq, dk, dv; L and D: (B, H, S) f32 scratch.
// dq (B, S, H, hd), dk and dv (B, S, KV, hd) packed; the inputs' strides in
// elements.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* L, void* D, int B,
    int S, int H, int KV, int hd, int dtype, int causal, int window,
    float scale, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, long long dsb, long long dss, long long dsh,
    void* stream) {
  const Args a{q, k, v, o, dout, dq, dk, dv, L, D, B, H, KV,
               {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
               {osb, oss, osh}, {dsb, dss, dsh}, {S, causal, window}, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim<float>(hd, a, st);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(hd, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
