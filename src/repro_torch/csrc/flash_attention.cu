// Causal GQA flash attention with an optional sliding window, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _kernel).
// q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0; query head h
// reads kv head h / (H / KV).  q is multiplied by 1/sqrt(hd) in f32, the
// softmax runs online with f32 running max m, denominator l and
// accumulator, and the output (B, S, H, hd) is stored in q's type.
// Masks: k <= q (causal) and k > q - window (window > 0), positions
// 0..S-1 for both q and k.
//
// What bounds it on this card: at phi4-mini's prefill, (4, 1024, 24, 8,
// 128) in bf16, the causal products are 2.58e10 flops, 26 us at the
// 989 TFLOP/s bf16 tensor-core rate, against 67 MB of q/k/v/o, 20 us at
// 3.35 TB/s: operations bound it.  This first kernel does its products
// with f32 FMAs on the CUDA cores (67 TFLOP/s peak), so it cannot come
// near that bound; tensor cores (wgmma) and TMA are a later redesign.
//
// What the design does:
//  * One block of 4 warps per (64-row q tile, head, batch).  Tiles are
//    handed out last-first, so the long causal rows start first.
//  * The scaled q tile stays in shared memory (f32); the block walks kv
//    tiles of 64 rows, staged in shared memory (f32), and skips every tile
//    that lies wholly above the diagonal or wholly outside the window (the
//    Pallas kernel computes such blocks and then masks them).
//  * Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 8 i (i < 8) of
//    the tile: scores at columns tx + 16 j (j < 4), output columns
//    tx + 16 c (c < hd / 16).  The row max and row sum are reduced with
//    shuffles over the 16 lanes that share a row; P goes through shared
//    memory only between those lanes, so one __syncwarp orders it.
//  * Row strides in shared memory are padded by 4 floats so the 16-byte
//    reads of q and k rows are free of bank conflicts.
//  * Rows and keys past S are masked inside the kernel, so S need not be
//    a multiple of the tile (the Pallas wrapper asserts that it is).
//  * Shared memory is 117,760 bytes at hd = 128, so the launch sets the
//    kernel's dynamic shared-memory limit first; a refused launch shows
//    in the returned error code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

struct Strides {
  long long b, s, h;   // elements; the head dim is contiguous
};

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

constexpr int BQ = 64, BK = 64, THREADS = 128;
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr int smem_floats() {
  return BQ * (HD + 4) + BK * (HD + 4) + BK * HD + BQ * (BK + 4);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int S, int H,
            int groups, Strides sq, Strides sk, Strides sv, int causal,
            int window, float scale) {
  constexpr int QP = HD + 4, KP = HD + 4, PP = BK + 4, NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * KP;
  float* Ps = Vs + BK * HD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / groups;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD, qi = q0 + r;
    Qs[r * QP + c] = qi < S ? to_f32(qb[qi * sq.s + c]) * scale : 0.f;
  }

  float m[8], l[8], acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();              // the last tile's reads are done
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD, c = idx % HD, kj = k0 + r;
      const bool in = kj < S;
      Ks[r * KP + c] = in ? to_f32(kb[kj * sk.s + c]) : 0.f;
      Vs[r * HD + c] = in ? to_f32(vb[kj * sv.s + c]) : 0.f;
    }
    __syncthreads();

    // scores s[i][j] = q_row(ty + 8i) . k_row(tx + 16j)
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kv4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * KP + d]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[(ty + 8 * i) * QP + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv.x, kv4[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv4[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv4[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv4[j].w, s[i][j]);
        }
      }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty + 8 * i, qi = q0 + row;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < S && (!causal || kj <= qi) &&
                (window <= 0 || kj > qi - window);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[row * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();

    // acc[i][c] += sum_kk P[row(i)][kk] V[kk][tx + 16c]
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float vv[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[u][c] = Vs[(kk + u) * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&Ps[(ty + 8 * i) * PP + kk]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c] = fmaf(p4.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(p4.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(p4.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(p4.w, vv[3][c], acc[i][c]);
        }
      }
    }
  }

  T* ob = o + ((long long)b * S * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + ty + 8 * i;
    if (qi < S) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        ob[(long long)qi * H * HD + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, Strides sq, Strides sk, Strides sv,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * 4;
  static bool attr_set = false;      // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  attn_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, H / KV, sq, sk, sv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             int B, int S, int H, int KV, Strides sq, Strides sk,
             Strides sv, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, sq, sk, sv,
                                  causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, sq, sk, sv,
                                  causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, sq, sk, sv,
                                    causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported hd).
// dtype: 0 = f32, 1 = bf16 for q, k, v and o.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int KV, int hd, int dtype, int causal, int window, float scale,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* stream) {
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, q, k, v, o, B, S, H, KV, sq, sk, sv, causal,
                           window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, sq, sk, sv,
                                   causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
