// Backward of the RWKV-6 wkv recurrence for Hopper (sm_90a), CUDA C++.
//
// Replaces the reference's gradient of the recurrence: XLA's autodiff of
// src/repro/models/rwkv.py::_wkv_scan, a lax.scan over chunks of 64 steps
// under jax.checkpoint (the Pallas kernel rwkv_wkv has no backward).
// Per (batch, head), with S_t the state before step t (S_0 = state) and
// dS_{t+1} the gradient of the state after it (dS_T = ds):
//
//     dS_t   = diag(w_t) dS_{t+1} + r_t dy_t^T
//     dr_t   = (S_t + u . k_t v_t^T) dy_t
//     dk_t   = G_t v_t,   dv_t = G_t^T k_t,   G_t = dS_{t+1} + (u . r_t) dy_t^T
//     dw_t   = rowsum(dS_{t+1} . S_t)
//     du     = sum_{b,t} r_t . k_t (v_t . dy_t),   dstate = dS_0
//
// (G_t is the gradient of the step's k_t v_t^T, which enters both y_t,
// through u, and S_{t+1}.)  r, k, v, w: (B, T, H, hd) in their strides, the
// head dim contiguous; r, k, v, u in f32 or bf16, w, the state, dy and ds
// in f32.  dr, dk, dv and du come out in r's type, dw and dstate in f32;
// all arithmetic is f32.
//
// What bounds it on this card.  At rwkv6-3b's train shape (2, 512, 40, 64)
// in f32 it reads r, k, v, w, dy and writes dr, dk, dv, dw: about 98 MB,
// 29 us at 3.35 TB/s; a step and head needs about 12 hd^2 flops (S_t
// rebuilt, then dS, dr, dk, dv and dw), 2.0 GFLOP, 30 us at the 67 TFLOP/s
// f32 rate.  As in the forward, only B * H = 80 (b, h) pairs exist, each
// a chain of T dependent steps, so the issue rate of one block and its
// chain of dependent instructions a step bound it; and dr and dw need S_t
// while the reverse pass walks t downwards.  What the design does:
//
//  * Checkpoints, the reference's own design.  A first pass runs the
//    forward from `state` and keeps S at every 64th step in a scratch of
//    (B, H, ceil(T/64), hd, hd) f32.  The reverse pass walks the chunks
//    from the last, carrying dS in registers; for each chunk it rebuilds
//    the states from the chunk's checkpoint, K steps at a time (a sub-
//    chunk: K = min(32768 / hd^2, 64) states in shared memory), from the
//    last sub-chunk down: the forward is recomputed from the checkpoint to
//    the sub-chunk's start, the sub-chunk's K states go to shared memory,
//    and its steps run backwards.  Extra memory is the checkpoints and one
//    sub-chunk, never one state a step.  S_t is never rebuilt backwards
//    from S_{t+1} (that divides by w_t, which may be tiny).
//  * One block per (b, h), 4 hd threads: lane (row i, quarter c) holds
//    columns c hd/4 .. c hd/4 + hd/4 - 1 of row i of S and of dS in
//    registers, so S's and dS's recurrences need no other lane; a
//    checkpoint and a sub-chunk's states are read back by the lane that
//    wrote them.  The recomputed steps are the forward kernel's
//    S = fma(w, S, k v), so the states are its states bit for bit.
//  * Sums: dr_t, dk_t, dw_t (and v_t . dy_t for du) sum a row over its
//    four lanes, a reduce-scatter of two shuffles (each lane ends with one
//    of the four sums and writes it); dv_t sums a column over the rows:
//    a reduce-scatter over the warp's 8 rows (7 shuffles a group of 8
//    columns), then the warps' partial sums of a sub-chunk's steps meet in
//    shared memory after one barrier, added in warp order.  du's partial
//    sums a (b, h) are added over t in the reverse order in a register,
//    then over b in a second small kernel.  No float atomics: two calls
//    on the same inputs give the same bits.
//  * Inputs are read from device memory in their strides (L1 and L2 hold
//    a chunk's rows, which every recomputation reads again); the vectors
//    of a lane's columns as 8- or 16-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, s, h;   // elements; the head dim is contiguous
};

constexpr int CHUNK = 64;             // steps between checkpoints
constexpr int LC = 4;                 // lanes per state row
constexpr int STATE_BYTES = 131072;   // shared memory for a sub-chunk's states
constexpr int CG = 8;                 // columns per group of the dv sums
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float bf16_lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

// N (4 or 8) consecutive elements from 16-byte-aligned (f32) or 8-byte-
// aligned (bf16) device memory into f32 registers.
template <int N>
__device__ __forceinline__ void load_vec(float (&out)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + i));
    out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(float (&out)[N],
                                         const __nv_bfloat16* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p + i));
    out[i] = bf16_lo(x.x); out[i + 1] = bf16_hi(x.x);
    out[i + 2] = bf16_lo(x.y); out[i + 3] = bf16_hi(x.y);
  }
}

template <int HD>
struct Geo {
  static constexpr int TC = HD / LC;               // columns per lane
  static constexpr int THREADS = HD * LC;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int K = STATE_BYTES / (HD * HD * 4) < CHUNK
                               ? STATE_BYTES / (HD * HD * 4) : CHUNK;
  static constexpr int G = TC < CG ? TC : CG;      // columns per dv group
  static constexpr int SMEM = K * HD * HD * 4 + K * WARPS * HD * 4;
  static_assert(TC % 4 == 0 && CHUNK % K == 0, "unsupported head dim");
};

// One forward step of a lane's row segment: S = w S + k v, as the forward
// kernel takes it.
template <typename T, int TC>
__device__ __forceinline__ void forward_step(float (&S)[TC], const T* kp,
                                             const T* vp, const float* wp) {
  const float kt = to_f32(*kp), wt = __ldg(wp);
#pragma unroll
  for (int g = 0; g < TC; g += 4) {
    float vv[4];
    load_vec(vv, vp + g);
#pragma unroll
    for (int x = 0; x < 4; ++x) S[g + x] = fmaf(wt, S[g + x], kt * vv[x]);
  }
}

template <int TC>
__device__ __forceinline__ void load_row(float (&S)[TC], const float* p) {
#pragma unroll
  for (int x = 0; x < TC; x += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + x);
    S[x] = a.x; S[x + 1] = a.y; S[x + 2] = a.z; S[x + 3] = a.w;
  }
}

template <int TC>
__device__ __forceinline__ void store_row(float* p, const float (&S)[TC]) {
#pragma unroll
  for (int x = 0; x < TC; x += 4)
    *reinterpret_cast<float4*>(p + x) =
        make_float4(S[x], S[x + 1], S[x + 2], S[x + 3]);
}

// Halve the N values a lane holds with its partner across `mask`: the
// upper partner keeps (and is sent the rest of) the upper half.  Returns
// the offset of the kept half.
template <int N>
__device__ __forceinline__ int halve(float* a, int lane, int mask) {
  const bool up = lane & mask;
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const float send = up ? a[x] : a[x + N / 2];
    const float keep = up ? a[x + N / 2] : a[x];
    a[x] = keep + __shfl_xor_sync(kFull, send, mask);
  }
  return up ? N / 2 : 0;
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD * LC)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const T* __restrict__ u, const float* __restrict__ s0,
               const float* __restrict__ dy, const float* __restrict__ ds,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ dstate,
               float* __restrict__ ckpt, float* __restrict__ du_part,
               int T_len, int H, Strides sr, Strides sk, Strides sv,
               Strides sw) {
  using Ge = Geo<HD>;
  constexpr int TC = Ge::TC, K = Ge::K, NT = Ge::THREADS, G = Ge::G;
  extern __shared__ float4 smem4[];
  float4* const states = smem4;                       // [K][TC / 4][NT]
  float* const colp =                                 // [K][WARPS][HD]
      reinterpret_cast<float*>(smem4 + K * (TC / 4) * NT);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ci = lane & (LC - 1);                     // column quarter
  const int i = warp * (32 / LC) + lane / LC;         // state row
  const int j0 = ci * TC;                             // first column
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nchunks = (T_len + CHUNK - 1) / CHUNK;

  const T* const rb = r + b * sr.b + h * sr.h + i;
  const T* const kb = k + b * sk.b + h * sk.h + i;
  const T* const vb = v + b * sv.b + h * sv.h + j0;
  const float* const wb = w + b * sw.b + h * sw.h + i;
  // dy and the outputs are packed (B, T, H, hd)
  const long long row0 = ((long long)b * T_len * H + h) * HD;
  const long long step = (long long)H * HD;
  const float* const dyb = dy + row0 + j0;
  float* const ck = ckpt + (long long)bh * nchunks * HD * HD + i * HD + j0;
  const float ui = to_f32(u[h * HD + i]);

  auto fwd = [&](float (&seg)[TC], int t) {
    forward_step<T, TC>(seg, kb + t * sk.s, vb + t * sv.s, wb + t * sw.s);
  };

  // pass 1: the forward from the state, a checkpoint every CHUNK steps
  float S[TC];
  load_row(S, s0 + (long long)bh * HD * HD + i * HD + j0);
  for (int c = 0; c < nchunks; ++c) {
    store_row(ck + (long long)c * HD * HD, S);
    if (c + 1 == nchunks) break;
#pragma unroll 4
    for (int t = c * CHUNK; t < (c + 1) * CHUNK; ++t) fwd(S, t);
  }

  // pass 2: the chunks backwards, each a sub-chunk of K states at a time
  float dS[TC];
  load_row(dS, ds + (long long)bh * HD * HD + i * HD + j0);
  float du_acc = 0.f;
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * CHUNK, n = min(CHUNK, T_len - t0);
    for (int sub = (n - 1) / K; sub >= 0; --sub) {
      const int ts = t0 + sub * K, mn = min(K, t0 + n - ts);
      load_row(S, ck + (long long)c * HD * HD);
#pragma unroll 4
      for (int t = t0; t < ts; ++t) fwd(S, t);
      for (int m = 0; m < mn; ++m) {
#pragma unroll
        for (int x = 0; x < TC / 4; ++x)
          states[(m * (TC / 4) + x) * NT + tid] =
              make_float4(S[4 * x], S[4 * x + 1], S[4 * x + 2], S[4 * x + 3]);
        if (m + 1 < mn) fwd(S, ts + m);
      }

      for (int m = mn - 1; m >= 0; --m) {
        const int t = ts + m;
        const float rt = to_f32(rb[t * sr.s]), kt = to_f32(kb[t * sk.s]);
        const float wt = __ldg(wb + t * sw.s);
        const float ukt = ui * kt, urt = ui * rt;
        // q4: (S + u k v) . dy, G . v, dS . S, v . dy over this lane's
        // columns
        float q4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int g = 0; g < TC; g += G) {
          float vv[G], dd[G], st[G], cp[G];
          load_vec(vv, vb + t * sv.s + g);
          load_vec(dd, dyb + t * step + g);
#pragma unroll
          for (int x = 0; x < G; x += 4) {
            const float4 a = states[(m * (TC / 4) + (g + x) / 4) * NT + tid];
            st[x] = a.x; st[x + 1] = a.y; st[x + 2] = a.z; st[x + 3] = a.w;
          }
#pragma unroll
          for (int x = 0; x < G; ++x) {
            const float gij = fmaf(urt, dd[x], dS[g + x]);
            q4[0] = fmaf(fmaf(ukt, vv[x], st[x]), dd[x], q4[0]);
            q4[1] = fmaf(gij, vv[x], q4[1]);
            q4[2] = fmaf(dS[g + x], st[x], q4[2]);
            q4[3] = fmaf(vv[x], dd[x], q4[3]);
            cp[x] = kt * gij;
            dS[g + x] = fmaf(wt, dS[g + x], rt * dd[x]);
          }
          // dv's column sums over the warp's 8 rows (lane bits 2..4)
          int off = halve<G>(cp, lane, 16);
          off += halve<G / 2>(cp, lane, 8);
          float* const out = colp + (m * Ge::WARPS + warp) * HD + j0 + g;
          if constexpr (G / 4 >= 2) {
            off += halve<G / 4>(cp, lane, 4);
            out[off] = cp[0];
          } else {
            cp[0] += __shfl_xor_sync(kFull, cp[0], 4);
            if (!(lane & 4)) out[off] = cp[0];
          }
        }
        // the row's four sums over its lanes: lane c keeps sum c
        int o = halve<4>(q4, ci, 2);
        o += halve<2>(q4, ci, 1);
        const long long at = row0 + t * step + i;
        if (o == 0) dr[at] = from_f32<T>(q4[0]);
        else if (o == 1) dk[at] = from_f32<T>(q4[0]);
        else if (o == 2) dw[at] = q4[0];
        else du_acc = fmaf(rt * kt, q4[0], du_acc);
      }
      __syncthreads();                  // the sub-chunk's dv partial sums
      for (int idx = tid; idx < mn * HD; idx += NT) {
        const int m = idx / HD, j = idx % HD;
        float a = 0.f;
#pragma unroll
        for (int x = 0; x < Ge::WARPS; ++x)
          a += colp[(m * Ge::WARPS + x) * HD + j];
        dv[row0 + (ts + m) * step + j] = from_f32<T>(a);
      }
      __syncthreads();                  // colp is free for the next one
    }
  }
  store_row(dstate + (long long)bh * HD * HD + i * HD + j0, dS);
  if (ci == LC - 1) du_part[(long long)bh * HD + i] = du_acc;
}

// du = the (b, h) partial sums added over b in order.
template <typename T>
__global__ void du_sum(const float* __restrict__ part, T* __restrict__ du,
                       int B, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  float a = 0.f;
  for (int b = 0; b < B; ++b) a += part[(long long)b * n + x];
  du[x] = from_f32<T>(a);
}

struct Args {
  const void *r, *k, *v, *w, *u, *s0, *dy, *ds;
  void *dr, *dk, *dv, *dw, *du, *dstate, *ckpt, *du_part;
  int B, T_len, H;
  Strides sr, sk, sv, sw;
};

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  using Ge = Geo<HD>;
  auto kern = wkv_bwd_kernel<T, HD>;
  static bool attr_set = false;      // once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ge::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kern<<<a.B * a.H, Ge::THREADS, Ge::SMEM, stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.w),
      static_cast<const T*>(a.u), static_cast<const float*>(a.s0),
      static_cast<const float*>(a.dy), static_cast<const float*>(a.ds),
      static_cast<T*>(a.dr), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.dw), static_cast<float*>(a.dstate),
      static_cast<float*>(a.ckpt), static_cast<float*>(a.du_part), a.T_len,
      a.H, a.sr, a.sk, a.sv, a.sw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = a.H * HD;
  du_sum<T><<<(n + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(a.du_part), static_cast<T*>(a.du), a.B, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` without synchronising (the backward kernel, then
// du's sum over b); returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for an unsupported hd or dtype.  dtype: 0 = f32,
// 1 = bf16 (r, k, v, u and dr, dk, dv, du); w, s0, dy, ds, dw, dstate in
// f32.  dy, dr, dk, dv, dw: packed (B, T, H, hd); s0, ds, dstate: (B, H,
// hd, hd); ckpt: (B, H, ceil(T / 64), hd, hd) f32 scratch; du_part: (B, H,
// hd) f32 scratch; r, k, v, w strides in elements.
extern "C" int rwkv_wkv_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* ds, void* dr,
    void* dk, void* dv, void* dw, void* du, void* dstate, void* ckpt,
    void* du_part, int B, int T_len, int H, int hd, int dtype,
    long long rsb, long long rss, long long rsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long wsb, long long wss, long long wsh,
    void* stream) {
  const Args a{r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw, du, dstate, ckpt,
               du_part, B, T_len, H, {rsb, rss, rsh}, {ksb, kss, ksh},
               {vsb, vss, vsh}, {wsb, wss, wsh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim<float>(hd, a, st);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(hd, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
