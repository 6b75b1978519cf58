// RWKV-6 wkv recurrence for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv_wkv.py::rwkv_wkv
// (body _kernel).  Per (batch, head), over time t:
//
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// r, k, v, w: (B, T, H, hd); u: (H, hd); S: (B, H, hd, hd) f32.
// Returns y (B, T, H, hd) f32 and the final S.
//
// What bounds it on this card: at the serve shapes the arithmetic and the
// serial time loop, not the bytes.  A (4, 1024, 40, 64) prefill moves about
// 152 MB (r/k/v bf16, w and y f32, S in and out), 45 us at 3.35 TB/s, and
// needs about 5 hd^2 flops per step and head, 3.4 GFLOP, 50 us at the
// 67 TFLOP/s f32 rate; but only B*H = 160 (b, h) pairs exist and each is a
// chain of T dependent steps, so the kernel is latency-bound.
//
// What the design does about it:
//  * The Pallas grid walks time blocks in order and carries S in VMEM
//    scratch from one grid step to the next.  Hopper runs blocks in no
//    order, so the time loop is inside the block: one block per (b, h),
//    hd threads, and thread j keeps column j of S in registers (hd f32)
//    for the whole sequence.  S never touches device memory between the
//    initial read and the final write.
//  * Each step reads r_i, k_i, w_i and r_i u_i k_i for every i: they are
//    staged for a chunk of CT steps into shared memory, packed as one
//    float4 per (t, i), so the inner loop issues one broadcast 16-byte
//    shared load per i and no global load.  The chunk's global loads are
//    independent and all in flight at once; v_t[j] is staged beside them.
//  * y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i: the same sum as the
//    reference in another order, with four partial sums so the chain of
//    dependent adds is a quarter as long.
//  * Inputs are read in their given strides (no transposes); r, k, v and u
//    are f32 or bf16, w is f32, and all arithmetic is f32.  T = 1 (decode)
//    is the same kernel.

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

constexpr int kStageElems = 2048;   // CT * hd elements per staged array

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const T* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_out, int T_len,
           int H, Strides sr, Strides sk, Strides sv, Strides sw) {
  constexpr int CT = kStageElems / HD;
  __shared__ float4 pk[CT][HD];      // (r_i, r_i u_i k_i, k_i, w_i)
  __shared__ float vs[CT][HD];

  const int j = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const T* rb = r + b * sr.b + h * sr.h + j;
  const T* kb = k + b * sk.b + h * sk.h + j;
  const T* vb = v + b * sv.b + h * sv.h + j;
  const float* wb = w + b * sw.b + h * sw.h + j;
  const float uj = to_f32(u[h * HD + j]);
  float* yb = y + ((long long)b * T_len * H + h) * HD + j;

  float Sc[HD];
  const float* s0b = s0 + (long long)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) Sc[i] = s0b[i * HD];

  for (int t0 = 0; t0 < T_len; t0 += CT) {
    const int n = min(CT, T_len - t0);
    __syncthreads();                     // the last chunk's reads are done
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
      const long long ts = t0 + t;
      const float rj = to_f32(rb[ts * sr.s]);
      const float kj = to_f32(kb[ts * sk.s]);
      pk[t][j] = make_float4(rj, rj * uj * kj, kj, wb[ts * sw.s]);
      vs[t][j] = to_f32(vb[ts * sv.s]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 p0 = pk[t][i], p1 = pk[t][i + 1];
        const float4 p2 = pk[t][i + 2], p3 = pk[t][i + 3];
        a0 = fmaf(p0.x, Sc[i], a0);
        a1 = fmaf(p1.x, Sc[i + 1], a1);
        a2 = fmaf(p2.x, Sc[i + 2], a2);
        a3 = fmaf(p3.x, Sc[i + 3], a3);
        c0 += p0.y + p1.y;
        c1 += p2.y + p3.y;
        Sc[i] = fmaf(p0.w, Sc[i], p0.z * vj);
        Sc[i + 1] = fmaf(p1.w, Sc[i + 1], p1.z * vj);
        Sc[i + 2] = fmaf(p2.w, Sc[i + 2], p2.z * vj);
        Sc[i + 3] = fmaf(p3.w, Sc[i + 3], p3.z * vj);
      }
      yb[(long long)(t0 + t) * H * HD] = (a0 + a1) + (a2 + a3) +
                                         vj * (c0 + c1);
    }
  }

  float* sob = s_out + (long long)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) sob[i * HD] = Sc[i];
}

template <typename T, int HD>
void launch(const void* r, const void* k, const void* v, const void* w,
            const void* u, const void* s0, void* y, void* s_out, int B,
            int T_len, int H, Strides sr, Strides sk, Strides sv, Strides sw,
            cudaStream_t stream) {
  wkv_kernel<T, HD><<<B * H, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), T_len, H, sr, sk,
      sv, sw);
}

template <typename T>
int dispatch(int hd, const void* r, const void* k, const void* v,
             const void* w, const void* u, const void* s0, void* y,
             void* s_out, int B, int T_len, int H, Strides sr, Strides sk,
             Strides sv, Strides sw, cudaStream_t stream) {
  switch (hd) {
    case 16: launch<T, 16>(r, k, v, w, u, s0, y, s_out, B, T_len, H, sr, sk,
                           sv, sw, stream); break;
    case 32: launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, T_len, H, sr, sk,
                           sv, sw, stream); break;
    case 64: launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, T_len, H, sr, sk,
                           sv, sw, stream); break;
    case 128: launch<T, 128>(r, k, v, w, u, s0, y, s_out, B, T_len, H, sr,
                             sk, sv, sw, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported hd).
// dtype: 0 = f32, 1 = bf16 (r, k, v, u); w and the state are f32.
extern "C" int rwkv_wkv_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* y, void* s_out, int B, int T_len,
    int H, int hd, int dtype, long long rsb, long long rss, long long rsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long wsb, long long wss,
    long long wsh, void* stream) {
  const Strides sr{rsb, rss, rsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh},
      sw{wsb, wss, wsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, r, k, v, w, u, s0, y, s_out, B, T_len, H, sr,
                           sk, sv, sw, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(hd, r, k, v, w, u, s0, y, s_out, B,
                                   T_len, H, sr, sk, sv, sw, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
