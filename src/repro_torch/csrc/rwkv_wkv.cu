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
// What bounds it on this card.  A (4, 1024, 40, 64) prefill moves about
// 152 MB (45 us at 3.35 TB/s) and needs about 5 hd^2 flops per step and
// head, 3.4 GFLOP (50 us at the 67 TFLOP/s f32 rate); but only B*H = 160
// (b, h) pairs exist, each a chain of T dependent steps, and every (i, j)
// of a step needs r_i, k_i, w_i and v_j in the thread that holds S[i][j].
// Shared memory hands an SM at most 128 bytes a cycle, broadcast or not,
// and each warp issues its instructions in order, so the operands' bytes,
// the issued instructions per (i, j) and each warp's chain of dependent
// instructions a step are what bound it.  What the design does:
//
//  * Each lane holds an R x C tile of S in registers for the whole
//    sequence: rows Rq..Rq+R-1, C adjacent columns.  Each operand it loads
//    serves R or C products: r, k (in their own type) and w for R rows,
//    v for C columns, 3 to 5 bytes per (i, j) in bf16.  The hd / R lanes
//    of one column block (LANES) split the rows; y's partial sums over
//    them meet by a reduce-scatter of warp shuffles (C - 1 shuffles for C
//    columns, then log2(LANES / C) to finish), so each lane ends with one
//    column's sum.  Adjacent lanes take adjacent column blocks.  A block
//    holds a few warps; the columns of one (b, h) spread over as many
//    blocks as it needs.  The geometry (R, C, warps per block, blocks per
//    head) is chosen on the host (kernels/rwkv_wkv.py::launch_geometry)
//    and checked here; rwkv6-3b's prefill takes 8 x 2 tiles, 9.7 warps
//    per SM.  The step loop is unrolled so that one step's shuffles
//    interleave with the next step's products.
//  * c_t = sum_i r_i u_i k_i is computed once per step and block, in the
//    staging pass (8 rows a thread, then a warp reduction), one chunk ahead
//    of the chunk that computes; it is not recomputed by every column.
//  * Chunks of CT steps of r, k, v, w arrive in shared memory by TMA (one
//    box of a 4-d tensor map over each input per chunk, completion counted
//    in bytes on an mbarrier per buffer) into a ring of four buffers, as
//    stored (bf16 stays bf16): chunks c + 2 and c + 3 are in flight while
//    chunk c computes, and one barrier a chunk orders the ring.  One
//    thread issues a chunk's four boxes; with 16-byte cp.async copies
//    (about 5 a thread and chunk) the issuing took a quarter of the time.
//    The wrapper checks that every base address and stride is 16-byte
//    aligned, as TMA needs; steps past T arrive as zeros and are not used.
//  * Inputs are read in their given strides (no transposes); r, k, v and u
//    are f32 or bf16, w is f32, and all arithmetic is f32 (no tensor
//    cores: the chunked matrix form of the recurrence would need TF32 or
//    bf16 products).
//  * T = 1 (decode) takes its own short kernel on the same geometry: each
//    lane loads its rows of r, k, w, u and its columns of v with vector
//    loads beside its tile of the state, all in flight together, takes the
//    one step and writes the state back: no ring, no staging pass and no
//    barrier.  It sums c and runs the step as the chunk kernel does, so a
//    decode step gives the same bits as that step inside a longer run.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

using namespace tma;

struct Strides {
  long long b, s, h;   // elements; the head dim is contiguous
};

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

// N consecutive elements (N even) from 8- or 16-byte-aligned shared memory
// into f32 registers.
template <int N>
__device__ __forceinline__ void load_f32(float (&out)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + i);
      out[i] = x.x; out[i + 1] = x.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_f32(float (&out)[N],
                                         const __nv_bfloat16* p) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + i);
      out[i] = bf16_lo(x.x); out[i + 1] = bf16_hi(x.x);
      out[i + 2] = bf16_lo(x.y); out[i + 3] = bf16_hi(x.y);
      out[i + 4] = bf16_lo(x.z); out[i + 5] = bf16_hi(x.z);
      out[i + 6] = bf16_lo(x.w); out[i + 7] = bf16_hi(x.w);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p + i);
      out[i] = bf16_lo(x.x); out[i + 1] = bf16_hi(x.x);
      out[i + 2] = bf16_lo(x.y); out[i + 3] = bf16_hi(x.y);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const unsigned x = *reinterpret_cast<const unsigned*>(p + i);
      out[i] = bf16_lo(x); out[i + 1] = bf16_hi(x);
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One row of C state entries in device memory, as 8- or 16-byte vectors.
template <int C>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + i);
      dst[i] = x.x; dst[i + 1] = x.y; dst[i + 2] = x.z; dst[i + 3] = x.w;
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* dst, const float* src) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  }
}

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// Shared memory of one block: a ring of four raw chunks (r, k, v in T and
// w in f32, CT rows each, as copied), c for two chunks, and one mbarrier
// per ring buffer, from a base aligned to 128 bytes for the copy engine.
template <typename T, int HD>
struct Layout {
  static constexpr int CT = 1024 / HD;            // steps per chunk
  static constexpr int ROW_T = HD * int(sizeof(T));
  static constexpr int ROW_W = HD * 4;
  static constexpr int RAW = CT * (3 * ROW_T + ROW_W);
  static constexpr int BUFS = 4;
  static constexpr int BAR_OFFSET = BUFS * RAW + 2 * CT * 4;   // 8-aligned
  static constexpr int SMEM = BAR_OFFSET + BUFS * 8 + 128;
};

constexpr int kStageRows = 8;         // rows of one step per thread in c_t

// One step of a lane's R x C tile: y's partial sums over its rows, S
// advanced, then the partial sums reduce-scattered over the column block's
// lanes.  Returns y of the lane's column (where `q`'s low bits select it;
// vf is overwritten), with c_t = ct.
template <int HD, int R, int C>
__device__ __forceinline__ float wkv_step(float (&S)[R][C],
                                          const float (&rf)[R],
                                          const float (&kf)[R],
                                          const float (&wf)[R],
                                          float (&vf)[C], int q, float ct) {
  constexpr int LANES = HD / R;         // lanes per column block
  constexpr int CB = 32 / LANES;        // column blocks per warp
  constexpr int LOG_L = log2i(LANES), LOG_C = log2i(C);
  float a[C];
#pragma unroll
  for (int j = 0; j < C; ++j) a[j] = 0.f;
#pragma unroll
  for (int e = 0; e < R; ++e)
#pragma unroll
    for (int j = 0; j < C; ++j) {
      a[j] = fmaf(rf[e], S[e][j], a[j]);
      S[e][j] = fmaf(wf[e], S[e][j], kf[e] * vf[j]);
    }
  // reduce-scatter over the top LOG_C bits of q: the upper half of each
  // exchange keeps the upper half of the columns
#pragma unroll
  for (int s = 0; s < LOG_C; ++s) {
    const int bit = LOG_L - 1 - s;
    const bool upper = (q >> bit) & 1;
    const int half = (C >> s) / 2;
#pragma unroll
    for (int j = 0; j < C / 2; ++j) {
      if (j < half) {
        const float send = upper ? a[j] : a[j + half];
        const float keep = upper ? a[j + half] : a[j];
        a[j] = keep + __shfl_xor_sync(kFull, send, CB << bit);
        vf[j] = upper ? vf[j + half] : vf[j];
      }
    }
  }
#pragma unroll
  for (int bit = LOG_L - LOG_C - 1; bit >= 0; --bit)
    a[0] += __shfl_xor_sync(kFull, a[0], CB << bit);
  return fmaf(vf[0], ct, a[0]);
}

template <typename T, int HD, int R, int C>
__global__ void __launch_bounds__(kMaxThreads)
wkv_kernel(const __grid_constant__ CUtensorMap tmr,
           const __grid_constant__ CUtensorMap tmk,
           const __grid_constant__ CUtensorMap tmv,
           const __grid_constant__ CUtensorMap tmw, const T* __restrict__ u,
           const float* __restrict__ s0, float* __restrict__ y,
           float* __restrict__ s_out, int T_len, int H,
           int blocks_per_head) {
  using L = Layout<T, HD>;
  constexpr int CT = L::CT;
  constexpr int LANES = HD / R;         // lanes per column block
  constexpr int CB = 32 / LANES;        // column blocks per warp
  constexpr int LOG_L = log2i(LANES), LOG_C = log2i(C);
  // steps the compiler may interleave: 4 where the registers allow it
  // without spills, else 2
  constexpr int kUnroll = R * C <= 16 && LANES <= 16 ? 4 : 2;
  static_assert(LANES <= 32 && C <= LANES && CB * C <= HD && C % 2 == 0 &&
                R % 4 == 0, "unsupported (HD, R, C)");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte aligned, as an offset from the shared array so that loads
  // stay shared-memory loads
  unsigned char* const smem =
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  float* const pc = reinterpret_cast<float*>(smem + L::BUFS * L::RAW);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int bh = blockIdx.x / blocks_per_head;
  const int b = bh / H, h = bh % H;
  const int q = lane / CB;                              // rows Rq..Rq+R-1
  const int col = (((blockIdx.x % blocks_per_head) * nwarps + warp) * CB +
                   lane % CB) * C;                      // first column

  const int nchunks = (T_len + CT - 1) / CT;

  auto raw = [&](int c) { return smem + (c % L::BUFS) * L::RAW; };

  // chunk c into its ring buffer by the copy engine: one box of CT steps
  // of the (b, h) row from each of r, k, v and w (steps past T arrive as
  // zeros), issued by one thread and counted on the buffer's mbarrier;
  // nothing past the last chunk
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFFSET);
  auto issue = [&](int c) {
    if (c >= nchunks) return;
    unsigned char* const dst = raw(c);
    uint64_t* const bar = &full[c % L::BUFS];
    mbar_expect_tx(bar, L::RAW);
    const int t0 = c * CT;
    tma_load(dst, &tmr, bar, 0, h, t0, b);
    tma_load(dst + CT * L::ROW_T, &tmk, bar, 0, h, t0, b);
    tma_load(dst + 2 * CT * L::ROW_T, &tmv, bar, 0, h, t0, b);
    tma_load(dst + 3 * CT * L::ROW_T, &tmw, bar, 0, h, t0, b);
  };
  // every thread's wait for chunk c
  auto landed = [&](int c) {
    mbar_wait(&full[c % L::BUFS], (c / L::BUFS) & 1);
  };

  // the staging pass: c_t of chunk c.  A thread sums r u k over 8 rows of
  // one step; the HD / 8 threads of a step meet by shuffles.
  constexpr int SPS = HD / kStageRows;  // threads per step
  float ul[kStageRows];
  {
    float uf[kStageRows];
    load_f32(uf, u + h * HD + (threadIdx.x % SPS) * kStageRows);
#pragma unroll
    for (int i = 0; i < kStageRows; ++i) ul[i] = uf[i];
  }
  auto stage = [&](int c) {
    const T* const xr = reinterpret_cast<const T*>(raw(c));
    const T* const xk = xr + CT * HD;
    float* const out = pc + (c & 1) * CT;
    const int n = min(CT, T_len - c * CT);
    for (int base = 0; base < CT * SPS; base += blockDim.x) {
      const int idx = base + threadIdx.x;
      const int t = idx / SPS;
      float part = 0.f;
      if (t < n) {
        float rf[kStageRows], kf[kStageRows];
        const int o = t * HD + (idx % SPS) * kStageRows;
        load_f32(rf, xr + o);
        load_f32(kf, xk + o);
#pragma unroll
        for (int i = 0; i < kStageRows; ++i)
          part = fmaf(rf[i] * ul[i], kf[i], part);
      }
#pragma unroll
      for (int off = SPS / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      if (t < n && idx % SPS == 0) out[t] = part;
    }
  };

  float S[R][C];
  const float* const s0b = s0 + (long long)bh * HD * HD + col;
#pragma unroll
  for (int e = 0; e < R; ++e)
    load_row<C>(S[e], s0b + (R * q + e) * HD);
  // this lane's y column after the reduce-scatter, stepped by H * HD a step
  float* yp = y + ((long long)b * T_len * H + h) * HD + col +
              (q >> (LOG_L - LOG_C));
  const long long y_step = (long long)H * HD;
  const bool stores = (q & ((LANES / C) - 1)) == 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::BUFS; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();            // the barriers' init, for every warp
  if (threadIdx.x == 0)
    for (int c = 0; c < 3; ++c) issue(c);
  landed(0);
  stage(0);
  for (int c = 0; c < nchunks; ++c) {
    // chunk c + 1 is in (c + 2 may fly); every thread is done with chunk
    // c - 1, whose buffer takes chunk c + 3; c_t of chunk c is staged
    if (c + 1 < nchunks) landed(c + 1);
    __syncthreads();
    if (threadIdx.x == 0) issue(c + 3);
    if (c + 1 < nchunks) stage(c + 1);

    const unsigned char* const buf = raw(c);
    const T* const xr = reinterpret_cast<const T*>(buf);
    const T* const xk = xr + CT * HD;
    const T* const xv = xk + CT * HD;
    const float* const xw =
        reinterpret_cast<const float*>(buf + 3 * CT * L::ROW_T);
    const float* const ct = pc + (c & 1) * CT;
    const int n = min(CT, T_len - c * CT);
#pragma unroll (kUnroll)
    for (int t = 0; t < n; ++t) {
      float rf[R], kf[R], wf[R], vf[C];
      load_f32(rf, xr + t * HD + R * q);
      load_f32(kf, xk + t * HD + R * q);
      load_f32(wf, xw + t * HD + R * q);
      load_f32(vf, xv + t * HD + col);
      const float yv = wkv_step<HD, R, C>(S, rf, kf, wf, vf, q, ct[t]);
      if (stores) *yp = yv;
      yp += y_step;
    }
  }

  float* const sob = s_out + (long long)bh * HD * HD + col;
#pragma unroll
  for (int e = 0; e < R; ++e)
    store_row<C>(sob + (R * q + e) * HD, S[e]);
}

// T = 1 (decode): the one step straight from device memory, on the lanes
// and tiles of wkv_kernel.  Every load a lane needs (its tile of the state,
// its rows of r, k, w, its columns of v, and the 8-row group of r, k, u
// that it sums into c) is issued before any is used.  c's groups meet in
// the staging pass's order, so the step's bits are those of wkv_kernel.
template <typename T, int HD, int R, int C>
__global__ void __launch_bounds__(kMaxThreads)
wkv_decode(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const T* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_out, int H,
           int blocks_per_head, Strides sr, Strides sk, Strides sv,
           Strides sw) {
  constexpr int LANES = HD / R;
  constexpr int CB = 32 / LANES;
  constexpr int LOG_L = log2i(LANES), LOG_C = log2i(C);
  constexpr int SPS = HD / kStageRows;  // 8-row groups of c
  static_assert(kStageRows % R == 0, "a group of c spans whole tiles");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x / blocks_per_head;
  const int b = bh / H, h = bh % H;
  const int q = lane / CB;
  const int col = (((blockIdx.x % blocks_per_head) * (blockDim.x >> 5) +
                    warp) * CB + lane % CB) * C;
  const int group = R * q / kStageRows * kStageRows;   // first row of c's

  const T* const xr = r + b * sr.b + h * sr.h;
  const T* const xk = k + b * sk.b + h * sk.h;
  const T* const xv = v + b * sv.b + h * sv.h;
  const float* const xw = w + b * sw.b + h * sw.h;
  float S[R][C];
  const float* const s0b = s0 + (long long)bh * HD * HD + col;
#pragma unroll
  for (int e = 0; e < R; ++e)
    load_row<C>(S[e], s0b + (R * q + e) * HD);
  float rf[R], kf[R], wf[R], vf[C];
  load_f32(rf, xr + R * q);
  load_f32(kf, xk + R * q);
  load_f32(wf, xw + R * q);
  load_f32(vf, xv + col);
  float rg[kStageRows], kg[kStageRows], ug[kStageRows];
  load_f32(rg, xr + group);
  load_f32(kg, xk + group);
  load_f32(ug, u + h * HD + group);

  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kStageRows; ++i)
    part = fmaf(rg[i] * ug[i], kg[i], part);
  // group g meets g ^ off, as the staging pass's lanes do
#pragma unroll
  for (int off = SPS / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off * (kStageRows / R) * CB);

  const float yv = wkv_step<HD, R, C>(S, rf, kf, wf, vf, q, part);
  if ((q & ((LANES / C) - 1)) == 0)
    y[(long long)bh * HD + col + (q >> (LOG_L - LOG_C))] = yv;
  float* const sob = s_out + (long long)bh * HD * HD + col;
#pragma unroll
  for (int e = 0; e < R; ++e)
    store_row<C>(sob + (R * q + e) * HD, S[e]);
}

struct Args {
  const void *r, *k, *v, *w, *u, *s0;
  void *y, *s_out;
  int B, T_len, H, warps, blocks_per_head;
  Strides sr, sk, sv, sw;
};

constexpr int ENCODE_ERROR = 10000;   // + the driver's CUresult

// The map of one (B, T, H, hd) input read in its strides: dims (hd, H, T,
// B), innermost first, and one box of (hd, 1, rows, 1).  A dim of size 1
// is never stepped over, so its stride is given as if packed there.
int encode(CUtensorMap* map, const void* base, bool f32, int es,
           const Strides& st, int B, int T_len, int H, int hd, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dim[4] = {cuuint64_t(hd), cuuint64_t(H),
                             cuuint64_t(T_len), cuuint64_t(B)};
  const long long elem[3] = {st.h, st.s, st.b};
  cuuint64_t stride[3];
  long long packed = static_cast<long long>(hd) * es;
  for (int i = 0; i < 3; ++i) {
    stride[i] = dim[i + 1] > 1 ? cuuint64_t(elem[i] * es) : cuuint64_t(packed);
    packed = static_cast<long long>(stride[i]) * dim[i + 1];
  }
  const cuuint32_t box[4] = {cuuint32_t(hd), 1, cuuint32_t(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dim, stride, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(r);
}

template <typename T, int HD, int R, int C>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int CB = 32 / (HD / R);
  constexpr int CT = Layout<T, HD>::CT;
  constexpr bool f32 = sizeof(T) == 4;
  if (a.warps < 1 || a.warps * 32 > kMaxThreads ||
      a.warps * CB * C * a.blocks_per_head != HD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = a.B * a.H * a.blocks_per_head;
  if (a.T_len == 1) {
    wkv_decode<T, HD, R, C><<<grid, a.warps * 32, 0, stream>>>(
        static_cast<const T*>(a.r), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const float*>(a.w),
        static_cast<const T*>(a.u), static_cast<const float*>(a.s0),
        static_cast<float*>(a.y), static_cast<float*>(a.s_out), a.H,
        a.blocks_per_head, a.sr, a.sk, a.sv, a.sw);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap tr, tk, tv, tw;
  int err = encode(&tr, a.r, f32, sizeof(T), a.sr, a.B, a.T_len, a.H, HD, CT);
  if (err == 0)
    err = encode(&tk, a.k, f32, sizeof(T), a.sk, a.B, a.T_len, a.H, HD, CT);
  if (err == 0)
    err = encode(&tv, a.v, f32, sizeof(T), a.sv, a.B, a.T_len, a.H, HD, CT);
  if (err == 0)
    err = encode(&tw, a.w, true, 4, a.sw, a.B, a.T_len, a.H, HD, CT);
  if (err != 0) return err;
  auto kern = wkv_kernel<T, HD, R, C>;
  constexpr int smem = Layout<T, HD>::SMEM;
  static bool attr_set = false;      // once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kern<<<grid, a.warps * 32, smem, stream>>>(
      tr, tk, tv, tw, static_cast<const T*>(a.u),
      static_cast<const float*>(a.s0), static_cast<float*>(a.y),
      static_cast<float*>(a.s_out), a.T_len, a.H, a.blocks_per_head);
  return static_cast<int>(cudaGetLastError());
}

// The instances: (rows, cols) per lane in (8, 2), (4, 2)
// (kernels/rwkv_wkv.py::TILES), where a column block's hd / rows lanes fit
// in a warp, cols <= those lanes and a warp's columns fit in hd.
template <int HD, int R, int C>
constexpr bool takes() {
  return HD / R <= 32 && C <= HD / R && (32 / (HD / R)) * C <= HD;
}

template <typename T, int HD, int R, int C>
int launch_if(const Args& a, cudaStream_t stream) {
  if constexpr (takes<HD, R, C>()) return launch<T, HD, R, C>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int HD>
int by_tile(int rows, int cols, const Args& a, cudaStream_t stream) {
  if (rows == 8 && cols == 2) return launch_if<T, HD, 8, 2>(a, stream);
  if (rows == 4 && cols == 2) return launch_if<T, HD, 4, 2>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_head_dim(int hd, int rows, int cols, const Args& a,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return by_tile<T, 16>(rows, cols, a, stream);
    case 32: return by_tile<T, 32>(rows, cols, a, stream);
    case 64: return by_tile<T, 64>(rows, cols, a, stream);
    case 128: return by_tile<T, 128>(rows, cols, a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for an unsupported hd or
// geometry, or 10000 + the driver's CUresult when a tensor map cannot be
// encoded.  dtype: 0 = f32, 1 = bf16 (r, k, v, u); w and the state are
// f32.  Geometry: `rows` x `cols` state entries per lane, `warps` per
// block, `blocks_per_head` blocks per (b, h); warps * (32 / (hd / rows))
// * cols * blocks_per_head must equal hd.
extern "C" int rwkv_wkv_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* y, void* s_out, int B, int T_len,
    int H, int hd, int dtype, int rows, int cols, int warps,
    int blocks_per_head,
    long long rsb, long long rss, long long rsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long wsb, long long wss, long long wsh,
    void* stream) {
  const Args a{r, k, v, w, u, s0, y, s_out, B, T_len, H, warps,
               blocks_per_head, {rsb, rss, rsh}, {ksb, kss, ksh},
               {vsb, vss, vsh}, {wsb, wss, wsh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim<float>(hd, rows, cols, a, st);
  if (dtype == 1) return by_head_dim<__nv_bfloat16>(hd, rows, cols, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
