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
// f32 rate.  Each (b, h) is a chain of T dependent steps, and dr and dw
// need S_t while the reverse pass walks t downwards, so S_t is computed a
// second time (here 2 T forward steps in all).  What bounds the kernel as
// built is the rate at which the SM dispatches that work, and its
// latency, at 12 resident warps an SM: beside the arithmetic above, each
// state entry and step costs the shuffles of the sums, shared-memory
// loads of S_t, v_t and dy_t and their addresses, and each chunk its
// staging and barriers.  The state's rows are independent in both
// recurrences: S_t[i, :] and dS_t[i, :] need only row i, and dr_t[i],
// dk_t[i], dw_t[i] and du[i] are sums within row i; only dv_t
// sums over the rows.  What the design does (the launch geometry comes
// from kernels/rwkv_wkv.py::wkv_bwd_geometry, and the kernel is
// instantiated for what it returns):
//
//  * State rows spread over a thread-block cluster.  A cluster of G blocks
//    takes one (b, h); block g owns rows [g RB, (g+1) RB), RB = hd / G (at
//    hd 64: G = 4 blocks of 16 rows and 128 threads, 320 blocks at the
//    train shape).  A lane holds LC columns (8 at hd >= 32) of one row of S and
//    of dS in registers, in groups of 4 consecutive ones hd / 2 apart
//    (neighbouring lanes, neighbouring groups: shared-memory accesses
//    without bank conflicts); hd / LC lanes make a row.
//  * Each chunk rebuilt once.  A first pass runs the forward from `state`
//    and keeps S at every K-th step (K = the chunk, 8 at hd 64) in a
//    scratch of (B, H, ceil(T/K), hd, hd) f32, each lane its own entries.
//    The reverse pass walks the chunks from the last, carrying dS in
//    registers; for each chunk it runs the forward once from the chunk's
//    checkpoint, the K states of the block's rows going to shared memory,
//    then walks the chunk's steps backwards, two steps at a time (the
//    second step's products need only the first's dS, so the two steps'
//    shuffle chains overlap).  S_t is never rebuilt backwards from S_{t+1}
//    (that divides by w_t, which may be tiny).  The recomputed steps are
//    the forward kernel's S = fma(w, S, k v), so the states are its states
//    bit for bit.
//  * A chunk's inputs staged before its walk: v_t and dy_t of its steps,
//    and the block's rows of r_t, k_t and w_t, are copied into shared
//    memory with cp.async in a ring of three slots, the next chunk's
//    while this one runs; the step loops read no device memory.  dr, dk
//    and dw of a chunk gather in shared memory and go out once a chunk,
//    RB consecutive values a step.  With three slots, and the chunk's
//    sums buffered by chunk parity and finished after the next chunk's
//    barrier, a chunk needs one block barrier (and one of the cluster).
//  * Sums, each in a fixed order (no float atomics: two calls on the same
//    inputs give the same bits).  dr_t, dk_t, dw_t and v_t . dy_t add a
//    row's LC columns in a lane, in column order, then the row's lanes by
//    a reduce-scatter of shuffles (halving by lane bit hd/(2 LC), then
//    hd/(4 LC), then a butterfly over the lower bits), so each of four
//    lanes ends with one sum.  du's row sums r_t k_t (v_t . dy_t) over t
//    in the reverse order in that lane, then over b in order in a second
//    small kernel.  dv_t: a lane's LC values k_t G_t[i, j] are added over
//    the rows of its warp by the same reduce-scatter (lane bits 16 down to
//    hd / LC), the warps' sums of a chunk meet in shared memory and are
//    added in warp order; then, after one cluster barrier a chunk, block g
//    adds columns [g RB, (g+1) RB) over the cluster's blocks in rank order
//    through distributed shared memory.  The barrier's arrive follows a
//    chunk's walk and its wait comes after the next chunk's rebuild, so
//    the blocks rarely wait.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

struct Strides {
  long long b, s, h;   // elements; the head dim is contiguous
};

constexpr unsigned kFull = 0xffffffffu;

constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

template <int N>
struct Int {
  static constexpr int value = N;
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

__device__ __forceinline__ float bf16_lo(unsigned x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned x) {
  return __uint_as_float(x & 0xffff0000u);
}

// A lane's N columns (N a multiple of 4) are N / 4 groups of 4
// consecutive ones, GS columns apart: group g of the lane at p is
// p[g GS .. g GS + 3].  Neighbouring lanes hold neighbouring groups, so
// a quarter-warp's 16-byte accesses cover 128 consecutive bytes (no bank
// conflict).  From shared memory (16-byte aligned f32, 8-byte aligned
// bf16) into f32 registers:
template <int N, int GS>
__device__ __forceinline__ void load_n(float (&o)[N], const float* p) {
#pragma unroll
  for (int x = 0; x < N; x += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + x / 4 * GS);
    o[x] = a.x; o[x + 1] = a.y; o[x + 2] = a.z; o[x + 3] = a.w;
  }
}
template <int N, int GS>
__device__ __forceinline__ void load_n(float (&o)[N],
                                       const __nv_bfloat16* p) {
#pragma unroll
  for (int x = 0; x < N; x += 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p + x / 4 * GS);
    o[x] = bf16_lo(a.x); o[x + 1] = bf16_hi(a.x);
    o[x + 2] = bf16_lo(a.y); o[x + 3] = bf16_hi(a.y);
  }
}

template <int N, int GS>
__device__ __forceinline__ void load_global(float (&o)[N], const float* p) {
#pragma unroll
  for (int x = 0; x < N; x += 4) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(p + x / 4 * GS));
    o[x] = a.x; o[x + 1] = a.y; o[x + 2] = a.z; o[x + 3] = a.w;
  }
}

template <int N, int GS>
__device__ __forceinline__ void store_n(float* p, const float (&a)[N]) {
#pragma unroll
  for (int x = 0; x < N; x += 4)
    *reinterpret_cast<float4*>(p + x / 4 * GS) =
        make_float4(a[x], a[x + 1], a[x + 2], a[x + 3]);
}

__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// `rows` rows of ROW_BYTES bytes, `stride` bytes apart in device memory,
// into consecutive rows of shared memory, 16 bytes a copy over NT threads.
template <int ROW_BYTES, int NT>
__device__ __forceinline__ void copy_rows(char* dst, const char* src,
                                          long long stride, int rows,
                                          int tid) {
  constexpr int PER = ROW_BYTES / 16;
  for (int e = tid; e < rows * PER; e += NT) {
    const int m = e / PER, p = e % PER;
    copy16_async(dst + m * ROW_BYTES + p * 16, src + m * stride + p * 16);
  }
}

// The launch geometry of one instance (wkv_bwd_geometry in Python gives
// the same numbers): LC columns a lane, G blocks a (b, h), RB rows a
// block, K steps a chunk.
template <typename T, int HD, int LC, int G, int K>
struct Geo {
  static constexpr int LANES = HD / LC;             // lanes a state row
  static constexpr int GS = LANES * 4;              // a lane's group stride
  static constexpr int RB = HD / G;                 // state rows a block
  static constexpr int THREADS = RB * LANES;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int ES = sizeof(T);
  // shared memory: the chunk's states [K][RB][HD] f32; three ring slots
  // of dy [K][HD] f32, v [K][HD] T, w [K][RB] f32, r and k [K][RB] T; by
  // chunk parity, the warps' dv sums [2][K][WARPS][HD], the block's dv
  // sums [2][K][HD] and the rows' dr, dk, dw [2][K][RB][4] f32
  static constexpr int STATES = K * RB * HD * 4;
  static constexpr int SLOT_DY = K * HD * 4;
  static constexpr int SLOT_V = K * HD * ES;
  static constexpr int SLOT_W = K * RB * 4;
  static constexpr int SLOT_R = K * RB * ES;
  static constexpr int SLOT = SLOT_DY + SLOT_V + SLOT_W + 2 * SLOT_R;
  static constexpr int SLOTS = 3;
  static constexpr int WPART = 2 * K * WARPS * HD * 4;
  static constexpr int BPART = 2 * K * HD * 4;
  static constexpr int ROWBUF = 2 * K * RB * 4 * 4;
  static constexpr int SMEM = STATES + SLOTS * SLOT + WPART + BPART + ROWBUF;
  // blocks an SM holds by shared memory (228 KB, 1 KB reserved a block),
  // to which the registers are held (__launch_bounds__), but never below
  // 160 registers a thread
  static constexpr int BY_SMEM = 233472 / (SMEM + 1024);
  static constexpr int BY_REGS = 65536 / (THREADS * 160);
  static constexpr int MIN_BLOCKS =
      BY_SMEM < BY_REGS ? BY_SMEM : (BY_REGS > 0 ? BY_REGS : 1);
  static_assert(RB * G == HD && LANES >= 4 && LANES <= 32 &&
                THREADS % 32 == 0 && LC % 4 == 0, "unsupported geometry");
  static_assert((RB * ES) % 16 == 0 && (HD * ES) % 16 == 0,
                "rows of 16-byte copies");
};

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

// Add a lane's N values over the lanes that differ from it in lane bits
// MASK, MASK / 2, .., LOW: halving while it holds more than one value
// (the upper partner keeps the upper half), then a butterfly.  Returns
// the offset of the values it keeps in a[0 .. Fold::kept - 1].
template <int N, int MASK, int LOW>
__device__ __forceinline__ int fold(float* a, int lane) {
  if constexpr (MASK < LOW) {
    return 0;
  } else if constexpr (N > 1) {
    const int off = halve<N>(a, lane, MASK);
    return off + fold<N / 2, MASK / 2, LOW>(a, lane);
  } else {
    a[0] += __shfl_xor_sync(kFull, a[0], MASK);
    return fold<1, MASK / 2, LOW>(a, lane);
  }
}
// What fold<N, HIGH, LOW> leaves: `kept` values a lane; the lanes with
// `writer` (zero in the bits of the butterfly levels) write them.
template <int N, int HIGH, int LOW>
struct Fold {
  static constexpr int levels = log2i(HIGH) - log2i(LOW) + 1;
  static constexpr int halvings = levels < log2i(N) ? levels : log2i(N);
  static constexpr int kept = N >> halvings;
  static constexpr int butterfly = LOW * ((1 << (levels - halvings)) - 1);
  __device__ __forceinline__ static bool writer(int lane) {
    return (lane & butterfly) == 0;
  }
};

template <typename T, int HD, int LC, int G, int K>
__global__ void __launch_bounds__(Geo<T, HD, LC, G, K>::THREADS,
                                  Geo<T, HD, LC, G, K>::MIN_BLOCKS)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const T* __restrict__ u, const float* __restrict__ s0,
               const float* __restrict__ dy, const float* __restrict__ ds,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ dstate,
               float* __restrict__ ckpt, float* __restrict__ du_part,
               int T_len, int H, Strides sr, Strides sk, Strides sv,
               Strides sw) {
  using Ge = Geo<T, HD, LC, G, K>;
  constexpr int LANES = Ge::LANES, RB = Ge::RB, NT = Ge::THREADS;
  constexpr int WARPS = Ge::WARPS, ES = Ge::ES, GS = Ge::GS;
  extern __shared__ float4 smem4[];
  char* const sm = reinterpret_cast<char*>(smem4);
  float* const states = reinterpret_cast<float*>(sm);     // [K][RB][HD]
  char* const ring = sm + Ge::STATES;                     // three slots
  float* const wpart =                                 // [2][K][WARPS][HD]
      reinterpret_cast<float*>(ring + Ge::SLOTS * Ge::SLOT);
  float* const bpart = wpart + 2 * K * WARPS * HD;        // [2][K][HD]
  float* const rowbuf = bpart + 2 * K * HD;               // [2][K][RB][4]

  const cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / G, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ri = tid / LANES;                   // row within the block
  const int j0 = (tid % LANES) * 4;             // first column (group 0)
  const int i = g * RB + ri;                    // state row
  const int nchunks = (T_len + K - 1) / K;
  const int njobs = 2 * nchunks - 1;            // pass 1, then pass 2

  const char* const rb = reinterpret_cast<const char*>(
      r + b * sr.b + h * sr.h + g * RB);
  const char* const kb = reinterpret_cast<const char*>(
      k + b * sk.b + h * sk.h + g * RB);
  const char* const wb = reinterpret_cast<const char*>(
      w + b * sw.b + h * sw.h + g * RB);
  const char* const vb = reinterpret_cast<const char*>(
      v + b * sv.b + h * sv.h);
  // dy and the outputs are packed (B, T, H, hd)
  const long long row0 = ((long long)b * T_len * H + h) * HD;
  const long long step = (long long)H * HD;
  const char* const dyb = reinterpret_cast<const char*>(dy + row0);
  float* const ck = ckpt + (long long)bh * nchunks * HD * HD + i * HD + j0;
  const float ui = to_f32(u[h * HD + i]);

  // job jb: chunk jb of pass 1 (jb < nchunks - 1), else chunk
  // 2 nchunks - 2 - jb of pass 2
  auto chunk_of = [&](int jb) {
    return jb < nchunks - 1 ? jb : 2 * nchunks - 2 - jb;
  };
  auto slot_dy = [&](int s) {
    return reinterpret_cast<const float*>(ring + s * Ge::SLOT);
  };
  auto slot_v = [&](int s) {
    return reinterpret_cast<const T*>(ring + s * Ge::SLOT + Ge::SLOT_DY);
  };
  auto slot_w = [&](int s) {
    return reinterpret_cast<const float*>(ring + s * Ge::SLOT + Ge::SLOT_DY
                                          + Ge::SLOT_V);
  };
  auto slot_r = [&](int s) {
    return reinterpret_cast<const T*>(ring + s * Ge::SLOT + Ge::SLOT_DY
                                      + Ge::SLOT_V + Ge::SLOT_W);
  };
  auto slot_k = [&](int s) { return slot_r(s) + K * RB; };
  // stage job jb's inputs into its slot: pass 1 reads k, v, w; pass 2
  // also r and dy
  auto stage = [&](int jb) {
    if (jb >= njobs) return;
    const int s = jb % Ge::SLOTS, c = chunk_of(jb), t0 = c * K;
    const int n = min(K, T_len - t0);
    const bool back = jb >= nchunks - 1;
    char* const p = ring + s * Ge::SLOT;
    if (back)
      copy_rows<HD * 4, NT>(p, dyb + t0 * step * 4, step * 4, n, tid);
    copy_rows<HD * ES, NT>(p + Ge::SLOT_DY, vb + t0 * sv.s * ES, sv.s * ES,
                           n, tid);
    copy_rows<RB * 4, NT>(p + Ge::SLOT_DY + Ge::SLOT_V, wb + t0 * sw.s * 4,
                          sw.s * 4, n, tid);
    if (back)
      copy_rows<RB * ES, NT>(reinterpret_cast<char*>(
                                 const_cast<T*>(slot_r(s))),
                             rb + t0 * sr.s * ES, sr.s * ES, n, tid);
    copy_rows<RB * ES, NT>(reinterpret_cast<char*>(
                               const_cast<T*>(slot_k(s))),
                           kb + t0 * sk.s * ES, sk.s * ES, n, tid);
  };
  // start job jb: its inputs in shared memory, the next job's in flight.
  // The next job's slot last held job jb - 2's, which every thread left
  // before the barrier of job jb - 1; this barrier is the job's only
  // block barrier.
  auto begin = [&](int jb) {
    stage(jb + 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
  };
  // one forward step of this lane's row segment from slot s, step m:
  // S = w S + k v, as the forward kernel takes it
  auto forward = [&](float (&S)[LC], int s, int m) {
    const float kt = to_f32(slot_k(s)[m * RB + ri]);
    const float wt = slot_w(s)[m * RB + ri];
    float vv[LC];
    load_n<LC, GS>(vv, slot_v(s) + m * HD + j0);
#pragma unroll
    for (int x = 0; x < LC; ++x) S[x] = fmaf(wt, S[x], kt * vv[x]);
  };
  // chunk c's dr, dk and dw (RB consecutive values a step) to device
  // memory, and its dv sums over the block's warps, in warp order
  auto finish = [&](int c) {
    const int t0 = c * K, n = min(K, T_len - t0);
    const float* const rows = rowbuf + (c & 1) * K * RB * 4;
    for (int e = tid; e < n * RB; e += NT) {
      const long long at = row0 + (t0 + e / RB) * step + g * RB + e % RB;
      dr[at] = from_f32<T>(rows[e * 4]);
      dk[at] = from_f32<T>(rows[e * 4 + 1]);
      dw[at] = rows[e * 4 + 2];
    }
    const float* const wp = wpart + (c & 1) * K * WARPS * HD;
    float* const bp = bpart + (c & 1) * K * HD;
    for (int e = tid; e < n * HD; e += NT) {
      const int m = e / HD, j = e % HD;
      float a = wp[m * WARPS * HD + j];
#pragma unroll
      for (int x = 1; x < WARPS; ++x) a += wp[(m * WARPS + x) * HD + j];
      bp[m * HD + j] = a;
    }
  };
  // dv of chunk c: columns [g RB, (g+1) RB) added over the cluster's
  // blocks in rank order
  auto write_dv = [&](int c) {
    const int t0 = c * K, n = min(K, T_len - t0);
    const float* const src = bpart + (c & 1) * K * HD;
    for (int e = tid; e < n * RB; e += NT) {
      const int m = e / RB, j = g * RB + e % RB;
      float a = 0.f;
#pragma unroll
      for (int x = 0; x < G; ++x)
        a += cluster.map_shared_rank(src, x)[m * HD + j];
      dv[row0 + (t0 + m) * step + j] = from_f32<T>(a);
    }
  };

  stage(0);
  asm volatile("cp.async.commit_group;" ::: "memory");

  // pass 1: the forward from the state, a checkpoint every K steps
  float S[LC];
  load_global<LC, GS>(S, s0 + (long long)bh * HD * HD + i * HD + j0);
  int jb = 0;
  for (; jb < nchunks - 1; ++jb) {
    begin(jb);
    store_n<LC, GS>(ck + (long long)jb * HD * HD, S);
#pragma unroll 4
    for (int m = 0; m < K; ++m) forward(S, jb % Ge::SLOTS, m);
  }

  // pass 2: the chunks backwards, each rebuilt once into shared memory
  float dS[LC];
  load_global<LC, GS>(dS, ds + (long long)bh * HD * HD + i * HD + j0);
  float du_acc = 0.f;
  float next[LC];                       // the next chunk's checkpoint
  // the row's four sums (dr, dk, dw, v . dy) over its LANES lanes: lane
  // bits LANES/2 and LANES/4 pick the sum a lane keeps (slot_o)
  using RowFold = Fold<4, LANES / 2, 1>;
  const int slot_o = (lane & (LANES / 2) ? 2 : 0)
                     + (lane & (LANES / 4) ? 1 : 0);
  const bool row_wr = RowFold::writer(lane);
  // dv's terms over the rows of the warp (lane bits LANES .. 16)
  using ColFold = Fold<LC, 16, LANES>;
  int pending = -1;                     // a chunk whose dv waits
  for (; jb < njobs; ++jb) {
    const int c = chunk_of(jb), s = jb % Ge::SLOTS;
    const int t0 = c * K, n = min(K, T_len - t0);
    if (c < nchunks - 1) {
#pragma unroll
      for (int x = 0; x < LC; ++x) S[x] = next[x];
    }
    if (c > 0)
      load_global<LC, GS>(next, ck + (long long)(c - 1) * HD * HD);
    begin(jb);
    if (pending >= 0) {
      finish(pending);
      cluster_arrive();
    }
    for (int m = 0; m < n; ++m) {
      store_n<LC, GS>(states + (m * RB + ri) * HD + j0, S);
      if (m + 1 < n) forward(S, s, m);
    }
    if (pending >= 0) {
      cluster_wait();
      write_dv(pending);
    }
    float* const wp = wpart + (c & 1) * K * WARPS * HD;
    float* const rows = rowbuf + (c & 1) * K * RB * 4;

    // the chunk's steps backwards, two at a time: the second step's
    // products need only the first's dS, so the two steps' shuffle chains
    // overlap
    auto walk = [&](int m, auto steps_) {
      constexpr int STEPS = decltype(steps_)::value;
      // q: (S + u k v) . dy, G . v, dS . S, v . dy over this lane's
      // columns; cp: k G, dv's terms
      float q[STEPS][4], cp[STEPS][LC], rk[STEPS];
#pragma unroll
      for (int e = 0; e < STEPS; ++e) {
        const int mm = m - e;
        const float rt = to_f32(slot_r(s)[mm * RB + ri]);
        const float kt = to_f32(slot_k(s)[mm * RB + ri]);
        const float wt = slot_w(s)[mm * RB + ri];
        const float ukt = ui * kt, urt = ui * rt;
        float vv[LC], dd[LC], st[LC];
        load_n<LC, GS>(vv, slot_v(s) + mm * HD + j0);
        load_n<LC, GS>(dd, slot_dy(s) + mm * HD + j0);
        load_n<LC, GS>(st, states + (mm * RB + ri) * HD + j0);
#pragma unroll
        for (int x = 0; x < 4; ++x) q[e][x] = 0.f;
#pragma unroll
        for (int x = 0; x < LC; ++x) {
          const float gij = fmaf(urt, dd[x], dS[x]);
          q[e][0] = fmaf(fmaf(ukt, vv[x], st[x]), dd[x], q[e][0]);
          q[e][1] = fmaf(gij, vv[x], q[e][1]);
          q[e][2] = fmaf(dS[x], st[x], q[e][2]);
          q[e][3] = fmaf(vv[x], dd[x], q[e][3]);
          cp[e][x] = kt * gij;
          dS[x] = fmaf(wt, dS[x], rt * dd[x]);
        }
        rk[e] = rt * kt;
      }
#pragma unroll
      for (int e = 0; e < STEPS; ++e) {
        const int mm = m - e;
        const int off = fold<LC, 16, LANES>(cp[e], lane);
        if (ColFold::writer(lane)) {
          float* const out = wp + (mm * WARPS + warp) * HD + j0
                             + off / 4 * GS + off % 4;
#pragma unroll
          for (int x = 0; x < ColFold::kept; ++x) out[x] = cp[e][x];
        }
        fold<4, LANES / 2, 1>(q[e], lane);
        // dr, dk, dw to shared memory, v . dy into du's sum
        if (row_wr) rows[(mm * RB + ri) * 4 + slot_o] = q[e][0];
        du_acc = slot_o == 3 && row_wr ? fmaf(rk[e], q[e][0], du_acc)
                                       : du_acc;
      }
    };
    int m = n - 1;
    for (; m >= 1; m -= 2) walk(m, Int<2>());
    if (m == 0) walk(m, Int<1>());
    pending = c;
  }
  __syncthreads();
  finish(pending);
  cluster_arrive();
  cluster_wait();
  write_dv(pending);
  store_n<LC, GS>(dstate + (long long)bh * HD * HD + i * HD + j0, dS);
  if (row_wr && slot_o == 3) du_part[(long long)bh * HD + i] = du_acc;
  cluster_arrive();                     // no block leaves while its sums
  cluster_wait();                       // are read
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

template <typename T, int HD, int LC, int G, int K>
int launch(const Args& a, int cols, int cluster, int chunk, int smem,
           cudaStream_t stream) {
  using Ge = Geo<T, HD, LC, G, K>;
  if (cols != LC || cluster != G || chunk != K || smem != Ge::SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wkv_bwd_kernel<T, HD, LC, G, K>;
  static bool attr_set = false;      // once per instance
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Ge::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.H * G);
  cfg.blockDim = dim3(Ge::THREADS);
  cfg.dynamicSmemBytes = Ge::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.w),
      static_cast<const T*>(a.u), static_cast<const float*>(a.s0),
      static_cast<const float*>(a.dy), static_cast<const float*>(a.ds),
      static_cast<T*>(a.dr), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.dw), static_cast<float*>(a.dstate),
      static_cast<float*>(a.ckpt), static_cast<float*>(a.du_part), a.T_len,
      a.H, a.sr, a.sk, a.sv, a.sw);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = a.H * HD;
  du_sum<T><<<(n + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(a.du_part), static_cast<T*>(a.du), a.B, n);
  return static_cast<int>(cudaGetLastError());
}

// The instances: (hd, columns a lane, cluster, chunk) as
// wkv_bwd_geometry gives them.
template <typename T>
int by_head_dim(int hd, const Args& a, int cols, int cluster, int chunk,
                int smem, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16, 4, 1, 32>(a, cols, cluster, chunk, smem,
                                            stream);
    case 32: return launch<T, 32, 8, 1, 8>(a, cols, cluster, chunk, smem,
                                           stream);
    case 64: return launch<T, 64, 8, 4, 8>(a, cols, cluster, chunk, smem,
                                           stream);
    case 128: return launch<T, 128, 8, 8, 4>(a, cols, cluster, chunk, smem,
                                             stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream` without synchronising (the backward kernel, then
// du's sum over b); returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for an unsupported hd or dtype or a geometry
// (columns a lane, cluster, chunk, shared memory bytes) that no instance
// has.  dtype:
// 0 = f32, 1 = bf16 (r, k, v, u and dr, dk, dv, du); w, s0, dy, ds, dw,
// dstate in f32.  dy, dr, dk, dv, dw: packed (B, T, H, hd); s0, ds,
// dstate: (B, H, hd, hd); ckpt: (B, H, ceil(T / chunk), hd, hd) f32
// scratch; du_part: (B, H, hd) f32 scratch; r, k, v, w strides in
// elements.
extern "C" int rwkv_wkv_bwd_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* ds, void* dr,
    void* dk, void* dv, void* dw, void* du, void* dstate, void* ckpt,
    void* du_part, int B, int T_len, int H, int hd, int dtype, int cols,
    int cluster, int chunk, int smem, long long rsb, long long rss,
    long long rsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long wsb,
    long long wss, long long wsh, void* stream) {
  const Args a{r, k, v, w, u, s0, dy, ds, dr, dk, dv, dw, du, dstate, ckpt,
               du_part, B, T_len, H, {rsb, rss, rsh}, {ksb, kss, ksh},
               {vsb, vss, vsh}, {wsb, wss, wsh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_head_dim<float>(hd, a, cols, cluster, chunk, smem, st);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(hd, a, cols, cluster, chunk, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
