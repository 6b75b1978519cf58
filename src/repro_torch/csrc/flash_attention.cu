// Causal GQA flash attention with an optional sliding window, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _kernel).
// q: (B, S, H, hd); k, v: (B, S, KV, hd) with H % KV == 0; query head h
// reads kv head h / (H / KV).  Scores are scaled by 1/sqrt(hd) in f32, the
// softmax runs online with f32 running max m, denominator l and
// accumulator, and the output (B, S, H, hd) is stored in q's type.
// Masks: k <= q (causal) and k > q - window (window > 0), positions
// 0..S-1 for both q and k; rows and keys past S are masked in the kernel,
// so S need not be a multiple of a tile.  Inputs are read in their given
// strides (the head dim contiguous).  Given a pointer, either body also
// writes each row's log-sum-exp L (B, H, S) in f32, which the backward
// (flash_attention_bwd.cu) takes instead of recomputing it; the serve path
// passes none.
//
// What bounds it on this card: at phi4-mini's prefill, (4, 1024, 24, 8,
// 128) in bf16, the causal products are 2.58e10 flops, 26 us at the
// 989 TFLOP/s bf16 tensor-core rate, against 67 MB of q/k/v/o, 20 us at
// 3.35 TB/s: operations bound it, so the products must run on the tensor
// cores.
//
// Two bodies; the route is a fixed function of (dtype, hd), chosen by the
// wrapper (kernels/flash_attention.py), with no fallback between them:
//   bf16, hd 64 or 128  -> tc::attn_kernel (tensor cores, TMA);
//   f32 at any hd, bf16 at hd 32 -> simt::attn_kernel (f32 FMAs on the CUDA
//   cores, the first port of this kernel, kept for full-f32 products).
//
// tc::attn_kernel, what the design does:
//  * One block per (128-row q tile, head, batch): two consumer warpgroups
//    of 64 q rows each (wgmma's M is 64 per warpgroup) and one producer
//    warpgroup, of which one thread issues the loads.  BQ = 128 lets the
//    two consumers share every K/V tile that arrives; BK = 128 makes
//    S = Q K^T one m64n128 product per k16 step.  384 threads start at 168
//    registers; the producer gives all but 40 back (setmaxnreg) and each
//    consumer thread takes 232, room for S (64 f32), O (hd/2 f32) and P
//    (32 bf16 pairs) without spills.
//  * The producer loads the Q tile once and K/V tiles into a ring of
//    three shared-memory stages with TMA (cp.async.bulk.tensor, 4-d maps
//    over (hd, heads, S, B) in the tensors' own strides, built on the
//    host with cuTensorMapEncodeTiled).  Each stage has a full and an
//    empty mbarrier: later tiles load while tile j computes.  Rows past S
//    arrive as zeros (TMA's out-of-range fill).
//  * 128-byte swizzle throughout: a bf16 row of 64 columns is the swizzle
//    span, so a row of hd 128 is two 64-column boxes, stored as two
//    regions of the tile; the wgmma descriptors step across them.
//  * S = Q K^T: wgmma.m64n128k16 with Q and K from shared memory, both
//    K-major (hd contiguous).  Scores are scaled in f32 after the product
//    by scale * log2(e), so the softmax runs on exp2.
//  * The online softmax runs on the accumulator fragment itself: a row
//    lives on a quad of lanes, so the row max is two shuffles; the row
//    sum stays per thread until the epilogue.  Exponents are 2^x on the
//    special-function unit (ex2.approx), the scale folded into one FMA.
//  * O += P V: P, converted to bf16 in registers, is the A fragment (the
//    f32 accumulator layout is the A-register layout); V comes from
//    shared memory as an N-major B operand (transpose bit set).
//  * The two consumer warpgroups take the tensor cores in turns (two
//    named barriers): while one runs its products, the other runs its
//    softmax.  Turn j issues Q K^T of tile j and P V of tile j - 1 as two
//    commit groups; as soon as S(j) is in, the softmax of tile j runs
//    while P V(j - 1) is still on the tensor cores.  So a tile's P waits
//    in registers for the next turn, and its stage is released one turn
//    later; three stages keep the next loads in flight meanwhile
//    (230,456 bytes of shared memory at hd 128).
//  * Only tiles on the diagonal, at the window's edge or past S run the
//    mask; tiles wholly above the diagonal or outside the window are
//    never loaded (a warpgroup skips a shared tile that is wholly masked
//    for its own rows).  q tiles are handed out longest first, and the
//    H/KV query heads of one kv head are neighbouring blocks, so their
//    shared K/V tiles hit L2.
//  * Epilogue: 1/max(l, 1e-30) in f32, bf16 pairs stored for rows < S.
//  * A wait on an mbarrier that spins for about 10 s traps, so a fault in
//    the ring ends the launch with an error instead of hanging the card.
//
// simt::attn_kernel, the f32 body:
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
//  * Shared memory is 117,760 bytes at hd = 128, so the launch sets the
//    kernel's dynamic shared-memory limit first; a refused launch shows
//    in the returned error code.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"
#include "wgmma.cuh"

// ==========================================================================
// simt::attn_kernel: f32 at any hd, bf16 at hd 32
// ==========================================================================

namespace simt {


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
            const T* __restrict__ v, T* __restrict__ o,
            float* __restrict__ lse, int S, int H, int groups, Strides sq,
            Strides sk, Strides sv, int causal, int window, float scale) {
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
      if (lse != nullptr && tx == 0)     // the row's log-sum-exp
        lse[((long long)b * H + h) * S + qi] =
            m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int KV, Strides sq, Strides sk, Strides sv,
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, H / KV, sq, sk,
      sv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int H, int KV, Strides sq, Strides sk,
             Strides sv, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, H, KV, sq, sk, sv,
                                  causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, H, KV, sq, sk, sv,
                                  causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, H, KV, sq, sk, sv,
                                    causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


}  // namespace simt

// ==========================================================================
// tc::attn_kernel: bf16 at hd 64 and 128, wgmma + TMA
// ==========================================================================

namespace tc {

using namespace tma;
using namespace tcore;

constexpr int BQ = 128;              // q rows of a block: two warpgroups
constexpr int BK = 128;              // kv rows of a tile
constexpr int STAGES = 3;            // K/V ring depth
constexpr int BOX_COLS = 64;         // 128 bytes of bf16: the swizzle span
constexpr int ROW_BYTES = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 32 * CONSUMER_WARPS + 128;  // + a producer warpgroup
// registers a thread after the hand-over (setmaxnreg): 384 threads start
// at 168; the producer warpgroup gives back 128 x 128, which lets the two
// consumer warpgroups take 256 x 64 more
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int HD>
struct Layout {                      // shared memory, in bytes
  static constexpr int BOXES = HD / BOX_COLS;         // 64-column regions
  static constexpr int Q_BYTES = BOXES * BQ * ROW_BYTES;
  static constexpr int KV_BYTES = BOXES * BK * ROW_BYTES;   // K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
  // + the barriers, + slack to align the base to the 1024-byte period of
  // the 128-byte swizzle
  static constexpr int BYTES = BAR_OFFSET + (2 * STAGES + 1) * 8 + 1024;
};

// Named barriers over the two consumer warpgroups (256 threads): one
// warpgroup syncs, the other arrives.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" :: "r"(id) : "memory");
}

// One warpgroup's turn on the tensor cores.  It issues S = Q K^T of this
// tile (QK) and O += P V of the last one (PV) as two commit groups and
// passes the turn to the other warpgroup; then, once S is in, it runs
// `softmax` on it while P V is still on the tensor cores, and waits for P V.
// O is rescaled to the last tile's running max before P V joins it.
template <int HD, bool PV, bool QK, class Softmax>
__device__ __forceinline__ void turn(float (&o_acc)[HD / 2],
                                     uint32_t (&p)[BK / 4], uint32_t v_addr,
                                     float corr0, float corr1,
                                     float (&s_acc)[BK / 2], uint32_t q_addr,
                                     uint32_t k_addr, int their_turn,
                                     Softmax&& softmax) {
  if constexpr (PV) {
#pragma unroll
    for (int t = 0; t < HD / 8; ++t) {
      o_acc[4 * t] *= corr0;
      o_acc[4 * t + 1] *= corr0;
      o_acc[4 * t + 2] *= corr1;
      o_acc[4 * t + 3] *= corr1;
    }
  }
  fence_regs(o_acc);
  fence_regs(p);
  fence_regs(s_acc);
  wgmma_fence();
  if constexpr (QK) {
    // hd / 16 steps of k16; steps 4c..4c+3 read box c, each 32 bytes
    // further into the swizzled 128-byte rows
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;
      wgmma_ss_n128(
          s_acc,
          desc_sw128(q_addr + (kk / 4) * BQ * ROW_BYTES + step, 16, 1024),
          desc_sw128(k_addr + (kk / 4) * BK * ROW_BYTES + step, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
  }
  if constexpr (PV) {
    // V's 16-row k16 steps are 2048 bytes apart, its 8-row groups 1024
    // bytes (SBO), its two 64-column boxes (hd 128) one region apart (LBO)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t vd = desc_sw128(v_addr + kk * 16 * ROW_BYTES,
                                     BK * ROW_BYTES, 1024);
      if constexpr (HD == 64)
        wgmma_rs_n64(o_acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                     p[4 * kk + 3], vd);
      else
        wgmma_rs_n128(o_acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                      p[4 * kk + 3], vd);
    }
    wgmma_commit();
  }
  named_arrive(their_turn);
  if constexpr (QK) {
    wgmma_wait<PV ? 1 : 0>();
    fence_regs(s_acc);
    softmax();
  }
  wgmma_wait<0>();
  fence_regs(o_acc);
  fence_regs(p);
  fence_regs(s_acc);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_kernel(const __grid_constant__ CUtensorMap tmq,
            const __grid_constant__ CUtensorMap tmk,
            const __grid_constant__ CUtensorMap tmv,
            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
            int B, int H, int groups, int causal, int window,
            float scale_log2) {
  using L = Layout<HD>;
  constexpr int NS = BK / 2, NO = HD / 2;   // accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + L::Q_BYTES;        // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  // longest q tiles first; the query heads of one kv head side by side
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / (B * H));
  const int bh = static_cast<int>(blockIdx.x % (B * H));
  const int b = bh / H, h = bh % H, kvh = h / groups;
  const int q0 = qt * BQ;
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

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
      mbar_expect_tx(qbar, L::Q_BYTES);
      for (int c = 0; c < L::BOXES; ++c)
        tma_load(sQ + c * BQ * ROW_BYTES, &tmq, qbar, c * BOX_COLS, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, k0 = kv_begin + j * BK;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
        uint8_t* kS = sKV + s * L::STAGE_BYTES;
        for (int c = 0; c < L::BOXES; ++c) {
          tma_load(kS + c * BK * ROW_BYTES, &tmk, &full[s], c * BOX_COLS,
                   kvh, k0, b);
          tma_load(kS + L::KV_BYTES + c * BK * ROW_BYTES, &tmv, &full[s],
                   c * BOX_COLS, kvh, k0, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns q rows row_lo .. row_lo + 63; this thread
  // holds rows r0 and r0 + 8, columns 8 t + cq and 8 t + cq + 1
  const int wg = warp / 4;
  const int row_lo = q0 + 64 * wg, row_hi = row_lo + 63;
  const int r0 = row_lo + 16 * (warp % 4) + lane / 4, r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const bool live = row_lo < S;
  const uint32_t q_addr = smem_u32(sQ) + 64 * wg * ROW_BYTES;

  float o_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o_acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // raw scores
  float corr0 = 0.f, corr1 = 0.f;   // O's rescale before the next P V
  float s_acc[NS];
  uint32_t p[NS / 2];          // P of the last tile, bf16, not yet in O
  bool have_p = false;
  uint32_t v_prev = 0;         // that tile's V
  int k0 = 0;

  // The online softmax of one tile, in place on its scores: mask where
  // the tile needs it, the row max over the quad, the rescale of the row
  // sums, and p = 2^(s scale_log2 - max scale_log2) in the log2 domain
  // (a row with no valid key yet keeps p = 0 and corr = 0).
  auto softmax = [&]() {
    if (k0 + BK > S || (causal && k0 + BK - 1 > row_lo) ||
        (window > 0 && k0 <= row_hi - window)) {
      // key k0 + cq + c is kept iff lo <= c <= hi (c is a constant below)
      const int base = k0 + cq;
      int hi0 = S - 1 - base, hi1 = hi0, lo0 = -BK, lo1 = -BK;
      if (causal) {
        hi0 = min(hi0, r0 - base);
        hi1 = min(hi1, r1 - base);
      }
      if (window > 0) {
        lo0 = r0 - window + 1 - base;
        lo1 = r1 - window + 1 - base;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i / 4) + (i & 1);
        const bool ok = (i & 2) ? (c >= lo1 && c <= hi1)
                                : (c >= lo0 && c <= hi0);
        s_acc[i] = ok ? s_acc[i] : -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int t = 0; t < NS / 4; ++t) {
      mx0 = fmaxf(mx0, fmaxf(s_acc[4 * t], s_acc[4 * t + 1]));
      mx1 = fmaxf(mx1, fmaxf(s_acc[4 * t + 2], s_acc[4 * t + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0 * scale_log2;
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1 * scale_log2;
    corr0 = fast_exp2(m0 * scale_log2 - ms0);
    corr1 = fast_exp2(m1 * scale_log2 - ms1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int t = 0; t < NS / 4; ++t) {
      s_acc[4 * t] = fast_exp2(fmaf(s_acc[4 * t], scale_log2, -ms0));
      s_acc[4 * t + 1] = fast_exp2(fmaf(s_acc[4 * t + 1], scale_log2, -ms0));
      s_acc[4 * t + 2] = fast_exp2(fmaf(s_acc[4 * t + 2], scale_log2, -ms1));
      s_acc[4 * t + 3] = fast_exp2(fmaf(s_acc[4 * t + 3], scale_log2, -ms1));
      sum0 += s_acc[4 * t] + s_acc[4 * t + 1];
      sum1 += s_acc[4 * t + 2] + s_acc[4 * t + 3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
  };

  // The two warpgroups take the tensor cores in turns (named barriers 1
  // and 2): while one runs its products, the other runs its softmax.
  // Phase j issues Q K^T of tile j and P V of tile j - 1; phase n_tiles
  // issues the last P V alone.  Warpgroup 0 goes first, and takes one
  // more turn at the end, which matches warpgroup 1's last hand-over.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) named_arrive(1);
  mbar_wait(qbar, 0);
  for (int j = 0; j <= n_tiles; ++j) {
    const int s = j % STAGES;
    k0 = kv_begin + j * BK;
    const bool run = j < n_tiles && live && !(causal && k0 > row_hi) &&
                     !(window > 0 && k0 + BK - 1 <= row_lo - window);
    if (j < n_tiles) mbar_wait(&full[s], (j / STAGES) & 1);
    __syncwarp();
    const uint32_t k_addr = smem_u32(sKV + s * L::STAGE_BYTES);
    named_sync(my_turn);
    // each branch issues its products as one whole block: wgmma under a
    // condition inside a block makes ptxas serialize them (C7520)
    if (have_p && run)
      turn<HD, true, true>(o_acc, p, v_prev, corr0, corr1, s_acc, q_addr,
                           k_addr, their_turn, softmax);
    else if (have_p)
      turn<HD, true, false>(o_acc, p, v_prev, corr0, corr1, s_acc, q_addr,
                            k_addr, their_turn, softmax);
    else if (run)
      turn<HD, false, true>(o_acc, p, v_prev, corr0, corr1, s_acc, q_addr,
                            k_addr, their_turn, softmax);
    else
      named_arrive(their_turn);
    if (j > 0) {                 // the last tile's K and V are done with
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
    }
    have_p = run;
    if (run) {
      // P in bf16, laid out as the A fragments of the k16 steps of P V:
      // step kk takes p[4 kk .. 4 kk + 3]
#pragma unroll
      for (int t = 0; t < NS / 4; ++t) {
        p[2 * t] = pack_bf16(s_acc[4 * t], s_acc[4 * t + 1]);
        p[2 * t + 1] = pack_bf16(s_acc[4 * t + 2], s_acc[4 * t + 3]);
      }
      v_prev = k_addr + L::KV_BYTES;
    }
  }

  if (wg == 0) named_sync(my_turn);

  // epilogue: the row sums over the quad, normalise, store rows < S
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const long long row_stride = static_cast<long long>(H) * HD;
  __nv_bfloat16* ob = o + static_cast<long long>(b) * S * row_stride +
                      static_cast<long long>(h) * HD + cq;
  if (r0 < S) {
    __nv_bfloat16* orow = ob + r0 * row_stride;
#pragma unroll
    for (int t = 0; t < NO / 4; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * t) =
          __floats2bfloat162_rn(o_acc[4 * t] * inv0, o_acc[4 * t + 1] * inv0);
  }
  if (r1 < S) {
    __nv_bfloat16* orow = ob + r1 * row_stride;
#pragma unroll
    for (int t = 0; t < NO / 4; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * t) = __floats2bfloat162_rn(
          o_acc[4 * t + 2] * inv1, o_acc[4 * t + 3] * inv1);
  }
  if (lse != nullptr && cq == 0) {
    // the row's log-sum-exp of the scaled scores, natural log:
    // (m scale_log2 + log2 l) ln 2
    float* lrow = lse + (static_cast<long long>(b) * H + h) * S;
    constexpr float LN2 = 0.6931471805599453f;
    if (r0 < S) lrow[r0] = (m0 * scale_log2 + log2f(fmaxf(l0, 1e-30f))) * LN2;
    if (r1 < S) lrow[r1] = (m1 * scale_log2 + log2f(fmaxf(l1, 1e-30f))) * LN2;
  }
}

// A map's arguments, as the wrapper computes them (flash_attention.py,
// tensor_map_args): dims (hd, heads, S, B), byte strides of heads, S and
// B, box (64, 1, rows, 1).
struct MapArgs {
  long long dim[4], stride[3], box[4];
};
static_assert(sizeof(MapArgs) == 11 * sizeof(long long), "11 values");

constexpr int ENCODE_ERROR = 10000;   // + the driver's CUresult

bool map_matches(const MapArgs& a, int hd, int heads, int S, int B,
                 int rows) {
  return a.dim[0] == hd && a.dim[1] == heads && a.dim[2] == S &&
         a.dim[3] == B && a.box[0] == BOX_COLS && a.box[1] == 1 &&
         a.box[2] == rows && a.box[3] == 1;
}

int encode(CUtensorMap* map, const void* base, const MapArgs& a) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cuuint64_t dim[4], stride[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dim[i] = static_cast<cuuint64_t>(a.dim[i]);
    box[i] = static_cast<cuuint32_t>(a.box[i]);
  }
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
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int KV, int causal, int window, float scale,
           const MapArgs& mq, const MapArgs& mk, const MapArgs& mv,
           cudaStream_t stream) {
  if (!map_matches(mq, HD, H, S, B, BQ) || !map_matches(mk, HD, KV, S, B, BK)
      || !map_matches(mv, HD, KV, S, B, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, mq);
  if (err == 0) err = encode(&tk, k, mk);
  if (err == 0) err = encode(&tv, v, mv);
  if (err != 0) return err;
  constexpr int bytes = Layout<HD>::BYTES;
  static bool attr_set = false;      // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const long long blocks = static_cast<long long>((S + BQ - 1) / BQ) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  attn_kernel<HD><<<static_cast<unsigned>(blocks), THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, B, H, H / KV,
      causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// Both entries launch on `stream` without synchronising and return
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a shape
// or type they do not take, or (tc) 10000 + the driver's CUresult when a
// tensor map cannot be encoded.

// Both take `lse`, a (B, H, S) f32 output for each row's log-sum-exp of
// its scaled scores (the backward's L), or null where no one needs it (the
// serve path).

// The SIMT body.  dtype: 0 = f32, 1 = bf16 for q, k, v and o; strides in
// elements.
extern "C" int flash_attention_simt_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int H, int KV, int hd, int dtype, int causal, int window,
    float scale,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* stream) {
  const simt::Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return simt::dispatch<float>(hd, q, k, v, o, l, B, S, H, KV, sq, sk, sv,
                                 causal, window, scale, st);
  if (dtype == 1)
    return simt::dispatch<__nv_bfloat16>(hd, q, k, v, o, l, B, S, H, KV, sq,
                                         sk, sv, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core body, bf16 only; q_map, k_map, v_map each hold 11 values:
// dims[4], byte strides[3], box[4] (see MapArgs).  o is (B, S, H, hd),
// contiguous.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int H, int KV, int hd, int causal, int window, float scale,
    const long long* q_map, const long long* k_map, const long long* v_map,
    void* stream) {
  tc::MapArgs mq, mk, mv;
  memcpy(&mq, q_map, sizeof mq);
  memcpy(&mk, k_map, sizeof mk);
  memcpy(&mv, v_map, sizeof mv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64: return tc::launch<64>(q, k, v, o, l, B, S, H, KV, causal, window,
                                   scale, mq, mk, mv, st);
    case 128: return tc::launch<128>(q, k, v, o, l, B, S, H, KV, causal,
                                     window, scale, mq, mk, mv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
