// Masked aggregate of one leaf for Hopper (sm_90a), CUDA C++.
//
// The server's aggregate of RANL for deep networks, one parameter leaf
// at a time (src/repro_torch/optim/ranl_llm.py::aggregate; Algorithm 1,
// lines 15-22).  From the N workers' gradients G (N, P) f32, their stored
// memory C (N, P) in its own type (bf16, f16 or f32) and one mask bool a
// worker:
//
//     count = sum_i m_i;   covered = count > 0
//     g     = sum_i (covered ? (m_i * G_i) / max(count, 1) : f32(C_i) * (1 / N))
//     C'_i  = m_i ? round-to-nearest-even(G_i) : C_i
//
// with the sum taken in worker order.  Every operation is an IEEE f32
// intrinsic (__fmul_rn, __fdiv_rn, __fadd_rn: no fused multiply-add), so
// g and C' equal the plain loop's (kernels/ref.py::masked_aggregate_ref)
// on the card bit for bit.  An uncovered leaf's C_i / N is taken as
// PyTorch takes a division by a number on the card: C_i times the f32
// reciprocal of N.  On the CPU the plain loop divides, which rounds
// apart where N is no power of two.
//
// It ports no Pallas kernel: the reference's masked_aggregate is plain
// jnp (src/repro/optim/ranl_llm.py::masked_aggregate).  It replaces the
// port's eager version of it, which decoded the whole (N, P) memory to
// f32, ran about six elementwise kernels a worker and encoded the new
// memory: about 3,000 launches a round at N = 12 and two (N, P) f32
// temporaries.
//
// What bounds it on this card: bytes.  It reads every row of G and C and
// writes every row of C' and g once: (4 + 2 c) N P + 4 P bytes for a
// memory of c bytes an element ((8N + 4) P in bf16), at a few operations
// a byte.  What the design does about it:
//
//  * A thread owns 8 consecutive elements of the leaf.  For each worker
//    row it makes two 16-byte loads of G and one of C (two in f32), with
//    the evict-first hint (ld.global.cs): nothing is read twice.  C' and
//    g leave as 16-byte evict-first stores.
//  * Rows go 4 at a time: all 4 rows' loads are issued before their sums,
//    so a thread keeps 12 16-byte loads (bf16) in flight.
//  * A masked-off worker's C' row is its C row's bits, copied; a trained
//    worker's row is its G row rounded.
//  * Each block reads the N mask bytes from device memory (at the mask's
//    stride): the host never waits for the card.
//  * A grid-stride loop over as many blocks as the card holds at once.
//  * A scalar kernel, one element a step, takes a leaf whose rows are not
//    16-byte aligned (P not a multiple of 8, or a pointer off 16 bytes).
//
// Arguments: G (N, P) f32, C and Cn (N, P) of the memory type named by
// mem (0 bf16, 1 f16, 2 f32), g (P,) f32, all contiguous; mask, N bytes
// of 0/1, mstride bytes apart; device, the index of the current device.
// The launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;      // elements a thread a step
constexpr int GROUP = 4;    // worker rows whose loads are issued together

struct Bf16 {
  using Bits = uint16_t;
  __device__ static float load(uint32_t b) { return __uint_as_float(b << 16); }
  __device__ static uint32_t store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

struct F16 {
  using Bits = uint16_t;
  __device__ static float load(uint32_t b) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
  }
  __device__ static uint32_t store(float x) {
    return __half_as_ushort(__float2half_rn(x));
  }
};

struct F32 {
  using Bits = uint32_t;
  __device__ static float load(uint32_t b) { return __uint_as_float(b); }
  __device__ static uint32_t store(float x) { return __float_as_uint(x); }
};

// VEC memory elements as 32-bit words: two elements a word (low half
// first) for a 16-bit type, one for f32.
template <typename M>
struct Pack {
  static constexpr int WORDS = VEC * static_cast<int>(sizeof(typename M::Bits)) / 4;
  static constexpr int PER_WORD = 4 / static_cast<int>(sizeof(typename M::Bits));
  uint32_t w[WORDS];

  __device__ __forceinline__ float get(int k) const {
    if constexpr (PER_WORD == 1) {
      return M::load(w[k]);
    } else {
      return M::load((w[k / 2] >> (16 * (k % 2))) & 0xffffu);
    }
  }
};

template <typename M>
__device__ __forceinline__ void load_pack(Pack<M>& p, const typename M::Bits* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int j = 0; j < Pack<M>::WORDS / 4; ++j) {
    const uint4 q = __ldcs(s + j);
    p.w[4 * j] = q.x;
    p.w[4 * j + 1] = q.y;
    p.w[4 * j + 2] = q.z;
    p.w[4 * j + 3] = q.w;
  }
}

template <typename M>
__device__ __forceinline__ void store_pack(typename M::Bits* dst, const Pack<M>& p) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int j = 0; j < Pack<M>::WORDS / 4; ++j)
    __stcs(d + j, make_uint4(p.w[4 * j], p.w[4 * j + 1], p.w[4 * j + 2], p.w[4 * j + 3]));
}

// G_i's 8 values rounded to the memory type, packed.
template <typename M>
__device__ __forceinline__ void encode(Pack<M>& p, const float (&x)[VEC]) {
#pragma unroll
  for (int j = 0; j < Pack<M>::WORDS; ++j) {
    if constexpr (Pack<M>::PER_WORD == 1) {
      p.w[j] = M::store(x[j]);
    } else {
      p.w[j] = M::store(x[2 * j]) | (M::store(x[2 * j + 1]) << 16);
    }
  }
}

// The leaf's count of trained workers and whether it is covered: the sum
// of N zeros and ones, exact in f32.
__device__ __forceinline__ float mask_count(const uint8_t* mask, int64_t mstride, int n) {
  float cnt = 0.0f;
  for (int i = 0; i < n; ++i) cnt = __fadd_rn(cnt, mask[i * mstride] ? 1.0f : 0.0f);
  return cnt;
}

// One worker's contribution to one element, added to acc (or starting
// it, for the first worker).
__device__ __forceinline__ float add(float acc, int row, float part) {
  return row == 0 ? part : __fadd_rn(acc, part);
}

// Worker row's contribution to a thread's 8 elements: (m G) / count where
// the leaf is covered, else C (1 / N).  covered is the same in the whole
// grid, so only one of the two branches runs.
template <typename M>
__device__ __forceinline__ void add_row(float (&acc)[VEC], int row, bool covered, float mf,
                                        const float (&x)[VEC], const Pack<M>& c, float div,
                                        float inv_n) {
  if (covered) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = add(acc[k], row, __fdiv_rn(__fmul_rn(mf, x[k]), div));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = add(acc[k], row, __fmul_rn(c.get(k), inv_n));
  }
}

template <typename M>
__global__ void __launch_bounds__(THREADS)
masked_aggregate_vec(const float* __restrict__ G, const typename M::Bits* __restrict__ C,
                     const uint8_t* __restrict__ mask, int64_t mstride,
                     float* __restrict__ g, typename M::Bits* __restrict__ Cn, int n,
                     int64_t P) {
  const float cnt = mask_count(mask, mstride, n);
  const bool covered = cnt > 0.0f;
  const float div = fmaxf(cnt, 1.0f);
  const float inv_n = __fdiv_rn(1.0f, static_cast<float>(n));
  const int64_t chunks = P / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t ch = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; ch < chunks;
       ch += stride) {
    const int64_t e = ch * VEC;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    int i = 0;
    for (; i + GROUP <= n; i += GROUP) {
      float x[GROUP][VEC];
      Pack<M> c[GROUP];
#pragma unroll
      for (int r = 0; r < GROUP; ++r) {
        const float4* gp = reinterpret_cast<const float4*>(G + (i + r) * P + e);
        const float4 a = __ldcs(gp), b = __ldcs(gp + 1);
        x[r][0] = a.x; x[r][1] = a.y; x[r][2] = a.z; x[r][3] = a.w;
        x[r][4] = b.x; x[r][5] = b.y; x[r][6] = b.z; x[r][7] = b.w;
        load_pack<M>(c[r], C + (i + r) * P + e);
      }
#pragma unroll
      for (int r = 0; r < GROUP; ++r) {
        const bool m = mask[(i + r) * mstride] != 0;
        const float mf = m ? 1.0f : 0.0f;
        add_row<M>(acc, i + r, covered, mf, x[r], c[r], div, inv_n);
        if (m) encode<M>(c[r], x[r]);
        store_pack<M>(Cn + (i + r) * P + e, c[r]);
      }
    }
    for (; i < n; ++i) {
      float x[VEC];
      Pack<M> c;
      const float4* gp = reinterpret_cast<const float4*>(G + i * P + e);
      const float4 a = __ldcs(gp), b = __ldcs(gp + 1);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
      load_pack<M>(c, C + i * P + e);
      const bool m = mask[i * mstride] != 0;
      const float mf = m ? 1.0f : 0.0f;
      add_row<M>(acc, i, covered, mf, x, c, div, inv_n);
      if (m) encode<M>(c, x);
      store_pack<M>(Cn + i * P + e, c);
    }
    float4* gp = reinterpret_cast<float4*>(g + e);
    __stcs(gp, make_float4(acc[0], acc[1], acc[2], acc[3]));
    __stcs(gp + 1, make_float4(acc[4], acc[5], acc[6], acc[7]));
  }
}

template <typename M>
__global__ void __launch_bounds__(THREADS)
masked_aggregate_scalar(const float* __restrict__ G, const typename M::Bits* __restrict__ C,
                        const uint8_t* __restrict__ mask, int64_t mstride,
                        float* __restrict__ g, typename M::Bits* __restrict__ Cn, int n,
                        int64_t P) {
  const float cnt = mask_count(mask, mstride, n);
  const bool covered = cnt > 0.0f;
  const float div = fmaxf(cnt, 1.0f);
  const float inv_n = __fdiv_rn(1.0f, static_cast<float>(n));
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x; e < P;
       e += stride) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float x = G[i * P + e];
      const typename M::Bits c = C[i * P + e];
      const bool m = mask[i * mstride] != 0;
      acc = add(acc, i, covered ? __fdiv_rn(__fmul_rn(m ? 1.0f : 0.0f, x), div)
                                : __fmul_rn(M::load(c), inv_n));
      Cn[i * P + e] = m ? static_cast<typename M::Bits>(M::store(x)) : c;
    }
    g[e] = acc;
  }
}

constexpr int MAX_DEVICES = 64;

// Blocks of a grid-stride launch of Kernel on device dev: enough for every
// element, at most as many as the card holds at once.  That count is
// found once a (device, kernel) and kept, so a launch makes no attribute
// or occupancy query.
template <auto Kernel>
int64_t grid_size(int dev, int64_t work) {
  static std::atomic<int64_t> known[MAX_DEVICES];   // 0: not found yet
  const bool keep = dev >= 0 && dev < MAX_DEVICES;
  int64_t resident = keep ? known[dev].load(std::memory_order_relaxed) : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, THREADS, 0);
    resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    if (keep) known[dev].store(resident, std::memory_order_relaxed);
  }
  const int64_t need = (work + THREADS - 1) / THREADS;
  return need < resident ? need : resident;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename M>
int launch(const float* G, const void* C, const uint8_t* mask, int64_t mstride, float* g,
           void* Cn, int n, int64_t P, int dev, cudaStream_t stream) {
  using Bits = typename M::Bits;
  const Bits* c = static_cast<const Bits*>(C);
  Bits* cn = static_cast<Bits*>(Cn);
  if (P % VEC == 0 && aligned16(G) && aligned16(C) && aligned16(g) && aligned16(Cn)) {
    const int64_t blocks = grid_size<masked_aggregate_vec<M>>(dev, P / VEC);
    masked_aggregate_vec<M><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        G, c, mask, mstride, g, cn, n, P);
  } else {
    const int64_t blocks = grid_size<masked_aggregate_scalar<M>>(dev, P);
    masked_aggregate_scalar<M><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        G, c, mask, mstride, g, cn, n, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int masked_aggregate_launch(const void* G, const void* C, const void* mask,
                                       long long mstride, void* g, void* Cn, int n,
                                       long long P, int mem, int device, void* stream) {
  if (n < 1 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* Gf = static_cast<const float*>(G);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* gf = static_cast<float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mem) {
    case 0: return launch<Bf16>(Gf, C, m, mstride, gf, Cn, n, P, device, s);
    case 1: return launch<F16>(Gf, C, m, mstride, gf, Cn, n, P, device, s);
    case 2: return launch<F32>(Gf, C, m, mstride, gf, Cn, n, P, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
