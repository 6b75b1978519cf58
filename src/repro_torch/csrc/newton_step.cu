// Diagonal Newton step of RANL for deep networks, for Hopper (sm_90a),
// CUDA C++: three multi-tensor passes, each one launch over every leaf.
//
// The step (src/repro_torch/optim/ranl_llm.py::newton_step; the
// reference's plain jnp `newton`, src/repro/optim/ranl_llm.py:384) acts on
// groups of leaves: a per-layer leaf of every layer that holds it, or one
// glue leaf.  For a group of leaves p, g (the aggregate) and h (the
// curvature), n elements in all:
//
//     floor = mu + mu_rel * (sum h * (1 / n))
//     D     = (lr * g) / max(h, floor)                         (never stored)
//     scale = min(1, trust * (||p|| + 1) / max(||D||, dn_min))
//     p'    = p - scale * D                                    (a new tensor)
//
// and ||g||^2, the round's gradient norm.  The trust ratio needs each
// group's ||D|| and ||p|| before any element can be written, so the work
// takes two passes over p, g and h and a pass over h before them:
//
//   pass 0 (S): each group's sum h, then its floor;
//   pass 1 (A): reads g, h and p, gives each group's ||D||^2, ||p||^2 and
//               ||g||^2;
//   pass 2 (B): reads p, g and h, takes scale from the group's sums and
//               writes p'.
//
// A group may come with its sum h given (with the count its mean divides
// by: a leaf cut over a "model" mesh axis) or its ||p||^2 given (taken from
// the gathered leaf); pass 0 then reads no h and pass 1 no p for it.
//
// Every operation is an IEEE f32 intrinsic with no fused multiply-add, and
// max and min propagate NaN as torch.maximum and torch.clamp do, so D and
// p' equal the eager formula run on the card (kernels/ref.py::
// newton_update_ref) bit for bit given the same floor and scale; the floor
// takes sum h * (1 / n) as PyTorch divides a tensor by a number there.
//
// What bounds it on this card: bytes, 32 a parameter (4 in pass 0, 12 in
// pass 1, 16 in pass 2; 28 where ||p||^2 is given) at a few operations a
// byte.  The eager step it replaces moved 72 and launched ~11 kernels a
// leaf.  What the design does about it:
//
//  * One launch a pass over every leaf of the round.  A device table (one
//    copy from pinned memory a call) lists each leaf's addresses, size,
//    group and chunk; a block takes chunks from a counter in turn (an
//    integer atomic), larger chunks first, and finds a chunk's leaf by a
//    binary search over the leaves' first chunks, held in shared memory.
//  * A chunk's size adapts to its group's: at least 4 steps of 2048
//    elements, and as many more as keep the group at 4096 chunks (and one
//    more for each leaf's ragged end).  A 3072-float norm is one chunk, a
//    614.6 M-float head 4056 of 151552 elements.
//  * A step of a block is 2048 elements: two 16-byte evict-first loads of
//    each array a thread, a warp's loads 512 contiguous bytes; a leaf whose
//    addresses are not all 16-byte aligned, and each leaf's last < 2048
//    elements, go one element a thread a step.
//  * Sums in a fixed order: a thread's elements in order, a warp's by a
//    fixed shuffle tree, the warps' in order, then each chunk's partial is
//    stored; the block that finishes a group's last chunk (an integer
//    counter a group) sums the group's partials in chunk order.  No float
//    atomics: two runs give the same bits, whatever block took a chunk.
//  * The host never waits: floor, sums and scale stay on the card.
//
// Launch: newton_step_launch(pass, table, work, T, G, C, lr, mu, mu_rel,
// trust, dn_min, device, stream).  table (int64 words, on the card): T
// leaves of 8 words {p, g, h, out, n, chunk, first chunk, group | aligned
// << 32} sorted by chunk size (largest first, stable), then G groups of 5
// words {first partial, partials, count, &sum h or 0, &||p||^2 or 0}, then
// 3 + 2 G zeroed counters (a chunk counter a pass, a done counter a group
// for passes 0 and 1).  work (f32, on the card): 4 C partials, then the
// G x 4 group rows {floor, ||D||^2, ||p||^2, ||g||^2}.  Returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEP = 2048;        // elements a block a step
constexpr int HALF = STEP / 2;    // a warp's float4 loads cover 512 bytes

struct Leaf {
  const float* p;
  const float* g;
  const float* h;
  float* out;
  long long n;
  long long chunk;
  long long first;
  int group;
  int aligned;
};

struct Group {
  long long first;
  long long parts;
  long long count;
  const float* hsum;
  const float* pn2;
};

struct Args {
  const Leaf* leaves;
  const Group* groups;
  unsigned long long* counters;
  float* work;
  int T;
  int G;
  long long C;
  float lr, mu, mu_rel, trust, dn_min;
};

static_assert(sizeof(Leaf) == 64, "a leaf is 8 words of the table");
static_assert(sizeof(Group) == 40, "a group is 5 words of the table");

// torch.maximum / torch.clamp on f32: NaN in, NaN out
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float delta(float lr, float g, float h, float floor) {
  return __fdiv_rn(__fmul_rn(lr, g), max_nan(h, floor));
}

__device__ __forceinline__ float add_sq(float acc, float x) {
  return __fadd_rn(acc, __fmul_rn(x, x));
}

__device__ __forceinline__ void unpack(const float4& v, float (&x)[4]) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// The K sums of a block, in a fixed order, in thread 0; red is reused by
// the next call only after a __syncthreads.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (&red)[K][WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = __fadd_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
    if (lane == 0) red[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = red[k][0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, red[k][w]);
      v[k] = s;
    }
  }
}

// The leaf whose chunks hold chunk c: the last with first <= c.
__device__ __forceinline__ int find_leaf(const unsigned* firsts, int T, unsigned c) {
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (firsts[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Elements [lo, hi) of a leaf: whole steps two float4 a thread (where the
// leaf is aligned), the rest one element a thread a step.
template <class Body>
__device__ __forceinline__ void walk(const Leaf& L, long long lo, long long hi, Body& body) {
  long long e = lo;
  if (L.aligned) {
    for (; e + STEP <= hi; e += STEP) body.step(e + 4 * threadIdx.x, e + HALF + 4 * threadIdx.x);
  }
  for (long long i = e + threadIdx.x; i < hi; i += THREADS) body.one(i);
}

struct SumH {
  const float* h;
  float acc[1];
  __device__ __forceinline__ void step(long long e0, long long e1) {
    float a[4], b[4];
    unpack(__ldcs(reinterpret_cast<const float4*>(h + e0)), a);
    unpack(__ldcs(reinterpret_cast<const float4*>(h + e1)), b);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[0] = __fadd_rn(acc[0], a[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[0] = __fadd_rn(acc[0], b[k]);
  }
  __device__ __forceinline__ void one(long long i) { acc[0] = __fadd_rn(acc[0], h[i]); }
};

// ||D||^2, ||p||^2 (unless given: WITH_P false) and ||g||^2
template <bool WITH_P>
struct Norms {
  const float* p;
  const float* g;
  const float* h;
  float lr, floor;
  float acc[3];
  __device__ __forceinline__ void add(float pv, float gv, float hv) {
    acc[0] = add_sq(acc[0], delta(lr, gv, hv, floor));
    if (WITH_P) acc[1] = add_sq(acc[1], pv);
    acc[2] = add_sq(acc[2], gv);
  }
  __device__ __forceinline__ void step(long long e0, long long e1) {
    float g0[4], g1[4], h0[4], h1[4], p0[4] = {}, p1[4] = {};
    unpack(__ldcs(reinterpret_cast<const float4*>(g + e0)), g0);
    unpack(__ldcs(reinterpret_cast<const float4*>(g + e1)), g1);
    unpack(__ldcs(reinterpret_cast<const float4*>(h + e0)), h0);
    unpack(__ldcs(reinterpret_cast<const float4*>(h + e1)), h1);
    if (WITH_P) {
      unpack(__ldcs(reinterpret_cast<const float4*>(p + e0)), p0);
      unpack(__ldcs(reinterpret_cast<const float4*>(p + e1)), p1);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) add(p0[k], g0[k], h0[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) add(p1[k], g1[k], h1[k]);
  }
  __device__ __forceinline__ void one(long long i) { add(WITH_P ? p[i] : 0.0f, g[i], h[i]); }
};

struct Update {
  const float* p;
  const float* g;
  const float* h;
  float* out;
  float lr, floor, scale;
  __device__ __forceinline__ float at(float pv, float gv, float hv) const {
    return __fsub_rn(pv, __fmul_rn(scale, delta(lr, gv, hv, floor)));
  }
  __device__ __forceinline__ void step(long long e0, long long e1) {
    float p0[4], p1[4], g0[4], g1[4], h0[4], h1[4];
    unpack(__ldcs(reinterpret_cast<const float4*>(p + e0)), p0);
    unpack(__ldcs(reinterpret_cast<const float4*>(p + e1)), p1);
    unpack(__ldcs(reinterpret_cast<const float4*>(g + e0)), g0);
    unpack(__ldcs(reinterpret_cast<const float4*>(g + e1)), g1);
    unpack(__ldcs(reinterpret_cast<const float4*>(h + e0)), h0);
    unpack(__ldcs(reinterpret_cast<const float4*>(h + e1)), h1);
    __stcs(reinterpret_cast<float4*>(out + e0),
           make_float4(at(p0[0], g0[0], h0[0]), at(p0[1], g0[1], h0[1]),
                       at(p0[2], g0[2], h0[2]), at(p0[3], g0[3], h0[3])));
    __stcs(reinterpret_cast<float4*>(out + e1),
           make_float4(at(p1[0], g1[0], h1[0]), at(p1[1], g1[1], h1[1]),
                       at(p1[2], g1[2], h1[2]), at(p1[3], g1[3], h1[3])));
  }
  __device__ __forceinline__ void one(long long i) { out[i] = at(p[i], g[i], h[i]); }
};

// The group's scale from its row {floor, ||D||^2, ||p||^2, ||g||^2}.
__device__ __forceinline__ float trust_scale(const float* row, float trust, float dn_min) {
  const float pn = __fsqrt_rn(row[2]), dn = __fsqrt_rn(row[1]);
  return min_nan(__fdiv_rn(__fmul_rn(trust, __fadd_rn(pn, 1.0f)), max_nan(dn, dn_min)), 1.0f);
}

// Store a chunk's K partial sums (thread 0 holds them) and, in the block
// that stores a group's last, sum the group's partials in chunk order.
// Returns true, with the sums in thread 0's v, in that block.
template <int K>
__device__ __forceinline__ bool finish_chunk(float (&v)[K], float (&red)[K][WARPS],
                                             float* parts, long long C, long long c,
                                             const Group& grp, unsigned long long* done,
                                             int* last) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) parts[k * C + c] = v[k];
    __threadfence();
    const unsigned long long before = atomicAdd(done, 1ull);
    *last = before + 1 == static_cast<unsigned long long>(grp.parts);
  }
  __syncthreads();
  if (!*last) return false;
  __threadfence();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = 0.0f;
  for (long long i = threadIdx.x; i < grp.parts; i += THREADS) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __fadd_rn(v[k], __ldcg(parts + k * C + grp.first + i));
  }
  block_sum<K>(v, red);
  return true;
}

template <int PASS>
__global__ void __launch_bounds__(THREADS) newton_pass(const Args a) {
  extern __shared__ unsigned firsts[];   // T + 1: each leaf's first chunk, then C
  constexpr int K = PASS == 1 ? 3 : 1;
  __shared__ float red[K][WARPS];
  __shared__ long long next;
  __shared__ int last;
  for (int i = threadIdx.x; i < a.T; i += THREADS)
    firsts[i] = static_cast<unsigned>(a.leaves[i].first);
  if (threadIdx.x == 0) {
    firsts[a.T] = static_cast<unsigned>(a.C);
    next = static_cast<long long>(atomicAdd(a.counters + PASS, 1ull));
  }
  __syncthreads();
  float* parts = a.work + (PASS == 0 ? 0 : a.C);   // pass 0: 1 C, pass 1: 3 C
  float* rows = a.work + 4 * a.C;
  for (long long c = next; c < a.C; c = next) {
    __syncthreads();   // every thread has read next
    if (threadIdx.x == 0) next = static_cast<long long>(atomicAdd(a.counters + PASS, 1ull));
    const Leaf L = a.leaves[find_leaf(firsts, a.T, static_cast<unsigned>(c))];
    const Group grp = a.groups[L.group];
    float* row = rows + 4 * L.group;
    const long long lo = (c - L.first) * L.chunk;
    const long long hi = lo + L.chunk < L.n ? lo + L.chunk : L.n;
    if constexpr (PASS == 0) {
      SumH body{L.h, {0.0f}};
      if (grp.hsum == nullptr) walk(L, lo, hi, body);
      block_sum<1>(body.acc, red);
      if (finish_chunk<1>(body.acc, red, parts, a.C, c, grp,
                          a.counters + 3 + L.group, &last) && threadIdx.x == 0) {
        const float hs = grp.hsum != nullptr ? *grp.hsum : body.acc[0];
        const float inv = __fdiv_rn(1.0f, __ll2float_rn(grp.count));
        row[0] = __fadd_rn(a.mu, __fmul_rn(a.mu_rel, __fmul_rn(hs, inv)));
      }
    } else if constexpr (PASS == 1) {
      const float floor = row[0];
      float v[3];
      if (grp.pn2 == nullptr) {
        Norms<true> body{L.p, L.g, L.h, a.lr, floor, {0.0f, 0.0f, 0.0f}};
        walk(L, lo, hi, body);
        v[0] = body.acc[0]; v[1] = body.acc[1]; v[2] = body.acc[2];
      } else {
        Norms<false> body{L.p, L.g, L.h, a.lr, floor, {0.0f, 0.0f, 0.0f}};
        walk(L, lo, hi, body);
        v[0] = body.acc[0]; v[1] = body.acc[1]; v[2] = body.acc[2];
      }
      block_sum<3>(v, red);
      if (finish_chunk<3>(v, red, parts, a.C, c, grp,
                          a.counters + 3 + a.G + L.group, &last) && threadIdx.x == 0) {
        row[1] = v[0];
        row[2] = grp.pn2 != nullptr ? *grp.pn2 : v[1];
        row[3] = v[2];
      }
    } else {
      Update body{L.p, L.g, L.h, L.out, a.lr, row[0], trust_scale(row, a.trust, a.dn_min)};
      walk(L, lo, hi, body);
    }
    __syncthreads();   // next is written; red and last are free again
  }
}

constexpr int MAX_DEVICES = 64;

int sm_count(int dev) {
  static int known[MAX_DEVICES];   // 0: not read yet
  const bool keep = dev >= 0 && dev < MAX_DEVICES;
  int sms = keep ? known[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (keep) known[dev] = sms;
  }
  return sms;
}

template <int PASS>
int launch(const Args& a, int dev, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(a.T) + 1) * sizeof(unsigned);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, newton_pass<PASS>, THREADS, smem);
  const long long resident = static_cast<long long>(sm_count(dev)) * (per_sm > 0 ? per_sm : 1);
  const long long blocks = a.C < resident ? a.C : resident;
  newton_pass<PASS><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int newton_step_launch(int pass, const void* table, void* work, int T, int G,
                                  long long C, float lr, float mu, float mu_rel, float trust,
                                  float dn_min, int device, void* stream) {
  if (T < 1 || G < 1 || C < T || T > 8192 || C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* words = static_cast<const long long*>(table);
  Args a;
  a.leaves = reinterpret_cast<const Leaf*>(words);
  a.groups = reinterpret_cast<const Group*>(words + 8LL * T);
  a.counters = reinterpret_cast<unsigned long long*>(const_cast<long long*>(words + 8LL * T + 5LL * G));
  a.work = static_cast<float*>(work);
  a.T = T;
  a.G = G;
  a.C = C;
  a.lr = lr;
  a.mu = mu;
  a.mu_rel = mu_rel;
  a.trust = trust;
  a.dn_min = dn_min;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pass) {
    case 0: return launch<0>(a, device, s);
    case 1: return launch<1>(a, device, s);
    case 2: return launch<2>(a, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
