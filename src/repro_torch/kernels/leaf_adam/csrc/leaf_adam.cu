// leaf_adam: one Adam step over a list of leaves of mixed types, in place,
// on Hopper (sm_90a): the global-norm clip, both moments and the update of
// optim/adam.py's `update` followed by `apply_updates`, fused.
//
// Replaces no TPU kernel.  The reference's LM train step runs optax's Adam
// inside one XLA program that donates the parameters and the optimizer
// state (`donate_argnums=(0, 1)`), so XLA updates them in place; the port's
// LM train step (`launch/steps.make_train_step`) steps its leaves with this
// kernel.  A leaf's parameter and gradient are bf16 or f32 (one tag for
// both), its moments f32.  With the f32 bias corrections bc1 = 1 - b1^t,
// bc2 = 1 - b2^t and the learning rate lr_t read from device memory (so a
// schedule keeps working), for every element:
//
//   scale = min(1, clip / (norm + 1e-12)),  norm = sqrt(sum over every leaf
//           of g^2)
//   g'    = (g * scale) in g's type
//   m     = b1 * m + (1 - b1) * g'
//   v     = b2 * v + (1 - b2) * g'^2
//   d     = (m / bc1) / (sqrt(v / bc2) + eps)   [+ wd * p with weight decay]
//   u     = (-lr_t * d) in p's type
//   p     = (p + u) in p's type
//
// in optim/adam.py's order of operations as PyTorch runs them on the card,
// each rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no
// FMA contraction), with PyTorch's rounding points: a bf16 gradient meets
// the f32 scale rounded to bf16 (CUDA's binary kernels load a 0-dim tensor
// of another type in the common type, bf16), the product is rounded to bf16,
// the update is rounded to bf16 before the bf16 add, and `clip / x` is a
// reciprocal then a product.  So for the same norm every element comes out
// bit for bit as the plain version (ref.py) gives it on the card.  The norm
// sums the squares in f64 (exact products of f32 values) and rounds to f32
// after the square root: its value does not hang on the order of the sum
// (which differs from PyTorch's per-leaf sums in f32) beyond the last bit,
// and the order here is fixed, so two launches give the same bits.
//
// What bounds it on this card.  Per element it reads g once for the norm,
// then p, g, m and v, and writes p, m and v: 24 bytes for a bf16 leaf (36
// for an f32 one).  At Moonlight-16B-A3B's share (2.78e9 elements, nearly
// all bf16) that is 66.7 GB, 19.9 ms at 3.35 TB/s; about 30 f32 operations
// an element (three correctly rounded divisions and a square root among
// them) are a few ms of the SMs' issue rate.  It is bound by bandwidth.
//
// Design.  Leaves come in tables of up to kMaxLeaves, passed by value
// (__grid_constant__: indexed in the parameter space, never copied to local
// memory); more leaves take one launch of each pass per table.  A leaf is
// cut into units of 8 elements, numbered across the table's leaves: one
// 16-byte load of a bf16 gradient or parameter, two of an f32 one or of a
// moment.  (1) sq_partials: a fixed grid (kBlocks x kThreads, the same on
// any card) in which thread t takes units t, t + kBlocks * kThreads, ...,
// following the leaves with a cursor; each thread sums its squares in f64,
// the block reduces in a fixed tree and writes one partial per block and
// table.  (2) finalize: one block sums every table's partials in a fixed
// order and writes the scale.  (3) adam_leaves: one unit a thread, found by
// bisection over the table; all four loads are issued before the arithmetic
// and the unit is written back in place (on an H100 at the share's leaves,
// keeping a thread to one unit measured 20.1 ms against 28.3 ms for four
// units a thread in a loop).  A leaf whose pointers are not 16-byte aligned, and the
// last unit of a leaf whose size is no multiple of 8, go element by element.
// Without a clip, (1) and (2) do not run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kBlocks = 1024;
constexpr int kUnit = 8;          // elements a unit

struct Leaf {
  void* p;
  const void* g;
  float* m;
  float* v;
  long long numel;
  long long unit0;                // the leaf's first unit in the table
  int bf16;                       // p and g are bf16 (else f32)
  int vec;                        // p, g, m and v are 16-byte aligned
};

struct Table {
  Leaf leaf[kMaxLeaves];
  long long units;                // units of every leaf of the table
  int n;
};

__device__ __forceinline__ long long unit_end(const Leaf& f) {
  return f.unit0 + (f.numel + kUnit - 1) / kUnit;
}

// The leaf that holds unit `u` < units: the last one that starts at or
// before it (an empty leaf starts where the next one does), by bisection
// over the table.
__device__ __forceinline__ int find(const Table& T, long long u) {
  int lo = 0, hi = T.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (T.leaf[mid].unit0 <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// From leaf `j`, the leaf that holds unit `u` >= its first unit.
__device__ __forceinline__ int advance(const Table& T, int j, long long u) {
  while (u >= unit_end(T.leaf[j])) ++j;
  return j;
}

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ unsigned short to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_bf16(float x) {
  return bf16_bits_to_float(to_bf16_bits(x));
}

// The 8 elements of a full, aligned unit as f32.
__device__ __forceinline__ void load8(const void* base, int bf16, long long e,
                                      float x[kUnit]) {
  if (bf16) {
    const uint4 r = *reinterpret_cast<const uint4*>(
        static_cast<const unsigned short*>(base) + e);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + e);
    const float4 a = q[0], b = q[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

__device__ __forceinline__ void store8(void* base, int bf16, long long e,
                                       const float x[kUnit]) {
  if (bf16) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = static_cast<unsigned>(to_bf16_bits(x[2 * k])) |
             (static_cast<unsigned>(to_bf16_bits(x[2 * k + 1])) << 16);
    *reinterpret_cast<uint4*>(static_cast<unsigned short*>(base) + e) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(base) + e);
    q[0] = make_float4(x[0], x[1], x[2], x[3]);
    q[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

__device__ __forceinline__ float load1(const void* base, int bf16, long long e) {
  return bf16 ? bf16_bits_to_float(static_cast<const unsigned short*>(base)[e])
              : static_cast<const float*>(base)[e];
}

__device__ __forceinline__ void store1(void* base, int bf16, long long e, float x) {
  if (bf16)
    static_cast<unsigned short*>(base)[e] = to_bf16_bits(x);
  else
    static_cast<float*>(base)[e] = x;
}

// Sum over the block in a fixed order: a shuffle tree in each warp, then
// warp 0 over the warps' sums.  The result is valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

__device__ __forceinline__ double sq(float x) {
  const double d = x;
  return d * d;
}

__global__ void __launch_bounds__(kThreads)
sq_partials(const __grid_constant__ Table T, double* partials) {
  const long long stride = static_cast<long long>(kBlocks) * kThreads;
  double acc = 0.0;
  long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int j = u < T.units ? find(T, u) : 0;
  for (; u < T.units; u += stride) {
    j = advance(T, j, u);
    const Leaf& f = T.leaf[j];
    const long long e = (u - f.unit0) * kUnit;
    if (f.vec && e + kUnit <= f.numel) {
      float x[kUnit];
      load8(f.g, f.bf16, e, x);
#pragma unroll
      for (int k = 0; k < kUnit; ++k) acc += sq(x[k]);
    } else {
      for (long long i = e; i < e + kUnit && i < f.numel; ++i)
        acc += sq(load1(f.g, f.bf16, i));
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
finalize(const double* partials, int n, float clip, float* scale) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    const float norm = static_cast<float>(sqrt(acc));
    const float tiny = static_cast<float>(1e-12);
    const float s = __fmul_rn(__frcp_rn(__fadd_rn(norm, tiny)), clip);
    *scale = isnan(s) ? s : fminf(s, 1.0f);   // torch.clamp(max=1)
  }
}

struct Consts {
  float scale, scale_bf16, neg_lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd;
  int clip, decay;
};

// One element: p and g as f32 (exact for bf16), m and v in place; returns
// the new parameter as f32 (exact in p's type).
__device__ __forceinline__ float adam_elem(float p, float g, float& m, float& v,
                                           int bf16, const Consts& c) {
  if (c.clip) g = bf16 ? round_bf16(__fmul_rn(g, c.scale_bf16)) : __fmul_rn(g, c.scale);
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float m_hat = __fdiv_rn(m, c.bc1);
  const float v_hat = __fdiv_rn(v, c.bc2);
  float d = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), c.eps));
  if (c.decay) d = __fadd_rn(d, __fmul_rn(c.wd, p));
  float u = __fmul_rn(c.neg_lr, d);
  if (bf16) u = round_bf16(u);
  const float q = __fadd_rn(p, u);
  return bf16 ? round_bf16(q) : q;
}

__global__ void __launch_bounds__(kThreads)
adam_leaves(const __grid_constant__ Table T, const float* scale,
            const float* lr_t, const float* bc1, const float* bc2, float b1,
            float omb1, float b2, float omb2, float eps, float wd, int clip,
            int decay) {
  Consts c;
  c.scale = clip ? *scale : 1.0f;
  c.scale_bf16 = round_bf16(c.scale);
  c.neg_lr = -*lr_t;
  c.bc1 = *bc1;
  c.bc2 = *bc2;
  c.b1 = b1; c.omb1 = omb1; c.b2 = b2; c.omb2 = omb2; c.eps = eps; c.wd = wd;
  c.clip = clip; c.decay = decay;
  const long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (u >= T.units) return;
  const Leaf& f = T.leaf[find(T, u)];
  const long long e = (u - f.unit0) * kUnit;
  if (f.vec && e + kUnit <= f.numel) {
    // every load in flight before the arithmetic
    float p[kUnit], g[kUnit], m[kUnit], v[kUnit];
    load8(f.p, f.bf16, e, p);
    load8(f.g, f.bf16, e, g);
    load8(f.m, 0, e, m);
    load8(f.v, 0, e, v);
#pragma unroll
    for (int i = 0; i < kUnit; ++i) p[i] = adam_elem(p[i], g[i], m[i], v[i], f.bf16, c);
    store8(f.p, f.bf16, e, p);
    store8(f.m, 0, e, m);
    store8(f.v, 0, e, v);
  } else {
    for (long long i = e; i < e + kUnit && i < f.numel; ++i) {
      float m1 = f.m[i], v1 = f.v[i];
      const float p1 = adam_elem(load1(f.p, f.bf16, i), load1(f.g, f.bf16, i),
                                 m1, v1, f.bf16, c);
      store1(f.p, f.bf16, i, p1);
      f.m[i] = m1;
      f.v[i] = v1;
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15ull) == 0;
}

}  // namespace

extern "C" {

int leaf_adam_max_leaves() { return kMaxLeaves; }
int leaf_adam_blocks() { return kBlocks; }

// One Adam step of n_leaves leaves on `stream`.  `info` is host memory,
// six int64 a leaf: p, g, m, v (device pointers), the element count, and
// 1 where p and g are bf16 (0: f32).  `partials` holds
// ceil(n_leaves / kMaxLeaves) x kBlocks doubles and `scale` one float (both
// unused without a clip); lr_t, bc1 and bc2 are device f32 scalars.
// Returns the first CUDA error of the launches (0 when all were accepted).
int leaf_adam_step(const long long* info, int n_leaves, double* partials,
                   float* scale, const float* lr_t, const float* bc1,
                   const float* bc2, float b1, float omb1, float b2, float omb2,
                   float eps, float wd, int decay, float clip, int clip_on,
                   void* stream) {
  if (n_leaves < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int tables = (n_leaves + kMaxLeaves - 1) / kMaxLeaves;
  // pass 0 fills the norm's partials (with a clip), pass 1 updates
  for (int pass = clip_on ? 0 : 1; pass < 2; ++pass) {
    for (int t = 0; t < tables; ++t) {
      Table T{};
      long long units = 0;
      const int lo = t * kMaxLeaves;
      T.n = n_leaves - lo < kMaxLeaves ? n_leaves - lo : kMaxLeaves;
      for (int l = 0; l < T.n; ++l) {
        const long long* d = info + 6 * (lo + l);
        Leaf& f = T.leaf[l];
        f.p = reinterpret_cast<void*>(d[0]);
        f.g = reinterpret_cast<const void*>(d[1]);
        f.m = reinterpret_cast<float*>(d[2]);
        f.v = reinterpret_cast<float*>(d[3]);
        f.numel = d[4];
        f.bf16 = d[5] != 0;
        f.vec = aligned16(f.p) && aligned16(f.g) && aligned16(f.m) && aligned16(f.v);
        f.unit0 = units;
        units += (d[4] + kUnit - 1) / kUnit;
      }
      T.units = units;
      if (pass == 0) {
        // an empty table still writes its block's partials (as zeros)
        sq_partials<<<kBlocks, kThreads, 0, s>>>(T, partials + static_cast<long long>(t) * kBlocks);
      } else if (units > 0) {
        const unsigned blocks = static_cast<unsigned>((units + kThreads - 1) / kThreads);
        adam_leaves<<<blocks, kThreads, 0, s>>>(T, scale, lr_t, bc1, bc2, b1, omb1,
                                                 b2, omb2, eps, wd, clip_on, decay);
      }
      if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    }
    if (pass == 0) {
      finalize<<<1, kThreads, 0, s>>>(partials, tables * kBlocks, clip, scale);
      if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    }
  }
  return 0;
}

const char* leaf_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
