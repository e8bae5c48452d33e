// stacked_adam: one Adam step of many workers' parameters at once, on Hopper
// (sm_90a), f32, fused: the global-norm clip, the bias corrections, both
// moments and the update.
//
// Replaces no TPU kernel.  The reference steps its workers inside one XLA
// program (`vmap` of optax's Adam), which XLA fuses; the port's trainer
// keeps W workers' parameters stacked [W, ...] leaf by leaf (ten leaves for
// the five-layer Q-network) and steps them with this kernel.  For each row
// w, with the row's own int32 step t (t += 1 here) and f32 constants:
//
//   scale = min(1, clip / (norm + 1e-12)),  norm = sqrt(sum over the row's
//           leaves of g^2)
//   g'    = g * scale
//   m     = b1 * m + (1 - b1) * g'
//   v     = b2 * v + (1 - b2) * g'^2
//   p     = p + (-lr) * ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps))
//
// in optim/adam.py's order of operations, each operation rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction), and
// `clip / x` as PyTorch computes it, reciprocal then product.  So for the
// same gradients and scale every row comes out bit for bit as the plain
// version (ref.py) and optim/adam.py give it.  The norm sums the squares in
// f64 (exact products of f32 values) and rounds to f32 after the square
// root, so its value does not hang on the order of the sum, which differs
// from PyTorch's.
//
// What bounds it on this card.  At the paper's 512 workers x 2,693,825
// parameters (1.38e9 elements) it reads g once for the norms, then p, g, m
// and v and writes p, m and v: 44.1 GB, 13.2 ms at 3.35 TB/s; about 60
// f32 operations an element (three correctly rounded divisions and a
// square root among them) are 2-3 ms of the SMs' issue rate.  It is bound
// by bandwidth.
//
// Design.  Three launches on the caller's stream.  (1) row_sq_partials: a
// grid of (tiles, rows), a tile being 4,096 elements of one leaf of one row;
// each thread sums 16 squares in f64, the block reduces in a fixed tree and
// writes one partial.  (2) row_finalize: one block a row sums its partials
// in a fixed order, takes the scale, increments the step and writes the
// row's scale and both bias corrections (so no block of the update reads a
// step that another block writes).  (3) adam_rows: the same grid as (1);
// each thread updates its 16 elements in place, as four float4 loads of
// each of p, g, m and v where the leaf allows (row size a multiple of 4 and
// 16-byte aligned rows), else as coalesced scalars.  A gradient's row
// stride may be 0: every row then reads one gradient (the fleet's mean in
// step mode).  Every sum has a fixed order, so two launches on the same
// input are bit-identical.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;

struct Leaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long numel[kMaxLeaves];      // elements of one row of the leaf
  long long g_stride[kMaxLeaves];   // the gradient's row stride: numel or 0
  long long tile0[kMaxLeaves + 1];  // the leaf's first tile; tile0[n] = all
  int vec[kMaxLeaves];              // float4 access
  int n;
};

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long numel, g_stride, tile0;
  int vec;
};

// The leaf that holds `tile`: the last one that starts at or before it
// (an empty leaf starts where the next one does).  Unrolled, so that the
// kernel parameters are read at fixed offsets and never copied to local
// memory for a dynamic index.
__device__ __forceinline__ Leaf leaf_at(const Leaves& L, long long tile) {
  Leaf f{};
#pragma unroll
  for (int j = 0; j < kMaxLeaves; ++j)
    if (j < L.n && tile >= L.tile0[j])
      f = Leaf{L.p[j], L.g[j], L.m[j], L.v[j], L.numel[j], L.g_stride[j],
               L.tile0[j], L.vec[j]};
  return f;
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
row_sq_partials(const Leaves L, long long tiles, double* partials) {
  const long long row = blockIdx.y;
  const long long tile = blockIdx.x;
  const Leaf f = leaf_at(L, tile);
  const long long first = (tile - f.tile0) * kTile;
  const long long n = f.numel;
  const float* g = f.g + row * f.g_stride;
  double acc = 0.0;
  if (f.vec) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      const long long i = first / 4 + threadIdx.x + k * kThreads;
      if (i < n / 4) {
        const float4 x = g4[i];
        acc += sq(x.x) + sq(x.y) + sq(x.z) + sq(x.w);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = first + threadIdx.x + k * kThreads;
      if (i < n) acc += sq(g[i]);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[row * tiles + tile] = acc;
}

__global__ void __launch_bounds__(kThreads)
row_finalize(const double* partials, long long tiles, int* step,
             float* row_out, float b1, float b2, float clip) {
  const long long row = blockIdx.x;
  double acc = 0.0;
  for (long long t = threadIdx.x; t < tiles; t += kThreads)
    acc += partials[row * tiles + t];
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    const float norm = static_cast<float>(sqrt(acc));
    const float tiny = static_cast<float>(1e-12);
    const float s = __fmul_rn(__frcp_rn(__fadd_rn(norm, tiny)), clip);
    const float scale = isnan(s) ? s : fminf(s, 1.0f);   // torch.clamp(max=1)
    const int t = step[row] + 1;
    step[row] = t;
    const float tf = static_cast<float>(t);
    row_out[3 * row] = scale;
    row_out[3 * row + 1] = __fsub_rn(1.0f, powf(b1, tf));
    row_out[3 * row + 2] = __fsub_rn(1.0f, powf(b2, tf));
  }
}

struct Consts {
  float scale, bc1, bc2, neg_lr, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v,
                                          const Consts& c) {
  const float gs = __fmul_rn(g, c.scale);
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, gs));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(gs, gs)));
  const float m_hat = __fdiv_rn(m, c.bc1);
  const float v_hat = __fdiv_rn(v, c.bc2);
  const float delta = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), c.eps));
  p = __fadd_rn(p, __fmul_rn(c.neg_lr, delta));
}

__global__ void __launch_bounds__(kThreads)
adam_rows(const Leaves L, const float* row_in, float neg_lr, float b1,
          float omb1, float b2, float omb2, float eps) {
  const long long row = blockIdx.y;
  const long long tile = blockIdx.x;
  const Leaf f = leaf_at(L, tile);
  const long long first = (tile - f.tile0) * kTile;
  const long long n = f.numel;
  const Consts c{row_in[3 * row], row_in[3 * row + 1], row_in[3 * row + 2],
                 neg_lr, b1, omb1, b2, omb2, eps};
  float* p = f.p + row * n;
  float* m = f.m + row * n;
  float* v = f.v + row * n;
  const float* g = f.g + row * f.g_stride;
  if (f.vec) {
    constexpr int kVec = kPerThread / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4 pr[kVec], gr[kVec], mr[kVec], vr[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long i = first / 4 + threadIdx.x + k * kThreads;
      if (i < n / 4) {
        pr[k] = p4[i];
        gr[k] = g4[i];
        mr[k] = m4[i];
        vr[k] = v4[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long i = first / 4 + threadIdx.x + k * kThreads;
      if (i < n / 4) {
        adam_elem(pr[k].x, gr[k].x, mr[k].x, vr[k].x, c);
        adam_elem(pr[k].y, gr[k].y, mr[k].y, vr[k].y, c);
        adam_elem(pr[k].z, gr[k].z, mr[k].z, vr[k].z, c);
        adam_elem(pr[k].w, gr[k].w, mr[k].w, vr[k].w, c);
        p4[i] = pr[k];
        m4[i] = mr[k];
        v4[i] = vr[k];
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = first + threadIdx.x + k * kThreads;
      if (i < n) {
        float pi = p[i], mi = m[i], vi = v[i];
        adam_elem(pi, g[i], mi, vi, c);
        p[i] = pi;
        m[i] = mi;
        v[i] = vi;
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15ull) == 0;
}

}  // namespace

extern "C" {

int stacked_adam_tile() { return kTile; }

// One Adam step of n_rows rows of n_leaves stacked leaves on `stream`.
// `info` is host memory, six int64 a leaf: p, g, m, v (device pointers),
// the elements of one row, and the gradient's row stride (that count, or
// 0).  `partials` holds n_rows x (the leaves' tiles of kTile elements)
// doubles, `row_scratch` n_rows x 3 floats.  Returns the first CUDA error
// of the launches (0 when all were accepted).
int stacked_adam_step(const long long* info, int n_leaves, int n_rows,
                      int* step, double* partials, float* row_scratch,
                      float neg_lr, float b1, float omb1, float b2, float omb2,
                      float eps, float clip, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_rows < 1 || n_rows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Leaves L{};
  long long tiles = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* d = info + 6 * l;
    L.p[l] = reinterpret_cast<float*>(d[0]);
    L.g[l] = reinterpret_cast<const float*>(d[1]);
    L.m[l] = reinterpret_cast<float*>(d[2]);
    L.v[l] = reinterpret_cast<float*>(d[3]);
    L.numel[l] = d[4];
    L.g_stride[l] = d[5];
    L.vec[l] = d[4] % 4 == 0 && aligned16(L.p[l]) && aligned16(L.g[l]) &&
               aligned16(L.m[l]) && aligned16(L.v[l]);
    L.tile0[l] = tiles;
    tiles += (d[4] + kTile - 1) / kTile;
  }
  L.tile0[n_leaves] = tiles;
  L.n = n_leaves;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(n_rows));
  if (tiles > 0) {
    row_sq_partials<<<grid, kThreads, 0, s>>>(L, tiles, partials);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  row_finalize<<<n_rows, kThreads, 0, s>>>(partials, tiles, step, row_scratch,
                                           b1, b2, clip);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (tiles > 0) {
    adam_rows<<<grid, kThreads, 0, s>>>(L, row_scratch, neg_lr, b1, omb1, b2,
                                        omb2, eps);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  return 0;
}

const char* stacked_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
