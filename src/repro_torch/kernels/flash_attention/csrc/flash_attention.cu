// flash_attention: blocked online-softmax GQA attention on Hopper (sm_90a),
// f32 FFMA with f32 softmax statistics and accumulator.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd
// (body _fa_kernel).  For batch b, query head h and query row qi:
//
//   o[b, qi, h] = sum_j softmax_j(s_ij) v[b, j, h / (H / K)],
//   s_ij = (q[b, qi, h] * D^-0.5) . k[b, j, h / (H / K)]   where mask(qi, j)
//
// mask = (j < Sk) & causal & window, then | ((j < prefix_len) & (j < Sk)),
// exactly _fa_kernel's: masked scores are the -1e30 sentinel, their p is
// forced to 0, and the output is acc / max(l, 1e-30), so a row with no
// valid key gives 0, not NaN.  Rows qi >= Sq are computed on zero queries
// and dropped on store (Pallas pads them).
//
// Layout.  q, k, v and o are [B, S, heads, D] with a unit stride on D; the
// other strides are arguments, so the model's [B, S, H, D] projections are
// read as they are and the reference wrapper's transposes disappear.
//
// What bounds it on this card.  At the prefill path's shape (B = 2,
// S = 4096, 32 heads of 64, causal) the work is 4 D FLOP for each of the
// 5.37e8 unmasked (query, key) pairs, 1.37e11 FLOP, against 134 MB of q, k,
// v and o: 0.139 ms of bf16 tensor-core time or 2.05 ms of f32 FFMA at
// 67 TFLOP/s, and 0.040 ms of HBM traffic at 3.35 TB/s.  So operations
// bound it, and this kernel, which multiplies in f32 FFMA, is bounded by
// the FFMA figure; wgmma on bf16 tiles with TMA loads is later work.
//
// Design.  One block of 256 threads per (64-query tile, head, batch).  The
// block stages its q tile (scaled, f32) once, then walks 64-key tiles: k and
// v in f32 in shared memory, s = q k^T as 4 x 4 register tiles per thread
// (16 threads per query row, so the row max and sum are 4 shuffles), p
// through shared memory into the [64, D] accumulator held in registers
// (4 rows x D/16 columns per thread).  A key tile that the mask empties for
// every row of the query tile is skipped: in _fa_kernel such a tile leaves
// m, l and the accumulator unchanged, bit for bit, so skipping it is exact;
// for the causal path it halves the work.  Rows of k and q are padded to
// D + 1 floats so the k-row reads of a warp fall in 16 different banks.
//
// Determinism.  Every sum has a fixed order (d = 0..D-1, keys in tile
// order, the fixed shuffle tree); no atomics, so two launches are
// bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // queries per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16: ty picks 4 rows, tx 4 (or D/16) columns
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;
};

struct Mask {
  int causal, window, prefix_len;   // window <= 0: no window
};

__device__ __forceinline__ bool valid(int qi, int kj, int Sk, Mask mk) {
  bool ok = kj < Sk;
  if (mk.causal) ok = ok && (kj <= qi);
  if (mk.window > 0) ok = ok && (kj > qi - mk.window);
  if (mk.prefix_len > 0) ok = ok || ((kj < mk.prefix_len) && (kj < Sk));
  return ok;
}

// Could any (query, key) pair of this tile pair be valid?  Exact for the
// union of per-row intervals (qi - window, qi], which is contiguous.
__device__ __forceinline__ bool tile_live(int q0, int qmax, int k0, int Sk,
                                          Mask mk) {
  const int kmax = min(k0 + BK, Sk) - 1;
  if (mk.prefix_len > 0 && k0 < min(mk.prefix_len, Sk)) return true;
  if (mk.causal && k0 > qmax) return false;
  if (mk.window > 0 && kmax <= q0 - mk.window) return false;
  return true;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int K, int Sq,
          int Sk, Strides qs, Strides ks, Strides vs, Strides os, float scale,
          Mask mk) {
  constexpr int DP = D + 1;    // padded row of q and k tiles
  constexpr int PP = BK + 1;   // padded row of the p tile
  constexpr int CJ = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][DP]
  float* Ks = Qs + BQ * DP;      // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][PP]

  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int idx = t; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    Qs[r * DP + d] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * qs.s + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }

  const int qmax = min(q0 + BQ, Sq) - 1;
  const int nk = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (!tile_live(q0, qmax, k0, Sk, mk)) continue;   // uniform over the block
    __syncthreads();   // the previous tile's readers are done (and Qs is staged)
    for (int idx = t; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < Sk;
      Ks[r * DP + d] = in ? to_f(kb[(k0 + r) * ks.s + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = valid(qi, k0 + tx + 16 * j, Sk, mk);
        if (!ok[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();   // a row's p is written and read by the same 16 lanes

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      ob[qi * os.s + tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int K, int Sq, int Sk, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, Mask mk,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) +
                                               BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, K, Sq, Sk, qs, ks, vs,
      os, scale, mk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int K, int Sq, int Sk, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale, Mask mk,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs, os, scale, mk, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs, os, scale, mk, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs, os, scale, mk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (q, k, v and o alike); head_dim in
// {32, 64, 128}; strides in elements, D contiguous; scale is D^-0.5 as the
// caller rounds it to f32; window <= 0 means none.
// Returns the launch's CUDA error (0 when it was accepted).
int flash_attention_forward(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, void* o, int B,
                            int H, int K, int Sq, int Sk, long long qsb,
                            long long qss, long long qsh, long long ksb,
                            long long kss, long long ksh, long long vsb,
                            long long vss, long long vsh, long long osb,
                            long long oss, long long osh, float scale,
                            int causal, int window, int prefix_len,
                            void* stream) {
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const Mask mk{causal, window, prefix_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(head_dim, q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs,
                             os, scale, mk, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(head_dim, q, k, v, o, B, H, K, Sq, Sk, qs,
                                     ks, vs, os, scale, mk, st);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
