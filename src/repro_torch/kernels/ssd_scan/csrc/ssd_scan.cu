// ssd_scan: the Mamba2 SSD chunked scan on Hopper (sm_90a), f32 FFMA with
// the [P, N] state in f32 in shared memory.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_blhp
// (body _ssd_kernel).  For batch b and head h (group g = h / (H / G)), over
// chunks of Q positions in order, with cum_q = sum_{u <= q} -A_h dt_u inside
// the chunk and total = cum_{Q-1}:
//
//   y_q = sum_{s <= q} (C_q . B_s) exp(cum_q - cum_s) dt_s x_s
//         + exp(cum_q) C_q S^T
//   S  <- exp(total) S + sum_u exp(total - cum_u) dt_u x_u B_u^T
//
// starting from S = 0 (no initial state, as in the Pallas kernel); the last
// S is the final state.  x [B, L, H, P], B and C [B, L, G, N] in x's type,
// dt [B, L, H] and A [H] in f32, all read by strides with a unit stride on
// the last dim, so the model's views into its conv output need no copy.  y
// [B, L, H, P] and the final state [B, H, P, N] are written contiguous in
// x's type.
//
// What bounds it on this card.  At the prefill path's shape (B = 2,
// L = 4096, H = 64, P = N = 64, G = 1, Q = 256) one (b, h, chunk) needs
// about 12.6 MFLOP with the causal half of the Q x Q products, 2.58e10 FLOP
// in all, against 140 MB of x, y, dt, B, C and the final state: 0.042 ms of
// HBM traffic at 3.35 TB/s, or 0.386 ms of f32 FFMA at 67 TFLOP/s.  This
// kernel multiplies in f32 FFMA, so the FFMA figure bounds it; with bf16
// tensor cores the bytes would.
//
// Design.  The Pallas grid walks a (b, h)'s chunks in order and carries
// the state in VMEM.  Here one block of 256 threads owns a (b, h) and loops
// over its chunks, so for the path's B x H = 128 there are 128 blocks on
// 132 SMs.  Per chunk it stages dt x [Q, P] in f32 and B, C [Q, N] in x's
// type in shared memory (231,936 bytes at Q = 256, P = N = 64 in f32, under
// the 232,448 a block may have), takes cum with one warp's scan, then for
// each 64-row query tile: the carry-in C S^T, and for each 64-row source tile
// at or below it the gated scores G = (C B^T) * exp(cum_q - cum_s) through
// shared memory into the [64, P] register accumulator (4 x 4 per thread).
// Source tiles above the diagonal are never computed.  Then the state update
// runs as 4 x 4 register tiles of [P, N].  A chunk-parallel redesign (all
// chunks' intra-chunk work at once, then a short pass over chunk states) and
// wgmma are later work.
//
// Determinism.  Every sum has a fixed order and there are no atomics, so
// two launches are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16: ty picks 4 rows, tx 4 columns
constexpr int TILE = 64;       // query / source tile
constexpr int GP = TILE + 1;   // padded row of the gate tile
constexpr int MAX_Q = 256, MAX_P = 64, MAX_N = 64;
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, l, h;   // h: the head (x, dt) or group (B, C) stride
};

// B's rows are padded so the 16 source rows a warp reads at one n fall in
// different banks: one f32 word, or one pair of bf16.
template <typename T>
__host__ __device__ constexpr int b_pitch(int n) { return n + 4 / (int)sizeof(T); }

template <typename T>
size_t smem_bytes(int Q, int P, int N) {
  return sizeof(float) * ((size_t)Q * P + (size_t)P * (N + 1) + Q + TILE * GP) +
         sizeof(T) * ((size_t)Q * b_pitch<T>(N) + (size_t)Q * N);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, T* __restrict__ fin,
           int L, int H, int G, int P, int N, int Q, Strides xs, Strides ds,
           Strides bs, Strides cs) {
  extern __shared__ float smem[];
  const int BP = b_pitch<T>(N), SP = N + 1;
  float* Xs = smem;                  // [Q][P]   dt_u x_u
  float* Ss = Xs + Q * P;            // [P][SP]  the state
  float* cum = Ss + P * SP;          // [Q]
  float* Gs = cum + Q;               // [TILE][GP]; also dt, then exp(total - cum)
  T* Bs = reinterpret_cast<T*>(Gs + TILE * GP);   // [Q][BP]
  T* Cs = Bs + Q * BP;                            // [Q][N]

  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h];
  const int TQ = Q < TILE ? Q : TILE;
  const T* xb = x + b * xs.b + h * xs.h;
  const float* db = dt + b * ds.b + h * ds.h;
  const T* bb = Bm + b * bs.b + g * bs.h;
  const T* cb = Cm + b * cs.b + g * cs.h;

  for (int idx = t; idx < P * N; idx += THREADS) Ss[(idx / N) * SP + idx % N] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();   // the previous chunk is done with every buffer
    for (int u = t; u < Q; u += THREADS) {
      const float d = db[(l0 + u) * ds.l];
      Gs[u] = d;
      cum[u] = -a * d;
    }
    __syncthreads();
    for (int idx = t; idx < Q * P; idx += THREADS) {
      const int u = idx / P, p = idx % P;
      Xs[idx] = to_f(xb[(l0 + u) * xs.l + p]) * Gs[u];
    }
    for (int idx = t; idx < Q * N; idx += THREADS) {
      const int u = idx / N, n = idx % N;
      Bs[u * BP + n] = bb[(l0 + u) * bs.l + n];
      Cs[idx] = cb[(l0 + u) * cs.l + n];
    }
    if (t < 32) {   // inclusive cumsum of cum[0..Q) by warp 0, in place
      const int per = (Q + 31) / 32, beg = t * per, end = min(beg + per, Q);
      float run = 0.f;
      for (int u = beg; u < end; ++u) {
        run += cum[u];
        cum[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (t >= off) incl += up;
      }
      const float before = incl - run;
      for (int u = beg; u < end; ++u) cum[u] += before;
    }
    __syncthreads();
    const float total = cum[Q - 1];

    for (int q0 = 0; q0 < Q; q0 += TQ) {
      float acc[4][4];
      // carry-in: exp(cum_q) C_q S^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
          cv[i] = r < TQ ? to_f(Cs[(q0 + r) * N + n]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          sv[j] = p < P ? Ss[p * SP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float e = r < TQ ? expf(cum[q0 + r]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // intra-chunk: source tiles at or below the diagonal
      for (int s0 = 0; s0 <= q0; s0 += TQ) {
        float gt[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gt[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            cv[i] = r < TQ ? to_f(Cs[(q0 + r) * N + n]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            bv[j] = c < TQ ? to_f(Bs[(s0 + c) * BP + n]) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) gt[i][j] = fmaf(cv[i], bv[j], gt[i][j]);
        }
        __syncthreads();   // the previous source tile's readers of Gs are done
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            if (r < TQ && c < TQ) {
              const int qg = q0 + r, sg = s0 + c;
              Gs[r * GP + c] = sg <= qg ? gt[i][j] * expf(cum[qg] - cum[sg]) : 0.f;
            }
          }
        }
        __syncthreads();
        for (int s = 0; s < TQ; ++s) {
          float gv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            gv[i] = r < TQ ? Gs[r * GP + s] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            xv[j] = p < P ? Xs[(s0 + s) * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (r >= TQ) continue;
        T* yr = y + (((long long)b * L + l0 + q0 + r) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yr[p] = from_f<T>(acc[i][j]);
        }
      }
    }

    __syncthreads();   // every reader of Gs and of the old state is done
    for (int u = t; u < Q; u += THREADS) Gs[u] = expf(total - cum[u]);
    __syncthreads();
    const float et = expf(total);
    float st[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        st[i][j] = (p < P && n < N) ? et * Ss[p * SP + n] : 0.f;
      }
    }
    for (int u = 0; u < Q; ++u) {
      const float w = Gs[u];
      float xv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty * 4 + i;
        xv[i] = p < P ? w * Xs[u * P + p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        bv[j] = n < N ? to_f(Bs[u * BP + n]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = fmaf(xv[i], bv[j], st[i][j]);
    }
    // each thread owns its (p, n) entries: no other thread reads them
    // before the next chunk's first barrier
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        if (p < P && n < N) Ss[p * SP + n] = st[i][j];
      }
    }
  }

  __syncthreads();
  T* fb = fin + ((long long)b * H + h) * P * N;
  for (int idx = t; idx < P * N; idx += THREADS)
    fb[idx] = from_f<T>(Ss[(idx / N) * SP + idx % N]);
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, void* fin, int B,
                   int L, int H, int G, int P, int N, int Q, Strides xs,
                   Strides ds, Strides bs, Strides cs, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(Q, P, N);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<T*>(fin), L, H,
      G, P, N, Q, xs, ds, bs, cs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (x, B, C, y and the final state); dt and
// A are float32.  Strides in elements, the last dim contiguous.  Takes
// P <= 64, N <= 64, Q <= 256 with Q <= 64 or Q % 64 == 0, L % Q == 0 and
// H % G == 0.  Returns the launch's CUDA error (0 when it was accepted).
int ssd_scan_forward(int dtype, const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, void* y, void* fin, int B,
                     int L, int H, int G, int P, int N, int Q, long long xsb,
                     long long xsl, long long xsh, long long dsb, long long dsl,
                     long long dsh, long long bsb, long long bsl, long long bsg,
                     long long csb, long long csl, long long csg,
                     void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > MAX_P || N <= 0 || N > MAX_N || Q <= 0 || Q > MAX_Q ||
      (Q > TILE && Q % TILE != 0) || L % Q != 0)
    return cudaErrorInvalidValue;
  const Strides xs{xsb, xsl, xsh}, ds{dsb, dsl, dsh}, bs{bsb, bsl, bsg},
      cs{csb, csl, csg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, fin, B, L, H, G, P, N, Q, xs, ds,
                         bs, cs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, fin, B, L, H, G, P, N, Q,
                                 xs, ds, bs, cs, st);
  return cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
