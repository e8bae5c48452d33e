// fused_qnet: the MolDQN Q-network forward on Hopper (sm_90a), f32 FFMA.
//
// Replaces the TPU kernel repro/kernels/fused_qnet/fused_qnet.py::fused_qnet_rows
// (body _qnet_kernel).  Computes, for x f32 [N, 2049] and weights in the JAX
// layout W_l f32 [in, out] row-major (not transposed), b_l f32 [out]:
//
//   q = relu(relu(relu(relu(x W1 + b1) W2 + b2) W3 + b3) W4 + b4) W5 + b5
//
// What bounds it on this card.  One row costs 2 * (2049*1024 + 1024*512 +
// 512*128 + 128*32 + 32) = 5.38 MFLOP, so N = 2048 rows are 11.0 GFLOP,
// against 27.6 MB that must move (x 16.8 MB, weights 10.8 MB, q 8 KB).  At
// 67 TFLOP/s of f32 FMA and 3.35 TB/s that is 164 us of arithmetic against
// 8 us of traffic: the kernel is bound by f32 FMA throughput.  Tensor cores
// in TF32 would lift the bound 7x but keep 10 mantissa bits, which cannot
// meet the port's 1e-4 tolerance over a 2049-term reduction, so the
// products stay in f32 FFMA.
//
// Design, simple first.  One launch per layer: a tiled SGEMM with the K
// slab of A and B staged in shared memory, a register micro-tile of TM x TN
// outputs per thread, and bias + ReLU in the epilogue; the 32 -> 1 head is a
// fifth, one-thread-per-row kernel.  h1..h4 live in device memory (13.9 MB
// at N = 2048, read back once each), which is cheap next to the arithmetic.
// The tile is picked per layer so that the grid fills the 132 SMs.
//
// Row stride and masking.  K = 2049 makes the row stride of x and the
// length of W1 8196 bytes, not a multiple of 16, so every load is a scalar
// f32 load (coalesced along the row for A, along the output dim for B); the
// K tail and ragged N are masked with zeros, which add exactly +0 to a sum.
//
// Determinism.  Each output element is one thread's sequential fmaf chain
// over k = 0 .. K-1, whatever the tile: no split-K, no atomics, no
// reduction whose order depends on scheduling.  So a row's q depends only
// on that row of x, and two launches on the same input are bit-identical.

#include <cuda_runtime.h>

namespace {

// C[M, N] = act(A[M, K] @ B[K, N] + bias[N]), all row-major f32.
// Thread (tr, tc) owns rows tr + i * (BM / TM) and columns tc + j * (BN / TN)
// of the block tile, so a warp's shared-memory reads and its stores to C
// fall on consecutive addresses.
template <int BM, int BN, int BK, int TM, int TN, bool RELU>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
linear_act(const float* __restrict__ A, const float* __restrict__ B,
           const float* __restrict__ bias, float* __restrict__ C,
           int M, int N, int K) {
  constexpr int RT = BM / TM;           // thread rows
  constexpr int CT = BN / TN;           // thread columns
  constexpr int NT = RT * CT;
  // +4 floats per k row: the transposed store of the A slab then hits 32
  // distinct banks per warp
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tc = tid % CT;
  const int tr = tid / CT;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int m = e / BK, k = e % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][tr + i * RT];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tc + j * CT];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tr + i * RT;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tc + j * CT;
      if (gn >= N) continue;
      float v = acc[i][j] + bias[gn];
      if (RELU) v = fmaxf(v, 0.f);
      C[(size_t)gm * N + gn] = v;
    }
  }
}

// q[r] = h[r, :] . w[:, 0] + b[0]: the K -> 1 head, one thread per row.
__global__ void head(const float* __restrict__ h, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ q,
                     int M, int K) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= M) return;
  const float* row = h + (size_t)r * K;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(row[k], w[k], acc);
  q[r] = acc + b[0];
}

constexpr int kSMs = 132;

template <int BM, int BN, int TM, int TN>
cudaError_t launch_tile(const float* A, const float* B, const float* bias,
                        float* C, int M, int N, int K, bool relu,
                        cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const dim3 block((BM / TM) * (BN / TN));
  if (relu)
    linear_act<BM, BN, 8, TM, TN, true><<<grid, block, 0, s>>>(A, B, bias, C, M, N, K);
  else
    linear_act<BM, BN, 8, TM, TN, false><<<grid, block, 0, s>>>(A, B, bias, C, M, N, K);
  return cudaGetLastError();
}

long long n_blocks(int M, int N, int bm, int bn) {
  return (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

// The largest tile whose grid still covers every SM twice (or once for the
// middle size); the sums do not depend on the choice.
cudaError_t linear(const float* A, const float* B, const float* bias, float* C,
                   int M, int N, int K, bool relu, cudaStream_t s) {
  if (n_blocks(M, N, 128, 128) >= 2 * kSMs)
    return launch_tile<128, 128, 8, 8>(A, B, bias, C, M, N, K, relu, s);
  if (n_blocks(M, N, 64, 64) >= kSMs)
    return launch_tile<64, 64, 4, 4>(A, B, bias, C, M, N, K, relu, s);
  return launch_tile<32, 32, 2, 2>(A, B, bias, C, M, N, K, relu, s);
}

}  // namespace

extern "C" {

// The five layers on `stream`; d0 is the input width, d1..d4 the hidden
// widths, the output width is 1.  h1..h4 are caller-allocated [n, d1..d4].
// Returns the first CUDA error of the launches (0 when all were accepted).
int fused_qnet_forward(const float* x,
                       const float* w1, const float* b1,
                       const float* w2, const float* b2,
                       const float* w3, const float* b3,
                       const float* w4, const float* b4,
                       const float* w5, const float* b5,
                       float* h1, float* h2, float* h3, float* h4, float* q,
                       int n, int d0, int d1, int d2, int d3, int d4,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  cudaError_t err;
  if ((err = linear(x, w1, b1, h1, n, d1, d0, true, s)) != cudaSuccess) return err;
  if ((err = linear(h1, w2, b2, h2, n, d2, d1, true, s)) != cudaSuccess) return err;
  if ((err = linear(h2, w3, b3, h3, n, d3, d2, true, s)) != cudaSuccess) return err;
  if ((err = linear(h3, w4, b4, h4, n, d4, d3, true, s)) != cudaSuccess) return err;
  head<<<(n + 255) / 256, 256, 0, s>>>(h4, w5, b5, q, n, d4);
  return cudaGetLastError();
}

const char* fused_qnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
