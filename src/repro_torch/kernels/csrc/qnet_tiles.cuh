// qnet_tiles.cuh: the MolDQN MLP forward as f32 FFMA tiles, shared by
// fused_qnet.cu (one parameter set over dense rows) and packed_qnet.cu (one
// parameter set per worker over packed or dense rows).
//
// Every layer is one launch of `linear_act`, a tiled SGEMM with the K slab of
// A and B staged in shared memory, a register micro-tile of TM x TN outputs
// per thread, and bias + ReLU in the epilogue; the K -> 1 head is a fifth,
// one-thread-per-row kernel.  blockIdx.z is the batch entry (the worker):
// B, bias and C advance by their batch strides, and the A loader receives z.
// With one batch entry this is exactly the single-network forward.
//
// Determinism.  Each output element is one thread's sequential fmaf chain
// over k = 0 .. K-1, starting from +0, whatever the tile or the A loader: no
// split-K, no atomics, no reduction whose order depends on scheduling.  So a
// row's q depends only on that row's input and its worker's weights, two
// launches are bit-identical, and two loaders that produce the same A values
// (the packed planes and their densified rows) give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qnet {

// A = row-major f32 [M, ld] per batch entry, entry z at a + z * batch_stride.
struct DenseRows {
  const float* a;
  long long batch_stride;
  int ld;
  __device__ float operator()(int z, int m, int k) const {
    return a[z * batch_stride + (long long)m * ld + k];
  }
};

// A = [unpackbits(bits[z, m, :]), frac[z, m]] without writing it anywhere:
// bits u8 [Z, rows, n_bytes], frac f32 [Z, rows].  Bit k < 8 * n_bytes is
// bit (7 - k % 8) of byte k / 8 (MSB first, the pack_fps contract), as an
// exact 0.0 or 1.0; column 8 * n_bytes is the steps-left feature.
struct PackedRows {
  const uint8_t* bits;
  const float* frac;
  int rows;
  int n_bytes;
  __device__ float operator()(int z, int m, int k) const {
    const long long r = (long long)z * rows + m;
    if (k < 8 * n_bytes)
      return (float)((bits[r * n_bytes + (k >> 3)] >> (7 - (k & 7))) & 1);
    return frac[r];
  }
};

// C[z] = act(A[z] @ B[z] + bias[z]) for the block's batch entry z, with
// A [M, K], B [K, N] row-major (the JAX [in, out] layout), C [M, N].  Thread
// (tr, tc) owns rows tr + i * (BM / TM) and columns tc + j * (BN / TN) of the
// block tile, so a warp's shared-memory reads and its stores to C fall on
// consecutive addresses.  The K tail and a ragged M or N are masked with
// zeros, which add exactly +0 to a sum.
template <int BM, int BN, int BK, int TM, int TN, bool RELU, class ALoad>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
linear_act(ALoad A, const float* __restrict__ B, long long sB,
           const float* __restrict__ bias, long long sBias,
           float* __restrict__ C, long long sC, int M, int N, int K) {
  constexpr int RT = BM / TM;           // thread rows
  constexpr int CT = BN / TN;           // thread columns
  constexpr int NT = RT * CT;
  // +4 floats per k row: the transposed store of the A slab then hits 32
  // distinct banks per warp
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int z = blockIdx.z;
  B += z * sB;
  bias += z * sBias;
  C += z * sC;
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
      As[k][m] = (gm < M && gk < K) ? A(z, gm, gk) : 0.f;
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

// q[z, r] = h[z, r, :] . w[z, :, 0] + b[z, 0]: the K -> 1 head, one thread
// per row over all Z * M rows.
__global__ void head(const float* __restrict__ h, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ q,
                     int M, int K, int Z) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (long long)M * Z) return;
  const int z = (int)(r / M);
  const float* row = h + r * K;
  const float* wz = w + (long long)z * K;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(row[k], wz[k], acc);
  q[r] = acc + b[z];
}

constexpr int kSMs = 132;

template <int BM, int BN, int TM, int TN, class ALoad>
cudaError_t launch_tile(ALoad A, const float* B, long long sB,
                        const float* bias, long long sBias, float* C,
                        long long sC, int M, int N, int K, int Z, bool relu,
                        cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, Z);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const dim3 block((BM / TM) * (BN / TN));
  if (relu)
    linear_act<BM, BN, 8, TM, TN, true><<<grid, block, 0, s>>>(
        A, B, sB, bias, sBias, C, sC, M, N, K);
  else
    linear_act<BM, BN, 8, TM, TN, false><<<grid, block, 0, s>>>(
        A, B, sB, bias, sBias, C, sC, M, N, K);
  return cudaGetLastError();
}

inline long long n_blocks(int M, int N, int Z, int bm, int bn) {
  return (long long)Z * ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

// The largest tile whose grid still covers every SM twice (or once for the
// middle size); the sums do not depend on the choice.
template <class ALoad>
cudaError_t linear(ALoad A, const float* B, long long sB, const float* bias,
                   long long sBias, float* C, long long sC, int M, int N,
                   int K, int Z, bool relu, cudaStream_t s) {
  if (n_blocks(M, N, Z, 128, 128) >= 2 * kSMs)
    return launch_tile<128, 128, 8, 8>(A, B, sB, bias, sBias, C, sC, M, N, K,
                                       Z, relu, s);
  if (n_blocks(M, N, Z, 64, 64) >= kSMs)
    return launch_tile<64, 64, 4, 4>(A, B, sB, bias, sBias, C, sC, M, N, K,
                                     Z, relu, s);
  return launch_tile<32, 32, 2, 2>(A, B, sB, bias, sBias, C, sC, M, N, K, Z,
                                   relu, s);
}

// The five layers for Z batch entries of M rows each on stream s.  Layer 1
// reads A through `x` (K = d0); d1..d4 are the hidden widths and the output
// width is 1.  Weights are [Z, in, out] and biases [Z, out], contiguous;
// h1..h4 are caller-allocated [Z, M, d1..d4] and q is [Z, M].  Returns the
// first CUDA error of the launches (cudaSuccess when all were accepted).
template <class ALoad>
cudaError_t forward(ALoad x, const float* w1, const float* b1,
                    const float* w2, const float* b2, const float* w3,
                    const float* b3, const float* w4, const float* b4,
                    const float* w5, const float* b5, float* h1, float* h2,
                    float* h3, float* h4, float* q, int Z, int M, int d0,
                    int d1, int d2, int d3, int d4, cudaStream_t s) {
  if (Z <= 0 || M <= 0) return cudaSuccess;
  const long long m = M;
  cudaError_t err;
  if ((err = linear(x, w1, (long long)d0 * d1, b1, d1, h1, m * d1, M, d1, d0,
                    Z, true, s)) != cudaSuccess)
    return err;
  if ((err = linear(DenseRows{h1, m * d1, d1}, w2, (long long)d1 * d2, b2, d2,
                    h2, m * d2, M, d2, d1, Z, true, s)) != cudaSuccess)
    return err;
  if ((err = linear(DenseRows{h2, m * d2, d2}, w3, (long long)d2 * d3, b3, d3,
                    h3, m * d3, M, d3, d2, Z, true, s)) != cudaSuccess)
    return err;
  if ((err = linear(DenseRows{h3, m * d3, d3}, w4, (long long)d3 * d4, b4, d4,
                    h4, m * d4, M, d4, d3, Z, true, s)) != cudaSuccess)
    return err;
  const long long rows = m * Z;
  head<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(h4, w5, b5, q, M, d4, Z);
  return cudaGetLastError();
}

}  // namespace qnet
