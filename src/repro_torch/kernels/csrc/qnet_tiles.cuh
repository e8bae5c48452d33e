// qnet_tiles.cuh: the MolDQN MLP forward as f32 FFMA tiles, shared by
// fused_qnet.cu (one parameter set over dense rows) and packed_qnet.cu (one
// parameter set per worker over packed or dense rows).
//
// Every layer is one launch of `linear_act`, a tiled SGEMM with K slabs of A
// and B double-buffered in shared memory, a register micro-tile of TM x TN
// outputs per thread, and bias + ReLU in the epilogue; the K -> 1 head is a
// fifth, one-thread-per-row kernel.  blockIdx.z is the batch entry (the
// worker): B, bias and C advance by their batch strides, and the A loader
// receives z.  With one batch entry this is exactly the single-network
// forward.
//
// What bounds it.  At 2048 rows layer 1 (2048 x 1024 x 2049) holds 78% of
// the FMAs; with one parameter set the forward is bound by f32 FFMA issue,
// so each thread keeps up to 8 x 8 accumulators and reads its A and B
// values from shared memory as float4 (16 FMAs per 16-byte read at 8 x 8,
// where 4 x 4 scalar reads gave 2).  Each slab's global loads are issued
// into registers before the current slab's FMAs and stored after them, so
// their latency hides behind the arithmetic, with one barrier per slab.
// With many workers of few rows each (128 x 32) the per-worker weights are
// read once per row tile, so the tile never takes more rows than a worker
// has: that shape is bound by weight bytes.
//
// Determinism.  Each output element is one thread's sequential fmaf chain
// over k = 0 .. K-1, starting from +0, whatever the tile or the A loader: no
// split-K, no atomics, no reduction whose order depends on scheduling.
// Zeros that pad the K tail add exactly +0.  So a row's q depends only on
// that row's input and its worker's weights, two launches are
// bit-identical, every tile gives the same bits, and two loaders that
// produce the same A values (the packed planes and their densified rows)
// give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qnet {

constexpr int BK = 16;  // K slab: two bytes of a packed row, one barrier each

// A = row-major f32 [M, ld] per batch entry, entry z at a + z * batch_stride.
// load4 returns A[z, m, k .. k + 3] (k a multiple of 4), zero past K.
struct DenseRows {
  const float* a;
  long long batch_stride;
  int ld;
  __device__ float4 load4(int z, int m, int k, int K, bool vec) const {
    const float* p = a + z * batch_stride + (long long)m * ld + k;
    if (vec && k + 3 < K) return *reinterpret_cast<const float4*>(p);
    return make_float4(k < K ? p[0] : 0.f, k + 1 < K ? p[1] : 0.f,
                       k + 2 < K ? p[2] : 0.f, k + 3 < K ? p[3] : 0.f);
  }
  // float4 loads are aligned: 16-byte base, ld and batch stride in float4s
  bool aligned() const {
    return reinterpret_cast<uintptr_t>(a) % 16 == 0 && ld % 4 == 0 &&
           batch_stride % 4 == 0;
  }
};

// A = [unpackbits(bits[z, m, :]), frac[z, m]] without writing it anywhere:
// bits u8 [Z, rows, n_bytes], frac f32 [Z, rows].  Bit k < 8 * n_bytes is
// bit (7 - k % 8) of byte k / 8 (MSB first, the pack_fps contract), as an
// exact 0.0 or 1.0; column 8 * n_bytes is the steps-left feature.  load4
// unpacks one nibble into four k values.
struct PackedRows {
  const uint8_t* bits;
  const float* frac;
  int rows;
  int n_bytes;
  __device__ float4 load4(int z, int m, int k, int K, bool) const {
    const long long r = (long long)z * rows + m;
    if (k < 8 * n_bytes) {
      const unsigned nib = (bits[r * n_bytes + (k >> 3)] >> ((k & 4) ? 0 : 4)) & 15u;
      return make_float4((float)(nib >> 3), (float)((nib >> 2) & 1),
                         (float)((nib >> 1) & 1), (float)(nib & 1));
    }
    return make_float4(k < K ? frac[r] : 0.f, 0.f, 0.f, 0.f);
  }
  bool aligned() const { return true; }
};

// C[z] = relu(A[z] @ B[z] + bias[z]) for the block's batch entry z, with
// A [M, K], B [K, N] row-major (the JAX [in, out] layout), C [M, N].
// Thread (tr, tc) owns rows g * 4 RT + 4 tr + i (g < TM / 4, i < 4) and
// columns g * 4 CT + 4 tc + j of the block tile, so its shared-memory reads
// are float4 and a warp's float4 reads of B cover consecutive addresses.
// The K tail and a ragged M or N are masked with zeros, which add exactly
// +0 to a sum.  vec: B and C allow float4 access (N % 4 == 0, 16-byte
// bases); vec_a: the A loader's float4 path is aligned.
// Registers are held to 128 a thread (512 threads an SM), so two 256-thread
// blocks share an SM.
template <int BM, int BN, int TM, int TN, class ALoad>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 512 / ((BM / TM) * (BN / TN)))
linear_act(ALoad A, const float* __restrict__ B, long long sB,
           const float* __restrict__ bias, long long sBias,
           float* __restrict__ C, long long sC, int M, int N, int K, bool vec,
           bool vec_a) {
  constexpr int RT = BM / TM;            // thread rows
  constexpr int CT = BN / TN;            // thread columns
  constexpr int NT = RT * CT;
  constexpr int AQ = BM * BK / 4;        // float4s of an A slab
  constexpr int BQ = BK * BN / 4;        // float4s of a B slab
  constexpr int A_PER = (AQ + NT - 1) / NT;
  constexpr int B_PER = (BQ + NT - 1) / NT;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "micro-tiles are float4 groups");
  // +4 floats per k row keep rows 16-byte aligned for the float4 reads and
  // hold the transposed store of the A slab to two-way bank conflicts
  __shared__ __align__(16) float As[2][BK][BM + 4];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int z = blockIdx.z;
  B += z * sB;
  bias += z * sBias;
  C += z * sC;
  const int tid = threadIdx.x;
  const int tc = tid % CT;
  const int tr = tid / CT;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float4 ra[A_PER], rb[B_PER];
  auto fetch = [&](int k0) {             // global -> registers
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT;
      const int m = e / (BK / 4), k = k0 + (e % (BK / 4)) * 4;
      ra[i] = (e < AQ && m0 + m < M) ? A.load4(z, m0 + m, k, K, vec_a)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      const int k = k0 + e / (BN / 4), n = n0 + (e % (BN / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < BQ && k < K) {
        const float* p = B + (size_t)k * N + n;
        if (vec && n + 3 < N) {
          v = *reinterpret_cast<const float4*>(p);
        } else {
          if (n < N) v.x = p[0];
          if (n + 1 < N) v.y = p[1];
          if (n + 2 < N) v.z = p[2];
          if (n + 3 < N) v.w = p[3];
        }
      }
      rb[i] = v;
    }
  };
  auto stash = [&](int buf) {            // registers -> shared
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int e = tid + i * NT;
      if (e < AQ) {
        const int m = e / (BK / 4), k = (e % (BK / 4)) * 4;
        As[buf][k][m] = ra[i].x;
        As[buf][k + 1][m] = ra[i].y;
        As[buf][k + 2][m] = ra[i].z;
        As[buf][k + 3][m] = ra[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int e = tid + i * NT;
      if (e < BQ)
        *reinterpret_cast<float4*>(&Bs[buf][e / (BN / 4)][(e % (BN / 4)) * 4]) = rb[i];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_slabs = (K + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < n_slabs; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slabs) fetch((s + 1) * BK);   // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[buf][k][g * 4 * RT + 4 * tr]);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[buf][k][g * 4 * CT + 4 * tc]);
        b[4 * g] = v.x;
        b[4 * g + 1] = v.y;
        b[4 * g + 2] = v.z;
        b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (s + 1 < n_slabs) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + (i / 4) * 4 * RT + 4 * tr + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int gn = n0 + g * 4 * CT + 4 * tc;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = fmaxf(acc[i][4 * g + j] + (gn + j < N ? bias[gn + j] : 0.f), 0.f);
      }
      float* out = C + (size_t)gm * N + gn;
      if (vec && gn + 3 < N) {
        *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) out[j] = v[j];
      }
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
                        long long sC, int M, int N, int K, int Z, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, Z);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const dim3 block((BM / TM) * (BN / TN));
  const bool vec = N % 4 == 0 && sB % 4 == 0 && sC % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C)) % 16 == 0;
  const bool vec_a = A.aligned();
  linear_act<BM, BN, TM, TN><<<grid, block, 0, s>>>(A, B, sB, bias, sBias, C,
                                                    sC, M, N, K, vec, vec_a);
  return cudaGetLastError();
}

inline long long n_blocks(int M, int N, int Z, int bm, int bn) {
  return (long long)Z * ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

// The first tile, largest micro-tile first, whose grid puts a block on
// every SM, among those no taller than the batch entry's rows rounded up
// to a tile height (a 128-row tile over 32 rows would waste 3/4 of its
// FMAs); the smallest tile otherwise.  The 8 x 8 tile is taken from 128
// blocks up: four idle SMs cost less than halving the micro-tile.  The
// sums do not depend on the choice.
template <class ALoad>
cudaError_t linear(ALoad A, const float* B, long long sB, const float* bias,
                   long long sBias, float* C, long long sC, int M, int N,
                   int K, int Z, cudaStream_t s) {
  const int cap = M <= 32 ? 32 : M <= 64 ? 64 : 128;
  auto fits = [&](int bm, int bn, long long min_blocks = kSMs) {
    return bm <= cap && n_blocks(M, N, Z, bm, bn) >= min_blocks;
  };
#define QNET_TILE(BM_, BN_, TM_, TN_)                                         \
  launch_tile<BM_, BN_, TM_, TN_>(A, B, sB, bias, sBias, C, sC, M, N, K, Z, s)
  if (fits(128, 128, kSMs - 4)) return QNET_TILE(128, 128, 8, 8);
  if (fits(128, 64)) return QNET_TILE(128, 64, 8, 4);
  if (fits(64, 64)) return QNET_TILE(64, 64, 4, 4);
  if (fits(32, 128)) return QNET_TILE(32, 128, 4, 8);
  if (fits(32, 64)) return QNET_TILE(32, 64, 4, 4);
  return QNET_TILE(32, 32, 4, 4);
#undef QNET_TILE
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
                    Z, s)) != cudaSuccess)
    return err;
  if ((err = linear(DenseRows{h1, m * d1, d1}, w2, (long long)d1 * d2, b2, d2,
                    h2, m * d2, M, d2, d1, Z, s)) != cudaSuccess)
    return err;
  if ((err = linear(DenseRows{h2, m * d2, d2}, w3, (long long)d2 * d3, b3, d3,
                    h3, m * d3, M, d3, d2, Z, s)) != cudaSuccess)
    return err;
  if ((err = linear(DenseRows{h3, m * d3, d3}, w4, (long long)d3 * d4, b4, d4,
                    h4, m * d4, M, d4, d3, Z, s)) != cudaSuccess)
    return err;
  const long long rows = m * Z;
  head<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(h4, w5, b5, q, M, d4, Z);
  return cudaGetLastError();
}

}  // namespace qnet
