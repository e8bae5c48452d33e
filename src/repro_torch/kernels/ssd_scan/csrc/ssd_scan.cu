// ssd_scan: the Mamba2 SSD chunked scan on Hopper (sm_90a), chunk-parallel.
// bf16 runs its products on the tensor cores (mma.sync, f32 accumulators);
// f32 runs in f32 FFMA.  Decay exponents, gates and states are f32 in both.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_blhp
// (src/repro/kernels/ssd_scan/ssd_scan.py:86, body _ssd_kernel).  For batch
// b and head h (group g = h / (H / G)), over chunks of Q positions, with
// cum_q = sum_{u <= q} -A_h dt_u inside the chunk and total = cum_{Q-1}:
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
// x's type.  Takes P <= 64, N <= 128 and any Q that divides L.
//
// Design: the SSD decomposition of the model's own ssd_chunked, not the
// Pallas grid (which walks a (b, h)'s chunks in order, carrying the state).
// Three launches, each parallel over chunks:
//   1. chunk_state, one block per (chunk, h, b): cum by a block-wide scan,
//      written to a [B, H, L] f32 scratch so the later launches read the
//      same bits; then the chunk's summary sum_u exp(total - cum_u) dt_u
//      x_u B_u^T [P, N] into a [B, H, nc, P, N] f32 scratch.
//   2. state_pass, one thread per (b, h, p, n): the length-nc recurrence
//      S <- exp(total_c) S + summary_c from S = 0, writing the state
//      ENTERING each chunk (f32: over its summary; bf16: as hi and lo bf16
//      planes in a third scratch, ready for cp.async); the final state is
//      written once.
//   3. chunk_scan, one block per (64-row query tile, chunk, h, b): the
//      carry-in exp(cum_q) C_q S^T from the entering state, then source
//      tiles of 64 rows at or left of the diagonal (those above it are never
//      computed; the s <= q mask and its exp apply only on the diagonal),
//      with B, x, cum and dt of the next source tile copied by cp.async into
//      a two-stage ring while this one is multiplied.  y is written once.
// The grid runs heads fastest, then a chunk's query tiles (the last, with
// the most source tiles, first), so a chunk's B, x and state tiles are read
// from HBM once and then from L2.
// A chunk of Q rows is cut into 64-row tiles with a ragged last tile, rows
// and columns past Q, P or N zero-filled, so any Q that divides L works.
//
// bf16 route (mma.sync.m16n8k16, bf16 in, f32 accumulators):
//   * C . B^T from exact bf16 inputs by ldmatrix; dt is folded into the
//     f32 gated scores G_qs = (C . B)_qs exp(cum_q - cum_s) dt_s, which are
//     rounded to bf16 A fragments in registers (two adjacent n-tiles of the
//     C layout are one A fragment); x enters G x unrounded, by
//     ldmatrix.trans.  A warp does scores, gate and G x one 16-column group
//     of the source tile at a time, so only 8 score accumulators are live.
//   * Precision: the two products with an f32 operand, the carry-in C S^T
//     (the state) and the summary (w x)^T B (w = exp(total - cum) dt),
//     split that operand as v = bf16(v) + bf16(v - bf16(v)) and run two
//     products, so the state keeps ~16 bits of mantissa and its error does
//     not compound over chunks as one bf16 rounding would.  The summary
//     splits w x in registers, on x's A fragments; the carry-in reads the
//     hi and lo planes that state_pass wrote.
//   * Every loop has a fixed trip count: N is zero-padded to 64 or 128
//     (template NKM = 4 or 8 k-steps of C, held in registers), P to 64;
//     only the diagonal tile is guarded.  The entering state needs no
//     shared memory of its own: its hi plane takes C's space once C is in
//     registers, its lo plane the ring stage the last source tile leaves
//     free.  At N <= 64 a block takes 46 KB and 128 registers, so four
//     blocks (16 warps) share an SM; at N = 128 it takes 70 KB, and three
//     blocks (12 warps) share an SM.
// f32 route: the same three launches as f32 FFMA register tiles (4 x 4 or
// 4 x 8 a thread, float4 shared reads); only FFMA meets the 2e-4 tolerance.
// What still bounds both routes is latency, not bytes or issue: a block's
// loads, barriers and dependent mma chains (scores -> gate -> G x) leave
// the tensor cores mostly idle with 16 warps an SM; wgmma with TMA and a
// producer warp, or more query rows a warp, are the next levers.
//
// What bounds it on this card (each input read once, each output written
// once; FLOP = the causal half of the two Q x Q products, the carry-in and
// the summary):
//   zamba2-1.2b path (B 2, L 4096, H 64, P = N = 64, G 1, Q 256): 2.58e10
//     FLOP against 140 MB: bf16 0.0416 ms of HBM at 3.35 TB/s (0.026 ms of
//     tensor cores at 989 TFLOP/s), so bytes; f32 0.386 ms of FFMA at
//     66.9 TFLOP/s, so operations.
//   mamba2-2.7b path (B 2, L 4096, H 80, P 64, N 128, G 1, Q 256): 5.38e10
//     FLOP against 177 MB: bf16 0.054 ms of tensor cores (bytes 0.053 ms);
//     f32 0.804 ms of FFMA.
// The state scratch adds 4 x 33.5 MB (zamba2) or 4 x 83.9 MB (mamba2) of
// traffic, part of it in the 50 MB L2, that the bound does not count.
//
// Determinism.  Every sum has a fixed order (the block scan's tree, u in
// order, the mma's fixed internal order, hi before lo), no atomics and no
// split that reorders a sum, so two launches are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int TILE = 64;          // rows of a query or source tile
constexpr int MAX_P = 64, MAX_N = 128;
constexpr int ST_THREADS = 256;   // chunk_state
constexpr int SC_BF_THREADS = 128;   // chunk_scan, bf16: 4 warps x 16 query rows
constexpr int SC_F32_THREADS = 256;  // chunk_scan, f32: 16 x 16, 4 x 4 each
constexpr int GP = TILE + 4;      // pitch of the f32 gate tile (float4 rows)

template <bool V> struct Flag {
  static constexpr bool value = V;
};

struct Strides {
  long long b, l, h;   // h: the head (x, dt) or group (B, C) stride
};

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  void* fin;
  float* cum;      // [B, H, L]
  float* st;       // [B, H, nc, P, N]: summaries, then (f32) entering states
  __nv_bfloat16* hl;   // bf16: [B, H, nc, 2, P, round_up(N, 16)] entering states
  int L, H, G, P, N, Q, nc;
  Strides xs, ds, bs, cs;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
// f32 row pitch = 4 (mod 32) floats: eight float4 rows of a quarter warp
// fall in eight different 16-byte bank groups
__host__ __device__ constexpr int f32_pitch(int n) { return round_up(n, 32) + 4; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ROWS x ncp elements of a tile into shared memory (row pitch `pitch`), from
// rows of `src` (row stride rs), zero where row >= nrows or col >= ncols.
// ncp is a multiple of 16 bytes.  VEC: 16-byte cp.async (the caller checked
// alignment and that ncols is a multiple of 16 bytes); else element loads.
template <typename T, bool VEC, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const T* src, long long rs,
                                          int nrows, int ncols, int ncp, int tid,
                                          int nthreads) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = ncp / E;
  for (int idx = tid; idx < ROWS * cpr; idx += nthreads) {
    const int r = idx / cpr, c = idx % cpr * E;
    T* d = dst + r * pitch + c;
    if (VEC) {
      const bool in = r < nrows && c < ncols;
      cp_async16(d, in ? src + r * rs + c : src, in);
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k)
        d[k] = (r < nrows && c + k < ncols) ? src[r * rs + c + k] : from_f<T>(0.f);
    }
  }
}

// cum[u] = sum_{v <= u} -a dt_v over the chunk's Q positions, written to
// cumb[0, Q), in a fixed order: within a warp by shuffles, then the warps
// before it, then the 256-position pieces before it.  Returns cum[Q - 1],
// the same bits as the value written there.  red: ST_THREADS / 32 + 1 floats.
// cum0 and dt0 return cum and dt at u = threadIdx.x (dt0 is 0 past Q).
__device__ float chunk_cum(const float* db, long long dsl, float a, int Q, float* cumb,
                           float* red, float& cum0, float& dt0) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float carry = 0.f;
  for (int u0 = 0; u0 < Q; u0 += ST_THREADS) {
    const int u = u0 + t;
    const float d = u < Q ? db[u * dsl] : 0.f;
    float v = -a * d;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) red[warp] = v;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += red[w];
    v += before;
    if (u < Q) cumb[u] = v;
    if (u0 == 0) {
      cum0 = v;
      dt0 = d;
    }
    if (t == min(Q - u0, ST_THREADS) - 1) red[ST_THREADS / 32] = v;
    __syncthreads();
    carry = red[ST_THREADS / 32];
    __syncthreads();   // red is rewritten by the next piece
  }
  return carry;
}

// ------------------------------------------------------------ 1. chunk_state

// Both routes walk the chunk in u tiles through a two-stage ring: tile 0's
// x and B are copied while the cum scan runs, tile k + 1's x, B, cum and dt
// while tile k is multiplied.  w_u = exp(total - cum_u) dt_u goes to ws, one
// entry a row: tile 0's from the scan's registers, later tiles' from the
// staged cum and dt.
__device__ __forceinline__ void chunk_weights(float* ws, const float* cw, const float* dw,
                                              float cum0, float dt0, float total, int u0,
                                              int rows) {
  const int t = threadIdx.x;
  if (t < rows) ws[t] = u0 == 0 ? expf(total - cum0) * dt0 : expf(total - cw[t]) * dw[t];
}

__device__ __forceinline__ void stage_weights(float* cw, float* dw, const float* cumb,
                                              const float* db, long long dsl, int u0,
                                              int nrows, int rows) {
  const int t = threadIdx.x;
  if (t < rows) {
    const bool in = t < nrows;
    cp_async4(cw + t, in ? cumb + u0 + t : cumb, in);
    cp_async4(dw + t, in ? db + (u0 + t) * dsl : db, in);
  }
}

// bf16 shared memory: x and B rings with 16 bytes of pad a row, P padded to
// 64 and N to 16 NKM, then ws, the staged cum and dt, and the scan's slots.
size_t state_smem_bf16(int nkm) {
  return sizeof(__nv_bfloat16) * (size_t)2 * TILE * (MAX_P + 8 + 16 * nkm + 8) +
         sizeof(float) * (5 * TILE + ST_THREADS / 32 + 1);
}

// bf16: 8 warps; warp w owns summary rows p in [16 (w & 3), +16) and the
// 16-column groups w >> 2, w >> 2 + 2, ... of N (padded to 16 NKM).  Per
// 64-row u tile, x and B arrive by cp.async; x's A fragments (A = x^T, by
// ldmatrix.trans) are scaled by w in registers and split there into hi and
// lo bf16 fragments; B by ldmatrix.trans.
template <bool VEC, int NKM>
__global__ void __launch_bounds__(ST_THREADS) chunk_state_bf16(const Args a) {
  using T = __nv_bfloat16;
  constexpr int Ppad = MAX_P, Npad = 16 * NKM;
  constexpr int LDP = Ppad + 8, LDN = Npad + 8;
  constexpr int NG = NKM / 2;   // 16-column groups a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xr = reinterpret_cast<T*>(smem_raw);   // [2][TILE][LDP] x as read
  T* Bs = Xr + 2 * TILE * LDP;              // [2][TILE][LDN]
  float* ws = reinterpret_cast<float*>(Bs + 2 * TILE * LDN);   // [TILE]
  float* cw = ws + TILE;                                       // [2][TILE] staged cum
  float* dw = cw + 2 * TILE;                                   // [2][TILE] and dt
  float* red = dw + 2 * TILE;                                  // [ST_THREADS / 32 + 1]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int P = a.P, N = a.N, Q = a.Q;
  const int g = h / (a.H / a.G);
  const long long l0 = (long long)c * Q;
  const T* xb = static_cast<const T*>(a.x) + b * a.xs.b + h * a.xs.h + l0 * a.xs.l;
  const float* db = a.dt + b * a.ds.b + h * a.ds.h + l0 * a.ds.l;
  const T* bb = static_cast<const T*>(a.Bm) + b * a.bs.b + g * a.bs.h + l0 * a.bs.l;
  float* cumb = a.cum + ((long long)b * a.H + h) * a.L + l0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int p0 = 16 * (warp & 3), ni = warp >> 2;

  auto load_u = [&](int u0, int stage) {
    const int nrows = min(TILE, Q - u0);
    load_tile<T, VEC, TILE>(Bs + stage * TILE * LDN, LDN, bb + u0 * a.bs.l, a.bs.l, nrows,
                            N, Npad, tid, ST_THREADS);
    load_tile<T, VEC, TILE>(Xr + stage * TILE * LDP, LDP, xb + u0 * a.xs.l, a.xs.l, nrows,
                            P, Ppad, tid, ST_THREADS);
    if (u0 > 0)
      stage_weights(cw + stage * TILE, dw + stage * TILE, cumb, db, a.ds.l, u0, nrows, TILE);
  };
  load_u(0, 0);
  cp_async_commit();
  float cum0, dt0;
  const float total = chunk_cum(db, a.ds.l, a.A[h], Q, cumb, red, cum0, dt0);

  float acc[NG][2][4];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int u0 = 0, stage = 0; u0 < Q; u0 += TILE, stage ^= 1) {
    if (u0 + TILE < Q) load_u(u0 + TILE, stage ^ 1);
    cp_async_commit();   // possibly empty
    cp_async_wait<1>();
    __syncthreads();
    chunk_weights(ws, cw + stage * TILE, dw + stage * TILE, cum0, dt0, total, u0, TILE);
    __syncthreads();
    const T* Xrs = Xr + stage * TILE * LDP;
    const T* Bst = Bs + stage * TILE * LDN;
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {   // rows past the tile are zero
      uint32_t raw[4], ah[4], al[4];
      ldsm_x4_trans(raw, Xrs + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LDP + p0 +
                             ((lane >> 3) & 1) * 8);
      // fragment registers 0, 1 hold u = 16 kk + 2 t4 + {0, 1}; 2, 3 hold u + 8
      const float2 w0 = *reinterpret_cast<const float2*>(ws + 16 * kk + 2 * t4);
      const float2 w1 = *reinterpret_cast<const float2*>(ws + 16 * kk + 2 * t4 + 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[q]));
        const float2 w = q < 2 ? w0 : w1;
        const float v0 = v.x * w.x, v1 = v.y * w.y;
        const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
        const float2 hf = __bfloat1622float2(hv);
        ah[q] = *reinterpret_cast<const uint32_t*>(&hv);
        al[q] = pack_bf16(v0 - hf.x, v1 - hf.y);
      }
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        uint32_t r[4];
        ldsm_x4_trans(r, Bst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                             16 * (ni + 2 * gi) + (lane >> 4) * 8);
        mma_bf16(acc[gi][0], ah, r[0], r[1]);
        mma_bf16(acc[gi][0], al, r[0], r[1]);
        mma_bf16(acc[gi][1], ah, r[2], r[3]);
        mma_bf16(acc[gi][1], al, r[2], r[3]);
      }
    }
    __syncthreads();   // this stage and ws are rewritten next turn
  }

  float* sb = a.st + (((long long)b * a.H + h) * a.nc + c) * P * N;
#pragma unroll
  for (int gi = 0; gi < NG; ++gi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + gq + (e >> 1) * 8;
        const int n = 16 * (ni + 2 * gi) + 8 * j + 2 * t4 + (e & 1);
        if (p < P && n < N) sb[p * N + n] = acc[gi][j][e];
      }
}

constexpr int F32_SU = 32;   // rows of an f32 u tile

size_t state_smem_f32(int nj) {
  return sizeof(float) * ((size_t)2 * F32_SU * (MAX_P + 16 * nj) + 5 * F32_SU +
                          ST_THREADS / 32 + 1);
}

// f32: 16 x 16 threads, thread (ty, tx) owns p = 4 ty + i (i < 4) and
// n = 4 tx + k + 64 jj (k < 4, jj < NJ / 4), so x and B are read as float4;
// each p's w x_p is made as it is read.
template <bool VEC, int NJ>
__global__ void __launch_bounds__(ST_THREADS) chunk_state_f32(const Args a) {
  constexpr int SU = F32_SU, NB = 16 * NJ, NQ = NJ / 4;
  extern __shared__ __align__(16) float fsm[];
  float* Xs = fsm;                  // [2][SU][MAX_P]
  float* Bs = Xs + 2 * SU * MAX_P;  // [2][SU][NB]
  float* ws = Bs + 2 * SU * NB;     // [SU]
  float* cw = ws + SU;              // [2][SU] staged cum
  float* dw = cw + 2 * SU;          // [2][SU] and dt
  float* red = dw + 2 * SU;         // [ST_THREADS / 32 + 1]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int P = a.P, N = a.N, Q = a.Q;
  const int g = h / (a.H / a.G);
  const long long l0 = (long long)c * Q;
  const float* xb = static_cast<const float*>(a.x) + b * a.xs.b + h * a.xs.h + l0 * a.xs.l;
  const float* db = a.dt + b * a.ds.b + h * a.ds.h + l0 * a.ds.l;
  const float* bb = static_cast<const float*>(a.Bm) + b * a.bs.b + g * a.bs.h + l0 * a.bs.l;
  float* cumb = a.cum + ((long long)b * a.H + h) * a.L + l0;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  auto load_u = [&](int u0, int stage) {
    const int nrows = min(SU, Q - u0);
    load_tile<float, VEC, SU>(Bs + stage * SU * NB, NB, bb + u0 * a.bs.l, a.bs.l, nrows, N,
                              NB, tid, ST_THREADS);
    load_tile<float, VEC, SU>(Xs + stage * SU * MAX_P, MAX_P, xb + u0 * a.xs.l, a.xs.l,
                              nrows, P, round_up(P, 4), tid, ST_THREADS);
    if (u0 > 0)
      stage_weights(cw + stage * SU, dw + stage * SU, cumb, db, a.ds.l, u0, nrows, SU);
  };
  load_u(0, 0);
  cp_async_commit();
  float cum0, dt0;
  const float total = chunk_cum(db, a.ds.l, a.A[h], Q, cumb, red, cum0, dt0);

  float acc[4][NQ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) acc[i][jj][0] = acc[i][jj][1] = acc[i][jj][2] = acc[i][jj][3] = 0.f;

  for (int u0 = 0, stage = 0; u0 < Q; u0 += SU, stage ^= 1) {
    const int nrows = min(SU, Q - u0);
    if (u0 + SU < Q) load_u(u0 + SU, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    chunk_weights(ws, cw + stage * SU, dw + stage * SU, cum0, dt0, total, u0, SU);
    __syncthreads();
    const float* Xst = Xs + stage * SU * MAX_P;
    const float* Bst = Bs + stage * SU * NB;
    if (4 * ty < P) {
      for (int u = 0; u < nrows; ++u) {
        const float4 xv = *reinterpret_cast<const float4*>(Xst + u * MAX_P + 4 * ty);
        const float w = ws[u];
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
        for (int jj = 0; jj < NQ; ++jj) {
          const float4 bv = *reinterpret_cast<const float4*>(Bst + u * NB + 4 * tx + 64 * jj);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][jj][0] = fmaf(xw[i], bv.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(xw[i], bv.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(xw[i], bv.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(xw[i], bv.w, acc[i][jj][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  float* sb = a.st + (((long long)b * a.H + h) * a.nc + c) * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = 4 * ty + i, n = 4 * tx + k + 64 * jj;
        if (p < P && n < N) sb[p * N + n] = acc[i][jj][k];
      }
}

// ------------------------------------------------------------- 2. state_pass

// One thread per V consecutive (b, h, p, n) (V = 4 when N % 4 == 0, so
// loads and stores are 16 or 8 bytes): the state entering each chunk, in
// order, the next chunk's summary loaded before this one's store.  The f32
// route overwrites each summary with the state entering its chunk; the bf16
// route writes it to its own scratch as hi and lo bf16 planes
// [B, H, nc, 2, P, Npad], zero in the columns past N, ready for cp.async.
template <typename T, int V>
__global__ void __launch_bounds__(256) state_pass(const Args a) {
  constexpr bool split = sizeof(T) == 2;
  const int PN = a.P * a.N;
  const int Npad = split ? round_up(a.N, 16) : a.N;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (e >= a.P * Npad) return;
  const int p = e / Npad, n = e % Npad;   // n + V <= N or n >= N
  const long long bh = blockIdx.y;
  const long long hstride = (long long)a.P * Npad;   // one bf16 plane
  __nv_bfloat16* hl = split ? a.hl + bh * a.nc * 2 * hstride + e : nullptr;
  if (n >= a.N) {   // bf16 padding
    for (int c = 0; c < 2 * a.nc; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) hl[c * hstride + v] = __float2bfloat16(0.f);
    return;
  }
  float* s = a.st + bh * a.nc * PN + p * a.N + n;
  const float* tot = a.cum + bh * a.L + (a.Q - 1);
  auto load = [&](int c, float (&v)[V]) {
    if constexpr (V == 4) {
      const float4 f = *reinterpret_cast<const float4*>(s + (long long)c * PN);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      v[0] = s[(long long)c * PN];
    }
  };
  float S[V], next[V];
#pragma unroll
  for (int v = 0; v < V; ++v) S[v] = 0.f;
  load(0, next);
  for (int c = 0; c < a.nc; ++c) {
    float contrib[V];
#pragma unroll
    for (int v = 0; v < V; ++v) contrib[v] = next[v];
    if (c + 1 < a.nc) load(c + 1, next);
    if constexpr (split) {   // the state entering chunk c
      uint32_t hi[(V + 1) / 2], lo[(V + 1) / 2];
#pragma unroll
      for (int v = 0; v < V; v += 2) {
        const float s1 = v + 1 < V ? S[v + 1] : 0.f;
        const __nv_bfloat162 h = __floats2bfloat162_rn(S[v], s1);
        const float2 hf = __bfloat1622float2(h);
        hi[v / 2] = *reinterpret_cast<const uint32_t*>(&h);
        lo[v / 2] = pack_bf16(S[v] - hf.x, s1 - hf.y);
      }
      if constexpr (V == 4) {
        *reinterpret_cast<uint2*>(hl + 2 * c * hstride) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(hl + (2 * c + 1) * hstride) = make_uint2(lo[0], lo[1]);
      } else {
        hl[2 * c * hstride] = *reinterpret_cast<const __nv_bfloat16*>(&hi[0]);
        hl[(2 * c + 1) * hstride] = *reinterpret_cast<const __nv_bfloat16*>(&lo[0]);
      }
    } else if constexpr (V == 4) {
      *reinterpret_cast<float4*>(s + (long long)c * PN) = make_float4(S[0], S[1], S[2], S[3]);
    } else {
      s[(long long)c * PN] = S[0];
    }
    const float decay = expf(tot[(long long)c * a.Q]);
#pragma unroll
    for (int v = 0; v < V; ++v) S[v] = fmaf(decay, S[v], contrib[v]);
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    static_cast<T*>(a.fin)[bh * PN + p * a.N + n + v] = from_f<T>(S[v]);
}

// ------------------------------------------------------------- 3. chunk_scan

// The block's (query tile, chunk, head, batch): heads fastest, so the
// blocks in flight read whole [H, P] rows of x; then query tiles, the last
// (most source tiles) first, so a chunk's tiles meet in L2.
struct ScanBlock {
  int qt, c, h, b;
};
__device__ __forceinline__ ScanBlock scan_block(const Args& a) {
  const int nqt = (a.Q + TILE - 1) / TILE;
  const int rest = blockIdx.x / a.H, chunk = rest / nqt;
  return {nqt - 1 - rest % nqt, chunk % a.nc, (int)(blockIdx.x % a.H), chunk / a.nc};
}

// bf16 shared memory: C [TILE][LDN], then two ring stages of B [TILE][LDN]
// and x [TILE][LDP], then cum and dt [2][TILE] each (bf16 elements, then
// floats).  The entering state's hi plane reuses C's space, its lo plane the
// stage the last source tile leaves free.
__host__ __device__ constexpr int scan_stage_bf16(int LDN, int LDP) { return TILE * (LDN + LDP); }
size_t scan_smem_bf16(int N) {
  const int LDN = (N <= 64 ? 64 : MAX_N) + 8, LDP = MAX_P + 8;
  return sizeof(__nv_bfloat16) * ((size_t)TILE * LDN + 2 * scan_stage_bf16(LDN, LDP)) +
         sizeof(float) * 4 * TILE;
}

// bf16: 4 warps, warp w owns query rows [16 w, 16 w + 16) of the tile.  C's
// A fragments are loaded once and stay in registers; scores are 16 x 16
// f32 accumulators a warp at a time; y is [16, 64] f32 accumulators.  NKM:
// C's k-steps held (4 up to N = 64, so four blocks share an SM, else 8, and
// three).  The carry-in runs last, once the entering state has arrived in
// the space that C and the ring no longer need.
template <bool VEC, int NKM>
__global__ void __launch_bounds__(SC_BF_THREADS, NKM <= 4 ? 4 : 3)
chunk_scan_bf16(const Args a) {
  using T = __nv_bfloat16;
  const int P = a.P, N = a.N, Q = a.Q;
  // every loop has a fixed trip count: N is zero-padded to 16 NKM, P to 64
  constexpr int Ppad = MAX_P, Npad = 16 * NKM;
  constexpr int LDN = Npad + 8, LDP = Ppad + 8;   // 16 bytes of pad a row
  constexpr int NK = NKM, NP16 = Ppad / 16;
  const int NpS = round_up(N, 16);   // the state planes' row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  static_assert(Ppad == TILE, "the state's planes take a tile's rows");
  T* Cs = reinterpret_cast<T*>(smem_raw);          // [TILE][LDN]; then the state, hi
  T* st0 = Cs + TILE * LDN;                        // ring stage 0: B [TILE][LDN], x [TILE][LDP]
  T* st1 = st0 + scan_stage_bf16(LDN, LDP);        // ring stage 1
  float* cums = reinterpret_cast<float*>(st1 + scan_stage_bf16(LDN, LDP));   // [2][TILE]
  float* dts = cums + 2 * TILE;                                            // [2][TILE]
  auto Bs = [&](int stage) { return stage ? st1 : st0; };
  auto Xs = [&](int stage) { return (stage ? st1 : st0) + TILE * LDN; };

  const ScanBlock k = scan_block(a);
  T* Sh = Cs;                    // [Ppad][LDN] the entering state, hi
  T* Sl = Bs((k.qt + 1) & 1);    // [Ppad][LDN] and lo
  const int g = k.h / (a.H / a.G), q0 = k.qt * TILE, nq = min(TILE, Q - q0);
  const long long l0 = (long long)k.c * Q;
  const T* xb = static_cast<const T*>(a.x) + k.b * a.xs.b + k.h * a.xs.h + l0 * a.xs.l;
  const float* db = a.dt + k.b * a.ds.b + k.h * a.ds.h + l0 * a.ds.l;
  const T* bb = static_cast<const T*>(a.Bm) + k.b * a.bs.b + g * a.bs.h + l0 * a.bs.l;
  const T* cb = static_cast<const T*>(a.Cm) + k.b * a.cs.b + g * a.cs.h + l0 * a.cs.l;
  const float* cumb = a.cum + ((long long)k.b * a.H + k.h) * a.L + l0;
  const T* hb = a.hl + (((long long)k.b * a.H + k.h) * a.nc + k.c) * 2 * P * NpS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;

  auto load_src = [&](int s_t, int stage) {
    const int s0 = s_t * TILE, ns = min(TILE, Q - s0);
    load_tile<T, VEC, TILE>(Bs(stage), LDN, bb + s0 * a.bs.l, a.bs.l, ns, N, Npad, tid,
                            SC_BF_THREADS);
    load_tile<T, VEC, TILE>(Xs(stage), LDP, xb + s0 * a.xs.l, a.xs.l, ns, P, Ppad, tid,
                            SC_BF_THREADS);
    if (tid < TILE) {
      const bool in = tid < ns;
      cp_async4(cums + stage * TILE + tid, in ? cumb + s0 + tid : cumb, in);
      cp_async4(dts + stage * TILE + tid, in ? db + (s0 + tid) * a.ds.l : db, in);
    }
  };

  auto load_state = [&](T* dst, int plane) {   // rows past P are zero
    for (int idx = tid; idx < Ppad * Npad / 8; idx += SC_BF_THREADS) {
      const int p = idx / (Npad / 8), n = idx % (Npad / 8) * 8;
      const bool in = p < P && n < NpS;
      cp_async16(dst + p * LDN + n, in ? hb + (plane * P + p) * NpS + n : hb, in);
    }
  };

  load_tile<T, VEC, TILE>(Cs, LDN, cb + q0 * a.cs.l, a.cs.l, nq, N, Npad, tid,
                          SC_BF_THREADS);
  load_src(0, 0);
  cp_async_commit();

  const int wr = 16 * warp;   // the warp's first row in the tile
  const bool live = wr < nq;
  const int r0 = wr + gq, r1 = r0 + 8;
  const float cq0 = r0 < nq ? cumb[q0 + r0] : 0.f;
  const float cq1 = r1 < nq ? cumb[q0 + r1] : 0.f;
  uint32_t qf[NKM][4];
  float acc[MAX_P / 8][4];
#pragma unroll
  for (int j = 0; j < MAX_P / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // Groups in flight: C and tile 0; then each turn one group, the next
  // tile or, on the last turn, the state's lo plane; the hi plane follows C.
  for (int s_t = 0; s_t <= k.qt; ++s_t) {
    const int stage = s_t & 1;
    if (s_t < k.qt) load_src(s_t + 1, stage ^ 1);
    else load_state(Sl, 1);   // the stage the last tile leaves free
    cp_async_commit();
    cp_async_wait<1>();   // all but the newest group landed
    __syncthreads();
    if (s_t == 0) {
      if (live) {
#pragma unroll
        for (int kd = 0; kd < NK; ++kd)
          ldsm_x4(qf[kd], Cs + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN + kd * 16 +
                              (lane >> 4) * 8);
      }
      __syncthreads();   // C is in registers: its space takes the state's hi plane
      load_state(Sh, 0);
      cp_async_commit();
    }

    // one source tile; on the diagonal (DIAG) only the 16-column groups at or
    // left of the warp's rows are computed, elsewhere every loop is full
    auto source_tile = [&](auto diag_flag) {
      constexpr bool DIAG = decltype(diag_flag)::value;
      const int np_max = DIAG ? warp : TILE / 16 - 1;
      const T* Bst = Bs(stage);
      const T* Xst = Xs(stage);
      const float* cs_ = cums + stage * TILE;
      const float* ds_ = dts + stage * TILE;

      // per 16-column group np: scores C B^T (two n-tiles), the gate, then
      // the group is one bf16 A fragment of G x (k-step np)
#pragma unroll
      for (int np = 0; np < TILE / 16; ++np) {
        if (np > np_max) continue;
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kd = 0; kd < NK; ++kd) {
          uint32_t r[4];
          ldsm_x4(r, Bst + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDN + kd * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(sc[0], qf[kd], r[0], r[1]);
          mma_bf16(sc[1], qf[kd], r[2], r[3]);
        }
        // G = (C B^T) exp(cum_q - cum_s) dt_s, where s <= q < nq
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qr = e < 2 ? r0 : r1, col = 16 * np + 8 * j + 2 * t4 + (e & 1);
            sc[j][e] = (qr < nq && (!DIAG || col <= qr))
                           ? sc[j][e] * __expf((e < 2 ? cq0 : cq1) - cs_[col]) * ds_[col]
                           : 0.f;
          }
        const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                                pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
        for (int dp = 0; dp < NP16; ++dp) {
          uint32_t r[4];
          ldsm_x4_trans(r, Xst + (np * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                               dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa, r[0], r[1]);
          mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    };
    if (live) {
      if (s_t == k.qt) source_tile(Flag<true>{});
      else source_tile(Flag<false>{});
    }
    __syncthreads();   // this stage is refilled next turn
  }
  cp_async_wait<0>();
  __syncthreads();

  // carry-in: exp(cum_q) C S^T, as C S_hi^T + C S_lo^T per 16 columns of y
  if (live) {
    const float e0 = expf(cq0), e1 = expf(cq1);
#pragma unroll
    for (int dp = 0; dp < NP16; ++dp) {
      float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kd = 0; kd < NK; ++kd) {
        const int off = (dp * 16 + (lane & 7) + (lane >> 4) * 8) * LDN + kd * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldsm_x4(r, Sh + off);
        mma_bf16(t[0], qf[kd], r[0], r[1]);
        mma_bf16(t[1], qf[kd], r[2], r[3]);
        ldsm_x4(r, Sl + off);
        mma_bf16(t[0], qf[kd], r[0], r[1]);
        mma_bf16(t[1], qf[kd], r[2], r[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[2 * dp + j][0] = fmaf(e0, t[j][0], acc[2 * dp + j][0]);
        acc[2 * dp + j][1] = fmaf(e0, t[j][1], acc[2 * dp + j][1]);
        acc[2 * dp + j][2] = fmaf(e1, t[j][2], acc[2 * dp + j][2]);
        acc[2 * dp + j][3] = fmaf(e1, t[j][3], acc[2 * dp + j][3]);
      }
    }
  }

  if (!live) return;
  T* yb = static_cast<T*>(a.y) + ((((long long)k.b * a.L + l0 + q0) * a.H + k.h) * P);
  const long long ys = (long long)a.H * P;   // y's row stride
#pragma unroll
  for (int j = 0; j < MAX_P / 8; ++j) {
    const int p = 8 * j + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= nq || p >= P) continue;
      T* o = yb + r * ys + p;
      const float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
      if ((P & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = __float2bfloat16(v0);
        if (p + 1 < P) o[1] = __float2bfloat16(v1);
      }
    }
  }
}

size_t scan_smem_f32(int N) {
  const int NPt = f32_pitch(N);
  const int ss = MAX_P * NPt > TILE * GP ? MAX_P * NPt : TILE * GP;
  return sizeof(float) * ((size_t)3 * TILE * NPt + 2 * TILE * MAX_P + ss + 4 * TILE);
}

// f32: 16 x 16 threads, thread (ty, tx) owns query rows 4 ty + i and
// columns tx + 16 j (i, j < 4) of the [64, P] output and of each 64 x 64
// score tile; C, B and the state are read as float4 along n, the gate tile
// through shared memory (the space of the state, once the carry-in is done).
template <bool VEC>
__global__ void __launch_bounds__(SC_F32_THREADS) chunk_scan_f32(const Args a) {
  const int P = a.P, N = a.N, Q = a.Q;
  const int NPt = f32_pitch(N), N4 = round_up(N, 4);
  extern __shared__ __align__(16) float fsm[];
  float* Cs = fsm;                      // [TILE][NPt]
  float* Bs = Cs + TILE * NPt;          // [2][TILE][NPt]
  float* Xs = Bs + 2 * TILE * NPt;      // [2][TILE][MAX_P]
  float* Ss = Xs + 2 * TILE * MAX_P;    // [MAX_P][NPt] the state, then
  float* Gs = Ss;                       // [TILE][GP] the gate tile
  float* cums = Ss + (MAX_P * NPt > TILE * GP ? MAX_P * NPt : TILE * GP);   // [2][TILE]
  float* dts = cums + 2 * TILE;                                             // [2][TILE]

  const ScanBlock k = scan_block(a);
  const int g = k.h / (a.H / a.G), q0 = k.qt * TILE, nq = min(TILE, Q - q0);
  const long long l0 = (long long)k.c * Q;
  const float* xb = static_cast<const float*>(a.x) + k.b * a.xs.b + k.h * a.xs.h + l0 * a.xs.l;
  const float* db = a.dt + k.b * a.ds.b + k.h * a.ds.h + l0 * a.ds.l;
  const float* bb = static_cast<const float*>(a.Bm) + k.b * a.bs.b + g * a.bs.h + l0 * a.bs.l;
  const float* cb = static_cast<const float*>(a.Cm) + k.b * a.cs.b + g * a.cs.h + l0 * a.cs.l;
  const float* cumb = a.cum + ((long long)k.b * a.H + k.h) * a.L + l0;
  const float* sb = a.st + (((long long)k.b * a.H + k.h) * a.nc + k.c) * P * N;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  auto load_src = [&](int s_t, int stage) {
    const int s0 = s_t * TILE, ns = min(TILE, Q - s0);
    load_tile<float, VEC, TILE>(Bs + stage * TILE * NPt, NPt, bb + s0 * a.bs.l, a.bs.l, ns,
                                N, N4, tid, SC_F32_THREADS);
    load_tile<float, VEC, TILE>(Xs + stage * TILE * MAX_P, MAX_P, xb + s0 * a.xs.l, a.xs.l,
                                ns, P, MAX_P, tid, SC_F32_THREADS);
    if (tid < TILE) {
      const bool in = tid < ns;
      cp_async4(cums + stage * TILE + tid, in ? cumb + s0 + tid : cumb, in);
      cp_async4(dts + stage * TILE + tid, in ? db + (s0 + tid) * a.ds.l : db, in);
    }
  };

  load_tile<float, VEC, TILE>(Cs, NPt, cb + q0 * a.cs.l, a.cs.l, nq, N, N4, tid,
                              SC_F32_THREADS);
  load_src(0, 0);
  cp_async_commit();
  for (int idx = tid; idx < MAX_P * N4; idx += SC_F32_THREADS) {   // entering state
    const int p = idx / N4, n = idx % N4;
    const bool in = p < P && n < N;   // zero past P and N
    cp_async4(Ss + p * NPt + n, in ? sb + p * N + n : sb, in);
  }
  cp_async_commit();

  float cq[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    cq[i] = r < nq ? cumb[q0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int s_t = 0; s_t <= k.qt; ++s_t) {
    const int stage = s_t & 1;
    if (s_t < k.qt) load_src(s_t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Bst = Bs + stage * TILE * NPt;
    const float* Xst = Xs + stage * TILE * MAX_P;
    const float* cs_ = cums + stage * TILE;
    const float* ds_ = dts + stage * TILE;
    const bool diag = s_t == k.qt;

    if (s_t == 0) {   // carry-in: exp(cum_q) C_q S^T
      for (int n = 0; n < N4; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(Cs + (4 * ty + i) * NPt + n);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sv[j] = *reinterpret_cast<const float4*>(Ss + (tx + 16 * j) * NPt + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(cv[i].x, sv[j].x, acc[i][j]);
            acc[i][j] = fmaf(cv[i].y, sv[j].y, acc[i][j]);
            acc[i][j] = fmaf(cv[i].z, sv[j].z, acc[i][j]);
            acc[i][j] = fmaf(cv[i].w, sv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(cq[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
    }

    float gt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gt[i][j] = 0.f;
    for (int n = 0; n < N4; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cv[i] = *reinterpret_cast<const float4*>(Cs + (4 * ty + i) * NPt + n);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(Bst + (tx + 16 * j) * NPt + n);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gt[i][j] = fmaf(cv[i].x, bv[j].x, gt[i][j]);
          gt[i][j] = fmaf(cv[i].y, bv[j].y, gt[i][j]);
          gt[i][j] = fmaf(cv[i].z, bv[j].z, gt[i][j]);
          gt[i][j] = fmaf(cv[i].w, bv[j].w, gt[i][j]);
        }
    }
    if (s_t == 0) __syncthreads();   // the carry-in's reads of Ss are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, sc = tx + 16 * j;
        Gs[r * GP + sc] = (r < nq && (!diag || sc <= r))
                              ? gt[i][j] * expf(cq[i] - cs_[sc]) * ds_[sc]
                              : 0.f;
      }
    __syncthreads();
    const int s_end = diag ? 4 * ty + 4 : TILE;   // the gate is 0 past the rows
    for (int s = 0; s < s_end; s += 4) {
      float4 gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        gv[i] = *reinterpret_cast<const float4*>(Gs + (4 * ty + i) * GP + s);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = Xst[(s + kk) * MAX_P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gk = kk == 0 ? gv[i].x : kk == 1 ? gv[i].y : kk == 2 ? gv[i].z : gv[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gk, xv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();   // this stage and the gate tile are rewritten next turn
  }
  cp_async_wait<0>();

  float* yb = static_cast<float*>(a.y) + ((((long long)k.b * a.L + l0 + q0) * a.H + k.h) * P);
  const long long ys = (long long)a.H * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < P) yb[r * ys + p] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------ host side

bool aligned16(const void* p, long long s0, long long s1, long long s2, int esize) {
  const long long e = 16 / esize;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % e == 0 && s1 % e == 0 &&
         s2 % e == 0;
}

template <typename K>
cudaError_t launch_with(K kernel, dim3 grid, int threads, size_t smem, const Args& a,
                        cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr bool bf16 = sizeof(T) == 2;
  constexpr int E = 16 / sizeof(T);
  const bool vec = a.P % E == 0 && a.N % E == 0 &&
                   aligned16(a.x, a.xs.b, a.xs.l, a.xs.h, sizeof(T)) &&
                   aligned16(a.Bm, a.bs.b, a.bs.l, a.bs.h, sizeof(T)) &&
                   aligned16(a.Cm, a.cs.b, a.cs.l, a.cs.h, sizeof(T));
  const long long nqt = (a.Q + TILE - 1) / TILE;
  const long long scan_blocks = nqt * a.nc * a.H * B;
  if (B > 65535 || a.H > 65535 || (long long)a.H * B > 65535 || scan_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;

  // 1. chunk summaries and cum
  const dim3 g1(a.nc, a.H, B);
  cudaError_t err;
  if (bf16 && a.N <= 64)
    err = launch_with(vec ? chunk_state_bf16<true, 4> : chunk_state_bf16<false, 4>, g1,
                      ST_THREADS, state_smem_bf16(4), a, stream);
  else if (bf16)
    err = launch_with(vec ? chunk_state_bf16<true, 8> : chunk_state_bf16<false, 8>, g1,
                      ST_THREADS, state_smem_bf16(8), a, stream);
  else if (a.N <= 64)
    err = launch_with(vec ? chunk_state_f32<true, 4> : chunk_state_f32<false, 4>, g1,
                      ST_THREADS, state_smem_f32(4), a, stream);
  else
    err = launch_with(vec ? chunk_state_f32<true, 8> : chunk_state_f32<false, 8>, g1,
                      ST_THREADS, state_smem_f32(8), a, stream);
  if (err != cudaSuccess) return err;

  // 2. entering states and the final state
  const int cols = bf16 ? round_up(a.N, 16) : a.N;
  if (a.N % 4 == 0)
    state_pass<T, 4><<<dim3((a.P * cols / 4 + 255) / 256, a.H * B), 256, 0, stream>>>(a);
  else
    state_pass<T, 1><<<dim3((a.P * cols + 255) / 256, a.H * B), 256, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 3. y
  const dim3 g3((unsigned)scan_blocks);
  if (bf16 && a.N <= 64)
    return launch_with(vec ? chunk_scan_bf16<true, 4> : chunk_scan_bf16<false, 4>, g3,
                       SC_BF_THREADS, scan_smem_bf16(a.N), a, stream);
  if (bf16)
    return launch_with(vec ? chunk_scan_bf16<true, 8> : chunk_scan_bf16<false, 8>, g3,
                       SC_BF_THREADS, scan_smem_bf16(a.N), a, stream);
  return launch_with(vec ? chunk_scan_f32<true> : chunk_scan_f32<false>, g3, SC_F32_THREADS,
                     scan_smem_f32(a.N), a, stream);
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (x, B, C, y and the final state); dt and
// A are float32.  cum [B, H, L] and states [B, H, L / Q, P, N] are f32
// scratch the caller allocates, and for bf16 also hl [B, H, L / Q, 2, P,
// round_up(N, 16)] in bf16 (null for f32).  Strides in elements, the last dim
// contiguous.  Takes P <= 64, N <= 128, L % Q == 0 and H % G == 0.  Three
// launches on `stream`; returns the first CUDA error (0 when all three
// were accepted).
int ssd_scan_forward(int dtype, const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, void* y, void* fin, float* cum,
                     float* states, void* hl, int B, int L, int H, int G, int P, int N, int Q,
                     long long xsb, long long xsl, long long xsh, long long dsb,
                     long long dsl, long long dsh, long long bsb, long long bsl,
                     long long bsg, long long csb, long long csl, long long csg,
                     void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 || P > MAX_P ||
      N <= 0 || N > MAX_N || Q <= 0 || L % Q != 0)
    return cudaErrorInvalidValue;
  if (dtype == 1 && hl == nullptr) return cudaErrorInvalidValue;
  const Args a{x, dt, A, Bm, Cm, y, fin, cum, states, static_cast<__nv_bfloat16*>(hl),
               L, H, G, P, N, Q, L / Q, {xsb, xsl, xsh}, {dsb, dsl, dsh},
               {bsb, bsl, bsg}, {csb, csl, csg}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, st);
  return cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
