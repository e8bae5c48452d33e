// flash_attention: blocked online-softmax GQA attention on Hopper (sm_90a).
// bf16 runs on the tensor cores (mma.sync, f32 accumulators); f32 runs in
// f32 FFMA.  Softmax statistics and the output accumulator are f32 in both.
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
// v and o: 0.139 ms of bf16 tensor-core time at 989 TFLOP/s, 2.05 ms of f32
// FFMA at 67 TFLOP/s, and 0.040 ms of HBM traffic at 3.35 TB/s.  So
// operations bound both routes, and the bf16 route has to reach the tensor
// cores to come near its bound.
//
// bf16 design (fa_bf16_kernel).  One block of 8 warps per (128-query tile,
// head, batch); each warp owns 16 query rows, the m16 of
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.
//   * q's A fragments are loaded once per block with ldmatrix and stay in
//     registers.  The scale D^-0.5 (times log2 e, for exp2) multiplies the
//     f32 scores after the product, as _fa_kernel scales q in f32: folding
//     it into bf16 q would add a rounding the reference does not have.
//   * Key tiles of 64 rows: k is read by ldmatrix as the col-major B of
//     q k^T; the 16 x 64 score tile stays in f32 accumulators.  The online
//     softmax works on those fragments; a row's max needs two quad shuffles
//     (the 4 lanes of a C-fragment row), its sum stays per lane until the
//     end.
//   * p becomes bf16 A fragments in registers (the m16n8 C layout of two
//     adjacent key n-tiles is the m16k16 A layout), so p never touches
//     shared memory; v is read by ldmatrix.trans; the [16, D] accumulator is
//     f32.  Rounding p to bf16 for PV is what the model's plain route does
//     (models/layers.py, probs.to(v.dtype)).
//   * k and v go through a two-stage ring in shared memory filled by 16-byte
//     cp.async: the next live tile's copy is in flight while this tile's
//     math runs.  Rows are padded by 16 bytes, so the 8 rows an ldmatrix
//     phase reads fall in 8 different 4-bank groups.
//   * Masks cost only where they bite: a key tile that the mask empties for
//     the whole query tile is never loaded (tile_live), a warp whose 16 rows
//     it empties skips the tile's math, and per-element masks are evaluated
//     only on tiles that straddle a causal, window, prefix or Sk edge
//     (tile_full).  Skipping is exact: in _fa_kernel an empty tile leaves m,
//     l and the accumulator unchanged, bit for bit.
//   * Causal balance: block x walks the query tiles from the last (most
//     live key tiles) to the first, all heads and batches of a tile before
//     the next tile, so the long blocks start first.
//   * Head dim 256 (paligemma-3b).  Held in registers, q's fragments would
//     take 64 registers a thread beside the 128 of the [16, 256] f32
//     accumulator and the 32 of the score tile: past the 255 a thread can
//     have once addressing is counted, so it would spill.  At D = 256 the
//     fragments are instead re-read with ldmatrix from the q tile, which
//     stays in shared memory for the block's life, once per 16-wide k-step
//     of each key tile (one ldmatrix beside the four of k it already
//     issues).  The tiles stay 128 x 64, so the mask rules and the causal
//     order are the same code: q's 66 KB and the 132 KB k/v ring are
//     198 KB of shared memory, one block of 8 warps an SM.
//   * What still bounds it: mma.sync issues from registers fed by ldmatrix,
//     one warp at a time, with the loads done by the same warps that
//     multiply; wgmma with TMA and a producer warp is the next step.
//
// f32 design (fa_f32_kernel).  One block of 256 threads per (64-query tile,
// head, batch) stages its q tile (scaled, f32) once, then walks 64-key
// tiles: k and v in f32 in shared memory, s = q k^T as 4 x 4 register tiles
// per thread (16 threads per query row, so the row max and sum are 4
// shuffles), p through shared memory into the [64, D] accumulator held in
// registers (4 rows x D/16 columns per thread).  Empty key tiles are skipped
// as above.  Rows of k and q are padded to D + 1 floats so the k-row reads
// of a warp fall in 16 different banks.  TF32 or bf16 products could not
// meet the f32 tolerance of 2e-5, so this route stays in FFMA.  At D = 256
// a thread holds 4 x 16 accumulators and the block 209 KB of shared memory
// (q and k padded, v, p), under the 227 KB opt-in limit: one block an SM.
//
// Determinism.  Every sum has a fixed order (d = 0..D-1 and keys in tile
// order in the f32 route, the mma's fixed internal order in the bf16 route,
// fixed shuffle trees); no atomics and no split over keys, so two launches
// are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BK = 64;         // keys per tile (both routes)
constexpr float NEG_INF = -1e30f;

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

// Could any (query, key) pair of rows [q0, qmax] and the key tile at k0 be
// valid?  Exact for the union of per-row intervals (qi - window, qi], which
// is contiguous.  ref.tile_live mirrors it for the tests.
__device__ __forceinline__ bool tile_live(int q0, int qmax, int k0, int Sk,
                                          Mask mk) {
  const int kmax = min(k0 + BK, Sk) - 1;
  if (mk.prefix_len > 0 && k0 < min(mk.prefix_len, Sk)) return true;
  if (mk.causal && k0 > qmax) return false;
  if (mk.window > 0 && kmax <= q0 - mk.window) return false;
  return true;
}

// Is every pair of rows [q0, qmax] and the key tile at k0 valid?  Then the
// tile needs no per-element mask.  ref.tile_full mirrors it.
__device__ __forceinline__ bool tile_full(int q0, int qmax, int k0, int Sk,
                                          Mask mk) {
  const int kmax = k0 + BK - 1;
  if (kmax >= Sk) return false;
  if (mk.prefix_len > 0 && kmax < mk.prefix_len) return true;
  if (mk.causal && kmax > q0) return false;
  if (mk.window > 0 && k0 <= qmax - mk.window) return false;
  return true;
}

// ---------------------------------------------------------------- f32 route

constexpr int F32_BQ = 64;         // queries per block
constexpr int F32_THREADS = 256;   // 16 x 16: ty picks 4 rows, tx 4 (or D/16) columns

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H,
              int K, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
              Strides os, float scale, Mask mk) {
  constexpr int BQ = F32_BQ;
  constexpr int THREADS = F32_THREADS;
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  for (int idx = t; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    Qs[r * DP + d] = (q0 + r < Sq) ? qb[(q0 + r) * qs.s + d] * scale : 0.f;
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
      Ks[r * DP + d] = in ? kb[(k0 + r) * ks.s + d] : 0.f;
      Vs[r * D + d] = in ? vb[(k0 + r) * vs.s + d] : 0.f;
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

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CJ; ++j) ob[qi * os.s + tx + 16 * j] = acc[i][j] / denom;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int K, int Sq, int Sk, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale,
                       Mask mk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(F32_BQ * (D + 1) + BK * (D + 1) +
                                               BK * D + F32_BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + F32_BQ - 1) / F32_BQ, H, B);
  fa_f32_kernel<D><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, K, Sq, Sk, qs,
      ks, vs, os, scale, mk);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 route

constexpr int BF_BQ = 128;         // queries per block: 8 warps x 16 rows
constexpr int BF_WARPS = BF_BQ / 16;
constexpr int BF_THREADS = 32 * BF_WARPS;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU (2 ulp; a result below 2^-126 flushes to 0, which a p that
// small could not move in a bf16 output anyway).  exp2f wraps the same
// instruction in range handling for arguments the scores never reach.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Fragment ownership (PTX ISA, mma.m16n8k16): lane = 4 g + t; a C fragment
// holds rows g and g + 8 at columns 2t and 2t + 1 of an 8-column n-tile.
// Up to D = 64 the registers are held to 128 a thread, so two blocks (16
// warps) share an SM and hide each other's barrier and copy waits.
template <int D>
__global__ void __launch_bounds__(BF_THREADS, D <= 64 ? 2 : 1)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int B, int H, int K, int Sq, int Sk, Strides qs, Strides ks,
               Strides vs, Strides os, float scale_log2, Mask mk) {
  constexpr int BQ = BF_BQ;
  constexpr int LD = D + 8;        // padded shared row, in bf16 (16 bytes of pad)
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr int KD = D / 16;       // k-steps of q k^T
  constexpr int NS = BK / 8;       // n-tiles of the score tile
  constexpr int NO = D / 8;        // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BQ][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                                 // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;                             // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int HB = H * B;
  const int qt = (int)(gridDim.x / HB) - 1 - (int)(blockIdx.x / HB);
  const int h = blockIdx.x % HB % H, b = blockIdx.x % HB / H;
  const int q0 = qt * BQ, kh = h / (H / K);
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;

  for (int idx = tid; idx < BQ * CH; idx += BF_THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool in = q0 + r < Sq;
    cp_async16(Qs + r * LD + c * 8, in ? qb + (q0 + r) * qs.s + c * 8 : qb, in);
  }
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    __nv_bfloat16* kd = Ks + stage * BK * LD;
    __nv_bfloat16* vd = Vs + stage * BK * LD;
    for (int idx = tid; idx < BK * CH; idx += BF_THREADS) {
      const int r = idx / CH, c = idx % CH;
      const bool in = k0 + r < Sk;
      cp_async16(kd + r * LD + c * 8, in ? kb + (k0 + r) * ks.s + c * 8 : kb, in);
      cp_async16(vd + r * LD + c * 8, in ? vb + (k0 + r) * vs.s + c * 8 : vb, in);
    }
  };

  const int qmax = min(q0 + BQ, Sq) - 1;
  const int nk = (Sk + BK - 1) / BK;
  auto next_live = [&](int kt) {
    while (kt < nk && !tile_live(q0, qmax, kt * BK, Sk, mk)) ++kt;
    return kt;
  };

  // this warp's 16 rows
  const int wq0 = q0 + warp * 16;
  const int wqmax = min(wq0 + 15, Sq - 1);
  const int row0 = wq0 + g, row1 = row0 + 8;

  // q's A fragments: all KD of them in registers up to D = 128; at D = 256
  // one, re-read from Qs at each k-step (see the header)
  constexpr bool QREG = D <= 128;
  const __nv_bfloat16* q_frag_s =
      Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  uint32_t qf[QREG ? KD : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // rows g, g + 8

  int kt = next_live(0);
  if (kt < nk) load_kv(kt, 0);
  cp_async_commit();                        // q and the first k/v tile
  bool have_q = false;
  int stage = 0;
  while (kt < nk) {
    const int kn = next_live(kt + 1);
    if (kn < nk) load_kv(kn, stage ^ 1);
    cp_async_commit();                      // possibly empty
    cp_async_wait<1>();                     // all but the newest group landed
    __syncthreads();

    if (QREG && !have_q) {
#pragma unroll
      for (int kd = 0; kd < (QREG ? KD : 1); ++kd) ldsm_x4(qf[kd], q_frag_s + kd * 16);
      have_q = true;
    }

    const int k0 = kt * BK;
    if (wq0 < Sq && tile_live(wq0, wqmax, k0, Sk, mk)) {   // uniform per warp
      const __nv_bfloat16* kt_s = Ks + stage * BK * LD;
      const __nv_bfloat16* vt_s = Vs + stage * BK * LD;

      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t(&a)[4] = qf[QREG ? kd : 0];
        if (!QREG) ldsm_x4(a, q_frag_s + kd * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, kt_s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kd * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, r[0], r[1]);
          mma_bf16(s[2 * np + 1], a, r[2], r[3]);
        }
      }

      const bool full = tile_full(wq0, wq0 + 15, k0, Sk, mk);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (!full && !valid(e < 2 ? row0 : row1, k0 + 8 * j + 2 * t4 + (e & 1), Sk, mk))
            x = NEG_INF;
          s[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2_approx(m0 - mn0), c1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked score is the sentinel; its p is 0 whatever the max
          const float p = (!full && s[j][e] == NEG_INF)
                              ? 0.f
                              : exp2_approx(s[j][e] - (e < 2 ? mn0 : mn1));
          s[j][e] = p;
          if (e < 2) sum0 += p; else sum1 += p;
        }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][0] *= c0;
        acc[j][1] *= c0;
        acc[j][2] *= c1;
        acc[j][3] *= c1;
      }

#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t r[4];
          ldsm_x4_trans(r, vt_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                               dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa, r[0], r[1]);
          mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();                        // this stage is refilled next turn
    stage ^= 1;
    kt = kn;
  }
  cp_async_wait<0>();                       // q's copy, if no tile was live

  // a row's sum is spread over its quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int d = 8 * j + 2 * t4;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * os.s + d) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * os.s + d) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int K, int Sq, int Sk, Strides qs,
                        Strides ks, Strides vs, Strides os, float scale,
                        Mask mk, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BF_BQ + 4 * BK) * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((Sq + BF_BQ - 1) / BF_BQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fa_bf16_kernel<D><<<(unsigned)blocks, BF_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), B, H,
      K, Sq, Sk, qs, ks, vs, os, scale * LOG2E, mk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16 (q, k, v and o alike); head_dim in
// {32, 64, 128, 256}; strides in elements, D contiguous (for bf16 the pointers
// and strides are 16-byte multiples); scale is D^-0.5 as the caller rounds
// it to f32; window <= 0 means none.
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
#define FA_ARGS q, k, v, o, B, H, K, Sq, Sk, qs, ks, vs, os, scale, mk, st
  if (dtype == 0) {
    switch (head_dim) {
      case 32: return launch_f32<32>(FA_ARGS);
      case 64: return launch_f32<64>(FA_ARGS);
      case 128: return launch_f32<128>(FA_ARGS);
      case 256: return launch_f32<256>(FA_ARGS);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 32: return launch_bf16<32>(FA_ARGS);
      case 64: return launch_bf16<64>(FA_ARGS);
      case 128: return launch_bf16<128>(FA_ARGS);
      case 256: return launch_bf16<256>(FA_ARGS);
    }
  }
#undef FA_ARGS
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
