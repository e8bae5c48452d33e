// packed_qnet_stacked: the fleet's per-worker MolDQN Q forward on Hopper
// (sm_90a), f32 FFMA, reading the candidates as packed fingerprint planes.
//
// Replaces the TPU kernel
// repro/kernels/packed_qnet/packed_qnet.py::packed_qnet_stacked_rows (body
// _packed_qnet_stacked_kernel).  For each worker w and candidate row c:
//
//   q[w, c] = MLP_w([unpackbits(bits[w, c]), frac[w, c]])
//
// with bits u8 [W, C, 256] (bit 8i+k is bit 7-k of byte i, the pack_fps
// contract), frac f32 [W, C], and worker w's own five (W_l [in, out], b_l)
// layers, stacked as [W, in, out] and [W, out].
//
// What bounds it on this card.  One row is 2,692,128 MACs = 5.38 MFLOP and
// one worker's parameters are 10.78 MB.  At the launcher's 4 workers x 1024
// rows that is 22.05 GFLOP against 44 MB: 330 us of f32 FMA at 67 TFLOP/s
// against 13 us of traffic at 3.35 TB/s, so operations bound it.  At a wide
// fleet of 128 workers x 32 rows the arithmetic is the same but the weights
// are 1.38 GB, 412 us of traffic: there the per-worker weight bytes bound
// it.  Products stay in f32 FFMA: TF32's 10 mantissa bits cannot meet the
// port's 1e-4 tolerance over a 2049-term sum.
//
// What does not carry over from the TPU.  The Pallas kernel keeps all ~11 MB
// of a worker's weights in VMEM and re-associates layer 1 into 8 bit-plane
// matmuls against pack_w1's [8, 256, 1024] slices.  Neither fits a Hopper
// block's 227 KB of shared memory.  Here every layer is one launch of the
// tiled SGEMM in ../../csrc/qnet_tiles.cuh with blockIdx.z = worker:
//
//   * layer 1's A tile is unpacked from the u8 planes straight into shared
//     memory as exact 0.0 / 1.0, one nibble into four k values (column 2048
//     is frac), and B is read from worker w's W1 in the [in, out] layout,
//     so no pack_w1 and no dense [W, C, 2049] array in device memory;
//   * the tile is never taller than a worker's rows rounded up to 32, 64
//     or 128: at 128 workers x 32 rows a 32-row tile reads each worker's
//     weights once and wastes no FMAs;
//   * layers 2-4 use the same template with per-worker strides, h1..h4 in
//     device memory; the 32 -> 1 head is one thread per row;
//   * a ragged C is masked in the kernel, not padded; dead or finished rows
//     arrive as zero planes and evaluate like any other row.
//
// The same launch takes dense f32 rows [W, C, 2049] through a second A
// loader (the trainer's dense acting mode).  Both loaders feed the identical
// A values to the identical fmaf chains, so packed, dense and fused_qnet on
// a worker's densified rows give the same bits.
//
// Determinism.  Each output is one thread's sequential fmaf chain over
// k = 0 .. K-1: no split-K, no atomics.  A row's q depends only on that row
// and its worker's weights, and two launches are bit-identical.

#include "qnet_tiles.cuh"

extern "C" {

// Packed rows: bits u8 [n_workers, c, n_bytes], frac f32 [n_workers, c];
// K = 8 * n_bytes + 1.  h1..h4 are caller-allocated [n_workers, c, d1..d4],
// q is [n_workers, c].  Returns the first CUDA error (0 when all launches
// were accepted).
int packed_qnet_stacked_forward(const uint8_t* bits, const float* frac,
                                const float* w1, const float* b1,
                                const float* w2, const float* b2,
                                const float* w3, const float* b3,
                                const float* w4, const float* b4,
                                const float* w5, const float* b5,
                                float* h1, float* h2, float* h3, float* h4,
                                float* q, int n_workers, int c, int n_bytes,
                                int d1, int d2, int d3, int d4, void* stream) {
  return qnet::forward(qnet::PackedRows{bits, frac, c, n_bytes}, w1, b1, w2,
                       b2, w3, b3, w4, b4, w5, b5, h1, h2, h3, h4, q,
                       n_workers, c, 8 * n_bytes + 1, d1, d2, d3, d4,
                       static_cast<cudaStream_t>(stream));
}

// Dense rows: x f32 [n_workers, c, d0], otherwise as above.
int dense_qnet_stacked_forward(const float* x,
                               const float* w1, const float* b1,
                               const float* w2, const float* b2,
                               const float* w3, const float* b3,
                               const float* w4, const float* b4,
                               const float* w5, const float* b5,
                               float* h1, float* h2, float* h3, float* h4,
                               float* q, int n_workers, int c, int d0, int d1,
                               int d2, int d3, int d4, void* stream) {
  return qnet::forward(qnet::DenseRows{x, (long long)c * d0, d0}, w1, b1, w2,
                       b2, w3, b3, w4, b4, w5, b5, h1, h2, h3, h4, q,
                       n_workers, c, d0, d1, d2, d3, d4,
                       static_cast<cudaStream_t>(stream));
}

const char* packed_qnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
