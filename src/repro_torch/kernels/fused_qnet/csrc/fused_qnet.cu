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
// Design.  One launch per layer of the tiled SGEMM in
// ../../csrc/qnet_tiles.cuh (K slabs of A and B double-buffered in shared
// memory, up to 8 x 8 outputs per thread read as float4, bias + ReLU in the
// epilogue) and a one-thread-per-row 32 -> 1 head; h1..h4 live in device
// memory (13.9 MB at N = 2048, read back once each), which is cheap next to
// the arithmetic.  The tile is picked per layer so that the grid puts a
// block on nearly every one of the 132 SMs (layer 1 at N = 2048: 128 x 128
// tiles of 8 x 8 a thread, 128 blocks).  packed_qnet.cu runs the same tiles per worker, so both kernels
// give the same bits on the same rows.
//
// Row stride and masking.  K = 2049 makes the row stride of x 8196 bytes,
// not a multiple of 16, so layer 1 reads x as scalar f32 loads (16
// consecutive k of a row per slab); W1's rows (1024 floats) and every
// hidden layer are read as float4.  The K tail and ragged N are masked
// with zeros, which add exactly +0 to a sum.
//
// Determinism.  Each output element is one thread's sequential fmaf chain
// over k = 0 .. K-1, whatever the tile: no split-K, no atomics, no
// reduction whose order depends on scheduling.  So a row's q depends only
// on that row of x, and two launches on the same input are bit-identical.

#include "qnet_tiles.cuh"

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
  return qnet::forward(qnet::DenseRows{x, 0, d0}, w1, b1, w2, b2, w3, b3, w4,
                       b4, w5, b5, h1, h2, h3, h4, q, 1, n, d0, d1, d2, d3, d4,
                       static_cast<cudaStream_t>(stream));
}

const char* fused_qnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
