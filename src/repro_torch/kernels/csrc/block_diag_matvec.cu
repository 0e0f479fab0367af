// Block-Jacobi apply with explicit block inverses: a batched block-diagonal
// matvec
//
//     y[p] = A[p] @ x[p],   A: float[P, bs, bs],  x, y: float[P, bs]
//
// Replaces the TPU kernel
// src/repro/kernels/block_diag_matmul.py::block_diag_matvec_pallas.
//
// Bound: bytes.  The blocks are read once, P * bs^2 * 4 bytes (1.81 GB at
// P = 1,728, bs = 512), against 2 * P * bs^2 flops: a quarter flop per byte,
// far below what float32 arithmetic could sustain, so the kernel is a stream
// over A.  The TPU pads bs to a multiple of 128 for its matrix unit; that
// tiling is not carried over, and any bs whose x fits in shared memory runs.
//
// Design: one thread block per p.  The block stages x[p] in shared memory;
// each warp takes rows i, i + warps, ..., reads row i of A[p] with lanes on
// adjacent addresses (coalesced), multiplies by the staged x and reduces
// with shuffles.  No atomics: every y[p, i] has one writer.
#include <cuda_runtime.h>

namespace {

__global__ void block_diag_matvec_kernel(const float* __restrict__ A, const float* __restrict__ x,
                                         float* __restrict__ y, int bs) {
  extern __shared__ float xs[];
  const long long p = blockIdx.x;
  const float* Ap = A + p * bs * bs;
  for (int j = threadIdx.x; j < bs; j += blockDim.x) xs[j] = x[p * bs + j];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  // the row loop bound is the same for all lanes of a warp, so every lane
  // reaches the shuffles
  for (int i = warp; i < bs; i += n_warps) {
    const float* row = Ap + (long long)i * bs;
    float acc = 0.f;
#pragma unroll 4
    for (int j = lane; j < bs; j += 32) acc += row[j] * xs[j];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) y[p * bs + i] = acc;
  }
}

}  // namespace

extern "C" int block_diag_matvec_f32(const void* A, const void* x, void* y, int p, int bs,
                                     void* stream) {
  if (p > 0 && bs > 0) {
    const int block = 256;
    block_diag_matvec_kernel<<<p, block, bs * sizeof(float), (cudaStream_t)stream>>>(
        (const float*)A, (const float*)x, (float*)y, bs);
  }
  return (int)cudaGetLastError();
}
