// ELLPACK reduced-Laplacian matvec, the PCG hot loop:
//
//     y[u] = diag[u] * v[u] + sum_lane vals[u, lane] * v[cols[u, lane]]
//
// Batched: vals float[B, n, k], diag float[B, n], v float[B, nv] and y
// float[B, n] hold B lanes that share one cols int32[n, k].  The grid's y
// index is the lane, so the plan is not copied per lane and no thread
// divides by n.  One instance (B = 1) runs the kernel compiled without the
// lane offsets: with them it ran ~22% slower at the 96³ shapes on an H100.
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv.py::ell_spmv_pallas.
//
// Bound: bytes.  Each row reads k column ids and k values, diag[u] and v[u],
// and writes y[u]: n * (8k + 12) bytes for float32, against 2nk + n flops.
// The gather v[cols] is served from L2 (v is 4n bytes: 3.5 MB at n = 884,736,
// well inside the 50 MB L2), so device memory sees the streamed rows.
//
// Design: a group of G lanes per row, G the smallest power of two >= k
// (at most 32).  Lane j of a group reads slots j, j + G, ..., so the loads of
// a warp cover adjacent addresses of adjacent rows.  The group reduces its
// partial sums with shuffles; there is no shared memory and no atomic.  The
// sum is taken in float32 for both float32 and bfloat16 inputs.  A column id
// outside [0, nv) gathers 0, as the TPU kernel's fill_value=0 does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, bool kBatched>
__global__ void ell_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                                const T* __restrict__ diag, const T* __restrict__ v,
                                T* __restrict__ y, int n, int k, int nv, int group) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long prow = tid / group;  // row of the shared plan
  const int lane = (int)(tid % group);
  // the row and voltages of this batch lane
  const long long row = kBatched ? (long long)blockIdx.y * n + prow : prow;
  const T* vb = kBatched ? v + (long long)blockIdx.y * nv : v;
  float acc = 0.f;
  if (prow < n) {
    const long long base = row * k;
    const long long cbase = kBatched ? prow * k : base;
#pragma unroll 4
    for (int j = lane; j < k; j += group) {
      const unsigned c = (unsigned)cols[cbase + j];
      const float vc = c < (unsigned)nv ? to_float(vb[c]) : 0.f;
      acc += to_float(vals[base + j]) * vc;
    }
  }
  // every lane of the warp reaches the shuffles: rows past n add 0
  for (int off = group >> 1; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, group);
  if (prow < n && lane == 0)
    y[row] = from_float<T>(to_float(diag[row]) * to_float(vb[prow]) + acc);
}

template <typename T>
int launch(const void* cols, const void* vals, const void* diag, const void* v, void* y,
           int n, int k, int nv, int group, int batch, void* stream) {
  if (n > 0 && batch > 0) {
    const int block = 256;  // a multiple of 32, so groups never straddle a warp
    const long long threads = (long long)n * group;
    const dim3 grid((unsigned)((threads + block - 1) / block), (unsigned)batch);
    if (batch == 1)
      ell_spmv_kernel<T, false><<<grid, block, 0, (cudaStream_t)stream>>>(
          (const int*)cols, (const T*)vals, (const T*)diag, (const T*)v, (T*)y, n, k, nv, group);
    else
      ell_spmv_kernel<T, true><<<grid, block, 0, (cudaStream_t)stream>>>(
          (const int*)cols, (const T*)vals, (const T*)diag, (const T*)v, (T*)y, n, k, nv, group);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_spmv_f32(const void* cols, const void* vals, const void* diag, const void* v,
                            void* y, int n, int k, int nv, int group, int batch,
                            void* stream) {
  return launch<float>(cols, vals, diag, v, y, n, k, nv, group, batch, stream);
}

extern "C" int ell_spmv_bf16(const void* cols, const void* vals, const void* diag, const void* v,
                             void* y, int n, int k, int nv, int group, int batch,
                             void* stream) {
  return launch<__nv_bfloat16>(cols, vals, diag, v, y, n, k, nv, group, batch, stream);
}
