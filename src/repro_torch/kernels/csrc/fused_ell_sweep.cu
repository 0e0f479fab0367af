// Single-sweep IRLS system build (paper eq. 4 -> eq. 8).  Per ELL slot
// (u, lane) holding edge e = (u, x):
//
//     z = c_e (v[u] - v[x]);   r = c_e^2 / sqrt(z^2 + eps^2);   vals = -r
//
// and per row the terminal conductances and the reduced-Laplacian diagonal:
//
//     r_s = c_s^2 / sqrt((c_s (1 - v[u]))^2 + eps^2)   (0 where c_s = 0)
//     r_t = c_t^2 / sqrt((c_t v[u])^2 + eps^2)         (0 where c_t = 0)
//     diag[u] = sum_lane r + r_s + r_t
//
// Batched: c_ell and vals float[B, n, k], c_s, c_t, diag, r_s, r_t
// float[B, n] and v float[B, nv] hold B lanes that share one cols int32[n, k].
// The grid's y index is the lane, so the plan is not copied per lane and no
// thread divides by n.  One instance (B = 1) runs the kernel compiled without
// the lane offsets: with them it ran ~33% slower at the 96³ shapes on an H100.
//
// Replaces the TPU kernel
// src/repro/kernels/edge_reweight.py::fused_ell_sweep_pallas.
//
// Bound: bytes.  Each row reads k column ids and k weights, c_s, c_t, v[u],
// and writes k values plus diag, r_s, r_t: n * (12k + 24) bytes, against
// about 8 flops and one reciprocal square root per slot.  The gather v[cols]
// is served from L2.
//
// Design: the row mapping of ell_spmv.cu — a group of G lanes per row (G the
// smallest power of two >= k, at most 32), lane j on slots j, j + G, ...,
// a shuffle reduction for the diagonal, no shared memory and no atomics.
// Each undirected edge is evaluated once per direction, as on the TPU: z^2
// is symmetric, so both copies get the same r without a cross-row scatter.
// v may be longer than n (halo-extended); a column id outside [0, nv)
// gathers 0, as the TPU kernel's fill_value=0 does.
#include <cuda_runtime.h>

namespace {

template <bool kBatched>
__global__ void fused_ell_sweep_kernel(const int* __restrict__ cols,
                                       const float* __restrict__ c_ell,
                                       const float* __restrict__ c_s,
                                       const float* __restrict__ c_t,
                                       const float* __restrict__ v, float eps2,
                                       float* __restrict__ vals, float* __restrict__ diag,
                                       float* __restrict__ r_s, float* __restrict__ r_t,
                                       int n, int k, int nv, int group) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long prow = tid / group;  // row of the shared plan
  const int lane = (int)(tid % group);
  // the row and voltages of this batch lane
  const long long row = kBatched ? (long long)blockIdx.y * n + prow : prow;
  const float* vb = kBatched ? v + (long long)blockIdx.y * nv : v;
  float acc = 0.f;
  float vr = 0.f;
  if (prow < n) {
    vr = vb[prow];
    const long long base = row * k;
    const long long cbase = kBatched ? prow * k : base;
#pragma unroll 4
    for (int j = lane; j < k; j += group) {
      const float c = c_ell[base + j];
      const unsigned col = (unsigned)cols[cbase + j];
      const float vc = col < (unsigned)nv ? vb[col] : 0.f;
      const float z = c * (vr - vc);
      const float r = (c * c) * rsqrtf(z * z + eps2);
      vals[base + j] = -r;
      acc += r;
    }
  }
  // every lane of the warp reaches the shuffles: rows past n add 0
  for (int off = group >> 1; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, group);
  if (prow < n && lane == 0) {
    const float cs = c_s[row];
    const float ct = c_t[row];
    const float zs = cs * (1.f - vr);
    const float zt = ct * vr;
    const float rs = cs > 0.f ? (cs * cs) * rsqrtf(zs * zs + eps2) : 0.f;
    const float rt = ct > 0.f ? (ct * ct) * rsqrtf(zt * zt + eps2) : 0.f;
    r_s[row] = rs;
    r_t[row] = rt;
    diag[row] = acc + rs + rt;
  }
}

}  // namespace

extern "C" int fused_ell_sweep_f32(const void* cols, const void* c_ell, const void* c_s,
                                   const void* c_t, const void* v, float eps2, void* vals,
                                   void* diag, void* r_s, void* r_t, int n, int k, int nv,
                                   int group, int batch, void* stream) {
  if (n > 0 && batch > 0) {
    const int block = 256;  // a multiple of 32, so groups never straddle a warp
    const long long threads = (long long)n * group;
    const dim3 grid((unsigned)((threads + block - 1) / block), (unsigned)batch);
    if (batch == 1)
      fused_ell_sweep_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
          (const int*)cols, (const float*)c_ell, (const float*)c_s, (const float*)c_t,
          (const float*)v, eps2, (float*)vals, (float*)diag, (float*)r_s, (float*)r_t, n, k,
          nv, group);
    else
      fused_ell_sweep_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
          (const int*)cols, (const float*)c_ell, (const float*)c_s, (const float*)c_t,
          (const float*)v, eps2, (float*)vals, (float*)diag, (float*)r_s, (float*)r_t, n, k,
          nv, group);
  }
  return (int)cudaGetLastError();
}
