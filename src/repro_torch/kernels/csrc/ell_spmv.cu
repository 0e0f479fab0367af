// ELLPACK reduced-Laplacian matvec, the PCG hot loop:
//
//     y[u] = diag[u] * v[u] + sum_lane vals[u, lane] * v[cols[u, lane]]
//
// Batched: vals float[B, n, k], diag float[B, n], v float[B, nv] and y
// float[B, n] hold B lanes that share one cols int32[n, k].
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv.py::ell_spmv_pallas.
//
// Bound: bytes.  Each row reads k column ids and, per lane, k values,
// diag[u] and v[u], and writes y[u]: n * (4k + B(4k + 12)) bytes for
// float32, against 2nk + 2n flops per lane.  The gather v[cols] is served
// from L2 (v is 4n bytes: 3.5 MB at n = 884,736, well inside the 50 MB L2),
// so device memory sees the streamed rows.
//
// Two variants of one kernel, chosen by shape:
//
// * vector (k % 4 == 0, k <= 128, every plan build_ell_plan makes): a group
//   of G threads serves a row, G the smallest power of two >= k/4 (at most
//   8), so each thread loads its slots 4 at a time: one 16-byte load of cols
//   (int4) and one of vals (float4, or 8 bytes of bf16) per chunk of 4
//   slots.  A thread of one lane serves two rows at k = 32, and issues every
//   load of both, diag[u] and v[u] included, before it uses any, so enough
//   bytes are in flight to cover device memory's latency.  cols and vals are
//   streamed past L1 (__ldcs); v is read through the read-only path (__ldg)
//   and stays cached.  Batched, the group loads cols once and walks the
//   lanes (at most LANES_Y of them; the grid's y index takes the next
//   chunk), loading each lane's vals and gathering v[b, cols].
// * scalar (any k): a group of G lanes per row, G the smallest power of two
//   >= k (at most 32); lane j of a group reads slots j, j + G, ...  The grid's
//   y index is the lane, so no thread divides by n.
//
// Either way the group reduces its partial sums with shuffles; there is no
// shared memory and no atomic.  The sum is taken in float32 for both float32
// and bfloat16 inputs.  A column id outside [0, nv) gathers 0, as the TPU
// kernel's fill_value=0 does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;   // a multiple of 32, so groups never straddle a warp
constexpr int LANES_Y = 8;   // batch lanes one vector-variant thread walks

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive values, streamed (read once, not kept in L1)
__device__ __forceinline__ float4 stream4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 stream4(const __nv_bfloat16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// v[c], or 0 for a column id outside [0, nv)
template <typename T>
__device__ __forceinline__ float gather(const T* __restrict__ v, int c, int nv) {
  return (unsigned)c < (unsigned)nv ? to_float(__ldg(v + c)) : 0.f;
}

// NCH 16-byte chunks per thread and row, RPT rows per thread
template <typename T, int NCH, int RPT>
__global__ void __launch_bounds__(BLOCK)
ell_spmv_vec_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                    const T* __restrict__ diag, const T* __restrict__ v, T* __restrict__ y,
                    int n, int k, int nv, int group_log2, int batch) {
  const int G = 1 << group_log2;
  const int li = threadIdx.x & (G - 1);         // slot chunk of the group
  const int groups = BLOCK >> group_log2;       // row groups per block
  const long long row0 = (long long)blockIdx.x * RPT * groups + (threadIdx.x >> group_log2);
  const int k4 = k >> 2;

  // the rows' column ids, once for every lane; a missing chunk reads -1,
  // which gathers 0
  int4 c[RPT][NCH];
  bool has[RPT][NCH];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const long long row = row0 + (long long)r * groups;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int j = li + ch * G;
      has[r][ch] = row < n && j < k4;
      c[r][ch] = has[r][ch] ? __ldcs(reinterpret_cast<const int4*>(cols) + row * k4 + j)
                            : make_int4(-1, -1, -1, -1);
    }
  }

  const int b_end = min(batch, ((int)blockIdx.y + 1) * LANES_Y);
  for (int b = blockIdx.y * LANES_Y; b < b_end; ++b) {
    // the lane's offsets, once; then every load of its RPT rows (values,
    // diagonal, v[row]) before any is used
    const T* vb = v + (long long)b * nv;
    const T* valb = vals + (long long)b * n * k;
    const T* diagb = diag + (long long)b * n;
    float4 a[RPT][NCH];
    float dg[RPT], vr[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const long long row = row0 + (long long)r * groups;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        a[r][ch] = has[r][ch] ? stream4(valb + (row * k4 + li + ch * G) * 4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      const bool lead = li == 0 && row < n;
      dg[r] = lead ? to_float(__ldcs(diagb + row)) : 0.f;
      vr[r] = lead ? to_float(__ldg(vb + row)) : 0.f;
    }
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      acc[r] = 0.f;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        acc[r] += a[r][ch].x * gather(vb, c[r][ch].x, nv);
        acc[r] += a[r][ch].y * gather(vb, c[r][ch].y, nv);
        acc[r] += a[r][ch].z * gather(vb, c[r][ch].z, nv);
        acc[r] += a[r][ch].w * gather(vb, c[r][ch].w, nv);
      }
    }
    // groups are aligned powers of two: xor stays inside the group, and
    // every thread of the warp reaches the shuffles
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      for (int off = G >> 1; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const long long row = row0 + (long long)r * groups;
      if (li == 0 && row < n) y[(long long)b * n + row] = from_float<T>(dg[r] * vr[r] + acc[r]);
    }
  }
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

template <typename T, int NCH, int RPT>
void launch_vec(const void* cols, const void* vals, const void* diag, const void* v, void* y,
                int n, int k, int nv, int group_log2, int batch, cudaStream_t stream) {
  const long long rows_per_block = (long long)RPT * (BLOCK >> group_log2);
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block),
                  (unsigned)((batch + LANES_Y - 1) / LANES_Y));
  ell_spmv_vec_kernel<T, NCH, RPT><<<grid, BLOCK, 0, stream>>>(
      (const int*)cols, (const T*)vals, (const T*)diag, (const T*)v, (T*)y, n, k, nv,
      group_log2, batch);
}

// one lane at NCH = 1 (k <= 32): two rows per thread; otherwise one row per
// thread, so more threads walk the lanes of a batch.  On an H100 at the
// 96^3 and 48^3 shapes these timed best among 2, 4 and 8 rows per thread
// for one lane, and among loading 1, 2, 4 or 8 lanes at once for a batch.
template <typename T, int NCH>
void launch_vec(const void* cols, const void* vals, const void* diag, const void* v, void* y,
                int n, int k, int nv, int group_log2, int batch, cudaStream_t stream) {
  if (batch == 1 && NCH == 1)
    launch_vec<T, NCH, 2>(cols, vals, diag, v, y, n, k, nv, group_log2, batch, stream);
  else
    launch_vec<T, NCH, 1>(cols, vals, diag, v, y, n, k, nv, group_log2, batch, stream);
}

template <typename T>
int launch(const void* cols, const void* vals, const void* diag, const void* v, void* y,
           int n, int k, int nv, int group, int batch, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n <= 0 || batch <= 0) return (int)cudaGetLastError();
  const bool aligned = ((uintptr_t)cols % 16 == 0) && ((uintptr_t)vals % (4 * sizeof(T)) == 0);
  if (k % 4 == 0 && k <= 128 && aligned) {
    // G = the smallest power of two >= k/4, at most 8; NCH chunks per thread
    const int k4 = k / 4;
    int g_log2 = 0;
    while ((1 << g_log2) < k4 && g_log2 < 3) ++g_log2;
    const int nch = (k4 + (1 << g_log2) - 1) >> g_log2;
    if (nch == 1)
      launch_vec<T, 1>(cols, vals, diag, v, y, n, k, nv, g_log2, batch, stream);
    else if (nch == 2)
      launch_vec<T, 2>(cols, vals, diag, v, y, n, k, nv, g_log2, batch, stream);
    else
      launch_vec<T, 4>(cols, vals, diag, v, y, n, k, nv, g_log2, batch, stream);
    return (int)cudaGetLastError();
  }
  const long long threads = (long long)n * group;
  const dim3 grid((unsigned)((threads + BLOCK - 1) / BLOCK), (unsigned)batch);
  // one instance compiles without the lane offsets, which cost ~22% there
  if (batch == 1)
    ell_spmv_kernel<T, false><<<grid, BLOCK, 0, stream>>>(
        (const int*)cols, (const T*)vals, (const T*)diag, (const T*)v, (T*)y, n, k, nv, group);
  else
    ell_spmv_kernel<T, true><<<grid, BLOCK, 0, stream>>>(
        (const int*)cols, (const T*)vals, (const T*)diag, (const T*)v, (T*)y, n, k, nv, group);
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
