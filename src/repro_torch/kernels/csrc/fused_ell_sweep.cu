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
//
// Replaces the TPU kernel
// src/repro/kernels/edge_reweight.py::fused_ell_sweep_pallas.
//
// Bound: bytes.  Each row reads k column ids and, per lane, k weights, c_s,
// c_t, v[u], and writes k values plus diag, r_s, r_t: n * (4k + B(8k + 24))
// bytes, against about 8 flops and one reciprocal square root per slot.
// The gather v[cols] is served from L2 (v is 3.5 MB at n = 884,736).
//
// Two variants, chosen by the wrapper (ops._vector_group_log2), with the
// row mapping of ell_spmv.cu:
//
// * vector (k % 4 == 0, k <= 128, cols and c_ell on 16-byte boundaries;
//   every plan build_ell_plan makes): a group of G threads serves a row, G
//   the smallest power of two >= k/4 (at most 8), each thread 4 slots at a
//   time: one 16-byte load of cols (int4) and one of c_ell (float4), both
//   streamed past L1, and one 16-byte streaming store of vals.  A thread of
//   one lane serves two rows at k = 32.  Every load of its rows (c_ell, the
//   gathers v[cols], which wait on cols alone, v[u], and c_s[u], c_t[u] for
//   the group's first thread, which writes the row's r_s, r_t and diag) is
//   issued before any is used; v is read through the read-only path
//   (__ldg) and stays cached.  Batched, the group loads cols once and walks
//   the lanes (at most LANES_Y of them; the grid's y index takes the next
//   chunk), so cols is read once, not once per lane.  On an H100, loading
//   two or four lanes at once, or two or four rows per thread of a batch,
//   timed no faster at the 96^3 and 48^3 (B = 4) shapes.
// * scalar (any k): a group of G lanes per row (G the smallest power of two
//   >= k, at most 32), lane j on slots j, j + G, ...; the grid's y index is
//   the batch lane, and one instance (B = 1) runs the kernel compiled
//   without the lane offsets.
//
// Either way the group reduces its partial sums with shuffles; no shared
// memory and no atomics.  Each undirected edge is evaluated once per
// direction, as on the TPU: z^2 is symmetric, so both copies get the same r
// without a cross-row scatter.  v may be longer than n (halo-extended); a
// column id outside [0, nv) gathers 0, as the TPU kernel's fill_value=0 does.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;   // a multiple of 32, so groups never straddle a warp
constexpr int LANES_Y = 8;   // batch lanes one vector-variant thread walks

// v[c], or 0 for a column id outside [0, nv)
__device__ __forceinline__ float gather(const float* __restrict__ v, int c, int nv) {
  return (unsigned)c < (unsigned)nv ? __ldg(v + c) : 0.f;
}

// the slot's conductance, in the plain version's order of operations
__device__ __forceinline__ float slot_r(float c, float vr, float vc, float eps2) {
  const float z = c * (vr - vc);
  return (c * c) * rsqrtf(z * z + eps2);
}

// the row's terminal conductances, its diagonal, and the three stores
__device__ __forceinline__ void row_epilogue(float cs, float ct, float vr, float acc, float eps2,
                                             float* r_s, float* r_t, float* diag,
                                             long long row) {
  const float zs = cs * (1.f - vr);
  const float zt = ct * vr;
  const float rs = cs > 0.f ? (cs * cs) * rsqrtf(zs * zs + eps2) : 0.f;
  const float rt = ct > 0.f ? (ct * ct) * rsqrtf(zt * zt + eps2) : 0.f;
  r_s[row] = rs;
  r_t[row] = rt;
  diag[row] = acc + rs + rt;
}

// NCH 16-byte chunks per thread and row, RPT rows per thread
template <int NCH, int RPT>
__global__ void __launch_bounds__(BLOCK)
fused_ell_sweep_vec_kernel(const int* __restrict__ cols, const float* __restrict__ c_ell,
                           const float* __restrict__ c_s, const float* __restrict__ c_t,
                           const float* __restrict__ v, float eps2, float* __restrict__ vals,
                           float* __restrict__ diag, float* __restrict__ r_s,
                           float* __restrict__ r_t, int n, int k, int nv, int group_log2,
                           int batch) {
  const int G = 1 << group_log2;
  const int li = threadIdx.x & (G - 1);         // slot chunk of the group
  const int groups = BLOCK >> group_log2;       // row groups per block
  const long long row0 = (long long)blockIdx.x * RPT * groups + (threadIdx.x >> group_log2);
  const int k4 = k >> 2;

  // the rows' column ids, once for every lane
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
    // the lane's offsets, once; then every load of its RPT rows (weights,
    // the gathers v[cols], v[u], c_s[u], c_t[u]) before any is used
    const long long rb = (long long)b * n;      // the lane's first row
    const float4* cb = reinterpret_cast<const float4*>(c_ell) + rb * k4;
    const float* vb = v + (long long)b * nv;
    float4 w[RPT][NCH], vc[RPT][NCH];
    float vr[RPT], cs[RPT], ct[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const long long row = row0 + (long long)r * groups;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int4 cc = c[r][ch];
        w[r][ch] = has[r][ch] ? __ldcs(cb + row * k4 + li + ch * G)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        vc[r][ch] = make_float4(gather(vb, cc.x, nv), gather(vb, cc.y, nv),
                                gather(vb, cc.z, nv), gather(vb, cc.w, nv));
      }
      vr[r] = row < n ? __ldg(vb + row) : 0.f;
      const bool lead = li == 0 && row < n;
      cs[r] = lead ? __ldcs(c_s + rb + row) : 0.f;
      ct[r] = lead ? __ldcs(c_t + rb + row) : 0.f;
    }
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const long long row = row0 + (long long)r * groups;
      acc[r] = 0.f;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        if (!has[r][ch]) continue;
        const float4 c4 = w[r][ch];
        const float4 g4 = vc[r][ch];
        const float rx = slot_r(c4.x, vr[r], g4.x, eps2);
        const float ry = slot_r(c4.y, vr[r], g4.y, eps2);
        const float rz = slot_r(c4.z, vr[r], g4.z, eps2);
        const float rw = slot_r(c4.w, vr[r], g4.w, eps2);
        __stcs(reinterpret_cast<float4*>(vals) + (rb + row) * k4 + li + ch * G,
               make_float4(-rx, -ry, -rz, -rw));
        acc[r] += rx;
        acc[r] += ry;
        acc[r] += rz;
        acc[r] += rw;
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
      if (li == 0 && row < n)
        row_epilogue(cs[r], ct[r], vr[r], acc[r], eps2, r_s, r_t, diag, rb + row);
    }
  }
}

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
      const float r = slot_r(c, vr, gather(vb, cols[cbase + j], nv), eps2);
      vals[base + j] = -r;
      acc += r;
    }
  }
  // every lane of the warp reaches the shuffles: rows past n add 0
  for (int off = group >> 1; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, group);
  if (prow < n && lane == 0) row_epilogue(c_s[row], c_t[row], vr, acc, eps2, r_s, r_t, diag, row);
}

template <int NCH, int RPT>
void launch_vec(const void* cols, const void* c_ell, const void* c_s, const void* c_t,
                const void* v, float eps2, void* vals, void* diag, void* r_s, void* r_t, int n,
                int k, int nv, int group_log2, int batch, cudaStream_t stream) {
  const long long rows_per_block = (long long)RPT * (BLOCK >> group_log2);
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block),
                  (unsigned)((batch + LANES_Y - 1) / LANES_Y));
  fused_ell_sweep_vec_kernel<NCH, RPT><<<grid, BLOCK, 0, stream>>>(
      (const int*)cols, (const float*)c_ell, (const float*)c_s, (const float*)c_t,
      (const float*)v, eps2, (float*)vals, (float*)diag, (float*)r_s, (float*)r_t, n, k, nv,
      group_log2, batch);
}

}  // namespace

// vec_log2 >= 0: the vector variant with G = 2^vec_log2 threads per row
// (the wrapper checked k and the alignment); otherwise the scalar variant
// with the smallest power of two >= k lanes per row, at most a warp.
extern "C" int fused_ell_sweep_f32(const void* cols, const void* c_ell, const void* c_s,
                                   const void* c_t, const void* v, float eps2, void* vals,
                                   void* diag, void* r_s, void* r_t, int n, int k, int nv,
                                   int vec_log2, int batch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || batch <= 0) return (int)cudaGetLastError();
  if (vec_log2 >= 0) {
    const int k4 = k / 4;
    if (k % 4 != 0 || k > 128 || vec_log2 > 3) return (int)cudaErrorInvalidValue;
    const int nch = (k4 + (1 << vec_log2) - 1) >> vec_log2;
    // one lane at one chunk per thread (k <= 32): two rows per thread;
    // otherwise one, so more threads walk the lanes of a batch
    if (nch == 1 && batch == 1)
      launch_vec<1, 2>(cols, c_ell, c_s, c_t, v, eps2, vals, diag, r_s, r_t, n, k, nv,
                       vec_log2, batch, s);
    else if (nch == 1)
      launch_vec<1, 1>(cols, c_ell, c_s, c_t, v, eps2, vals, diag, r_s, r_t, n, k, nv,
                       vec_log2, batch, s);
    else if (nch == 2)
      launch_vec<2, 1>(cols, c_ell, c_s, c_t, v, eps2, vals, diag, r_s, r_t, n, k, nv,
                       vec_log2, batch, s);
    else
      launch_vec<4, 1>(cols, c_ell, c_s, c_t, v, eps2, vals, diag, r_s, r_t, n, k, nv,
                       vec_log2, batch, s);
    return (int)cudaGetLastError();
  }
  int group = 1;
  while (group < k && group < 32) group *= 2;
  const int block = 256;
  const long long threads = (long long)n * group;
  const dim3 grid((unsigned)((threads + block - 1) / block), (unsigned)batch);
  if (batch == 1)
    fused_ell_sweep_kernel<false><<<grid, block, 0, s>>>(
        (const int*)cols, (const float*)c_ell, (const float*)c_s, (const float*)c_t,
        (const float*)v, eps2, (float*)vals, (float*)diag, (float*)r_s, (float*)r_t, n, k, nv,
        group);
  else
    fused_ell_sweep_kernel<true><<<grid, block, 0, s>>>(
        (const int*)cols, (const float*)c_ell, (const float*)c_s, (const float*)c_t,
        (const float*)v, eps2, (float*)vals, (float*)diag, (float*)r_s, (float*)r_t, n, k, nv,
        group);
  return (int)cudaGetLastError();
}
