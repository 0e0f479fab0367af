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
// over A, and every percent it loses is bytes not in flight or an SM idle.
// The TPU pads bs to a multiple of 128 for its matrix unit; that tiling is
// not carried over.
//
// Two variants, chosen by the wrapper (ops._bdm_plan):
//
// * vector (bs % 4 == 0, bs <= 512, A and x on 16-byte boundaries): the
//   rows of all blocks are cut into units of `unit_rows` consecutive rows
//   of one p (a group of G lanes per row, G the smallest power of two
//   >= bs/4, at most 32, so a warp serves 32/G rows a step, RPT steps a
//   unit: 2 rows, 4 KB, at bs = 512).  Each thread block of WARPS warps
//   takes one contiguous range of units (two per warp, ops'
//   _BDM_UNITS_PER_WARP, so the grid holds many short blocks), and its
//   warps take every WARPS-th unit of it, so a block's warps stream
//   neighbouring rows.  A lane keeps its
//   slice of x[p] in registers (NCH float4s, read again only when p
//   changes, through the read-only path: x is 3.5 MB and lives in L2) and,
//   per unit, issues every 16-byte load of its rows (NCH * RPT float4s,
//   128 bytes) before it uses any; A is read once, so its loads bypass L1
//   (ld.global.nc.L1::no_allocate) and ask L2 for 256-byte sectors.  Each
//   row ends in a shuffle reduction over its G lanes.  No shared memory, no
//   atomics, no __syncthreads.  On an H100 at bs = 512 a persistent grid
//   of one wave (132 SMs x 2 blocks, each streaming its share to the end)
//   timed slower than these short blocks, whose order the hardware's block
//   scheduler balances as SMs finish, and the more so the fewer blocks it
//   had; 4-row units (256 bytes in flight per lane) were no faster than
//   2-row units, nor were 4 or 16 warps a block, a mask-free copy of the
//   kernel for bs = 128 * NCH, software prefetch of the next unit into L2,
//   L2 eviction policies, or one contiguous range per warp.
// * scalar (any other bs up to the wrapper's limit): one block of 256
//   threads per p stages x[p] in shared memory; each warp takes rows i,
//   i + 8, ..., reads row i with lanes on adjacent addresses and reduces
//   with shuffles.
//
// Either way every y[p, i] is one float32 dot product of length bs with one
// writer.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                 // warps per block (vector variant)
constexpr int BLOCK = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;            // blocks an SM's registers must hold
constexpr int IN_FLIGHT = 8;             // float4 loads of A in flight per thread
constexpr int SCALAR_BLOCK = 256;

// four floats read once: not kept in L1, 256-byte L2 sectors
__device__ __forceinline__ float4 stream4(const float4* p) {
  float4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p));
  return r;
}

template <int NCH>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
block_diag_matvec_vec_kernel(const float* __restrict__ A, const float* __restrict__ x,
                             float* __restrict__ y, int bs, int g_log2, int units_per_p,
                             long long units) {
  constexpr int RPT = IN_FLIGHT / NCH;   // steps of rows per unit
  const int G = 1 << g_log2;
  const int lane = threadIdx.x & 31;
  const int li = lane & (G - 1);         // the lane's place in its row's group
  const int step_rows = 32 >> g_log2;    // rows a warp serves per step
  const int unit_rows = step_rows * RPT;
  const int k4 = bs >> 2;
  // the block's units [u_begin, u_end); its warp takes every WARPS-th,
  // starting at its own index, and tracks (p, unit within p) as it goes
  const long long u_begin = blockIdx.x * units / gridDim.x;
  const long long u_end = (blockIdx.x + 1) * units / gridDim.x;
  long long u = u_begin + (threadIdx.x >> 5);
  if (u >= u_end) return;                // the whole warp
  long long p = u / units_per_p;
  int up = (int)(u - p * units_per_p);
  long long p_held = -1;
  float4 xr[NCH];
  for (; u < u_end; u += WARPS) {
    const int row0 = up * unit_rows + (lane >> g_log2);
    const float4* Ap = reinterpret_cast<const float4*>(A) + p * bs * (long long)k4;
    // every load of the unit first
    float4 a[RPT][NCH];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r * step_rows;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int j = li + ch * G;
        a[r][ch] = row < bs && j < k4 ? stream4(Ap + (long long)row * k4 + j)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (p != p_held) {   // the same for the whole warp
      p_held = p;
      const float4* xp = reinterpret_cast<const float4*>(x) + p * k4;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int j = li + ch * G;
        xr[ch] = j < k4 ? __ldg(xp + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      acc[r] = 0.f;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        acc[r] += a[r][ch].x * xr[ch].x;
        acc[r] += a[r][ch].y * xr[ch].y;
        acc[r] += a[r][ch].z * xr[ch].z;
        acc[r] += a[r][ch].w * xr[ch].w;
      }
    }
    // groups are aligned powers of two: xor stays inside the group, and
    // every lane of the warp reaches the shuffles
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      for (int off = G >> 1; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r * step_rows;
      if (li == 0 && row < bs) y[p * bs + row] = acc[r];
    }
    for (up += WARPS; up >= units_per_p; up -= units_per_p) ++p;
  }
}

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

// g_log2 < 0: the scalar variant (grid = p).  Otherwise the vector variant
// with G = 2^g_log2 lanes per row and nch float4s of a row per lane, on
// `grid` blocks over units of (32 / G) * (IN_FLIGHT / nch) rows; lanes
// that cannot hold a row are refused.
extern "C" int block_diag_matvec_f32(const void* A, const void* x, void* y, int p, int bs,
                                     int g_log2, int nch, int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p <= 0 || bs <= 0) return (int)cudaGetLastError();
  if (g_log2 < 0) {
    block_diag_matvec_kernel<<<p, SCALAR_BLOCK, bs * sizeof(float), s>>>(
        (const float*)A, (const float*)x, (float*)y, bs);
    return (int)cudaGetLastError();
  }
  if (g_log2 > 5 || (nch != 1 && nch != 2 && nch != 4) || bs % 4 != 0 ||
      (bs / 4 + (1 << g_log2) - 1) >> g_log2 > nch || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const int unit_rows = (32 >> g_log2) * (IN_FLIGHT / nch);
  const int units_per_p = (bs + unit_rows - 1) / unit_rows;
  const long long units = (long long)p * units_per_p;
  const float* a = (const float*)A;
  const float* xx = (const float*)x;
  float* yy = (float*)y;
  if (nch == 1)
    block_diag_matvec_vec_kernel<1><<<grid, BLOCK, 0, s>>>(a, xx, yy, bs, g_log2, units_per_p, units);
  else if (nch == 2)
    block_diag_matvec_vec_kernel<2><<<grid, BLOCK, 0, s>>>(a, xx, yy, bs, g_log2, units_per_p, units);
  else
    block_diag_matvec_vec_kernel<4><<<grid, BLOCK, 0, s>>>(a, xx, yy, bs, g_log2, units_per_p, units);
  return (int)cudaGetLastError();
}
