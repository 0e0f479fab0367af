// COO edge reweight (paper eq. 4 on the non-terminal edges), per edge e and
// lane b of a batch of B same-topology weight vectors:
//
//     z = c[b, e] (v[b, src[e]] - v[b, dst[e]]);   r[b, e] = c[b, e]^2 / sqrt(z^2 + eps^2)
//
// c, r: float[B, m]; v: float[B, nv]; src, dst: int32[m], shared by the lanes.
//
// Replaces the TPU kernel src/repro/kernels/edge_reweight.py::edge_reweight_pallas.
//
// Bound: bytes.  Each edge reads its two indices once, and per lane its
// weight and writes its r; the B voltage vectors are read once: 8m + 8Bm +
// 4B nv bytes, against ~7 flops, a square root and a division per edge and
// lane.  The gathers v[src], v[dst] are served from L2: the lanes' v is 28 MB
// at the 96^3 volume with B = 8 and 34 MB at a 1024^2 frame, inside the 50 MB
// L2, and neighbouring edges of a grid graph touch neighbouring nodes.
//
// Two variants, chosen by the wrapper (ops._er_plan) by shape alone:
//
// * vector (m % 4 == 0 and src, dst, c and r on 16-byte boundaries, so every
//   lane's row of c and r is too): each thread takes EDGES = 4 consecutive
//   edges, one work item of a one-shot grid, and reads their src and dst
//   with one 16-byte load each, once for all B lanes.  It walks the lanes one
//   at a time: it asks L2 for the next lane's 16 bytes of c (prefetch), then
//   starts this lane's 16-byte load of c and its 8 gathers of v before it
//   uses any, and writes the lane's 4 results with one 16-byte store.  The
//   first design had one edge per thread and 8 bytes of c in flight at a
//   time, too little to cover device memory's latency (the card needs ~2 MB
//   in flight, ~15 KB an SM); here every thread has 16 bytes loading and 16
//   prefetching, at 5 blocks of 256 threads an SM (the register cap that
//   MIN_BLOCKS sets: 48 registers, no spill).  src, dst, c and r are touched
//   once: their loads and stores are marked evict-first (__ldcs, __stcs), so
//   the lanes' v, gathered through the read-only path (__ldg), stays in L2.
//   Neighbouring threads take neighbouring 16-byte groups, so every lane's
//   loads and stores are coalesced.
// * scalar (any other m or alignment): the first design, one edge per
//   thread in a grid-stride loop, src[e] and dst[e] loaded once and the B
//   lanes walked one at a time.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W by kernel_times.py
// --kernels edge_reweight (device time in a CUDA graph; volume 96^3 B = 8 /
// B = 1 / 1024^2 frame B = 8; bounds 0.2503 / 0.0548 / 0.0550 ms): this
// design 0.2969 / 0.0638 / 0.0689 ms (0.84 / 0.86 / 0.80 of the bounds), the
// first design 0.5088 / 0.1086 / 0.1022 ms in the same run.  Variants
// timed while the design was chosen, at B = 8, were all slower than this
// one: chunks of 2 or 4 lanes loaded together (more registers, fewer
// threads an SM), persistent grids of 4, 8 or 16 blocks an SM, one lane at
// a time without the prefetch, and the prefetch without MIN_BLOCKS.  SASS
// (chip_smoke.py's sass_loops): the lane loop, unrolled over two lanes,
// holds 410 instructions, 51 an edge and lane, of which the untaken calls
// into the square root's and the division's slow paths take ~7; ~44 an
// edge and lane for the 90M edge-lanes at B = 8 take ~0.12 ms to dispatch
// on the card's 528 schedulers, half the byte bound, under the loads.
//
// Either way no shared memory and no atomics: every r[b, e] has one writer.
// Every operation is rounded once, in the plain version's order, with a
// correctly rounded square root and division (__f*_rn: no contraction into
// an FMA, not the TPU kernel's rsqrt): the kernel's r equals the plain
// version's bit for bit, so a solve through the kernel and one on the plain
// path differ only where the rest of the path sums in another order.  An
// index outside [0, nv) gathers 0, as the TPU kernel's fill_value=0 does;
// the TPU kernel's padding of m to EDGES_PER_BLOCK is TPU tiling and is not
// carried over.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;       // threads per block (both variants)
constexpr int EDGES = 4;         // edges per thread of the vector variant: one int4 of src, of dst
constexpr int MIN_BLOCKS = 5;    // blocks an SM's registers must hold (vector variant)

// r = c^2 / sqrt((c (vs - vd))^2 + eps2), each operation rounded once and in
// the plain version's order: the plain version's r, bit for bit
__device__ __forceinline__ float reweight(float ce, float vs, float vd, float eps2) {
  const float z = __fmul_rn(ce, __fsub_rn(vs, vd));
  return __fdiv_rn(__fmul_rn(ce, ce), __fsqrt_rn(__fadd_rn(__fmul_rn(z, z), eps2)));
}

// v[i], or 0 for an index outside [0, nv)
__device__ __forceinline__ float gather(const float* __restrict__ vb, int i, int nv) {
  return (unsigned)i < (unsigned)nv ? __ldg(vb + i) : 0.f;
}

// asks L2 for the line holding p, ahead of its load
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
edge_reweight_vec_kernel(const int4* __restrict__ src, const int4* __restrict__ dst,
                         const float4* __restrict__ c, const float* __restrict__ v, float eps2,
                         float4* __restrict__ r, long long m4, int nv, int batch) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < m4; q += stride) {
    const int4 s = __ldcs(src + q);
    const int4 d = __ldcs(dst + q);
    for (int b = 0; b < batch; ++b) {
      // the next lane's weights travel to L2 while this lane's are used
      if (b + 1 < batch) prefetch_l2(c + (long long)(b + 1) * m4 + q);
      const float* vb = v + (long long)b * nv;
      // the lane's row of v in a register: each gather is then one address
      // computation, where the compiler would add b * nv to every index in
      // 64-bit arithmetic and spill at MIN_BLOCKS
      asm("" : "+l"(vb));
      // every load of the lane first
      const float4 cc = __ldcs(c + (long long)b * m4 + q);
      const float vs0 = gather(vb, s.x, nv), vs1 = gather(vb, s.y, nv);
      const float vs2 = gather(vb, s.z, nv), vs3 = gather(vb, s.w, nv);
      const float vd0 = gather(vb, d.x, nv), vd1 = gather(vb, d.y, nv);
      const float vd2 = gather(vb, d.z, nv), vd3 = gather(vb, d.w, nv);
      float4 o;
      o.x = reweight(cc.x, vs0, vd0, eps2);
      o.y = reweight(cc.y, vs1, vd1, eps2);
      o.z = reweight(cc.z, vs2, vd2, eps2);
      o.w = reweight(cc.w, vs3, vd3, eps2);
      __stcs(r + (long long)b * m4 + q, o);
    }
  }
}

__global__ void edge_reweight_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                                     const float* __restrict__ c, const float* __restrict__ v,
                                     float eps2, float* __restrict__ r, long long m, int nv,
                                     int batch) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < m; e += stride) {
    const unsigned s = (unsigned)src[e];
    const unsigned d = (unsigned)dst[e];
    const bool s_in = s < (unsigned)nv;
    const bool d_in = d < (unsigned)nv;
    for (int b = 0; b < batch; ++b) {
      const float* vb = v + (long long)b * nv;
      const float vs = s_in ? vb[s] : 0.f;
      const float vd = d_in ? vb[d] : 0.f;
      const long long i = (long long)b * m + e;
      r[i] = reweight(c[i], vs, vd, eps2);
    }
  }
}

}  // namespace

// edges = EDGES: the vector variant (m % EDGES == 0 and src, dst, c and r on
// 16-byte boundaries, which the wrapper checks), a thread per EDGES edges;
// edges = 1: the scalar variant.  `grid` blocks of BLOCK threads, in a
// grid-stride loop over the threads' work.
extern "C" int edge_reweight_f32(const void* src, const void* dst, const void* c, const void* v,
                                 float eps2, void* r, long long m, int nv, int batch, int edges,
                                 int grid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 0 || batch <= 0) return (int)cudaGetLastError();
  if (grid <= 0 || !(edges == 1 || (edges == EDGES && m % EDGES == 0)))
    return (int)cudaErrorInvalidValue;
  if (edges == 1)
    edge_reweight_kernel<<<grid, BLOCK, 0, st>>>((const int*)src, (const int*)dst,
                                                 (const float*)c, (const float*)v, eps2,
                                                 (float*)r, m, nv, batch);
  else
    edge_reweight_vec_kernel<<<grid, BLOCK, 0, st>>>(
        (const int4*)src, (const int4*)dst, (const float4*)c, (const float*)v, eps2,
        (float4*)r, m / EDGES, nv, batch);
  return (int)cudaGetLastError();
}
