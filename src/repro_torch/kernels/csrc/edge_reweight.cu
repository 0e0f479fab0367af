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
// weight and writes its r: 8m + 8Bm bytes, plus the B voltage vectors, against
// ~7 flops, a square root and a division per edge and lane.  The gathers
// v[src], v[dst] are served from L2 (v is 3.5 MB a lane at n = 884,736).
//
// Design: a grid-stride loop with one thread per edge.  The thread loads
// src[e] and dst[e] once and loops over the B lanes, so a batch reads the
// indices once and not once per lane.  Neighbouring threads take
// neighbouring edges, so the loads of c and the stores of r are coalesced
// in every lane.  No shared memory and no atomics: every r[b, e] has one
// writer.  Every operation is rounded once, in the plain version's order,
// with a correctly rounded square root and division (not the TPU kernel's
// rsqrt): the kernel's r equals the plain version's bit for bit, so a solve
// through the kernel and one on the plain path differ only where the rest of
// the path sums in another order.  The TPU kernel's padding of m to EDGES_PER_BLOCK is TPU tiling and
// is not carried over.  An index outside [0, nv) gathers 0, as the TPU
// kernel's fill_value=0 does.
#include <cuda_runtime.h>

namespace {

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
      const float ce = c[i];
      // each operation rounded once and in the plain version's order
      // (c (vs - vd), z z + eps2, a correctly rounded square root, c c
      // over it): the kernel's r is the plain version's, bit for bit
      const float z = __fmul_rn(ce, __fsub_rn(vs, vd));
      r[i] = __fdiv_rn(__fmul_rn(ce, ce), __fsqrt_rn(__fadd_rn(__fmul_rn(z, z), eps2)));
    }
  }
}

}  // namespace

extern "C" int edge_reweight_f32(const void* src, const void* dst, const void* c, const void* v,
                                 float eps2, void* r, long long m, int nv, int batch,
                                 void* stream) {
  if (m > 0 && batch > 0) {
    const int block = 256;
    // enough blocks to fill the card many times over; the grid-stride loop
    // covers the rest
    const long long want = (m + block - 1) / block;
    const unsigned grid = (unsigned)(want < 132 * 64 ? want : 132 * 64);
    edge_reweight_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int*)src, (const int*)dst, (const float*)c, (const float*)v, eps2, (float*)r, m,
        nv, batch);
  }
  return (int)cudaGetLastError();
}
