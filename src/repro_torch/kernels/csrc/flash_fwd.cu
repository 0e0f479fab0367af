// Flash-attention forward with grouped-query heads and online softmax:
//
//     out[bh, i] = sum_j p_ij v[bh / G, j] / l_i,   lse[bh, i] = m_i + log(l_i)
//     s_ij = scale * q[bh, i] . k[bh / G, j],  masked to -1e30 where j > i (causal)
//     m_i = max_j s_ij,  p_ij = exp(s_ij - m_i),  l_i = max(sum_j p_ij, 1e-30)
//
// q [BH, Sq, D], k and v [BKV, Sk, D] with BH = BKV * G, bfloat16 or float32;
// out [BH, Sq, D] in q's dtype, lse [BH, Sq] float32.  D is 64 or 128.  Any Sq
// and Sk: rows and keys past the end of a tile are masked.  Causal masking
// aligns position 0 of q with position 0 of k, as the TPU kernel does.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_fwd_pallas.
//
// Bound: operations.  Prefill at 4 x 4096 tokens, 48 query heads, D = 128,
// causal, is 4 * BH * D * S(S+1)/2 = 206 GFLOP against 118 MB of q, k, v, out
// and lse: 0.21 ms at the bf16 tensor-core rate, 0.035 ms at the memory rate.
//
// Design: one block of 4 warps per (bh, 64-row q tile); each warp owns 16
// rows.  The block walks the key tiles of head bh / G (64 keys each; a causal
// block stops at its diagonal tile), staging K and V in shared memory.  The
// running max m, sum l and accumulator acc of each row stay in registers in
// float32; each tile rescales acc by exp(m_old - m_new).  For bfloat16 both
// products run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
// accumulate): the S fragment of q.k^T is laid out as the A operand of p.v,
// so p never leaves registers (it is rounded to bf16 for that product); V's
// fragments come from row-major shared memory through ldmatrix.trans.  For
// float32 both products are float32 FMAs on the CUDA cores in the same
// fragment layout (p goes through shared memory), as exact as the TPU
// kernel's float32 dots.  Blocks of the last q tiles, which do the most work
// under causal masking, are launched first.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> struct Pad;
template <> struct Pad<__nv_bfloat16> { static constexpr int v = 8; };  // 16 bytes
template <> struct Pad<float> { static constexpr int v = 4; };          // 16 bytes

template <typename T, int D>
struct Smem {
  static constexpr int RS = D + Pad<T>::v;   // row stride of the q, k, v tiles
  static constexpr int PS = BK + 4;          // row stride of p (float32 path)
  static constexpr size_t q_elems = (size_t)BQ * RS;
  static constexpr size_t kv_elems = (size_t)BK * RS;
  static constexpr size_t p_floats = sizeof(T) == 4 ? (size_t)WARPS * 16 * PS : 0;
  static constexpr size_t bytes = (q_elems + 2 * kv_elems) * sizeof(T) + p_floats * 4;
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: thread i gives the row address of
// matrix i / 8, row i % 8, and receives {M[2(i%4)][i/4], M[2(i%4)+1][i/4]}
// of each matrix: the B fragments of v (rows = keys) for mma m16n8k16
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// rows [row0, row0 + nrows) of a [rows, D] matrix into a shared tile of
// stride RS, 16 bytes per thread and step; rows past `limit` read as 0
template <typename T, int D>
__device__ __forceinline__ void stage(T* tile, const T* src, int row0, int nrows, int limit) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int RS = Smem<T, D>::RS;
  for (int i = threadIdx.x; i < nrows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(tile + r * RS + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int n_bh, int sq, int sk,
                 int group, int causal, float scale) {
  using S = Smem<T, D>;
  constexpr int RS = S::RS;
  constexpr int NT = BK / 8;   // 8-key column tiles of s
  constexpr int ND = D / 8;    // 8-wide column tiles of acc
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + S::q_elems;
  T* vs = ks + S::kv_elems;

  const int nq = (sq + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)(blockIdx.x / n_bh);   // the heaviest q tiles first
  const int bh = (int)(blockIdx.x % n_bh);
  const int q0 = iq * BQ;
  const T* qh = q + (long long)bh * sq * D;
  const T* kh = k + (long long)(bh / group) * sk * D;
  const T* vh = v + (long long)(bh / group) * sk * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;   // fragment row group and column pair
  const int r0 = warp * 16;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;   // this lane's two rows

  stage<T, D>(qs, qh, q0, BQ, sq);
  __syncthreads();

  // q fragments (A operand, 16 rows x 16 of D per step), bf16 path only
  constexpr int QF = sizeof(T) == 2 ? D / 16 : 1;
  uint32_t qa[QF][4];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int st = 0; st < D / 16; ++st) {
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(qs) +
                               (r0 + g) * RS + st * 16 + t * 2;
      qa[st][0] = ld32(b);
      qa[st][1] = ld32(b + 8 * RS);
      qa[st][2] = ld32(b + 8);
      qa[st][3] = ld32(b + 8 * RS + 8);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = MASKED, m_b = MASKED, l_a = 0.f, l_b = 0.f;   // l: this lane's part

  const int k_end = causal ? min(sk, q0 + BQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // every warp is done with the previous tile
    stage<T, D>(ks, kh, k0, BK, sk);
    stage<T, D>(vs, vh, k0, BK, sk);
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's 64 keys; lane holds
    // s[j][0..1] at (row_a, key k0 + 8j + 2t + {0,1}) and s[j][2..3] at row_b
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(ks);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int st = 0; st < D / 16; ++st) {
          const __nv_bfloat16* b = kb + (j * 8 + g) * RS + st * 16 + t * 2;
          mma_bf16(s[j], qa[st], ld32(b), ld32(b + 8));
        }
      }
    } else {
      const float* qf = reinterpret_cast<const float*>(qs);
      const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qa_ = qf[(r0 + g) * RS + d], qb_ = qf[(r0 + g + 8) * RS + d];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float k0v = kf[(j * 8 + 2 * t) * RS + d];
          const float k1v = kf[(j * 8 + 2 * t + 1) * RS + d];
          s[j][0] = fmaf(qa_, k0v, s[j][0]);
          s[j][1] = fmaf(qa_, k1v, s[j][1]);
          s[j][2] = fmaf(qb_, k0v, s[j][2]);
          s[j][3] = fmaf(qb_, k1v, s[j][3]);
        }
      }
    }

    // scale, mask (keys past sk; under causal, keys after the row)
    const bool edge = (k0 + BK > sk) || (causal && k0 + BK - 1 > q0 + r0);
    float mx_a = MASKED, mx_b = MASKED;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (key >= sk || (causal && key > row)) x = MASKED;
        }
        s[j][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    // a row's 64 entries lie on the 4 lanes of a quad
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float c_a = exp2f((m_a - mn_a) * LOG2E), c_b = exp2f((m_b - mn_b) * LOG2E);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f((s[j][0] - mn_a) * LOG2E);
      s[j][1] = exp2f((s[j][1] - mn_a) * LOG2E);
      s[j][2] = exp2f((s[j][2] - mn_b) * LOG2E);
      s[j][3] = exp2f((s[j][3] - mn_b) * LOG2E);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * c_a + sum_a;
    l_b = l_b * c_b + sum_b;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= c_a;
      acc[n][1] *= c_a;
      acc[n][2] *= c_b;
      acc[n][3] *= c_b;
    }

    // acc += p v
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(vs);
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
        // matrices: keys 16kc + {0..7, 8..15} at columns 8n, then at 8(n+1)
        const __nv_bfloat16* base =
            vb + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, base + n * 8);
          mma_bf16(acc[n], pa, b[0], b[1]);
          mma_bf16(acc[n + 1], pa, b[2], b[3]);
        }
      }
    } else {
      float* ps = reinterpret_cast<float*>(vs + S::kv_elems) + warp * 16 * S::PS;
      const float* vf = reinterpret_cast<const float*>(vs);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        ps[g * S::PS + j * 8 + 2 * t] = s[j][0];
        ps[g * S::PS + j * 8 + 2 * t + 1] = s[j][1];
        ps[(g + 8) * S::PS + j * 8 + 2 * t] = s[j][2];
        ps[(g + 8) * S::PS + j * 8 + 2 * t + 1] = s[j][3];
      }
      __syncwarp();
#pragma unroll 2
      for (int key = 0; key < BK; ++key) {
        const float pa_ = ps[g * S::PS + key], pb_ = ps[(g + 8) * S::PS + key];
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const float v0 = vf[key * RS + n * 8 + 2 * t];
          const float v1 = vf[key * RS + n * 8 + 2 * t + 1];
          acc[n][0] = fmaf(pa_, v0, acc[n][0]);
          acc[n][1] = fmaf(pa_, v1, acc[n][1]);
          acc[n][2] = fmaf(pb_, v0, acc[n][2]);
          acc[n][3] = fmaf(pb_, v1, acc[n][3]);
        }
      }
      __syncwarp();   // p is rewritten by the next tile
    }
  }

  // the full row sums, then out = acc / max(l, 1e-30) and lse = m + log(l)
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  T* oh = out + (long long)bh * sq * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if constexpr (sizeof(T) == 2) {
      if (row_a < sq)
        *reinterpret_cast<uint32_t*>(oh + (long long)row_a * D + col) =
            pack_bf16(acc[n][0] / l_a, acc[n][1] / l_a);
      if (row_b < sq)
        *reinterpret_cast<uint32_t*>(oh + (long long)row_b * D + col) =
            pack_bf16(acc[n][2] / l_b, acc[n][3] / l_b);
    } else {
      if (row_a < sq)
        *reinterpret_cast<float2*>(oh + (long long)row_a * D + col) =
            make_float2(acc[n][0] / l_a, acc[n][1] / l_a);
      if (row_b < sq)
        *reinterpret_cast<float2*>(oh + (long long)row_b * D + col) =
            make_float2(acc[n][2] / l_b, acc[n][3] / l_b);
    }
  }
  if (t == 0) {
    if (row_a < sq) lse[(long long)bh * sq + row_a] = m_a + logf(l_a);
    if (row_b < sq) lse[(long long)bh * sq + row_b] = m_b + logf(l_b);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int n_bh,
           int sq, int sk, int group, int causal, float scale, void* stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = Smem<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n_bh > 0 && sq > 0) {
    const long long blocks = (long long)n_bh * ((sq + BQ - 1) / BQ);
    kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, n_bh, sq, sk, group,
        causal, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, void* lse, int n_bh,
             int sq, int sk, int d, int group, int causal, float scale, void* stream) {
  if (d == 64)
    return launch<T, 64>(q, k, v, out, lse, n_bh, sq, sk, group, causal, scale, stream);
  if (d == 128)
    return launch<T, 128>(q, k, v, out, lse, n_bh, sq, sk, group, causal, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                              int n_bh, int sq, int sk, int d, int group, int causal,
                              float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, lse, n_bh, sq, sk, d, group, causal, scale,
                                 stream);
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                             int n_bh, int sq, int sk, int d, int group, int causal,
                             float scale, void* stream) {
  return dispatch<float>(q, k, v, out, lse, n_bh, sq, sk, d, group, causal, scale, stream);
}
