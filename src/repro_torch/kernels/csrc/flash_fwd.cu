// Flash-attention forward with grouped-query heads and online softmax:
//
//     out[b, h, i] = sum_j p_ij v[b, h / G, j] / l_i,   lse[b*H + h, i] = m_i + log(l_i)
//     s_ij = scale * q[b, h, i] . k[b, h / G, j],  masked to -1e30 where j > i (causal)
//     m_i = max_j s_ij,  p_ij = exp(s_ij - m_i),  l_i = max(sum_j p_ij, 1e-30)
//
// q, k, v and out are addressed through element strides (batch, head, row;
// the head dim is contiguous), so the kernel reads the model's own
// [B, S, H, D] tensors in place, and the wrapper's [B*H, S, D] layout is the
// case of B*H/G batches of G heads.  bfloat16 or float32; out in q's dtype,
// lse [B*H, Sq] float32.  D is 64 or 128.  Any Sq and Sk: keys past Sk are
// masked, rows past Sq are never stored.  Causal masking aligns position 0 of
// q with position 0 of k, as the TPU kernel does.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_fwd_pallas.
//
// Bound: operations.  Prefill at 4 x 4096 tokens, 48 query heads, D = 128,
// causal, is 4 * BH * D * S(S+1)/2 = 206 GFLOP against 118 MB of q, k, v, out
// and lse: 0.21 ms at the bf16 tensor-core rate, 0.035 ms at the memory rate.
//
// bfloat16 design (Hopper: TMA, mbarriers, wgmma, warp specialisation).
// Persistent blocks of three warpgroups, one per SM, walk the work tiles
// (b, h, 128-row q tile) heaviest first: the last q tiles do the most work
// under causal masking.
// * Warpgroup 2 is the producer: it gives up registers (setmaxnreg) and one
//   of its threads issues TMA loads: each work tile's q once, then its K and
//   V tiles of 128 keys through a ring of 2 stages in shared memory (q has a
//   full and an empty barrier too, so the next work tile's loads overlap
//   this one's last products), K and V each
//   guarded by a "full" barrier the loads complete and an "empty" one the
//   consumers release (K once S = QK^T is done, V after O += PV).  TMA's
//   tensor maps carry the strides (built on the host for each call) and fill
//   rows and keys past the tensor's end with zeros.  All tiles use the
//   128-byte swizzle: a row of D = 128 bf16 is two 64-column boxes.
// * Warpgroups 0 and 1 are consumers, 64 q rows each.  Per key tile:
//   S = Q K^T as wgmma m64n128k16 with both operands in shared memory
//   (K as stored is K-major for that product); the online softmax in float32
//   registers (m, l and O stay there), in base 2 on the special-function
//   unit, with the mask applied only on the tiles that need it; P is rounded
//   to bf16 once and taken straight from the S accumulator fragment as the
//   register A operand of O += P V, wgmma with V from shared memory and the
//   transpose bit set (V is MN-major for that product).  The two consumers
//   run independently, so one's softmax overlaps the other's products.  A
//   causal block stops at its diagonal tile.  The scale must be positive
//   (the row max is taken before scaling).
//
// float32 design (CUDA cores; wgmma's only 32-bit input is TF32, which would
// not hold float32 results): one block of 4 warps per (b, h, 64-row q tile);
// each warp owns 16 rows and walks the key tiles of 64 keys, staged in shared
// memory by every thread.  Both products are float32 FMAs in the mma.sync
// fragment layout (p goes through shared memory).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// element strides of one [batch, head, row, D] operand
struct Strides {
  long long b, h, s;
};

struct Args {
  Strides q, k, v, o;
  float* lse;
  int nb, nh, group, sq, sk, causal;
  float scale;
  int perm_q, perm_kv;   // bf16: where (head, row, batch) sit among the tensor map's dims 1-3
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// ============================ bfloat16: TMA + wgmma ============================

namespace tc {

constexpr int BQ = 128;        // q rows per block: two consumer warpgroups of 64
constexpr int BK = 128;        // keys per tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;   // warpgroups 0, 1: consumers; 2: producer

template <int D>
struct Smem {
  static constexpr uint32_t BOX = 128;   // bytes per row of a 64-column box
  static constexpr uint32_t Q = BQ * D * 2, KV = BK * D * 2;
  static constexpr uint32_t BARS = Q + 2 * STAGES * KV;
  // q_full, q_empty, then k_full, v_full, k_empty and v_empty of each
  // stage; 1,024 bytes to align the tiles
  static constexpr size_t bytes = BARS + 8 * (2 + 4 * STAGES) + 1024;
};

// the TMA coordinate of dims 1-3 at `slot`, from the (head, row, batch)
// positions packed in perm (2 bits each)
__device__ __forceinline__ int coord(int perm, int slot, int h, int s, int b) {
  return (perm & 3) == slot ? h : ((perm >> 2) & 3) == slot ? s : b;
}

__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int perm, int h, int row, int b, int boxes,
                                          uint32_t box_bytes) {
  for (int x = 0; x < boxes; ++x)
    hopper::tma_load_4d(dst + x * box_bytes, map, bar, x * 64, coord(perm, 0, h, row, b),
                        coord(perm, 1, h, row, b), coord(perm, 2, h, row, b));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ Args a,
                    __nv_bfloat16* __restrict__ out) {
  using S = Smem<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + S::Q, sV = sK + STAGES * S::KV;
  const uint32_t q_full = base + S::BARS, q_empty = q_full + 8;
  auto k_full = [&](int st) { return q_full + 16 + 8 * st; };
  auto v_full = [&](int st) { return q_full + 16 + 8 * (STAGES + st); };
  auto k_empty = [&](int st) { return q_full + 16 + 8 * (2 * STAGES + st); };
  auto v_empty = [&](int st) { return q_full + 16 + 8 * (3 * STAGES + st); };

  // Work tile t (a q tile of one head) is (iq, bh) = (nq - 1 - t / nbh,
  // t % nbh): the heaviest q tiles first.  Block c takes tiles c, c + grid,
  // c + 2 grid, ...
  const int nbh = a.nb * a.nh;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int total = nq * nbh;
  auto q_start = [&](int t) { return (nq - 1 - t / nbh) * BQ; };
  auto key_tiles = [&](int q0) {
    const int k_end = a.causal ? min(a.sk, q0 + BQ) : a.sk;
    return (k_end + BK - 1) / BK;
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 8);   // lane 0 of each consumer warp
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(k_full(st), 1);
      hopper::mbar_init(v_full(st), 1);
      hopper::mbar_init(k_empty(st), 8);
      hopper::mbar_init(v_empty(st), 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread issues every load.  The ring position kv
    // runs on across work tiles, so the next tile's q, K and V load while
    // the consumers finish this one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int kv = 0;
      for (int t = blockIdx.x, j = 0; t < total; t += gridDim.x, ++j) {
        const int q0 = q_start(t), bh = t % nbh;
        const int b = bh / a.nh, h = bh % a.nh, hk = h / a.group;
        hopper::mbar_wait(q_empty, (j & 1) ^ 1);   // the previous tile's q is read
        hopper::mbar_expect_tx(q_full, S::Q);
        load_tile(sQ, &tq, q_full, a.perm_q, h, q0, b, BOXES, BQ * S::BOX);
        const int n_tiles = key_tiles(q0);
        for (int it = 0; it < n_tiles; ++it, ++kv) {
          const int st = kv % STAGES;
          const uint32_t ph = (kv / STAGES) & 1;
          hopper::mbar_wait(k_empty(st), ph ^ 1);   // the first lap passes at once
          hopper::mbar_expect_tx(k_full(st), S::KV);
          load_tile(sK + st * S::KV, &tk, k_full(st), a.perm_kv, hk, it * BK, b, BOXES,
                    BK * S::BOX);
          hopper::mbar_wait(v_empty(st), ph ^ 1);
          hopper::mbar_expect_tx(v_full(st), S::KV);
          load_tile(sV + st * S::KV, &tv, v_full(st), a.perm_kv, hk, it * BK, b, BOXES,
                    BK * S::BOX);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows q0 + 64 wg ... + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    constexpr int NT = BK / 8;   // 8-key column blocks of S
    constexpr int ND = D / 8;    // 8-wide column blocks of O
    const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    // this warp's first row and this lane's two rows, of the current tile
    int r0 = 0, row_a = 0, row_b = 0;

    float o[ND * 4];
    float m_a, m_b, l_a, l_b;   // l: this lane's part
    // S of the current key tile; lane holds s[4j + {0,1}] at (row_a, key
    // k0 + 8j + 2t4 + {0,1}) and s[4j + {2,3}] at row_b
    float s[NT * 4];
    // P, rounded to bf16 once, in the A fragment layout of m64nNk16: keys
    // 16kk + 2t4 (+1), + 8 (+1) of rows row_a and row_b
    uint32_t p[BK / 16][4];

    // S = Q K^T of the key tile in stage st, issued (not waited for)
    auto issue_s = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 bf16 along the swizzled row
        const uint64_t da = hopper::sw128_desc(
            sQ + (kk / 4) * (BQ * S::BOX) + wg * 64 * S::BOX + off, 16, 1024);
        const uint64_t db =
            hopper::sw128_desc(sK + st * S::KV + (kk / 4) * (BK * S::BOX) + off, 16, 1024);
        hopper::wgmma_ss(s, da, db, kk > 0);   // m64n128k16
      }
      hopper::wgmma_commit();
    };
    // O += P V of the key tile in stage st, issued (not waited for)
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db =
            hopper::sw128_desc(sV + st * S::KV + kk * 16 * S::BOX, BK * S::BOX, 1024);
        hopper::wgmma_rs(o, p[kk], db);   // m64n{D}k16, by the size of o
      }
      hopper::wgmma_commit();
    };
    // the online softmax of the key tile at k0, in base 2 (scale > 0): keys
    // past sk and, under causal, keys after the row masked to -1e30 on the
    // tiles that have any; m = max(m, max_j s_j * scale * log2 e), l, and
    // s_j = 2^(s_j * scale * log2 e - m).  Returns the factors c_a, c_b that
    // O still has to be rescaled by.
    const float scale2 = a.scale * LOG2E;
    auto softmax = [&](int k0, float& c_a, float& c_b) {
      if ((k0 + BK > a.sk) || (a.causal && k0 + BK - 1 > r0)) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * t4 + (e & 1);
            if (key >= a.sk || (a.causal && key > (e < 2 ? row_a : row_b)))
              s[4 * j + e] = MASKED;
          }
      }
      float mx_a = MASKED, mx_b = MASKED;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      // a row's entries lie on the 4 lanes of a quad
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a * scale2), mn_b = fmaxf(m_b, mx_b * scale2);
      c_a = hopper::exp2_approx(m_a - mn_a);
      c_b = hopper::exp2_approx(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[4 * j] = hopper::exp2_approx(fmaf(s[4 * j], scale2, -mn_a));
        s[4 * j + 1] = hopper::exp2_approx(fmaf(s[4 * j + 1], scale2, -mn_a));
        s[4 * j + 2] = hopper::exp2_approx(fmaf(s[4 * j + 2], scale2, -mn_b));
        s[4 * j + 3] = hopper::exp2_approx(fmaf(s[4 * j + 3], scale2, -mn_b));
        sum_a += s[4 * j] + s[4 * j + 1];
        sum_b += s[4 * j + 2] + s[4 * j + 3];
      }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
    };
    // this warp is done with a buffer (q, or a stage's K or V)
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };

    int kv = 0;   // the ring position, as the producer's
    for (int t = blockIdx.x, j = 0; t < total; t += gridDim.x, ++j) {
      const int q0 = q_start(t), bh = t % nbh;
      const int b = bh / a.nh, h = bh % a.nh;
      r0 = q0 + 64 * wg + 16 * warp;
      row_a = r0 + g;
      row_b = row_a + 8;
#pragma unroll
      for (int i = 0; i < ND * 4; ++i) o[i] = 0.f;
      m_a = m_b = MASKED;
      l_a = l_b = 0.f;

      hopper::mbar_wait(q_full, j & 1);
      const int n_tiles = key_tiles(q0);
      for (int it = 0; it < n_tiles; ++it, ++kv) {
        const int st = kv % STAGES;
        const uint32_t ph = (kv / STAGES) & 1;

        // S = Q K^T
        hopper::mbar_wait(k_full(st), ph);
        hopper::wgmma_fence();
        issue_s(st);
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < NT * 4; ++i) hopper::reg_fence(s[i]);
        release(k_empty(st));
        if (it == n_tiles - 1) release(q_empty);   // q's last product is done

        float c_a, c_b;
        softmax(it * BK, c_a, c_b);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[4 * n] *= c_a;
          o[4 * n + 1] *= c_a;
          o[4 * n + 2] *= c_b;
          o[4 * n + 3] *= c_b;
        }
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
          p[jj / 2][(jj % 2) * 2] = pack_bf16(s[4 * jj], s[4 * jj + 1]);
          p[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(s[4 * jj + 2], s[4 * jj + 3]);
        }

        // O += P V
        hopper::mbar_wait(v_full(st), ph);
        hopper::wgmma_fence();
        issue_pv(st);
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < ND * 4; ++i) hopper::reg_fence(o[i]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) hopper::reg_fence(p[kk][e]);
        release(v_empty(st));
      }

      // the full row sums, then out = O / max(l, 1e-30) and lse = m + log(l)
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      l_a = fmaxf(l_a, 1e-30f);
      l_b = fmaxf(l_b, 1e-30f);
      __nv_bfloat16* oh = out + b * a.o.b + h * a.o.h;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int col = n * 8 + 2 * t4;
        if (row_a < a.sq)
          *reinterpret_cast<uint32_t*>(oh + row_a * a.o.s + col) =
              pack_bf16(o[4 * n] / l_a, o[4 * n + 1] / l_a);
        if (row_b < a.sq)
          *reinterpret_cast<uint32_t*>(oh + row_b * a.o.s + col) =
              pack_bf16(o[4 * n + 2] / l_b, o[4 * n + 3] / l_b);
      }
      if (t4 == 0) {
        float* lh = a.lse + (long long)bh * a.sq;
        // m is in base 2: lse = (m + log2 l) ln 2
        if (row_a < a.sq) lh[row_a] = (m_a + log2f(l_a)) * LN2;
        if (row_b < a.sq) lh[row_b] = (m_b + log2f(l_b)) * LN2;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already loaded (no
// link against libcuda at build time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// A 4-D tensor map over (D, and the head, row and batch dims sorted by
// stride), boxes of 64 columns x `rows` rows of one head, 128-byte swizzle.
// Sets perm to where head, row and batch landed.  Returns 0 or an error code.
int make_map(CUtensorMap* map, const void* ptr, int d, long long heads, long long rows,
             long long batch, const Strides& st, int box_rows, int* perm) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  struct Dim {
    cuuint64_t extent, stride;
    cuuint32_t box;
    int role;
  } dims[3] = {{(cuuint64_t)heads, (cuuint64_t)st.h * 2, 1, 0},
               {(cuuint64_t)rows, (cuuint64_t)st.s * 2, (cuuint32_t)box_rows, 1},
               {(cuuint64_t)batch, (cuuint64_t)st.b * 2, 1, 2}};
  for (int i = 1; i < 3; ++i)   // stable insertion sort by stride
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim x = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = x;
    }
  cuuint64_t extent[4] = {(cuuint64_t)d, dims[0].extent, dims[1].extent, dims[2].extent};
  cuuint64_t stride[3] = {dims[0].stride, dims[1].stride, dims[2].stride};
  cuuint32_t box[4] = {64, dims[0].box, dims[1].box, dims[2].box};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  *perm = 0;
  for (int i = 0; i < 3; ++i) *perm |= i << (2 * dims[i].role);
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                             extent, stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, Args a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int nkv = a.nh / a.group;
  int perm_v = 0, rc;
  if ((rc = make_map(&tq, q, D, a.nh, a.sq, a.nb, a.q, BQ, &a.perm_q)) != 0) return rc;
  if ((rc = make_map(&tk, k, D, nkv, a.sk, a.nb, a.k, BK, &a.perm_kv)) != 0) return rc;
  if ((rc = make_map(&tv, v, D, nkv, a.sk, a.nb, a.v, BK, &perm_v)) != 0) return rc;
  if (perm_v != a.perm_kv) return (int)cudaErrorInvalidValue;   // k and v share the coordinates
  auto kernel = flash_fwd_tc_kernel<D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block per SM (a block takes 160 KB of shared memory)
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const long long tiles = (long long)a.nb * a.nh * ((a.sq + BQ - 1) / BQ);
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<blocks, THREADS, smem, stream>>>(tq, tk, tv, a, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ============================ float32: CUDA cores ============================

namespace f32 {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;

template <int D>
struct Smem {
  static constexpr int RS = D + 4;        // row stride of the q, k, v tiles (16 bytes of pad)
  static constexpr int PS = BK + 4;       // row stride of p
  static constexpr size_t q_elems = (size_t)BQ * RS;
  static constexpr size_t kv_elems = (size_t)BK * RS;
  static constexpr size_t p_floats = (size_t)WARPS * 16 * PS;
  static constexpr size_t bytes = (q_elems + 2 * kv_elems + p_floats) * 4;
};

// rows [row0, row0 + nrows) of a head (row stride rs) into a shared tile of
// stride RS, 16 bytes per thread and step; rows past `limit` read as 0
template <int D>
__device__ __forceinline__ void stage(float* tile, const float* src, long long rs, int row0,
                                      int nrows, int limit) {
  constexpr int PER_ROW = D / 4;
  constexpr int RS = Smem<D>::RS;
  for (int i = threadIdx.x; i < nrows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) val = *reinterpret_cast<const float4*>(src + (row0 + r) * rs + c);
    *reinterpret_cast<float4*>(tile + r * RS + c) = val;
  }
}

// 3 blocks per SM: ptxas then keeps the kernel in 168 registers without
// spilling (unbounded, it spills the accumulators and runs 25% slower)
template <int D>
__global__ void __launch_bounds__(THREADS, 3)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, const Args a) {
  using S = Smem<D>;
  constexpr int RS = S::RS;
  constexpr int NT = BK / 8;   // 8-key column tiles of s
  constexpr int ND = D / 8;    // 8-wide column tiles of acc
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + S::q_elems;
  float* vs = ks + S::kv_elems;

  const int nbh = a.nb * a.nh;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq = nq - 1 - (int)(blockIdx.x / nbh);   // the heaviest q tiles first
  const int bh = (int)(blockIdx.x % nbh);
  const int b = bh / a.nh, h = bh % a.nh, hk = h / a.group;
  const int q0 = iq * BQ;
  const float* qh = q + b * a.q.b + h * a.q.h;
  const float* kh = k + b * a.k.b + hk * a.k.h;
  const float* vh = v + b * a.v.b + hk * a.v.h;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;   // fragment row group and column pair
  const int r0 = warp * 16;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;   // this lane's two rows

  stage<D>(qs, qh, a.q.s, q0, BQ, a.sq);
  __syncthreads();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = MASKED, m_b = MASKED, l_a = 0.f, l_b = 0.f;   // l: this lane's part

  const int k_end = a.causal ? min(a.sk, q0 + BQ) : a.sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // every warp is done with the previous tile
    stage<D>(ks, kh, a.k.s, k0, BK, a.sk);
    stage<D>(vs, vh, a.v.s, k0, BK, a.sk);
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's 64 keys; lane holds
    // s[j][0..1] at (row_a, key k0 + 8j + 2t + {0,1}) and s[j][2..3] at row_b
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qa_ = qs[(r0 + g) * RS + d], qb_ = qs[(r0 + g + 8) * RS + d];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float k0v = ks[(j * 8 + 2 * t) * RS + d];
        const float k1v = ks[(j * 8 + 2 * t + 1) * RS + d];
        s[j][0] = fmaf(qa_, k0v, s[j][0]);
        s[j][1] = fmaf(qa_, k1v, s[j][1]);
        s[j][2] = fmaf(qb_, k0v, s[j][2]);
        s[j][3] = fmaf(qb_, k1v, s[j][3]);
      }
    }

    // scale, mask (keys past sk; under causal, keys after the row)
    const bool edge = (k0 + BK > a.sk) || (a.causal && k0 + BK - 1 > q0 + r0);
    float mx_a = MASKED, mx_b = MASKED;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (edge) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          if (key >= a.sk || (a.causal && key > row)) x = MASKED;
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

    // acc += p v, p through shared memory
    float* ps = vs + S::kv_elems + warp * 16 * S::PS;
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
        const float v0 = vs[key * RS + n * 8 + 2 * t];
        const float v1 = vs[key * RS + n * 8 + 2 * t + 1];
        acc[n][0] = fmaf(pa_, v0, acc[n][0]);
        acc[n][1] = fmaf(pa_, v1, acc[n][1]);
        acc[n][2] = fmaf(pb_, v0, acc[n][2]);
        acc[n][3] = fmaf(pb_, v1, acc[n][3]);
      }
    }
    __syncwarp();   // p is rewritten by the next tile
  }

  // the full row sums, then out = acc / max(l, 1e-30) and lse = m + log(l)
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  float* oh = out + b * a.o.b + h * a.o.h;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_a < a.sq)
      *reinterpret_cast<float2*>(oh + row_a * a.o.s + col) =
          make_float2(acc[n][0] / l_a, acc[n][1] / l_a);
    if (row_b < a.sq)
      *reinterpret_cast<float2*>(oh + row_b * a.o.s + col) =
          make_float2(acc[n][2] / l_b, acc[n][3] / l_b);
  }
  if (t == 0) {
    float* lh = a.lse + (long long)bh * a.sq;
    if (row_a < a.sq) lh[row_a] = m_a + logf(l_a);
    if (row_b < a.sq) lh[row_b] = m_b + logf(l_b);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const Args& a,
           cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)a.nb * a.nh * ((a.sq + BQ - 1) / BQ);
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>((const float*)q, (const float*)k,
                                                     (const float*)v, (float*)out, a);
  return (int)cudaGetLastError();
}

}  // namespace f32

Args make_args(void* lse, int nb, int nh, int group, int sq, int sk, const long long* st,
               int causal, float scale) {
  Args a;
  a.q = {st[0], st[1], st[2]};
  a.k = {st[3], st[4], st[5]};
  a.v = {st[6], st[7], st[8]};
  a.o = {st[9], st[10], st[11]};
  a.lse = (float*)lse;
  a.nb = nb;
  a.nh = nh;
  a.group = group;
  a.sq = sq;
  a.sk = sk;
  a.causal = causal;
  a.scale = scale;
  a.perm_q = a.perm_kv = 0;
  return a;
}

}  // namespace

// q, k, v, out and lse on the card; nb batches of nh query heads, group
// query heads per kv head; strides: 12 element strides, (batch, head, row)
// of q, k, v and out in that order.  Returns 0 or a cudaError_t.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                              int nb, int nh, int group, int sq, int sk, int d,
                              const long long* strides, int causal, float scale, void* stream) {
  if (nb <= 0 || nh <= 0 || sq <= 0) return (int)cudaGetLastError();
  const Args a = make_args(lse, nb, nh, group, sq, sk, strides, causal, scale);
  if (d == 64) return tc::launch<64>(q, k, v, out, a, (cudaStream_t)stream);
  if (d == 128) return tc::launch<128>(q, k, v, out, a, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                             int nb, int nh, int group, int sq, int sk, int d,
                             const long long* strides, int causal, float scale, void* stream) {
  if (nb <= 0 || nh <= 0 || sq <= 0) return (int)cudaGetLastError();
  const Args a = make_args(lse, nb, nh, group, sq, sk, strides, causal, scale);
  if (d == 64) return f32::launch<64>(q, k, v, out, a, (cudaStream_t)stream);
  if (d == 128) return f32::launch<128>(q, k, v, out, a, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
