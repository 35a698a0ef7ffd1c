// Fused vocab head: top_k(h @ w + b) per row, values descending, ties to the
// lowest id, optionally minus the exact row logsumexp. The [G, V] logits
// never reach device memory.
//
// Replaces the TPU kernel dlsg_tpu/ops/pallas/vocab_head.py::vocab_head_topk
// (pallas_call at :151; body _vocab_head_kernel :52-92, _tile_topk :36-49).
//
// What bounds it on the card: at the beam step's shapes (G=640 rows, H=1536,
// V=10000) the function is 19.7 GFLOP against 30.7 MB of bf16 weights (61.4
// MB fp32), so it is bound by operations: ~20 us at the bf16 tensor-core
// rate; with fp32 w, three TF32 passes (below) at 495 TFLOP/s, ~119 us.
//
// Design: the TPU kernel walked the V tiles in order and kept a running top-k
// and (max, sumexp) in scratch. Blocks on the card run in no order, so the
// walk becomes two launches:
//   1. a tile kernel, one block per (row tile, 128-column vocab tile): the
//      block computes its fp32 logits tile, adds the bias, skips columns >= V
//      itself (no padded copy of w), and writes the tile's top-k (value, id)
//      and the row's (max, sum exp(x - max)) over the tile to scratch. In
//      that epilogue 2 threads share a row: each keeps the 8 best of its
//      columns in registers by insertion, and the lists merge over shuffles;
//   2. merge_kernel, one warp per row: picks the k best of the per-tile lists
//      and combines the lse as M + log(sum_j s_j exp(m_j - M)), which it also
//      writes out when asked (a vocab head split over ranks merges the ranks'
//      top-k and lse after this launch, evaluation/decode.py).
// The tile kernel has two forms, chosen by the dtype of w alone. Both are a
// 128 x 128 tile on the tensor cores, the row tile the fast grid index: 8
// warps, each a 64 x 32 sub-tile, fed by a ring of [128 x 32] h tiles and
// [32 x 128] w tiles in shared memory that 16-byte cp.async fills (ordinary
// loads where a row is not 16-byte aligned), rows >= G and k >= H zero-filled;
// the ring is then reused as the [128 x 130] fp32 logits tile.
//   - bf16 w (the serving path): tc_tile_kernel. h arrives as bf16 (rounded
//     once by the wrapper, as the TPU kernel casts h to w's dtype); a 4-stage
//     ring, mma.sync m16n8k16 bf16 -> fp32 fed by ldmatrix (ldmatrix.trans
//     for w, which is [H, V] row-major).
//   - fp32 w: tf32x3_tile_kernel, the fp32 product on the TF32 tensor cores.
//     One TF32 pass would not do: it rounds both operands to 11 significant
//     bits, and at K1's operands (h = tanh(N(0, 1)), w xavier-normal, H =
//     1536, logits up to 1.58) its error against a float64 product is 4.6e-4,
//     where a plain fp32 product's is 6.9e-7. So each operand x is split in
//     registers as it is loaded, hi = tf32(x) and lo = tf32(x - hi) (cvt.rna;
//     x - hi is exact), and every fragment pair issues hi*lo, lo*hi, then
//     hi*hi (mma.sync m16n8k8 tf32 -> fp32). Only lo*lo (2^-22 of x*y) and
//     the rounding of lo (2^-22 of x) are dropped: with exact sums the three
//     products are 1.2e-7 from float64. The sums are not exact: the tensor
//     core rounds each mma's fp32 result toward zero. Summed that way over
//     the 576 mma (192 k-steps x 3) of an output, the bias reaches 2.5e-5 in
//     a numpy emulation (1.5e-6 if it rounded to nearest), and 2.04e-5 on an
//     H100 (kernels/breakdown.py, variant tf32x3_one_accumulator). So the 12
//     mma of each 32-deep k-tile sum into fresh registers, added to the fp32
//     accumulator with round-to-nearest adds (48 per output): 6.7e-7 in the
//     emulation, 7.9e-7 on the H100, a plain fp32 product's level.
//     ldmatrix does not serve 32-bit transposed B, so the fragments are scalar
//     shared loads: h rows padded by 4 floats (stride 36) and w rows by 8
//     (stride 136) put the A loads (g*36 + t) and B loads (t*136 + g) of a
//     warp on 32 distinct banks. A stage is 35 840 B, 4 stages 140 KB.
//     ptxas (sm_90a): 221 registers a thread (64 accumulators, 64 k-tile
//     sums, the hi/lo fragments), no spills, so one block of 8 warps per SM
//     at either ring depth (3 stages, 105 KB, measured no faster). The split
//     is about a fifth of the kernel's time; rounding by an integer add and
//     mask instead of cvt.rna is faster but turns CUDA's canonical NaN
//     (0x7fffffff) into -0, hiding a NaN in h or w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;       // vocab columns per block (one tile), both forms
constexpr int THREADS = 256;  // both tile kernels
constexpr int KMAX = 8;
constexpr long long NO_ID = 0x7fffffffLL;  // id of an empty slot
constexpr unsigned FULL = 0xffffffffu;

// bf16 tensor-core form
constexpr int TC_BM = 128;
constexpr int TC_BK = 32;
constexpr int TC_STAGES = 4;
// bf16 per row of the h and w tiles in shared memory, padded by 8 so that
// ldmatrix's 8 row addresses fall on distinct banks (80 B and 272 B rows)
constexpr int A_STRIDE = TC_BK + 8;
constexpr int B_STRIDE = BN + 8;
constexpr int A_STAGE = TC_BM * A_STRIDE;
constexpr int B_STAGE = TC_BK * B_STRIDE;
constexpr int TC_RING_BYTES = TC_STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int TC_TILE_BYTES = TC_BM * (BN + THREADS / TC_BM) * 4;
constexpr int TC_SMEM_BYTES = TC_RING_BYTES > TC_TILE_BYTES ? TC_RING_BYTES : TC_TILE_BYTES;

// fp32 TF32x3 form: 128 x 128 tiles, as the bf16 form, on fp32 rings
constexpr int F_BM = 128;
constexpr int F_BK = 32;
constexpr int F_STAGES = 4;
// floats per row of the h and w tiles in shared memory (see the note above)
constexpr int FA_STRIDE = F_BK + 4;
constexpr int FB_STRIDE = BN + 8;
constexpr int FA_STAGE = F_BM * FA_STRIDE;
constexpr int FB_STAGE = F_BK * FB_STRIDE;
constexpr int F_RING_BYTES = F_STAGES * (FA_STAGE + FB_STAGE) * 4;
constexpr int F_TILE_BYTES = F_BM * (BN + THREADS / F_BM) * 4;
constexpr int F_SMEM_BYTES = F_RING_BYTES > F_TILE_BYTES ? F_RING_BYTES : F_TILE_BYTES;

// (v, i) ranks before (bv, bi): larger value first, then lower id
template <typename I>
__device__ __forceinline__ bool better(float v, I i, float bv, I bi) {
  return v > bv || (v == bv && i < bi);
}

// best (value, id) over the warp; every lane ends with the same pair
__device__ __forceinline__ void warp_best(float& v, long long& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, off);
    long long oi = __shfl_xor_sync(FULL, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// insert (v, i) into the sorted list (tv, ti) of the KMAX best, dropping the last
__device__ __forceinline__ void insert(float (&tv)[KMAX], int (&ti)[KMAX], float v, int i) {
  if (!better(v, i, tv[KMAX - 1], ti[KMAX - 1])) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (better(v, i, tv[j], ti[j])) {  // (v, i) takes slot j and carries the old entry down
      const float sv = tv[j];
      const int si = ti[j];
      tv[j] = v;
      ti[j] = i;
      v = sv;
      i = si;
    }
}

// Row stride of the logits tile C [ROWS][stride] in shared memory: P = THREADS
// / ROWS neighbouring threads share a row and read columns P j + q, so a
// stride of BN + P puts the 32 lanes of a warp on 32 banks.
template <int ROWS>
__host__ __device__ constexpr int tile_stride() { return BN + THREADS / ROWS; }

// The epilogue both tile kernels share. C holds the logits tile with the bias
// added. P threads per row each keep the KMAX best of their columns (>= V
// skipped) in registers with the row's (max, sumexp) over them; the P lists
// and sums merge over shuffles, and the row's first thread writes the tile's
// top-k and (max, sumexp) to scratch.
template <int ROWS>
__device__ void tile_epilogue(const float* C, int row0, int col0, int tile, int G, int V,
                              int k, int n_tiles, float* __restrict__ part_v,
                              long long* __restrict__ part_i, float* __restrict__ part_m,
                              float* __restrict__ part_s) {
  constexpr int P = THREADS / ROWS, S = tile_stride<ROWS>();
  const int m = threadIdx.x / P, q = threadIdx.x % P;
  const float* row = C + m * S;
  const int n_cols = min(BN, V - col0);  // columns of this tile below V
  float tv[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tv[j] = -INFINITY;
    ti[j] = (int)NO_ID;
  }
  float mx = -INFINITY;
  for (int n = q; n < n_cols; n += P) {
    const float v = row[n];
    mx = fmaxf(mx, v);
    insert(tv, ti, v, col0 + n);
  }
  float s = 0.f;
  for (int n = q; n < n_cols; n += P) s += expf(row[n] - mx);
#pragma unroll
  for (int off = 1; off < P; off <<= 1) {  // the P threads of a row are neighbouring lanes
    const float om = __shfl_xor_sync(FULL, mx, off), os = __shfl_xor_sync(FULL, s, off);
    const float M = fmaxf(mx, om);
    s = (s > 0.f ? s * expf(mx - M) : 0.f) + (os > 0.f ? os * expf(om - M) : 0.f);
    mx = M;
    float pv[KMAX];
    int pi[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      pv[j] = __shfl_xor_sync(FULL, tv[j], off);
      pi[j] = __shfl_xor_sync(FULL, ti[j], off);
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j) insert(tv, ti, pv[j], pi[j]);
  }
  const int r = row0 + m;
  if (q != 0 || r >= G) return;
  const size_t slot = (size_t)r * n_tiles + tile;
  part_m[slot] = mx;
  part_s[slot] = s;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) {
      part_v[slot * k + j] = tv[j];
      part_i[slot * k + j] = ti[j];
    }
}

// ------------------------------------------------ bf16 w: tensor cores

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with `pred` false the destination is zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 bf16 at src[0..n) (n <= 8, the rest zero) into 16 bytes of shared memory
// with ordinary loads: the path for rows that are not 16-byte aligned
__device__ __forceinline__ void copy8_sync(__nv_bfloat16* dst, const __nv_bfloat16* src, int n) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  unsigned short v[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = q < n ? __ldg(s + q) : (unsigned short)0;
  uint4 u;
  u.x = v[0] | ((uint32_t)v[1] << 16);
  u.y = v[2] | ((uint32_t)v[3] << 16);
  u.z = v[4] | ((uint32_t)v[5] << 16);
  u.w = v[6] | ((uint32_t)v[7] << 16);
  *reinterpret_cast<uint4*>(dst) = u;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, k-major), fp32 accumulate.
// Not volatile: independent products may be scheduled around each other.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage k-tile kt of h [G, H] and w [H, V] into ring slot `slot`: 512
// 16-byte chunks each, two per thread. With `aligned` (H and V multiples of
// 8, 16-byte base pointers) a chunk is wholly in or out of bounds, and
// cp.async zero-fills the ones out.
__device__ __forceinline__ void tc_load_stage(__nv_bfloat16* As, __nv_bfloat16* Bs,
                                              const __nv_bfloat16* __restrict__ h,
                                              const __nv_bfloat16* __restrict__ w, int kt,
                                              int row0, int col0, int G, int H, int V,
                                              bool aligned) {
  const int k0 = kt * TC_BK;
#pragma unroll
  for (int q = 0; q < (TC_BM * TC_BK / 8) / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int m = e / (TC_BK / 8), kc = (e % (TC_BK / 8)) * 8;
    const int r = row0 + m, c = k0 + kc;
    __nv_bfloat16* dst = As + m * A_STRIDE + kc;
    const bool in = r < G && c < H;
    const __nv_bfloat16* src = in ? h + (size_t)r * H + c : h;
    if (aligned)
      cp_async16(dst, src, in);
    else
      copy8_sync(dst, src, in ? min(8, H - c) : 0);
  }
#pragma unroll
  for (int q = 0; q < (TC_BK * BN / 8) / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int kk = e / (BN / 8), nc = (e % (BN / 8)) * 8;
    const int r = k0 + kk, c = col0 + nc;
    __nv_bfloat16* dst = Bs + kk * B_STRIDE + nc;
    const bool in = r < H && c < V;
    const __nv_bfloat16* src = in ? w + (size_t)r * V + c : w;
    if (aligned)
      cp_async16(dst, src, in);
    else
      copy8_sync(dst, src, in ? min(8, V - c) : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
tc_tile_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ part_v,
               long long* __restrict__ part_i, float* __restrict__ part_m,
               float* __restrict__ part_s, int G, int H, int V, int k, int n_tiles,
               int aligned) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  // the row tile is the fast grid index: the blocks that share a w tile run together
  const int row0 = blockIdx.x * TC_BM;
  const int tile = blockIdx.y;
  const int col0 = tile * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // the warp's 64 x 32 sub-tile
  const int KT = (H + TC_BK - 1) / TC_BK;

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto As = [&](int s) { return ring + s * (A_STAGE + B_STAGE); };
  auto Bs = [&](int s) { return ring + s * (A_STAGE + B_STAGE) + A_STAGE; };

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < KT) tc_load_stage(As(s), Bs(s), h, w, s, row0, col0, G, H, V, aligned);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<TC_STAGES - 2>();  // k-tile kt has landed
    __syncthreads();                 // ... for every thread; slot (kt - 1) is free
    const int next = kt + TC_STAGES - 1;
    if (next < KT)
      tc_load_stage(As(next % TC_STAGES), Bs(next % TC_STAGES), h, w, next, row0, col0, G, H,
                    V, aligned);
    cp_async_commit();
    const __nv_bfloat16* a_s = As(kt % TC_STAGES);
    const __nv_bfloat16* b_s = Bs(kt % TC_STAGES);
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], a_s + (wm + i * 16 + lane % 16) * A_STRIDE + kk + (lane / 16) * 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_s + (kk + lane % 16) * B_STRIDE + wn + jj * 16 + (lane / 16) * 8);
        bf[2 * jj][0] = r[0];
        bf[2 * jj][1] = r[1];
        bf[2 * jj + 1][0] = r[2];
        bf[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused as the logits tile

  // the logits tile (+ bias), [TC_BM][tile_stride<TC_BM>()]; columns >= V are never read
  float* C = reinterpret_cast<float*>(tc_smem);
  constexpr int CS = tile_stride<TC_BM>();
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = wn + j * 8 + 2 * t, c = col0 + n;
    const float b0 = c < V ? b[c] : 0.f, b1 = c + 1 < V ? b[c + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = wm + i * 16 + g;
      *reinterpret_cast<float2*>(C + m * CS + n) =
          make_float2(acc[i][j][0] + b0, acc[i][j][1] + b1);
      *reinterpret_cast<float2*>(C + (m + 8) * CS + n) =
          make_float2(acc[i][j][2] + b0, acc[i][j][3] + b1);
    }
  }
  __syncthreads();
  tile_epilogue<TC_BM>(C, row0, col0, tile, G, V, k, n_tiles, part_v, part_i, part_m, part_s);
}

// ------------------------------------------------------ fp32 w: TF32 x 3

// x rounded to TF32 (half away from zero) as an fp32 bit pattern: a .tf32
// value's 13 low bits are unspecified, and x - hi needs them zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo + (2^-22 |x| at most), hi and lo TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a (16x8 tf32, row-major) * b (8x8 tf32, k-major), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 floats at src[0..n) (n <= 4, the rest zero) into 16 bytes of shared
// memory with ordinary loads: the path for rows that are not 16-byte aligned
__device__ __forceinline__ void copy4_sync(float* dst, const float* src, int n) {
  float4 v;
  v.x = n > 0 ? __ldg(src) : 0.f;
  v.y = n > 1 ? __ldg(src + 1) : 0.f;
  v.z = n > 2 ? __ldg(src + 2) : 0.f;
  v.w = n > 3 ? __ldg(src + 3) : 0.f;
  *reinterpret_cast<float4*>(dst) = v;
}

// Stage k-tile kt of h [G, H] and w [H, V] (fp32) into ring slot `slot`:
// 1024 16-byte chunks each, four per thread. With `aligned` (H and V
// multiples of 4, 16-byte base pointers) a chunk is wholly in or out of
// bounds, and cp.async zero-fills the ones out.
__device__ __forceinline__ void f_load_stage(float* As, float* Bs, const float* __restrict__ h,
                                             const float* __restrict__ w, int kt, int row0,
                                             int col0, int G, int H, int V, bool aligned) {
  const int k0 = kt * F_BK;
#pragma unroll
  for (int q = 0; q < (F_BM * F_BK / 4) / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int m = e / (F_BK / 4), kc = (e % (F_BK / 4)) * 4;
    const int r = row0 + m, c = k0 + kc;
    float* dst = As + m * FA_STRIDE + kc;
    const bool in = r < G && c < H;
    const float* src = in ? h + (size_t)r * H + c : h;
    if (aligned)
      cp_async16(dst, src, in);
    else
      copy4_sync(dst, src, in ? min(4, H - c) : 0);
  }
#pragma unroll
  for (int q = 0; q < (F_BK * BN / 4) / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int kk = e / (BN / 4), nc = (e % (BN / 4)) * 4;
    const int r = k0 + kk, c = col0 + nc;
    float* dst = Bs + kk * FB_STRIDE + nc;
    const bool in = r < H && c < V;
    const float* src = in ? w + (size_t)r * V + c : w;
    if (aligned)
      cp_async16(dst, src, in);
    else
      copy4_sync(dst, src, in ? min(4, V - c) : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
tf32x3_tile_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ part_v,
                   long long* __restrict__ part_i, float* __restrict__ part_m,
                   float* __restrict__ part_s, int G, int H, int V, int k, int n_tiles,
                   int aligned) {
  extern __shared__ __align__(16) unsigned char f_smem[];
  float* ring = reinterpret_cast<float*>(f_smem);
  const int row0 = blockIdx.x * F_BM;
  const int tile = blockIdx.y;
  const int col0 = tile * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // the warp's 64 x 32 sub-tile
  const int g = lane / 4, t = lane % 4;
  const int KT = (H + F_BK - 1) / F_BK;

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  auto As = [&](int s) { return ring + s * (FA_STAGE + FB_STAGE); };
  auto Bs = [&](int s) { return ring + s * (FA_STAGE + FB_STAGE) + FA_STAGE; };

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < KT) f_load_stage(As(s), Bs(s), h, w, s, row0, col0, G, H, V, aligned);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<F_STAGES - 2>();  // k-tile kt has landed
    __syncthreads();                // ... for every thread; slot (kt - 1) is free
    const int next = kt + F_STAGES - 1;
    if (next < KT)
      f_load_stage(As(next % F_STAGES), Bs(next % F_STAGES), h, w, next, row0, col0, G, H, V,
                   aligned);
    cp_async_commit();
    const float* a_s = As(kt % F_STAGES) + (wm + g) * FA_STRIDE + t;
    const float* b_s = Bs(kt % F_STAGES) + t * FB_STRIDE + wn + g;
    float part[4][4][4];  // this k-tile's sums, added to acc round-to-nearest
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < F_BK; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(b_s[kk * FB_STRIDE + j * 8], bh[j][0], bl[j][0]);
        split_tf32(b_s[(kk + 4) * FB_STRIDE + j * 8], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* a = a_s + i * 16 * FA_STRIDE + kk;
        uint32_t ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8 * FA_STRIDE], ah[1], al[1]);
        split_tf32(a[4], ah[2], al[2]);
        split_tf32(a[8 * FA_STRIDE + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(part[i][j], ah, bl[j][0], bl[j][1]);
          mma_tf32(part[i][j], al, bh[j][0], bh[j][1]);
          mma_tf32(part[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused as the logits tile

  // the logits tile (+ bias), [F_BM][tile_stride<F_BM>()]; columns >= V are never read
  float* C = ring;
  constexpr int CS = tile_stride<F_BM>();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = wn + j * 8 + 2 * t, c = col0 + n;
    const float b0 = c < V ? b[c] : 0.f, b1 = c + 1 < V ? b[c + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = wm + i * 16 + g;
      *reinterpret_cast<float2*>(C + m * CS + n) =
          make_float2(acc[i][j][0] + b0, acc[i][j][1] + b1);
      *reinterpret_cast<float2*>(C + (m + 8) * CS + n) =
          make_float2(acc[i][j][2] + b0, acc[i][j][3] + b1);
    }
  }
  __syncthreads();
  tile_epilogue<F_BM>(C, row0, col0, tile, G, V, k, n_tiles, part_v, part_i, part_m, part_s);
}

// ------------------------------------------------------------- merge

__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part_v, const long long* __restrict__ part_i,
             const float* __restrict__ part_m, const float* __restrict__ part_s,
             float* __restrict__ vals, long long* __restrict__ ids,
             float* __restrict__ lse_out, int G, int k, int n_tiles, int normalize) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= G) return;  // whole warp
  const float* pm = part_m + (size_t)r * n_tiles;
  const float* ps = part_s + (size_t)r * n_tiles;
  float M = -INFINITY;
  for (int t = lane; t < n_tiles; t += 32) M = fmaxf(M, pm[t]);
  M = warp_max(M);
  float S = 0.f;
  for (int t = lane; t < n_tiles; t += 32) S += ps[t] * expf(pm[t] - M);
  S = warp_sum(S);
  const float lse = M + logf(S);
  if (lse_out != nullptr && lane == 0) lse_out[r] = lse;

  const float* cv = part_v + (size_t)r * n_tiles * k;
  const long long* ci = part_i + (size_t)r * n_tiles * k;
  const int n = n_tiles * k;
  float pv = INFINITY;
  long long pi = -1;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    long long bi = NO_ID;
    for (int c = lane; c < n; c += 32) {
      const float x = cv[c];
      const long long i = ci[c];
      if (better(pv, pi, x, i) && better(x, i, bv, bi)) {
        bv = x;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      vals[(size_t)r * k + t] = normalize ? bv - lse : bv;
      ids[(size_t)r * k + t] = bi;
    }
    pv = bv;
    pi = bi;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one tile block of each form, in bytes (the
// wrapper's tile plans state the same numbers).
extern "C" int vocab_head_tc_smem_bytes() { return TC_SMEM_BYTES; }
extern "C" int vocab_head_tf32x3_smem_bytes() { return F_SMEM_BYTES; }

// w [H, V] bf16 (w_bf16 = 1) with h [G, H] bf16, or w and h fp32; b [V]
// fp32; scratch part_v/part_i [G, n_tiles, k], part_m/part_s [G, n_tiles]
// with n_tiles = ceil(V / 128); outputs vals [G, k] fp32, ids [G, k] int64,
// and, when lse is not null, the row logsumexp lse [G] fp32 (last, so a
// caller of the form without it binds unchanged).
// Returns the first nonzero cudaGetLastError() of the launches.
extern "C" int vocab_head_topk_launch(const void* h, const void* w, int w_bf16,
                                      const void* b, void* part_v, void* part_i,
                                      void* part_m, void* part_s, void* vals, void* ids,
                                      int G, int H, int V, int k, int normalize,
                                      void* stream, void* lse) {
  if (k < 1 || k > KMAX || G < 1 || V < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + BN - 1) / BN;
  const float* bp = static_cast<const float*>(b);
  float* pv = static_cast<float*>(part_v);
  long long* pi = static_cast<long long*>(part_i);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  if (w_bf16) {
    // per device, so set on every launch (a host-side call, no launch)
    const cudaError_t e = cudaFuncSetAttribute(
        tc_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int aligned = H % 8 == 0 && V % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const dim3 grid((G + TC_BM - 1) / TC_BM, n_tiles);
    tc_tile_kernel<<<grid, THREADS, TC_SMEM_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w), bp, pv, pi,
        pm, ps, G, H, V, k, n_tiles, aligned);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        tf32x3_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int aligned = H % 4 == 0 && V % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const dim3 grid((G + F_BM - 1) / F_BM, n_tiles);
    tf32x3_tile_kernel<<<grid, THREADS, F_SMEM_BYTES, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), bp, pv, pi, pm, ps, G, H, V,
        k, n_tiles, aligned);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<(G + 7) / 8, 256, 0, st>>>(pv, pi, pm, ps, static_cast<float*>(vals),
                                            static_cast<long long*>(ids),
                                            static_cast<float*>(lse), G, k, n_tiles, normalize);
  return static_cast<int>(cudaGetLastError());
}
