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
// Before either, the bf16 form's mainloop meets the L2 -> SM traffic of its
// ring fills (each tile streams its h rows and w columns over all of H), as
// qmatmul's does (PERF.md).
//
// Design: the TPU kernel walked the V tiles in order and kept a running top-k
// and (max, sumexp) in scratch. Blocks on the card run in no order, so the
// walk becomes two launches:
//   1. a tile kernel over (row tile, vocab tile) pairs: for each, the fp32
//      logits tile plus the bias, columns >= V skipped (no padded copy of
//      w), reduced to the tile's top-k (value, id) and each row's (max, sum
//      exp(x - max)) over the tile, written to scratch. In that epilogue a
//      few threads share a row: each keeps the 8 best of its columns in
//      registers by insertion, and the lists merge over shuffles;
//   2. merge_kernel, one warp per row: picks the k best of the per-tile lists
//      and combines the lse as M + log(sum_j s_j exp(m_j - M)), which it also
//      writes out when asked (a vocab head split over ranks merges the ranks'
//      top-k and lse after this launch, evaluation/decode.py).
// The first launch has two forms, by w's dtype
// (kernels/vocab_head.py::vocab_head_plan):
//   - bf16 w, any H and V: vh_wgmma_kernel<BN>, route "wgmma", a persistent
//     warp-specialized kernel reading h and w through TMA maps with a row
//     pitch of their own (a multiple of 16 bytes, as TMA needs: the
//     wrapper copies h into such rows where H is not a multiple of 8, and
//     the decoder keeps its head's w [H, V] in rows of ceil8(V) once per
//     decode, Decoder.vocab_head_weights). It is a
//     kernel. At most one block per SM walks output tiles of 128 rows x BN
//     columns (BN 64 or 128, the plan's), the row tile the fast index, so the
//     blocks at work together share a few w column tiles. One thread of a
//     producer warpgroup (its registers lowered with setmaxnreg) keeps a
//     6-8 stage ring full by TMA (128-byte swizzle): [128 x 64] h tiles,
//     K-major, and [64 x BN] w tiles, which are MN-major (w is [H, V]
//     row-major), read by wgmma's transpose-B for 16-bit types with an
//     MN-major descriptor (8-row k groups 1024 bytes apart, the 64-column
//     TMA boxes 8192 bytes apart). Two consumer warpgroups, 64 rows each,
//     run wgmma m64nBNk16 bf16 -> fp32 with one group in flight and
//     release each stage as its products finish. The epilogue runs from the
//     accumulators: the tile's bias staged in shared memory once, then per
//     row (a quad of 4 threads shares one) a top-5 (k <= 5) or top-8 in each
//     thread without branches (a sorting network over its first columns,
//     each later one inserted by value alone: the ids rise), the sum of
//     exp(x - max) after it, merged across the quad by bitonic merges over
//     shuffles. The producer loads the next tile meanwhile, as far as the
//     ring reaches. Rows past G and columns past V are zero-filled by TMA
//     (boxes wholly past them are skipped) and never written; k past H
//     reads zeros from both maps. h is rounded to bf16 once by the wrapper
//     (as the TPU kernel casts h to w's dtype).
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
//     One block of 8 warps per (row tile, 128-column vocab tile), each
//     warp a 64 x 32 sub-tile, fed by a 4-stage ring of [128 x 32] h and
//     [32 x 128] w tiles that 16-byte cp.async fills (ordinary loads where
//     a row is not 16-byte aligned), rows >= G and k >= H zero-filled; the
//     ring is then reused as the [128 x 130] fp32 logits tile for
//     tile_epilogue. ldmatrix does not serve 32-bit transposed B, so the
//     fragments are scalar
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
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int BN = 128;       // vocab columns per block of the fp32 tile kernel
constexpr int THREADS = 256;  // each block of the fp32 tile kernel
constexpr int KMAX = 8;
constexpr long long NO_ID = 0x7fffffffLL;  // id of an empty slot
constexpr unsigned FULL = 0xffffffffu;

// fp32 TF32x3 form: 128 x 128 tiles on fp32 rings
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

// Merge the list and (max, sumexp) of lane (lane ^ off) into this lane's:
// both lanes end with the merged ones
__device__ __forceinline__ void merge_lane(float (&tv)[KMAX], int (&ti)[KMAX], float& mx, float& s,
                                           int off) {
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

// Row r's top-k and (max, sumexp) over vocab tile `tile`, into the scratch
// the merge launch reads
__device__ __forceinline__ void write_part(const float (&tv)[KMAX], const int (&ti)[KMAX], float mx,
                                           float s, int r, int tile, int k, int n_tiles,
                                           float* __restrict__ part_v,
                                           long long* __restrict__ part_i,
                                           float* __restrict__ part_m, float* __restrict__ part_s) {
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

// Row stride of the logits tile C [ROWS][stride] in shared memory: P = THREADS
// / ROWS neighbouring threads share a row and read columns P j + q, so a
// stride of BN + P puts the 32 lanes of a warp on 32 banks.
template <int ROWS>
__host__ __device__ constexpr int tile_stride() { return BN + THREADS / ROWS; }

// The fp32 tile kernel's epilogue. C holds the logits tile with the bias
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
  for (int off = 1; off < P; off <<= 1)  // the P threads of a row are neighbouring lanes
    merge_lane(tv, ti, mx, s, off);
  const int r = row0 + m;
  if (q == 0 && r < G) write_part(tv, ti, mx, s, r, tile, k, n_tiles, part_v, part_i, part_m, part_s);
}

// ------------------------------- bf16 w: persistent TMA + wgmma (route wgmma)

constexpr int W_CONSUMERS = 2;  // consumer warpgroups, 64 rows of a tile each
constexpr int W_BM = 64 * W_CONSUMERS;
constexpr int W_BK = 64;   // k per ring stage: one 128-byte swizzle row of bf16
constexpr int W_BOX = 64;  // TMA boxes: 64 rows of h, 64 k-rows x 64 columns of w
constexpr int W_BOX_BYTES = W_BOX * 128;
constexpr int W_A_BYTES = W_BM * W_BK * 2;
constexpr int W_RING_BYTES = 196608;  // 6 stages at BN 128, 8 at BN 64
constexpr int W_MAX_STAGES = 8;
constexpr int W_ALIGN = 1024;  // the ring starts 1024-aligned (128-byte swizzle)
constexpr int W_BIAS_BYTES = W_CONSUMERS * 128 * 4;  // each warpgroup's tile of bias
constexpr int W_BAR_BYTES = 2 * W_MAX_STAGES * 8;
constexpr int W_THREADS = 128 * (W_CONSUMERS + 1);

template <int BN>
__host__ __device__ constexpr int w_stage_bytes() { return W_A_BYTES + W_BK * BN * 2; }

template <int BN>
__host__ __device__ constexpr int w_stages() {
  return W_RING_BYTES / w_stage_bytes<BN>() < W_MAX_STAGES ? W_RING_BYTES / w_stage_bytes<BN>()
                                                             : W_MAX_STAGES;
}

template <int BN>
__host__ __device__ constexpr int w_smem_bytes() {
  return W_ALIGN + w_stages<BN>() * w_stage_bytes<BN>() + W_BIAS_BYTES + W_BAR_BYTES;
}

// wgmma descriptor of an MN-major B tile (w's [k, n] rows as TMA lays them
// with SWIZZLE_128B): 128-byte rows of 64 columns, one row per k; 8-row k
// groups 1024 bytes apart (stride byte offset) and the 64-column blocks
// `lbo` bytes apart (leading byte offset)
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t saddr, uint32_t lbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

#define F8(i)                                                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x BN fp32, the warpgroup's fragment) += a (64 x 16 bf16, K-major) *
// b (16 x BN bf16, MN-major: imm-trans-b 1), both from shared memory
template <int BN>
__device__ __forceinline__ void wgmma_bf16_tb(float (&d)[BN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16_tb<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16_tb<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(a), "l"(b), "r"(1));
}

#undef F8

// (v, i) ranks before (bv, bi), as `better`, without a branch
__device__ __forceinline__ bool better_nb(float v, int i, float bv, int bi) {
  return (v > bv) | ((v == bv) & (i < bi));
}

// Insert (v, i) into the sorted list (tv, ti) of the KL best, dropping the
// last, where i is larger than every id in the list: an equal value then
// ranks after, so `v > tv[j]` alone decides, and every slot is computed
// from the old list at once (no branch, no chain). A warp's lanes insert
// different values, so a branchy insertion's early exit seldom skips a
// warp's work, and its slot-by-slot chain leaves the scheduler idle.
template <int KL>
__device__ __forceinline__ void insert_later(float (&tv)[KL], int (&ti)[KL], float v, int i) {
  bool before[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j) before[j] = v > tv[j];
#pragma unroll
  for (int j = KL - 1; j > 0; --j) {
    tv[j] = before[j - 1] ? tv[j - 1] : before[j] ? v : tv[j];
    ti[j] = before[j - 1] ? ti[j - 1] : before[j] ? i : ti[j];
  }
  tv[0] = before[0] ? v : tv[0];
  ti[0] = before[0] ? i : ti[0];
}

// slot a keeps the better of the two entries, slot b the other
__device__ __forceinline__ void exchange(float& va, int& ia, float& vb, int& ib) {
  const bool swap = better_nb(vb, ib, va, ia);
  const float v = swap ? vb : va;
  const int i = swap ? ib : ia;
  vb = swap ? va : vb;
  ib = swap ? ia : ib;
  va = v;
  ia = i;
}

// Sort KL = 8 or 5 entries best first by a sorting network: Batcher's
// odd-even merge sort for 8 (19 exchanges), an optimal one for 5 (9)
template <int KL>
__device__ __forceinline__ void sort_network(float (&tv)[KL], int (&ti)[KL]) {
  static_assert(KL == 8 || KL == 5, "sort_network");
#define X(a, b) exchange(tv[a], ti[a], tv[b], ti[b])
  if constexpr (KL == 8) {
    X(0, 1), X(2, 3), X(4, 5), X(6, 7);
    X(0, 2), X(1, 3), X(4, 6), X(5, 7);
    X(1, 2), X(5, 6);
    X(0, 4), X(1, 5), X(2, 6), X(3, 7);
    X(2, 4), X(3, 5);
    X(1, 2), X(3, 4), X(5, 6);
  } else {
    X(0, 1), X(3, 4), X(2, 4);
    X(2, 3), X(0, 3), X(0, 2);
    X(1, 4), X(1, 3), X(1, 2);
  }
#undef X
}

// `merge_lane` by a bitonic merge: the better of slot j and the partner's
// slot KMAX-1-j holds the KMAX best of both sorted lists as a bitonic
// sequence, which log2(KMAX) rounds of exchanges sort
__device__ __forceinline__ void merge_lane_bitonic(float (&tv)[KMAX], int (&ti)[KMAX], float& mx,
                                                   float& s, int off) {
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
  for (int j = 0; j < KMAX; ++j) {
    const bool theirs = better_nb(pv[KMAX - 1 - j], pi[KMAX - 1 - j], tv[j], ti[j]);
    tv[j] = theirs ? pv[KMAX - 1 - j] : tv[j];
    ti[j] = theirs ? pi[KMAX - 1 - j] : ti[j];
  }
#pragma unroll
  for (int d = KMAX / 2; d > 0; d /= 2)
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if ((j & d) == 0) exchange(tv[j], ti[j], tv[j + d], ti[j + d]);
}

// The warpgroup's 64 x BN logits fragment of tile (row0, col0), plus the
// bias, reduced to the tile's top-k and (max, sumexp) of each of its rows.
// Fragment layout (wgmma's D): warp w holds rows 16w..16w+15; d[4j + 2r + e]
// is row 16w + lane/4 + 8r, column 8j + 2(lane%4) + e. Each thread keeps the
// KL >= k best of its BN/4 columns of each of its two rows in registers
// (both rows at once, without branches: its columns rise with (j, e), so
// the first KL are sorted by a network and each later one is inserted by
// value alone); the best is the row's max over them, and the sum of exp
// follows. The 4 threads of a quad share the rows and merge their lists,
// padded to KMAX, by bitonic merges over shuffles; the quad's first writes.
// Columns >= V, the last of a thread's, enter as (-inf, NO_ID): after
// every real entry, and never inserted later.
template <int BN, int KL>
__device__ __forceinline__ void wgmma_epilogue(const float (&acc)[BN / 2], const float* bias,
                                               int row0, int col0, int tile, int G, int V, int k,
                                               int n_tiles, float* __restrict__ part_v,
                                               long long* __restrict__ part_i,
                                               float* __restrict__ part_m,
                                               float* __restrict__ part_s) {
  static_assert(2 * (BN / 8) > KL, "a thread's columns fill its list");
  constexpr float LOG2E = 1.4426950408889634f;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  const int n_cols = min(BN, V - col0);  // columns of this tile below V
  float tv[2][KL];
  int ti[2][KL];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = n + e < n_cols;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = in ? acc[4 * j + 2 * r + e] + (e ? bb.y : bb.x) : -INFINITY;
        const int id = in ? col0 + n + e : (int)NO_ID;
        if (2 * j + e < KL) {
          tv[r][2 * j + e] = v;
          ti[r][2 * j + e] = id;
          if (2 * j + e == KL - 1) sort_network<KL>(tv[r], ti[r]);
        } else {
          insert_later<KL>(tv[r], ti[r], v, id);
        }
      }
    }
  }
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float x = exp2f((acc[4 * j + 2 * r + e] + (e ? bb.y : bb.x) - tv[r][0]) * LOG2E);
        s[r] += n + e < n_cols ? x : 0.f;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lv[KMAX], mx = tv[r][0];
    int li[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      lv[j] = j < KL ? tv[r][j] : -INFINITY;
      li[j] = j < KL ? ti[r][j] : (int)NO_ID;
    }
    merge_lane_bitonic(lv, li, mx, s[r], 1);
    merge_lane_bitonic(lv, li, mx, s[r], 2);
    const int row = row0 + 16 * warp + g + 8 * r;
    if (t == 0 && row < G)
      write_part(lv, li, mx, s[r], row, tile, k, n_tiles, part_v, part_i, part_m, part_s);
  }
}

template <int BN, int KL>
__global__ void __launch_bounds__(W_THREADS, 1)
vh_wgmma_kernel(const __grid_constant__ CUtensorMap h_map,
                const __grid_constant__ CUtensorMap w_map, const float* __restrict__ b,
                float* __restrict__ part_v, long long* __restrict__ part_i,
                float* __restrict__ part_m, float* __restrict__ part_s, int G, int H, int V,
                int k) {
  constexpr int STAGES = w_stages<BN>();
  constexpr int STAGE_BYTES = w_stage_bytes<BN>();
  static_assert(STAGES >= 2 && STAGES <= W_MAX_STAGES, "ring");
  extern __shared__ unsigned char vh_smem[];
  const uint32_t raw = smem_addr(vh_smem);
  const uint32_t ring = (raw + W_ALIGN - 1) & ~uint32_t(W_ALIGN - 1);
  float* bias_all = reinterpret_cast<float*>(vh_smem + (ring - raw) + STAGES * STAGE_BYTES);
  const uint32_t full0 = ring + STAGES * STAGE_BYTES + W_BIAS_BYTES;  // full[i] at +8i
  const uint32_t empty0 = full0 + 8 * W_MAX_STAGES;
  const int MT = (G + W_BM - 1) / W_BM;
  const int n_tiles = (V + BN - 1) / BN;
  const int tiles = MT * n_tiles;
  const int KT = (H + W_BK - 1) / W_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);                 // the producer's expect_tx
      mbar_init(empty0 + 8 * i, 4 * W_CONSUMERS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == W_CONSUMERS) {
    // ---- producer: one thread issues every TMA load
    if constexpr (W_CONSUMERS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == W_CONSUMERS * 128) {
      prefetch_map(&h_map);
      prefetch_map(&w_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % MT) * W_BM, n0 = (tile / MT) * BN;
        // boxes wholly past G or V are not loaded: their rows and columns are never read
        const int a_boxes = min(W_CONSUMERS, (G - m0 + W_BOX - 1) / W_BOX);
        const int b_boxes = min(BN / W_BOX, (V - n0 + W_BOX - 1) / W_BOX);
        const uint32_t bytes = (a_boxes + b_boxes) * W_BOX_BYTES;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage, dst = ring + stage * STAGE_BYTES;
          mbar_expect_tx(full, bytes);
          for (int i = 0; i < a_boxes; ++i)
            tma_load(dst + i * W_BOX_BYTES, &h_map, kt * W_BK, m0 + i * W_BOX, full);
          for (int i = 0; i < b_boxes; ++i)
            tma_load(dst + W_A_BYTES + i * W_BOX_BYTES, &w_map, n0 + i * W_BOX, kt * W_BK, full);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of each tile
    if constexpr (W_CONSUMERS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, tw = threadIdx.x % 128;
    float* bias = bias_all + wg * 128;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile % MT) * W_BM + wg * 64, col0 = (tile / MT) * BN;
      named_bar(1 + wg);  // the previous tile's reads of the bias are done
      if (tw < BN) bias[tw] = col0 + tw < V ? b[col0 + tw] : 0.f;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] = 0.f;
        pin(acc[i]);
      }
      int prev = -1;
#pragma unroll 1
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a = ring + stage * STAGE_BYTES + wg * W_BOX_BYTES;
        const uint32_t bt = ring + stage * STAGE_BYTES + W_A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W_BK / 16; ++kk)  // 16 k: 32 bytes of an h row, 16 rows of w
          wgmma_bf16_tb<BN>(acc, sw128_desc(a + 32 * kk),
                            sw128_mn_desc(bt + 16 * 128 * kk, W_BOX_BYTES));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) pin(acc[i]);
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      named_bar(1 + wg);  // the tile's bias is written
      wgmma_epilogue<BN, KL>(acc, bias, row0, col0, tile / MT, G, V, k, n_tiles, part_v, part_i,
                             part_m, part_s);
    }
  }
}

template <int BN, int KL>
cudaError_t launch_wgmma(const CUtensorMap& hm, const CUtensorMap& wm, const float* b,
                         float* pv, long long* pi, float* pm, float* ps, int G, int H, int V,
                         int k, int blocks, cudaStream_t st) {
  // per device, so set once for each device this process launches on
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(vh_wgmma_kernel<BN, KL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, w_smem_bytes<BN>());
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  vh_wgmma_kernel<BN, KL><<<blocks, W_THREADS, w_smem_bytes<BN>(), st>>>(hm, wm, b, pv, pi, pm,
                                                                         ps, G, H, V, k);
  return cudaGetLastError();
}

// the kernel at tile width BN with lists of 5 (k <= 5: the beam-5 decode,
// greedy) or KMAX
template <int BN>
cudaError_t launch_wgmma_k(const CUtensorMap& hm, const CUtensorMap& wm, const float* b,
                           float* pv, long long* pi, float* pm, float* ps, int G, int H, int V,
                           int k, int blocks, cudaStream_t st) {
  return k <= 5 ? launch_wgmma<BN, 5>(hm, wm, b, pv, pi, pm, ps, G, H, V, k, blocks, st)
                : launch_wgmma<BN, KMAX>(hm, wm, b, pv, pi, pm, ps, G, H, V, k, blocks, st);
}

// The TMA map of bf16 rows [rows, cols], `pitch` elements apart (a multiple
// of 8 at least cols, the base 16-byte aligned), in boxes of 64 x 64 with
// 128-byte swizzle; reads past cols or rows are zero-filled
cudaError_t encode_bf16_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                            long long pitch) {
  if (rows < 1 || cols < 1 || pitch < cols || pitch % 8 ||
      reinterpret_cast<uintptr_t>(ptr) % 16)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * 2};
  const cuuint32_t box[2] = {W_BOX, W_BOX};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------ fp32 w: TF32 x 3

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

// Dynamic shared memory of one block of each form, in bytes (the wrapper's
// tile plans state the same numbers): the TF32x3 tiles, and the persistent
// wgmma kernel at tile width bn (64 or 128; -1 for another).
extern "C" int vocab_head_tf32x3_smem_bytes() { return F_SMEM_BYTES; }
extern "C" int vocab_head_wgmma_smem_bytes(int bn) {
  return bn == 64 ? w_smem_bytes<64>() : bn == 128 ? w_smem_bytes<128>() : -1;
}

// Bytes of a TMA map (CUtensorMap), and the map of bf16 rows [rows, cols]
// at ptr, `pitch` elements apart (encode_bf16_map), written to `map`: the
// wrapper encodes w's once per (pointer, shape, pitch) and keeps it.
extern "C" int vocab_head_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }
extern "C" int vocab_head_encode_map(void* map_out, const void* ptr, int rows, int cols,
                                     long long pitch) {
  CUtensorMap map;  // 64-byte aligned; map_out need not be
  const cudaError_t err = encode_bf16_map(&map, ptr, rows, cols, pitch);
  if (err == cudaSuccess) memcpy(map_out, &map, sizeof(map));
  return static_cast<int>(err);
}

// h [G, H] and w [H, V] bf16 (w_bf16 = 1), or h and w fp32 and contiguous;
// b [V] fp32; scratch part_v/part_i [G, n_tiles, k], part_m/part_s
// [G, n_tiles] with n_tiles = ceil(V / tile width); outputs vals [G, k]
// fp32, ids [G, k] int64, and, when lse is not null, the row logsumexp lse
// [G] fp32. bf16 runs the persistent TMA + wgmma kernel at tile width bn
// (64 or 128, kernels/vocab_head.py::vocab_head_plan) on `blocks` blocks,
// reading w through `w_map` (vocab_head_encode_map of w) and h through a
// map of its rows, h_pitch elements apart (a multiple of 8, h 16-byte
// aligned); `w` is not read. fp32 runs the 128-column TF32x3 tiles (bn 0).
// Returns the first nonzero cudaGetLastError() of the launches.
extern "C" int vocab_head_topk_launch(const void* h, const void* w, int w_bf16,
                                      const void* b, void* part_v, void* part_i,
                                      void* part_m, void* part_s, void* vals, void* ids,
                                      int G, int H, int V, int k, int normalize,
                                      void* stream, void* lse, int bn, int blocks,
                                      const void* w_map, long long h_pitch) {
  if (k < 1 || k > KMAX || G < 1 || V < 1 || H < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + (w_bf16 ? bn : BN) - 1) / (w_bf16 ? bn : BN);
  const float* bp = static_cast<const float*>(b);
  float* pv = static_cast<float*>(part_v);
  long long* pi = static_cast<long long*>(part_i);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  cudaError_t err = cudaSuccess;
  if (w_bf16) {
    if ((bn != 64 && bn != 128) || blocks < 1 || w_map == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap hm, wm;  // by value into the kernel's parameters (__grid_constant__)
    err = encode_bf16_map(&hm, h, G, H, h_pitch);
    if (err != cudaSuccess) return static_cast<int>(err);
    memcpy(&wm, w_map, sizeof(wm));  // w_map need not be 64-byte aligned
    err = bn == 64 ? launch_wgmma_k<64>(hm, wm, bp, pv, pi, pm, ps, G, H, V, k, blocks, st)
                   : launch_wgmma_k<128>(hm, wm, bp, pv, pi, pm, ps, G, H, V, k, blocks, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    if (bn) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(tf32x3_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F_SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int aligned = H % 4 == 0 && V % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const dim3 grid((G + F_BM - 1) / F_BM, n_tiles);
    tf32x3_tile_kernel<<<grid, THREADS, F_SMEM_BYTES, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), bp, pv, pi, pm, ps, G, H, V,
        k, n_tiles, aligned);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<(G + 7) / 8, 256, 0, st>>>(pv, pi, pm, ps, static_cast<float*>(vals),
                                            static_cast<long long*>(ids),
                                            static_cast<float*>(lse), G, k, n_tiles, normalize);
  return static_cast<int>(cudaGetLastError());
}
