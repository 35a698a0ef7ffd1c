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
//   1. a kernel over the (row tile, vocab tile) pairs: for each, the fp32
//      logits tile plus the bias, columns >= V skipped (no padded copy of
//      w), reduced to the tile's top-k (value, id) and each row's (max, sum
//      exp(x - max)) over the tile, written to scratch;
//   2. merge_kernel, one warp per row: picks the k best of the per-tile lists
//      and combines the lse as M + log(sum_j s_j exp(m_j - M)), which it also
//      writes out when asked (a vocab head split over ranks merges the ranks'
//      top-k and lse after this launch, evaluation/decode.py).
// The first launch is one persistent warp-specialized kernel,
// vh_wgmma_kernel<TF32, BN, KL>, with two routes by w's dtype
// (kernels/vocab_head.py::vocab_head_plan), which share everything but the
// k-loop's products:
//   - the walk: at most one block per SM walks output tiles of 128 rows x
//     BN columns (BN 64 or 128, the plan's), the row tile the fast index, so
//     the blocks at work together share a few w column tiles in L2. One
//     thread of a producer warpgroup (its registers lowered with setmaxnreg)
//     keeps a ring of stages full by TMA (128-byte swizzle). A stage is 128
//     rows of h, each one 128-byte row of k (64 bf16 or 32 fp32; K-major),
//     and BN columns of w as 128-byte rows, once (bf16) or twice (fp32: hi
//     and lo). Two consumer warpgroups, 64 rows each, run wgmma m64nBNkK and
//     release each stage as its products finish. h is read through a TMA map
//     of its rows at a pitch of its own (a multiple of 16 bytes, as TMA
//     needs: the wrapper copies h into such rows where it is not). Rows past
//     G and columns past V are zero-filled by TMA (boxes wholly past them are
//     skipped) and never written; k past H reads zeros.
//   - the epilogue runs from the accumulators, whose fragment layout is the
//     same for both input types: the tile's bias staged in shared memory
//     once, then per row (a quad of 4 threads shares one) a top-5 (k <= 5)
//     or top-8 in each thread without branches (a sorting network over its
//     first columns, each later one inserted by value alone: the ids rise),
//     the sum of exp(x - max) after it, merged across the quad by bitonic
//     merges over shuffles. The producer loads the next tile meanwhile, as
//     far as the ring reaches.
//   - bf16 w (route "wgmma"), any H and V: w [H, V] as the decoder keeps it
//     in rows of ceil8(V) once per decode (Decoder.vocab_head_weights), so
//     its tiles are MN-major: [64 x BN] bf16 read by wgmma's transpose-B for
//     16-bit types with an MN-major descriptor (8-row k groups 1024 bytes
//     apart, the 64-column TMA boxes 8192 bytes apart); wgmma m64nBNk16 bf16
//     -> fp32 from shared memory with one group in flight. h is rounded to
//     bf16 once by the wrapper (as the TPU kernel casts h to w's dtype).
//   - fp32 w (route "wgmma_tf32"): the fp32 product on the TF32 tensor
//     cores. One TF32 pass would not do: it rounds both operands to 11
//     significant bits, and at K1's operands (h = tanh(N(0, 1)), w
//     xavier-normal, H = 1536, logits up to 1.58) its error against a
//     float64 product is 4.6e-4, where a plain fp32 product's is 6.9e-7. So
//     each operand x is split, hi = tf32(x) and lo = tf32(x - hi) (round half
//     away; x - hi is exact), and each k8 step issues hi*lo, lo*hi, then
//     hi*hi. Only lo*lo (2^-22 of x*y) and the rounding of lo (2^-22 of x)
//     are dropped: with exact sums the three products are 1.2e-7 from
//     float64. The sums are not exact: the tensor core rounds each product's
//     fp32 sum toward zero. Summed that way over the 576 products (192 k8
//     steps x 3) of an output, the bias reaches 2.5e-5 in a numpy emulation
//     (1.5e-6 if it rounded to nearest), and 2.04e-5 on an H100 (warp-level
//     TF32 products into one accumulator). So the 12 products of each 32-deep
//     k-tile (one stage) go into fresh accumulators, the first with scale-d
//     0, and are added to the tile's accumulators with round-to-nearest adds
//     (64 + 64 registers a thread at BN = 128): 6.7e-7 in the emulation.
//     TF32 wgmma reads both operands K-major (it has no transpose for 32-bit
//     types), so w is split once per decode by tf32_split_kernel into hi
//     and lo [V, ceil4(H)] (TF32 bit patterns, K-major, zeros past H; the
//     parts [2, V, ceil4(H)] behind one 3-D TMA map), which the decoder keeps
//     for the decode (kernels/vocab_head.py::split_head); a bare fp32 w is
//     split in the call. h is split in registers: the consumers read their
//     A fragments (fp32) from the stage, split them and issue register-A
//     wgmma m64nBNk8 tf32, so a stage holds h once (48 KB at BN = 128: 4
//     stages), and no launch splits h. The rounding is an integer add and
//     mask with a NaN kept a NaN (the add alone turns CUDA's canonical NaN
//     into -0), inf and NaN taking lo = 0: the plain version
//     (kernels/vocab_head.py::tf32_split_plain) is the same integer
//     arithmetic, bitwise. What bounds it: at G = 640 the three products
//     (59 GFLOP at 495 TFLOP/s, 119 us) against 123 MB of split w (37 us):
//     operations; at the first beam step's G = 128 the bytes (37 us against
//     24 us). A stage brings 48 KB from L2 for 1.6 M multiply-adds, the
//     bf16 route's 32 per byte, at half the bf16 rate: half its L2 -> SM
//     traffic a second.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int KMAX = 8;
constexpr long long NO_ID = 0x7fffffffLL;  // id of an empty slot
constexpr unsigned FULL = 0xffffffffu;

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

// ------------------------------------------------------ the TF32 split

constexpr uint32_t TF32_NAN = 0x7fffe000u;  // the split's one NaN

// x rounded to TF32 (10 fraction bits), half away from zero, as an fp32 bit
// pattern with the 13 low bits zero; a NaN gives TF32_NAN (the add alone
// would carry CUDA's canonical NaN 0x7fffffff into -0)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return x != x ? TF32_NAN : (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (2^-22 |x| at most), hi and lo TF32; an inf or NaN hi (x
// inf, NaN, or rounded up past the largest float) takes lo = 0
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = (hi & 0x7f800000u) == 0x7f800000u ? 0u : tf32_rna(x - __uint_as_float(hi));
}

constexpr int S_TILE = 32;  // the split's tiles: 32 k x 32 columns, 32 x 8 threads

// w [H, V] fp32 at element strides (sk, sn) -> parts [2][V][Hp]: hi and lo
// of w's column n in row n of each part, k contiguous, zeros for k in
// [H, Hp). Through a 32 x 33 shared tile, so that both the reads (along
// whichever of k and n is contiguous) and the writes (along k) coalesce.
__global__ void __launch_bounds__(S_TILE * 8)
tf32_split_kernel(const float* __restrict__ w, long long sk, long long sn, int H, int V, int Hp,
                  uint32_t* __restrict__ parts) {
  __shared__ float tile[S_TILE][S_TILE + 1];  // [n][k]
  const int k0 = blockIdx.x * S_TILE, n0 = blockIdx.y * S_TILE;
  const bool n_fast = sn < sk;
  for (int j = threadIdx.y; j < S_TILE; j += 8) {
    const int dk = n_fast ? j : threadIdx.x, dn = n_fast ? threadIdx.x : j;
    const int kk = k0 + dk, n = n0 + dn;
    tile[dn][dk] = kk < H && n < V ? w[kk * sk + n * sn] : 0.f;
  }
  __syncthreads();
  const int kk = k0 + threadIdx.x;
  for (int j = threadIdx.y; j < S_TILE; j += 8) {
    const int n = n0 + j;
    if (n < V && kk < Hp) {
      uint32_t hi, lo;
      split_tf32(tile[j][threadIdx.x], hi, lo);
      parts[(size_t)n * Hp + kk] = hi;
      parts[((size_t)V + n) * Hp + kk] = lo;
    }
  }
}

// --------------------------------- the persistent TMA + wgmma kernel

constexpr int W_CONSUMERS = 2;  // consumer warpgroups, 64 rows of a tile each
constexpr int W_BM = 64 * W_CONSUMERS;
constexpr int W_ROW = 128;  // bytes of k a stage holds a row: 64 bf16 or 32 fp32
constexpr int W_BOX = 64;   // TMA boxes: 64 rows of W_ROW bytes
constexpr int W_BOX_BYTES = W_BOX * W_ROW;
constexpr int W_A_BYTES = W_BM * W_ROW;
constexpr int W_RING_BYTES = 196608;  // bf16: 6 stages at BN 128, 8 at 64; fp32: 4, 6
constexpr int W_MAX_STAGES = 8;
constexpr int W_ALIGN = 1024;  // the ring starts 1024-aligned (128-byte swizzle)
constexpr int W_BIAS_BYTES = W_CONSUMERS * 128 * 4;  // each warpgroup's tile of bias
constexpr int W_BAR_BYTES = 2 * W_MAX_STAGES * 8;
constexpr int W_THREADS = 128 * (W_CONSUMERS + 1);

// a stage: 128 rows of h and BN rows of w (bf16) or of its hi and lo (fp32)
template <bool TF32, int BN>
__host__ __device__ constexpr int w_stage_bytes() { return W_A_BYTES + (TF32 ? 2 : 1) * BN * W_ROW; }

template <bool TF32, int BN>
__host__ __device__ constexpr int w_stages() {
  return W_RING_BYTES / w_stage_bytes<TF32, BN>() < W_MAX_STAGES
             ? W_RING_BYTES / w_stage_bytes<TF32, BN>()
             : W_MAX_STAGES;
}

template <bool TF32, int BN>
__host__ __device__ constexpr int w_smem_bytes() {
  return W_ALIGN + w_stages<TF32, BN>() * w_stage_bytes<TF32, BN>() + W_BIAS_BYTES + W_BAR_BYTES;
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

// d (64 x BN fp32) = d * (scale_d != 0) + a (64 x 8 tf32, the warpgroup's
// register fragment) * b (8 x BN tf32, K-major, from shared memory). The
// wgmma reads a's registers until it retires: in-out operands, pinned by
// the caller after the wait that retires it.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint32_t (&a)[4], uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint32_t (&a)[4], uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), "+r"(a[0]), "+r"(a[1]),
        "+r"(a[2]), "+r"(a[3])
      : "l"(b), "r"(scale_d));
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


template <bool TF32, int BN, int KL>
__global__ void __launch_bounds__(W_THREADS, 1)
vh_wgmma_kernel(const __grid_constant__ CUtensorMap h_map,
                const __grid_constant__ CUtensorMap w_map, const float* __restrict__ b,
                float* __restrict__ part_v, long long* __restrict__ part_i,
                float* __restrict__ part_m, float* __restrict__ part_s, int G, int H, int V,
                int k) {
  constexpr int STAGES = w_stages<TF32, BN>();
  constexpr int STAGE_BYTES = w_stage_bytes<TF32, BN>();
  constexpr int BK = TF32 ? 32 : 64;  // k a stage: one 128-byte row of h
  constexpr int W_PARTS = TF32 ? 2 : 1;  // w tiles a stage: hi and lo, or w
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
  const int KT = (H + BK - 1) / BK;
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
        const uint32_t bytes = (a_boxes + W_PARTS * b_boxes) * W_BOX_BYTES;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage, dst = ring + stage * STAGE_BYTES;
          mbar_expect_tx(full, bytes);
          for (int i = 0; i < a_boxes; ++i)
            tma_load(dst + i * W_BOX_BYTES, &h_map, kt * BK, m0 + i * W_BOX, full);
          for (int i = 0; i < b_boxes; ++i) {
            const uint32_t wt = dst + W_A_BYTES + i * W_BOX_BYTES;
            if constexpr (TF32) {  // rows n0 + 64 i.. of hi (part 0) and of lo (part 1)
              tma_load_3d(wt, &w_map, kt * BK, n0 + i * W_BOX, 0, full);
              tma_load_3d(wt + BN * W_ROW, &w_map, kt * BK, n0 + i * W_BOX, 1, full);
            } else {
              tma_load(wt, &w_map, n0 + i * W_BOX, kt * BK, full);
            }
          }
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
    float part[TF32 ? BN / 2 : 1];  // fp32: one k-tile's products
#pragma unroll
    for (int i = 0; i < (TF32 ? BN / 2 : 1); ++i) part[i] = 0.f;
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
      if constexpr (TF32) {
        // this thread's A fragment rows in the stage's 128-byte-swizzled h
        // box: 16 warp + g and 8 below; k chunk c of a row lies at chunk c ^ g
        const int g = lane / 4, t = lane % 4;
        const unsigned char* a_rows = vh_smem + (ring - raw) + wg * W_BOX_BYTES +
                                      (16 * (tw / 32) + g) * W_ROW + 4 * t;
#pragma unroll 1
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(full0 + 8 * stage, phase);
          const unsigned char* a_s = a_rows + stage * STAGE_BYTES;
          const uint32_t wh = ring + stage * STAGE_BYTES + W_A_BYTES, wl = wh + BN * W_ROW;
          uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // (row g + 8 (i & 1), k 8 kk + t + 4 (i >> 1))
              const float x = *reinterpret_cast<const float*>(
                  a_s + (i & 1) * 8 * W_ROW + (((2 * kk + (i >> 1)) ^ g) << 4));
              split_tf32(x, ah[kk][i], al[kk][i]);
            }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {  // 8 k: 32 bytes of each 128-byte row
            wgmma_tf32<BN>(part, ah[kk], sw128_desc(wl + 32 * kk), kk);  // kk 0: fresh sums
            wgmma_tf32<BN>(part, al[kk], sw128_desc(wh + 32 * kk), 1);
            wgmma_tf32<BN>(part, ah[kk], sw128_desc(wh + 32 * kk), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              pin(ah[kk][i]);
              pin(al[kk][i]);
            }
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) pin(part[i]);
          if (lane == 0) mbar_arrive(empty0 + 8 * stage);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];  // round to nearest
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      } else {
        int prev = -1;
#pragma unroll 1
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint32_t a = ring + stage * STAGE_BYTES + wg * W_BOX_BYTES;
          const uint32_t bt = ring + stage * STAGE_BYTES + W_A_BYTES;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)  // 16 k: 32 bytes of an h row, 16 rows of w
            wgmma_bf16_tb<BN>(acc, sw128_desc(a + 32 * kk),
                              sw128_mn_desc(bt + 16 * W_ROW * kk, W_BOX_BYTES));
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
      }
      named_bar(1 + wg);  // the tile's bias is written
      wgmma_epilogue<BN, KL>(acc, bias, row0, col0, tile / MT, G, V, k, n_tiles, part_v, part_i,
                             part_m, part_s);
    }
  }
}

template <bool TF32, int BN, int KL>
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
    err = cudaFuncSetAttribute(vh_wgmma_kernel<TF32, BN, KL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               w_smem_bytes<TF32, BN>());
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  vh_wgmma_kernel<TF32, BN, KL><<<blocks, W_THREADS, w_smem_bytes<TF32, BN>(), st>>>(
      hm, wm, b, pv, pi, pm, ps, G, H, V, k);
  return cudaGetLastError();
}

// the kernel at tile width bn (64 or 128) with lists of 5 (k <= 5: the
// beam-5 decode, greedy) or KMAX
template <bool TF32>
cudaError_t launch_route(const CUtensorMap& hm, const CUtensorMap& wm, const float* b, float* pv,
                         long long* pi, float* pm, float* ps, int G, int H, int V, int k, int bn,
                         int blocks, cudaStream_t st) {
  if (bn == 64)
    return k <= 5 ? launch_wgmma<TF32, 64, 5>(hm, wm, b, pv, pi, pm, ps, G, H, V, k, blocks, st)
                  : launch_wgmma<TF32, 64, KMAX>(hm, wm, b, pv, pi, pm, ps, G, H, V, k, blocks, st);
  return k <= 5 ? launch_wgmma<TF32, 128, 5>(hm, wm, b, pv, pi, pm, ps, G, H, V, k, blocks, st)
                : launch_wgmma<TF32, 128, KMAX>(hm, wm, b, pv, pi, pm, ps, G, H, V, k, blocks, st);
}

// The TMA map of rows [rows, cols] of 2-byte (bf16) or 4-byte (fp32)
// elements, `pitch` elements apart (pitch >= cols, 16-byte multiples, the
// base 16-byte aligned), in boxes of 64 rows x 128 bytes with 128-byte
// swizzle; reads past cols or rows are zero-filled
cudaError_t encode_rows_map(CUtensorMap* map, const void* ptr, int esize, int rows, int cols,
                            long long pitch) {
  if (rows < 1 || cols < 1 || pitch < cols || pitch * esize % 16 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 || (esize != 2 && esize != 4))
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(W_ROW / esize), W_BOX};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
      const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA map of a split w's parts [2][V][Hp] (TF32 bit patterns as fp32,
// Hp a multiple of 4, the base 16-byte aligned): boxes of 64 rows x 32 k of
// one part, 128-byte swizzle; rows past V are zero-filled
cudaError_t encode_parts_map(CUtensorMap* map, const void* ptr, int V, int Hp) {
  if (V < 1 || Hp < 4 || Hp % 4 || reinterpret_cast<uintptr_t>(ptr) % 16)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Hp), static_cast<cuuint64_t>(V), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Hp) * 4,
                                 static_cast<cuuint64_t>(V) * Hp * 4};
  const cuuint32_t box[3] = {W_ROW / 4, W_BOX, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

// Dynamic shared memory of one block of the persistent kernel at tile width
// bn (64 or 128) for bf16 w (tf32 = 0) or a split fp32 w (tf32 = 1); -1 for
// another width (the wrapper's tile plans state the same numbers).
extern "C" int vocab_head_wgmma_smem_bytes(int bn, int tf32) {
  if (bn == 64) return tf32 ? w_smem_bytes<true, 64>() : w_smem_bytes<false, 64>();
  if (bn == 128) return tf32 ? w_smem_bytes<true, 128>() : w_smem_bytes<false, 128>();
  return -1;
}

// Bytes of a TMA map (CUtensorMap); the map of bf16 rows [rows, cols] at
// ptr, `pitch` elements apart (encode_rows_map), and that of a split w's
// parts [2][V][Hp] (encode_parts_map), written to `map_out`: the wrapper
// encodes w's once (per (pointer, shape, pitch), or per split) and keeps it.
extern "C" int vocab_head_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }
extern "C" int vocab_head_encode_map(void* map_out, const void* ptr, int rows, int cols,
                                     long long pitch) {
  CUtensorMap map;  // 64-byte aligned; map_out need not be
  const cudaError_t err = encode_rows_map(&map, ptr, 2, rows, cols, pitch);
  if (err == cudaSuccess) memcpy(map_out, &map, sizeof(map));
  return static_cast<int>(err);
}
extern "C" int vocab_head_encode_split_map(void* map_out, const void* parts, int V, int Hp) {
  CUtensorMap map;
  const cudaError_t err = encode_parts_map(&map, parts, V, Hp);
  if (err == cudaSuccess) memcpy(map_out, &map, sizeof(map));
  return static_cast<int>(err);
}

// fp32 w [H, V] at element strides (sk, sn) -> parts [2][V][Hp] (hi, lo;
// Hp >= H a multiple of 4, zeros past H), tf32_split_kernel on `stream`.
// Returns cudaGetLastError().
extern "C" int vocab_head_split_launch(const void* w, long long sk, long long sn, int H, int V,
                                       int Hp, void* parts, void* stream) {
  if (H < 1 || V < 1 || Hp < H || Hp % 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Hp + S_TILE - 1) / S_TILE, (V + S_TILE - 1) / S_TILE);
  tf32_split_kernel<<<grid, dim3(S_TILE, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), sk, sn, H, V, Hp, static_cast<uint32_t*>(parts));
  return static_cast<int>(cudaGetLastError());
}

// h [G, H] bf16 (tf32 = 0) or fp32 (tf32 = 1), its rows h_pitch elements
// apart (16-byte multiples, h 16-byte aligned); w through `w_map`: bf16 w
// [H, V] (vocab_head_encode_map) or a split fp32 w's parts
// (vocab_head_encode_split_map); b [V] fp32; scratch part_v/part_i
// [G, n_tiles, k], part_m/part_s [G, n_tiles] with n_tiles = ceil(V / bn);
// outputs vals [G, k] fp32, ids [G, k] int64, and, when lse is not null,
// the row logsumexp lse [G] fp32. Runs the persistent kernel at tile width
// bn (64 or 128, kernels/vocab_head.py::vocab_head_plan) on `blocks`
// blocks, then the merge. Returns the first nonzero cudaGetLastError() of
// the launches.
extern "C" int vocab_head_topk_launch(const void* h, int tf32, const void* b, void* part_v,
                                      void* part_i, void* part_m, void* part_s, void* vals,
                                      void* ids, int G, int H, int V, int k, int normalize,
                                      void* stream, void* lse, int bn, int blocks,
                                      const void* w_map, long long h_pitch) {
  if (k < 1 || k > KMAX || G < 1 || V < 1 || H < 1 || (bn != 64 && bn != 128) || blocks < 1 ||
      w_map == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + bn - 1) / bn;
  const float* bp = static_cast<const float*>(b);
  float* pv = static_cast<float*>(part_v);
  long long* pi = static_cast<long long*>(part_i);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  CUtensorMap hm, wm;  // by value into the kernel's parameters (__grid_constant__)
  cudaError_t err = encode_rows_map(&hm, h, tf32 ? 4 : 2, G, H, h_pitch);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(&wm, w_map, sizeof(wm));  // w_map need not be 64-byte aligned
  err = tf32 ? launch_route<true>(hm, wm, bp, pv, pi, pm, ps, G, H, V, k, bn, blocks, st)
             : launch_route<false>(hm, wm, bp, pv, pi, pm, ps, G, H, V, k, bn, blocks, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<(G + 7) / 8, 256, 0, st>>>(pv, pi, pm, ps, static_cast<float*>(vals),
                                            static_cast<long long*>(ids),
                                            static_cast<float*>(lse), G, k, n_tiles, normalize);
  return static_cast<int>(cudaGetLastError());
}
