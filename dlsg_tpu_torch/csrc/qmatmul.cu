// Int8 product with dynamic per-row activation scales:
//   out[g, n] = float(sum_k xq[g, k] * q[k, n]) * sx[g] * s[n]
// with sx = max(max_k |x[g, k]| * (1/127 in fp32), 1e-12) and
// xq = clip(rint(x / sx), -127, 127). The product by the fp32 reciprocal is
// what XLA makes of the JAX source's division by 127 under jit.
//
// Replaces dlsg_tpu/ops/quant.py::qmatmul (:35-47). That is no Pallas kernel:
// on the TPU it is an XLA dot_general int8 x int8 -> int32 on the MXU, with the
// row quantization and the rescale as XLA elementwise ops around it.
//
// What bounds it on the card: at the int8 decode's shapes (G = 640 rows of a
// beam-5 step over 128 clips; K x N = 2860 x 4096, 4608 x 6144, 1536 x 10000)
// the product is 15-36 GOP at the tensor cores' int8 rate (1979 TOP/s dense)
// against 30-56 MB to move (x in fp32, the int8 weight, the fp32 output) at
// 3.35 TB/s: 8.8, 18.3 and 13.4 us, Wl bound by operations, Wq and Wv by
// bytes. At G = 128 (the first beam step) bytes bound all three. Measured on
// an H100 SXM (PERF.md), the tile kernel's mainloop is bound before either
// by the ring's fills from L2 (~8.4 TB/s of them at G = 640).
//
// Design: two launches.
//   1. quantize_rows_kernel, one block of 256 threads per row of x [G, K]
//      (fp32 or bf16, read as it is), 16 values a thread a step in 16-byte
//      loads where K and the pointer allow: the row's absmax (shuffles, then
//      across the warps), sx, then xq [G, Kp] int8 from the values kept in
//      registers (rows of up to 8192) in 16-byte stores, Kp = K rounded up
//      to K_ALIGN and the tail zero. rint(x / sx) (round half to even, as
//      torch.round and jnp.round) of the IEEE quotient keeps it bitwise
//      equal to the plain version; the quotient is a product by 1 / sx
//      where that provably gives the same integer (store16), else the IEEE
//      division. No __fdividef, no --use_fast_math. It is latency-bound
//      (load, a block reduction, then compute): staging rows by bulk copies
//      under the next row's compute measured slower.
//   2. qmm_wgmma_kernel<BN>, a persistent warp-specialized kernel: one block
//      per SM at most (the plan in kernels/qmatmul.py picks BN and the block
//      count), each walking output tiles of BM x BN with the row tile as the
//      fast index, so the blocks at work at any moment share a few weight
//      column tiles and the weight crosses device memory about once. A
//      producer warpgroup (registers lowered with setmaxnreg, one thread at
//      work) keeps a ring of STAGES tiles, each [BM x 128] of xq and [BN x 128]
//      of qt, filled by TMA (2-D tensor maps, 128-byte swizzle, boxes of 64
//      rows of xq and 32 of qt, 128 bytes deep; zero fill past G, N and Kp)
//      and signalled through mbarriers. Two consumer warpgroups, 64 rows
//      each, run wgmma m64nBNk32 (BN a multiple of 32 from 64 to 256)
//      s8 x s8 -> s32 from shared memory (both operands K-major, as int8
//      needs: the weight arrives transposed, qt [N, Kp], from the wrapper's
//      once-per-decode packing), one wgmma group in flight, and release each
//      slot as its products finish. Their epilogue stages the tile's column
//      scales in shared memory (one wait on device memory a tile, not one a
//      piece), rescales float(acc) * sx[row] * s[col], in that order, stages
//      64 x 32 fp32 pieces in shared memory and writes them back with 16-byte
//      stores (one row's 128 bytes per eight threads) while the producer
//      already loads the next tile.
//      int8 x int8 -> int32 is exact (|sum| <= 127^2 K < 2^31 for the K the
//      plan takes), so the output equals the plain version's bitwise.
// The tensor maps are built on the host (cuTensorMapEncodeTiled, found with
// cudaGetDriverEntryPoint, so the library links no libcuda): the weight's
// once per (pointer, N, Kp), the scratch xq's once per scratch buffer, both
// cached by the wrapper.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int K_ALIGN = 32;   // Kp = K rounded up; kernels/qmatmul.py::K_ALIGN
constexpr int CONSUMERS = 2;  // consumer warpgroups, 64 output rows each
constexpr int BM = 64 * CONSUMERS;
constexpr int BK = 128;  // k bytes per ring stage: one 128-byte swizzle row
constexpr int A_BOX_ROWS = 64;  // TMA box rows of xq: one consumer warpgroup's rows
constexpr int B_BOX_ROWS = 32;  // of qt: tile widths are multiples of 32
constexpr int A_BYTES = BM * BK;
constexpr int RING_BYTES = 196608;  // 4 stages at BN 256, 5 at 160, 6 at 128, 8 at 64
constexpr int MAX_STAGES = 8;
constexpr int EPI_COLS = 32;         // output columns per staged piece
constexpr int EPI_STRIDE = EPI_COLS + 8;  // floats a staged row: float2 writes hit 32 banks
constexpr int EPI_BYTES = CONSUMERS * 64 * EPI_STRIDE * 4;
constexpr int SCALE_BYTES = CONSUMERS * 256 * 4;  // each warpgroup's tile of column scales
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;
constexpr int ALIGN_SLACK = 1024;  // the ring starts 1024-aligned (128-byte swizzle)
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int QUANT_THREADS = 256;  // quantize kernel: one block a row
constexpr int QUANT_HELD = 2;       // 16-value steps a thread keeps in registers
constexpr unsigned FULL = 0xffffffffu;

template <int BN>
__host__ __device__ constexpr int stages_for() {
  return RING_BYTES / ((BM + BN) * BK) < MAX_STAGES ? RING_BYTES / ((BM + BN) * BK) : MAX_STAGES;
}

template <int BN>
__host__ __device__ constexpr int smem_bytes_for() {
  return ALIGN_SLACK + stages_for<BN>() * (BM + BN) * BK + EPI_BYTES + SCALE_BYTES + BAR_BYTES;
}

// max with NaN kept, as torch's amax
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// 16 consecutive values of row `xr` from column k0 as fp32, zero at k >= K;
// `vec`: K and the row pointer allow 16-byte loads (each wholly in or out)
__device__ __forceinline__ void load16(const float* xr, int k0, int K, bool vec, float (&v)[16]) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = k0 + 4 * i < K ? *reinterpret_cast<const float4*>(xr + k0 + 4 * i)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = k0 + e < K ? xr[k0 + e] : 0.f;
  }
}

// bf16 widened exactly (its bits are the top half of the fp32's)
__device__ __forceinline__ float bf16_bits(uint32_t h) { return __uint_as_float(h << 16); }

__device__ __forceinline__ void load16(const uint16_t* xr, int k0, int K, bool vec, float (&v)[16]) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 u = k0 + 8 * i < K ? *reinterpret_cast<const uint4*>(xr + k0 + 8 * i)
                                     : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[8 * i + 2 * j] = bf16_bits(w[j] & 0xffffu);
        v[8 * i + 2 * j + 1] = bf16_bits(w[j] >> 16);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = k0 + e < K ? bf16_bits(xr[k0 + e]) : 0.f;
  }
}

// xq[k0 .. k0 + 16) of a row: clip(rint(v / scale), -127, 127), zero at k >= K
// (where load16 gave v = 0), in one 16-byte store. The quotient is taken as
// p = v * r, r = 1 / scale rounded (`fast`: r normal), where that provably
// rounds to the same integer as the IEEE quotient: two roundings of 2^-24
// each put p within |p| 2^-22 of v / scale, and that one's rounding within
// |p| 2^-24 more, so where p lies farther than |p| 2^-21 from the rounding
// boundaries (the half-integers) rint gives one integer for both. A chunk
// with a value nearer (a tie, about one in 10^4), a NaN or an inf takes the
// IEEE division v / scale instead: bitwise the plain version either way.
__device__ __forceinline__ void store16(int8_t* qr, int k0, int K, float scale, float r, bool fast,
                                        const float (&v)[16]) {
  float q[16];
  bool ok = fast;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float p = v[e] * r;
    q[e] = rintf(p);
    ok &= 0.5f - fabsf(p - q[e]) > fabsf(p) * 0x1p-21f;
  }
  if (!ok) {
#pragma unroll
    for (int e = 0; e < 16; ++e) q[e] = k0 + e < K ? rintf(v[e] / scale) : 0.f;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const float c = fminf(fmaxf(q[e], -127.f), 127.f);
    w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(c))) << (8 * (e % 4));
  }
  *reinterpret_cast<uint4*>(qr + k0) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                     int K, int Kp, int vec) {
  const int chunks = Kp / 16;  // 16-value steps of a row
  __shared__ float warp_max[QUANT_THREADS / 32];
  const int row = blockIdx.x, lane = threadIdx.x % 32;  // one block per row
  const T* xr = x + (size_t)row * K;
  // a row of up to QUANT_HELD steps a thread stays in registers from its one
  // read to its store; a longer row is read again (from L1) to store it
  const bool held = chunks <= QUANT_HELD * QUANT_THREADS;
  float v[QUANT_HELD][16];
  float m = 0.f;
  if (held) {
#pragma unroll
    for (int h = 0; h < QUANT_HELD; ++h) {
      const int c = threadIdx.x + h * QUANT_THREADS;
      if (c < chunks) load16(xr, 16 * c, K, vec, v[h]);
    }
#pragma unroll
    for (int h = 0; h < QUANT_HELD; ++h)
      if (threadIdx.x + h * QUANT_THREADS < chunks)
#pragma unroll
        for (int e = 0; e < 16; ++e) m = nan_max(fabsf(v[h][e]), m);
  } else {
    for (int c = threadIdx.x; c < chunks; c += QUANT_THREADS) {
      load16(xr, 16 * c, K, vec, v[0]);
#pragma unroll
      for (int e = 0; e < 16; ++e) m = nan_max(fabsf(v[0][e]), m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(__shfl_xor_sync(FULL, m, off), m);
  if (lane == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < QUANT_THREADS / 32; ++w) m = nan_max(warp_max[w], m);
  float scale = m * (1.0f / 127.0f);                      // as XLA's rewrite of `/ 127.0`
  scale = scale != scale ? scale : fmaxf(scale, 1e-12f);  // clamp_min keeps NaN
  if (threadIdx.x == 0) sx[row] = scale;
  const float r = 1.0f / scale;
  const bool fast = r >= 0x1p-126f && r <= 0x1.fffffep127f;  // normal (not NaN, 0 or inf)
  int8_t* qr = xq + (size_t)row * Kp;
  if (held) {
#pragma unroll
    for (int h = 0; h < QUANT_HELD; ++h) {
      const int c = threadIdx.x + h * QUANT_THREADS;
      if (c < chunks) store16(qr, 16 * c, K, scale, r, fast, v[h]);
    }
  } else {
    for (int c = threadIdx.x; c < chunks; c += QUANT_THREADS) {
      load16(xr, 16 * c, K, vec, v[0]);
      store16(qr, 16 * c, K, scale, r, fast, v[0]);
    }
  }
}

#define D8(i)                                                                                \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x BN s32, the warpgroup's fragment) += a (64 x 32 s8) * b (BN x 32 s8)^T,
// both from shared memory through descriptors
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<160>(int (&d)[80], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<192>(int (&d)[96], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72), D8(80),
        D8(88)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<224>(int (&d)[112], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72), D8(80),
        D8(88), D8(96), D8(104)
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72), D8(80),
        D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(a), "l"(b), "r"(1));
}

#undef D8

// The warpgroup's 64 x BN fragment of tile (m0, n0) rescaled and written to
// out: 64 x EPI_COLS pieces through the warpgroup's staging area `epi`.
// Fragment layout (wgmma's D): warp w holds rows 16w..16w+15; in each n8 block
// j, d[4j], d[4j+1] are row 16w + lane/4, columns 8j + 2(lane%4) + {0, 1}, and
// d[4j+2], d[4j+3] the same columns 8 rows down.
template <int BN>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], float* epi, float* s_tile,
                                           int bar_id, const float* __restrict__ sx,
                                           const float* __restrict__ s, float* __restrict__ out,
                                           int m0, int n0, int G, int N) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4, c0 = 2 * (lane % 4);
  const bool vec = N % 4 == 0;
  named_bar(bar_id);  // the previous tile's reads of s_tile and epi are done
  // the tile's column and row scales, each from device memory once: one wait
  for (int i = t; i < BN; i += 128) s_tile[i] = n0 + i < N ? s[n0 + i] : 0.f;
  const float rs0 = m0 + r0 < G ? sx[m0 + r0] : 0.f;
  const float rs1 = m0 + r0 + 8 < G ? sx[m0 + r0 + 8] : 0.f;
#pragma unroll
  for (int c = 0; c < BN / EPI_COLS; ++c) {
    named_bar(bar_id);  // s_tile is written; the previous piece's reads are done
#pragma unroll
    for (int j = 0; j < EPI_COLS / 8; ++j) {
      const int col = c * EPI_COLS + j * 8 + c0;
      const float s0 = s_tile[col], s1 = s_tile[col + 1];
      const int i = (c * (EPI_COLS / 8) + j) * 4;
      float* p = epi + r0 * EPI_STRIDE + j * 8 + c0;
      *reinterpret_cast<float2*>(p) = make_float2(static_cast<float>(acc[i]) * rs0 * s0,
                                                  static_cast<float>(acc[i + 1]) * rs0 * s1);
      *reinterpret_cast<float2*>(p + 8 * EPI_STRIDE) =
          make_float2(static_cast<float>(acc[i + 2]) * rs1 * s0,
                      static_cast<float>(acc[i + 3]) * rs1 * s1);
    }
    named_bar(bar_id);
#pragma unroll
    for (int q = 0; q < 64 * EPI_COLS / 4 / 128; ++q) {
      const int e = q * 128 + t;
      const int row = e / (EPI_COLS / 4), c4 = 4 * (e % (EPI_COLS / 4));
      const int gm = m0 + row, gn = n0 + c * EPI_COLS + c4;
      if (gm < G && gn < N) {
        const float4 v = *reinterpret_cast<const float4*>(epi + row * EPI_STRIDE + c4);
        float* dst = out + (size_t)gm * N + gn;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = v;
        } else {
          dst[0] = v.x;
          if (gn + 1 < N) dst[1] = v.y;
          if (gn + 2 < N) dst[2] = v.z;
          if (gn + 3 < N) dst[3] = v.w;
        }
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, const float* __restrict__ sx,
                 const float* __restrict__ s, float* __restrict__ out, int G, int N, int Kp) {
  constexpr int STAGES = stages_for<BN>();
  constexpr int STAGE_BYTES = (BM + BN) * BK;
  static_assert(STAGES >= 2 && STAGES <= MAX_STAGES, "ring");
  extern __shared__ unsigned char qmm_smem[];
  const uint32_t raw = smem_addr(qmm_smem);
  const uint32_t ring = (raw + ALIGN_SLACK - 1) & ~uint32_t(ALIGN_SLACK - 1);
  float* epi = reinterpret_cast<float*>(qmm_smem + (ring - raw) + STAGES * STAGE_BYTES);
  float* scales = epi + EPI_BYTES / 4;
  const uint32_t full0 = ring + STAGES * STAGE_BYTES + EPI_BYTES + SCALE_BYTES;  // full[i] at +8i
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  const int MT = (G + BM - 1) / BM;
  const int tiles = MT * ((N + BN - 1) / BN);
  const int KT = (Kp + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);                  // the producer's expect_tx
      mbar_init(empty0 + 8 * i, 4 * CONSUMERS);     // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every TMA load
    if constexpr (CONSUMERS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      prefetch_map(&a_map);
      prefetch_map(&b_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % MT) * BM, n0 = (tile / MT) * BN;
        // boxes wholly past G or N are not loaded: their rows are never stored
        const int a_boxes = min(BM / A_BOX_ROWS, (G - m0 + A_BOX_ROWS - 1) / A_BOX_ROWS);
        const int b_boxes = min(BN / B_BOX_ROWS, (N - n0 + B_BOX_ROWS - 1) / B_BOX_ROWS);
        const uint32_t bytes = (a_boxes * A_BOX_ROWS + b_boxes * B_BOX_ROWS) * BK;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage, dst = ring + stage * STAGE_BYTES;
          mbar_expect_tx(full, bytes);
          for (int i = 0; i < a_boxes; ++i)
            tma_load(dst + i * A_BOX_ROWS * BK, &a_map, kt * BK, m0 + i * A_BOX_ROWS, full);
          for (int i = 0; i < b_boxes; ++i)
            tma_load(dst + A_BYTES + i * B_BOX_ROWS * BK, &b_map, kt * BK, n0 + i * B_BOX_ROWS,
                     full);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of each tile
    if constexpr (CONSUMERS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32;
    float* epi_wg = epi + wg * 64 * EPI_STRIDE;
    float* s_wg = scales + wg * 256;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % MT) * BM + wg * 64, n0 = (tile / MT) * BN;
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] = 0;
        pin(acc[i]);
      }
      int prev = -1;
#pragma unroll 1
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a = ring + stage * STAGE_BYTES + wg * A_BOX_ROWS * BK;
        const uint32_t b = ring + stage * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) wgmma_s8<BN>(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
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
      store_tile<BN>(acc, epi_wg, s_wg, 1 + wg, sx, s, out, m0, n0, G, N);
    }
  }
}

template <int BN>
cudaError_t launch_tiles(const CUtensorMap& a, const CUtensorMap& b, const float* sx,
                         const float* s, float* out, int G, int N, int Kp, int blocks,
                         cudaStream_t st) {
  // per device, so set once for each device this process launches on
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(qmm_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes_for<BN>());
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  qmm_wgmma_kernel<BN><<<blocks, THREADS, smem_bytes_for<BN>(), st>>>(a, b, sx, s, out, G, N, Kp);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int qmatmul_k_align() { return K_ALIGN; }
extern "C" int qmatmul_map_bytes() { return static_cast<int>(sizeof(CUtensorMap)); }

// Shared memory of the tile kernel at tile width bn (a multiple of 32 from 64
// to 256), -1 for another.
extern "C" int qmatmul_smem_bytes(int bn) {
  switch (bn) {
    case 64: return smem_bytes_for<64>();
    case 96: return smem_bytes_for<96>();
    case 128: return smem_bytes_for<128>();
    case 160: return smem_bytes_for<160>();
    case 192: return smem_bytes_for<192>();
    case 224: return smem_bytes_for<224>();
    case 256: return smem_bytes_for<256>();
    default: return -1;
  }
}

// The TMA map of an int8 [rows, Kp] row-major tensor at `ptr` (16-byte
// aligned, Kp a multiple of 16), in boxes 128 bytes deep and A_BOX_ROWS rows
// (the activations xq) or B_BOX_ROWS rows (weight != 0: a weight qt), with
// 128-byte swizzle, written to map_out (qmatmul_map_bytes() bytes). Returns 0,
// the CUresult of the encoding, or -1 if cuTensorMapEncodeTiled is not found.
extern "C" int qmatmul_encode_map(void* map_out, const void* ptr, int rows, int Kp, int weight) {
  const EncodeTiled encode = encode_tiled_fn();
  if (encode == nullptr) return -1;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(weight ? B_BOX_ROWS : A_BOX_ROWS)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// x [G, K] fp32 (x_bf16 = 0) or bf16 (1); a_map the map of the scratch xq
// [G, Kp] int8, b_map that of qt [N, Kp] int8 (Kp = K rounded up to K_ALIGN,
// zero past K), s [N] fp32; scratch sx [G] fp32; out [G, N] fp32 (16-byte
// aligned). bn and blocks from kernels/qmatmul.py::qmatmul_plan. Returns the
// first nonzero cudaGetLastError() of the launches.
extern "C" int qmatmul_launch(const void* x, int x_bf16, const void* a_map, const void* b_map,
                              const void* s, void* xq, void* sx, void* out, int G, int K, int N,
                              int bn, int blocks, void* stream) {
  if (G < 1 || K < 1 || N < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Kp = (K + K_ALIGN - 1) / K_ALIGN * K_ALIGN;
  // rows of whole 16-byte steps from a 16-byte aligned x go in 16-byte loads
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K * (x_bf16 ? 2 : 4) % 16 == 0;
  if (x_bf16) {
    quantize_rows_kernel<uint16_t><<<G, QUANT_THREADS, 0, st>>>(
        static_cast<const uint16_t*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), K, Kp,
        vec);
  } else {
    quantize_rows_kernel<float><<<G, QUANT_THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), K, Kp,
        vec);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap a, b;  // by value into the kernel's parameters (__grid_constant__)
  memcpy(&a, a_map, sizeof(a));
  memcpy(&b, b_map, sizeof(b));
  const float* sxf = static_cast<const float*>(sx);
  const float* sf = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  switch (bn) {
    case 64: err = launch_tiles<64>(a, b, sxf, sf, o, G, N, Kp, blocks, st); break;
    case 96: err = launch_tiles<96>(a, b, sxf, sf, o, G, N, Kp, blocks, st); break;
    case 128: err = launch_tiles<128>(a, b, sxf, sf, o, G, N, Kp, blocks, st); break;
    case 160: err = launch_tiles<160>(a, b, sxf, sf, o, G, N, Kp, blocks, st); break;
    case 192: err = launch_tiles<192>(a, b, sxf, sf, o, G, N, Kp, blocks, st); break;
    case 224: err = launch_tiles<224>(a, b, sxf, sf, o, G, N, Kp, blocks, st); break;
    case 256: err = launch_tiles<256>(a, b, sxf, sf, o, G, N, Kp, blocks, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
