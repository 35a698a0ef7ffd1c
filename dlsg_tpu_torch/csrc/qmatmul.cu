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
// bytes. At G = 128 (the first beam step) bytes bound all three.
//
// Design: two launches, each simple.
//   1. quantize_rows_kernel, one block per row of x [G, K] fp32: the row's
//      absmax (a block reduction), sx, then xq [G, Kp] int8 with Kp = K
//      rounded up to K_ALIGN and the tail zero. IEEE division x / sx and rintf
//      (round half to even, as torch.round and jnp.round) keep it bitwise
//      equal to the plain version: no __fdividef, no --use_fast_math.
//   2. qmm_tile_kernel, one block per 128 x 128 output tile, 8 warps of 64 x
//      32, mma.sync m16n8k32 s8 x s8 -> s32 fed by ldmatrix from a 4-stage
//      ring of [128 x 64] xq and qt tiles that 16-byte cp.async fills (rows
//      >= G or >= N and k >= Kp zero-filled). The weight arrives transposed,
//      qt [N, Kp] (K-major, the mma's .col B operand), from the wrapper's
//      once-per-decode packing: ldmatrix cannot transpose 8-bit data, and the
//      zero tail makes every 16-byte chunk wholly in or out, so no K (2860)
//      needs a scalar path. Rows in shared memory are 80 bytes (64 + 16), so
//      ldmatrix's 8 row addresses fall on distinct banks. The epilogue writes
//      float(acc) * sx[row] * s[col] straight from the accumulators, in that
//      order. int8 x int8 -> int32 is exact, so the output equals the plain
//      version's bitwise.
// Not yet wgmma or TMA: a right kernel first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int K_ALIGN = 32;   // Kp = K rounded up; kernels/qmatmul.py::K_ALIGN
constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 64;        // k (bytes) per ring stage: two mma k-steps
constexpr int STAGES = 4;
constexpr int THREADS = 256;  // tile kernel: 8 warps of 64 x 32
constexpr int STRIDE = BK + 16;  // bytes per tile row in shared memory
constexpr int A_STAGE = BM * STRIDE;
constexpr int B_STAGE = BN * STRIDE;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);
constexpr int QUANT_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// max with NaN kept, as torch's amax
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

__global__ void __launch_bounds__(QUANT_THREADS)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                     int K, int Kp) {
  __shared__ float warp_max[QUANT_THREADS / 32];
  __shared__ float row_scale;
  const int row = blockIdx.x;
  const float* xr = x + (size_t)row * K;
  float m = 0.f;
  for (int c = threadIdx.x; c < K; c += QUANT_THREADS) m = nan_max(fabsf(xr[c]), m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(__shfl_xor_sync(FULL, m, off), m);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = warp_max[0];
    for (int w = 1; w < QUANT_THREADS / 32; ++w) v = nan_max(warp_max[w], v);
    v = v * (1.0f / 127.0f);             // as XLA's rewrite of `/ 127.0`
    v = v != v ? v : fmaxf(v, 1e-12f);   // clamp_min keeps NaN
    row_scale = v;
    sx[row] = v;
  }
  __syncthreads();
  const float scale = row_scale;
  int8_t* qr = xq + (size_t)row * Kp;
  for (int c = threadIdx.x; c < Kp; c += QUANT_THREADS) {
    float q = 0.f;
    if (c < K) q = fminf(fmaxf(rintf(xr[c] / scale), -127.f), 127.f);
    qr[c] = static_cast<int8_t>(q);
  }
}

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

// four 8 x 16-byte matrices; lanes 8j..8j+7 give matrix j's row addresses
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 32 s8, row-major) * b (32 x 8 s8, k-major), exact int32.
// Not volatile: independent products may be scheduled around each other.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage k-tile kt of xq [G, Kp] and qt [N, Kp] into ring slot (As, Bs): 512
// 16-byte chunks each, two per thread; Kp is a multiple of 16, so a chunk is
// wholly in or out of bounds
__device__ __forceinline__ void load_stage(int8_t* As, int8_t* Bs, const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ qt, int kt, int row0,
                                           int col0, int G, int N, int Kp) {
  const int k0 = kt * BK;
#pragma unroll
  for (int q = 0; q < (BM * BK / 16) / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int m = e / (BK / 16), kc = (e % (BK / 16)) * 16;
    const int r = row0 + m, c = k0 + kc;
    const bool in = r < G && c < Kp;
    cp_async16(As + m * STRIDE + kc, in ? xq + (size_t)r * Kp + c : xq, in);
  }
#pragma unroll
  for (int q = 0; q < (BN * BK / 16) / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int n = e / (BK / 16), kc = (e % (BK / 16)) * 16;
    const int r = col0 + n, c = k0 + kc;
    const bool in = r < N && c < Kp;
    cp_async16(Bs + n * STRIDE + kc, in ? qt + (size_t)r * Kp + c : qt, in);
  }
}

__global__ void __launch_bounds__(THREADS)
qmm_tile_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ qt,
                const float* __restrict__ sx, const float* __restrict__ s,
                float* __restrict__ out, int G, int N, int Kp) {
  extern __shared__ __align__(16) unsigned char qmm_smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(qmm_smem);
  // the row tile is the fast grid index: the blocks that share a weight tile run together
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // the warp's 64 x 32 sub-tile
  const int KT = (Kp + BK - 1) / BK;

  int acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  auto As = [&](int st) { return ring + st * (A_STAGE + B_STAGE); };
  auto Bs = [&](int st) { return ring + st * (A_STAGE + B_STAGE) + A_STAGE; };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load_stage(As(st), Bs(st), xq, qt, st, row0, col0, G, N, Kp);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // k-tile kt has landed
    __syncthreads();              // ... for every thread; slot (kt - 1) is free
    const int next = kt + STAGES - 1;
    if (next < KT)
      load_stage(As(next % STAGES), Bs(next % STAGES), xq, qt, next, row0, col0, G, N, Kp);
    cp_async_commit();
    const int8_t* a_s = As(kt % STAGES);
    const int8_t* b_s = Bs(kt % STAGES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
      // A: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) of each m16 tile
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], a_s + (wm + i * 16 + lane % 16) * STRIDE + kk + (lane / 16) * 16);
      // B: two n8 tiles a load, matrices (n 0-7, bytes 0-15), (n 0-7, 16-31),
      // (n 8-15, 0-15), (n 8-15, 16-31)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, b_s + (wn + jj * 16 + (lane / 16) * 8 + lane % 8) * STRIDE + kk +
                           ((lane / 8) % 2) * 16);
        bf[2 * jj][0] = r[0];
        bf[2 * jj][1] = r[1];
        bf[2 * jj + 1][0] = r[2];
        bf[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: fragment q of (i, j) is row g (+8 for q >= 2), column 2t + q % 2
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = row0 + wm + i * 16 + g + half * 8;
      if (m >= G) continue;
      const float rs = sx[m];
      float* orow = out + (size_t)m * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = col0 + wn + j * 8 + 2 * t;
        if (n < N) orow[n] = static_cast<float>(acc[i][j][2 * half]) * rs * s[n];
        if (n + 1 < N) orow[n + 1] = static_cast<float>(acc[i][j][2 * half + 1]) * rs * s[n + 1];
      }
    }
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int qmatmul_smem_bytes() { return SMEM_BYTES; }
extern "C" int qmatmul_k_align() { return K_ALIGN; }

// x [G, K] fp32, qt [N, Kp] int8 (16-byte aligned rows: Kp = K rounded up to
// K_ALIGN, zero past K), s [N] fp32; scratch xq [G, Kp] int8 and sx [G] fp32;
// out [G, N] fp32. Returns the first nonzero cudaGetLastError() of the launches.
extern "C" int qmatmul_launch(const void* x, const void* qt, const void* s, void* xq, void* sx,
                              void* out, int G, int K, int N, void* stream) {
  if (G < 1 || K < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Kp = (K + K_ALIGN - 1) / K_ALIGN * K_ALIGN;
  quantize_rows_kernel<<<G, QUANT_THREADS, 0, st>>>(static_cast<const float*>(x),
                                                    static_cast<int8_t*>(xq),
                                                    static_cast<float*>(sx), K, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // per device, so set on every launch (a host-side call, no launch)
  err = cudaFuncSetAttribute(qmm_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((G + BM - 1) / BM, (N + BN - 1) / BN);
  qmm_tile_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(qt),
      static_cast<const float*>(sx), static_cast<const float*>(s), static_cast<float*>(out), G,
      N, Kp);
  return static_cast<int>(cudaGetLastError());
}
