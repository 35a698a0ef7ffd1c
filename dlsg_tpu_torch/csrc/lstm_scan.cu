// One LSTM direction over pre-projected inputs: the recurrence of one half of
// the encoder's Bi-LSTM.
//
// Replaces the TPU kernel dlsg_tpu/ops/pallas/lstm_scan.py::lstm_scan_pallas
// (pallas_call at :128; body _kernel :31-94). Numeric contract kept: h0 = c0
// = 0; gates = xw[:, t] + h_{t-1} @ W_hh with h in fp32, W_hh rounded to bf16
// (once, by the wrapper) and fp32 accumulation; gates in (i, f, g, o) order;
// c = sig(f) c + sig(i) tanh(g), h = sig(o) tanh(c). With `reverse` the scan
// runs t = T-1 .. 0 and outputs stay at their input positions.
//
// What bounds it on the card: each step is 2 B H 4H operations (1.07 GFLOP at
// B=128, H=1024). The product runs on the bf16 tensor cores as three passes
// (below), 3 x 26.8 GFLOP per direction, ~81 us at 989 TFLOP/s, against
// 76.5 MB per direction (W_hh 8.4 MB once, xw 54.5 MB, hs 13.6 MB), ~23 us at
// 3.35 TB/s: bound by operations. In practice each step also re-reads h_{t-1}
// (B x H fp32, 512 KB) from L2 in every block, and crosses a grid barrier.
//
// Design: the TPU kernel kept W_hh in VMEM for all T steps. Here one
// cooperative launch runs the whole direction: ceil(H / U) blocks (U = 8 or
// 16 hidden units each, at most one block per SM), each holding all four gate
// columns of its units, [H x 4U] bf16 of W_hh, in shared memory for all steps,
// stored in the order of mma.sync's B fragments (one 8-byte load per lane, no
// bank conflicts). Each step, for each 128-row batch tile:
//   1. h_{t-1} = hs[:, t_prev] streams from L2 in [128 x KC] fp32 chunks
//      through a ring of NS chunks (NS - 1 in flight) filled by cp.async.cg
//      (L2 only: other blocks wrote it); the block's xw[:, t] columns are
//      loaded into registers before the product;
//   2. 8 warps, one 16-row m-tile each, multiply with mma.sync m16n8k16
//      bf16 -> fp32. Each fp32 h is split into three bf16 terms, hi =
//      bf16(h), mid = bf16(h - hi), lo = bf16(h - hi - mid), which hold all of
//      h's 24 significant bits; a bf16 x bf16 product is exact in fp32, so the
//      three passes, each into its own fp32 accumulator, summed (lo + mid) +
//      hi, give the fp32 product up to summation order;
//   3. a thread's accumulators hold all four gates of 2 rows x 2 units (per 8
//      units), so the cell update runs in registers; c stays in shared memory
//      for the whole scan, and h_t goes to hs[:, t];
//   4. the grid barrier (cooperative_groups::this_grid().sync()).
// A ragged batch or hidden size is masked, not padded in device memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // 8 warps, one 16-row m-tile each
constexpr int ROWS = 128;     // batch rows per row tile

__host__ __device__ constexpr int chunk_k(int units) { return units == 8 ? 64 : 16; }

// dynamic shared memory of one block: W_hh slice, a ring of `stages` h
// chunks, c
__host__ __device__ constexpr long long smem_bytes(int B, int H, int units, int stages) {
  return (long long)((H + 15) / 16 * 16) * 4 * units * 2 +
         (long long)stages * ROWS * (chunk_k(units) + 8) * 4 +
         (long long)((B + ROWS - 1) / ROWS) * ROWS * units * 4;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only; with `pred` false the
// destination is zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, k-major), fp32 accumulate.
// Not volatile: independent products may be scheduled around each other.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) fp32 -> three bf16x2 terms whose sum is (x, y)
__device__ __forceinline__ void split3(float2 x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x.x, x.y);
  const float2 hf = __bfloat1622float2(h);
  const float2 r = make_float2(x.x - hf.x, x.y - hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r.x, r.y);
  const float2 mf = __bfloat1622float2(m);
  hi = pack(h);
  mid = pack(m);
  lo = pack(__floats2bfloat162_rn(r.x - mf.x, r.y - mf.y));
}

template <int UH, int NS>  // U = 8 UH hidden units per block; NS h chunks in the ring
__global__ void __launch_bounds__(THREADS, 1)
lstm_scan_kernel(const float* __restrict__ xw, const __nv_bfloat16* __restrict__ w,
                 float* hs, int B, int T, int H, int reverse, int aligned) {
  constexpr int U = 8 * UH, NT = 4 * UH, KC = chunk_k(U), S = KC + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hp = (H + 15) / 16 * 16;
  uint2* wf = reinterpret_cast<uint2*>(smem);                    // [Hp/16][NT][32]
  float* stage = reinterpret_cast<float*>(smem + (size_t)Hp * 4 * U * 2);  // [NS][ROWS][S]
  float* cs = stage + NS * ROWS * S;                             // [rows][U]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int j0 = blockIdx.x * U;
  const size_t G4 = 4 * (size_t)H;

  // W_hh's [H x 4U] slice, once, in B-fragment order: entry (ks, j, lane)
  // holds W[16ks + 2t4 + {0, 1, 8, 9}][column g of n-tile j]; n-tile j is
  // gate j / UH, units 8 (j % UH) .. + 7. Rows >= H and units >= H are zero.
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w);
  for (int e = threadIdx.x; e < Hp / 16 * NT * 32; e += THREADS) {
    const int ln = e % 32, j = (e / 32) % NT, ks = e / (32 * NT);
    const int unit = j0 + (j % UH) * 8 + ln / 4;
    const size_t col = (size_t)(j / UH) * H + unit;
    const int k = ks * 16 + 2 * (ln % 4);
    auto at = [&](int kk) -> uint32_t {
      return (unit < H && kk < H) ? __ldg(wb + (size_t)kk * G4 + col) : 0u;
    };
    wf[e] = make_uint2(at(k) | at(k + 1) << 16, at(k + 8) | at(k + 9) << 16);
  }
  __syncthreads();

  const int n_rt = (B + ROWS - 1) / ROWS;
  const int n_chunks = (Hp + KC - 1) / KC;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int tp = reverse ? t + 1 : t - 1;
    for (int rt = 0; rt < n_rt; ++rt) {
      const int r0 = rt * ROWS;
      const int mrow = r0 + warp * 16;  // the warp's first row
      const bool active = mrow < B;     // uniform over the warp

      // this thread's xw[:, t] entries, in flight while the product runs:
      // [uh][row g / g + 8][unit 2t4 / 2t4 + 1][gate]
      float xv[UH][2][2][4];
#pragma unroll
      for (int uh = 0; uh < UH; ++uh)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int b = mrow + g + 8 * r, j = j0 + uh * 8 + 2 * t4 + e;
            const bool in = active && b < B && j < H;
            const float* x = xw + ((size_t)b * T + t) * G4 + j;
#pragma unroll
            for (int q = 0; q < 4; ++q) xv[uh][r][e][q] = in ? __ldg(x + q * H) : 0.f;
          }

      // one accumulator per bf16 term of h (lo, mid, hi): no product waits
      // on another, and the small terms are summed apart from the large
      float acc[3][NT][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][j][q] = 0.f;

      if (s > 0) {  // h0 = 0: step 0 has no product
        auto load_chunk = [&](int c) {
          float* dst0 = stage + (c % NS) * ROWS * S;
          const int k0 = c * KC;
          if (aligned) {  // H % 4 == 0: a 4-float chunk is wholly in or out
            for (int e = threadIdx.x; e < ROWS * KC / 4; e += THREADS) {
              const int m = e / (KC / 4), kq = (e % (KC / 4)) * 4;
              const int b = r0 + m, k = k0 + kq;
              const bool in = b < B && k < H;
              cp_async16(dst0 + m * S + kq, in ? hs + ((size_t)b * T + tp) * H + k : hs, in);
            }
          } else {
            for (int e = threadIdx.x; e < ROWS * KC; e += THREADS) {
              const int m = e / KC, kk = e % KC;
              const int b = r0 + m, k = k0 + kk;
              dst0[m * S + kk] = (b < B && k < H) ? __ldcg(hs + ((size_t)b * T + tp) * H + k) : 0.f;
            }
          }
        };
        // a ring of NS chunks, NS - 1 in flight; one commit group per chunk
#pragma unroll
        for (int c = 0; c < NS - 1; ++c) {
          if (c < n_chunks) load_chunk(c);
          asm volatile("cp.async.commit_group;\n");
        }
        for (int c = 0; c < n_chunks; ++c) {
          asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));  // chunk c has landed
          __syncthreads();  // ... for every thread; slot (c - 1) % NS is free
          if (c + NS - 1 < n_chunks) load_chunk(c + NS - 1);
          asm volatile("cp.async.commit_group;\n");
          if (active) {
            const float* A = stage + (c % NS) * ROWS * S + warp * 16 * S;
            const int k0 = c * KC;
#pragma unroll
            for (int kl = 0; kl < KC / 16; ++kl) {
              if (k0 + kl * 16 >= Hp) break;
              const float* a = A + kl * 16 + 2 * t4;
              uint32_t hi[4], mid[4], lo[4];
              split3(*reinterpret_cast<const float2*>(a + g * S), hi[0], mid[0], lo[0]);
              split3(*reinterpret_cast<const float2*>(a + (g + 8) * S), hi[1], mid[1], lo[1]);
              split3(*reinterpret_cast<const float2*>(a + g * S + 8), hi[2], mid[2], lo[2]);
              split3(*reinterpret_cast<const float2*>(a + (g + 8) * S + 8), hi[3], mid[3], lo[3]);
              const uint2* wk = wf + (size_t)((k0 / 16 + kl) * NT) * 32 + lane;
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                const uint2 bw = wk[j * 32];
                mma_bf16(acc[0][j], lo, bw);
                mma_bf16(acc[1][j], mid, bw);
                mma_bf16(acc[2][j], hi, bw);
              }
            }
          }
        }
        __syncthreads();  // the ring is refilled for the next row tile
      }

      if (active) {
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int b = mrow + g + 8 * r, u = uh * 8 + 2 * t4 + e, j = j0 + u;
              if (b >= B || j >= H) continue;
              float gate[4];  // i, f, g, o
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int j = q * UH + uh, f = 2 * r + e;
                gate[q] = xv[uh][r][e][q] + ((acc[0][j][f] + acc[1][j][f]) + acc[2][j][f]);
              }
              const float gi = gate[0], gf = gate[1], gg = gate[2], go = gate[3];
              float* c = cs + (size_t)b * U + u;  // only this thread touches it
              const float cn = sigmoid(gf) * (s == 0 ? 0.f : *c) + sigmoid(gi) * tanhf(gg);
              *c = cn;
              hs[((size_t)b * T + t) * H + j] = sigmoid(go) * tanhf(cn);
            }
      }
    }
    if (s + 1 < T) cg::this_grid().sync();  // h_t complete in every block
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block for (B, H, units, stages), in bytes
// (the wrapper's launch plan states the same number).
extern "C" long long lstm_scan_smem_bytes(int B, int H, int units, int stages) {
  return smem_bytes(B, H, units, stages);
}

// xw [B, T, 4H] fp32; w [H, 4H] bf16; hs [B, T, H] fp32 output. One
// cooperative launch of ceil(H / units) blocks on `stream`, (units, stages)
// one of (8, 4), (8, 2), (16, 2). Returns a CUDA error code:
// cudaErrorCooperativeLaunchTooLarge if the blocks cannot all be resident at
// once, else the launch's own.
extern "C" int lstm_scan_launch(const void* xw, const void* w, void* hs, int B, int T, int H,
                                int units, int stages, int reverse, void* stream) {
  const void* kernel = nullptr;
  if (units == 8 && stages == 4) kernel = reinterpret_cast<const void*>(lstm_scan_kernel<1, 4>);
  if (units == 8 && stages == 2) kernel = reinterpret_cast<const void*>(lstm_scan_kernel<1, 2>);
  if (units == 16 && stages == 2) kernel = reinterpret_cast<const void*>(lstm_scan_kernel<2, 2>);
  if (kernel == nullptr || B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(B, H, units, stages);
  int dev = 0, n_sm = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, (size_t)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (H + units - 1) / units;
  if (per_sm * n_sm < blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const float* xw_p = static_cast<const float*>(xw);
  const __nv_bfloat16* w_p = static_cast<const __nv_bfloat16*>(w);
  float* hs_p = static_cast<float*>(hs);
  int aligned = H % 4 == 0 && reinterpret_cast<uintptr_t>(hs) % 16 == 0;
  void* args[] = {&xw_p, &w_p, &hs_p, &B, &T, &H, &reverse, &aligned};
  return static_cast<int>(cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args,
                                                      (size_t)smem,
                                                      static_cast<cudaStream_t>(stream)));
}
