// Fused vocab head: top_k(h @ w + b) per row, values descending, ties to the
// lowest id, optionally minus the exact row logsumexp. The [G, V] logits
// never reach device memory.
//
// Replaces the TPU kernel dlsg_tpu/ops/pallas/vocab_head.py::vocab_head_topk
// (pallas_call at :151; body _vocab_head_kernel :52-92, _tile_topk :36-49).
//
// What bounds it on the card: at the beam step's shapes (G=640 rows, H=1536,
// V=10000) the function is 19.7 GFLOP against 30.7 MB of bf16 weights, so it
// is bound by operations: ~20 us at the bf16 tensor-core rate. This first
// kernel multiplies with fp32 FMAs on the CUDA cores (67 TFLOP/s peak, so
// ~0.3 ms at best) and is bound by that rate; a tensor-core (wgmma) form is
// later work.
//
// Design: the TPU kernel walked the V tiles in order and kept a running top-k
// and (max, sumexp) in scratch. Blocks on the card run in no order, so the
// walk becomes two launches:
//   1. tile_topk_kernel, grid (V tiles x row tiles): a block computes a
//      64 x 128 fp32 logits tile (4 x 8 per thread, operands staged through
//      shared memory in k-slices of 16), adds the bias, masks columns >= V
//      itself (no padded copy of w), and writes the tile's top-k (value, id)
//      and the row's (max, sum exp(x - max)) over the tile to scratch;
//   2. merge_kernel, one warp per row: picks the k best of the per-tile lists
//      and combines the lse as M + log(sum_j s_j exp(m_j - M)).
// h is rounded to w's dtype before the product, as the TPU kernel casts it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BN = 128;       // vocab columns per block (one tile)
constexpr int BK = 16;        // k-slice staged in shared memory
constexpr int THREADS = 256;  // 16 x 16: rows ty + 16 i, columns tx + 16 j
constexpr int TM = 4;
constexpr int TN = 8;
constexpr int KMAX = 8;
constexpr long long NO_ID = 0x7fffffffLL;  // id of an empty slot
constexpr int SMEM_FLOATS = BM * (BN + 1);  // logits tile; >= BK * (BM + BN)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_w(const float* w, size_t i) { return w[i]; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* w, size_t i) {
  return __bfloat162float(w[i]);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// (v, i) ranks before (bv, bi): larger value first, then lower id
__device__ __forceinline__ bool better(float v, long long i, float bv, long long bi) {
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

template <typename WT>
__global__ void __launch_bounds__(THREADS)
tile_topk_kernel(const float* __restrict__ h, const WT* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ part_v,
                 long long* __restrict__ part_i, float* __restrict__ part_m,
                 float* __restrict__ part_s, int G, int H, int V, int k, int n_tiles) {
  __shared__ float smem[SMEM_FLOATS];
  float* As = smem;            // [BK][BM]: h slice, transposed
  float* Bs = smem + BK * BM;  // [BK][BN]: w slice
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int tile = blockIdx.x;
  const int col0 = tile * BN;
  const int row0 = blockIdx.y * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, kk = e % BK;
      const int r = row0 + m, c = k0 + kk;
      const float x = (r < G && c < H) ? h[(size_t)r * H + c] : 0.f;
      As[kk * BM + m] = round_to(x, w);
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, n = e % BN;
      const int r = k0 + kk, c = col0 + n;
      Bs[kk * BN + n] = (r < H && c < V) ? load_w(w, (size_t)r * V + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * BM + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bb[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // logits tile (+ bias) into shared memory; columns >= V are -inf
  float* C = smem;  // [BM][BN + 1]
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = ty + 16 * i, n = tx + 16 * j, c = col0 + n;
      C[m * (BN + 1) + n] = (c < V) ? acc[i][j] + b[c] : -INFINITY;
    }
  __syncthreads();

  // one warp per row: (max, sumexp) and the tile's top-k
  const int warp = tid / 32, lane = tid % 32;
  for (int m = warp; m < BM; m += THREADS / 32) {
    const int r = row0 + m;
    if (r >= G) break;  // uniform over the warp
    float v[BN / 32];
    long long id[BN / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      const int n = lane + 32 * q, c = col0 + n;
      v[q] = C[m * (BN + 1) + n];
      id[q] = (c < V) ? (long long)c : NO_ID;
      mx = fmaxf(mx, v[q]);
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q)
      if (id[q] != NO_ID) s += expf(v[q] - mx);
    s = warp_sum(s);
    const size_t slot = (size_t)r * n_tiles + tile;
    if (lane == 0) {
      part_m[slot] = mx;
      part_s[slot] = s;
    }
    // pick t takes the best candidate ranked after pick t-1
    float pv = INFINITY;
    long long pi = -1;
    for (int t = 0; t < k; ++t) {
      float bv = -INFINITY;
      long long bi = NO_ID;
#pragma unroll
      for (int q = 0; q < BN / 32; ++q)
        if (better(pv, pi, v[q], id[q]) && better(v[q], id[q], bv, bi)) {
          bv = v[q];
          bi = id[q];
        }
      warp_best(bv, bi);
      if (lane == 0) {
        part_v[slot * k + t] = bv;
        part_i[slot * k + t] = bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part_v, const long long* __restrict__ part_i,
             const float* __restrict__ part_m, const float* __restrict__ part_s,
             float* __restrict__ vals, long long* __restrict__ ids, int G, int k,
             int n_tiles, int normalize) {
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

// h [G, H] fp32; w [H, V] bf16 (w_bf16 = 1) or fp32; b [V] fp32; scratch
// part_v/part_i [G, n_tiles, k], part_m/part_s [G, n_tiles] with
// n_tiles = ceil(V / 128); outputs vals [G, k] fp32, ids [G, k] int64.
// Returns cudaGetLastError() after the launches.
extern "C" int vocab_head_topk_launch(const void* h, const void* w, int w_bf16,
                                      const void* b, void* part_v, void* part_i,
                                      void* part_m, void* part_s, void* vals, void* ids,
                                      int G, int H, int V, int k, int normalize,
                                      void* stream) {
  if (k < 1 || k > KMAX || G < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + BN - 1) / BN;
  const dim3 grid(n_tiles, (G + BM - 1) / BM);
  const float* hp = static_cast<const float*>(h);
  const float* bp = static_cast<const float*>(b);
  float* pv = static_cast<float*>(part_v);
  long long* pi = static_cast<long long*>(part_i);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  if (w_bf16) {
    tile_topk_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        hp, static_cast<const __nv_bfloat16*>(w), bp, pv, pi, pm, ps, G, H, V, k, n_tiles);
  } else {
    tile_topk_kernel<float><<<grid, THREADS, 0, st>>>(
        hp, static_cast<const float*>(w), bp, pv, pi, pm, ps, G, H, V, k, n_tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<(G + 7) / 8, 256, 0, st>>>(pv, pi, pm, ps, static_cast<float*>(vals),
                                            static_cast<long long*>(ids), G, k, n_tiles,
                                            normalize);
  return static_cast<int>(cudaGetLastError());
}
