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
// 3.35 TB/s: bound by operations. In practice each step also moves h_{t-1}
// from L2 into every block that needs it, and crosses a grid barrier: the
// steps are a chain of 25 dependent products.
//
// Design: the TPU kernel kept W_hh in VMEM for all T steps. Here one
// cooperative launch runs the whole direction on at most one block per SM,
// every block resident, so a barrier on a global counter can separate the
// steps. Block (group, unit block) owns U = 8 or 16 hidden units, all four
// gate columns of them, [H x 4U] bf16 of W_hh, which its prologue packs into
// shared memory once in wgmma's K-major layout (64-k blocks of 4U 128-byte
// rows, 128-byte swizzle), and the 64-row batch tiles of its group: with G
// groups, tiles g, g + G, ... The plan (kernels/lstm_scan.py) picks U and G:
// at B = 128, H = 1024, 64 unit blocks of 16 units x 2 groups, so a block
// reads 64 rows of h_{t-1} a step where one block of the whole batch would
// read 128 (half the L2 -> SM traffic, 32 MB a step). Each step, each tile:
//   1. h_{t-1} arrives by TMA: one producer thread loads [64 x 32] fp32
//      chunks (128-byte swizzle) of a [2, B, ceil4(H)] ping-pong scratch into
//      a ring of mbarrier-signalled stages of two chunks (one where shared
//      memory is short), ahead of the product. The scratch, not hs, because
//      TMA needs 16-byte row pitches and hs[b, t, :] has none at H = 21; the
//      map's extent H zero-fills k >= H and rows >= B. The consumer
//      warpgroup loads its xw[:, t] columns into registers meanwhile;
//   2. the consumer warpgroup (4 warps, 16 rows each) splits each fp32 h
//      into three bf16 terms, hi = bf16(h), mid = bf16(h - hi), lo = bf16(h -
//      hi - mid), which hold all of h's 24 significant bits, as wgmma's A
//      fragments in registers (m64k16 layout), and runs wgmma m64n(4U)k16
//      bf16 -> fp32 against the W_hh slice in shared memory, each term into
//      its own accumulator (a bf16 x bf16 product is exact in fp32), summed
//      (lo + mid) + hi: the fp32 product up to summation order. One chunk's
//      products stay in flight while the next chunk is split, and each ring
//      stage is released when its products are done;
//   3. a thread's accumulators hold all four gates of 2 rows x 2 units (per
//      8 units), so the cell update runs in registers; c stays in shared
//      memory for the whole scan; h_t goes to hs[:, t] and to the scratch;
//   4. the writers' proxy fence (h_t is written by ordinary stores and read
//      by TMA, the async proxy, on the next step), then the step barrier:
//      each block's release add on a global counter, which the producer
//      awaits (acquire) before it loads h_t; the consumers go on to the
//      next step's xw loads and wait for the h chunks alone.
// A ragged batch or hidden size is masked, not padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int ROWS = 64;            // batch rows per tile: one consumer warpgroup
constexpr int THREADS = 128 + 32;   // the consumer warpgroup and the producer warp
constexpr int KC = 32;              // fp32 k per h chunk: one 128-byte swizzle row
constexpr int CHUNK_BYTES = ROWS * KC * 4;
constexpr int MAX_STAGES = 8;      // ring stages, each of 1 or 2 chunks
constexpr int ALIGN = 1024;         // the ring and W_hh start 1024-aligned (128-byte swizzle)
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// dynamic shared memory of one block: the h ring (stages of `boxes` chunks),
// the W_hh slice [ceil64(H) x 4U] bf16, c for each of the block's row tiles,
// the barriers
__host__ __device__ constexpr long long smem_bytes(int B, int H, int units, int groups,
                                                   int stages, int boxes) {
  return (long long)ALIGN + (long long)stages * boxes * CHUNK_BYTES +
         (long long)round_up(H, 64) * 4 * units * 2 +
         (long long)((B + ROWS - 1) / ROWS + groups - 1) / groups * ROWS * units * 4 + BAR_BYTES;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

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

#define F8(i)                                                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N fp32, the warpgroup's fragment) += a (64 x 16 bf16 in registers,
// m64k16 fragments) * b (16 x N bf16, K-major, shared memory). `a` is read
// while the wgmma is in flight: it is an in-out operand so that its
// registers stay its own until a later pin() after the wait.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : F8(0), F8(8), "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(b), "r"(1));
}

#undef F8

// the (lo, mid, hi) A fragments of one k16 step
struct Frag {
  uint32_t t[3][4];
};

__device__ __forceinline__ void pin(Frag& f) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) pin(f.t[p][i]);
}

// The warp's A fragments of k16 step kk of an h chunk in the ring (64 rows x
// 128 bytes, 128-byte swizzle): rows 16 warp + g (+ 8), columns 16 kk + 2 t4
// (+ 8), as wgmma's m64k16 register layout (mma.sync's m16k16 per warp)
__device__ __forceinline__ void load_frag(const unsigned char* chunk, int warp, int g, int t4,
                                          int kk, Frag& f) {
  const unsigned char* r0 = chunk + (16 * warp + g) * 128;  // (16 warp + g) % 8 == g
  const unsigned char* r1 = r0 + 8 * 128;
  const int c0 = ((4 * kk + t4 / 2) ^ g) * 16 + (t4 % 2) * 8;      // columns 16 kk + 2 t4
  const int c1 = ((4 * kk + 2 + t4 / 2) ^ g) * 16 + (t4 % 2) * 8;  // ... + 8
  split3(*reinterpret_cast<const float2*>(r0 + c0), f.t[2][0], f.t[1][0], f.t[0][0]);
  split3(*reinterpret_cast<const float2*>(r1 + c0), f.t[2][1], f.t[1][1], f.t[0][1]);
  split3(*reinterpret_cast<const float2*>(r0 + c1), f.t[2][2], f.t[1][2], f.t[0][2]);
  split3(*reinterpret_cast<const float2*>(r1 + c1), f.t[2][3], f.t[1][3], f.t[0][3]);
}

__device__ __forceinline__ void proxy_fence_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The step barrier, split in two on a global counter that only grows (zeroed
// by the wrapper before the launch): after a step each block adds one with
// release semantics (step_arrive, once its h_t is stored and fenced), and
// before loading h_{t-1} the producer waits with acquire semantics until
// every block has (step_wait). The producer thread does both: a release
// also waits for the issuing thread's own loads in flight, and the
// consumers need no barrier, only the h_{t-1} chunks. A wait longer than
// WATCHDOG_NS traps.
__device__ __forceinline__ void step_arrive(unsigned* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

__device__ __forceinline__ void step_wait(const unsigned* counter, unsigned target) {
  uint64_t t0 = 0;
  for (unsigned n = 1;; ++n) {
    unsigned seen;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    if (seen >= target) return;
    if (n % 1024 == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > WATCHDOG_NS) __trap();
    }
  }
}

template <int UH, int BOXES>  // U = 8 UH hidden units per block; BOXES chunks a ring stage
__global__ void __launch_bounds__(THREADS, 1)
lstm_scan_kernel(const __grid_constant__ CUtensorMap h_map, const float* __restrict__ xw,
                 const __nv_bfloat16* __restrict__ w, float* __restrict__ hs,
                 float* __restrict__ scratch, unsigned* counter, int B, int T, int H, int Hs,
                 int groups, int stages, int reverse) {
  constexpr int U = 8 * UH, N = 4 * U, STAGE_BYTES = BOXES * CHUNK_BYTES;
  extern __shared__ unsigned char smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + ALIGN - 1) & ~uint32_t(ALIGN - 1);
  unsigned char* ring_p = smem + (base - raw);
  const uint32_t ring = base;
  const int Hp = round_up(H, 64);
  unsigned char* wsm = ring_p + stages * STAGE_BYTES;  // [Hp / 64][N][128 bytes], swizzled
  const uint32_t wsm_a = ring + stages * STAGE_BYTES;
  float* cs = reinterpret_cast<float*>(wsm + (size_t)Hp * N * 2);  // [row tiles][ROWS][U]
  const int n_rt = (B + ROWS - 1) / ROWS;
  const int my_tiles = (n_rt + groups - 1) / groups;
  const uint32_t full0 = smem_addr(cs + (size_t)my_tiles * ROWS * U);  // full[i] at +8i
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  const int nb = gridDim.x / groups;
  const int group = blockIdx.x / nb, j0 = (blockIdx.x % nb) * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_chunks = (H + KC - 1) / KC;
  const size_t G4 = 4 * (size_t)H;

  // W_hh's [H x 4U] slice, once: row n = gate q * U + unit u of the block,
  // 8 consecutive k a 16-byte piece, at wgmma's K-major 128-byte-swizzled
  // place (w_offset); rows >= H and units >= H are zero. Where H % 8 == 0 a
  // thread reads an 8 k x 8 unit block in eight 16-byte loads and writes it
  // transposed in eight 16-byte stores; elsewhere one value a load.
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w);
  auto w_offset = [&](int n, int k0) {
    return (k0 / 64) * N * 128 + n * 128 + ((((k0 % 64) / 8) ^ (n % 8)) * 16);
  };
  if (H % 8 == 0) {
    for (int e = threadIdx.x; e < Hp / 8 * 4 * UH; e += THREADS) {
      const int o = e % (4 * UH), k0 = (e / (4 * UH)) * 8;  // o: gate o / UH, units 8 (o % UH) + 0..7
      const int n0 = (o / UH) * U + (o % UH) * 8;
      const size_t col = (size_t)(o / UH) * H + j0 + (o % UH) * 8;
      const bool cols_in = j0 + (o % UH) * 8 < H;  // all 8 units or none (H % 8 == 0)
      uint4 r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        r[i] = cols_in && k0 + i < H ? __ldg(reinterpret_cast<const uint4*>(wb + (size_t)(k0 + i) * G4 + col))
                                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // unit u: its 8 k values, one from each row
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t word = u / 2 == 0 ? r[i].x : u / 2 == 1 ? r[i].y : u / 2 == 2 ? r[i].z : r[i].w;
          v[i] = u % 2 ? word >> 16 : word & 0xffffu;
        }
        *reinterpret_cast<uint4*>(wsm + w_offset(n0 + u, k0)) =
            make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16, v[6] | v[7] << 16);
      }
    }
  } else {
    for (int e = threadIdx.x; e < Hp / 8 * N; e += THREADS) {
      const int n = e % N, k0 = (e / N) * 8;
      const int unit = j0 + n % U;
      const size_t col = (size_t)(n / U) * H + unit;
      uint32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = (unit < H && k0 + i < H) ? __ldg(wb + (size_t)(k0 + i) * G4 + col) : 0u;
      *reinterpret_cast<uint4*>(wsm + w_offset(n, k0)) =
          make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16, v[6] | v[7] << 16);
    }
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);   // the producer's expect_tx
      mbar_init(empty0 + 8 * i, 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // W_hh, written above, for wgmma
  __syncthreads();

  const int n_stages = (n_chunks + BOXES - 1) / BOXES;  // ring stages a row tile a step;
                                                         // a last box past H is zero-filled
  int stage = 0;
  uint32_t phase = 0;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    if (warp == 4) {
      // ---- producer: h_{t-1} (plane (s - 1) % 2 of the scratch), BOXES
      // 32-column boxes a stage
      if (lane == 0 && s > 0) {
        step_wait(counter, (unsigned)s * gridDim.x);  // every block's h_{t-1} is stored
        proxy_fence_global();  // ... and is read by TMA
        for (int rt = group; rt < n_rt; rt += groups)
          for (int st = 0; st < n_stages; ++st) {
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            const uint32_t full = full0 + 8 * stage;
            mbar_expect_tx(full, STAGE_BYTES);
            for (int bx = 0; bx < BOXES; ++bx)
              tma_load_3d(ring + stage * STAGE_BYTES + bx * CHUNK_BYTES, &h_map,
                          (st * BOXES + bx) * KC, rt * ROWS, (s - 1) & 1, full);
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    } else {
      // ---- consumers: each of the group's row tiles
      for (int rt = group, i = 0; rt < n_rt; rt += groups, ++i) {
        // this thread's xw[:, t] entries, in flight while the product runs:
        // [uh][row g / g + 8][unit 2 t4 / 2 t4 + 1][gate]. (Loaded before
        // the step barrier instead, they measured slower.)
        const int mrow = rt * ROWS + 16 * warp;  // the warp's first row
        float xv[UH][2][2][4];
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int b = mrow + g + 8 * r, j = j0 + uh * 8 + 2 * t4 + e;
              const bool in = b < B && j < H;
              const float* x = xw + ((size_t)b * T + t) * G4 + j;
#pragma unroll
              for (int q = 0; q < 4; ++q) xv[uh][r][e][q] = in ? __ldg(x + q * H) : 0.f;
            }

        // one accumulator per bf16 term of h (lo, mid, hi): the small terms
        // are summed apart from the large
        float acc[3][N / 2];
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int q = 0; q < N / 2; ++q) {
            acc[p][q] = 0.f;
            pin(acc[p][q]);
          }

        if (s > 0) {  // h0 = 0: step 0 has no product
          Frag fr[2][2];  // [box parity][k16 step]: one box in flight while the next splits
          int prev = -1;
          // box c (32 columns of h) at `box`: split, 6 wgmma (2 k16 steps x
          // 3 terms); `release`: every product before this box is done, so
          // the previous stage is free
          auto run_box = [&](int c, const unsigned char* box, bool release, Frag (&cur)[2],
                             Frag (&old)[2]) {
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) load_frag(box, warp, g, t4, kk, cur[kk]);
            wgmma_fence();
            const uint32_t wk = wsm_a + (c / 2) * N * 128 + (c % 2) * 64;
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
#pragma unroll
              for (int p = 0; p < 3; ++p)
                wgmma_rs<N>(acc[p], cur[kk].t[p], sw128_desc(wk + 32 * kk));
            wgmma_commit();
            wgmma_wait<1>();  // the previous box's products are done
            pin(old[0]);
            pin(old[1]);
            if (release && prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
          };
          auto next_stage = [&]() {
            prev = stage;
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          };
#pragma unroll 1
          for (int st = 0; st < n_stages; st += 3 - BOXES) {  // a pair of boxes an iteration
            mbar_wait(full0 + 8 * stage, phase);
            const unsigned char* hc = ring_p + stage * STAGE_BYTES;
            run_box(st * BOXES, hc, true, fr[0], fr[1]);
            if constexpr (BOXES == 2) {
              run_box(st * 2 + 1, hc + CHUNK_BYTES, false, fr[1], fr[0]);
              next_stage();
            } else {
              next_stage();
              if (st + 1 < n_stages) {
                mbar_wait(full0 + 8 * stage, phase);
                run_box(st + 1, ring_p + stage * STAGE_BYTES, true, fr[1], fr[0]);
                next_stage();
              }
            }
          }
          wgmma_wait<0>();
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int q = 0; q < N / 2; ++q) pin(acc[p][q]);
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }

        // the cell update: acc[.][4 jb + 2 r + e] is row g + 8 r, column 8 jb
        // + 2 t4 + e, column jb * 8 + ... = gate q * U + unit 8 uh + 2 t4 + e
        float* c_tile = cs + (size_t)i * ROWS * U;
#pragma unroll
        for (int uh = 0; uh < UH; ++uh)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int lr = 16 * warp + g + 8 * r, b = rt * ROWS + lr;
              const int u = uh * 8 + 2 * t4 + e, j = j0 + u;
              if (b >= B || j >= H) continue;
              float gate[4];  // i, f, g, o
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int f = 4 * (q * UH + uh) + 2 * r + e;
                gate[q] = xv[uh][r][e][q] + ((acc[0][f] + acc[1][f]) + acc[2][f]);
              }
              float* c = c_tile + lr * U + u;  // only this thread touches it
              const float cn = sigmoid(gate[1]) * (s == 0 ? 0.f : *c) +
                               sigmoid(gate[0]) * tanhf(gate[2]);
              *c = cn;
              const float hn = sigmoid(gate[3]) * tanhf(cn);
              hs[((size_t)b * T + t) * H + j] = hn;
              scratch[((size_t)(s & 1) * B + b) * Hs + j] = hn;
            }
      }
      proxy_fence_global();  // h_t, written by the generic proxy, is read by TMA next step
    }
    if (s + 1 < T) {
      __syncthreads();  // the block's h_t is stored and fenced
      if (threadIdx.x == 128) step_arrive(counter);
    }
  }
}

// The TMA map of the scratch [2, B, Hs] fp32 (Hs = ceil4(H)): boxes of 32
// columns x 64 rows x 1 plane, 128-byte swizzle, extent H (k >= H zero-filled)
cudaError_t encode_scratch_map(CUtensorMap* map, void* scratch, int B, int H, int Hs) {
  const EncodeTiled encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Hs) * 4,
                                 static_cast<cuuint64_t>(B) * Hs * 4};
  const cuuint32_t box[3] = {KC, ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, scratch, dims, strides, box,
                            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block for (B, H, units, groups, stages,
// boxes), in bytes (the wrapper's launch plan states the same number).
extern "C" long long lstm_scan_smem_bytes(int B, int H, int units, int groups, int stages,
                                          int boxes) {
  return smem_bytes(B, H, units, groups, stages, boxes);
}

// xw [B, T, 4H] fp32; w [H, 4H] bf16; hs [B, T, H] fp32 output; scratch [2,
// B, ceil4(H)] fp32 (16-byte aligned); counter one uint32, zeroed on
// `stream` before the launch. One
// cooperative launch of groups x ceil(H / units) blocks on `stream`, units 8
// or 16, stages 2..8 h chunks in the ring (kernels/lstm_scan.py::
// lstm_scan_plan). Returns a CUDA error code: cudaErrorCooperativeLaunchTooLarge
// if the blocks cannot all be resident at once, else the launch's own.
extern "C" int lstm_scan_launch(const void* xw, const void* w, void* hs, void* scratch,
                                void* counter, int B, int T, int H, int units, int groups,
                                int stages, int boxes, int reverse, void* stream) {
  const void* kernel = nullptr;
  if (units == 8 && boxes == 1) kernel = reinterpret_cast<const void*>(lstm_scan_kernel<1, 1>);
  if (units == 8 && boxes == 2) kernel = reinterpret_cast<const void*>(lstm_scan_kernel<1, 2>);
  if (units == 16 && boxes == 1) kernel = reinterpret_cast<const void*>(lstm_scan_kernel<2, 1>);
  if (units == 16 && boxes == 2) kernel = reinterpret_cast<const void*>(lstm_scan_kernel<2, 2>);
  if (kernel == nullptr || B < 1 || T < 1 || H < 1 || groups < 1 || stages < 2 ||
      stages > MAX_STAGES || boxes < 1 || boxes > 2 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(B, H, units, groups, stages, boxes);
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
  int blocks = groups * ((H + units - 1) / units);
  if (per_sm * n_sm < blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int Hs = round_up(H, 4);
  CUtensorMap map;  // by value into the kernel's parameters (__grid_constant__)
  err = encode_scratch_map(&map, scratch, B, H, Hs);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xw_p = static_cast<const float*>(xw);
  const __nv_bfloat16* w_p = static_cast<const __nv_bfloat16*>(w);
  float* hs_p = static_cast<float*>(hs);
  float* scr_p = static_cast<float*>(scratch);
  unsigned* ctr_p = static_cast<unsigned*>(counter);
  void* args[] = {&map, &xw_p, &w_p, &hs_p, &scr_p, &ctr_p, &B, &T, &H, &Hs, &groups, &stages,
                  &reverse};
  return static_cast<int>(cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args,
                                                      (size_t)smem,
                                                      static_cast<cudaStream_t>(stream)));
}
