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
// B=128, H=1024) in fp32 on the CUDA cores, ~16 us at 67 TFLOP/s, against
// 76.5 MB per direction (W_hh 8.4 MB once, xw 54.5 MB, hs 13.6 MB), ~23 us in
// all at 3.35 TB/s. So it is bound by operations, ~0.42 ms per direction.
//
// Design: the TPU kernel kept W_hh in VMEM for all T steps inside one grid
// step. Here the step-to-step dependency crosses every block, so each
// timestep is one launch (lstm_scan_launch issues all T on the caller's
// stream; the launch boundary is the grid-wide barrier) and the 8.4 MB bf16
// W_hh stays in the 50 MB L2 between steps. h_{t-1} is read back from
// hs[:, t_prev], so no separate h buffer exists. A block owns 32 batch rows x
// 16 hidden units and computes all four gate columns of those units, so the
// cell update happens in registers: a thread holds 4 rows x 4 gates of one
// unit. A ragged batch or hidden size is masked, not padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RB = 32;        // batch rows per block
constexpr int UB = 16;        // hidden units per block
constexpr int KB = 32;        // k-slice staged in shared memory
constexpr int THREADS = 128;  // UB units x 8 row groups of 4 rows

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(THREADS)
lstm_step_kernel(const float* __restrict__ xw, const __nv_bfloat16* __restrict__ w,
                 float* __restrict__ hs, float* __restrict__ c, int B, int T, int H,
                 int t, int t_prev, int first) {
  __shared__ float hsm[KB][RB + 1];  // h_{t-1} slice, [k][row]
  __shared__ float wsm[KB][4 * UB];  // W_hh slice, [k][gate * UB + unit]
  const int tid = threadIdx.x;
  const int u = tid % UB, rg = tid / UB;
  const int b0 = blockIdx.y * RB, j0 = blockIdx.x * UB;
  const size_t G4 = 4 * (size_t)H;

  float acc[4][4];  // [row][gate]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;

  if (!first) {
    for (int k0 = 0; k0 < H; k0 += KB) {
      for (int e = tid; e < RB * KB; e += THREADS) {
        const int m = e / KB, kk = e % KB;
        const int b = b0 + m, kx = k0 + kk;
        hsm[kk][m] = (b < B && kx < H) ? hs[((size_t)b * T + t_prev) * H + kx] : 0.f;
      }
      for (int e = tid; e < KB * 4 * UB; e += THREADS) {
        const int kk = e / (4 * UB), cc = e % (4 * UB);
        const int g = cc / UB, j = j0 + cc % UB, kx = k0 + kk;
        wsm[kk][cc] =
            (kx < H && j < H) ? __bfloat162float(w[(size_t)kx * G4 + (size_t)g * H + j]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KB; ++kk) {
        float a[4], wg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = hsm[kk][rg * 4 + i];
#pragma unroll
        for (int g = 0; g < 4; ++g) wg[g] = wsm[kk][g * UB + u];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[i][g] = fmaf(a[i], wg[g], acc[i][g]);
      }
      __syncthreads();
    }
  }

  const int j = j0 + u;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + rg * 4 + i;
    if (b >= B) break;
    const float* x = xw + ((size_t)b * T + t) * G4;
    const float gi = x[j] + acc[i][0];
    const float gf = x[H + j] + acc[i][1];
    const float gg = x[2 * H + j] + acc[i][2];
    const float go = x[3 * H + j] + acc[i][3];
    const float cp = first ? 0.f : c[(size_t)b * H + j];
    const float cn = sigmoid(gf) * cp + sigmoid(gi) * tanhf(gg);
    c[(size_t)b * H + j] = cn;
    hs[((size_t)b * T + t) * H + j] = sigmoid(go) * tanhf(cn);
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xw [B, T, 4H] fp32; w [H, 4H] bf16; hs [B, T, H] fp32 output; c [B, H] fp32
// scratch (its contents are ignored: the first step starts from c0 = 0).
// Issues T launches on `stream`; returns the first nonzero cudaGetLastError().
extern "C" int lstm_scan_launch(const void* xw, const void* w, void* hs, void* c, int B,
                                int T, int H, int reverse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((H + UB - 1) / UB, (B + RB - 1) / RB);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int t_prev = reverse ? t + 1 : t - 1;
    lstm_step_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(xw), static_cast<const __nv_bfloat16*>(w),
        static_cast<float*>(hs), static_cast<float*>(c), B, T, H, t, t_prev, s == 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
