// Hopper building blocks the TMA + wgmma kernels share (qmatmul.cu,
// vocab_head.cu, lstm_scan.cu): mbarriers with a watchdog, TMA tensor loads,
// named barriers, wgmma descriptors and fences, and the host-side lookup of
// cuTensorMapEncodeTiled. Each including source is its own library, so
// everything here has internal linkage.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t WATCHDOG_NS = 10000000000ull;  // a wait this long traps (a lost phase)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait for the completion of the barrier's phase of parity `parity`; a phase
// that does not complete within WATCHDOG_NS traps (a CUDA error the launch's
// caller sees) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (unsigned n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n % 1024 == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > WATCHDOG_NS) __trap();
    }
  }
}

// one box of a 2-D tensor map at coordinates (x, y) (x the contiguous
// dimension) into shared memory, completing its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// the same for a 3-D tensor map at (x, y, z)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// barrier `id` over the 128 threads of one warpgroup
__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma operand descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzle (TMA's SWIZZLE_128B), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving a register that an asynchronous wgmma
// reads or writes (an accumulator, a register operand) across it
__device__ __forceinline__ void pin(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// libraries link no libcuda); nullptr if the driver has none
inline EncodeTiled encode_tiled_fn() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return nullptr;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

}  // namespace
