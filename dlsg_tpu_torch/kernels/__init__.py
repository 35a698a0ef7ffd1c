"""Hand-written CUDA kernels for Hopper (sm_90a), one module each, with the
plain PyTorch version of the same function beside the wrapper.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. Sources live in `../csrc/`.
"""

from typing import Dict

from dlsg_tpu_torch.kernels import _build, lstm_scan, qmatmul, vocab_head

LIBRARIES = (lstm_scan.LIBRARY, vocab_head.LIBRARY, qmatmul.LIBRARY)


def launch_counts() -> Dict[str, int]:
    """Each kernel's launch counter (`CudaLibrary.launches`) and K1's by
    route (`vocab_head.ROUTE_LAUNCHES`, as `vocab_head[<route>]`)."""
    out = {lib.name: lib.launches for lib in LIBRARIES}
    out.update({f"vocab_head[{r}]": n for r, n in vocab_head.ROUTE_LAUNCHES.items()})
    return out


def add_launches(delta: Dict[str, int]) -> None:
    """The counters of `launch_counts` raised by `delta` (lowered where it
    is negative)."""
    for lib in LIBRARIES:
        lib.launches += delta.get(lib.name, 0)
    for r in vocab_head.ROUTE_LAUNCHES:
        vocab_head.ROUTE_LAUNCHES[r] += delta.get(f"vocab_head[{r}]", 0)


def build_all() -> None:
    """Build every kernel, one nvcc per source, all at once."""
    _build.build_all(LIBRARIES)
