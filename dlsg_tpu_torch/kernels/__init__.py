"""Hand-written CUDA kernels for Hopper (sm_90a), one module each, with the
plain PyTorch version of the same function beside the wrapper.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. Sources live in `../csrc/`.
"""

from dlsg_tpu_torch.kernels import _build, lstm_scan, qmatmul, vocab_head

LIBRARIES = (lstm_scan.LIBRARY, vocab_head.LIBRARY, qmatmul.LIBRARY)


def build_all() -> None:
    """Build every kernel, one nvcc per source, all at once."""
    _build.build_all(LIBRARIES)
