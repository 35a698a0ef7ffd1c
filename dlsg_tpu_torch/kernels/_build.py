"""Build the CUDA sources under `csrc/` with nvcc and bind them with ctypes.

Each source is compiled on first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
`build/dlsg_tpu_torch/` beside the package. The library's file name carries
a digest of the source and the flags, so an edited source is never served
from an old build. `build_all` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dlsg_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

Signature = Tuple[Sequence, object]  # (argtypes, restype)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc (CUDA_HOME)")
    return found


class CudaLibrary:
    """One kernel source: its build, its ctypes binding and its launch count.

    `launches` is a plain counter that the kernel's wrapper raises by one each
    time it launches the kernel."""

    def __init__(self, name: str, signatures: Dict[str, Signature]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.signatures = signatures
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._proc: Optional[subprocess.Popen] = None

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for hdr in sorted(CSRC.glob("*.cuh")):
            digest.update(hdr.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def start_build(self) -> None:
        """Start nvcc in the background unless the library is already built."""
        if self._lib is not None or self._proc is not None or self.path().exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path().with_suffix(f".{os.getpid()}.tmp")
        self._proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

    def finish_build(self) -> None:
        """Wait for a started nvcc; raise with its output if it failed."""
        if self._proc is None:
            return
        proc, self._proc = self._proc, None
        out, _ = proc.communicate()
        self.build_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source} (exit {proc.returncode}):\n{out}")
        os.replace(tmp, self.path())

    def load(self) -> ctypes.CDLL:
        """The bound library, built first if needed."""
        if self._lib is None:
            self.start_build()
            self.finish_build()
            lib = ctypes.CDLL(str(self.path()))
            for fn, (argtypes, restype) in self.signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = restype
            self._lib = lib
        return self._lib

    def check(self, err: int) -> None:
        """Raise if a launch function returned a CUDA error code."""
        if err:
            msg = self.load().cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err} ({msg})")


def build_all(libraries: Iterable[CudaLibrary]) -> None:
    """Build several sources with one nvcc each, all running at once."""
    libraries = list(libraries)
    for lib in libraries:
        lib.start_build()
    failures = []
    for lib in libraries:  # wait for every nvcc before raising for one
        try:
            lib.finish_build()
        except RuntimeError as e:
            failures.append(e)
    if failures:
        raise failures[0]
    for lib in libraries:
        lib.load()


# every kernel library exports this, for the messages of `CudaLibrary.check`
ERROR_STRING = {"cuda_error_string": ([ctypes.c_int], ctypes.c_char_p)}
