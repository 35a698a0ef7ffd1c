"""Where a kernel's time goes: time copies of it with one part removed.

    python -m dlsg_tpu_torch.kernels.breakdown

Run from the root of a checkout on a machine with a CUDA device and nvcc.
Each variant is the kernel's source with the named statements deleted,
built with the package's nvcc flags into `build/dlsg_tpu_torch/breakdown/`
and bound in place of the kernel's library; the wrappers then time it at the
serving path's shapes (CUDA events, mean of back-to-back calls, each variant
twice). A variant computes wrong values: its time says what the removed part
costs, nothing else. Prints one JSON line of microseconds per call.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from dlsg_tpu_torch.kernels import _build, lstm_scan, vocab_head

_MMA = ("mma_bf16(acc[0][j], lo, bw);", "mma_bf16(acc[1][j], mid, bw);",
        "mma_bf16(acc[2][j], hi, bw);")
_LOADS = ("if (c < n_chunks) load_chunk(c);", "if (c + NS - 1 < n_chunks) load_chunk(c + NS - 1);")

# variant -> statements deleted from the source
VARIANTS = {
    lstm_scan.LIBRARY: {
        "whole": (),
        "no_grid_barrier": ("if (s + 1 < T) cg::this_grid().sync();",),
        "no_product": _MMA,  # the h split and fragment loads go with it (dead code)
        "no_h_loads": _LOADS,
        "no_product_no_h_loads": _MMA + _LOADS,
    },
    vocab_head.LIBRARY: {
        "whole": (),
        "no_epilogue": (
            "tile_epilogue<TC_BM>(C, row0, col0, tile, G, V, k, n_tiles, part_v, part_i, "
            "part_m, part_s);",
        ),
        "no_mainloop": ("const int KT = (H + TC_BK - 1) / TC_BK;",),
    },
}
_REPLACE = {"const int KT = (H + TC_BK - 1) / TC_BK;": "const int KT = 0;"}


def _build_variants():
    out = _build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib, variants in VARIANTS.items():
        source = lib.source.read_text()
        for name, cuts in variants.items():
            text = source
            for stmt in cuts:
                if stmt not in text:
                    raise RuntimeError(f"{lib.source.name} no longer has `{stmt}`")
                text = text.replace(stmt, _REPLACE.get(stmt, ""))
            src = out / f"{lib.name}_{name}.cu"
            src.write_text(text)
            so = out / f"lib{lib.name}_{name}.so"
            procs[(lib, name)] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    for (lib, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant of {lib.name}:\n{log}")
    return {key: so for key, (so, _) in procs.items()}


def _bind(lib: _build.CudaLibrary, so) -> None:
    handle = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in lib.signatures.items():
        f = getattr(handle, fn)
        f.argtypes = list(argtypes)
        f.restype = restype
    lib._lib = handle


def _us_per_call(fn, n: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("breakdown: needs a CUDA device")
    builds = _build_variants()
    g = torch.Generator().manual_seed(0)
    # the serving path's shapes: the beam step's vocab head, one encoder direction
    h = torch.tanh(torch.randn(640, 1536, generator=g)).to(torch.bfloat16).cuda()
    w = (torch.randn(1536, 10000, generator=g) * 0.02).to(torch.bfloat16).cuda()
    b = torch.zeros(10000, device="cuda")
    xw = (torch.randn(128, 26, 4096, generator=g) * 0.5).cuda()
    w_hh = (torch.randn(1024, 4096, generator=g) / 32).cuda()
    calls = {
        vocab_head.LIBRARY: ("vocab_head_topk h [640,1536] w [1536,10000] bf16 k=5",
                             lambda: vocab_head.vocab_head_topk(h, w, b, 5), 20),
        lstm_scan.LIBRARY: ("lstm_scan B=128 T=26 H=1024, one direction",
                            lambda: lstm_scan.lstm_scan(xw, w_hh), 10),
    }
    saved = {lib: lib._lib for lib in VARIANTS}
    result = {}
    try:
        for _ in range(2):
            for (lib, name), so in builds.items():
                _bind(lib, so)
                label, fn, n = calls[lib]
                result.setdefault(label, {}).setdefault(name, []).append(_us_per_call(fn, n))
    finally:
        for lib, handle in saved.items():
            lib._lib = handle
    print(json.dumps({"device": torch.cuda.get_device_name(0), "us_per_call": result}), flush=True)


if __name__ == "__main__":
    main()
