"""Where a kernel's time goes: time copies of it with one part removed or
changed.

    python -m dlsg_tpu_torch.kernels.breakdown [--against OTHER_CHECKOUT]

Run from the root of a checkout on a machine with a CUDA device and nvcc.
Each variant is the kernel's source with the named statements deleted or
replaced, built with the package's nvcc flags into
`build/dlsg_tpu_torch/breakdown/` and bound in place of the kernel's library;
the wrappers then time it at the serving path's shapes (CUDA events, mean of
back-to-back calls, each variant twice). A variant with a part removed
computes wrong values: its time says what the removed part costs, nothing
else. The vocab head runs once per w dtype (both of its tile forms); for fp32
w each variant's top-k logits are also held against a float64 product, so the
variants that change the arithmetic (one TF32 pass, one accumulator) show what
the TF32x3 design's accuracy rests on. `--against` builds another checkout's
sources (the parent commit's, unpacked with `git archive`) as one more
variant, timed in the same turns, for a before/after on one card, and adds
the fp32 beam-5 decode of 128 clips at MSR-VTT widths under the vocab head's
'whole' and 'against' builds (and with the fused head off). Prints one JSON
line of microseconds per call, those errors and ptxas's registers per kernel
of each variant. qmatmul (the int8 decode's product) runs at the decode's
three products at G = 640, each with its int8 bound and its library
yardstick (`int_mm_library`) timed beside it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dlsg_tpu_torch.kernels import _build, lstm_scan, qmatmul, vocab_head

_MMA = ("mma_bf16(acc[0][j], lo, bw);", "mma_bf16(acc[1][j], mid, bw);",
        "mma_bf16(acc[2][j], hi, bw);")
_LOADS = ("if (c < n_chunks) load_chunk(c);", "if (c + NS - 1 < n_chunks) load_chunk(c + NS - 1);")
_KERNELS = ("tc_tile_kernel", "tf32x3_tile_kernel", "merge_kernel", "lstm_scan_kernel",
            "qmm_tile_kernel", "quantize_rows_kernel")
# the int8 decode's products at MSR-VTT widths: (weight, K, N) of Wq, Wl, Wv
QMATMUL_SHAPES = (("Wq", 2860, 4096), ("Wl", 4608, 6144), ("Wv", 1536, 10000))
PEAK_INT8, PEAK_BYTES = 1979e12, 3.35e12  # H100 SXM, dense, 700 W
_SMALL_TERMS = ("mma_tf32(part[i][j], ah, bl[j][0], bl[j][1]);",
                "mma_tf32(part[i][j], al, bh[j][0], bh[j][1]);")


def _cut(*stmts):
    return {stmt: "" for stmt in stmts}


# variant -> {statement: what replaces it}, per kernel source
VARIANTS = {
    lstm_scan.LIBRARY: {
        "whole": {},
        "no_grid_barrier": _cut("if (s + 1 < T) cg::this_grid().sync();"),
        "no_product": _cut(*_MMA),  # the h split and fragment loads go with it (dead code)
        "no_h_loads": _cut(*_LOADS),
        "no_product_no_h_loads": _cut(*_MMA, *_LOADS),
    },
    vocab_head.LIBRARY: {
        "whole": {},
        # bf16 w: tc_tile_kernel
        "no_epilogue": _cut(
            "tile_epilogue<TC_BM>(C, row0, col0, tile, G, V, k, n_tiles, part_v, part_i, "
            "part_m, part_s);"
        ),
        "no_mainloop": {"const int KT = (H + TC_BK - 1) / TC_BK;": "const int KT = 0;"},
        # fp32 w: tf32x3_tile_kernel
        "tf32x3_no_epilogue": _cut(
            "tile_epilogue<F_BM>(C, row0, col0, tile, G, V, k, n_tiles, part_v, part_i, "
            "part_m, part_s);"
        ),
        "tf32x3_no_mainloop": {"const int KT = (H + F_BK - 1) / F_BK;": "const int KT = 0;"},
        "tf32x3_no_split": {  # raw fp32 bits into the mma (wrong values): the split's cost
            "hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));":
                "hi = __float_as_uint(x);\n  lo = hi;"},
        "tf32x3_one_pass": _cut(*_SMALL_TERMS),  # hi*hi alone: one TF32 pass
        "tf32x3_one_accumulator": {  # every mma straight into acc, no k-tile sums
            **{stmt: stmt.replace("part[", "acc[")
               for stmt in (*_SMALL_TERMS, "mma_tf32(part[i][j], ah, bh[j][0], bh[j][1]);")},
            "for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];": ";"},
        "tf32x3_three_stages": {"constexpr int F_STAGES = 4;": "constexpr int F_STAGES = 3;"},
        "tf32x3_integer_rounding": {  # round half away by integer add and mask, no cvt
            'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
            "  return r & 0xffffe000u;": "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"},
    },
    qmatmul.LIBRARY: {
        "whole": {},
        "no_mainloop": {"const int KT = (Kp + BK - 1) / BK;": "const int KT = 0;"},
        "no_quantize": {"  const int row = blockIdx.x;\n":
                        "  const int row = blockIdx.x;\n  if (K > 0) return;\n"},
        "no_epilogue": {"      if (m >= G) continue;": "      if (m >= 0) continue;"},
    },
}


def _build_variants(against: Optional[Path]):
    out = _build.BUILD_DIR / "breakdown"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lib, variants in VARIANTS.items():
        source = lib.source.read_text()
        texts = {}
        for name, edits in variants.items():
            text = source
            for stmt, new in edits.items():
                if stmt not in text:
                    raise RuntimeError(f"{lib.source.name} no longer has `{stmt}`")
                text = text.replace(stmt, new)
            texts[name] = text
        other = None if against is None else against / "dlsg_tpu_torch" / "csrc" / lib.source.name
        if other is not None and other.exists():  # a parent may lack a newer kernel
            texts["against"] = other.read_text()
        for name, text in texts.items():
            src = out / f"{lib.name}_{name}.cu"
            src.write_text(text)
            so = out / f"lib{lib.name}_{name}.so"
            procs[(lib, name)] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    builds, registers = {}, {}
    for (lib, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant of {lib.name}:\n{log}")
        builds[(lib, name)] = so
        registers[f"{lib.name}/{name}"] = _registers(log)
    return builds, registers


def _registers(ptxas_log: str) -> dict:
    """ptxas's "Used N registers" line of each kernel (entry) in a build log."""
    out, entry = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            entry = next((k for k in _KERNELS if k in m.group(1)), m.group(1))
        elif entry and "registers" in line:
            out[entry] = line.split(":", 1)[-1].strip()
            entry = None
    return out


def _bind(lib: _build.CudaLibrary, so) -> None:
    handle = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in lib.signatures.items():
        if not hasattr(handle, fn):  # an --against source may lack a newer export
            continue
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


def _f64_error(h, w, b, k: int):
    """Max-abs error of a call's top-k logits (no normalisation) against the
    sorted top-k of a float64 product."""
    want = torch.topk(h.double() @ w.double() + b.double(), k).values

    def error() -> float:
        vals, _ = vocab_head.vocab_head_topk(h, w, b, k, normalize=False)
        return float((vals.double() - want).abs().max())

    return error


def int_mm_library(x: torch.Tensor, w) -> torch.Tensor:
    """qmatmul's library yardstick (one PyTorch call for the product, never
    called by the port): the plain row quantization, torch._int_mm on K
    padded to Kp (a multiple of 32, hence of the 8 it needs) with the
    weight's K-major layout, then the rescale."""
    xq, sx = qmatmul.quantize_rows_plain(x)
    xq8 = torch.nn.functional.pad(xq, (0, w.qt.shape[1] - x.shape[1])).to(torch.int8)
    return torch._int_mm(xq8, w.qt.t()).float() * sx * w.s[None, :]


def qmatmul_bound_us(G: int, K: int, N: int) -> float:
    """Least microseconds for qmatmul at (G, K, N): 2GKN operations at the
    int8 rate or x, the int8 weight, its scales and the output once through
    memory, whichever is larger."""
    nbytes = G * K * 4 + N * qmatmul.padded_k(K) + N * 4 + G * N * 4
    return 1e6 * max(2.0 * G * K * N / PEAK_INT8, nbytes / PEAK_BYTES)


def _decode_calls(n_clips: int = 128, vocab: int = 10000):
    """The fp32 beam-5 decode of `n_clips` MSR-VTT clips (seeded random
    weights, both kernel switches on), with the fused vocab head on and off."""
    from dlsg_tpu_torch.config import DLSGConfig, apply_dataset_overrides
    from dlsg_tpu_torch.evaluation.decode import make_decode_fn
    from dlsg_tpu_torch.models.generator import CapGnnModel

    cfg = apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="float32",
                                             use_pallas_lstm=True, use_fused_vocab_head="on"))
    model = CapGnnModel(cfg, vocab, generator=torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    fr = torch.from_numpy(rng.standard_normal((n_clips, cfg.max_frames, cfg.feature_size),
                                              dtype=np.float32)).cuda()
    rg = torch.from_numpy(rng.standard_normal(
        (n_clips, cfg.max_frames, cfg.num_obj, cfg.region_feature_size), dtype=np.float32)).cuda()
    on = make_decode_fn(model, cfg, beam_size=5, device="cuda")
    off = make_decode_fn(model, replace(cfg, use_fused_vocab_head="off"), beam_size=5, device="cuda")
    return {"fused_on": lambda: on(fr, rg), "fused_off": lambda: off(fr, rg)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout (say the parent commit's): its csrc/ sources, which "
                         "must keep this one's C interface, are built as variant 'against', "
                         "and the fp32 beam-5 decode is timed under both vocab head builds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("breakdown: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    builds, registers = _build_variants(args.against)
    g = torch.Generator().manual_seed(0)
    # the serving path's shapes: the beam step's vocab head, one encoder direction
    h = torch.tanh(torch.randn(640, 1536, generator=g)).to(torch.bfloat16).cuda()
    w = (torch.randn(1536, 10000, generator=g) * 0.02).to(torch.bfloat16).cuda()
    b = torch.zeros(10000, device="cuda")
    # fp32 w as in chip_smoke.py's check: h = tanh(N(0, 1)), w xavier-normal
    h32 = torch.tanh(torch.randn(640, 1536, generator=g)).cuda()
    w32 = (torch.randn(1536, 10000, generator=g) * (2.0 / 11536) ** 0.5).cuda()
    b32 = (torch.randn(10000, generator=g) * 0.01).cuda()
    xw = (torch.randn(128, 26, 4096, generator=g) * 0.5).cuda()
    w_hh = (torch.randn(1024, 4096, generator=g) / 32).cuda()
    shared = ("whole", "against")
    bf16 = lambda n: n in shared or not n.startswith("tf32x3_")  # noqa: E731
    fp32 = lambda n: n in shared or n.startswith("tf32x3_")  # noqa: E731
    # library -> [(label, call, calls per timing, variants it times, error or None)]
    calls = {
        vocab_head.LIBRARY: [
            ("vocab_head_topk h [640,1536] w [1536,10000] bf16 k=5",
             lambda: vocab_head.vocab_head_topk(h, w, b, 5), 20, bf16, None),
            ("vocab_head_topk h [640,1536] w [1536,10000] fp32 k=5",
             lambda: vocab_head.vocab_head_topk(h32, w32, b32, 5), 20, fp32,
             _f64_error(h32, w32, b32, 5)),
        ],
        lstm_scan.LIBRARY: [("lstm_scan B=128 T=26 H=1024, one direction",
                             lambda: lstm_scan.lstm_scan(xw, w_hh), 10, lambda n: True, None)],
    }
    from dlsg_tpu_torch.ops.quant import quantize_weight

    qmm_reference = {}
    calls[qmatmul.LIBRARY] = []
    for name, K, N in QMATMUL_SHAPES:
        qx = torch.tanh(torch.randn(640, K, generator=g)).cuda()
        qw = quantize_weight((torch.randn(K, N, generator=g) / K**0.5).cuda())
        label = f"qmatmul {name} x [640,{K}] fp32, qt [{N},{qmatmul.padded_k(K)}] int8"
        calls[qmatmul.LIBRARY].append(
            (label, lambda qx=qx, qw=qw: qmatmul.qmatmul(qx, *qw), 20, lambda n: True, None))
        qmm_reference[label] = {
            "bound_us": qmatmul_bound_us(640, K, N),
            "library_us": _us_per_call(lambda qx=qx, qw=qw: int_mm_library(qx, qw), 20),
        }
    if args.against is not None:
        decode = _decode_calls()
        label = "decode fp32 beam-5 128 msr-vtt clips, fused vocab head"
        calls[vocab_head.LIBRARY].append(
            (label + " on", decode["fused_on"], 3, lambda n: n in shared, None))
        calls[vocab_head.LIBRARY].append(
            (label + " off", decode["fused_off"], 3, lambda n: n == "whole", None))
    saved = {lib: lib.load() for lib in VARIANTS}
    result, errors = {}, {}
    for _ in range(2):
        for (lib, name), so in builds.items():
            _bind(lib, so)
            try:
                for label, fn, n, times, error in calls[lib]:
                    if not times(name):
                        continue
                    result.setdefault(label, {}).setdefault(name, []).append(_us_per_call(fn, n))
                    if error is not None:
                        errors.setdefault(label, {})[name] = error()
            finally:  # the other library runs its own build (the decode runs both)
                lib._lib = saved[lib]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "us_per_call": result,
                      "max_abs_err_vs_float64": errors, "qmatmul_bound_and_library": qmm_reference,
                      "registers": registers}), flush=True)


if __name__ == "__main__":
    main()
