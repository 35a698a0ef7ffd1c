"""Where a kernel's time goes: time copies of it with one part removed or
changed.

    python -m dlsg_tpu_torch.kernels.breakdown [--against OTHER_CHECKOUT]

Run from the root of a checkout on a machine with a CUDA device and nvcc.
Each variant is the kernel's source with the named statements deleted or
replaced, built with the package's nvcc flags (and `-I` its checkout's
`csrc/` for the shared headers) into `build/dlsg_tpu_torch/breakdown/` and
bound in place of the kernel's library; the wrappers then time it at the
serving path's shapes (CUDA events, mean of back-to-back calls, each variant
twice) and by device time without host time (torch.profiler,
`device_us_per_call`, with each kernel's share). A variant with a part
removed computes wrong values: its time says what the removed part costs,
nothing else. The vocab head runs once per w dtype on its persistent
kernel: bf16 w at the beam step's G = 640 and the first step's G = 128, and
at each tile width the plan can choose; fp32 w (its TF32 route, on w split
once as the decoder does) at G = 640 and 128 with V = 10 000 and at G = 640
with a rank's 5 000 columns, each call's top-k logits also held against a
float64 product, so the variants that change the arithmetic (one TF32 pass,
one accumulator) show what the route's accuracy rests on; beside them the
split of the decoder's head, and of h (the launch that the option not taken,
h split apart into shared memory, would add each call; `tf32_h_presplit` is
a proxy of that option's kernel), and each shape's bound. The LSTM scan runs one
direction each way, and also with the plan's row groups, units and
two-chunk stages forced to the alternatives. `--against` builds another
checkout's sources (the parent commit's, unpacked with `git archive`) as
one more variant, timed in the same turns, for a before/after on one card;
an `--against` source whose wrapper module differs from this checkout's (a
changed C interface) runs through that checkout's own wrapper (fed a bare w
where it takes no prepared head). It also times the bf16
beam-5 decode (the serving path) and the fp32 one, each on each checkout's
kernels and wrappers in turns, one decode each a turn. Prints one JSON line of microseconds
per call (and each call's host time: the wrapper's enqueue, no
synchronisation), those errors and ptxas's registers per kernel of each
variant. qmatmul (the int8 decode's product) runs at the
decode's three products at G = 640, each with its int8 bound and its
library yardstick (`int_mm_library`) timed beside it, and the whole kernel
at each tile width the plan can choose.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dlsg_tpu_torch.kernels import _build, lstm_scan, qmatmul, vocab_head

_MMA = ("                wgmma_rs<N>(acc[p], cur[kk].t[p], sw128_desc(wk + 32 * kk));\n",)
_LOADS = ("            mbar_expect_tx(full, STAGE_BYTES);\n"
          "            for (int bx = 0; bx < BOXES; ++bx)\n"
          "              tma_load_3d(ring + stage * STAGE_BYTES + bx * CHUNK_BYTES, &h_map,\n"
          "                          (st * BOXES + bx) * KC, rt * ROWS, (s - 1) & 1, full);\n",)
_KERNELS = ("vh_wgmma_kernel", "tf32x3_tile_kernel", "tf32_split_kernel", "merge_kernel",
            "lstm_scan_kernel", "qmm_wgmma_kernel", "quantize_rows_kernel")
# the int8 decode's products at MSR-VTT widths: (weight, K, N) of Wq, Wl, Wv
QMATMUL_SHAPES = (("Wq", 2860, 4096), ("Wl", 4608, 6144), ("Wv", 1536, 10000))
PEAK_INT8, PEAK_BF16, PEAK_TF32, PEAK_BYTES = 1979e12, 989e12, 495e12, 3.35e12  # H100 SXM, dense, 700 W
# the fp32 route's three products of a k8 step, its register split and its h loads
_TF32_TERMS = ("            wgmma_tf32<BN>(part, ah[kk], sw128_desc(wl + 32 * kk), kk);  // kk 0: fresh sums\n"
               "            wgmma_tf32<BN>(part, al[kk], sw128_desc(wh + 32 * kk), 1);\n"
               "            wgmma_tf32<BN>(part, ah[kk], sw128_desc(wh + 32 * kk), 1);\n")
_SPLIT = ("  hi = tf32_rna(x);\n"
          "  lo = (hi & 0x7f800000u) == 0x7f800000u ? 0u : tf32_rna(x - __uint_as_float(hi));")
_H_LOAD = "            tma_load(dst + i * W_BOX_BYTES, &h_map, kt * BK, m0 + i * W_BOX, full);\n"


_QROW = "  const int chunks = Kp / 16;  // 16-value steps of a row\n"


def _cut(*stmts):
    return {stmt: "" for stmt in stmts}


# variant -> {statement: what replaces it}, per kernel source
VARIANTS = {
    lstm_scan.LIBRARY: {
        "whole": {},
        # the step barrier's wait cut (each block loads h_{t-1} at once)
        "no_grid_barrier": _cut("        step_wait(counter, (unsigned)s * gridDim.x);  "
                                "// every block's h_{t-1} is stored\n"),
        "no_product": {_MMA[0]: "                ;\n"},  # the splits stay (their fragments are pinned)
        # the producer arrives on each stage without loading it
        "no_h_loads": {_LOADS[0]: "            mbar_arrive(full);\n"},
        "no_product_no_h_loads": {_MMA[0]: "                ;\n", _LOADS[0]: "            mbar_arrive(full);\n"},
    },
    vocab_head.LIBRARY: {
        "whole": {},
        # both routes of vh_wgmma_kernel; a test that never passes keeps one
        # read of the accumulators (ptxas drops a wgmma nobody reads)
        "no_epilogue": {
            "      wgmma_epilogue<BN, KL>(acc, bias, row0, col0, tile / MT, G, V, k, n_tiles, "
            "part_v, part_i,\n                             part_m, part_s);\n":
                "      if (acc[0] == 1e30f) part_m[0] = 0.f;\n"},
        "no_mainloop": {"const int KT = (H + BK - 1) / BK;": "const int KT = 0;"},
        # 64-row tiles, one consumer warpgroup a block, same grid (still right)
        "one_consumer": {"constexpr int W_CONSUMERS = 2;": "constexpr int W_CONSUMERS = 1;"},
        # fp32 w (route wgmma_tf32): hi*hi alone, one TF32 pass
        "tf32_one_pass": {_TF32_TERMS: "            wgmma_tf32<BN>(part, ah[kk], sw128_desc(wh + 32 * kk), kk);\n"},
        # every product straight into the tile's accumulators, no k-tile sums
        "tf32_one_accumulator": {
            _TF32_TERMS: _TF32_TERMS.replace("(part,", "(acc,").replace(", kk);", ", 1);"),
            "for (int i = 0; i < BN / 2; ++i) pin(part[i]);": "for (int i = 0; i < BN / 2; ++i) pin(acc[i]);",
            "#pragma unroll\n          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];": ""},
        # raw fp32 bits into the products (wrong values): the split's cost
        "tf32_no_split": {_SPLIT: "  hi = __float_as_uint(x);\n  lo = hi;"},
        # a proxy of the option not taken (h split by a launch of its own,
        # whose time is the split call at h's shape): its bytes, stages of
        # h's hi and lo (loaded as h twice) besides w's, 3 of them, and no
        # split in registers, but still this route's A fragments loaded
        # from shared memory into registers for register-A wgmma, where the
        # option itself would give wgmma both operands by descriptor
        "tf32_h_presplit": {
            "constexpr int W_A_BYTES = W_BM * W_ROW;": "constexpr int W_A_BYTES = 2 * W_BM * W_ROW;",
            "(a_boxes + W_PARTS * b_boxes)": "(2 * a_boxes + W_PARTS * b_boxes)",
            _H_LOAD: "{\n" + _H_LOAD + _H_LOAD.replace("dst + i", "dst + W_BM * W_ROW + i") + "}\n",
            _SPLIT: "  hi = __float_as_uint(x);\n  lo = hi;"},
    },
    qmatmul.LIBRARY: {
        "whole": {},
        "no_mainloop": {"const int KT = (Kp + BK - 1) / BK;": "const int KT = 0;"},
        "no_quantize": {_QROW: _QROW + "  if (K > 0) return;\n"},
        # a store that never happens keeps the products (ptxas drops unread wgmma)
        "no_epilogue": {
            "      store_tile<BN>(acc, epi_wg, s_wg, 1 + wg, sx, s, out, m0, n0, G, N);\n":
                "      if (acc[0] == 0x7fffffff) out[0] = 0.f;\n"},
        # the epilogue staged as before but nothing written to device memory
        "no_store": {"          *reinterpret_cast<float4*>(dst) = v;":
                     "          if (v.x == 1e30f) dst[0] = 0.f;"},
        # 64-row tiles, one consumer warpgroup a block, same grid (still right)
        "one_consumer": {"constexpr int CONSUMERS = 2;": "constexpr int CONSUMERS = 1;"},
    },
}
# the current wrapper module of each library; an --against checkout's own
# wrapper takes its place while its build is bound (`_against_wrappers`)
WRAPPERS = {lstm_scan.LIBRARY: lstm_scan, vocab_head.LIBRARY: vocab_head, qmatmul.LIBRARY: qmatmul}


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
            headers = other.parent if name == "against" else _build.CSRC  # its own csrc/*.cuh
            procs[(lib, name)] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(headers), "-o", str(so), str(src)],
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


def _against_wrappers(against: Optional[Path]) -> dict:
    """library -> the --against checkout's wrapper module, for each library
    whose wrapper file there differs from this checkout's (loaded under
    another name; it binds its own build, `_bind`)."""
    out = {}
    for lib, mod in WRAPPERS.items():
        other = None if against is None else against / "dlsg_tpu_torch" / "kernels" / f"{lib.name}.py"
        if other is None or not other.exists() or other.read_text() == Path(mod.__file__).read_text():
            continue
        spec = importlib.util.spec_from_file_location(f"against_{lib.name}", other)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module  # a dataclass looks its module up while it is built
        spec.loader.exec_module(module)
        out[lib] = module
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


def device_us_per_call(fn, n: int, by_kernel: Optional[dict] = None) -> float:
    """Device microseconds of one `fn` call without its host time: the kernel
    time torch.profiler records over n back-to-back calls, over n; with
    `by_kernel`, each kernel's share is added there under its name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if by_kernel is not None:
        for e in kernels:
            name = next((k for k in _KERNELS if k in e.key), e.key[:60])
            by_kernel[name] = by_kernel.get(name, 0.0) + e.self_device_time_total / n
    return sum(e.self_device_time_total for e in kernels) / n


def _f64_error(h, w, b, k: int, call):
    """Max-abs error of `call()`'s top-k logits (no normalisation) against
    the sorted top-k of a float64 product of h and w."""
    want = torch.topk(h.double() @ w.double() + b.double(), k).values

    def error() -> float:
        return float((call()[0].double() - want).abs().max())

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


def _decode_turns(builds: dict, against_mods: dict, compute_dtype: str, n: int = 10) -> dict:
    """Wall ms of the beam-5 decode of 128 MSR-VTT clips at `compute_dtype`
    (seeded random weights, both kernels on; bf16 is the serving path) in
    this process, in turns: each turn one decode on this checkout's kernels
    and wrappers and one on the --against checkout's (both libraries bound
    to its builds, its wrappers put in the decode's place where they
    differ; a vocab head wrapper that takes no prepared head is handed the
    head as its decoder laid it out, `_bare_head`), the order alternating;
    n turns after one that warms both up."""
    from dlsg_tpu_torch.config import DLSGConfig, apply_dataset_overrides
    from dlsg_tpu_torch.evaluation import decode as decode_mod
    from dlsg_tpu_torch.evaluation.decode import make_decode_fn
    from dlsg_tpu_torch.models.generator import CapGnnModel
    from dlsg_tpu_torch.ops import lstm as lstm_ops

    cfg = apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype=compute_dtype,
                                             use_pallas_lstm=True, use_fused_vocab_head="on"))
    model = CapGnnModel(cfg, 10000, generator=torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    fr = torch.from_numpy(rng.standard_normal((128, cfg.max_frames, cfg.feature_size),
                                              dtype=np.float32)).cuda()
    rg = torch.from_numpy(rng.standard_normal(
        (128, cfg.max_frames, cfg.num_obj, cfg.region_feature_size), dtype=np.float32)).cuda()
    decode = make_decode_fn(model, cfg, beam_size=5, device="cuda")
    libs = {vocab_head.LIBRARY: (decode_mod, "vocab_head_topk"), lstm_scan.LIBRARY: (lstm_ops, "lstm_scan")}
    own = {lib: (lib.load(), getattr(where, name)) for lib, (where, name) in libs.items()}

    def bind(side: str) -> None:
        for lib, (where, name) in libs.items():
            mod = against_mods.get(lib) if side == "against" else None
            if side == "whole":
                lib._lib = own[lib][0]
                setattr(where, name, own[lib][1])
            elif mod is None:
                _bind(lib, builds[(lib, "against")])
            else:
                _bind(mod.LIBRARY, builds[(lib, "against")])
                wrapper = getattr(mod, name)
                if lib is vocab_head.LIBRARY and not hasattr(mod, "PreparedHead"):
                    wrapper = _bare_head(wrapper)
                setattr(where, name, wrapper)

    out = {"whole": [], "against": []}
    try:
        for turn in range(n + 1):
            for side in ("whole", "against") if turn % 2 else ("against", "whole"):
                bind(side)
                torch.cuda.synchronize()
                t = time.perf_counter()
                decode(fr, rg)
                torch.cuda.synchronize()
                if turn:  # the first turn warms both up
                    out[side].append((time.perf_counter() - t) * 1e3)
    finally:
        bind("whole")
    return out


def _bare_head(wrapper):
    """`wrapper` (a vocab head wrapper that takes no PreparedHead) fed the
    head as a decoder without `prepare_head` laid it out once per decode:
    bf16 in rows TMA reads (the prepared head's rows), fp32 contiguous (made
    once for each prepared head, whose split the decode still makes)."""
    last = {}

    def call(h, w, b, k, **kw):
        if isinstance(w, vocab_head.PreparedHead):
            if last.get("head") is not w:
                last.update(head=w, w=w.w.contiguous() if w.parts is not None else w.w)
            w = last["w"]
        return wrapper(h, w, b, k, **kw)

    return call


def _host_us(fn, n: int) -> float:
    """Host microseconds a call takes to enqueue its work: wall clock over n
    back-to-back calls, no synchronisation between them."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return us


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout (say the parent commit's): its csrc/ sources are "
                         "built as variant 'against' (through its own wrappers where they "
                         "differ), and the bf16 and fp32 beam-5 decodes are timed in turns "
                         "on both")
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
    # fp32 w as in chip_smoke.py's check: h = tanh(N(0, 1)), w xavier-normal,
    # split once as the decoder does (this checkout's wrapper); an --against
    # wrapper without the split takes the bare w, contiguous
    h32 = torch.tanh(torch.randn(640, 1536, generator=g)).cuda()
    w32 = (torch.randn(1536, 10000, generator=g) * (2.0 / 11536) ** 0.5).cuda()
    b32 = (torch.randn(10000, generator=g) * 0.01).cuda()
    w5, b5 = w32[:, :5000].contiguous(), b32[:5000].contiguous()  # a rank's columns
    heads = {id(w32): vocab_head.split_head(w32), id(w5): vocab_head.split_head(w5)}
    xw = (torch.randn(128, 26, 4096, generator=g) * 0.5).cuda()
    w_hh = (torch.randn(1024, 4096, generator=g) / 32).cuda()
    shared = ("whole", "against")
    bf16 = lambda n: n in shared or not n.startswith("tf32_")  # noqa: E731
    fp32 = lambda n: n in shared or n in ("no_epilogue", "no_mainloop") or n.startswith("tf32_")  # noqa: E731
    h128, h32_128 = h[:128].contiguous(), h32[:128].contiguous()  # the first beam step's rows
    vh = lambda *a, **kw: WRAPPERS[vocab_head.LIBRARY].vocab_head_topk(*a, **kw)  # noqa: E731
    scan = lambda *a, **kw: WRAPPERS[lstm_scan.LIBRARY].lstm_scan(*a, **kw)  # noqa: E731

    def vh32(hh, ww, bb, **kw):
        """fp32 K1 on the split head where the bound wrapper takes one."""
        own_wrapper = WRAPPERS[vocab_head.LIBRARY] is vocab_head
        return vh(hh, heads[id(ww)] if own_wrapper else ww, bb, 5, **kw)

    def fp32_call(label, hh, ww, bb, times):
        return (f"vocab_head_topk h [{hh.shape[0]},1536] w [1536,{ww.shape[1]}] fp32 k=5" + label,
                lambda: vh32(hh, ww, bb), 20, times,
                _f64_error(hh, ww, bb, 5, lambda: vh32(hh, ww, bb, normalize=False)))

    # library -> [(label, call, calls per timing, variants it times, error or None)]
    calls = {
        vocab_head.LIBRARY: [
            ("vocab_head_topk h [640,1536] w [1536,10000] bf16 k=5",
             lambda: vh(h, w, b, 5), 20, bf16, None),
            ("vocab_head_topk h [128,1536] w [1536,10000] bf16 k=5",
             lambda: vh(h128, w, b, 5), 20, bf16, None),
            fp32_call("", h32, w32, b32, fp32),
            fp32_call("", h32_128, w32, b32, lambda n: n in shared),
            fp32_call(" (a rank's columns)", h32, w5, b5, lambda n: n in shared),
            # the decoder's once-a-decode split of its [V, H] weight, and the
            # split launch over h that the option not taken would add a call
            ("tf32_split w [1536,10000] (a [10000,1536] weight's transpose)",
             lambda w_t=w32.t().contiguous().t(): vocab_head.split_head(w_t), 20,
             lambda n: n == "whole", None),
            ("tf32_split h [640,1536] as [1536,640]", lambda: vocab_head.split_head(h32.t()), 20,
             lambda n: n == "whole", None),
        ],
        lstm_scan.LIBRARY: [("lstm_scan B=128 T=26 H=1024, one direction",
                             lambda: scan(xw, w_hh), 10, lambda n: True, None),
                            ("lstm_scan B=128 T=26 H=1024, reverse",
                             lambda: scan(xw, w_hh, reverse=True), 10, lambda n: n in shared,
                             None)],
    }
    # K2's row groups (the plan: 2 groups of 64 rows x 64 blocks of 16 units)
    # against one group reading the whole batch, at 16 and at 8 units a block,
    # and its stages of two chunks against stages of one
    for units, groups, boxes in ((16, 1, 2), (8, 1, 2), (16, 2, 1)):
        calls[lstm_scan.LIBRARY].append((
            f"lstm_scan B=128 T=26 H=1024, one direction, units={units} groups={groups} "
            f"boxes={boxes}",
            lambda units=units, groups=groups, boxes=boxes: _forced_scan(xw, w_hh, units, groups,
                                                                         boxes), 10,
            lambda n: n == "whole", None))
    from dlsg_tpu_torch.ops.quant import quantize_weight

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    qmm_reference = {}
    calls[qmatmul.LIBRARY] = []
    for name, K, N in QMATMUL_SHAPES:
        qx = torch.tanh(torch.randn(640, K, generator=g)).cuda()
        qw = quantize_weight((torch.randn(K, N, generator=g) / K**0.5).cuda())
        label = f"qmatmul {name} x [640,{K}] fp32, qt [{N},{qmatmul.padded_k(K)}] int8"
        call = lambda qx=qx, qw=qw: WRAPPERS[qmatmul.LIBRARY].qmatmul(qx, *qw)  # noqa: E731
        calls[qmatmul.LIBRARY].append((label, call, 20, lambda n: True, None))
        library = lambda qx=qx, qw=qw: int_mm_library(qx, qw)  # noqa: E731
        plan = qmatmul.qmatmul_plan(640, K, N, n_sm)
        qmm_reference[label] = {
            "bound_us": qmatmul_bound_us(640, K, N),
            "library_us": _us_per_call(library, 20),
            "library_device_us": device_us_per_call(library, 20),
            "plan": {"block_n": plan.block_n, "blocks": plan.blocks, "tiles": list(plan.tiles)},
            "device_us_by_block_n": _by_block_n(call),
        }
    against_mods = _against_wrappers(args.against)
    saved = {lib: lib.load() for lib in VARIANTS}
    own = dict(WRAPPERS)
    result, device, kernel_us, errors, host = {}, {}, {}, {}, {}
    for _ in range(2):
        for (lib, name), so in builds.items():
            mod = against_mods.get(lib) if name == "against" else None
            if mod is not None:  # the other checkout's wrapper binds its own build
                WRAPPERS[lib] = mod
                _bind(mod.LIBRARY, so)
            else:
                _bind(lib, so)
            try:
                for label, fn, n, times, error in calls[lib]:
                    if not times(name):
                        continue
                    result.setdefault(label, {}).setdefault(name, []).append(_us_per_call(fn, n))
                    host.setdefault(label, {}).setdefault(name, []).append(_host_us(fn, n))
                    split = kernel_us.setdefault(label, {}).setdefault(name, {})
                    device.setdefault(label, {}).setdefault(name, []).append(
                        device_us_per_call(fn, n, split))
                    if error is not None:
                        errors.setdefault(label, {})[name] = error()
            finally:  # the other library runs its own build (the decode runs both)
                lib._lib = saved[lib]
                WRAPPERS[lib] = own[lib]
    vh_widths = {f"{dt} G={G} V={ww.shape[1]}": _vocab_head_by_block_n(G, hh, ww, bb)
                 for dt, hh, ww, bb in (("bf16", h, w, b), ("fp32", h32, heads[id(w32)], b32),
                                        ("fp32", h32, heads[id(w5)], b5))
                 for G in (128, 640)}
    bounds = {f"{dt} G={G} V={V}": vocab_head_bound_us(G, 1536, V, dt)
              for dt in (torch.bfloat16, torch.float32) for G in (128, 640) for V in (10000, 5000)}
    # what the fp32 design reads beyond the function's bytes: its hi and lo in w's place
    bounds.update({f"fp32 split w extra us V={V}": 1e6 * (split_bytes(1536, V) - 1536 * V * 4)
                   / PEAK_BYTES for V in (10000, 5000)})
    turns = {} if args.against is None else {
        f"decode_{dt}_beam5_ms_turns": _decode_turns(builds, against_mods, dt)
        for dt in ("bfloat16", "float32")}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "us_per_call": result,
                      "host_us_per_call": host, **turns,
                      "device_us_per_call": device, "device_us_by_kernel_two_runs": kernel_us,
                      "max_abs_err_vs_float64": errors, "qmatmul_bound_and_library": qmm_reference,
                      "vocab_head_device_us_by_block_n": vh_widths, "vocab_head_bound_us": bounds,
                      "registers": registers}), flush=True)


def _by_block_n(call) -> dict:
    """Device microseconds of a qmatmul call at each tile width of the
    plan's choice (qmatmul_plan with block_n forced), the built kernel."""
    chosen = qmatmul.qmatmul_plan
    out = {}
    try:
        for bn in qmatmul.BLOCK_NS:
            qmatmul.qmatmul_plan = lambda G, K, N, n_sm=qmatmul.N_SM, bn=bn: chosen(  # noqa: E731
                G, K, N, n_sm, block_n=bn)
            out[bn] = device_us_per_call(call, 20)
    finally:
        qmatmul.qmatmul_plan = chosen
    return out


def _forced_scan(xw, w_hh, units: int, groups: int, boxes: int):
    """lstm_scan on the plan `_ring` makes at (units, groups, boxes) in
    place of lstm_scan_plan's choice."""
    chosen = lstm_scan.lstm_scan_plan
    lstm_scan.lstm_scan_plan = lambda B, H, **kw: lstm_scan._ring(B, H, units, groups, boxes)
    try:
        return lstm_scan.lstm_scan(xw, w_hh)
    finally:
        lstm_scan.lstm_scan_plan = chosen


def _vocab_head_by_block_n(G: int, h, w, b) -> dict:
    """Device microseconds of the vocab head at G rows for each tile width
    of the persistent kernel (`_wgmma_plan` in place of the plan's choice),
    bf16 w or a split fp32 head."""
    chosen = vocab_head.vocab_head_plan
    hg = h[:G].contiguous()
    out = {}
    try:
        for bn in vocab_head.WGMMA_BLOCK_NS:
            vocab_head.vocab_head_plan = (  # noqa: E731
                lambda G, H, V, dt, n_sm=vocab_head.N_SM, bn=bn: vocab_head._wgmma_plan(G, V, bn, n_sm, dt))
            out[bn] = device_us_per_call(lambda: vocab_head.vocab_head_topk(hg, w, b, 5), 20)
    finally:
        vocab_head.vocab_head_plan = chosen
    return out


def vocab_head_bound_us(G: int, H: int, V: int, dtype) -> float:
    """Least microseconds for K1 at (G, H, V): 2GHV operations at the bf16
    rate, or three times them at the TF32 rate for fp32 w, or the bytes of
    the function (h, w in its dtype, b, the top-5 out, each once) at the
    memory rate, whichever is larger. A split fp32 w's hi and lo, which the
    kernel reads in w's place, are a cost of the design, not of the
    function: `split_bytes`."""
    fp32 = dtype == torch.float32
    ops = (3 if fp32 else 1) * 2.0 * G * H * V / (PEAK_TF32 if fp32 else PEAK_BF16)
    w_bytes = H * V * (4 if fp32 else 2)
    return 1e6 * max(ops, (G * H * 4 + w_bytes + V * 4 + G * 5 * 12) / PEAK_BYTES)


def split_bytes(H: int, V: int) -> int:
    """Bytes of an fp32 w [H, V] split into TF32 hi and lo (`split_head`)."""
    return 2 * V * -(-H // vocab_head.SPLIT_ALIGN) * vocab_head.SPLIT_ALIGN * 4


if __name__ == "__main__":
    main()
