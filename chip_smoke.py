#!/usr/bin/env python3
"""Drive dlsg_tpu_torch's beam-5 serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device and nvcc, builds the
kernels from `dlsg_tpu_torch/csrc/` into `build/dlsg_tpu_torch/`, and prints
one JSON line per phase:

1. device: the card's name, count and nvidia-smi power limit;
2. build: seconds to build every kernel (one nvcc per source, in parallel);
3. kernel checks: each kernel against its plain PyTorch version at the
   shapes the serving path gives it (MSR-VTT widths, batch 128, beam 5);
4. serving: a Captioner at MSR-VTT widths (bf16 compute, both kernel
   switches on, 10 000-word vocabulary, seeded random weights) warms every
   bucket and answers beam-5 requests of 3, 50 and 128 clips and one greedy
   request, with each kernel's launch count read over that run; then the
   decode time of a 128-clip batch already on the card, and the share of
   tokens that agree with the same decode through the plain versions. It
   must be >= 99% at fp32 compute, and at bf16 with the vocab head swapped
   alone. At bf16 with both swapped it must not fall more than 2 points
   below the plain decode's agreement with itself under a 1e-6 input
   perturbation: random weights give near-tied beams, and bf16 rounding
   spreads the LSTM kernel's ulp-sized differences into different tokens;
5. the `kernels` line (times, bounds, launches), the nvidia-smi line, and as
   the last line `{"ok": true, "device": {...}}`.

Any failure raises, and the script exits nonzero without the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from dlsg_tpu_torch import kernels  # noqa: E402
from dlsg_tpu_torch.config import DLSGConfig, apply_dataset_overrides  # noqa: E402
from dlsg_tpu_torch.evaluation import decode as decode_mod  # noqa: E402
from dlsg_tpu_torch.evaluation.decode import make_decode_fn  # noqa: E402
from dlsg_tpu_torch.kernels.lstm_scan import LIBRARY as LSTM_LIB  # noqa: E402
from dlsg_tpu_torch.kernels.lstm_scan import lstm_scan, lstm_scan_plain  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import LIBRARY as VOCAB_LIB  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk, vocab_head_topk_plain  # noqa: E402
from dlsg_tpu_torch.models.generator import CapGnnModel  # noqa: E402
from dlsg_tpu_torch.ops import lstm as lstm_mod  # noqa: E402
from dlsg_tpu_torch.ops.linear import matmul_f32  # noqa: E402
from dlsg_tpu_torch.serve import Captioner  # noqa: E402
from dlsg_tpu_torch.vocab import Vocabulary  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

VOCAB = 10000
BATCH = 128
BEAM = 5
SEED = 0
REQUESTS = (3, 50, 128)  # land in buckets 8, 64 and 128
TOKEN_AGREEMENT_MIN = 0.99
# bf16 kernel-vs-plain agreement may sit this far below the perturbation floor
BF16_FLOOR_MARGIN = 0.02
DEVICE = "cuda"
KERNEL_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


_FLUSH = None


def _flush_l2() -> None:
    """Overwrite more than the 50 MB L2, so each timed call starts cold as it
    does inside the decode (other weights run between two calls)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    _FLUSH.zero_()


def time_ms(fn, repeats: int = 10, warmup: int = 2, flush: bool = True) -> float:
    """Median milliseconds of `fn` on the card, by CUDA events per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        if flush:
            _flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(ops: float, peak_ops: float, nbytes: float):
    """(least milliseconds for the work, "operations" or "bytes")."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    # fp32 products in full fp32: the plain versions are references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "nvidia_smi": nvidia_smi(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {
        lib.name: [ln.strip() for ln in lib.build_log.splitlines()
                   if "registers" in ln or "spill" in ln]
        for lib in kernels.LIBRARIES
    }
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def check_lstm_scan(cfg: DLSGConfig) -> dict:
    """K2 at the encoder Bi-LSTM's shapes: B=128, T=26, H=1024, both
    directions, against lstm_scan_plain."""
    B, T, H = BATCH, cfg.max_frames, cfg.visual_hidden_size
    g = torch.Generator().manual_seed(SEED)
    xw = (torch.randn(B, T, 4 * H, generator=g) * 0.5).to(DEVICE)
    w_hh = torch.nn.init.orthogonal_(torch.empty(H, 4 * H), generator=g).to(DEVICE)
    err = 0.0
    for reverse in (False, True):
        got = lstm_scan(xw, w_hh, reverse=reverse)
        torch.cuda.synchronize()
        want = lstm_scan_plain(xw, w_hh, reverse=reverse)
        err = max(err, float((got - want).abs().max()))
    if not err <= KERNEL_TOL:
        raise AssertionError(f"lstm_scan differs from its plain version: {err} > {KERNEL_TOL}")
    ops = 2.0 * B * H * 4 * H * (T - 1)  # step 0 multiplies h0 = 0: no product
    nbytes = xw.numel() * 4 + H * 4 * H * 2 + B * T * H * 4
    bms, by = bound_ms(ops, PEAK_FP32, nbytes)
    return {
        "name": "lstm_scan", "route": "cuda", "source": "dlsg_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "dlsg_tpu/ops/pallas/lstm_scan.py:98",
        "shapes": f"xw [{B},{T},{4 * H}] fp32, w_hh [{H},{4 * H}] -> bf16, one direction",
        "max_abs_err": err, "tolerance": KERNEL_TOL,
        "ms": time_ms(lambda: lstm_scan(xw, w_hh)),
        "plain_ms": time_ms(lambda: lstm_scan_plain(xw, w_hh)),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    }


def check_vocab_head(cfg: DLSGConfig) -> dict:
    """K1 at the beam step's shapes: G=640 (128 x beam 5), H=1536,
    V=10000, k=5, bf16 w, against vocab_head_topk_plain."""
    G, H, k = BATCH * BEAM, cfg.decode_hidden_size, BEAM
    g = torch.Generator().manual_seed(SEED + 1)
    h = torch.tanh(torch.randn(G, H, generator=g)).to(DEVICE)  # like tanh(LN(l_h))
    std = (2.0 / (H + VOCAB)) ** 0.5  # xavier-normal, as word_restore
    w = (torch.randn(H, VOCAB, generator=g) * std).to(torch.bfloat16).to(DEVICE)
    b = (torch.randn(VOCAB, generator=g) * 0.01).to(DEVICE)
    vals, ids = vocab_head_topk(h, w, b, k)
    torch.cuda.synchronize()
    pv, pi = vocab_head_topk_plain(h, w, b, k)
    err = float((vals - pv).abs().max())
    logits = h.to(torch.bfloat16).float() @ w.float() + b
    differ = ids != pi
    gap = (logits.gather(1, ids) - logits.gather(1, pi)).abs()
    near_tie_only = bool((gap[differ] <= KERNEL_TOL).all())
    if not (err <= KERNEL_TOL and near_tie_only):
        raise AssertionError(
            f"vocab_head_topk differs from its plain version: vals {err}, "
            f"{int(differ.sum())} ids differ, near-ties only: {near_tie_only}"
        )

    def library():
        hb = h.to(torch.bfloat16)
        lg = matmul_f32(hb, w) + b  # torch.mm(out_dtype=float32) on the card
        return torch.topk(lg, k), torch.logsumexp(lg, dim=-1)

    ops = 2.0 * G * H * VOCAB
    nbytes = h.numel() * 4 + w.numel() * 2 + b.numel() * 4 + G * k * (4 + 8)
    bms, by = bound_ms(ops, PEAK_BF16, nbytes)
    return {
        "name": "vocab_head_topk", "route": "cuda",
        "source": "dlsg_tpu_torch/csrc/vocab_head.cu",
        "replaces": "dlsg_tpu/ops/pallas/vocab_head.py:117",
        "shapes": f"h [{G},{H}] fp32, w [{H},{VOCAB}] bf16, b [{VOCAB}], k={k}",
        "max_abs_err": err, "ids_differ": int(differ.sum()), "tolerance": KERNEL_TOL,
        "ms": time_ms(lambda: vocab_head_topk(h, w, b, k)),
        "plain_ms": time_ms(lambda: vocab_head_topk_plain(h, w, b, k)),
        "bound_ms": bms, "bound_by": by, "library_ms": time_ms(library),
    }


def features(n: int, cfg: DLSGConfig, seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((n, cfg.max_frames, cfg.feature_size), dtype=np.float32)
    regions = rng.standard_normal(
        (n, cfg.max_frames, cfg.num_obj, cfg.region_feature_size), dtype=np.float32
    )
    return frames, regions


def decode_plain(decode, frames, regions, lstm: bool = True, vocab: bool = True):
    """`decode` with the model's kernel call sites (both by default) routed to
    the plain versions: the reference decode. Checks that the swapped
    kernels did not launch."""
    swapped = [lib for lib, on in ((LSTM_LIB, lstm), (VOCAB_LIB, vocab)) if on]
    before = [lib.launches for lib in swapped]
    saved = (lstm_mod.lstm_scan, decode_mod.vocab_head_topk)
    if lstm:
        lstm_mod.lstm_scan = lstm_scan_plain
    if vocab:
        decode_mod.vocab_head_topk = vocab_head_topk_plain
    try:
        ids = decode(frames, regions)
        torch.cuda.synchronize()
    finally:
        lstm_mod.lstm_scan, decode_mod.vocab_head_topk = saved
    if [lib.launches for lib in swapped] != before:
        raise AssertionError("the plain reference decode launched a kernel")
    return ids


def agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a == b).float().mean())


def device_profile(fn, wall_ms: float, top: int = 8) -> dict:
    """Kernel time by name over one call of `fn` (torch.profiler), and the
    share of `wall_ms` (the call's CUDA-event time, taken unprofiled) in
    which the device ran no kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    return {
        "kernel_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if rows else None,
        "top": [{"kernel": k[:90], "calls": n, "ms": ms} for k, n, ms in rows[:top]],
    }


def phase_serving(cfg: DLSGConfig) -> dict:
    vocab = Vocabulary.from_words(f"w{i}" for i in range(VOCAB - 4))
    gen = torch.Generator().manual_seed(SEED)
    params = CapGnnModel(cfg, len(vocab), generator=gen, device="cpu").state_dict()
    captioner = Captioner.from_params(cfg, vocab, params, device=DEVICE)
    reqs = [features(n, cfg, seed=SEED + n) for n in REQUESTS]

    # ---- the main path, with every kernel's launch count read over it ----
    for lib in kernels.LIBRARIES:
        lib.launches = 0
    t0 = time.perf_counter()
    n_buckets = captioner.warmup()
    warmup_s = time.perf_counter() - t0
    answers = [captioner.caption(fr, rg) for fr, rg in reqs]
    greedy = captioner.caption(*reqs[0], greedy=True)
    torch.cuda.synchronize()
    launches = {lib.name: lib.launches for lib in kernels.LIBRARIES}

    for (fr, _), out in zip(reqs, answers):
        if len(out) != fr.shape[0] or not all(isinstance(s, str) for s in out):
            raise AssertionError("a request was not answered with one caption per clip")
    if len(greedy) != REQUESTS[0]:
        raise AssertionError("the greedy request was not answered")
    encodes = n_buckets + len(REQUESTS) + 1  # two lstm_scan calls per encode
    beam_decodes = n_buckets + len(REQUESTS)
    if launches["lstm_scan"] != 2 * encodes:
        raise AssertionError(f"lstm_scan launched {launches['lstm_scan']} times, want {2 * encodes}")
    if not beam_decodes <= launches["vocab_head"] <= beam_decodes * cfg.max_words:
        raise AssertionError(
            f"vocab_head launched {launches['vocab_head']} times for {beam_decodes} beam decodes"
        )

    # ---- timing: a 128-clip batch already on the card ----
    decode = make_decode_fn(captioner.model, cfg, beam_size=BEAM, device=DEVICE)
    fr128 = torch.from_numpy(reqs[-1][0]).to(DEVICE)
    rg128 = torch.from_numpy(reqs[-1][1]).to(DEVICE)
    steps0 = VOCAB_LIB.launches
    ids = decode(fr128, rg128)
    steps = VOCAB_LIB.launches - steps0  # beam steps run (the early exit may stop short)
    with torch.inference_mode():
        obj, mot = captioner.model.encode(fr128, rg128)
    finite = bool(torch.isfinite(obj).all() and torch.isfinite(mot).all())
    if not finite or ids.shape != (BATCH, cfg.max_words) or not bool(
        ((ids >= 0) & (ids < VOCAB)).all()
    ):
        raise AssertionError("the decode gave non-finite proposals or out-of-range ids")
    decode_ms = time_ms(lambda: decode(fr128, rg128), repeats=7, warmup=1, flush=False)
    with torch.inference_mode():
        encode_ms = time_ms(lambda: captioner.model.encode(fr128, rg128), repeats=7, flush=False)
    caption_ms = time_ms(lambda: captioner.caption(*reqs[-1]), repeats=5, warmup=1, flush=False)
    profile = device_profile(lambda: decode(fr128, rg128), decode_ms)

    # ---- the same batch through the plain versions, on the card ----
    # fp32 compute: the two decodes differ only in the kernels' summation order
    cfg32 = replace(cfg, compute_dtype="float32")
    model32 = CapGnnModel(cfg32, VOCAB, device=DEVICE)
    model32.load_state_dict(captioner.model.state_dict())
    decode32 = make_decode_fn(model32, cfg32, beam_size=BEAM, device=DEVICE)
    agree_fp32 = agreement(decode32(fr128, rg128), decode_plain(decode32, fr128, rg128))
    if agree_fp32 < TOKEN_AGREEMENT_MIN:
        raise AssertionError(f"fp32 token agreement with the plain versions {agree_fp32} < 0.99")
    # bf16 compute (the serving config). The vocab head alone swapped for its
    # plain version must agree as at fp32.
    agree_bf16_vocab = agreement(ids, decode_plain(decode, fr128, rg128, lstm=False))
    if agree_bf16_vocab < TOKEN_AGREEMENT_MIN:
        raise AssertionError(
            f"bf16 token agreement with the plain vocab head {agree_bf16_vocab} < 0.99"
        )
    # Both swapped: the lstm_scan kernel's h differs from its plain version by
    # an ulp or two, and the bf16 layers after the Bi-LSTM round that into
    # different tokens wherever random weights leave beams near-tied. So
    # the agreement is held against the plain decode's agreement with itself
    # after a 1e-6 relative perturbation of the frames.
    plain_bf16 = decode_plain(decode, fr128, rg128)
    agree_bf16 = agreement(ids, plain_bf16)
    noise = torch.randn(
        fr128.shape, generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE
    )
    floor_bf16 = agreement(plain_bf16, decode_plain(decode, fr128 * (1 + 1e-6 * noise), rg128))
    if agree_bf16 < floor_bf16 - BF16_FLOOR_MARGIN:
        raise AssertionError(
            f"bf16 token agreement with the plain versions {agree_bf16} is below the "
            f"perturbation floor {floor_bf16} - {BF16_FLOOR_MARGIN}"
        )

    result = {
        "phase": "serving", "config": "msr-vtt, bf16, use_pallas_lstm, fused vocab head",
        "vocab": VOCAB, "beam": BEAM, "buckets": captioner.bucket_sizes(),
        "warmup_s": warmup_s, "requests": list(REQUESTS), "launches": launches,
        "decode_ms_b128": decode_ms, "captions_per_s": BATCH / (decode_ms / 1e3),
        "encode_ms_b128": encode_ms, "beam_steps_b128": steps, "caption_ms_b128_from_host": caption_ms,
        "token_agreement_vs_plain_fp32": agree_fp32,
        "token_agreement_vs_plain_vocab_head_bf16": agree_bf16_vocab,
        "token_agreement_vs_plain_bf16": agree_bf16,
        "bf16_plain_self_agreement_input_1e-6": floor_bf16,
        "profile_b128": profile,
        "sample": answers[0][0], "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(result)
    return result


def main() -> None:
    info = phase_device()
    phase_build()
    cfg = apply_dataset_overrides(
        DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16",
                   use_pallas_lstm=True, use_fused_vocab_head="on")
    )
    checks = [(LSTM_LIB, check_lstm_scan(cfg)), (VOCAB_LIB, check_vocab_head(cfg))]
    launches = phase_serving(cfg)["launches"]
    for lib, entry in checks:
        entry["launches"] = launches[lib.name]
    emit({"kernels": [entry for _, entry in checks]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})


if __name__ == "__main__":
    main()
