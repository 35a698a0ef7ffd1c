#!/usr/bin/env python3
"""Drive dlsg_tpu_torch's beam-5 serving path and its GAN train step on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device and nvcc, builds the
kernels from `dlsg_tpu_torch/csrc/` into `build/dlsg_tpu_torch/`, and prints
one JSON line per phase:

1. device: the card's name, count and nvidia-smi power limit;
2. build: seconds to build every kernel (one nvcc per source, in parallel),
   ptxas's registers per kernel, and the tensor-core (HMMA) instructions
   `cuobjdump` finds in each library;
3. kernel checks: each kernel against its plain PyTorch version at the
   shapes the serving path gives it (MSR-VTT widths, batch 128, beam 5); the
   vocab head once per tile form, bf16 w (tensor cores, the serving path)
   and fp32 w (SIMT);
4. serving: a Captioner at MSR-VTT widths (bf16 compute, both kernel
   switches on, 10 000-word vocabulary, seeded random weights) warms every
   bucket and answers beam-5 requests of 3, 50 and 128 clips and one greedy
   request, with each kernel's launch count (the vocab head's per tile
   form too) read over that run; then the
   decode time of a 128-clip batch already on the card, and the share of
   tokens that agree with the same decode through the plain versions. It
   must be >= 99% at fp32 compute, and at bf16 with the vocab head swapped
   alone. At bf16 with both swapped it must not fall more than 2 points
   below the plain decode's agreement with itself under a 1e-6 input
   perturbation: random weights give near-tied beams, and bf16 rounding
   spreads the LSTM kernel's ulp-sized differences into different tokens;
5. train: the WGAN-GP train step of CapGnnModel + DiscV2 at MSR-VTT widths
   (bf16 compute, the plain LSTM recurrence under autograd as in the JAX
   train config, 10 000 words, batch 128, seeded random weights): one
   warm-up GAN step, then the median of 3 by CUDA events, the CE step the
   same way, peak memory and a profile of one GAN step. It checks finite
   metrics, that both models moved, num_D_visual D updates per step, lambda
   at its start value while the window fills, no launch of either kernel
   (the train path runs neither, like JAX's), and that 5 CE steps on one
   batch end below the first loss. Then one GAN step at tiny dims on the
   card and on the CPU from the same weights, dropout off and the penalty's
   mixing weights fixed, must give the same Adam first moments, at fp32 and
   at bf16 compute (its own line, `train_card_vs_cpu`). It also records whether `torch.mm(..., out_dtype=)`
   carries a gradient (ops/linear.py's `_MatmulF32` exists for that);
6. the `kernels` line (times, bounds, launches), the nvidia-smi line, and as
   the last line `{"ok": true, "device": {...}}`.

Any failure raises, and the script exits nonzero without the last line.
"""

from __future__ import annotations

import json
import os
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
from dlsg_tpu_torch.kernels.vocab_head import ROUTE_LAUNCHES  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_plan, vocab_head_topk  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk_plain  # noqa: E402
from dlsg_tpu_torch.config import tiny_test_config  # noqa: E402
from dlsg_tpu_torch.models.discriminator import DiscV2  # noqa: E402
from dlsg_tpu_torch.models.generator import CapGnnModel  # noqa: E402
from dlsg_tpu_torch.ops import linear as linear_mod  # noqa: E402
from dlsg_tpu_torch.ops import lstm as lstm_mod  # noqa: E402
from dlsg_tpu_torch.ops.linear import matmul_f32  # noqa: E402
from dlsg_tpu_torch.serve import Captioner  # noqa: E402
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state  # noqa: E402
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer  # noqa: E402
from dlsg_tpu_torch.train.steps import make_ce_train_step, make_gan_train_step  # noqa: E402
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
# the train phase (bench.py's train program: lr 1.6e-4, lambda0 0.01, eps 0.9)
TRAIN_LR = 1.6e-4
LAMBDA0 = 0.01
SS_EPSILON = 0.9
TRAIN_KEY = 7
# card-vs-CPU Adam first moments, as a share of each tensor's max-abs. fp32:
# the two devices differ only in summation order. bf16: the Dense layers
# round their fp32 sums to bf16 (2^-8 relative), and a sum taken in another
# order lands one bf16 ulp away now and then; 5e-2 allows ~13 ulps of the
# largest element after the 5 D updates and the generator's 9-step scans
MOMENT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# ... at this learning rate: Adam's first updates are lr * sign(grad), so an
# element whose gradient sits at rounding level moves by +-lr depending on
# the device, and at lr 1.6e-4 that fed back into D's later substeps by
# 1.1e-4 of a moment's max-abs at fp32 (one tensor of 117, H100 80GB HBM3).
# At 1e-7 the moments compare the gradients, lost ones included
MOMENT_CHECK_LR = 1e-7


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


def sass_mma_count(path) -> int:
    """Tensor-core instructions (HMMA) in a built library's machine code."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    out = subprocess.run(
        [str(Path(cuda_home) / "bin" / "cuobjdump"), "-sass", str(path)],
        capture_output=True, text=True, timeout=120, check=True,
    )
    return sum("HMMA" in ln for ln in out.stdout.splitlines())


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {
        lib.name: [ln.strip() for ln in lib.build_log.splitlines()
                   if "entry function" in ln or "registers" in ln or "spill" in ln]
        for lib in kernels.LIBRARIES
    }
    mma = {lib.name: sass_mma_count(lib.path()) for lib in kernels.LIBRARIES}
    if not all(mma.values()):
        raise AssertionError(f"a kernel library has no tensor-core instruction: {mma}")
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas, "sass_hmma": mma})


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
    # step 0 multiplies h0 = 0: no product. The kernel's product is fp32-exact
    # as three bf16 tensor-core passes (h split into hi + mid + lo), so the
    # least time for the same work is 3x the operations at the bf16 rate.
    ops = 3 * 2.0 * B * H * 4 * H * (T - 1)
    nbytes = xw.numel() * 4 + H * 4 * H * 2 + B * T * H * 4
    bms, by = bound_ms(ops, PEAK_BF16, nbytes)
    return {
        "name": "lstm_scan", "route": "cuda", "source": "dlsg_tpu_torch/csrc/lstm_scan.cu",
        "replaces": "dlsg_tpu/ops/pallas/lstm_scan.py:98",
        "shapes": f"xw [{B},{T},{4 * H}] fp32, w_hh [{H},{4 * H}] -> bf16, one direction",
        "design": "one cooperative launch per direction, W_hh in shared memory, "
                  "3-term bf16 split of h on mma.sync",
        "max_abs_err": err, "tolerance": KERNEL_TOL,
        "ms": time_ms(lambda: lstm_scan(xw, w_hh)),
        "plain_ms": time_ms(lambda: lstm_scan_plain(xw, w_hh)),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    }


def check_vocab_head(cfg: DLSGConfig, w_dtype: torch.dtype) -> dict:
    """K1 at the beam step's shapes: G=640 (128 x beam 5), H=1536,
    V=10000, k=5, against vocab_head_topk_plain. bf16 w takes the
    tensor-core tiles (the serving path), fp32 w the SIMT tiles."""
    G, H, k = BATCH * BEAM, cfg.decode_hidden_size, BEAM
    route = vocab_head_plan(G, VOCAB, w_dtype).route
    g = torch.Generator().manual_seed(SEED + 1)
    h = torch.tanh(torch.randn(G, H, generator=g)).to(DEVICE)  # like tanh(LN(l_h))
    std = (2.0 / (H + VOCAB)) ** 0.5  # xavier-normal, as word_restore
    w = (torch.randn(H, VOCAB, generator=g) * std).to(w_dtype).to(DEVICE)
    b = (torch.randn(VOCAB, generator=g) * 0.01).to(DEVICE)
    vals, ids = vocab_head_topk(h, w, b, k)
    torch.cuda.synchronize()
    pv, pi = vocab_head_topk_plain(h, w, b, k)
    err = float((vals - pv).abs().max())
    logits = h.to(w_dtype).float() @ w.float() + b
    differ = ids != pi
    gap = (logits.gather(1, ids) - logits.gather(1, pi)).abs()
    near_tie_only = bool((gap[differ] <= KERNEL_TOL).all())
    if not (err <= KERNEL_TOL and near_tie_only):
        raise AssertionError(
            f"vocab_head_topk ({route}) differs from its plain version: vals {err}, "
            f"{int(differ.sum())} ids differ, near-ties only: {near_tie_only}"
        )

    def library():
        lg = matmul_f32(h.to(w_dtype), w) + b  # bf16: torch.mm(out_dtype=float32)
        return torch.topk(lg, k), torch.logsumexp(lg, dim=-1)

    ops = 2.0 * G * H * VOCAB
    nbytes = h.numel() * 4 + w.numel() * w.element_size() + b.numel() * 4 + G * k * (4 + 8)
    bms, by = bound_ms(ops, PEAK_BF16 if w_dtype == torch.bfloat16 else PEAK_FP32, nbytes)
    w_name = "bf16" if w_dtype == torch.bfloat16 else "fp32"
    return {
        "name": f"vocab_head_topk[{route}]", "route": "cuda",
        "source": "dlsg_tpu_torch/csrc/vocab_head.cu",
        "replaces": "dlsg_tpu/ops/pallas/vocab_head.py:117",
        "shapes": f"h [{G},{H}] fp32, w [{H},{VOCAB}] {w_name}, b [{VOCAB}], k={k}",
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
        # a range such as Optimizer.step spans kernels counted on their own
        and not getattr(e, "is_user_annotation", False)
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
    for route in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[route] = 0
    t0 = time.perf_counter()
    n_buckets = captioner.warmup()
    warmup_s = time.perf_counter() - t0
    answers = [captioner.caption(fr, rg) for fr, rg in reqs]
    greedy = captioner.caption(*reqs[0], greedy=True)
    torch.cuda.synchronize()
    launches = {lib.name: lib.launches for lib in kernels.LIBRARIES}
    launches.update({f"vocab_head[{r}]": n for r, n in ROUTE_LAUNCHES.items()})

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
    if launches["vocab_head[tensor_cores]"] != launches["vocab_head"]:
        raise AssertionError(f"bf16 serving did not take the tensor-core tiles only: {launches}")

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
    simt0 = ROUTE_LAUNCHES["simt"]
    ids32 = decode32(fr128, rg128)
    simt_fp32_decode = ROUTE_LAUNCHES["simt"] - simt0  # fp32 w: the SIMT tiles
    agree_fp32 = agreement(ids32, decode_plain(decode32, fr128, rg128))
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
        "vocab_head_simt_launches_fp32_decode": simt_fp32_decode,
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


def train_batch(cfg: DLSGConfig, n: int, vocab: int, seed: int, device) -> dict:
    """Features and captions of random lengths (2..max_words, 0-padded)."""
    frames, regions = features(n, cfg, seed)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, cfg.max_words + 1, size=n)
    caps = np.where(
        np.arange(cfg.max_words)[None] < lengths[:, None],
        rng.integers(4, vocab, size=(n, cfg.max_words)), 0,
    )
    return {k: torch.as_tensor(v, device=device) for k, v in
            (("frames", frames), ("regions", regions), ("captions", caps), ("lengths", lengths))}


def probe_mm_out_dtype() -> dict:
    """What the installed torch does with autograd through
    `torch.mm(bf16, bf16, out_dtype=float32)`. A probe of the library, not
    a check of the port: whatever it finds, matmul_f32 differentiates
    through its own autograd.Function."""
    a = torch.randn(8, 16, device=DEVICE, dtype=torch.bfloat16, requires_grad=True)
    b = torch.randn(16, 4, device=DEVICE, dtype=torch.bfloat16, requires_grad=True)
    result = {"torch": torch.__version__}
    try:
        out = torch.mm(a, b, out_dtype=torch.float32)
    except RuntimeError as e:  # the probe's finding, recorded
        return {**result, "forward": f"raises: {str(e)[:160]}"}
    result["forward"] = f"ok, grad_fn={type(out.grad_fn).__name__ if out.grad_fn else None}"
    if out.grad_fn is not None:
        try:
            out.sum().backward()
            result["backward"] = f"ok, a.grad is {'set' if a.grad is not None else 'None'}"
        except RuntimeError as e:  # the probe's finding, recorded
            result["backward"] = f"raises: {str(e)[:160]}"
    return result


def _finite_metrics(m: dict) -> dict:
    out = {k: float(v) for k, v in m.items() if k != "sample_tokens"}
    if not all(np.isfinite(list(out.values()))):
        raise AssertionError(f"non-finite train metrics: {out}")
    return out


def check_train_card_vs_cpu(compute_dtype: str) -> dict:
    """One GAN step at tiny dims on the card and on the CPU from the same
    weights, dropout switched off at its one function, epsilon 1 and fixed
    penalty weights: the Adam first moments ((1 - beta1) grad) of G and D
    must agree, and no tensor may have a moment on one device only."""
    cfg = tiny_test_config(compute_dtype=compute_dtype)
    vocab, n = 50, 4
    batch = train_batch(cfg, n, vocab, SEED + 3, "cpu")
    eps_gp = torch.from_numpy(np.random.default_rng(SEED).uniform(size=(cfg.num_D_visual, n)))
    moments = {}
    saved = linear_mod.dropout
    linear_mod.dropout = lambda x, rate, rng: x
    try:
        for device in ("cpu", DEVICE):
            g = CapGnnModel(cfg, vocab, device=device)  # seeded with cfg.seed
            d = DiscV2(cfg, vocab, device=device)
            gs = TrainState.create(g, make_optimizer(MOMENT_CHECK_LR))
            ds = TrainState.create(d, make_optimizer(MOMENT_CHECK_LR))
            step = make_gan_train_step(g, d, cfg)
            gs, ds, _, m = step(gs, ds, init_lambda_state(LAMBDA0, device=device),
                                {k: v.to(device) for k, v in batch.items()}, TRAIN_KEY, 1.0,
                                eps_gp=eps_gp)
            _finite_metrics(m)
            moments[device] = {**{f"G.{k}": v.float().cpu() for k, v in gs.first_moments().items()},
                               **{f"D.{k}": v.float().cpu() for k, v in ds.first_moments().items()}}
    finally:
        linear_mod.dropout = saved
    tol = MOMENT_TOL[compute_dtype]
    worst, bad = 0.0, []
    for name, want in moments["cpu"].items():
        got = moments[DEVICE][name]
        scale = float(want.abs().max())
        if (scale == 0) != (float(got.abs().max()) == 0):
            bad.append(f"{name}: zero on one device only")
            continue
        ratio = float((got - want).abs().max()) / scale if scale else 0.0
        worst = max(worst, ratio)
        if ratio > tol:
            bad.append(f"{name}: {ratio}")
    if bad:
        raise AssertionError(f"{compute_dtype} card-vs-CPU Adam moments differ: {bad[:8]}")
    return {"tensors": len(moments["cpu"]), "worst_share_of_max_abs": worst, "tolerance": tol}


def phase_train(cfg: DLSGConfig) -> dict:
    """The GAN and CE train steps at MSR-VTT widths (module doc, item 5)."""
    gen = torch.Generator().manual_seed(SEED)
    G = CapGnnModel(cfg, VOCAB, generator=gen, device=DEVICE)
    D = DiscV2(cfg, VOCAB, generator=gen, device=DEVICE)
    batch = train_batch(cfg, BATCH, VOCAB, SEED + 5, DEVICE)
    gs = TrainState.create(G, make_optimizer(TRAIN_LR))
    ds = TrainState.create(D, make_optimizer(TRAIN_LR))
    lstate = init_lambda_state(LAMBDA0, device=DEVICE)
    gan_step = make_gan_train_step(G, D, cfg)
    ce_step = make_ce_train_step(G, cfg)
    g0 = [p.detach().clone() for p in G.parameters()]
    d0 = [p.detach().clone() for p in D.parameters()]

    # ---- the main path, with every kernel's launch count read over it ----
    for lib in kernels.LIBRARIES:
        lib.launches = 0
    torch.cuda.reset_peak_memory_stats()
    metrics, gan_ms = [], []
    for i in range(4):  # one warm-up step, then 3 timed by CUDA events
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gs, ds, lstate, m = gan_step(gs, ds, lstate, batch, TRAIN_KEY, SS_EPSILON)
        end.record()
        end.synchronize()
        metrics.append(_finite_metrics(m))
        if i:
            gan_ms.append(start.elapsed_time(end))
    peak_gan_gb = torch.cuda.max_memory_allocated() / 1e9
    gan_step_ms = float(np.median(gan_ms))

    def one_gan_step():
        nonlocal gs, ds, lstate
        gs, ds, lstate, _ = gan_step(gs, ds, lstate, batch, TRAIN_KEY, SS_EPSILON)

    profile = device_profile(one_gan_step, gan_step_ms)
    torch.cuda.reset_peak_memory_stats()
    ce_state = TrainState.create(G, make_optimizer(TRAIN_LR))
    ce_ms = []
    for i in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ce_state, m = ce_step(ce_state, batch, TRAIN_KEY, SS_EPSILON)
        end.record()
        end.synchronize()
        _finite_metrics(m)
        if i:
            ce_ms.append(start.elapsed_time(end))
    peak_ce_gb = torch.cuda.max_memory_allocated() / 1e9
    # 5 CE steps on one batch at the config's learning rate, all gold words
    ce_state = TrainState.create(G, make_optimizer(cfg.learning_rate))
    ce_losses = []
    for _ in range(5):
        ce_state, m = ce_step(ce_state, batch, TRAIN_KEY, 1.0)
        ce_losses.append(m["cap_loss"])
    ce_losses = [float(x) for x in ce_losses]
    launches = {lib.name: lib.launches for lib in kernels.LIBRARIES}

    steps_run = len(metrics) + 1
    if any(launches.values()):
        raise AssertionError(f"the train path launched a kernel: {launches}")
    if ds.step != steps_run * cfg.num_D_visual or gs.step != steps_run:
        raise AssertionError(f"D took {ds.step} updates and G {gs.step} in {steps_run} GAN steps")
    if any(m["gan_lambda"] != np.float32(LAMBDA0) for m in metrics):
        raise AssertionError(f"lambda left {LAMBDA0} before its window filled: {metrics}")
    moved_g = any(not torch.equal(p, q) for p, q in zip(G.parameters(), g0))
    moved_d = any(not torch.equal(p, q) for p, q in zip(D.parameters(), d0))
    if not (moved_g and moved_d):
        raise AssertionError(f"parameters did not move: G {moved_g}, D {moved_d}")
    if not np.all(np.isfinite(ce_losses)) or not ce_losses[-1] < ce_losses[0]:
        raise AssertionError(f"5 CE steps on one batch did not lower the loss: {ce_losses}")

    result = {
        "phase": "train", "config": "msr-vtt, bf16, plain LSTM recurrence (use_pallas_lstm off)",
        "vocab": VOCAB, "batch": BATCH, "lr": TRAIN_LR, "lambda0": LAMBDA0, "epsilon": SS_EPSILON,
        "num_D_visual": cfg.num_D_visual, "gan_single_forward": cfg.gan_single_forward,
        "launches": launches,
        "gan_step_ms_b128": gan_step_ms, "gan_step_ms_all": gan_ms,
        "clips_per_s_gan": BATCH / (gan_step_ms / 1e3),
        "ce_step_ms_b128": float(np.median(ce_ms)), "ce_step_ms_all": ce_ms,
        "peak_mem_gb_gan": peak_gan_gb, "peak_mem_gb_ce": peak_ce_gb,
        "metrics": metrics, "ce_losses_5_steps": ce_losses,
        "profile_gan_step": profile,
        "mm_out_dtype_autograd_probe": probe_mm_out_dtype(),
    }
    emit(result)
    emit({"phase": "train_card_vs_cpu", "lr": MOMENT_CHECK_LR,
          "fp32": check_train_card_vs_cpu("float32"),
          "bf16": check_train_card_vs_cpu("bfloat16")})
    return result


def main() -> None:
    info = phase_device()
    phase_build()
    cfg = apply_dataset_overrides(
        DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16",
                   use_pallas_lstm=True, use_fused_vocab_head="on")
    )
    # (key of the serving phase's launch counts, kernels line entry); the
    # fp32-w SIMT tiles are off the bf16 serving path and count 0 there
    checks = [
        ("lstm_scan", check_lstm_scan(cfg)),
        ("vocab_head[tensor_cores]", check_vocab_head(cfg, torch.bfloat16)),
        ("vocab_head[simt]", check_vocab_head(cfg, torch.float32)),
    ]
    launches = phase_serving(cfg)["launches"]
    torch.cuda.empty_cache()
    phase_train(apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16")))
    for key, entry in checks:
        entry["launches"] = launches[key]
    emit({"kernels": [entry for _, entry in checks]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})


if __name__ == "__main__":
    main()
