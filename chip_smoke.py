#!/usr/bin/env python3
"""Drive dlsg_tpu_torch's beam-5 serving path (the Captioner, the two-pass
decode, the HTTP server, `cli serve`/`export`), its GAN train step, its
trainer, its C++ scorer and its data parallelism on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device, nvcc and g++,
builds the kernels from `dlsg_tpu_torch/csrc/` and the scorer library from
`dlsg_tpu_torch/native/` into `build/dlsg_tpu_torch/`, and prints one JSON
line per phase:

1. device: the card's name, count and nvidia-smi power limit;
2. build: seconds to build every kernel (one nvcc per source, in parallel,
   with g++ building the scorer library beside them), ptxas's registers per
   kernel, and the tensor-core (HMMA) instructions `cuobjdump` finds in each
   library;
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
4b. two_pass: the same weights and config with decode_two_pass_t1 = 8 and
   the default bucket (32 rows), batch 128, in three regimes: the random
   weights (every row runs to 26 tokens: pass 2 re-decodes the whole
   batch), <end>'s bias raised until 25-75% of the rows finish within t1
   (more rows unfinished than the bucket: the whole batch again), and until
   78-95% do (the compacted bucket). Each gives the single-pass and
   two-pass decode ms (median of 7 CUDA-event timings), beam steps and
   launches; the rows pass 1 finished must equal the single pass's ids
   bitwise at bf16 and at fp32, the re-decoded rows agree >= 99% at fp32,
   and at bf16 the agreement is held to the serving phase's perturbation
   rule;
4c. server: CaptionServer over the warmed serving Captioner on 127.0.0.1 in
   a thread: an .npz request of 32 clips (~253 MB), a JSON request of 2 and
   a greedy .npz request of 8, whose captions must equal caption()'s on the
   same arrays, both kernels launched for each beam request; a malformed
   body gets a 400, /healthz names the card, /metrics counts it all; then
   the request's latency against caption() alone;
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
6. trainer: `RunGAN` at MSR-VTT widths (bf16 compute, the fused vocab head
   on, 10 000 words, 128 synthetic videos with 2 captions each: 2 GAN steps
   of batch 128 and 2 beam-5 evals of the 128 clips an epoch, checkpoints
   on) trains epoch 0; a second RunGAN on the same results resumes from the
   latest checkpoint, must hold its parameters, Adam state, step counters and
   lambda state bitwise, and trains epoch 1. It checks the logged losses
   (finite, every tag), the step counters (G 2 then 4, D 10 then 20), both
   epoch checkpoints, all seven finite scores per eval, the vocab head
   launched on the tensor-core tiles on every beam step of every eval decode
   (between 1 and max_words launches per eval) and no lstm_scan launch; then
   the final generator's eval decode against the same decode with the plain
   vocab head (token agreement >= 99%), and `cli train --synthetic` at tiny
   dims on the card. Its line gives the epoch seconds, the Stopwatch spans,
   decode against scoring seconds per eval, the scorer's seconds for 128
   26-word captions (where Python METEOR is slowest), save_train /
   restore_train seconds and bytes, and peak memory. Its evals score
   through the C++ tokenizer and METEOR aligner (the line counts the pairs
   aligned there);
6b. scorer: the 128 26-word captions scored through the C++ path and the
   Python path: all seven scores equal; the seconds of each and of the
   library's build;
6c. cli_serve: `cli export --allow_random_params --synthetic`, `cli serve
   --bundle --features --output` (its lines must equal caption()'s) and
   `cli evaluate --torch_checkpoint` of a reference-schema .pt written here,
   at tiny dims on the card with both kernel switches on;
6d. data_parallel (parallel/dist.py; the card's machine has one card, and
   NCCL puts no two ranks on one card): (a) the main path, `python -m
   torch.distributed.run --nproc_per_node=1 chip_smoke.py --cli-rank DIR
   train --distributed ...`, which runs `cli.main` (the `-m
   dlsg_tpu_torch.cli` entry point) in the rank and records its kernel
   launches, the gradient all-reduces (CUDA-event ms, bytes) and the eval
   gathers: `cli train --synthetic` at MSR-VTT widths (bf16, fused vocab
   head, 10 000 words, 2 GAN steps of batch 64, 2 evals, checkpoints on)
   over NCCL at world size 1, then the same command without a process group
   and the same seed: the epoch_0 checkpoints must be equal bitwise (NCCL's
   sum over one rank is exact) and so must every logged loss and score;
   the vocab head must launch on the tensor-core tiles in each eval, the
   LSTM kernel never. (b) `--gan-rank`: one GAN step at MSR-VTT widths,
   fp32, dropout off, epsilon 1, fixed penalty weights, lr 1e-7, over two
   ranks x 64 on the one card over gloo against one process x 128: the two
   ranks' parameters must be equal bitwise and their Adam first moments
   within train_card_vs_cpu's fp32 tolerance of the single process's. Its
   line gives each run's seconds and step ms, the gradient bytes and
   all-reduce ms per GAN step, the gather seconds and peak memory;
7. the `kernels` line (times, bounds, launches on each path: serving,
   two_pass, server, train, trainer, cli_serve, data_parallel), the
   nvidia-smi line, and as the last line
   `{"ok": true, "device": {...}}`.

Any failure raises, and the script exits nonzero without the last line.

Not driven here: the loader's worker pool (`data/parallel_loader.py`, behind
`loader_workers > 0`). Only the HDF5 datasets have workers, as in the JAX
package, and the card's machine has no h5py; the CPU tests hold it
(tests/test_torch_parallel_loader.py).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from dlsg_tpu_torch import checkpoint as ckpt_mod  # noqa: E402
from dlsg_tpu_torch import cli  # noqa: E402
from dlsg_tpu_torch import kernels  # noqa: E402
from dlsg_tpu_torch import native  # noqa: E402
from dlsg_tpu_torch.config import DLSGConfig, apply_dataset_overrides, parse_opt  # noqa: E402
from dlsg_tpu_torch.evaluation import decode as decode_mod  # noqa: E402
from dlsg_tpu_torch.evaluation.decode import make_decode_fn  # noqa: E402
from dlsg_tpu_torch.kernels.lstm_scan import LIBRARY as LSTM_LIB  # noqa: E402
from dlsg_tpu_torch.kernels.lstm_scan import lstm_scan, lstm_scan_plain  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import LIBRARY as VOCAB_LIB  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import ROUTE_LAUNCHES  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_plan, vocab_head_topk  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk_plain  # noqa: E402
from dlsg_tpu_torch.config import tiny_test_config  # noqa: E402
from dlsg_tpu_torch.data.loader import eval_batches  # noqa: E402
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab  # noqa: E402
from dlsg_tpu_torch.metrics.scorer import score_captions  # noqa: E402
from dlsg_tpu_torch.models.discriminator import DiscV2  # noqa: E402
from dlsg_tpu_torch.models.generator import CapGnnModel  # noqa: E402
from dlsg_tpu_torch.ops import linear as linear_mod  # noqa: E402
from dlsg_tpu_torch.ops import lstm as lstm_mod  # noqa: E402
from dlsg_tpu_torch.ops.linear import matmul_f32  # noqa: E402
from dlsg_tpu_torch.serve import Captioner, jsonable_id  # noqa: E402
from dlsg_tpu_torch.server import CaptionServer  # noqa: E402
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state  # noqa: E402
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer  # noqa: E402
from dlsg_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from dlsg_tpu_torch.train.steps import make_ce_train_step, make_gan_train_step  # noqa: E402
from dlsg_tpu_torch.vocab import END_ID, Vocabulary  # noqa: E402

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
# the trainer phase: 128 videos x 2 captions = 2 GAN steps of batch 128 an
# epoch; saving_schedule(epoch, 2) evaluates after steps 1 and 2
TRAINER_VIDEOS = 128
SCORE_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")
TRAINER_TAGS = ("Loss/cap_loss", "Loss/G_v_loss", "Loss/D_loss_visual",
                "Loss/wasserstein_visual", "parameter/gan_lambda")
# `cli train --synthetic` on the card: tiny dims (tests/test_cli_realdata.py)
CLI_DIMS = [
    "--train_batch_size", "4", "--test_batch_size", "4", "--beam_size", "2",
    "--visual_hidden_size", "32", "--region_projected_size", "32",
    "--query_hidden_size", "32", "--decode_hidden_size", "32",
    "--word_size", "16", "--gan_word_size", "16",
    "--num_proposals", "2", "--num_obj", "3", "--num_topk", "2",
    "--max_frames", "6", "--max_words", "8",
    "--a_feature_size", "24", "--m_feature_size", "12", "--region_feature_size", "20",
]
CLI_FLAGS = ["--synthetic", "--synthetic_videos", "8", "--epoch_num", "1", "--no_debug"] + CLI_DIMS
# the two-pass phase: pass 1 runs t1 beam steps; each regime is the share of
# rows whose beams all end within them that <end>'s bias is searched for
# (None: the random weights as they are)
TWO_PASS_T1 = 8
TWO_PASS_REGIMES = (("random", None), ("mixed", (0.25, 0.75)), ("bucket", (0.78, 0.95)))
# the server phase: one .npz body of this many MSR-VTT clips (~253 MB of fp32
# features; 64 clips would come close to MAX_BODY_BYTES), a JSON body of 2
# and a greedy .npz of 8
SERVER_CLIPS = 32
# the data_parallel phase. (a): `cli train` at MSR-VTT widths, 43 synthetic
# videos x 3 captions = 2 GAN steps of batch 64 and, by saving_schedule(0, 2),
# an eval of the 43 clips after each, checkpoints on; (b): one GAN step of
# 2 ranks x DP_RANK_BATCH against 1 x 2 DP_RANK_BATCH
DP_FLAGS = ["--dataset", "msr-vtt", "--compute_dtype", "bfloat16", "--use_fused_vocab_head", "on",
            "--synthetic", "--synthetic_videos", "43", "--synthetic_vocab", str(VOCAB),
            "--train_batch_size", "64", "--test_batch_size", "64", "--epoch_num", "1", "--no_debug"]
DP_RANK_BATCH = 64
DP_TIMEOUT = 600  # seconds, each torchrun or cli process


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


def reset_launches() -> None:
    for lib in kernels.LIBRARIES:
        lib.launches = 0
    for route in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[route] = 0


def read_launches() -> dict:
    out = {lib.name: lib.launches for lib in kernels.LIBRARIES}
    out.update({f"vocab_head[{r}]": n for r, n in ROUTE_LAUNCHES.items()})
    return out


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


def phase_build() -> float:
    """Build the CUDA kernels (one nvcc each) and, beside them, the C++
    scorer library (g++); returns the scorer's build seconds."""
    native_build = {}

    def build_native():
        t = time.perf_counter()
        try:
            native.load()
        except Exception as e:  # re-raised below, in the main thread
            native_build["error"] = e
        native_build["s"] = time.perf_counter() - t

    scorer_build = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    scorer_build.start()
    kernels.build_all()
    seconds = time.perf_counter() - t0
    scorer_build.join()
    if "error" in native_build:
        raise native_build["error"]
    ptxas = {
        lib.name: [ln.strip() for ln in lib.build_log.splitlines()
                   if "entry function" in ln or "registers" in ln or "spill" in ln]
        for lib in kernels.LIBRARIES
    }
    mma = {lib.name: sass_mma_count(lib.path()) for lib in kernels.LIBRARIES}
    if not all(mma.values()):
        raise AssertionError(f"a kernel library has no tensor-core instruction: {mma}")
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas, "sass_hmma": mma,
          "scorer_library_s": native_build["s"], "scorer_library": native.library_path().name})
    return native_build["s"]


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


def serving_model(cfg: DLSGConfig):
    """The serving phases' vocabulary and seeded random weights (a state_dict
    on the host)."""
    vocab = Vocabulary.from_words(f"w{i}" for i in range(VOCAB - 4))
    gen = torch.Generator().manual_seed(SEED)
    return vocab, CapGnnModel(cfg, len(vocab), generator=gen, device="cpu").state_dict()


def phase_serving(cfg: DLSGConfig, vocab: Vocabulary, params: dict) -> dict:
    captioner = Captioner.from_params(cfg, vocab, params, device=DEVICE)
    reqs = [features(n, cfg, seed=SEED + n) for n in REQUESTS]

    # ---- the main path, with every kernel's launch count read over it ----
    reset_launches()
    t0 = time.perf_counter()
    n_buckets = captioner.warmup()
    warmup_s = time.perf_counter() - t0
    answers = [captioner.caption(fr, rg) for fr, rg in reqs]
    greedy = captioner.caption(*reqs[0], greedy=True)
    torch.cuda.synchronize()
    launches = read_launches()

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
    reset_launches()
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
    launches = read_launches()

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


@contextlib.contextmanager
def timed_calls(module, name: str, log: list):
    """Replace `module.name` while the block runs with a wrapper that appends
    (seconds, result) of each call to `log`."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        log.append((time.perf_counter() - t0, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def _check_resumed(runner, path: str) -> None:
    """The resumed runner's G/D parameters, Adam state, step counters and
    lambda state equal the checkpoint's, bitwise."""
    saved = torch.load(path, map_location=DEVICE, weights_only=True)
    bad = []

    def same(a, b, name):
        if not (torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b)):
            bad.append(name)

    for prefix, state in (("gen", runner.gen_state), ("disc", runner.disc_state)):
        if state.step != saved[f"{prefix}_step"]:
            bad.append(f"{prefix}_step")
        for k, v in state.module.state_dict().items():
            same(v, saved[f"{prefix}_params"][k], f"{prefix}.{k}")
        opt = state.optimizer.state_dict()
        if len(opt["state"]) != len(state.params) or opt["param_groups"] != saved[f"{prefix}_opt"]["param_groups"]:
            bad.append(f"{prefix}_opt layout")
        for i, st in opt["state"].items():
            for k, v in st.items():
                same(v, saved[f"{prefix}_opt"]["state"][i][k], f"{prefix}_opt.{i}.{k}")
    for k, v in runner.lambda_state.items():
        same(v, saved["gan_lambda_state"][k], f"lambda.{k}")
    if bad:
        raise AssertionError(f"the resumed trainer differs from its checkpoint: {bad[:8]}")


def phase_trainer(cfg: DLSGConfig, vocab_size: int, num_videos: int):
    """RunGAN, its resume and `cli train` on the card (module doc, item 6).
    Returns the phase's line, and the references with the 26-word captions
    that the scorer phase scores again."""
    vocab = make_vocab(extra_words=vocab_size - len(make_vocab()))
    if len(vocab) != vocab_size:
        raise AssertionError(f"the vocabulary has {len(vocab)} words, want {vocab_size}")
    t0 = time.perf_counter()
    ds = SyntheticDataset(cfg, vocab, num_videos=num_videos, captions_per_video=2)
    data_s = time.perf_counter() - t0
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_")
    cfg = replace(cfg, result_dir=os.path.join(work.name, "results"))
    evals, saves, restores, epochs, stopwatch, aligned = [], [], [], [], [], []

    # ---- the main path, with every kernel's launch count read over it ----
    reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    real_evaluate = trainer_mod.evaluate

    def counted_evaluate(*args, **kw):
        k1, tc = VOCAB_LIB.launches, ROUTE_LAUNCHES["tensor_cores"]
        t = time.perf_counter()
        out = real_evaluate(*args, **kw)
        evals.append({"seconds": time.perf_counter() - t, "infer_s": out[3],
                      "k1_launches": VOCAB_LIB.launches - k1,
                      "k1_tensor_core_launches": ROUTE_LAUNCHES["tensor_cores"] - tc,
                      "scores": out[0]})
        return out

    trainer_mod.evaluate = counted_evaluate
    runners = []
    try:
        with timed_calls(ckpt_mod, "save_train", saves), \
                timed_calls(ckpt_mod, "restore_train", restores), \
                timed_calls(native, "meteor_stats", aligned):
            for epoch_num, resume in ((1, None), (2, "latest")):
                t = time.perf_counter()
                runner = trainer_mod.RunGAN(
                    replace(cfg, epoch_num=epoch_num), vocab, ds, ds.eval_view(), ds.references,
                    is_debug=False, resume_epoch=resume, device=DEVICE,
                )
                build_s = time.perf_counter() - t
                if resume is not None:
                    if runner.last_epoch != 0:
                        raise AssertionError(f"resume picked epoch {runner.last_epoch}, want 0")
                    _check_resumed(runner, os.path.join(cfg.checkpoint_dir, "epoch_0", ckpt_mod.TRAIN_FILE))
                torch.cuda.synchronize()
                t = time.perf_counter()
                runner.train()
                torch.cuda.synchronize()
                epochs.append({"epoch": epoch_num - 1, "seconds": time.perf_counter() - t,
                               "build_s": build_s,
                               "steps_g_d": [runner.gen_state.step, runner.disc_state.step]})
                stopwatch.append({k: {"total_s": runner.stopwatch.totals[k],
                                      "spans": runner.stopwatch.counts[k]}
                                  for k in runner.stopwatch.totals})
                runners.append(runner)
    finally:
        trainer_mod.evaluate = real_evaluate
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # ---- checks ----
    steps_per_epoch = len(ds) // cfg.train_batch_size
    want_steps = [[steps_per_epoch * e, steps_per_epoch * e * cfg.num_D_visual] for e in (1, 2)]
    if [e["steps_g_d"] for e in epochs] != want_steps:
        raise AssertionError(f"step counters {[e['steps_g_d'] for e in epochs]}, want {want_steps}")
    for e in (0, 1):
        if not os.path.exists(os.path.join(cfg.checkpoint_dir, f"epoch_{e}", ckpt_mod.TRAIN_FILE)):
            raise AssertionError(f"no epoch_{e} checkpoint")
    log_path = os.path.join(cfg.result_dir, runners[-1].base_name, "logs", "scalars.jsonl")
    with open(log_path) as f:
        scalars = [json.loads(ln) for ln in f]
    tags = {s["tag"] for s in scalars}
    if not set(TRAINER_TAGS) <= tags or not any(t.startswith("results/") for t in tags):
        raise AssertionError(f"scalars.jsonl lacks tags: {sorted(tags)}")
    if not all(np.isfinite(s["value"]) for s in scalars):
        raise AssertionError("a logged scalar is not finite")
    if len(evals) != 4:
        raise AssertionError(f"{len(evals)} evals, want 2 an epoch")
    for ev in evals:
        if set(ev["scores"]) != set(SCORE_KEYS) or not all(np.isfinite(list(ev["scores"].values()))):
            raise AssertionError(f"eval scores: {ev['scores']}")
        if not 1 <= ev["k1_launches"] <= cfg.max_words or ev["k1_tensor_core_launches"] != ev["k1_launches"]:
            raise AssertionError(f"vocab_head launches of an eval decode: {ev}")
    if launches["lstm_scan"] != 0:
        raise AssertionError(f"the trainer launched lstm_scan: {launches}")
    if launches["vocab_head"] != sum(ev["k1_launches"] for ev in evals):
        raise AssertionError(f"vocab_head launched outside the eval decodes: {launches}")
    cpp_pairs = sum(out is not None for _, out in aligned)
    if not cpp_pairs or cpp_pairs != len(aligned):
        raise AssertionError(f"the evals aligned {len(aligned) - cpp_pairs} of {len(aligned)} "
                             "METEOR pairs outside the C++ aligner")

    # ---- the final generator's eval decode against the plain vocab head ----
    final = runners[-1]
    decode = make_decode_fn(final.gen_model, final.cfg, beam_size=final.cfg.beam_size, device=DEVICE)
    batch = next(eval_batches(ds.eval_view(), final.cfg.test_batch_size))
    fr = torch.from_numpy(batch["frames"]).to(DEVICE)
    rg = torch.from_numpy(batch["regions"]).to(DEVICE)
    ids = decode(fr, rg)
    agree = agreement(ids, decode_plain(decode, fr, rg, lstm=False))
    if agree < TOKEN_AGREEMENT_MIN:
        raise AssertionError(f"trainer eval decode agreement with the plain vocab head {agree} < 0.99")
    # the scorer's cost where Python METEOR is slowest: 26-word captions of
    # the references' own words (many candidate matches), one per clip
    rng = np.random.default_rng(SEED)
    words = sorted({w for caps in ds.references.values() for c in caps for w in c.split()})
    babble = {vid: " ".join(rng.choice(words, size=cfg.max_words)) for vid in ds.references}
    t = time.perf_counter()
    babble_scores = score_captions(ds.references, babble)
    babble_s = time.perf_counter() - t
    if not all(np.isfinite(list(babble_scores.values()))):
        raise AssertionError(f"scores of the 26-word captions: {babble_scores}")
    size = os.path.getsize(os.path.join(cfg.checkpoint_dir, "epoch_0", ckpt_mod.TRAIN_FILE))
    best = sorted(d for d in os.listdir(cfg.checkpoint_dir) if d.startswith("best_"))
    del runners, final, decode
    torch.cuda.empty_cache()

    # ---- `cli train` on the card, the device left at its default ----
    t = time.perf_counter()
    rc = cli.main(["train", "--result_dir", os.path.join(work.name, "cli")] + CLI_FLAGS)
    cli_s = time.perf_counter() - t
    if rc != 0 or not os.path.exists(os.path.join(work.name, "cli", "checkpoints", "epoch_0")):
        raise AssertionError(f"cli train returned {rc} or wrote no checkpoint")
    work.cleanup()

    result = {
        "phase": "trainer",
        "config": "RunGAN, msr-vtt, bf16, fused vocab head, use_pallas_lstm off",
        "vocab": vocab_size, "videos": num_videos, "captions": len(ds),
        "batch": cfg.train_batch_size, "beam": cfg.beam_size, "synthetic_data_s": data_s,
        "epochs": epochs, "stopwatch": stopwatch,
        "evals": [{k: v for k, v in ev.items() if k != "scores"}
                  | {"scoring_s": ev["seconds"] - ev["infer_s"], "CIDEr": ev["scores"]["CIDEr"],
                     "METEOR": ev["scores"]["METEOR"]} for ev in evals],
        "scoring": f"C++ tokenizer and METEOR aligner (dlsg_tpu_torch/native): {cpp_pairs} "
                   "pairs aligned in the evals",
        "scoring_s_26_word_captions": babble_s, "scoring_26_word_captions_METEOR":
            babble_scores["METEOR"],
        "save_train_s": [s for s, _ in saves], "checkpoint_bytes": size,
        "restore_train_s": [s for s, _ in restores], "best_models": best,
        "launches": launches, "peak_mem_gb": peak_gb,
        "token_agreement_vs_plain_vocab_head_bf16": agree,
        "resume": "exact (parameters, Adam state, steps, lambda state)",
        "cli_train_s": cli_s,
    }
    emit(result)
    return result, ds.references, babble

# ------------------------------------------------------- the two-pass decode


def finished_after(model, cfg: DLSGConfig, fr, rg, steps: int) -> torch.Tensor:
    """[B] bool: the rows whose beams have all emitted <end> after `steps`
    beam steps (what the two-pass decode's pass 1 reads)."""
    beam_feats = decode_mod._make_beam_from_feats(model, cfg, BEAM)
    with torch.inference_mode():
        obj, mot = model.encode(fr, rg)
        return beam_feats(obj, mot, steps)[3]


def search_end_bias(model, cfg: DLSGConfig, fr, rg, base: float, lo: float, hi: float):
    """Raise <end>'s bias in the vocab head (bisection; the share of rows
    finished within TWO_PASS_T1 steps grows with it) until that share lies
    in [lo, hi]. Returns (bias added, share)."""
    bias = model.get_parameter("decoder.step.word_restore.bias")
    a, b = 0.0, 64.0
    for _ in range(30):
        m = (a + b) / 2
        with torch.no_grad():
            bias[END_ID] = base + m
        share = float(finished_after(model, cfg, fr, rg, TWO_PASS_T1).float().mean())
        if share < lo:
            a = m
        elif share > hi:
            b = m
        else:
            return m, share
    raise AssertionError(f"no <end> bias in [{a}, {b}] finishes {lo}-{hi} of the rows")


def phase_two_pass(cfg: DLSGConfig, params: dict) -> dict:
    """The two-pass decode (decode_two_pass_t1 = 8, default bucket) against
    the single pass at the serving config, one regime per TWO_PASS_REGIMES
    entry: each regime's main path is one two-pass decode, with the launch
    counts read over it."""
    model = CapGnnModel(cfg, VOCAB, device=DEVICE)
    model.load_state_dict(params)
    cfg32 = replace(cfg, compute_dtype="float32")
    model32 = CapGnnModel(cfg32, VOCAB, device=DEVICE)
    two_cfg = replace(cfg, decode_two_pass_t1=TWO_PASS_T1)
    single = make_decode_fn(model, cfg, beam_size=BEAM, device=DEVICE)
    two = make_decode_fn(model, two_cfg, beam_size=BEAM, device=DEVICE)
    single32 = make_decode_fn(model32, cfg32, beam_size=BEAM, device=DEVICE)
    two32 = make_decode_fn(model32, replace(two_cfg, compute_dtype="float32"), beam_size=BEAM,
                           device=DEVICE)
    fr, rg = (torch.from_numpy(a).to(DEVICE) for a in features(BATCH, cfg, seed=SEED + 11))
    noise = torch.randn(fr.shape, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                        device=DEVICE)
    bias = model.get_parameter("decoder.step.word_restore.bias")
    base = float(bias.detach()[END_ID])
    bucket = max(1, min(BATCH, cfg.decode_two_pass_bucket or BATCH // 4))
    regimes, launches = [], {}
    for name, window in TWO_PASS_REGIMES:
        if window is None:
            end_bias = 0.0
        else:
            end_bias, _ = search_end_bias(model, cfg, fr, rg, base, *window)
        with torch.no_grad():
            bias[END_ID] = base + end_bias
        model32.load_state_dict(model.state_dict())
        fin = finished_after(model, cfg, fr, rg, TWO_PASS_T1)
        n_unfin = int((~fin).sum())
        branch = "none" if n_unfin == 0 else ("bucket" if n_unfin <= bucket else "full batch")

        # ---- the main path: one two-pass decode, every launch count read over it ----
        reset_launches()
        ids_two = two(fr, rg)
        torch.cuda.synchronize()
        launches[name] = read_launches()
        k1 = VOCAB_LIB.launches
        ids_one = single(fr, rg)
        steps_single = VOCAB_LIB.launches - k1
        n = launches[name]
        if n["lstm_scan"] != 2 or not 1 <= n["vocab_head"] <= TWO_PASS_T1 + cfg.max_words \
                or n["vocab_head[tensor_cores]"] != n["vocab_head"]:
            raise AssertionError(f"two-pass decode ({name}) launches: {n}")
        if ids_two.shape != (BATCH, cfg.max_words) or not torch.equal(ids_two[fin], ids_one[fin]):
            raise AssertionError(f"two-pass ({name}): the rows pass 1 finished differ at bf16")
        agree = agreement(ids_two, ids_one)
        floor = agreement(ids_one, single(fr * (1 + 1e-6 * noise), rg))
        if agree < floor - BF16_FLOOR_MARGIN:
            raise AssertionError(f"two-pass ({name}) bf16 agreement {agree} is below the "
                                 f"perturbation floor {floor} - {BF16_FLOOR_MARGIN}")
        # fp32: pass 1's first t1 steps have the single pass's shapes, so the
        # rows it finished are bitwise the single pass's; the re-decoded rows
        # (a bucket's GEMMs may sum in another order) agree >= 99%
        fin32 = finished_after(model32, cfg32, fr, rg, TWO_PASS_T1)
        a32, b32 = single32(fr, rg), two32(fr, rg)
        if not torch.equal(a32[fin32], b32[fin32]):
            raise AssertionError(f"two-pass ({name}): the rows pass 1 finished differ at fp32")
        agree32 = agreement(a32[~fin32], b32[~fin32]) if bool((~fin32).any()) else 1.0
        if agree32 < TOKEN_AGREEMENT_MIN:
            raise AssertionError(f"two-pass ({name}): re-decoded rows agree {agree32} < 0.99 at fp32")
        regimes.append({
            "regime": name, "end_bias_added": end_bias,
            "finished_share_after_t1": float(fin.float().mean()),
            "finished_share_after_t1_fp32": float(fin32.float().mean()),
            "unfinished_rows": n_unfin, "pass2": branch,
            "single_ms": time_ms(lambda: single(fr, rg), repeats=7, warmup=1, flush=False),
            "two_pass_ms": time_ms(lambda: two(fr, rg), repeats=7, warmup=1, flush=False),
            "beam_steps_single": steps_single, "beam_steps_two_pass": n["vocab_head"],
            "launches_two_pass": n,
            "token_agreement_bf16": agree, "bf16_self_agreement_input_1e-6": floor,
            "token_agreement_redecoded_fp32": agree32,
            "mean_caption_tokens": float((ids_one != END_ID).sum(dim=1).float().mean()),
        })
    result = {"phase": "two_pass", "config": "msr-vtt, bf16, use_pallas_lstm, fused vocab head",
              "batch": BATCH, "beam": BEAM, "t1": TWO_PASS_T1, "bucket": bucket,
              "regimes": regimes}
    emit(result)
    result["launches"] = {k: sum(n[k] for n in launches.values()) for k in launches["random"]}
    return result


# ------------------------------------------------------------------- server


def http(url: str, body: bytes = None, content_type: str = "application/x-npz"):
    """(status, decoded reply, ms) of one request; an HTTP error is a reply."""
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            status, raw, ctype = r.status, r.read(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    ms = (time.perf_counter() - t) * 1e3
    return status, (json.loads(raw) if "json" in ctype else raw.decode()), ms


def npz_body(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def phase_server(cfg: DLSGConfig, vocab: Vocabulary, params: dict) -> dict:
    """CaptionServer over the serving Captioner (warmed), in a thread on
    127.0.0.1: an .npz request of SERVER_CLIPS clips, a JSON request of 2
    and a greedy .npz request of 8 (the main path), a malformed one, then
    /healthz, /metrics, and the request latency against caption() alone."""
    captioner = Captioner.from_params(cfg, vocab, params, device=DEVICE)
    captioner.warmup()
    server = CaptionServer(captioner, "127.0.0.1", 0)
    server.start_background()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        fr, rg = features(SERVER_CLIPS, cfg, seed=SEED + 21)
        vids = np.array([f"video{7010 + i}" for i in range(SERVER_CLIPS)])
        body = npz_body(frames=fr, regions=rg, video_ids=vids)
        fr2, rg2 = features(2, cfg, seed=SEED + 22)
        json_body = json.dumps({"frames": fr2.tolist(), "regions": rg2.tolist(),
                                "video_ids": [7, 8]}).encode()
        fr8, rg8 = features(8, cfg, seed=SEED + 23)

        # ---- the main path, with every kernel's launch count read over it ----
        reset_launches()
        replies = [http(f"{url}/caption", body)]
        k1_npz = VOCAB_LIB.launches
        replies.append(http(f"{url}/caption", json_body, "application/json"))
        k1_json = VOCAB_LIB.launches - k1_npz
        replies.append(http(f"{url}/caption?greedy=1", npz_body(frames=fr8, regions=rg8)))
        launches = read_launches()

        bad = http(f"{url}/caption", b"garbage", "application/json")
        _, health, _ = http(f"{url}/healthz")
        _, metrics_text, _ = http(f"{url}/metrics")
        metrics = {ln.split()[0]: float(ln.split()[1]) for ln in metrics_text.splitlines()
                   if ln and not ln.startswith("#")}
        if [r[0] for r in replies] != [200, 200, 200] or bad[0] != 400:
            raise AssertionError(f"statuses {[r[0] for r in replies]} and {bad[0]} for the bad body")
        want = [(vids, captioner.caption(fr, rg)), ([7, 8], captioner.caption(fr2, rg2)),
                (range(8), captioner.caption(fr8, rg8, greedy=True))]
        for (_, payload, _), (ids, caps) in zip(replies, want):
            got = [(c["video_id"], c["caption"]) for c in payload["captions"]]
            if got != [(jsonable_id(v), c) for v, c in zip(ids, caps)]:
                raise AssertionError(f"the server's captions differ from caption(): {got[:2]}")
        if not (k1_npz >= 1 and k1_json >= 1 and launches["lstm_scan"] == 2 * 3
                and launches["vocab_head"] == k1_npz + k1_json
                and launches["vocab_head[tensor_cores]"] == launches["vocab_head"]):
            raise AssertionError(f"server launches: {launches}, K1 {k1_npz} + {k1_json}")
        if health.get("device_name") != torch.cuda.get_device_name(0) or \
                health.get("devices") != torch.cuda.device_count() or health.get("warm") is not True:
            raise AssertionError(f"/healthz: {health}")
        counted = (metrics["dlsg_requests_total"], metrics["dlsg_clips_total"],
                   metrics["dlsg_errors_total"], metrics["dlsg_request_latency_seconds_count"])
        if counted != (4, SERVER_CLIPS + 2 + 8, 1, 3):
            raise AssertionError(f"/metrics counted {counted}")

        # ---- latency: the request against caption() alone on the same arrays ----
        request_ms, server_s, caption_ms = [], [], []
        for _ in range(3):
            status, payload, ms = http(f"{url}/caption", body)
            request_ms.append(ms)
            server_s.append(payload["latency_s"])
            torch.cuda.synchronize()
            t = time.perf_counter()
            captioner.caption(fr, rg)
            caption_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        server.shutdown()
        server.server_close()
    result = {
        "phase": "server", "config": "msr-vtt, bf16, use_pallas_lstm, fused vocab head, warmed",
        "npz_clips": SERVER_CLIPS, "npz_body_mb": len(body) / 1e6,
        "json_body_mb": len(json_body) / 1e6, "launches": launches,
        "healthz": health, "metrics": dict(zip(("requests", "clips", "errors", "latencies"), counted)),
        "request_ms_npz": float(np.median(request_ms)), "request_ms_npz_all": request_ms,
        "server_latency_ms_npz": 1e3 * float(np.median(server_s)),
        "caption_ms_same_clips": float(np.median(caption_ms)), "caption_ms_all": caption_ms,
        "request_ms_json_2_clips": replies[1][2], "request_ms_greedy_8_clips": replies[2][2],
        "sample": replies[0][1]["captions"][0],
    }
    emit(result)
    return result


# ------------------------------------------------------------------- scorer


def phase_scorer(references: dict, captions: dict, build_s: float) -> dict:
    """The trainer phase's 26-word captions scored through the C++ tokenizer
    and aligner and through the Python ones: the seven scores must be equal."""
    t = time.perf_counter()
    cpp = score_captions(references, captions)
    cpp_s = time.perf_counter() - t
    saved = native.ptb_tokenize, native.meteor_stats
    native.ptb_tokenize = native.meteor_stats = lambda *args, **kw: None  # the Python path
    try:
        t = time.perf_counter()
        py = score_captions(references, captions)
        py_s = time.perf_counter() - t
    finally:
        native.ptb_tokenize, native.meteor_stats = saved
    if set(cpp) != set(SCORE_KEYS) or cpp != py:
        raise AssertionError(f"C++ scores {cpp} differ from the Python path's {py}")
    result = {"phase": "scorer", "captions": len(captions),
              "words_per_caption": len(next(iter(captions.values())).split()),
              "cpp_s": cpp_s, "python_s": py_s, "python_over_cpp": py_s / cpp_s,
              "library_build_s": build_s, "library": native.library_path().name, "scores": cpp}
    emit(result)
    return result


# -------------------------------------------------------- cli serve / export


def reference_state_dict(cfg: DLSGConfig, vocab_size: int, seed: int) -> dict:
    """A random state_dict with the key set and shapes of the reference
    CapGnnModel (run_gun.py:302-310 `model_state_dict`), its dead parameters
    included; tests/test_convert.py builds the same set."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(key, *shape):
        sd[key] = torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32))

    def linear(key, fin, fout, bias=True):
        t(f"{key}.weight", fout, fin)
        if bias:
            t(f"{key}.bias", fout)

    def ln(key, d):
        t(f"{key}.weight", d)
        t(f"{key}.bias", d)

    def lstm(key, fin, h, sfx=""):  # sfx "_l0" / "_l0_reverse": nn.LSTM; "": LSTMCell
        for name, shape in (("weight_ih", (4 * h, fin)), ("weight_hh", (4 * h, h)),
                            ("bias_ih", (4 * h,)), ("bias_hh", (4 * h,))):
            t(f"{key}.{name}{sfx}", *shape)

    def att(key, vin, kin, out, norm=True):
        for name, fin in (("K", vin), ("Q", kin), ("V", vin)):
            linear(f"{key}.{name}", fin, out, bias=False)
        if norm:  # AttentionShare
            linear(f"{key}.output_layer.0", out, out, bias=False)
            ln(f"{key}.output_layer.2", out)

    H, Q, D = cfg.visual_hidden_size, cfg.query_hidden_size, cfg.decode_hidden_size
    for branch, vin in (("obj_encoder", cfg.a_feature_size), ("motion_encoder", None)):
        key = f"encoder.{branch}"
        if vin is not None:
            linear(f"{key}.visual_embed", vin, H)
        ln(f"{key}.visual_norm.1", H)
        if cfg.num_obj > 4:
            linear(f"{key}.obj_embed", cfg.region_feature_size, cfg.region_projected_size)
            ln(f"{key}.obj_norm.1", cfg.region_projected_size)
            ln(f"{key}.obj_visual_norm.1", H)
        t(f"{key}.v2l_layer.theta", cfg.num_proposals, H)
        ln(f"{key}.v2l_layer.out_norm.1", H)
        ln(f"{key}.att_l2l_norm", H)  # dead in the reference's forward
    pre = "encoder.motion_pre_encoder"
    linear(f"{pre}.linear_embed", cfg.a_feature_size + cfg.m_feature_size, H)
    lstm(f"{pre}.lstm", H, H, "_l0")
    lstm(f"{pre}.lstm", H, H, "_l0_reverse")
    ln(f"{pre}.layernorm_lstm", 2 * H)
    att(f"{pre}.self_attention", 2 * H, 2 * H, 2 * H, norm=False)
    linear(f"{pre}.self_attention.output_layer.0", 2 * H, H, bias=False)
    ln(f"{pre}.layernorm_sa", H)
    t("decoder.word_embed.weight", vocab_size, cfg.word_size)
    lstm("decoder.query_lstm", D + 2 * H + cfg.word_size, Q)
    ln("decoder.query_lstm_layernorm", Q)
    lstm("decoder.lang_lstm", 2 * H + Q, D)
    ln("decoder.lang_lstm_layernorm", D)
    att("decoder.context_att", H, Q, H)
    att("decoder.context_att_2", H, Q, H)
    linear("decoder.word_restore", D, vocab_size)
    ln("decoder.context_layernorm", D)  # dead in the reference's forward
    return sd


def phase_cli_serve() -> dict:
    """`cli export`, `cli serve --bundle --features` and `cli evaluate
    --torch_checkpoint` at tiny dims on the card (the device left at its
    default), both kernel switches on."""
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_serve_")
    switches = ["--use_fused_vocab_head", "on", "--use_pallas_lstm", "true"]
    flags = CLI_FLAGS + switches + ["--result_dir", os.path.join(work.name, "results")]
    cfg = parse_opt(CLI_DIMS + switches)
    bundle = os.path.join(work.name, "model.dlsg.npz")
    clips = os.path.join(work.name, "clips.npz")
    out = os.path.join(work.name, "captions.jsonl")
    fr, rg = features(5, cfg, seed=SEED + 31)
    vids = np.array(["clip_a", "clip_b", "clip_c", "clip_d", "clip_e"])
    np.savez(clips, frames=fr, regions=rg, video_ids=vids)
    timings = {}

    def run(name, argv):
        stdout = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(argv)
        timings[name] = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"cli {name} returned {rc}")
        return stdout.getvalue()

    run("export", ["export", "--allow_random_params", "--out", bundle] + flags)
    # ---- the main path: `cli serve`, every launch count read over it ----
    reset_launches()
    run("serve", ["serve", "--bundle", bundle, "--features", clips, "--output", out])
    launches = read_launches()
    lines = [json.loads(ln) for ln in open(out)]
    want = Captioner.from_bundle(bundle, device=DEVICE).caption(fr, rg)
    if lines != [{"video_id": jsonable_id(v), "caption": c} for v, c in zip(vids, want)]:
        raise AssertionError(f"cli serve wrote {lines[:2]}, caption() gives {want[:2]}")
    chunks = -(-len(vids) // cfg.test_batch_size)  # Captioner batches of test_batch_size
    if launches["lstm_scan"] != 2 * chunks or not chunks <= launches["vocab_head"] <= chunks * cfg.max_words:
        raise AssertionError(f"cli serve launches: {launches}")
    # a reference-schema .pt, written here, through evaluate --torch_checkpoint
    pt = os.path.join(work.name, "reference_epoch.pt")
    torch.save({"epoch": 0, "model_state_dict": reference_state_dict(cfg, len(make_vocab()), SEED),
                "cap_list": np.zeros(1)}, pt)
    printed = run("evaluate", ["evaluate", "--torch_checkpoint", pt] + flags)
    scores = dict(ln.split(": ") for ln in printed.splitlines() if ln.split(":")[0] in SCORE_KEYS)
    if list(scores) != list(SCORE_KEYS) or not all(np.isfinite(float(v)) for v in scores.values()):
        raise AssertionError(f"cli evaluate --torch_checkpoint printed {printed!r}")
    work.cleanup()
    result = {"phase": "cli_serve", "config": "tiny dims (CLI_FLAGS), fp32, both kernel switches",
              "seconds": timings, "captions": len(lines), "launches": launches,
              "evaluate_torch_checkpoint_scores": {k: float(v) for k, v in scores.items()}}
    emit(result)
    return result


# ------------------------------------------------------------ data parallel


def run_command(argv, timeout: float, env=None):
    """(returncode, stdout, stderr) of a command in a session of its own;
    at `timeout` the whole session is killed (torchrun and its ranks)."""
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True, env=env)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err


def _torchrun(nproc: int):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), str(Path(__file__).resolve())]


def cli_rank(out_dir: str, argv) -> int:
    """One process of the data_parallel phase's `cli train` (module doc,
    item 6d): `cli.main(argv)` with every kernel's launch count read over
    it, each gradient all-reduce timed by CUDA events (no sync added) and
    sized, each eval gather timed; written to out_dir/rank_<RANK>.json."""
    from dlsg_tpu_torch.train import steps as steps_mod

    eval_mod = sys.modules["dlsg_tpu_torch.evaluation.evaluate"]
    reduces, gathers = [], []
    real_reduce, real_gather = steps_mod.all_reduce_grads, eval_mod.gather_eval

    def timed_reduce(grads):
        grads = list(grads)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_reduce(grads)
        end.record()
        reduces.append((start, end, sum(g.numel() * g.element_size() for g in grads)))
        return out

    def timed_gather(*args):
        t = time.perf_counter()
        out = real_gather(*args)
        gathers.append(time.perf_counter() - t)
        return out

    steps_mod.all_reduce_grads, eval_mod.gather_eval = timed_reduce, timed_gather
    try:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rc = cli.main(list(argv))
        seconds = time.perf_counter() - t
        torch.cuda.synchronize()
    finally:
        steps_mod.all_reduce_grads, eval_mod.gather_eval = real_reduce, real_gather
    result = {"rc": rc, "seconds": seconds, "launches": read_launches(),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "all_reduce": [[s.elapsed_time(e), n] for s, e, n in reduces], "gather_s": gathers}
    with open(os.path.join(out_dir, f"rank_{os.environ.get('RANK', '0')}.json"), "w") as f:
        json.dump(result, f)
    return rc


def _same_checkpoint(a, b, path="") -> list:
    """The paths at which two loaded checkpoints differ (tensors bitwise)."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        same = torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(a, b)
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [f"{path}: keys"]
        return [p for k in a for p in _same_checkpoint(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) and len(a) == len(b):
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in _same_checkpoint(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def _scalars(result_dir: str) -> list:
    (log,) = Path(result_dir).glob("*/logs/scalars.jsonl")
    return [(s["tag"], s["value"], s["step"]) for s in map(json.loads, log.read_text().splitlines())]


def dp_gan_step(rows: slice, device) -> dict:
    """The data_parallel phase's GAN step (module doc, item 6d) on the given
    rows of the global batch: MSR-VTT widths, fp32, dropout off, epsilon 1,
    fixed penalty weights, lr MOMENT_CHECK_LR. Returns the models, states,
    the step's ms and its gradient all-reduces' ms."""
    from dlsg_tpu_torch.train import steps as steps_mod

    cfg = apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="float32"))
    gen = torch.Generator().manual_seed(SEED)
    G = CapGnnModel(cfg, VOCAB, generator=gen, device=device)
    D = DiscV2(cfg, VOCAB, generator=gen, device=device)
    n = 2 * DP_RANK_BATCH
    batch = {k: v[rows] for k, v in train_batch(cfg, n, VOCAB, SEED + 41, device).items()}
    eps_gp = torch.from_numpy(np.random.default_rng(SEED + 42).uniform(size=(cfg.num_D_visual, n))[:, rows])
    gs = TrainState.create(G, make_optimizer(MOMENT_CHECK_LR))
    ds = TrainState.create(D, make_optimizer(MOMENT_CHECK_LR))
    step = make_gan_train_step(G, D, cfg)
    real_reduce, reduce_ms = steps_mod.all_reduce_grads, []

    def timed_reduce(grads):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_reduce(grads)
        torch.cuda.synchronize()
        reduce_ms.append(1e3 * (time.perf_counter() - t))
        return out

    saved = linear_mod.dropout
    linear_mod.dropout = lambda x, rate, rng: x
    steps_mod.all_reduce_grads = timed_reduce
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        gs, ds, _, m = step(gs, ds, init_lambda_state(LAMBDA0, device=device), batch, TRAIN_KEY, 1.0,
                            eps_gp=eps_gp)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t)
    finally:
        linear_mod.dropout, steps_mod.all_reduce_grads = saved, real_reduce
    return {"G": G, "D": D, "gs": gs, "ds": ds, "metrics": _finite_metrics(m), "step_ms": step_ms,
            "all_reduce_ms": reduce_ms, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _moments(run: dict) -> dict:
    return {**{f"G.{k}": v for k, v in run["gs"].first_moments().items()},
            **{f"D.{k}": v for k, v in run["ds"].first_moments().items()}}


def gan_rank(work: str) -> None:
    """One of the two ranks on one card over gloo (module doc, item 6d):
    its half of the global batch, then its Adam first moments against the
    single process's (work/single_moments.pt) and a digest of its
    parameters; written to work/gan_rank_<RANK>.json."""
    import hashlib

    from dlsg_tpu_torch.parallel import dist

    device = dist.init_distributed(f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE, backend="gloo")
    try:
        r = dist.rank()
        run = dp_gan_step(slice(r * DP_RANK_BATCH, (r + 1) * DP_RANK_BATCH), device)
        want = torch.load(os.path.join(work, "single_moments.pt"), map_location=device, weights_only=True)
        worst, bad = 0.0, []
        for name, got in _moments(run).items():
            w = want[name]
            scale = float(w.abs().max())
            ratio = float((got - w).abs().max()) / scale if scale else float(got.abs().max())
            worst = max(worst, ratio)
            if ratio > MOMENT_TOL["float32"] or ((scale == 0) != (float(got.abs().max()) == 0)):
                bad.append(f"{name}: {ratio}")
        digest = hashlib.sha256()
        for model in (run["G"], run["D"]):
            for t in model.state_dict().values():
                digest.update(t.detach().cpu().numpy().tobytes())
        digests = [None] * dist.world_size()
        torch.distributed.all_gather_object(digests, digest.hexdigest())
        result = {"rank": r, "device": str(device), "step_ms": run["step_ms"],
                  "all_reduce_ms": run["all_reduce_ms"], "peak_mem_gb": run["peak_mem_gb"],
                  "metrics": run["metrics"], "moments_worst_share_of_max_abs": worst,
                  "moments_off": bad[:8], "params_equal_across_ranks": len(set(digests)) == 1}
        with open(os.path.join(work, f"gan_rank_{r}.json"), "w") as f:
            json.dump(result, f)
    finally:
        torch.distributed.destroy_process_group()


def phase_data_parallel() -> dict:
    """(a) `cli train` under torchrun at world size 1 (NCCL) against the same
    command without a process group; (b) two ranks on the one card over gloo
    against one process (module doc, item 6d)."""
    t_phase = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")  # the same cuBLAS setup for both

    # ---- (a) the main path: torchrun ... cli train --distributed, NCCL, world size 1 ----
    runs = {}
    for name, launcher, extra in (("nccl_world_1", _torchrun(1), ["--distributed"]),
                                  ("no_group", [sys.executable, str(Path(__file__).resolve())], [])):
        out_dir = os.path.join(work.name, name)
        os.makedirs(out_dir)
        argv = ["train", "--result_dir", os.path.join(out_dir, "results"),
                "--device", DEVICE] + DP_FLAGS + extra
        t = time.perf_counter()
        rc, out, err = run_command(launcher + ["--cli-rank", out_dir] + argv, DP_TIMEOUT, env)
        if rc != 0:
            raise AssertionError(f"data_parallel {name}: rc {rc}\n{out[-3000:]}\n{err[-3000:]}")
        with open(os.path.join(out_dir, "rank_0.json")) as f:
            runs[name] = json.load(f)
        steps = re.search(r"train_step: total ([\d.]+)s over (\d+) spans", out)
        runs[name].update(wall_s=time.perf_counter() - t,
                          train_step_ms=1e3 * float(steps[1]) / int(steps[2]),
                          checkpoint=os.path.join(out_dir, "results", "checkpoints", "epoch_0",
                                                  ckpt_mod.TRAIN_FILE),
                          scalars=_scalars(os.path.join(out_dir, "results")))
    dist_run, plain = runs["nccl_world_1"], runs["no_group"]
    launches = dist_run["launches"]
    diff = _same_checkpoint(*(torch.load(r["checkpoint"], map_location="cpu", weights_only=True)
                              for r in (dist_run, plain)))
    if diff:
        raise AssertionError(f"data_parallel (a): the epoch_0 checkpoints differ at {diff[:8]}")
    if dist_run["scalars"] != plain["scalars"] or not any(t.startswith("results/")
                                                         for t, _, _ in plain["scalars"]):
        raise AssertionError("data_parallel (a): the logged losses or scores differ")
    evals = len(dist_run["gather_s"])
    per_step = 1 + DLSGConfig().num_D_visual  # G's update and each D substep's
    gan_steps = len(dist_run["all_reduce"]) // per_step
    if evals < 1 or gan_steps < 1 or launches["lstm_scan"] or \
            not evals <= launches["vocab_head"] <= evals * DLSGConfig().max_words or \
            launches["vocab_head[tensor_cores]"] != launches["vocab_head"]:
        raise AssertionError(f"data_parallel (a): {evals} evals, {gan_steps} GAN steps, {launches}")
    reduce_ms = [sum(ms for ms, _ in dist_run["all_reduce"][i * per_step:(i + 1) * per_step])
                 for i in range(gan_steps)]
    grad_bytes = sum(n for _, n in dist_run["all_reduce"][:per_step])
    del runs

    # ---- (b) two ranks on the one card over gloo against one process ----
    torch.cuda.empty_cache()
    single = dp_gan_step(slice(0, 2 * DP_RANK_BATCH), DEVICE)
    torch.save({k: v.detach() for k, v in _moments(single).items()},
               os.path.join(work.name, "single_moments.pt"))
    single = {k: single[k] for k in ("step_ms", "peak_mem_gb", "metrics")}
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rc, out, err = run_command(_torchrun(2) + ["--gan-rank", work.name], DP_TIMEOUT)
    ranks_s = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"data_parallel (b): rc {rc}\n{out[-3000:]}\n{err[-3000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(work.name, f"gan_rank_{r}.json")) as f:
            ranks.append(json.load(f))
    verdicts = [(r["params_equal_across_ranks"], r["moments_off"]) for r in ranks]
    if not all(equal and not off for equal, off in verdicts):
        raise AssertionError(f"data_parallel (b): (parameters equal, moments off) per rank: {verdicts}")
    work.cleanup()

    result = {
        "phase": "data_parallel",
        "a": {"config": "cli train --synthetic, msr-vtt, bf16, fused vocab head, batch 64, "
                        f"{VOCAB} words; torchrun world size 1 (NCCL) against no process group",
              "checkpoint_and_logs": "bitwise equal", "gan_steps": gan_steps, "evals": evals,
              "wall_s": [dist_run["wall_s"], plain["wall_s"]],
              "cli_main_s": [dist_run["seconds"], plain["seconds"]],
              "train_step_ms": [dist_run["train_step_ms"], plain["train_step_ms"]],
              "grad_bytes_all_reduced_per_gan_step": grad_bytes,
              "all_reduce_ms_per_gan_step": reduce_ms,
              "gather_s": dist_run["gather_s"],
              "peak_mem_gb": [dist_run["peak_mem_gb"], plain["peak_mem_gb"]],
              "launches": launches},
        "b": {"config": f"GAN step, msr-vtt, fp32, 2 ranks x {DP_RANK_BATCH} on one card over gloo "
                        f"against 1 x {2 * DP_RANK_BATCH}, lr {MOMENT_CHECK_LR}",
              "torchrun_s": ranks_s, "single": single,
              "ranks": [{k: r[k] for k in ("device", "step_ms", "all_reduce_ms", "peak_mem_gb",
                                           "moments_worst_share_of_max_abs")} for r in ranks],
              "params_equal_across_ranks": True, "tolerance": MOMENT_TOL["float32"]},
        "seconds": time.perf_counter() - t_phase,
    }
    emit(result)
    result["launches"] = launches
    return result


def main() -> None:
    info = phase_device()
    scorer_build_s = phase_build()
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
    vocab, params = serving_model(cfg)
    launches = {"launches": phase_serving(cfg, vocab, params)["launches"]}
    torch.cuda.empty_cache()
    launches["launches_two_pass"] = phase_two_pass(cfg, params)["launches"]
    torch.cuda.empty_cache()
    launches["launches_server"] = phase_server(cfg, vocab, params)["launches"]
    del params
    torch.cuda.empty_cache()
    phase_train(apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16")))
    torch.cuda.empty_cache()
    trainer, references, captions = phase_trainer(
        apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16",
                                           use_fused_vocab_head="on", epoch_num=1)),
        VOCAB, TRAINER_VIDEOS,
    )
    launches["launches_trainer"] = trainer["launches"]
    torch.cuda.empty_cache()
    launches["launches_data_parallel"] = phase_data_parallel()["launches"]
    phase_scorer(references, captions, scorer_build_s)
    launches["launches_cli_serve"] = phase_cli_serve()["launches"]
    for key, entry in checks:
        for path, counts in launches.items():
            entry[path] = counts[key]
    emit({"kernels": [entry for _, entry in checks]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})


if __name__ == "__main__":
    # the data_parallel phase runs these two under torchrun or alone
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--gan-rank"]:
        gan_rank(sys.argv[2])
        sys.exit(0)
    main()
