#!/usr/bin/env python3
"""Drive dlsg_tpu_torch's beam-5 serving path (the Captioner, the two-pass
decode, the HTTP server, the int8 decode, `cli serve`/`export`), the
evidence that its training learns, its GAN train step with and without
remat, its graph-variant encoders, its trainer, its baseline generators and
their CE trainers, its C++ scorer, its data parallelism and its model axis
on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs a CUDA device, nvcc and g++,
builds the kernels from `dlsg_tpu_torch/csrc/` and the scorer library from
`dlsg_tpu_torch/native/` into `build/dlsg_tpu_torch/`, and prints one JSON
line per phase:

1. device: the card's name, count and nvidia-smi power limit;
2. build: seconds to build every kernel (one nvcc per source, in parallel,
   with g++ building the scorer library beside them), ptxas's registers per
   kernel, and the tensor-core instructions `cuobjdump` finds in each
   library: warpgroup wgmma (HGMMA) and no mma.sync (HMMA) in the vocab
   head's (both routes) and in the LSTM scan's; qmatmul's s8 products must
   be warpgroup wgmma, IGMMA, with no IMMA mma.sync left;
3. kernel checks: each kernel against its plain PyTorch version at the
   shapes the serving path gives it (MSR-VTT widths, batch 128, beam 5); the
   LSTM scan in both directions, each also run REPEATS times and bitwise
   equal every time (h_t comes back through TMA: a missing proxy fence or
   a leaky step barrier shows as a run that differs); the vocab head once
   per w dtype, bf16 w (the persistent TMA + wgmma kernel, the serving
   path, at G = 640 and at the first beam step's G = 128, each checked and
   timed with the wrapper's host time a call, and at G = 640 against a
   9 999-word vocabulary in the decoder's layout, rows of ceil8(V)) and
   fp32 w (the same kernel's TF32 route: three TF32 wgmma products of a
   hi/lo split, w split once per decode by the split kernel, which is
   checked bitwise against its plain version and timed with its bytes), at
   G = 640 and 128 (the bound counts fp32 w's bytes once; the split's hi
   and lo, which this design reads instead, stand beside it), the fp32
   form's top-k logits also held within max(3 x
   the plain fp32 product's error, 2e-6) of a float64 product, which one
   TF32 pass fails; qmatmul (the int8 product) at the int8 decode's three products
   (the quantized Wq 2860 x 4096, Wl 4608 x 6144 and Wv 1536 x 10000 of the
   serving weights) at G = 128 and 640 rows, bitwise its plain version,
   with its library yardstick (row quantize + torch._int_mm + rescale,
   which must also be bitwise equal) and a bf16 torch.mm of each shape, and
   each one's device time without host time (torch.profiler), qmatmul's
   host time a call (the wrapper's enqueue) and its device time's share of
   the bound;
4. serving: a Captioner at MSR-VTT widths (bf16 compute, both kernel
   switches on, 10 000-word vocabulary, seeded random weights) warms every
   bucket and answers beam-5 requests of 3, 50 and 128 clips and one greedy
   request, with each kernel's launch count (the vocab head's per tile
   form too) read over that run; then the
   decode time of a 128-clip batch already on the card, and the share of
   tokens that agree with the same decode through the plain versions. It
   must be >= 99% at fp32 compute (the vocab head on its TF32 route, with
   each kernel's launches over that decode: the split once, K1 every beam
   step), and
   at bf16 with the vocab head swapped alone. At bf16 with both swapped it
   must not fall more than 2 points below the plain decode's agreement with
   itself under a 1e-6 input perturbation: random weights give near-tied
   beams, and bf16 rounding spreads the LSTM kernel's ulp-sized differences
   into different tokens. Then the fp32 decode's time with the fused vocab
   head on and off, in turns;
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
4d. int8: the serving config with decode_quant="int8" and the serving
   weights, 128 clips: the main path is the beam-5 decode with the fused
   head on (K2 twice, then qmatmul twice and K1 a beam step) and off
   (qmatmul three times a step), and the two-pass decode of a copy whose
   <end> bias finishes 25-75% of the rows within t1 = 8, with the launch
   counts checked per decode. Then: tokens bitwise the same decodes' with
   qmatmul alone swapped for its plain version; with every kernel swapped,
   the serving phase's perturbation rule; the two-pass decode's pass-1 rows
   bitwise the single pass's; the first beam step's logits correlated >
   0.999 with the unquantized bf16 step's; the int8 and bf16 decode ms
   (fused head on) in turns, the fused-off int8 decode's ms, and a profile;
4e. learning (`dlsg_tpu_torch/train/learning.py`, the JAX package's
   tests/test_learning.py and tests/test_convergence.py at their dims and
   step counts, from this package's seeded init): the GAN fit at fp32 and
   bf16 (CE halves, Bleu_1 > max(0.5, before + 0.3), CIDEr + 0.5), the
   held-out CE generalization with the trained model's int8 decode through
   qmatmul (Bleu_1 within 0.1 and CIDEr within 0.5 of the unquantized
   decode's), and the GAN dynamics (mean Wasserstein tail > max(5, 2 x
   head), 0.01 < penalty tail < 5) with the CE ablation; then the trained
   decodes' mean caption length and their C++ and Python scoring seconds;
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
5a. remat (ops/remat.py): the train phase's config, weights, batch and
   seeds (dropout 0.3 on) under each (decoder_remat, disc_remat) of (none,
   none), (dots, none), (full, none), (none, dots), (none, full), each
   from the same start weights, each row's GAN step replayed from one CUDA
   graph (train/steps.py): the GAN step's ms (median of 3 after a warm-up
   that also captures, CUDA events) and peak memory with the graph's pool
   counted, and the same for the CE step on the decoder_remat rows. The
   first GAN step's and CE step's metrics, parameters and Adam first
   moments of each row must lie within MOMENT_TOL bf16 of each tensor's
   max-abs from the (none, none) row's, and, from one fp32 run of every
   row at batch 32, within MOMENT_TOL fp32; `full` must lower the GAN
   step's peak below none's, for the decoder and for D; no kernel
   launches;
5b. graph_variants (models/graph_variants.py, which no trainer runs):
   LatentGNN, GNN, GraphAttentionLayer, EncoderVisualGraph and
   EncoderVisualGAT at MSR-VTT widths in fp32 (frames [128, 26, 2560],
   regions [128, 26, 36, 2048], hidden 1024, 5 proposals; GNN over the 936
   regions of a clip, 2048 -> 1024), seeded weights and running
   statistics: each one's eval forward ms, train-mode forward + backward
   ms (running statistics updated) and its peak memory; then the same
   modules on the CPU with the same weights on the first 4 clips: the
   card's eval rows 0-3, and a train-mode batch of those 4 clips on both
   devices (output and updated running statistics), within 1e-4 of each
   CPU tensor's max-abs; GNN (one forward in either mode) within 1e-3 of
   a float64 product's max-abs (GV_GNN_TOL says why), its card-vs-CPU
   share recorded beside; no kernel launches;
6. trainer: `RunGAN` at MSR-VTT widths (bf16 compute, the fused vocab head
   on, 10 000 words, 128 synthetic videos with 2 captions each: 2 GAN steps
   of batch 128 and 2 beam-5 evals of the 128 clips an epoch, checkpoints
   on) trains epoch 0; a second RunGAN on the same results resumes from the
   latest checkpoint, must hold its parameters, Adam state, step counters and
   lambda state bitwise, and trains epoch 1. It checks the logged losses
   (finite, every tag), the step counters (G 2 then 4, D 10 then 20), both
   epoch checkpoints, all seven finite scores per eval, the vocab head
   launched on its bf16 (wgmma) route on every beam step of every eval decode
   (between 1 and max_words launches per eval) and no lstm_scan launch; then
   the final generator's eval decode against the same decode with the plain
   vocab head (token agreement >= 99%), and `cli train --synthetic` at tiny
   dims on the card. Its line gives the epoch seconds, the Stopwatch spans,
   decode against scoring seconds per eval, the scorer's seconds for 128
   26-word captions (where Python METEOR is slowest), save_train /
   restore_train seconds and bytes, and peak memory. Its evals score
   through the C++ tokenizer and METEOR aligner (the line counts the pairs
   aligned there);
6a. baselines: (a) CapModel, CapBaseline1 and CapBaselineModel at the
   serving config (MSR-VTT widths, bf16, use_pallas_lstm, fused vocab head,
   10 000 words, seeded random weights): the beam-5 decode of 128 clips
   through both kernels, K2 twice and K1 once a beam step on its bf16
   (wgmma) route, held to the serving phase's three agreement rules
   against the same decode through the plain versions; each decode's and
   encode's ms (median of 7 CUDA-event timings). Then the CE step of
   CapBaseline1 and CapModel's own at MSR-VTT widths, bf16, batch 128
   (median of 3 after a warm-up, peak memory, no kernel launched), and one
   fp32 CE step of CapBaseline1 at tiny dims on the card against the CPU
   (Adam moments within MOMENT_TOL, lr MOMENT_CHECK_LR). (b) `cli
   train-base --synthetic` and `cli train-legacy --synthetic` at MSR-VTT
   widths (bf16, fused head, batch 128, 86 videos x 3 captions: 2 CE steps
   and an eval after each): exit 0, K1 on its bf16 (wgmma) route on every
   beam step of each eval decode, seven finite scores, the losses and
   scores logged, no checkpoint directory; `--resume` exits 2. (c) `cli
   train-base --use_glove true --freeze_word_embed true` with a GloVe
   file of 200 vocabulary words at the config's word_size, written here
   (1 step, 1 eval): those embedding rows on the card equal the file's
   vectors and the embedding is bitwise unchanged after the step while
   other parameters move. Launches are counted over (a)'s first decode of
   each generator and (b)-(c);
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
   the vocab head must launch on its bf16 (wgmma) route in each eval, the
   LSTM kernel never. (b) `--gan-rank`: one GAN step at MSR-VTT widths,
   fp32, dropout off, epsilon 1, fixed penalty weights, lr 1e-7, over two
   ranks x 64 on the one card over gloo against one process x 128: the two
   ranks' parameters must be equal bitwise and their Adam first moments
   within train_card_vs_cpu's fp32 tolerance of the single process's. Its
   line gives each run's seconds and step ms, the gradient bytes and
   all-reduce ms per GAN step, the gather seconds and peak memory;
6e. model_axis (parallel/mesh.py; two ranks on the one card over gloo under
   `torchrun --nproc_per_node=2 chip_smoke.py --model-axis-rank DIR`, every
   kernel's launches counted in the ranks over (a)-(c); (a)'s reference
   runs first, as `chip_smoke.py --model-axis-single DIR` in the ranks'
   environment): (a) RunGAN at MSR-VTT widths, fp32, fused vocab
   head, 64 videos x 2 captions (2 GAN steps of batch 64, cut to one eval
   after the last step), lr MOMENT_CHECK_LR, on a (data 1 x model 2) mesh
   against the same run in one process: the gathered epoch_0 checkpoint's
   Adam moments within MOMENT_TOL fp32 and its parameters within
   2 x updates x lr of the single run's, the replicated parameters bitwise
   equal across the ranks, each rank's head and both moments of V / 2
   rows, the eval's token agreement >= 99%; it gives each GAN step's ms
   (ranks and one process), the model axis's all-gathers and all-reduces
   per step and the sharded decode's merges (ms, the card synced around
   each), peak memory. (b) the sharded beam-5 decode of 128 clips at bf16
   and fp32 against the whole head's K1 decode of the same weights (the
   one-process decode, run in the same rank so that both share its cuBLAS
   set-up): token agreement >= 99% each, K1 launched once a beam step on
   each rank on the dtype's route (wgmma, wgmma_tf32), and one beam
   step's split K1 + merge equal to the whole K1 at G = 640 (ids, values
   within KERNEL_TOL); it also gives the whole decode's own agreement under
   a 1e-6 input perturbation. (c) Captioner(mesh=) on a (data 2) mesh at
   the serving config (both kernels) on a 128-clip request: its captions
   must equal one process's captions of the two 64-clip halves (a
   Captioner without a mesh in the same rank), and their agreement with
   the 128-clip decode is printed; then one
   16-clip .npz request through the leader's CaptionServer, the other rank
   following, which must answer caption()'s captions and stop the
   follower;
7. a `timing` line (each phase's seconds and the script's), the
   `kernels` line (times, bounds, launches on each path: serving, the fp32
   agreement decode, two_pass, server, int8, learning, train, remat,
   graph_variants, trainer, baselines, cli_serve, data_parallel,
   model_axis; K2 and K1's bf16 (wgmma) route must launch on the baselines
   path, K1's fp32 (wgmma_tf32) route and the TF32 split on the fp32
   decode, cli_serve and model_axis paths, qmatmul on the int8 and
   learning paths), the nvidia-smi line, and as the last line
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
from dlsg_tpu_torch.kernels.lstm_scan import lstm_scan, lstm_scan_plain, lstm_scan_plan  # noqa: E402
from dlsg_tpu_torch.kernels.qmatmul import LIBRARY as QMM_LIB  # noqa: E402
from dlsg_tpu_torch.kernels.qmatmul import qmatmul_plan  # noqa: E402
from dlsg_tpu_torch.kernels.breakdown import device_us_per_call, int_mm_library  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import LIBRARY as VOCAB_LIB  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import ROUTE_LAUNCHES  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import prepare_head, split_head  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import tf32_split_plain, vocab_head_plan  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk  # noqa: E402
from dlsg_tpu_torch.kernels.vocab_head import vocab_head_topk_plain  # noqa: E402
from dlsg_tpu_torch.config import tiny_test_config  # noqa: E402
from dlsg_tpu_torch.data.loader import eval_batches  # noqa: E402
from dlsg_tpu_torch.data.synthetic import SyntheticDataset, make_vocab  # noqa: E402
from dlsg_tpu_torch.metrics.scorer import score_captions  # noqa: E402
from dlsg_tpu_torch.models.discriminator import DiscV2  # noqa: E402
from dlsg_tpu_torch.models.generator import (  # noqa: E402
    CapBaseline1, CapBaselineModel, CapGnnModel, CapModel,
)
from dlsg_tpu_torch.models.glove import WORD_EMBED_KEY  # noqa: E402
from dlsg_tpu_torch.ops import linear as linear_mod  # noqa: E402
from dlsg_tpu_torch.ops import lstm as lstm_mod  # noqa: E402
from dlsg_tpu_torch.ops import quant as quant_mod  # noqa: E402
from dlsg_tpu_torch.ops.linear import matmul_f32  # noqa: E402
from dlsg_tpu_torch.ops.quant import qmatmul, qmatmul_plain  # noqa: E402
from dlsg_tpu_torch.parallel import mesh_timing  # noqa: E402
from dlsg_tpu_torch.serve import Captioner, jsonable_id  # noqa: E402
from dlsg_tpu_torch.server import CaptionServer  # noqa: E402
from dlsg_tpu_torch.train.gan_lambda import init_lambda_state  # noqa: E402
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer  # noqa: E402
from dlsg_tpu_torch.train import learning  # noqa: E402
from dlsg_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from dlsg_tpu_torch.train.steps import (  # noqa: E402
    make_ce_train_step, make_gan_train_step, make_legacy_ce_train_step,
)
from dlsg_tpu_torch.vocab import END_ID, START_ID, Vocabulary  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_INT8 = 1979e12
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
# K1's route for bf16 w, every shape (rows TMA cannot read are laid out in
# rows it can): the persistent TMA + wgmma kernel
K1_BF16 = "wgmma"
K1_BF16_KEY = f"vocab_head[{K1_BF16}]"
# ... for fp32 w: the same kernel's TF32 route, on w split once per decode
K1_FP32 = "wgmma_tf32"
K1_FP32_KEY = f"vocab_head[{K1_FP32}]"
SPLIT_KEY = "vocab_head[tf32_split]"
REPEATS = 10  # runs of K2 at the serving shape that must agree bitwise
# the fp32 vocab head against a float64 product: within this many times the
# plain fp32 product's error, or F64_FLOOR if that is larger (one TF32 pass
# is ~4.6e-4 off at K1's operands)
F64_FACTOR = 3.0
F64_FLOOR = 2e-6
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
# the remat phase: every (decoder_remat, disc_remat) row, held to the first;
# the fp32 check runs at this batch
REMAT_POLICIES = (("none", "none"), ("dots", "none"), ("full", "none"),
                  ("none", "dots"), ("none", "full"))
REMAT_FP32_BATCH = 32
# the graph_variants phase: the card's B = 128 outputs against the CPU's on
# the first clips (the CPU cannot run B = 128 of GNN in a phase's time),
# within GV_TOL of each CPU tensor's max-abs. GNN's output against a float64
# product instead, within GV_GNN_TOL of its max-abs: its q.k logits are
# unscaled (std ~45 here) and each is two fp32 sums of 2048 unit-scale
# products, so any fp32 evaluation moves the tail of its 3.5 million logits
# by ~5e-5 and the peaked softmax carries ~2x that into the output: ~1e-4 of
# max-abs, which the card reaches (1.12e-4; the CPU 3.0e-5, H100 80GB HBM3,
# 700.00 W). A wrong module is off by order 1.
GV_CPU_CLIPS = 4
GV_TOL = 1e-4
GV_GNN_TOL = 1e-3


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


# tensor-core instructions: warp-level mma.sync (HMMA floating point, IMMA
# integer) and warpgroup wgmma (HGMMA, IGMMA); no name holds another
MMA_OPS = ("HMMA", "IMMA", "HGMMA", "IGMMA")


def sass_mma_count(path) -> dict:
    """Tensor-core instructions in a built library's machine code (MMA_OPS)."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    out = subprocess.run(
        [str(Path(cuda_home) / "bin" / "cuobjdump"), "-sass", str(path)],
        capture_output=True, text=True, timeout=120, check=True,
    )
    lines = out.stdout.splitlines()
    return {op: sum(op in ln for ln in lines) for op in MMA_OPS}


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
    if not all(sum(n.values()) for n in mma.values()):
        raise AssertionError(f"a kernel library has no tensor-core instruction: {mma}")
    if not mma[QMM_LIB.name]["IGMMA"] or mma[QMM_LIB.name]["IMMA"]:
        raise AssertionError(f"qmatmul's s8 products must be wgmma (IGMMA), no mma.sync: {mma}")
    for lib in (VOCAB_LIB, LSTM_LIB):
        if not mma[lib.name]["HGMMA"] or mma[lib.name]["HMMA"]:
            raise AssertionError(f"{lib.name}'s products must be wgmma (HGMMA), no mma.sync: {mma}")
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas, "sass_mma": mma,
          "scorer_library_s": native_build["s"], "scorer_library": native.library_path().name})
    return native_build["s"]


def check_lstm_scan(cfg: DLSGConfig) -> dict:
    """K2 at the encoder Bi-LSTM's shapes: B=128, T=26, H=1024, both
    directions, against lstm_scan_plain, and each direction's REPEATS runs
    bitwise equal."""
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
        # h_t goes out by ordinary stores and comes back by TMA: a missing
        # proxy fence or a leaky step barrier shows as a run that differs
        repeats = [torch.equal(lstm_scan(xw, w_hh, reverse=reverse), got) for _ in range(REPEATS - 1)]
        if not all(repeats):
            raise AssertionError(f"lstm_scan (reverse={reverse}) is not bitwise repeatable: "
                                 f"{repeats.count(False)} of {REPEATS - 1} runs differ")
    if not err <= KERNEL_TOL:
        raise AssertionError(f"lstm_scan differs from its plain version: {err} > {KERNEL_TOL}")
    plan = lstm_scan_plan(B, H)
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
        "design": "one cooperative launch per direction, W_hh in shared memory (wgmma's "
                  "K-major layout), h_{t-1} by TMA from a ping-pong scratch into an mbarrier "
                  "ring, 3-term bf16 split of h as register A of wgmma m64n(4U)k16, a "
                  "release/acquire step counter after a proxy fence",
        "plan": {"units": plan.units, "groups": plan.groups, "blocks": plan.blocks,
                 "stages": plan.stages, "boxes": plan.boxes},
        "bitwise_repeats": REPEATS,
        "max_abs_err": err, "tolerance": KERNEL_TOL,
        "ms": time_ms(lambda: lstm_scan(xw, w_hh)),
        "plain_ms": time_ms(lambda: lstm_scan_plain(xw, w_hh)),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    }


def _k1_against_plain(h, w, head, b, k: int, route: str) -> dict:
    """One K1 call on `head` (`prepare_head` of w) against
    vocab_head_topk_plain on w: values within KERNEL_TOL, ids that differ
    only at near-ties (logits within KERNEL_TOL of each other)."""
    vals, ids = vocab_head_topk(h, head, b, k)
    torch.cuda.synchronize()
    pv, pi = vocab_head_topk_plain(h, w, b, k)
    err = float((vals - pv).abs().max())
    logits = h.to(w.dtype).float() @ w.float() + b
    differ = ids != pi
    gap = (logits.gather(1, ids) - logits.gather(1, pi)).abs()
    near_tie_only = bool((gap[differ] <= KERNEL_TOL).all())
    if not (err <= KERNEL_TOL and near_tie_only):
        raise AssertionError(
            f"vocab_head_topk ({route}, G = {h.shape[0]}) differs from its plain version: vals "
            f"{err}, {int(differ.sum())} ids differ, near-ties only: {near_tie_only}"
        )
    return {"max_abs_err": err, "ids_differ": int(differ.sum())}


def _k1_f64(h, w, head, b, k: int, route: str) -> dict:
    """fp32 K1's accuracy: its sorted top-k logits on `head` against a
    float64 product's of w, within max(F64_FACTOR x the plain fp32
    product's error, F64_FLOOR)."""
    want = torch.topk(h.double() @ w.double() + b.double(), k).values
    f64_err = float((vocab_head_topk(h, head, b, k, normalize=False)[0].double() - want).abs().max())
    plain_f64_err = float((vocab_head_topk_plain(h, w, b, k, normalize=False)[0].double() - want).abs().max())
    f64_tol = max(F64_FACTOR * plain_f64_err, F64_FLOOR)
    if not f64_err <= f64_tol:
        raise AssertionError(
            f"vocab_head_topk ({route}, G = {h.shape[0]}) is {f64_err} from a float64 product, "
            f"above {f64_tol} (the plain fp32 product: {plain_f64_err})"
        )
    return {"f64_err": f64_err, "plain_f64_err": plain_f64_err, "f64_tol": f64_tol}


def _k1_times(h, w, head, b, k: int, peak: float, passes: int) -> dict:
    """K1's ms on `head` (`prepare_head` of w; L2 flushed), its plain
    version's and the library call's (torch.mm + bias + torch.topk +
    torch.logsumexp) on w, and its bound: the passes x 2GHV operations at
    `peak` or the bytes of the function (h, w, b once, the outputs),
    whichever is larger, with both; the bytes this design moves where they
    differ (fp32: the split's hi and lo in w's place, `design_bytes`, and
    their time at the memory rate), beside the bound, not in it; its device
    time without host time (L2 warm) and the wrapper's host time a call
    (`host_us`: plan, map of h, scratch, the two launches)."""
    G, H = h.shape
    V = w.shape[1]
    w_bytes = w.numel() * w.element_size()

    def library():
        lg = matmul_f32(h.to(w.dtype), w) + b  # bf16: torch.mm(out_dtype=float32)
        return torch.topk(lg, k), torch.logsumexp(lg, dim=-1)

    ops = passes * 2.0 * G * H * V
    nbytes = h.numel() * 4 + w_bytes + b.numel() * 4 + G * k * (4 + 8)
    bms, by = bound_ms(ops, peak, nbytes)
    out = {
        "ms": time_ms(lambda: vocab_head_topk(h, head, b, k)),
        "plain_ms": time_ms(lambda: vocab_head_topk_plain(h, w, b, k)),
        "bound_ms": bms, "bound_by": by, "bound_ms_operations": 1e3 * ops / peak,
        "bound_ms_bytes": 1e3 * nbytes / PEAK_BYTES, "library_ms": time_ms(library),
        "device_ms": device_ms(lambda: vocab_head_topk(h, head, b, k)),
        "host_us": host_us(lambda: vocab_head_topk(h, head, b, k)),
    }
    if head.parts is not None:
        design = nbytes - w_bytes + head.parts.numel() * 4
        out.update(design_bytes=design, design_bytes_ms=1e3 * design / PEAK_BYTES)
    return out


def _plan(G: int, H: int, dtype) -> dict:
    plan = vocab_head_plan(G, H, VOCAB, dtype)
    return {"block_n": plan.block_n, "stages": plan.stages, "tiles": list(plan.tiles),
            "blocks": plan.blocks}


def check_vocab_head(cfg: DLSGConfig, w_dtype: torch.dtype) -> dict:
    """K1 at the beam step's shapes: G=640 (128 x beam 5), H=1536,
    V=10000, k=5, against vocab_head_topk_plain, and at the first beam
    step's G = 128, each checked and timed, on w prepared once
    (`prepare_head`, as the decoder does once per decode). bf16 w takes the
    persistent TMA + wgmma kernel (the serving path); fp32 w its TF32 route
    on w split into hi and lo, whose top-k logits are also held against a
    float64 product at both G."""
    G, H, k = BATCH * BEAM, cfg.decode_hidden_size, BEAM
    route = vocab_head_plan(G, H, VOCAB, w_dtype).route
    g = torch.Generator().manual_seed(SEED + 1)
    h = torch.tanh(torch.randn(G, H, generator=g)).to(DEVICE)  # like tanh(LN(l_h))
    std = (2.0 / (H + VOCAB)) ** 0.5  # xavier-normal, as word_restore
    w = (torch.randn(H, VOCAB, generator=g) * std).to(w_dtype).to(DEVICE)
    b = (torch.randn(VOCAB, generator=g) * 0.01).to(DEVICE)
    h128 = h[:BATCH].contiguous()  # the first beam step: one beam per clip
    fp32 = w_dtype == torch.float32
    wk = prepare_head(w, w_dtype)  # as the decoder does once per decode
    checked = _k1_against_plain(h, w, wk, b, k, route)
    first = _k1_against_plain(h128, w, wk, b, k, route)
    if fp32:
        # three TF32 products (hi*lo, lo*hi, hi*hi) on the tensor cores
        peak, passes = PEAK_TF32, 3
        extra = {**_k1_f64(h, w, wk, b, k, route),
                 "bound_ms_fp32_cuda_core_rate": bound_ms(
                     2.0 * G * H * VOCAB, PEAK_FP32,
                     h.numel() * 4 + w.numel() * 4 + b.numel() * 4 + G * k * (4 + 8))[0]}
        first.update(_k1_f64(h128, w, wk, b, k, route))
        design = ("the persistent TMA + wgmma kernel's TF32 route: w split once into TF32 hi "
                  "and lo (K-major, one 3-D TMA map), h split in registers from the ring, "
                  "wgmma m64nBNk8 tf32 x 3 (hi*lo, lo*hi, hi*hi) into fresh accumulators each "
                  "32-deep k-tile, added round-to-nearest; the bf16 route's epilogue, merge launch")
    else:
        peak, passes = PEAK_BF16, 1
        # a vocabulary of any size (len(vocab) of a dataset): w in the
        # decoder's layout, rows of ceil8(V), read in place by TMA
        vr = VOCAB - 1
        wr, br = prepare_head(w[:, :vr], w_dtype), b[:vr].contiguous()
        ragged = _k1_against_plain(h, w[:, :vr], wr, br, k, route)
        extra = {f"v{vr}": {**ragged, "row_pitch": wr.w.stride(0),
                            "ms": time_ms(lambda: vocab_head_topk(h, wr, br, k))}}
        design = ("persistent warp-specialized: TMA (128-byte swizzle) into an mbarrier ring, "
                  "wgmma m64nBNk16 bf16 with transpose-B (w MN-major), two consumer "
                  "warpgroups, top-k and (max, sumexp) from the accumulators, merge launch")
    return {
        "name": f"vocab_head_topk[{route}]", "route": "cuda",
        "source": "dlsg_tpu_torch/csrc/vocab_head.cu",
        "replaces": "dlsg_tpu/ops/pallas/vocab_head.py:117",
        "shapes": f"h [{G},{H}] fp32, w [{H},{VOCAB}] {'fp32, split' if fp32 else 'bf16'}, b [{VOCAB}], k={k}",
        "design": design, **checked, "tolerance": KERNEL_TOL,
        **_k1_times(h, w, wk, b, k, peak, passes), **_plan(G, H, w_dtype),
        "g128": {**first, **_k1_times(h128, w, wk, b, k, peak, passes), **_plan(BATCH, H, w_dtype)},
        **extra,
    }


def check_tf32_split(cfg: DLSGConfig) -> dict:
    """The split kernel on the decoder's fp32 head as the decode hands it
    over once per decode (word_restore's weight [V, H] seen as w [H, V]),
    with zeros, subnormals, infs and NaNs planted: bitwise its plain
    version. Emits its per-decode time and bytes."""
    H = cfg.decode_hidden_size
    g = torch.Generator().manual_seed(SEED + 2)
    weight = torch.randn(VOCAB, H, generator=g) * (2.0 / (H + VOCAB)) ** 0.5
    flat = weight.view(-1)
    flat[:4] = torch.tensor([0.0, -0.0, float("inf"), float("-inf")])
    flat[4:8] = float("nan")
    flat[8::1009] *= 2.0**-126  # subnormal
    w = weight.to(DEVICE).t()
    head = split_head(w)
    torch.cuda.synchronize()
    want = tf32_split_plain(w)
    if not torch.equal(head.parts.view(torch.int32), want.view(torch.int32)):
        differ = int((head.parts.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"the TF32 split differs from its plain version in {differ} values")
    nbytes = w.numel() * 4 + head.parts.numel() * 4  # w read once, hi and lo written once
    bms, by = bound_ms(0.0, PEAK_FP32, nbytes)
    entry = {
        "name": "tf32_split", "route": "cuda", "source": "dlsg_tpu_torch/csrc/vocab_head.cu",
        "replaces": "dlsg_tpu/ops/pallas/vocab_head.py:117",
        "shapes": f"w [{H},{VOCAB}] fp32 (a [{VOCAB},{H}] weight's transpose) -> hi, lo "
                  f"[2,{VOCAB},{head.parts.shape[2]}]",
        "design": "K1's fp32 preparation, once per decode: a 32 x 32 shared-memory transpose, "
                  "TF32 round half away by an integer add and mask (NaN kept), lo of w - hi",
        "max_abs_err": 0.0, "bitwise": True,
        "ms": time_ms(lambda: split_head(w)), "plain_ms": time_ms(lambda: tf32_split_plain(w)),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "device_ms": device_ms(lambda: split_head(w)), "bytes_per_decode": head.parts.numel() * 4,
    }
    emit({"phase": "tf32_split", **{k: entry[k] for k in ("shapes", "ms", "device_ms", "bound_ms",
                                                          "bytes_per_decode")}})
    return entry


def features(n: int, cfg: DLSGConfig, seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((n, cfg.max_frames, cfg.feature_size), dtype=np.float32)
    regions = rng.standard_normal(
        (n, cfg.max_frames, cfg.num_obj, cfg.region_feature_size), dtype=np.float32
    )
    return frames, regions


def decode_plain(decode, frames, regions, lstm: bool = True, vocab: bool = True,
                 qmm: bool = True):
    """`decode` with the model's kernel call sites (all by default) routed to
    the plain versions: the reference decode. Checks that the swapped
    kernels did not launch."""
    swapped = [lib for lib, on in ((LSTM_LIB, lstm), (VOCAB_LIB, vocab), (QMM_LIB, qmm)) if on]
    before = [lib.launches for lib in swapped]
    saved = (lstm_mod.lstm_scan, decode_mod.vocab_head_topk, quant_mod.qmatmul)
    if lstm:
        lstm_mod.lstm_scan = lstm_scan_plain
    if vocab:
        decode_mod.vocab_head_topk = vocab_head_topk_plain
    if qmm:
        quant_mod.qmatmul = qmatmul_plain
    try:
        ids = decode(frames, regions)
        torch.cuda.synchronize()
    finally:
        lstm_mod.lstm_scan, decode_mod.vocab_head_topk, quant_mod.qmatmul = saved
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
    if launches[K1_BF16_KEY] != launches["vocab_head"]:
        raise AssertionError(f"bf16 serving did not take K1's {K1_BF16} route only: {launches}")

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
    profile = device_profile(lambda: decode(fr128, rg128), decode_ms, top=12)

    # ---- the same batch through the plain versions, on the card ----
    # fp32 compute: the two decodes differ only in the kernels' summation order
    cfg32 = replace(cfg, compute_dtype="float32")
    model32 = CapGnnModel(cfg32, VOCAB, device=DEVICE)
    model32.load_state_dict(captioner.model.state_dict())
    decode32 = make_decode_fn(model32, cfg32, beam_size=BEAM, device=DEVICE)
    before = read_launches()
    ids32 = decode32(fr128, rg128)
    torch.cuda.synchronize()
    fp32_launches = {key: n - before[key] for key, n in read_launches().items()}
    # fp32 w: the head split once, K1 on its TF32 route every beam step
    if not (fp32_launches[K1_FP32_KEY] == fp32_launches["vocab_head"] >= 1
            and fp32_launches[SPLIT_KEY] == 1):
        raise AssertionError(f"the fp32 decode did not run K1's {K1_FP32} route on a split head: "
                             f"{fp32_launches}")
    agree_fp32 = agreement(ids32, decode_plain(decode32, fr128, rg128))
    if agree_fp32 < TOKEN_AGREEMENT_MIN:
        raise AssertionError(f"fp32 token agreement with the plain versions {agree_fp32} < 0.99")
    # the fp32 decode with the fused vocab head on (its TF32 route) and off
    # (torch.mm + top-k + logsumexp), in turns: on, off, off, on
    decode32_off = make_decode_fn(model32, replace(cfg32, use_fused_vocab_head="off"),
                                  beam_size=BEAM, device=DEVICE)
    fp32_ms = {"on": [], "off": []}
    for head in ("on", "off", "off", "on"):
        fn = decode32 if head == "on" else decode32_off
        fp32_ms[head].append(time_ms(lambda: fn(fr128, rg128), repeats=5, warmup=1, flush=False))
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
        "launches_fp32_decode": fp32_launches,
        "decode_ms_b128_fp32_fused_head_on": fp32_ms["on"],
        "decode_ms_b128_fp32_fused_head_off": fp32_ms["off"],
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
    return compare_card_vs_cpu(moments, MOMENT_TOL[compute_dtype], f"{compute_dtype} GAN step")


def compare_card_vs_cpu(moments: dict, tol: float, what: str) -> dict:
    """Adam first moments {"cpu": {name: t}, DEVICE: {...}}: within `tol` of
    each CPU tensor's max-abs, and none zero on one device only."""
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
        raise AssertionError(f"{what}: card-vs-CPU Adam moments differ: {bad[:8]}")
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


def _timed_steps(step, n: int = 4) -> list:
    """CUDA-event ms of `n` calls of `step()`: the first is the warm-up."""
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def remat_run(cfg: DLSGConfig, start: dict, batch: dict, policy, timed: bool) -> dict:
    """One (decoder_remat, disc_remat) row from the `start` weights: the
    first GAN step's metrics, parameters and Adam first moments (and the
    same of a first CE step when disc_remat is none); with `timed` three
    more steps of each, their ms and each step's peak memory."""
    pcfg = replace(cfg, decoder_remat=policy[0], disc_remat=policy[1])
    G = CapGnnModel(pcfg, VOCAB, device=DEVICE)
    D = DiscV2(pcfg, VOCAB, device=DEVICE)
    G.load_state_dict(start["G"])
    D.load_state_dict(start["D"])
    gs = TrainState.create(G, make_optimizer(TRAIN_LR))
    ds = TrainState.create(D, make_optimizer(TRAIN_LR))
    lstate = init_lambda_state(LAMBDA0, device=DEVICE)
    gan_step = make_gan_train_step(G, D, pcfg)
    out = {}

    def state(tag, state_g, state_d=None):
        """Parameters and first moments, on the host (so that no row's
        copies sit in a later row's peak)."""
        parts = [("G", G.state_dict()), ("G.mu", state_g.first_moments())]
        if state_d is not None:
            parts += [("D", D.state_dict()), ("D.mu", state_d.first_moments())]
        return {f"{tag}.{part}.{k}": v.detach().to("cpu", torch.float32, copy=True)
                for part, tensors in parts for k, v in tensors.items()}

    metrics = []

    def one_gan():
        nonlocal gs, ds, lstate
        gs, ds, lstate, m = gan_step(gs, ds, lstate, batch, TRAIN_KEY, SS_EPSILON)
        metrics.append(m)

    torch.cuda.reset_peak_memory_stats()
    ms = _timed_steps(one_gan, 1)
    first = metrics[0]
    out["tensors"] = state("gan", gs, ds)
    out["metrics"] = {f"gan.{k}": float(v) for k, v in _finite_metrics(first).items()}
    if timed:
        ms += _timed_steps(one_gan, 3)
        out["gan_ms"] = ms[1:]
        out["peak_gb_gan"] = torch.cuda.max_memory_allocated() / 1e9
    if policy[1] == "none":
        G.load_state_dict(start["G"])
        ce_step = make_ce_train_step(G, pcfg)
        cs = TrainState.create(G, make_optimizer(TRAIN_LR))
        ce_metrics = []

        def one_ce():
            nonlocal cs
            cs, m = ce_step(cs, batch, TRAIN_KEY, SS_EPSILON)
            ce_metrics.append(m)

        torch.cuda.reset_peak_memory_stats()
        ms = _timed_steps(one_ce, 1)
        out["tensors"].update(state("ce", cs))
        out["metrics"]["ce.cap_loss"] = float(ce_metrics[0]["cap_loss"])
        if timed:
            ms += _timed_steps(one_ce, 3)
            out["ce_ms"] = ms[1:]
            out["peak_gb_ce"] = torch.cuda.max_memory_allocated() / 1e9
    del G, D, gs, ds, gan_step
    torch.cuda.empty_cache()
    return out


def compare_to_none(rows: dict, tol: float, what: str) -> dict:
    """Each row's metrics and tensors against the (none, none) row's: the
    largest difference as a share of the reference tensor's max-abs (of
    the metric's magnitude, at least 1), which must stay within `tol`."""
    want = rows[("none", "none")]
    worst = {}
    for policy, got in rows.items():
        if policy == ("none", "none"):
            continue
        shares = []
        for k, v in got["metrics"].items():
            shares.append(abs(v - want["metrics"][k]) / max(abs(want["metrics"][k]), 1.0))
        for k, v in got["tensors"].items():
            ref = want["tensors"][k]
            scale = float(ref.abs().max())
            shares.append(float((v - ref).abs().max()) / scale if scale else float(v.abs().max()))
        worst["/".join(policy)] = max(shares)
    bad = {k: v for k, v in worst.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{what}: remat rows differ from (none, none) beyond {tol}: {bad}")
    return {"worst_share_of_max_abs": worst, "tolerance": tol}


def phase_remat(cfg: DLSGConfig) -> dict:
    """The GAN and CE train steps under each remat policy (module doc,
    item 5a)."""
    gen = torch.Generator().manual_seed(SEED)
    start = {"G": CapGnnModel(cfg, VOCAB, generator=gen, device=DEVICE).state_dict(),
             "D": DiscV2(cfg, VOCAB, generator=gen, device=DEVICE).state_dict()}
    batch = train_batch(cfg, BATCH, VOCAB, SEED + 5, DEVICE)

    # ---- the main path, with every kernel's launch count read over it ----
    reset_launches()
    rows = {policy: remat_run(cfg, start, batch, policy, timed=True)
            for policy in REMAT_POLICIES}
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the remat path launched a kernel: {launches}")
    bf16 = compare_to_none(rows, MOMENT_TOL["bfloat16"], "bf16, B = 128")
    base = rows[("none", "none")]["peak_gb_gan"]
    for policy in (("full", "none"), ("none", "full")):
        if not rows[policy]["peak_gb_gan"] < base:
            raise AssertionError(f"remat {policy} did not lower the GAN step's peak: "
                                 f"{rows[policy]['peak_gb_gan']} GB against {base} GB")
    del start, batch
    torch.cuda.empty_cache()

    f32 = replace(cfg, compute_dtype="float32")
    gen = torch.Generator().manual_seed(SEED)
    start = {"G": CapGnnModel(f32, VOCAB, generator=gen, device=DEVICE).state_dict(),
             "D": DiscV2(f32, VOCAB, generator=gen, device=DEVICE).state_dict()}
    batch = train_batch(f32, REMAT_FP32_BATCH, VOCAB, SEED + 5, DEVICE)
    fp32 = compare_to_none({p: remat_run(f32, start, batch, p, timed=False)
                            for p in REMAT_POLICIES},
                           MOMENT_TOL["float32"], f"fp32, B = {REMAT_FP32_BATCH}")
    table = [{"decoder_remat": p[0], "disc_remat": p[1],
              "gan_step_ms": float(np.median(r["gan_ms"])), "gan_ms_all": r["gan_ms"],
              "peak_gb_gan": r["peak_gb_gan"],
              **({"ce_step_ms": float(np.median(r["ce_ms"])), "ce_ms_all": r["ce_ms"],
                  "peak_gb_ce": r["peak_gb_ce"]} if "ce_ms" in r else {})}
             for p, r in rows.items()]
    result = {"phase": "remat", "config": "msr-vtt, bf16, dropout 0.3, train phase's seeds",
              "vocab": VOCAB, "batch": BATCH, "launches": launches, "rows": table,
              "check_bf16": bf16, "check_fp32": fp32}
    emit(result)
    return result


def _gv_modules(cfg: DLSGConfig, device) -> dict:
    """The five graph modules at MSR-VTT widths, fp32, seeded weights and
    seeded running statistics (so that eval mode uses them)."""
    from dlsg_tpu_torch.models import graph_variants as gv

    vh, P = cfg.visual_hidden_size, cfg.num_proposals
    mods = {
        "LatentGNN": gv.LatentGNN(vh, P, generator=torch.Generator().manual_seed(SEED),
                                  device=device),
        "GNN": gv.GNN(cfg.region_feature_size, vh,
                      generator=torch.Generator().manual_seed(SEED), device=device),
        "GraphAttentionLayer": gv.GraphAttentionLayer(
            vh, vh, cfg.dropout, generator=torch.Generator().manual_seed(SEED), device=device),
        "EncoderVisualGraph": gv.EncoderVisualGraph(cfg, device=device),
        "EncoderVisualGAT": gv.EncoderVisualGAT(cfg, device=device),
    }
    rng = np.random.default_rng(SEED)
    for mod in mods.values():
        for name, buf in mod.named_buffers():
            vals = (rng.uniform(0.5, 2.0, size=buf.shape) if name.endswith("running_var")
                    else rng.normal(size=buf.shape) * 0.1)
            buf.copy_(torch.from_numpy(vals.astype(np.float32)))
    return mods


def _gv_inputs(cfg: DLSGConfig, n: int, device) -> dict:
    """Each module's inputs for n clips: frames [n, 26, 2560], regions
    [n, 26, 36, 2048], frame-wide features [n, 26, H] and object-wide
    [n, 26 * 36, H]."""
    frames, regions = (torch.as_tensor(a, device=device) for a in features(n, cfg, SEED + 9))
    rng = np.random.default_rng(SEED + 10)
    T, O, H = cfg.max_frames, cfg.num_obj, cfg.visual_hidden_size
    frame_h = torch.as_tensor(rng.normal(size=(n, T, H)).astype(np.float32), device=device)
    obj_h = torch.as_tensor(rng.normal(size=(n, T * O, H)).astype(np.float32), device=device)
    return {"LatentGNN": (frame_h,), "GNN": (regions,), "GraphAttentionLayer": (obj_h, frame_h),
            "EncoderVisualGraph": (frames, regions), "EncoderVisualGAT": (frames, regions)}


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| as a share of want's max-abs (compare_card_vs_cpu's
    measure)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


def gnn_against_float64(cpu_gnn, regions: torch.Tensor, cpu_out: torch.Tensor,
                        card_out: torch.Tensor) -> dict:
    """GNN's card and CPU fp32 outputs against its float64 product on the
    CPU, as shares of its max-abs: the card's must stay within GV_GNN_TOL
    (its definition says why)."""
    B, T, O, Fs = regions.shape
    f = regions.reshape(B, T * O, Fs).double()
    lin = lambda d, a: a @ d.weight.double().t() + d.bias.double()  # noqa: E731
    adj = torch.softmax(lin(cpu_gnn.adj_Q, f) @ lin(cpu_gnn.adj_K, f).transpose(1, 2), dim=-1)
    ref = (adj @ lin(cpu_gnn.graph_update, f)).reshape(B, T, O, -1)
    card, cpu = _share(card_out.double(), ref), _share(cpu_out.double(), ref)
    if not card <= GV_GNN_TOL:
        raise AssertionError(f"GNN on the card is {card} of max-abs from float64 "
                             f"(the CPU's fp32 {cpu}): beyond {GV_GNN_TOL}")
    return {"card_vs_float64": card, "cpu_vs_float64": cpu, "float64_tolerance": GV_GNN_TOL}


def phase_graph_variants() -> dict:
    """The five graph modules at MSR-VTT widths (module doc, item 5b)."""
    cfg = apply_dataset_overrides(DLSGConfig(dataset="msr-vtt"))
    mods = _gv_modules(cfg, DEVICE)
    cpu_mods = _gv_modules(cfg, "cpu")
    for name, mod in mods.items():
        cpu_mods[name].load_state_dict(mod.state_dict())
    inputs = _gv_inputs(cfg, BATCH, DEVICE)

    # ---- the main path, with every kernel's launch count read over it ----
    reset_launches()
    rows, outs = [], {}
    for name, mod in mods.items():
        args = inputs[name]
        mod.eval()
        with torch.no_grad():
            outs[name] = mod(*args)
            if not torch.isfinite(outs[name]).all():
                raise AssertionError(f"{name}: non-finite eval output")
            eval_ms = time_ms(lambda: mod(*args), repeats=5, warmup=1)
        mod.train()
        stats = {k: v.clone() for k, v in mod.named_buffers()}

        def train_step():
            out = mod(*args)
            (out.float() ** 2).mean().backward()

        torch.cuda.reset_peak_memory_stats()
        train_ms = time_ms(train_step, repeats=3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        for k, v in mod.named_buffers():  # restore the seeded statistics
            v.copy_(stats[k])
        mod.zero_grad(set_to_none=True)
        rows.append({"module": name, "input_shapes": [list(a.shape) for a in args],
                     "output_shape": list(outs[name].shape), "eval_ms": eval_ms,
                     "train_fwd_bwd_ms": train_ms, "peak_gb_train": peak})
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the graph_variants path launched a kernel: {launches}")

    n = GV_CPU_CLIPS
    cpu_inputs = {k: tuple(a[:n].cpu() for a in v) for k, v in inputs.items()}
    checks = {}
    for (name, mod), row in zip(mods.items(), rows):
        cmod = cpu_mods[name]
        cmod.eval()
        with torch.no_grad():
            eval_diff = _share(outs[name][:n], cmod(*cpu_inputs[name]))
        # train mode: the first n clips as their own batch on both devices
        mod.train()
        cmod.train()
        with torch.no_grad():
            card_out = mod(*(a[:n] for a in inputs[name]))
            cpu_out = cmod(*cpu_inputs[name])
        train_diff = _share(card_out, cpu_out)
        stats_diff = max([_share(a, b) for a, b in zip(mod.buffers(), cmod.buffers())],
                         default=0.0)
        checks[name] = {"eval": eval_diff, "train": train_diff, "running_stats": stats_diff,
                        "batch_stats": len(list(mod.buffers())) // 2}
        if name == "GNN":  # no mode of its own: eval and train are one forward
            checks[name].update(gnn_against_float64(cmod, cpu_inputs[name][0], cpu_out,
                                                    outs[name][:n]))
        elif not max(eval_diff, train_diff, stats_diff) <= GV_TOL:
            raise AssertionError(f"{name}: card against CPU beyond {GV_TOL}: {checks[name]}")
    result = {"phase": "graph_variants", "config": "msr-vtt, fp32", "batch": BATCH,
              "launches": launches, "rows": rows, "card_vs_cpu_share_of_max_abs": checks,
              "cpu_clips": n, "tolerance": GV_TOL}
    emit(result)
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
        k1, k1_route = VOCAB_LIB.launches, ROUTE_LAUNCHES[K1_BF16]
        t = time.perf_counter()
        out = real_evaluate(*args, **kw)
        evals.append({"seconds": time.perf_counter() - t, "infer_s": out[3],
                      "k1_launches": VOCAB_LIB.launches - k1,
                      "k1_bf16_route_launches": ROUTE_LAUNCHES[K1_BF16] - k1_route,
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
        if not 1 <= ev["k1_launches"] <= cfg.max_words or ev["k1_bf16_route_launches"] != ev["k1_launches"]:
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


# --------------------------------------------------------------- baselines

# the baselines phase. (b): `cli train-base` / `train-legacy` at MSR-VTT
# widths, 86 synthetic videos x 3 captions = 2 CE steps of 128 and, by
# saving_schedule(0, 2), an eval of the 86 clips after each; (c): the GloVe
# run, 43 x 3 = 1 step and its eval
BASELINES = (CapModel, CapBaseline1, CapBaselineModel)
BASE_FLAGS = ["--dataset", "msr-vtt", "--compute_dtype", "bfloat16", "--use_fused_vocab_head", "on",
              "--synthetic", "--synthetic_vocab", str(VOCAB), "--train_batch_size", str(BATCH),
              "--test_batch_size", str(BATCH), "--epoch_num", "1", "--no_debug"]
BASE_VIDEOS = 86
GLOVE_VIDEOS = 43
GLOVE_WORDS = 200  # the vocabulary words the GloVe file holds


def base_config() -> DLSGConfig:
    """The config that the commands of BASE_FLAGS run."""
    return parse_opt(cli._parser().parse_known_args(BASE_FLAGS)[1])


def baseline_decode(cls, cfg: DLSGConfig, fr, rg, noise) -> dict:
    """(a) for one generator: its beam-5 decode of the clips through both
    kernels (the main path, counted), then, uncounted, its time and its
    agreement with the same decode through the plain versions under the
    serving phase's rules."""
    model = cls(cfg, VOCAB, generator=torch.Generator().manual_seed(SEED + 70), device=DEVICE)
    decode = make_decode_fn(model, cfg, beam_size=BEAM, device=DEVICE)
    before = read_launches()
    ids = decode(fr, rg)
    torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in read_launches().items()}
    if ids.shape != (BATCH, cfg.max_words) or not bool(((ids >= 0) & (ids < VOCAB)).all()):
        raise AssertionError(f"{cls.__name__}: the decode gave ids {tuple(ids.shape)} out of range")
    if launches["lstm_scan"] != 2 or not 1 <= launches["vocab_head"] <= cfg.max_words or \
            launches[K1_BF16_KEY] != launches["vocab_head"]:
        raise AssertionError(f"{cls.__name__}: launches of one decode {launches}")
    with uncounted():
        decode_ms = time_ms(lambda: decode(fr, rg), repeats=7, warmup=1, flush=False)
        with torch.inference_mode():
            encode_ms = time_ms(lambda: model.encode(fr, rg), repeats=7, flush=False)
        cfg32 = replace(cfg, compute_dtype="float32")
        model32 = cls(cfg32, VOCAB, device=DEVICE)
        model32.load_state_dict(model.state_dict())
        decode32 = make_decode_fn(model32, cfg32, beam_size=BEAM, device=DEVICE)
        agree_fp32 = agreement(decode32(fr, rg), decode_plain(decode32, fr, rg))
        agree_vocab = agreement(ids, decode_plain(decode, fr, rg, lstm=False))
        plain = decode_plain(decode, fr, rg)
        agree_bf16 = agreement(ids, plain)
        floor = agreement(plain, decode_plain(decode, fr * (1 + 1e-6 * noise), rg))
    if agree_fp32 < TOKEN_AGREEMENT_MIN or agree_vocab < TOKEN_AGREEMENT_MIN or \
            agree_bf16 < floor - BF16_FLOOR_MARGIN:
        raise AssertionError(
            f"{cls.__name__}: token agreement with the plain versions fp32 {agree_fp32}, bf16 "
            f"vocab head alone {agree_vocab}, bf16 both {agree_bf16} (floor {floor})")
    return {"decode_ms_b128": decode_ms, "encode_ms_b128": encode_ms,
            "launches_one_decode": launches,
            "token_agreement_vs_plain_fp32": agree_fp32,
            "token_agreement_vs_plain_vocab_head_bf16": agree_vocab,
            "token_agreement_vs_plain_bf16": agree_bf16,
            "bf16_plain_self_agreement_input_1e-6": floor}


def baseline_ce_step(cls, cfg: DLSGConfig) -> dict:
    """The generator's CE step at MSR-VTT widths, batch 128: one warm-up
    step, then the median of 3 by CUDA events, and peak memory. No kernel
    launches (the train path runs neither, as in JAX)."""
    model = cls(cfg, VOCAB, generator=torch.Generator().manual_seed(SEED + 72), device=DEVICE)
    batch = train_batch(cfg, BATCH, VOCAB, SEED + 73, DEVICE)
    state = TrainState.create(model, make_optimizer(TRAIN_LR))
    step = (make_legacy_ce_train_step if cls is CapModel else make_ce_train_step)(model, cfg)
    before = read_launches()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch, TRAIN_KEY, SS_EPSILON)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(_finite_metrics(m)["cap_loss"])
    if read_launches() != before:
        raise AssertionError(f"{cls.__name__}'s CE step launched a kernel")
    return {"ce_step_ms_b128": float(np.median(ms[1:])), "ce_step_ms_all": ms[1:],
            "cap_loss": losses, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_ce_card_vs_cpu() -> dict:
    """One fp32 CE step of CapBaseline1 at tiny dims on the card and on the
    CPU from the same weights, dropout off, every word gold, lr
    MOMENT_CHECK_LR: the Adam first moments must agree."""
    cfg = tiny_test_config()
    vocab, n = 50, 4
    batch = train_batch(cfg, n, vocab, SEED + 74, "cpu")
    moments = {}
    saved = linear_mod.dropout
    linear_mod.dropout = lambda x, rate, rng: x
    try:
        for device in ("cpu", DEVICE):
            model = CapBaseline1(cfg, vocab, device=device)  # seeded with cfg.seed
            state = TrainState.create(model, make_optimizer(MOMENT_CHECK_LR))
            state, m = make_ce_train_step(model, cfg)(
                state, {k: v.to(device) for k, v in batch.items()}, TRAIN_KEY, 1.0)
            _finite_metrics(m)
            moments[device] = {k: v.float().cpu() for k, v in state.first_moments().items()}
    finally:
        linear_mod.dropout = saved
    return compare_card_vs_cpu(moments, MOMENT_TOL["float32"], "CapBaseline1 fp32 CE step")


def baseline_cli(command: str, result_dir: str, videos: int, evals_want: int, extra=()) -> dict:
    """`cli <command> --synthetic` at MSR-VTT widths (BASE_FLAGS) on the
    card: exit 0, `evals_want` evals whose decodes launch K1 on its bf16
    (wgmma) route on every beam step, all seven scores finite, the
    losses and scores logged (finite) and no checkpoint directory."""
    evals = []
    real_evaluate = trainer_mod.evaluate

    def counted_evaluate(*args, **kw):
        k1, k1_route = VOCAB_LIB.launches, ROUTE_LAUNCHES[K1_BF16]
        t = time.perf_counter()
        out = real_evaluate(*args, **kw)
        evals.append({"seconds": time.perf_counter() - t, "infer_s": out[3],
                      "k1_launches": VOCAB_LIB.launches - k1,
                      "k1_bf16_route_launches": ROUTE_LAUNCHES[K1_BF16] - k1_route,
                      "scores": out[0]})
        return out

    trainer_mod.evaluate = counted_evaluate
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = cli.main([command, "--result_dir", result_dir, "--synthetic_videos", str(videos)]
                          + BASE_FLAGS + list(extra))
    finally:
        trainer_mod.evaluate = real_evaluate
    seconds = time.perf_counter() - t
    max_words = base_config().max_words
    problems = []
    if rc != 0 or len(evals) != evals_want:
        problems.append(f"rc {rc}, {len(evals)} evals")
    for ev in evals:
        if set(ev["scores"]) != set(SCORE_KEYS) or not all(np.isfinite(list(ev["scores"].values()))):
            problems.append(f"scores {ev['scores']}")
        if not 1 <= ev["k1_launches"] <= max_words or ev["k1_bf16_route_launches"] != ev["k1_launches"]:
            problems.append(f"K1 launches of an eval decode {ev}")
    if os.path.exists(os.path.join(result_dir, "checkpoints")):
        problems.append("it wrote a checkpoint directory")
    scalars = _scalars(result_dir)
    tags = {tag for tag, _, _ in scalars}
    if not {"Loss/cap_loss", "results/CIDEr"} <= tags or not all(np.isfinite(v) for _, v, _ in scalars):
        problems.append(f"scalars.jsonl: {sorted(tags)}")
    if problems:
        raise AssertionError(f"cli {command}: {problems}\n{log.getvalue()[-2000:]}")
    return {"seconds": seconds,
            "evals": [{k: v for k, v in ev.items() if k != "scores"}
                      | {"CIDEr": ev["scores"]["CIDEr"]} for ev in evals]}


def baseline_glove(work: str) -> dict:
    """(c): `cli train-base --use_glove true --freeze_word_embed true` with
    a GloVe text file of GLOVE_WORDS of the vocabulary's words at the
    config's word_size: their embedding rows on the card equal the file's
    vectors, and the whole embedding is bitwise unchanged after the step."""
    word_size = base_config().word_size
    words = cli._synthetic_vocab(VOCAB).idx2word[4:4 + GLOVE_WORDS]
    rng = np.random.default_rng(SEED + 75)
    vectors = [[f"{v:.6f}" for v in rng.normal(size=word_size)] for _ in words]
    path = os.path.join(work, "glove.txt")
    with open(path, "w") as f:
        f.writelines(" ".join([w] + vec) + "\n" for w, vec in zip(words, vectors))
    runs = []
    real_train = trainer_mod.Run.train

    def recording_train(self):
        before = self.gen_model.state_dict()[WORD_EMBED_KEY].clone()
        params = {k: v.clone() for k, v in self.gen_model.state_dict().items()}
        out = real_train(self)
        runs.append((self, before, params))
        return out

    trainer_mod.Run.train = recording_train
    try:
        out = baseline_cli("train-base", os.path.join(work, "results"), GLOVE_VIDEOS, 1,
                           ["--use_glove", "true", "--freeze_word_embed", "true",
                            "--glove_txt_path", path, "--data_dir", work])
    finally:
        trainer_mod.Run.train = real_train
    (runner, before, params), = runs
    after = runner.gen_model.state_dict()
    ids = [runner.vocab(w) for w in words]
    want = torch.tensor(np.float64(vectors)).float().to(DEVICE)
    problems = []
    if before.device.type != torch.device(DEVICE).type or not torch.equal(before[ids], want):
        problems.append("the grafted rows differ from the file's vectors")
    if not torch.equal(after[WORD_EMBED_KEY], before) or runner.gen_state.step != 1:
        problems.append(f"the frozen embedding moved (steps {runner.gen_state.step})")
    if all(torch.equal(after[k], v) for k, v in params.items() if k != WORD_EMBED_KEY):
        problems.append("no other parameter moved")
    if problems:
        raise AssertionError(f"glove: {problems}")
    return {**out, "word_size": word_size, "file_words": len(words),
            "grafted_rows_equal_file": True, "embedding_unchanged_after_step": True}


def phase_baselines() -> dict:
    """The baseline generators and their CE trainers on the card (module
    doc, item 6f); every kernel's launches counted over (a)'s decodes and
    (b)-(c)'s commands."""
    t_phase = time.perf_counter()
    cfg = serving_config()
    fr, rg = (torch.from_numpy(a).to(DEVICE) for a in features(BATCH, cfg, seed=SEED + 71))
    noise = torch.randn(fr.shape, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                        device=DEVICE)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    decodes = {}
    for cls in BASELINES:
        decodes[cls.__name__] = baseline_decode(cls, cfg, fr, rg, noise)
        torch.cuda.empty_cache()
    decode_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del fr, rg, noise
    torch.cuda.empty_cache()
    train_cfg = apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16"))
    steps = {}
    for cls in (CapBaseline1, CapModel):
        steps[cls.__name__] = baseline_ce_step(cls, train_cfg)
        torch.cuda.empty_cache()
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_baselines_")
    trainers = {cmd: baseline_cli(cmd, os.path.join(work.name, cmd), BASE_VIDEOS, 2)
                for cmd in ("train-base", "train-legacy")}
    glove = baseline_glove(work.name)
    launches = read_launches()
    resume_rc = {cmd: cli.main([cmd, "--resume", "--synthetic"]) for cmd in ("train-base", "train-legacy")}
    work.cleanup()
    if set(resume_rc.values()) != {2}:
        raise AssertionError(f"--resume: {resume_rc}, want exit 2")
    if not launches["lstm_scan"] or not launches[K1_BF16_KEY]:
        raise AssertionError(f"the baselines path did not launch both kernels: {launches}")
    result = {
        "phase": "baselines",
        "config": "(a) msr-vtt, bf16, use_pallas_lstm, fused vocab head, beam 5, 128 clips; "
                  "(b)-(c) the trainers' commands at msr-vtt widths, bf16, fused head, batch 128",
        "decode": decodes, "decode_peak_mem_gb": decode_peak_gb,
        "ce_steps": steps, "ce_card_vs_cpu_fp32": check_ce_card_vs_cpu(),
        "trainers": trainers, "glove": glove, "resume_rc": resume_rc,
        "launches": launches, "seconds": time.perf_counter() - t_phase,
    }
    emit(result)
    return result

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
                or n[K1_BF16_KEY] != n["vocab_head"]:
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
                and launches[K1_BF16_KEY] == launches["vocab_head"]):
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
    cpp, cpp_s, py_s = time_scorers(references, captions)
    result = {"phase": "scorer", "captions": len(captions),
              "words_per_caption": len(next(iter(captions.values())).split()),
              "cpp_s": cpp_s, "python_s": py_s, "python_over_cpp": py_s / cpp_s,
              "library_build_s": build_s, "library": native.library_path().name, "scores": cpp}
    emit(result)
    return result


# --------------------------------------------------------------- int8 decode

# the int8 phase's share of rows finished within TWO_PASS_T1 for its two-pass
# decode (the two_pass phase's "mixed" regime)
INT8_TWO_PASS_WINDOW = (0.25, 0.75)
# the first beam step's logits, int8 against unquantized (tests/test_quant.py)
INT8_CORR_MIN = 0.999


def int8_model(cfg: DLSGConfig, params: dict):
    """(config with decode_quant='int8', CapGnnModel of it with `params`)."""
    qcfg = replace(cfg, decode_quant="int8")
    model = CapGnnModel(qcfg, VOCAB, device=DEVICE)
    model.load_state_dict(params)
    return qcfg, model


def device_ms(fn, n: int = 20) -> float:
    """Device milliseconds of one `fn` call without its host time (the kernel
    time torch.profiler records over n back-to-back calls, L2 warm)."""
    return device_us_per_call(fn, n) / 1e3


def host_us(fn, n: int = 50) -> float:
    """Host microseconds a call of `fn` takes to enqueue its work (wall clock
    over n back-to-back calls, no synchronisation between them)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return host


def check_qmatmul(cfg: DLSGConfig, params: dict) -> dict:
    """qmatmul at the int8 decode's three products (the quantized Wq, Wl and
    Wv of the serving weights, from the decode's own precompute) and both
    row counts (B = 128 on the first beam step, B x beam = 640 after), x =
    tanh(N(0, 1)) like the decoder's states: bitwise its plain version. The
    kernels-line numbers are one beam step's three products at G = 640,
    summed; `per_call` has each call with its plan (tile width, blocks),
    a bf16 torch.mm of the same shape (unquantized weights, fp32 output)
    beside the library's int8 product, the device time of each of the three
    without host time (`device_ms`), qmatmul's host time a call (`host_us`)
    and the bound's share of its device time."""
    qcfg, model = int8_model(cfg, params)
    fr, rg = (torch.from_numpy(a).to(DEVICE) for a in features(BATCH, cfg, seed=SEED + 3))
    with torch.inference_mode():
        _, pre = model.decoder_init_beam_state(*model.encode(fr, rg))
        step = model.decoder.step
        bf16 = {"Wq": step.query_lstm.fused_weights()[0], "Wl": step.lang_lstm.fused_weights()[0],
                "Wv": step.word_restore.kernel(torch.bfloat16)}
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    shapes, err, library_equal = [], 0.0, True
    for name in ("Wq", "Wl", "Wv"):
        w = pre[name]
        N, Kp = w.qt.shape
        K = bf16[name].shape[0]
        for G in (BATCH, BATCH * BEAM):
            x = torch.tanh(torch.randn(G, K, generator=g, device=DEVICE))
            got = qmatmul(x, *w)
            torch.cuda.synchronize()
            want = qmatmul_plain(x, *w)
            err = max(err, float((got - want).abs().max()))
            library_equal &= bool(torch.equal(int_mm_library(x, w), got))
            xb, wb = x.to(torch.bfloat16), bf16[name].to(torch.bfloat16)
            ops = 2.0 * G * K * N
            nbytes = G * K * 4 + N * Kp + N * 4 + G * N * 4
            bms, by = bound_ms(ops, PEAK_INT8, nbytes)
            plan = qmatmul_plan(G, K, N, torch.cuda.get_device_properties(0).multi_processor_count)
            shapes.append({
                "weight": name, "G": G, "K": K, "N": N, "Kp": Kp, "block_n": plan.block_n,
                "blocks": plan.blocks, "tiles": plan.tiles[0] * plan.tiles[1],
                "ms": time_ms(lambda: qmatmul(x, *w)),
                "plain_ms": time_ms(lambda: qmatmul_plain(x, *w)),
                "library_ms": time_ms(lambda: int_mm_library(x, w)),
                "bf16_mm_ms": time_ms(lambda: torch.mm(xb, wb, out_dtype=torch.float32)),
                "device_ms": device_ms(lambda: qmatmul(x, *w)),
                "library_device_ms": device_ms(lambda: int_mm_library(x, w)),
                "bf16_mm_device_ms": device_ms(lambda: torch.mm(xb, wb, out_dtype=torch.float32)),
                "host_us": host_us(lambda: qmatmul(x, *w)),
                "bound_ms": bms, "bound_by": by,
            })
            shapes[-1]["bound_share_of_device"] = bms / shapes[-1]["device_ms"]
    if err != 0.0:
        raise AssertionError(f"qmatmul differs from its plain version: max-abs {err}, want 0")
    step640 = [s for s in shapes if s["G"] == BATCH * BEAM]
    # the kind that bounds the calls holding most of the summed bound
    by_ms = {by: sum(s["bound_ms"] for s in step640 if s["bound_by"] == by)
             for by in ("bytes", "operations")}
    return {
        "name": "qmatmul", "route": "cuda", "source": "dlsg_tpu_torch/csrc/qmatmul.cu",
        "replaces": "dlsg_tpu/ops/quant.py:35",
        "shapes": "one int8 beam step's Wq, Wl and Wv products at G = 640, summed; per call in "
                  "`per_call`",
        "design": "row-quantize launch (a warp a row, 16-byte loads), then a persistent "
                  "warp-specialized kernel: TMA into an mbarrier ring, wgmma m64nBNk32 s8 on "
                  "two consumer warpgroups, a staged 16-byte epilogue",
        "max_abs_err": err, "tolerance": 0.0, "library_equal_bitwise": library_equal,
        **{k: sum(s[k] for s in step640) for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                   "bf16_mm_ms", "device_ms", "library_device_ms",
                                                   "bf16_mm_device_ms", "host_us")},
        "bound_by": max(by_ms, key=by_ms.get), "per_call": shapes,
    }


def first_step_logits(model, fr, rg) -> torch.Tensor:
    """Raw logits [B, V] of the first beam step from <start>."""
    with torch.inference_mode():
        state, pre = model.decoder_init_beam_state(*model.encode(fr, rg))
        start = torch.full((fr.shape[0],), START_ID, dtype=torch.int64, device=fr.device)
        return model.decoder_beam_step(start, state, pre)[0]


def phase_int8(cfg: DLSGConfig, params: dict) -> dict:
    """The int8 decode (decode_quant='int8') at the serving config. The main
    path, counted: the beam-5 decode of 128 clips with the fused head on (K2
    twice, then qmatmul twice and K1 a beam step) and off (qmatmul three
    times a step), and the two-pass decode of a copy whose <end> bias
    finishes 25-75% of the rows within t1. Then, uncounted: tokens bitwise
    the decode's with qmatmul alone swapped for its plain version; with
    every kernel swapped, held to the serving phase's perturbation rule;
    the two-pass decode's pass-1 rows bitwise the single pass's; the first
    beam step's logits correlated > INT8_CORR_MIN with the unquantized
    step's; the int8 and bf16 decode ms (fused head on) in turns."""
    qcfg, model = int8_model(cfg, params)
    _, model_tp = int8_model(cfg, params)
    on = make_decode_fn(model, qcfg, beam_size=BEAM, device=DEVICE)
    off = make_decode_fn(model, replace(qcfg, use_fused_vocab_head="off"), beam_size=BEAM,
                         device=DEVICE)
    tp_cfg = replace(qcfg, decode_two_pass_t1=TWO_PASS_T1)
    single_tp = make_decode_fn(model_tp, qcfg, beam_size=BEAM, device=DEVICE)
    two_tp = make_decode_fn(model_tp, tp_cfg, beam_size=BEAM, device=DEVICE)
    fr, rg = (torch.from_numpy(a).to(DEVICE) for a in features(BATCH, cfg, seed=SEED + 12))
    noise = torch.randn(fr.shape, generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                        device=DEVICE)
    base = float(model_tp.get_parameter("decoder.step.word_restore.bias").detach()[END_ID])
    with uncounted():
        end_bias, _ = search_end_bias(model_tp, qcfg, fr, rg, base, *INT8_TWO_PASS_WINDOW)

    # ---- the main path, every launch count read over it ----
    reset_launches()
    ids_on = on(fr, rg)
    torch.cuda.synchronize()
    n_on = read_launches()
    ids_off = off(fr, rg)
    torch.cuda.synchronize()
    n_off = {k: n - n_on[k] for k, n in read_launches().items()}
    before = read_launches()
    ids_two = two_tp(fr, rg)
    torch.cuda.synchronize()
    launches = read_launches()
    n_two = {k: n - before[k] for k, n in launches.items()}

    steps_on = n_on["vocab_head"]
    if n_on["lstm_scan"] != 2 or not 1 <= steps_on <= cfg.max_words or \
            n_on["qmatmul"] != 2 * steps_on or n_on[K1_BF16_KEY] != steps_on:
        raise AssertionError(f"int8 decode, fused head on: launches {n_on}")
    if n_off["lstm_scan"] != 2 or n_off["vocab_head"] != 0 or n_off["qmatmul"] % 3 or \
            not 3 <= n_off["qmatmul"] <= 3 * cfg.max_words:
        raise AssertionError(f"int8 decode, fused head off: launches {n_off}")
    if n_two["lstm_scan"] != 2 or not 1 <= n_two["vocab_head"] or \
            n_two["qmatmul"] != 2 * n_two["vocab_head"]:
        raise AssertionError(f"int8 two-pass decode: launches {n_two}")
    for ids in (ids_on, ids_off, ids_two):
        if ids.shape != (BATCH, cfg.max_words) or not bool(((ids >= 0) & (ids < VOCAB)).all()):
            raise AssertionError("the int8 decode gave ids out of range")

    with uncounted():
        # qmatmul alone swapped: the product is bitwise its plain version's
        same = {head: bool(torch.equal(ids, decode_plain(fn, fr, rg, lstm=False, vocab=False)))
                for head, fn, ids in (("on", on, ids_on), ("off", off, ids_off))}
        if not all(same.values()):
            raise AssertionError(f"int8 tokens differ with qmatmul's plain version: {same}")
        plain = decode_plain(on, fr, rg)
        agree = agreement(ids_on, plain)
        floor = agreement(plain, decode_plain(on, fr * (1 + 1e-6 * noise), rg))
        if agree < floor - BF16_FLOOR_MARGIN:
            raise AssertionError(f"int8 token agreement with the plain versions {agree} is "
                                 f"below the perturbation floor {floor} - {BF16_FLOOR_MARGIN}")
        fin = finished_after(model_tp, qcfg, fr, rg, TWO_PASS_T1)
        ids_single = single_tp(fr, rg)
        if not bool(fin.any()) or not torch.equal(ids_two[fin], ids_single[fin]):
            raise AssertionError("int8 two-pass: the rows pass 1 finished differ from the single pass")
        model_bf = CapGnnModel(cfg, VOCAB, device=DEVICE)
        model_bf.load_state_dict(params)
        lq, lf = first_step_logits(model, fr, rg), first_step_logits(model_bf, fr, rg)
        corr = float(torch.corrcoef(torch.stack([lq.flatten(), lf.flatten()]))[0, 1])
        if not corr > INT8_CORR_MIN:
            raise AssertionError(f"first beam step: int8 logits correlate {corr} with bf16's")
        bf16 = make_decode_fn(model_bf, cfg, beam_size=BEAM, device=DEVICE)
        agree_bf16 = agreement(ids_on, bf16(fr, rg))
        ms = {"bf16": [], "int8": []}
        for which in ("bf16", "int8", "int8", "bf16"):
            fn = on if which == "int8" else bf16
            ms[which].append(time_ms(lambda: fn(fr, rg), repeats=5, warmup=1, flush=False))
        off_ms = time_ms(lambda: off(fr, rg), repeats=5, warmup=1, flush=False)
        profile = device_profile(lambda: on(fr, rg), float(np.median(ms["int8"])))
    result = {
        "phase": "int8", "config": "msr-vtt, bf16, use_pallas_lstm, fused vocab head, decode_quant int8",
        "vocab": VOCAB, "batch": BATCH, "beam": BEAM, "launches_fused_on": n_on,
        "launches_fused_off": n_off, "launches_two_pass": n_two, "beam_steps": steps_on,
        "tokens_equal_qmatmul_plain": same, "token_agreement_vs_plain": agree,
        "plain_self_agreement_input_1e-6": floor, "token_agreement_vs_bf16_decode": agree_bf16,
        "first_step_logit_corr_vs_bf16": corr,
        "two_pass": {"t1": TWO_PASS_T1, "end_bias_added": end_bias,
                     "finished_share_after_t1": float(fin.float().mean()),
                     "pass1_rows_equal_single": True},
        "decode_ms_b128_int8_fused_on": ms["int8"], "decode_ms_b128_bf16_fused_on": ms["bf16"],
        "decode_ms_b128_int8_fused_off": off_ms, "profile_int8_b128": profile,
        "mean_caption_tokens": float((ids_on != END_ID).sum(dim=1).float().mean()),
    }
    emit(result)
    result["launches"] = launches
    return result


# ------------------------------------------------------------------ learning


def time_scorers(references: dict, captions: dict):
    """(scores, C++ seconds, Python seconds) of `captions` scored through the
    C++ tokenizer and aligner, then through the Python ones; the two paths'
    seven scores must be equal."""
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
    return cpp, cpp_s, py_s


def phase_learning() -> dict:
    """The JAX package's learning and convergence experiments on the card
    (`train/learning.py`: the GAN fit at fp32 and bf16, the held-out CE
    generalization with the trained model's int8 decode through qmatmul, the
    GAN dynamics with the CE ablation), each held to its thresholds, from
    this package's seeded init. Then the trained decodes' mean caption
    length and their scoring through the C++ and the Python scorer."""
    reset_launches()
    t0 = time.perf_counter()
    runs = {}
    for name, run, check in (
        ("gan_fit_float32", lambda: learning.gan_fit(learning.learning_config(), DEVICE),
         learning.check_gan_fit),
        ("gan_fit_bfloat16",
         lambda: learning.gan_fit(learning.learning_config(compute_dtype="bfloat16"), DEVICE),
         learning.check_gan_fit),
        ("heldout_ce", lambda: learning.heldout_ce(learning.learning_config(), DEVICE),
         learning.check_heldout_ce),
        ("gan_dynamics", lambda: learning.gan_dynamics(learning.learning_config(), DEVICE),
         learning.check_gan_dynamics),
    ):
        runs[name] = run()
        check(runs[name])
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["qmatmul"] == 0:
        raise AssertionError(f"the trained model's int8 decode did not launch qmatmul: {launches}")
    # the trained decodes' captions, scored at their own lengths
    captions, references = {}, {}
    for name, key in (("gan_fit_float32", "captions"), ("gan_fit_bfloat16", "captions"),
                      ("heldout_ce", "captions"), ("heldout_ce", "captions_int8"),
                      ("gan_dynamics", "captions")):
        r = runs[name]
        for vid, cap in r[key].items():
            captions[f"{name}/{key}/{vid}"] = cap
            references[f"{name}/{key}/{vid}"] = [{"caption": c} for c in r["references"][vid]]
    _, cpp_s, py_s = time_scorers(references, captions)
    words = [len(c.split()) for c in captions.values()]
    drop = ("captions", "captions_int8", "references", "wasserstein", "grad_penalty")
    result = {
        "phase": "learning", "seconds": seconds,
        "config": f"tiny_test_config at widths 64 (the JAX tests'), {len(make_vocab())} words",
        "experiments": {name: {k: v for k, v in r.items() if k not in drop} for name, r in runs.items()},
        "trained_captions": len(captions), "mean_caption_words": float(np.mean(words)),
        "scorer_cpp_s": cpp_s, "scorer_python_s": py_s, "launches": launches,
    }
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
    if launches["lstm_scan"] != 2 * chunks or not chunks <= launches["vocab_head"] <= chunks * cfg.max_words \
            or launches[K1_FP32_KEY] != launches["vocab_head"] or launches[SPLIT_KEY] != chunks:
        raise AssertionError(f"cli serve launches (fp32: K1's {K1_FP32} route, a split a decode): "
                             f"{launches}")
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
            launches[K1_BF16_KEY] != launches["vocab_head"]:
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


# ------------------------------------------------------------- model axis

# (a): RunGAN, msr-vtt widths, fp32, fused head, MA_VIDEOS x 2 captions =
# 2 GAN steps of MA_BATCH, cut to one eval (after the last step), at
# MOMENT_CHECK_LR so that the moments compare gradients
MA_VIDEOS = 64
MA_BATCH = 64
MA_SERVER_CLIPS = 16
MA_TIMEOUT = 900  # seconds, the torchrun of the two ranks
def ma_trainer(result_dir: str, mesh=None) -> dict:
    """(a): one RunGAN epoch (module doc, item 6e) in this process, with the
    head split over `mesh`'s model axis when given, timed by
    `parallel/mesh_timing.py` (each GAN step, the model axis's gathers and
    all-reduces, the split decode's merges; the card synced around each)."""
    out = mesh_timing.timed_run_gan(result_dir, DEVICE, mesh, MA_VIDEOS, MA_BATCH)
    out["checkpoint"] = os.path.join(out.pop("checkpoint_dir"), "epoch_0", ckpt_mod.TRAIN_FILE)
    return out


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (a reference or a check, not the main
    path) leave every count as it was."""
    saved = [lib.launches for lib in kernels.LIBRARIES], dict(ROUTE_LAUNCHES)
    try:
        yield
    finally:
        for lib, n in zip(kernels.LIBRARIES, saved[0]):
            lib.launches = n
        ROUTE_LAUNCHES.update(saved[1])


def ma_decode(compute_dtype: str, mesh) -> dict:
    """(b): the beam-5 decode of BATCH clips (fused head) with the head
    split over `mesh`'s model axis, against the same process's decode of
    the whole head (the one-process K1 decode; uncounted). Returns the
    token agreement, the whole decode's own agreement under a 1e-6 input
    perturbation, the beam steps, K1's launches over the split decode (all
    and on the dtype's route), one beam step's split K1 + merge against the
    whole K1 at G = BATCH x BEAM (uncounted), and both decodes' ms."""
    from dlsg_tpu_torch.parallel.mesh import shard_params

    cfg = apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype=compute_dtype,
                                             use_fused_vocab_head="on"))
    model = CapGnnModel(cfg, VOCAB, generator=torch.Generator().manual_seed(SEED + 60), device=DEVICE)
    fr, rg = (torch.from_numpy(a).to(DEVICE) for a in features(BATCH, cfg, seed=SEED + 61))
    decode = make_decode_fn(model, cfg, beam_size=BEAM, device=DEVICE)
    out = {}
    with uncounted():  # the references: the whole head in this process
        whole = decode(fr, rg)
        nudged = decode(fr + 1e-6, rg)
        out["whole_decode_ms"] = time_ms(lambda: decode(fr, rg), repeats=3, warmup=1)
        wv, bv = model.decoder_vocab_head()
        # the whole head, kept from the sharding below (a prepared head's
        # parts or rows are its own)
        bv = bv.clone()
    out["perturbation_floor"] = agreement(whole, nudged)
    shard_params(model, mesh)
    g = torch.Generator().manual_seed(SEED + 62)
    h = torch.tanh(torch.randn(BATCH * BEAM, cfg.decode_hidden_size, generator=g)).to(DEVICE)
    with uncounted():  # one beam step's function: the split head against the whole
        wv_s, bv_s = model.decoder_vocab_head()
        mv, mi = decode_mod.sharded_vocab_head_topk(h, wv_s, bv_s, BEAM, model.decoder_vocab_shard()[0])
        pv, pi = vocab_head_topk(h, wv, bv, BEAM)
        out["step_max_abs_err"] = float((mv - pv).abs().max())
        out["step_ids_differ"] = int((mi != pi).sum())
    route = vocab_head_plan(BATCH * BEAM, *wv_s.shape, cfg.cdtype).route
    steps = []
    real_step = model.decoder_beam_step_hidden
    model.decoder_beam_step_hidden = lambda *a: steps.append(1) or real_step(*a)
    k1, on_route = VOCAB_LIB.launches, ROUTE_LAUNCHES[route]
    ids = decode(fr, rg)
    torch.cuda.synchronize()
    out.update(token_agreement=agreement(ids, whole), beam_steps=len(steps), route=route,
               k1_launches=VOCAB_LIB.launches - k1, k1_on_route=ROUTE_LAUNCHES[route] - on_route)
    model.decoder_beam_step_hidden = real_step
    out["decode_ms"] = time_ms(lambda: decode(fr, rg), repeats=3, warmup=1)
    return out


def serving_config() -> DLSGConfig:
    return apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16",
                                              use_pallas_lstm=True, use_fused_vocab_head="on"))


def caption_agreement(a: list, b: list) -> float:
    """The share of word positions two caption lists agree on (the longer
    caption of each pair sets its positions)."""
    same = total = 0
    for x, y in zip(a, b):
        x, y = x.split(), y.split()
        n = max(len(x), len(y), 1)
        same += sum(p == q for p, q in zip(x, y)) + (len(x) == len(y) == 0)
        total += n
    return same / total


def model_axis_rank(work: str) -> None:
    """One of the two ranks of the model_axis phase (module doc, item 6e),
    both on the one card over gloo: (a) RunGAN on a (data 1 x model 2)
    mesh, (b) the sharded decodes, (c) Captioner(mesh=) on a (data 2) mesh
    and, through the leader, one HTTP request. Every kernel's launches are
    counted over (a)-(c), the references of (b) and (c) (run here, so that
    both sides share one process's cuBLAS set-up) left out. Writes
    work/model_axis_rank_<RANK>.json; the checks run in the parent, so no
    rank leaves a collective early."""
    import datetime

    from dlsg_tpu_torch.parallel import dist
    from dlsg_tpu_torch.parallel.mesh import make_mesh
    from dlsg_tpu_torch.server import follow

    dist.init_distributed(f"{DEVICE}:0", backend="gloo", timeout=datetime.timedelta(seconds=600))
    try:
        r = dist.rank()
        reset_launches()
        mesh = make_mesh(n_data=1, n_model=2)
        t = time.perf_counter()
        a = ma_trainer(os.path.join(work, "tp"), mesh)
        a["seconds"] = time.perf_counter() - t
        ids = a.pop("ids")
        torch.save(ids, os.path.join(work, f"a_ids_{r}.pt"))
        b = {dtype: ma_decode(dtype, mesh) for dtype in ("bfloat16", "float32")}
        torch.cuda.empty_cache()

        mesh = make_mesh(n_data=2)
        cfg = serving_config()
        vocab, params = serving_model(cfg)
        fr, rg = features(BATCH, cfg, seed=SEED + 70)
        half = BATCH // 2
        with uncounted():  # the references: one process's Captioner, here
            one = Captioner(cfg, vocab, params, device=DEVICE)
            halves = one.caption(fr[:half], rg[:half]) + one.caption(fr[half:], rg[half:])
            whole = one.caption(fr, rg)
            del one
        cap = Captioner(cfg, vocab, params, device=DEVICE, mesh=mesh)
        c = {"captions": cap.caption(fr, rg)}
        c["equal_halves"] = c["captions"] == halves
        c["agreement_with_whole"] = caption_agreement(c["captions"], whole)
        fr16, rg16 = fr[:MA_SERVER_CLIPS], rg[:MA_SERVER_CLIPS]
        c["captions_16"] = cap.caption(fr16, rg16)
        if r == 0:
            server = CaptionServer(cap, "127.0.0.1", 0)
            server.start_background()
            try:
                status, payload, ms = http(f"http://127.0.0.1:{server.server_address[1]}/caption",
                                           npz_body(frames=fr16, regions=rg16))
                _, health, _ = http(f"http://127.0.0.1:{server.server_address[1]}/healthz")
            finally:
                server.shutdown()
                server.server_close()  # stops the follower
            c.update(http_status=status, http_ms=ms, healthz=health,
                     http_captions=[x["caption"] for x in payload["captions"]] if status == 200 else None)
        else:
            c["followed"] = follow(cap)
        torch.cuda.synchronize()
        launches = read_launches()
        with open(os.path.join(work, f"model_axis_rank_{r}.json"), "w") as f:
            json.dump({"rank": r, "a": a, "b": b, "c": c, "launches": launches}, f)
    finally:
        torch.distributed.destroy_process_group()


def model_axis_single(work: str) -> None:
    """(a)'s reference: the same RunGAN epoch in one process without a
    group, started like the ranks (same environment, so the same cuBLAS
    set-up); writes work/model_axis_single.json and its eval ids."""
    t = time.perf_counter()
    single = ma_trainer(os.path.join(work, "single"))
    single["seconds"] = time.perf_counter() - t
    torch.save(single.pop("ids"), os.path.join(work, "a_ids_single.pt"))
    with open(os.path.join(work, "model_axis_single.json"), "w") as f:
        json.dump(single, f)


def _moment_diffs(got: dict, want: dict) -> tuple:
    """([worst share of max-abs, its moment], tensors over MOMENT_TOL fp32,
    worst absolute parameter difference) of two loaded train checkpoints."""
    worst, off, param = [0.0, None], [], 0.0
    for prefix in ("gen", "disc"):
        for i, st in want[f"{prefix}_opt"]["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                w, g = st[key].double(), got[f"{prefix}_opt"]["state"][i][key].double()
                if w.shape != g.shape:
                    off.append(f"{prefix}.{i}.{key}: shape {tuple(g.shape)} != {tuple(w.shape)}")
                    continue
                scale = float(w.abs().max())
                share = float((g - w).abs().max()) / scale if scale else float(g.abs().max())
                if share > worst[0]:
                    worst = [share, f"{prefix}.{i}.{key}"]
                if share > MOMENT_TOL["float32"]:
                    off.append(f"{prefix}.{i}.{key}: {share}")
        for k, w in want[f"{prefix}_params"].items():
            g = got[f"{prefix}_params"][k]
            if g.shape != w.shape:
                off.append(f"{prefix}.{k}: shape {tuple(g.shape)} != {tuple(w.shape)}")
                continue
            param = max(param, float((g.double() - w.double()).abs().max()))
    return worst, off, param


def phase_model_axis() -> dict:
    """The model axis on the one card (module doc, item 6e): (a)'s
    one-process reference, then the two ranks under torchrun, each a
    process of its own with one environment; then the checks."""
    t_phase = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_ma_")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")  # the same cuBLAS set-up for all

    # ---- one process: (a)'s reference ----
    rc, out, err = run_command([sys.executable, str(Path(__file__).resolve()), "--model-axis-single",
                                work.name], MA_TIMEOUT, env)
    if rc != 0:
        raise AssertionError(f"model_axis single: rc {rc}\n{out[-3000:]}\n{err[-3000:]}")
    with open(os.path.join(work.name, "model_axis_single.json")) as f:
        single = json.load(f)
    single_ids = torch.load(os.path.join(work.name, "a_ids_single.pt"))

    # ---- the two ranks ----
    t = time.perf_counter()
    rc, out, err = run_command(_torchrun(2) + ["--model-axis-rank", work.name], MA_TIMEOUT, env)
    ranks_s = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"model_axis: rc {rc}\n{out[-3000:]}\n{err[-3000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(work.name, f"model_axis_rank_{r}.json")) as f:
            ranks.append(json.load(f))

    # ---- (a) checks ----
    a0, a1 = ranks[0]["a"], ranks[1]["a"]
    tp_ckpt = torch.load(a0["checkpoint"], map_location="cpu", weights_only=True)
    one_ckpt = torch.load(single["checkpoint"], map_location="cpu", weights_only=True)
    worst, off, param_diff = _moment_diffs(tp_ckpt, one_ckpt)
    updates = max(one_ckpt["disc_step"], 1)
    half_v = VOCAB // 2
    a_agree = [agreement(torch.load(os.path.join(work.name, f"a_ids_{r}.pt")), single_ids) for r in range(2)]
    problems = []
    if off or param_diff > 2 * updates * MOMENT_CHECK_LR:
        problems.append(f"(a) checkpoint against one process: {off[:6]}, parameters {param_diff}")
    if a0["replicated_digest"] != a1["replicated_digest"]:
        problems.append("(a) the replicated parameters differ between the ranks")
    if [a0["head_rows"], a1["head_rows"]] != [[half_v] * 3] * 2 or \
            [a0["out_shard"], a1["out_shard"]] != [[0, VOCAB], [half_v, VOCAB]]:
        problems.append(f"(a) head layout {a0['head_rows']} {a1['head_rows']} {a0['out_shard']} {a1['out_shard']}")
    if a0["steps_g_d"] != single["steps_g_d"] or min(a_agree) < TOKEN_AGREEMENT_MIN or not a0["merges"]:
        problems.append(f"(a) steps {a0['steps_g_d']} vs {single['steps_g_d']}, eval agreement "
                        f"{a_agree}, merges {a0['merges']}")
    # ---- (b) ----
    for dtype in ("bfloat16", "float32"):
        for rk in ranks:
            got = rk["b"][dtype]
            if not (got["k1_launches"] == got["k1_on_route"] == got["beam_steps"] >= 1
                    and got["route"] == (K1_BF16 if dtype == "bfloat16" else K1_FP32)
                    and got["step_max_abs_err"] <= KERNEL_TOL and got["step_ids_differ"] == 0
                    and got["token_agreement"] >= TOKEN_AGREEMENT_MIN):
                problems.append(f"(b) {dtype} rank {rk['rank']}: {got}")
    # ---- (c) ----
    c0, c1 = ranks[0]["c"], ranks[1]["c"]
    if not (c0["equal_halves"] and c1["equal_halves"] and c0["captions"] == c1["captions"]):
        problems.append("(c) the data-split captions differ from one process's 64-clip halves")
    if c0["http_status"] != 200 or c0["http_captions"] != c0["captions_16"] or c1.get("followed") != 1 \
            or c0["healthz"].get("world") != 2 or c0["healthz"].get("mesh") != {"data": 2, "model": 1}:
        problems.append(f"(c) server: status {c0['http_status']}, followed {c1.get('followed')}, "
                        f"healthz {c0['healthz']}")
    launches = ranks[0]["launches"]
    if ranks[1]["launches"] != launches or not launches["lstm_scan"] or \
            not launches[K1_BF16_KEY] or not launches[K1_FP32_KEY] or not launches[SPLIT_KEY]:
        problems.append(f"(a)-(c) launches {launches} / {ranks[1]['launches']}")
    if problems:
        raise AssertionError("model_axis: " + "; ".join(problems))
    work.cleanup()

    result = {
        "phase": "model_axis",
        "a": {"config": f"RunGAN msr-vtt, fp32, fused head, {VOCAB} words, {MA_VIDEOS} videos x 2 "
                        f"captions = 2 GAN steps of {MA_BATCH}, 1 eval; (data 1 x model 2) on one card "
                        f"over gloo against one process; lr {MOMENT_CHECK_LR}",
              "checkpoint_moments_worst_share_of_max_abs": worst, "tolerance": MOMENT_TOL["float32"],
              "checkpoint_params_max_abs_diff": param_diff, "eval_token_agreement": a_agree,
              "step_ms": {"single": single["step_ms"], "ranks": [a0["step_ms"], a1["step_ms"]]},
              "seconds": {"single": single["seconds"], "ranks": [a0["seconds"], a1["seconds"]]},
              "gather_ms_per_step": [a0["gather_ms_per_step"], a1["gather_ms_per_step"]],
              "all_reduce_ms_per_step": [a0["model_all_reduce_ms_per_step"],
                                         a1["model_all_reduce_ms_per_step"]],
              "calls_per_step": a0["calls_per_step"],
              "merge_ms_per_beam_step": [a0["merge_ms_per_beam_step"], a1["merge_ms_per_beam_step"]],
              "peak_mem_gb": {"single": single["peak_mem_gb"],
                              "ranks": [a0["peak_mem_gb"], a1["peak_mem_gb"]]},
              "head_rows_per_rank": a0["head_rows"], "replicated_params_equal_across_ranks": True},
        "b": {dtype: {k: [rk["b"][dtype][k] for rk in ranks]
                      for k in ("token_agreement", "perturbation_floor", "beam_steps", "k1_launches",
                                "route", "step_max_abs_err", "step_ids_differ", "decode_ms",
                                "whole_decode_ms")}
              for dtype in ("bfloat16", "float32")},
        "c": {"config": "serving (msr-vtt, bf16, both kernels), (data 2) on one card over gloo",
              "captions_equal_halves": True,
              "agreement_with_128_clip_decode": [c0["agreement_with_whole"], c1["agreement_with_whole"]],
              "http_ms_16_clips": c0["http_ms"], "healthz": c0["healthz"]},
        "collectives": "gloo, two ranks on one card: not NCCL's times",
        "torchrun_s": ranks_s, "launches": launches, "seconds": time.perf_counter() - t_phase,
    }
    emit(result)
    return result


def main() -> None:
    t_main = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    info = phase_device()
    scorer_build_s = timed("build", phase_build)
    cfg = apply_dataset_overrides(
        DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16",
                   use_pallas_lstm=True, use_fused_vocab_head="on")
    )
    # (key of the serving phase's launch counts, kernels line entry); K1's
    # fp32 route and the split are off the bf16 serving path and count 0
    # there (the fp32 decode, cli serve and the model axis run them)
    t = time.perf_counter()
    checks = [
        ("lstm_scan", check_lstm_scan(cfg)),
        (K1_BF16_KEY, check_vocab_head(cfg, torch.bfloat16)),
        (K1_FP32_KEY, check_vocab_head(cfg, torch.float32)),
        (SPLIT_KEY, check_tf32_split(cfg)),
    ]
    vocab, params = serving_model(cfg)
    checks.append(("qmatmul", check_qmatmul(cfg, params)))
    seconds["kernel_checks"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    serving = timed("serving", phase_serving, cfg, vocab, params)
    launches = {"launches": serving["launches"], "launches_fp32_decode": serving["launches_fp32_decode"]}
    torch.cuda.empty_cache()
    launches["launches_two_pass"] = timed("two_pass", phase_two_pass, cfg, params)["launches"]
    torch.cuda.empty_cache()
    launches["launches_server"] = timed("server", phase_server, cfg, vocab, params)["launches"]
    torch.cuda.empty_cache()
    launches["launches_int8"] = timed("int8", phase_int8, cfg, params)["launches"]
    del params
    torch.cuda.empty_cache()
    launches["launches_learning"] = timed("learning", phase_learning)["launches"]
    torch.cuda.empty_cache()
    train_cfg = apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16"))
    launches["launches_train"] = timed("train", phase_train, train_cfg)["launches"]
    torch.cuda.empty_cache()
    launches["launches_remat"] = timed("remat", phase_remat, train_cfg)["launches"]
    torch.cuda.empty_cache()
    launches["launches_graph_variants"] = timed("graph_variants", phase_graph_variants)["launches"]
    torch.cuda.empty_cache()
    trainer, references, captions = timed(
        "trainer", phase_trainer,
        apply_dataset_overrides(DLSGConfig(dataset="msr-vtt", compute_dtype="bfloat16",
                                           use_fused_vocab_head="on", epoch_num=1)),
        VOCAB, TRAINER_VIDEOS,
    )
    launches["launches_trainer"] = trainer["launches"]
    torch.cuda.empty_cache()
    launches["launches_baselines"] = timed("baselines", phase_baselines)["launches"]
    torch.cuda.empty_cache()
    launches["launches_data_parallel"] = timed("data_parallel", phase_data_parallel)["launches"]
    timed("scorer", phase_scorer, references, captions, scorer_build_s)
    launches["launches_cli_serve"] = timed("cli_serve", phase_cli_serve)["launches"]
    torch.cuda.empty_cache()
    launches["launches_model_axis"] = timed("model_axis", phase_model_axis)["launches"]
    for key, entry in checks:
        for path, counts in launches.items():
            entry[path] = counts[key]
    emit({"phase": "timing", "seconds": seconds, "total_s": time.perf_counter() - t_main})
    emit({"kernels": [entry for _, entry in checks]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})


if __name__ == "__main__":
    # the data_parallel and model_axis phases run these under torchrun or alone
    if sys.argv[1:2] == ["--cli-rank"]:
        sys.exit(cli_rank(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--gan-rank"]:
        gan_rank(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--model-axis-rank"]:
        model_axis_rank(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--model-axis-single"]:
        model_axis_single(sys.argv[2])
        sys.exit(0)
    main()
