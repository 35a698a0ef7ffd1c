"""Scalar logging.

Replaces the reference's rank-0 TensorBoard SummaryWriter (run_gun.py:86-87,
tags Loss/cap_loss, Loss/G_v_loss, Loss/D_loss_visual, Loss/wasserstein_visual,
parameter/gan_lambda, results/{Bleu_4,METEOR,CIDEr,ROUGE_L}) with an append-only
JSONL scalar log plus optional TensorBoard when torch is importable. JSONL is
the source of truth — trivially parseable, multi-host safe (leader-only).
A copy of `dlsg_tpu/utils/logging.py`: the same JSONL lines.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    def __init__(self, log_dir: str, enabled: bool = True, tensorboard: bool = False):
        self.enabled = enabled
        self._tb = None
        self._f = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a", buffering=1)
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if not self.enabled:
            return
        self._f.write(
            json.dumps(
                {"tag": tag, "value": float(value), "step": int(step), "t": time.time()}
            )
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        if self._f:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
