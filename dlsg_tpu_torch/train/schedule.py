"""Training schedules (counterpart of `dlsg_tpu/train/schedule.py`).

- scheduled sampling epsilon (reference run_gun.py:136 and the msr-vtt
  per-step variant run_gun.py:149-151)
- mid-epoch evaluation schedule (run_gun.py:115-133)
"""

from __future__ import annotations

import math
from typing import List


def scheduled_sampling_epsilon(
    ss_factor: int, epoch: int, dataset: str = "msvd", step: int = 0, total_steps: int = 1
) -> float:
    """Teacher-forcing ratio, floored at 0.6.

    msvd: eps = max(.6, ss / (ss + e^(epoch/ss)))
    msr-vtt: per-half-epoch variant with lambda_e in {1, 2}"""
    if dataset == "msr-vtt":
        lambda_e = 1 if step < total_steps / 2 else 2
        return max(0.6, ss_factor / (ss_factor + math.exp((epoch * 2 + lambda_e) / ss_factor)))
    return max(0.6, ss_factor / (ss_factor + math.exp(epoch / ss_factor)))


def saving_schedule(epoch: int, total_step: int, dataset: str = "msvd") -> List[int]:
    """Step indices (1-based) at which to run mid-epoch evaluation: 2 a
    epoch for epochs < 4, 8 for < 7, then 12 for msr-vtt (8 for msvd)."""

    def sched(n):
        return [int(x * total_step / n) for x in range(1, n + 1)]

    if epoch < 4:
        return sched(2)
    if epoch < 7:
        return sched(8)
    return sched(12) if dataset == "msr-vtt" else sched(8)
