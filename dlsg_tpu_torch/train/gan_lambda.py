"""Adaptive GAN loss weight (counterpart of `dlsg_tpu/train/gan_lambda.py`;
reference utils/utils.py:196-265).

Watch a 200-step window of caption loss; while stable, hold lambda at its
start value (0.01); if the mean of the recent half of the window rises more
than 4% over the earlier half, enter a 'decrease' state that follows a
500-step half-sinusoid from lambda_0 down to 0.006 and back, then return to
stable.

Two implementations with the same semantics:
- `GANLambdaHandler`: on the host, in numpy;
- `init_lambda_state` / `lambda_update`: device tensors (a ring buffer and
  the schedule tables, branch-free selects) inside the GAN step, with no
  host sync. Step N's lambda comes from step N's cap_loss, before the
  generator update (run_gun.py:210-231).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlsg_tpu_torch.device import DeviceLike, resolve_device

STABLE, DECREASE, INCREASE = 0, 1, 2

LambdaState = Dict[str, torch.Tensor]


def _sin_schedule(counter: int, start: float, low: float, phase: float) -> List[float]:
    base = (start - low) / 2.0
    xs = np.arange(int(counter * (phase + 1.0)))[int(counter * phase):]
    ys = np.sin(2 * np.pi * 0.5 * xs / counter) * base + base + low
    return ys.tolist()


class GANLambdaHandler:
    def __init__(
        self,
        total_step: int,
        gan_lambda: float,
        cap_list: Optional[Sequence[float]] = None,
        window: int = 200,
        counter: int = 500,
        low_gan_lambda: float = 0.006,
    ):
        self.cap_list: List[float] = list(cap_list) if cap_list is not None else []
        self.total_step = total_step
        self.window = window
        self.counter = counter
        self.current_schedule_step = 0
        self.start_gan_lambda = gan_lambda
        self.low_gan_lambda = low_gan_lambda
        # decrease: sine phase [0.5, 1.5); increase: [1.5, 2.5) (utils.py:249-265)
        self.decrease_schedule = _sin_schedule(counter, gan_lambda, low_gan_lambda, 0.5)
        self.increase_schedule = _sin_schedule(counter, gan_lambda, low_gan_lambda, 1.5)
        self.current_lambda = gan_lambda
        self.state = STABLE

    def update_gan_lambda(self, epoch: int, step: int, cap_loss: float) -> None:
        """Feed the latest caption loss (utils.py:214-235)."""
        self.cap_list.append(float(cap_loss))
        w = self.window
        if len(self.cap_list) > w:
            self.cap_list = self.cap_list[-w:]
            if self.state == STABLE:
                loss_first = float(np.mean(self.cap_list[: w // 2]))
                loss_last = float(np.mean(self.cap_list[w // 2 :]))
                if loss_last > loss_first * 1.04:
                    self.state = DECREASE
            else:
                if self.current_schedule_step == self.counter - 1:
                    self.current_schedule_step = 0
                    self.state = STABLE

    def get_current_lambda(self) -> float:
        """Advance the active schedule and return lambda (utils.py:237-247)."""
        if self.state == DECREASE:
            self.current_lambda = self.decrease_schedule[self.current_schedule_step]
            self.current_schedule_step += 1
        elif self.state == INCREASE:
            self.current_lambda = self.increase_schedule[self.current_schedule_step]
            self.current_schedule_step += 1
        return self.current_lambda


def init_lambda_state(
    gan_lambda: float,
    window: int = 200,
    counter: int = 500,
    low_gan_lambda: float = 0.006,
    device: DeviceLike = None,
) -> LambdaState:
    """The device-side lambda state: a dict of tensors on `device` (default
    `cuda`; pass ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def i64(x):
        return torch.tensor(x, dtype=torch.int64, device=device)

    return {
        "window": torch.zeros(window, dtype=torch.float32, device=device),
        "count": i64(0),
        "state": i64(STABLE),
        "sched_step": i64(0),
        "current_lambda": f32(gan_lambda),
        "dec_schedule": f32(_sin_schedule(counter, gan_lambda, low_gan_lambda, 0.5)),
        "inc_schedule": f32(_sin_schedule(counter, gan_lambda, low_gan_lambda, 1.5)),
    }


def lambda_update(lstate: LambdaState, cap_loss: torch.Tensor) -> Tuple[LambdaState, torch.Tensor]:
    """`update_gan_lambda` then `get_current_lambda`, on the device without
    a host sync: (new state, lambda), lambda from this step's cap_loss."""
    window = lstate["window"]
    w = window.shape[0]
    counter = lstate["dec_schedule"].shape[0]
    slots = torch.arange(w, device=window.device)
    window = torch.where(slots == lstate["count"] % w, cap_loss.detach().float(), window)
    count = lstate["count"] + 1
    state, sched = lstate["state"], lstate["sched_step"]

    # update_gan_lambda: acts only once the window is full
    full = count > w
    ordered = window[(slots + count % w) % w]  # oldest first
    loss_first = ordered[: w // 2].mean()
    loss_last = ordered[w // 2 :].mean()
    trigger = full & (state == STABLE) & (loss_last > loss_first * 1.04)
    reset = full & (state != STABLE) & (sched == counter - 1)
    state = torch.where(trigger, DECREASE, torch.where(reset, STABLE, state))
    sched = torch.where(reset, 0, sched)

    # get_current_lambda
    idx = sched.clamp(0, counter - 1)
    table_val = torch.where(
        state == DECREASE, lstate["dec_schedule"][idx], lstate["inc_schedule"][idx]
    )
    active = state != STABLE
    lam = torch.where(active, table_val, lstate["current_lambda"])
    sched = torch.where(active, sched + 1, sched)
    new_state = dict(
        lstate, window=window, count=count, state=state, sched_step=sched, current_lambda=lam
    )
    return new_state, lam
