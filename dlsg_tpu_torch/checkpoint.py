"""Checkpoint / resume (counterpart of `dlsg_tpu/checkpoint.py`).

The reference's two mechanisms (SURVEY.md §5), in the JAX package's directory
layout under `ckpt_dir`:
1. best-metric model saving (ResultHandler/SAVING_MODEL_NAME,
   utils.py:110-146): `save_model(ckpt_dir, "best_CIDEr", state_dict)`
   writes `best_CIDEr/model.pt`;
2. full training checkpoints (run_gun.py:302-310), one directory per epoch:
   `save_train` writes `epoch_N/train.pt` with the generator's (and the
   discriminator's) parameters, Adam state and step counter, and the
   GAN-lambda state; `restore_train` loads them into fresh train states.

The files are `torch.save` of state_dicts, ints and tensors, read back with
`torch.load(weights_only=True)`. They hold whole tensors whatever the
layout: under a mesh with a model axis `save_train` gathers the split vocab
head and its Adam moments over the model group (every rank calls it; the
leader writes), and a trainer re-splits what `restore_train` loads, so a
checkpoint restores in one process or under any model axis. The JAX package writes orbax checkpoints,
and orbax imports jax, so neither package reads the other's checkpoints: a
serving bundle (`bundle.py`) carries trained weights across.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from dlsg_tpu_torch.device import DeviceLike
from dlsg_tpu_torch.parallel.dist import is_leader
from dlsg_tpu_torch.parallel.mesh import whole_optimizer_state, whole_state_dict
from dlsg_tpu_torch.train.gan_lambda import LambdaState
from dlsg_tpu_torch.train.optim import TrainState

MODEL_FILE = "model.pt"
TRAIN_FILE = "train.pt"


def _save(path: str, payload: Dict[str, Any]) -> str:
    """Write `payload` to `path` through a temporary file, so a crash
    mid-write leaves no truncated checkpoint under the final name."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def save_model(ckpt_dir: str, name: str, state_dict: Mapping[str, torch.Tensor]) -> str:
    """Save generator parameters under a metric-named dir (best_Bleu_4,
    best_CIDEr); returns the file's path."""
    return _save(os.path.join(os.path.abspath(ckpt_dir), name, MODEL_FILE), dict(state_dict))


def restore_model(ckpt_dir: str, name: str, device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
    """The state_dict `save_model` wrote, on `device`."""
    path = os.path.join(os.path.abspath(ckpt_dir), name, MODEL_FILE)
    return torch.load(path, map_location=device, weights_only=True)


def save_train(
    ckpt_dir: str,
    epoch: int,
    gen_state: TrainState,
    disc_state: Optional[TrainState] = None,
    lambda_state: Optional[LambdaState] = None,
) -> str:
    """Full training checkpoint of `epoch` (run_gun.py:302-310). The step
    counters seed each step's draws (train/steps.py), so a resume from here
    reproduces the uninterrupted run's draws; `lambda_state` is the
    on-device GAN-lambda machine (the reference saves its cap_list).

    Inside a process group every rank calls it: split tensors are gathered
    whole (a collective over the model group) and only the leader writes.
    Returns the file's path."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"epoch_{epoch}", TRAIN_FILE)
    payload: Dict[str, Any] = {
        "epoch": int(epoch),
        "gen_params": whole_state_dict(gen_state.module),
        "gen_opt": whole_optimizer_state(gen_state),
        "gen_step": int(gen_state.step),
    }
    if disc_state is not None:
        payload["disc_params"] = whole_state_dict(disc_state.module)
        payload["disc_opt"] = whole_optimizer_state(disc_state)
        payload["disc_step"] = int(disc_state.step)
    if lambda_state is not None:
        payload["gan_lambda_state"] = dict(lambda_state)
    return _save(path, payload) if is_leader() else path


def _restore_state(state: TrainState, payload: Dict[str, Any], prefix: str) -> TrainState:
    # Adam's state_dict keys its moments by position in the parameter list,
    # which TrainState.create takes in the module's registration order
    state.module.load_state_dict(payload[f"{prefix}_params"])
    state.optimizer.load_state_dict(payload[f"{prefix}_opt"])
    if state.capturable and state.params[0].device.type == "cpu":
        state.set_capturable(False)  # a card's graphed Adam state, resumed on the CPU
    state.step = int(payload[f"{prefix}_step"])
    return state


def restore_train(
    ckpt_dir: str,
    epoch: int,
    gen_state: TrainState,
    disc_state: Optional[TrainState] = None,
    lambda_state: Optional[LambdaState] = None,
) -> Dict[str, Any]:
    """Load an `epoch_N` checkpoint into fresh, whole train states (in
    place, on their modules' device; a trainer splits them after).
    Returns {'epoch', 'gen_state', 'disc_state',
    'gan_lambda_state'}; the lambda state is None unless the checkpoint has
    one and `lambda_state` (its template: device and dtypes) is given."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"epoch_{epoch}", TRAIN_FILE)
    device = gen_state.params[0].device
    payload = torch.load(path, map_location=device, weights_only=True)
    out = {
        "epoch": int(payload["epoch"]),
        "gen_state": _restore_state(gen_state, payload, "gen"),
        "disc_state": None,
        "gan_lambda_state": None,
    }
    if disc_state is not None:
        out["disc_state"] = _restore_state(disc_state, payload, "disc")
    saved = payload.get("gan_lambda_state")
    if saved is not None and lambda_state is not None:
        out["gan_lambda_state"] = {
            k: saved[k].to(tpl.device, tpl.dtype) for k, tpl in lambda_state.items()
        }
    return out


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """Highest epoch_N subdir, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [
        int(d.split("_", 1)[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("epoch_") and d.split("_", 1)[1].isdigit()
    ]
    return max(epochs) if epochs else None
