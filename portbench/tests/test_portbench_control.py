"""The control on the card: the reference one precision below the
configuration's (TF32 products) put in the program's place fails the
cell's comparison, and so does the program with the discriminator's
gradient penalty left out. Each cell at its own size (the caption cell's
512 clips: over fewer, TF32 flips too few near ties to fail every seed).

Run on a card: python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests -q
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from portbench import control, harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32 on the tensor cores")
    return torch.device("cuda", 0)


def _run(cell_name: str, seed: int, **traffic):
    spec = harness.benchmark()
    cell = harness.cell_of(spec, cell_name)
    r = harness.Run(SimpleNamespace(seed=seed, seconds=0, trace=0), spec, cell, time.perf_counter())
    r.traffic = {**r.traffic, **traffic}
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("cell,traffic", [
    ("msrvtt-caption-b128", {}),
    ("msrvtt-gan-b128", {}),
])
def test_tf32_control_fails(card, cell, traffic):
    r = _run(cell, 3000000101, **traffic)
    nums = control.control(r, "tf32")
    assert any(v["limit"] is not None and v["value"] > v["limit"] for v in nums.values()), nums


@pytest.mark.cuda
def test_fp32_reference_passes_against_itself(card):
    r = _run("msrvtt-gan-b128", 3000000103, batch=16)
    nums = control.control(r, "fp32")
    assert all(v["value"] <= v["limit"] for v in nums.values() if v["limit"] is not None), nums


@pytest.mark.cuda
def test_penalty_left_out_fails(card):
    r = _run("msrvtt-gan-b128", 3000000107)
    nums = control.control(r, "no_penalty")
    assert nums["d_loss_gap"]["value"] > nums["d_loss_gap"]["limit"], nums
