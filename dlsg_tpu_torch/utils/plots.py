"""Attention heatmap dumps.

Parity with `RunGAN.plot_alpha_all` (run_gun.py:455-465): save a side-by-side
heatmap of the decoder's object/motion proposal attention for the first sample,
each row max-normalized (including the reference's quirk of normalizing the
motion panel by the *object* panel's row max, run_gun.py:460). A copy of
`dlsg_tpu/utils/plots.py`: without matplotlib it prints one message and
writes no PNG.
"""

from __future__ import annotations

import os

import numpy as np

_WARNED_NO_MPL = False


def plot_alpha_all(
    alpha_all: np.ndarray,
    num_psl: int,
    title: str,
    out_dir: str,
    epoch: int,
    step: int,
    vid: int,
) -> str:
    """alpha_all: [B, T, 2*num_psl] decoder attention.

    Writes a PNG and returns its path; returns "" (with a one-time warning)
    when matplotlib is unavailable, so a plot-less install can still train.
    """
    try:
        import matplotlib
    except ImportError:
        global _WARNED_NO_MPL
        if not _WARNED_NO_MPL:
            _WARNED_NO_MPL = True
            print("plots: matplotlib not installed — skipping attention heatmaps")
        return ""

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    alpha = np.asarray(alpha_all)[0]
    alpha_obj = alpha[:, :num_psl]
    alpha_mt = alpha[:, -num_psl:]
    obj_rowmax = alpha_obj.max(axis=1, keepdims=True)
    obj_rowmax[obj_rowmax == 0] = 1.0
    alpha_obj = alpha_obj / obj_rowmax
    alpha_mt = alpha_mt / obj_rowmax  # reference normalizes by the obj max (:460)

    fig, ax = plt.subplots(1, 2)
    for a, data in zip(ax, (alpha_obj, alpha_mt)):
        a.imshow(data, aspect="auto", cmap="viridis")
        a.set_xticks([])
        a.set_yticks([])
    plt.title(title)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{vid}_{epoch}_{step}.png")
    plt.savefig(path)
    plt.close(fig)
    return path
