"""Configuration: the port's own copy of `dlsg_tpu.config.DLSGConfig`.

Field names and defaults are identical to the JAX package's, so the config
JSON inside a serving bundle loads into either package, and so are the
derived data paths, `checkpoint_dir`, `base_name()` and the CLI flags of
`parse_opt`. The two dtype properties return torch dtypes instead of jnp
ones. Fields that select JAX-only machinery (remat, the training RNG) are
kept so a bundle round-trips, and are ignored by this package.
`mesh_data_axis`/`mesh_model_axis` lay the ranks of a process group out as
a (data, model) mesh (parallel/mesh.py), as they lay out devices in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class DLSGConfig:
    """All hyper-parameters of the D-LSG system (reference `utils/opt.py`)."""

    # ---- General settings ----
    dataset: str = "msvd"  # 'msvd' | 'msr-vtt'
    epoch_num: int = 60
    save_per_epoch: int = 8
    train_batch_size: int = 128
    test_batch_size: int = 128
    beam_size: int = 5
    use_glove: bool = False

    # ---- Network settings ----
    model: str = "RMN"
    dropout: float = 0.3
    use_graph: bool = True
    use_psl_loss: bool = False
    use_visual_gan: bool = True
    use_lang_gan: bool = False
    num_D_switch: int = 3
    num_D_lang: int = 5
    lambda_D_lang: float = 0.006
    num_D_visual: int = 5
    lambda_D_visual: float = 0.01

    frame_hidden_size: int = 1000
    motion_hidden_size: int = 1000
    visual_hidden_size: int = 1024
    region_projected_size: int = 1024
    spatial_projected_size: int = 300
    num_proposals: int = 8
    num_obj: int = 16
    num_topk: int = 3

    word_size: int = 300
    gan_word_size: int = 512
    hidden_size: int = 1300
    att_size: int = 1024
    time_size: int = 300
    query_hidden_size: int = 1024
    decode_hidden_size: int = 1536
    ss_factor: int = 20

    # ---- Optimization settings ----
    learning_rate: float = 0.00016
    grad_clip: float = 10.0

    # ---- Feature extraction constants ----
    max_frames: int = 26
    max_words: int = 26
    num_boxes: int = 36
    a_feature_size: int = 1536
    m_feature_size: int = 1024
    region_feature_size: int = 2048
    spatial_feature_size: int = 5

    # ---- Dataset ranges ----
    msrvtt_train_range: Tuple[int, int] = (0, 6513)
    msrvtt_val_range: Tuple[int, int] = (6513, 7010)
    msrvtt_test_range: Tuple[int, int] = (7010, 10000)
    msvd_train_range: Tuple[int, int] = (0, 1200)
    msvd_val_range: Tuple[int, int] = (1200, 1300)
    msvd_test_range: Tuple[int, int] = (1300, 1970)

    # ---- Paths (relative to data_dir) ----
    data_dir: str = "./data"
    result_dir: str = "./results/dlsg"

    # ---- GloVe embedding import ----
    glove_txt_path: str = ""
    freeze_word_embed: bool = False

    # ---- Accelerator settings ----
    # compute dtype for matmuls/activations; params stay fp32
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # dtype the float feature batches are staged to the device in
    input_stage_dtype: str = "float32"  # 'float32' | 'bfloat16'
    loader_workers: int = 0
    # route the encoder Bi-LSTM's recurrence to the lstm_scan kernel
    use_pallas_lstm: bool = False
    # project the region tensor once for both graph branches
    joint_region_projection: bool = False
    # route each beam step's vocab projection + top-k + logsumexp to the
    # vocab_head kernel: 'on' | 'off' | 'auto' ('auto' resolves to off)
    use_fused_vocab_head: str = "auto"
    plot_attention: bool = True
    seed: int = 12
    rng_impl: str = "rbg"
    profile_dir: str = ""
    # beam bookkeeping: single-pass clipped sumexp (exact for logits in (-88, 80))
    decode_fast_lse: bool = True
    # beam top-k recall target; this package always takes the exact top-k
    decode_approx_topk: float = 1.0
    decode_quant: str = "none"  # 'none' | 'int8' (inference only; ops/quant.py)
    gan_single_forward: bool = True
    # JAX computes the penalty's parameter gradient by reverse-over-forward
    # when true; this package has one implementation (a double backward)
    # for both values, which give the same gradient
    gan_gp_custom_vjp: bool = True
    disc_scan_unroll: int = 1
    disc_remat: str = "none"
    decoder_remat: str = "none"
    decode_two_pass_t1: int = 0
    decode_two_pass_bucket: int = 0
    # the (data, model) mesh over the ranks of a process group
    # (parallel/mesh.py): -1 data takes the rest; model > 1 splits the vocab
    # head over that many ranks and needs a process group
    mesh_data_axis: int = -1
    mesh_model_axis: int = 1
    log_every: int = 10

    # ---- HDF5 dataset keys ----
    feature_h5_feats: str = "feats"
    feature_h5_lens: str = "lens"
    region_visual_feats: str = "vfeats"
    region_spatial_feats: str = "sfeats"

    # ------------------------------------------------------------------
    @property
    def feature_size(self) -> int:
        """Full per-frame feature dim: appearance + motion (2560 by default)."""
        return self.a_feature_size + self.m_feature_size

    @property
    def cdtype(self) -> torch.dtype:
        """Compute dtype for matmuls/activations (params stay fp32)."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def stage_dtype(self) -> Optional[torch.dtype]:
        """dtype float feature batches are cast to on the host before the copy
        to the device (None = keep fp32; see input_stage_dtype)."""
        if self.input_stage_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                "input_stage_dtype must be 'float32' or 'bfloat16', got "
                f"{self.input_stage_dtype!r}"
            )
        return torch.bfloat16 if self.input_stage_dtype == "bfloat16" else None

    @property
    def train_range(self) -> Tuple[int, int]:
        return self.msvd_train_range if self.dataset == "msvd" else self.msrvtt_train_range

    @property
    def val_range(self) -> Tuple[int, int]:
        return self.msvd_val_range if self.dataset == "msvd" else self.msrvtt_val_range

    @property
    def test_range(self) -> Tuple[int, int]:
        return self.msvd_test_range if self.dataset == "msvd" else self.msrvtt_test_range

    @property
    def feat_dir(self) -> str:
        sub = {"msvd": "MSVD", "msr-vtt": "MSR-VTT"}
        if self.dataset not in sub:
            raise ValueError("choose one dataset from msvd|msr-vtt")
        return os.path.join(self.data_dir, sub[self.dataset])

    # Derived data-file paths (opt.py:116-134)
    @property
    def vocab_pkl_path(self) -> str:
        return os.path.join(self.feat_dir, f"{self.dataset}_vocab.pkl")

    @property
    def train_caption_pkl_path(self) -> str:
        return os.path.join(self.feat_dir, f"{self.dataset}_captions_train.pkl")

    @property
    def val_caption_pkl_path(self) -> str:
        return os.path.join(self.feat_dir, f"{self.dataset}_captions_val.pkl")

    @property
    def test_caption_pkl_path(self) -> str:
        return os.path.join(self.feat_dir, f"{self.dataset}_captions_test.pkl")

    @property
    def feature_h5_path(self) -> str:
        return os.path.join(self.feat_dir, f"{self.dataset}_features.h5")

    @property
    def region_feature_h5_path(self) -> str:
        name = {"msvd": "msvd_region_feature.h5", "msr-vtt": "msrvtt_region_feature.h5"}
        return os.path.join(self.feat_dir, name[self.dataset])

    @property
    def glove_path(self) -> str:
        """Resolved GloVe text path (layer.py:356-360 fallback chain)."""
        return self.glove_txt_path or os.path.join(self.data_dir, "glove.42B.300d.txt")

    @property
    def glove_cache_npy_path(self) -> str:
        """Per-dataset .npy cache (layer.py:353)."""
        return os.path.join(self.data_dir, f"{self.dataset}_glove.npy")

    @property
    def val_reference_txt_path(self) -> str:
        return os.path.join(self.feat_dir, f"{self.dataset}_val_references.txt")

    @property
    def test_reference_txt_path(self) -> str:
        return os.path.join(self.feat_dir, f"{self.dataset}_test_references.txt")

    @property
    def test_prediction_txt_path(self) -> str:
        return os.path.join(self.result_dir, f"{self.dataset}_test_predictions.txt")

    @property
    def checkpoint_dir(self) -> str:
        return os.path.join(self.result_dir, "checkpoints")

    def base_name(self) -> str:
        """Experiment name, mirroring `run_gun.py:413-431`."""
        name = f"{self.dataset}_{self.ss_factor}_GNN_{self.num_obj}_{self.num_proposals}"
        if self.use_psl_loss:
            name += "_use_psl_loss"
        if self.use_visual_gan:
            name += f"_visual_{self.lambda_D_visual}_{self.num_D_visual}"
        return name


def apply_dataset_overrides(cfg: DLSGConfig) -> DLSGConfig:
    """Per-dataset overrides of the reference trainers (`run_gun.py:31-40`):
    msvd -> decode_hidden 1024 / 8 proposals / 16 objects / top-3;
    anything else -> 1536 / 5 / 36 / 5."""
    if cfg.dataset == "msvd":
        return replace(cfg, decode_hidden_size=1024, num_proposals=8, num_obj=16, num_topk=3)
    return replace(cfg, decode_hidden_size=1536, num_proposals=5, num_obj=36, num_topk=5)


def tiny_test_config(**overrides) -> DLSGConfig:
    """A small config for unit tests and dry-runs (same structure, tiny dims)."""
    base = dict(
        dataset="msvd",
        train_batch_size=4,
        test_batch_size=4,
        beam_size=3,
        visual_hidden_size=32,
        region_projected_size=32,
        query_hidden_size=32,
        decode_hidden_size=32,
        word_size=16,
        gan_word_size=16,
        num_proposals=6,
        num_obj=8,
        num_topk=3,
        max_frames=7,
        max_words=9,
        a_feature_size=24,
        m_feature_size=12,
        region_feature_size=20,
        epoch_num=2,
    )
    base.update(overrides)
    return DLSGConfig(**base)


def _add_args(parser: argparse.ArgumentParser) -> None:
    """Register every scalar config field as a CLI flag with the dataclass
    default; the id ranges take two ints (`--msvd_test_range 1300 1970`)."""
    for f in dataclasses.fields(DLSGConfig):
        if f.type in ("str", "int", "float"):
            parser.add_argument(f"--{f.name}", type={"str": str, "int": int, "float": float}[f.type],
                                default=f.default)
        elif f.type == "bool":
            parser.add_argument(
                f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"), default=f.default
            )
        elif f.type.startswith("Tuple[int"):
            parser.add_argument(f"--{f.name}", type=int, nargs=2, default=f.default)


def parse_opt(argv: Optional[list] = None, apply_overrides: bool = True) -> DLSGConfig:
    """CLI entry mirroring `utils/opt.py:parse_opt` (same flag names / defaults)."""
    parser = argparse.ArgumentParser(description="D-LSG video captioning (PyTorch)")
    _add_args(parser)
    ns = parser.parse_args(argv)
    cfg = DLSGConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in vars(ns).items()})
    if apply_overrides:
        cfg = apply_dataset_overrides(cfg)
    return cfg
