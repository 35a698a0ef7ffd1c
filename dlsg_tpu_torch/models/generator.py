"""Generator models (counterpart of `dlsg_tpu/models/generator.py`).

`CapGnnModel` — the D-LSG generator: CapGnnEncoder -> multi-modal Decoder
(reference models/model.py:25-53). The frames-only `CapModel` and the
ablation baselines are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.device import DeviceLike, resolve_device
from dlsg_tpu_torch.models.decoder import Decoder
from dlsg_tpu_torch.models.encoders import CapGnnEncoder
from dlsg_tpu_torch.ops.linear import init_parameters


class _BeamDecodeMixin:
    """Decoder passthroughs that the beam decode (evaluation/decode.py) calls."""

    def decoder_beam_step(self, word_id, state, pre):
        return self.decoder.beam_step(word_id, state, pre)

    def decoder_beam_step_hidden(self, word_id, state, pre):
        return self.decoder.beam_step_hidden(word_id, state, pre)

    def decoder_vocab_head(self):
        return self.decoder.vocab_head_weights()

    def decoder_init_beam_state(self, feats, feats2):
        return self.decoder.init_beam_state(feats, feats2)


class CapGnnModel(nn.Module, _BeamDecodeMixin):
    """Latent-semantic-graph captioning generator.

    Weights are drawn from `generator` (default: seeded with `cfg.seed`) with
    the JAX modules' initializers, and the model is moved to `device`
    (default `cuda`; pass ``device="cpu"`` to run on the CPU)."""

    def __init__(
        self,
        cfg: DLSGConfig,
        vocab_size: int,
        *,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.encoder = CapGnnEncoder(cfg)
        self.decoder = Decoder(cfg, vocab_size, multi_modal=True)
        init_parameters(self, generator or torch.Generator().manual_seed(cfg.seed))
        self.eval()
        self.to(device)

    def forward(self, visual_feats, region_feats, caption: Optional[torch.Tensor] = None):
        """Greedy decode: (ids [B, T], obj_psl, motion_psl, alpha [B, T, 2P])."""
        obj_psl, motion_psl = self.encoder(visual_feats, region_feats)
        outputs, alpha_all = self.decoder(obj_psl, caption, motion_psl)
        return outputs, obj_psl, motion_psl, alpha_all

    def encode(self, visual_feats, region_feats):
        """Encoder only: (obj proposals, motion proposals) [B, P, H]."""
        return self.encoder(visual_feats, region_feats)
