"""Generator models (counterpart of `dlsg_tpu/models/generator.py`;
reference models/model.py).

- `CapGnnModel`: the D-LSG generator, CapGnnEncoder -> multi-modal Decoder
  (model.py:25-53), returns (outputs, obj_psl, motion_psl, alpha);
- `CapModel`: the frames-only legacy generator, EncoderVisual -> single-modal
  Decoder (model.py:10-22), returns the outputs alone;
- `CapBaselineModel`: the graph-encoder ablation, decoding the motion
  branch's aggregated frames (model.py:76-91), returns (outputs, 0, 0, 0);
- `CapBaseline1`: the Bi-LSTM-only baseline of `train.trainer.Run`,
  EncoderVisual with `out_try` (model.py:94-107), returns (outputs, 0, 0, 0).

Each takes the JAX module's call signature. `encode` gives the decoder's
inputs (feats, feats2): both branches' proposals for CapGnnModel, (feats,
None) for the single-modal three, so the beam and greedy decodes
(evaluation/decode.py) drive any of them. A single-modal decoder attends
over the encoder's T frames: its attention is [B, T_words, T_frames].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.device import DeviceLike, resolve_device
from dlsg_tpu_torch.models.decoder import Decoder
from dlsg_tpu_torch.models.encoders import CapGnnEncoder, EncoderVisual
from dlsg_tpu_torch.ops.linear import init_parameters


class _Generator(nn.Module):
    """The encoder and decoder of a generator, and the decoder passthroughs
    that the decodes (evaluation/decode.py) call.

    Weights are drawn from `generator` (default: seeded with `cfg.seed`) with
    the JAX modules' initializers, and the model is moved to `device`
    (default `cuda`; pass ``device="cpu"`` to run on the CPU). It starts in
    eval mode; the train steps switch it to training mode for a step."""

    multi_modal = False

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
        self.encoder = self._encoder(cfg)
        self.decoder = Decoder(cfg, vocab_size, multi_modal=self.multi_modal)
        init_parameters(self, generator or torch.Generator().manual_seed(cfg.seed))
        self.eval()
        self.to(device)

    def _encoder(self, cfg: DLSGConfig) -> nn.Module:
        raise NotImplementedError

    def _rng(self, caption, rng):
        """The forward's dropout generator: none for greedy decoding; a
        training-mode teacher-forced forward must be given one."""
        if caption is None:
            return None
        if self.training and rng is None:
            raise ValueError("a training-mode forward needs rng, a torch.Generator on the model's device")
        return rng

    def greedy_decode(self, visual_feats, region_feats=None):
        """Greedy decode: (token ids [B, T], the decoder's attention)."""
        feats, feats2 = self.encode(visual_feats, region_feats)
        return self.decoder(feats, None, 1.0, feats2)

    def decoder_beam_step(self, word_id, state, pre):
        return self.decoder.beam_step(word_id, state, pre)

    def decoder_beam_step_hidden(self, word_id, state, pre):
        return self.decoder.beam_step_hidden(word_id, state, pre)

    def decoder_vocab_head(self):
        return self.decoder.vocab_head_weights()

    def decoder_vocab_shard(self):
        return self.decoder.vocab_head_shard()

    def decoder_init_beam_state(self, feats, feats2):
        return self.decoder.init_beam_state(feats, feats2)


class CapGnnModel(_Generator):
    """Latent-semantic-graph captioning generator (models/model.py:25-53)."""

    multi_modal = True

    def _encoder(self, cfg):
        return CapGnnEncoder(cfg)

    def forward(
        self,
        visual_feats,
        region_feats,
        caption: Optional[torch.Tensor] = None,
        teacher_forcing_ratio: float = 1.0,
        rng: Optional[torch.Generator] = None,
    ):
        """(outputs, obj_psl, motion_psl, alpha [B, T, 2P]).

        With `caption` [B, T]: the teacher-forced training forward, outputs
        are logits [B, T, V]; in training mode it needs `rng`, a generator on
        the model's device, for dropout and the scheduled-sampling coins.
        Without: greedy decode, outputs are token ids [B, T] and nothing is
        dropped."""
        rng = self._rng(caption, rng)
        obj_psl, motion_psl = self.encoder(visual_feats, region_feats, rng)
        outputs, alpha_all = self.decoder(
            obj_psl, caption, teacher_forcing_ratio, motion_psl, rng
        )
        return outputs, obj_psl, motion_psl, alpha_all

    def encode(self, visual_feats, region_feats):
        """Encoder only: (obj proposals, motion proposals) [B, P, H]."""
        return self.encoder(visual_feats, region_feats)


class CapModel(_Generator):
    """Frames-only encoder + single-modal decoder (models/model.py:10-22)."""

    def _encoder(self, cfg):
        return EncoderVisual(cfg, cfg.feature_size)

    def forward(
        self,
        visual_feats,
        caption: Optional[torch.Tensor] = None,
        teacher_forcing_ratio: float = 1.0,
        rng: Optional[torch.Generator] = None,
    ):
        """Logits [B, T, V] with `caption`, else greedy token ids [B, T]
        (CapGnnModel.forward's rules for `rng`)."""
        rng = self._rng(caption, rng)
        enc = self.encoder(visual_feats, rng)
        outputs, _ = self.decoder(enc, caption, teacher_forcing_ratio, None, rng)
        return outputs

    def encode(self, visual_feats, region_feats=None):
        """(frames [B, T, H], None); the region features are ignored, so the
        decodes call every generator alike."""
        return self.encoder(visual_feats), None


class CapBaselineModel(_Generator):
    """Graph-encoder ablation: decodes the motion branch's aggregated frames
    (models/model.py:76-91). The object branch runs and holds its
    parameters, as in JAX, but nothing reads its output: its parameters get
    zero gradients."""

    def _encoder(self, cfg):
        return CapGnnEncoder(cfg, baseline=True)

    def forward(
        self,
        visual_feats,
        region_feats,
        caption: Optional[torch.Tensor] = None,
        teacher_forcing_ratio: float = 1.0,
        rng: Optional[torch.Generator] = None,
    ):
        """(outputs, 0, 0, 0), outputs as CapModel.forward's."""
        rng = self._rng(caption, rng)
        _, motion = self.encoder(visual_feats, region_feats, rng)
        outputs, _ = self.decoder(motion, caption, teacher_forcing_ratio, None, rng)
        return outputs, 0, 0, 0

    def encode(self, visual_feats, region_feats):
        _, motion = self.encoder(visual_feats, region_feats)
        return motion, None


class CapBaseline1(_Generator):
    """Bi-LSTM-only baseline used by run_graph.Run (models/model.py:94-107)."""

    def _encoder(self, cfg):
        return EncoderVisual(cfg, cfg.feature_size, baseline=True)

    def forward(
        self,
        visual_feats,
        region_feats,
        caption: Optional[torch.Tensor] = None,
        teacher_forcing_ratio: float = 1.0,
        rng: Optional[torch.Generator] = None,
    ):
        """(outputs, 0, 0, 0), outputs as CapModel.forward's; the region
        features are ignored."""
        rng = self._rng(caption, rng)
        enc = self.encoder(visual_feats, rng)
        outputs, _ = self.decoder(enc, caption, teacher_forcing_ratio, None, rng)
        return outputs, 0, 0, 0

    def encode(self, visual_feats, region_feats=None):
        return self.encoder(visual_feats), None
