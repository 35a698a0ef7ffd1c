"""Visual encoders (counterpart of `dlsg_tpu/models/encoders.py`).

- `EncoderVisual`: Linear embed -> Bi-LSTM -> LN -> self-attention -> LN
  (reference models/layer.py:7-61)
- `EncoderVisualGraphTUN`: object -> frame graph aggregation + latent
  proposal pooling (reference models/layer.py:139-201)
- `CapGnnEncoder`: the two-branch object/motion encoder of CapGnnModel
  (reference models/model.py:56-73)
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.models.layers import LatentPSL, SelfAttention, TanhLayerNorm
from dlsg_tpu_torch.ops.linear import Dense, LayerNorm, matmul_f32
from dlsg_tpu_torch.ops.lstm import BiLSTM


class EncoderVisual(nn.Module):
    """Linear embed -> Bi-LSTM -> LN -> self-attention (+LN): [B, T, F] ->
    [B, T, H]. `use_pallas_lstm` routes the Bi-LSTM to the lstm_scan kernel."""

    def __init__(self, cfg: DLSGConfig, in_features: int):
        super().__init__()
        H = cfg.visual_hidden_size
        cd = cfg.cdtype
        self.linear_embed = Dense(in_features, H, dtype=cd, kernel_init="xavier_normal")
        self.lstm = BiLSTM(H, H, dtype=cd, use_pallas=cfg.use_pallas_lstm)
        self.layernorm_lstm = LayerNorm(2 * H)
        self.self_attention = SelfAttention(2 * H, 2 * H, H, get_pe=True, dtype=cd)
        self.layernorm_sa = LayerNorm(H)

    def forward(self, inputs):
        x = self.lstm(self.linear_embed(inputs))  # [B, T, 2H] fp32
        x = self.layernorm_lstm(x)
        return self.layernorm_sa(self.self_attention(x))


class EncoderVisualGraphTUN(nn.Module):
    """Object -> frame graph aggregation, then LatentPSL pooling of the T
    frames into num_proposals latent nodes.

    The adjacency softmax runs over the flattened T*O object axis and is
    scaled by sqrt of the RAW region feature size (reference layer.py:187).
    With fewer than 5 objects the object branch is skipped."""

    def __init__(self, cfg: DLSGConfig, visual_features: Optional[int], own_obj_embed: bool = True):
        """`visual_features` is the input width of `visual_embed`; None means
        no embedding (the motion branch). `own_obj_embed=False` when the
        encoder projects the regions jointly for both branches."""
        super().__init__()
        cd = cfg.cdtype
        self.cfg = cfg
        vh = cfg.visual_hidden_size
        self.visual_embed = Dense(visual_features, vh, dtype=cd) if visual_features else None
        self.visual_norm = TanhLayerNorm(vh, dtype=cd)
        self.obj_embed = (
            Dense(cfg.region_feature_size, cfg.region_projected_size, dtype=cd)
            if own_obj_embed else None
        )
        self.obj_norm = TanhLayerNorm(cfg.region_projected_size, dtype=cd)
        self.obj_visual_norm = TanhLayerNorm(vh, dtype=cd)
        self.v2l_layer = LatentPSL(vh, cfg.num_proposals)

    def forward(self, visual_feats, obj_feats, obj_embedded=None):
        cd = self.cfg.cdtype
        B, T, O, obj_size = obj_feats.shape
        visual_embed = visual_feats
        if self.visual_embed is not None:
            visual_embed = self.visual_embed(visual_feats)
        visual_embed = self.visual_norm(visual_embed)

        if O < 5:
            obj_visual = visual_embed
        else:
            obj = obj_embedded if obj_embedded is not None else self.obj_embed(obj_feats)
            obj = self.obj_norm(obj).reshape(B, T * O, -1).to(cd)
            adj = matmul_f32(visual_embed.to(cd), obj.transpose(1, 2)) / math.sqrt(obj_size)
            adj = torch.softmax(adj, dim=-1)  # over the T*O object axis
            obj_agg = matmul_f32(adj.to(cd), obj)
            obj_visual = self.obj_visual_norm(obj_agg + visual_embed)
        return self.v2l_layer(obj_visual)  # [B, num_psl, H]


class CapGnnEncoder(nn.Module):
    """Two branches: EncoderVisualGraphTUN('object') over the appearance
    features; EncoderVisual over the full features, then
    EncoderVisualGraphTUN('motion') without an embedding."""

    def __init__(self, cfg: DLSGConfig):
        super().__init__()
        self.cfg = cfg
        joint = cfg.joint_region_projection
        self.obj_embed_joint = (
            Dense(cfg.region_feature_size, 2 * cfg.region_projected_size, dtype=cfg.cdtype)
            if joint else None
        )
        self.obj_encoder = EncoderVisualGraphTUN(cfg, cfg.a_feature_size, own_obj_embed=not joint)
        self.motion_pre_encoder = EncoderVisual(cfg, cfg.feature_size)
        self.motion_encoder = EncoderVisualGraphTUN(cfg, None, own_obj_embed=not joint)

    def forward(self, visual_feats, region_feats) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        obj_e1 = obj_e2 = None
        if region_feats.shape[2] >= 5 and self.obj_embed_joint is not None:
            joint = self.obj_embed_joint(region_feats)
            obj_e1 = joint[..., : cfg.region_projected_size]
            obj_e2 = joint[..., cfg.region_projected_size :]
        obj_proposals = self.obj_encoder(
            visual_feats[:, :, : cfg.a_feature_size], region_feats, obj_e1
        )
        motion_input = self.motion_pre_encoder(visual_feats)
        motion_proposals = self.motion_encoder(motion_input, region_feats, obj_e2)
        return obj_proposals, motion_proposals
