"""Alternative graph modules of the reference's model zoo (counterpart of
`dlsg_tpu/models/graph_variants.py`), with the JAX package's names, module
names and arguments:

- `LatentGNN`            — conv-adjacency latent pooling (sublayer.py:147-173)
- `GNN`                  — dense QK region GNN (sublayer.py:121-144)
- `GraphAttentionLayer`  — GAT with pairwise concat scoring (sublayer.py:200-289)
- `EncoderVisualGraph`   — conv-adjacency encoder variant (layer.py:64-136)
- `EncoderVisualGAT`     — GAT-based encoder variant (layer.py:204-272)

No generator, trainer or CLI uses them, and `models/__init__.py` does not
export them, as in the JAX package. Everything is fp32.

Modes follow torch: in training mode the `BatchNorm`s normalize with the
batch's statistics and update their running ones (flax
`use_running_average=False`, the JAX modules' `train=True`), and dropout
acts when the forward is given a generator `rng` (JAX's
`deterministic=False`); in eval mode both use the running statistics and no
dropout. A batch's statistics are this process's batch: no rank reduces
them with another.

`BatchNorm` is flax's (0.12), not torch's `nn.BatchNorm1d`: it reduces over
every axis but the last in fp32, takes the biased variance as E[x^2] -
E[x]^2 clamped at 0, normalizes as (x - mean) * (rsqrt(var + 1e-5) *
scale) + bias, and updates running = 0.99 * running + 0.01 * batch for the
mean and the biased variance alike. Its running statistics are the buffers
`running_mean`/`running_var`, which `weights.py` maps to flax's
`batch_stats` `mean`/`var`.

Weights are drawn from `generator` (default: seeded with `cfg.seed`, or 0
for the modules without a config) and the module is moved to `device`
(default `cuda`). A Dense has flax's default init (lecun normal, zero
bias); the GAT's `Ws`, `We` and `a` are uniform +-sqrt(2) *
sqrt(6 / (fan_in + fan_out)) in flax's [in, out] layout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.device import DeviceLike, resolve_device
from dlsg_tpu_torch.models.layers import SelfAttention, xavier_uniform_gain_
from dlsg_tpu_torch.ops.linear import Dense, Dropout, LayerNorm, init_parameters

BN_MOMENTUM = 0.99
BN_EPS = 1e-5
RELU_GAIN = math.sqrt(2.0)


def _l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(1e-12)


def _place(module: nn.Module, generator: Optional[torch.Generator], seed: int,
           device: DeviceLike) -> None:
    """Draw `module`'s weights, put it in eval mode and on its device."""
    device = resolve_device(device)
    init_parameters(module, generator or torch.Generator().manual_seed(seed))
    module.eval()
    module.to(device)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the last axis (module doc)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = ((x * x).mean(dim=axes) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.copy_(
                    BN_MOMENTUM * self.running_mean + (1.0 - BN_MOMENTUM) * mean)
                self.running_var.copy_(
                    BN_MOMENTUM * self.running_var + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias


class LatentGNN(nn.Module):
    """Conv-adjacency latent pooling (sublayer.py:147-173): [B, T, C] ->
    [B, num_latent, C]."""

    def __init__(self, input_size: int, num_latent: int, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        self.v2l_adj = Dense(input_size, num_latent, bias=False)
        self.bn = BatchNorm(num_latent)
        _place(self, generator, 0, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # Conv2d(C -> L, k=1) + BN + ReLU over the feature axis
        adj = F.relu(self.bn(self.v2l_adj(x))).transpose(1, 2)  # [B, L, T]
        if mask is not None:
            adj = torch.where(mask > 0, adj, torch.zeros((), device=adj.device))
        adj = _l2_normalize(adj, dim=2)
        return torch.matmul(adj, x)


class GNN(nn.Module):
    """Dense QK GNN over flattened region features (sublayer.py:121-144):
    [B, T, O, F] -> [B, T, O, out_size]."""

    def __init__(self, feature_size: int = 2048, out_size: int = 1024, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        self.out_size = out_size
        self.adj_Q = Dense(feature_size, feature_size)
        self.adj_K = Dense(feature_size, feature_size)
        self.graph_update = Dense(feature_size, out_size)
        _place(self, generator, 0, device)

    def forward(self, region_feats: torch.Tensor) -> torch.Tensor:
        B, T, O, Fs = region_feats.shape
        feats = region_feats.reshape(B, T * O, Fs)
        q, k = self.adj_Q(feats), self.adj_K(feats)
        adj = torch.softmax(torch.matmul(q, k.transpose(1, 2)), dim=-1)
        out = torch.matmul(adj, self.graph_update(feats))
        return out.reshape(B, T, O, self.out_size)


class GraphAttentionLayer(nn.Module):
    """GAT layer with pairwise concat scoring (sublayer.py:200-289): the
    start nodes [B, N1, in] are aggregated onto the end nodes [B, N2, in]."""

    def __init__(self, in_features: int, out_features: int, dropout: float,
                 alpha: float = 0.2, concat: bool = True, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        self.out_features = out_features
        self.alpha = alpha
        self.concat = concat
        self.Ws = nn.Parameter(torch.empty(in_features, out_features))
        self.We = nn.Parameter(torch.empty(in_features, out_features))
        self.a = nn.Parameter(torch.empty(2 * out_features, 1))
        self.drop = Dropout(dropout)
        _place(self, generator, 0, device)

    def reset_parameters(self, generator=None) -> None:
        for p in (self.Ws, self.We, self.a):
            xavier_uniform_gain_(p.data, RELU_GAIN, generator)

    def forward(self, start_feature: torch.Tensor, end_feature: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        hs = torch.matmul(start_feature, self.Ws)  # [B, N1, F]
        he = torch.matmul(end_feature, self.We)  # [B, N2, F]
        # e_ij = leakyrelu([hs_i || he_j] a) as two rank-1 contractions
        s1 = torch.matmul(hs, self.a[: self.out_features, 0])  # [B, N1]
        s2 = torch.matmul(he, self.a[self.out_features :, 0])  # [B, N2]
        att = F.leaky_relu(s1[:, :, None] + s2[:, None, :], self.alpha)  # [B, N1, N2]
        att = self.drop(torch.softmax(att, dim=1), rng)
        h_prime = torch.matmul(att.transpose(1, 2), hs) + he  # starts onto ends
        return F.elu(h_prime) if self.concat else h_prime


class _EncoderVisualLatent(nn.Module):
    """What both encoder variants share: the visual embedding, the object
    projection and, after each variant's object -> frame aggregation, the
    latent pooling (v2l_adj + BatchNorm + ReLU, L2-normalized over time),
    LayerNorm, self-attention and LayerNorm."""

    def __init__(self, cfg: DLSGConfig, input_type: str, use_embed: bool, baseline: bool,
                 visual_size: Optional[int]):
        super().__init__()
        self.cfg = cfg
        self.input_type = input_type
        self.baseline = baseline
        vh = cfg.visual_hidden_size
        # flax infers the input width; `visual_size` is the frames' width
        self.visual_embed = Dense(visual_size or cfg.feature_size, vh) if use_embed else None
        # JAX builds the object branch only for inputs of 5 objects or more
        self.has_objects = cfg.num_obj >= 5
        if self.has_objects:
            self.obj_embed = Dense(cfg.region_feature_size, cfg.region_projected_size)
        if not baseline:
            self.v2l_adj = Dense(vh, cfg.num_proposals, bias=False)
            self.v2l_bn = BatchNorm(cfg.num_proposals)
            self.att_l2l_norm = LayerNorm(vh)
            self.att_l2l = SelfAttention(vh, vh, vh, dropout=cfg.dropout)
            self.att_l2l_norm2 = LayerNorm(vh)

    def aggregate(self, obj, visual_embed, obj_size: int, rng):
        raise NotImplementedError

    def forward(self, visual_feats: torch.Tensor, obj_feats: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, O, obj_size = obj_feats.shape
        visual_embed = visual_feats
        if self.visual_embed is not None:
            visual_embed = self.visual_embed(visual_feats)
        if O < 5:
            obj_visual = visual_embed
        else:
            if not self.has_objects:
                raise ValueError(f"built for cfg.num_obj = {self.cfg.num_obj} < 5 objects "
                                 f"(no object branch), given {O}")
            obj = self.obj_embed(obj_feats).reshape(B, T * O, -1)
            obj_visual = self.aggregate(obj, visual_embed, obj_size, rng)
        if self.baseline:
            return obj_visual
        adj = F.relu(self.v2l_bn(self.v2l_adj(obj_visual))).transpose(1, 2)  # [B, P, T]
        adj = _l2_normalize(adj, dim=2)
        latent = self.att_l2l_norm(torch.matmul(adj, obj_visual))
        return self.att_l2l_norm2(self.att_l2l(latent, rng=rng))


class EncoderVisualGraph(_EncoderVisualLatent):
    """Earlier conv-adjacency encoder variant (layer.py:64-136): frames
    [B, T, visual_size] and regions [B, T, O, region_feature_size] ->
    [B, num_proposals, visual_hidden_size] ([B, T, H] with `baseline`).
    The adjacency is scaled by sqrt of the RAW region width and softmaxed
    over the T*O objects. With fewer than 5 objects the object branch is
    skipped; built for `cfg.num_obj` < 5 the module has none, as JAX's
    parameter tree then has none."""

    def __init__(self, cfg: DLSGConfig, input_type: str = "motion", use_embed: bool = True,
                 baseline: bool = False, *, visual_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__(cfg, input_type, use_embed, baseline, visual_size)
        _place(self, generator, cfg.seed, device)

    def aggregate(self, obj, visual_embed, obj_size: int, rng):
        adj = torch.matmul(obj, visual_embed.transpose(1, 2)) / math.sqrt(obj_size)  # [B, N, T]
        adj = torch.softmax(adj, dim=1)
        return torch.matmul(adj.transpose(1, 2), obj) + visual_embed


class EncoderVisualGAT(_EncoderVisualLatent):
    """GAT-based encoder variant (layer.py:204-272): the objects are
    aggregated onto the frames by a `GraphAttentionLayer` (`agg_o2v`); the
    rest as `EncoderVisualGraph`."""

    def __init__(self, cfg: DLSGConfig, input_type: str = "motion", use_embed: bool = True,
                 baseline: bool = False, *, visual_size: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__(cfg, input_type, use_embed, baseline, visual_size)
        if self.has_objects:
            vh = cfg.visual_hidden_size
            # built on the host: its weights are drawn again below, with
            # the encoder's, and moved with them
            self.agg_o2v = GraphAttentionLayer(vh, vh, cfg.dropout, device="cpu")
        _place(self, generator, cfg.seed, device)

    def aggregate(self, obj, visual_embed, obj_size: int, rng):
        return self.agg_o2v(obj, visual_embed, rng)
