"""Reference-checkpoint import: the reference's torch state_dict -> this
package's state_dict (counterpart of `dlsg_tpu/convert.py`).

The reference saves `{'model_state_dict': CapGnnModel.state_dict(),
'model_d_state_dict': DiscV2.state_dict(), 'cap_list': ...}` per epoch
(run_gun.py:302-310). Its modules are laid out differently from this
package's, so the import goes in two steps: this package's own copy of the
JAX package's transliterator turns the reference's tensors into the JAX
parameter tree (the rules below), and `weights.params_from_jax` turns that
tree into this package's `state_dict`. A trained reference `.pt` then
serves and evaluates here (`cli evaluate|serve|export --torch_checkpoint`).

Layout rules (reference torch -> flax tree):
- nn.Linear weight [out, in]      -> Dense kernel [in, out] (transpose)
- nn.Embedding weight [V, D]      -> Embed embedding (copy)
- nn.LayerNorm weight/bias        -> LayerNorm scale/bias (copy)
- nn.LSTM / nn.LSTMCell           -> ops/lstm.py layout: weight_ih.T as the
  `ih` Dense kernel, bias_ih + bias_hh as its bias, weight_hh.T as `w_hh`.
  Gate order is (i, f, g, o) on both sides (ops/lstm.py:16-17), so no gate
  permutation is needed.
- The decoder's query LSTM input is [lang_h, global_feat, word] in the
  reference (layer.py:570-571) but is split here into a dynamic part
  [lang_h, word] and a precomputed static part [global_feat]
  (SplitInputLSTMCell): weight_ih's input rows are re-sliced accordingly.
- nn.Conv1d k=1 weight [out, in, 1] -> Dense kernel [in, out]
- nn.Conv1d k=3 weight [out, in, 3] -> nn.Conv kernel [3, in, out]

Known limitations (documented, checked where possible):
- Only the modules the live reference training path instantiates are mapped
  (CapGnnModel with multi_modal=True/baseline=False, DiscV2). Dead parameters
  the reference creates but never uses in forward (decoder.context_layernorm,
  TUN's att_l2l_norm, decoder.beam_search buffers) are skipped.
- Dropout/RNG state has no parameter equivalent; optimizer state is not
  converted (Adam moments are not transferable to optax one-to-one).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.weights import params_from_jax


def _np(t) -> np.ndarray:
    """torch.Tensor | ndarray -> float32/float ndarray on host."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _lin(sd: Mapping, key: str, bias: bool = True) -> Dict:
    out = {"kernel": _np(sd[f"{key}.weight"]).T}
    if bias:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _emb(sd: Mapping, key: str) -> Dict:
    return {"embedding": _np(sd[f"{key}.weight"])}


def _ln(sd: Mapping, key: str) -> Dict:
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _tanh_ln(sd: Mapping, key: str) -> Dict:
    """Sequential(Tanh, LayerNorm) -> TanhLayerNorm{ln} (index 1 holds the LN)."""
    return {"ln": _ln(sd, key)}


def _lstm_cell(sd: Mapping, key: str) -> Dict:
    """nn.LSTMCell -> {ih: {kernel, bias}, w_hh}."""
    return {
        "ih": {
            "kernel": _np(sd[f"{key}.weight_ih"]).T,
            "bias": _np(sd[f"{key}.bias_ih"]) + _np(sd[f"{key}.bias_hh"]),
        },
        "w_hh": _np(sd[f"{key}.weight_hh"]).T,
    }


def _lstm_seq(sd: Mapping, key: str, suffix: str = "") -> Dict:
    """One direction of nn.LSTM -> LSTMSequence {ih: {kernel, bias}, w_hh}."""
    return {
        "ih": {
            "kernel": _np(sd[f"{key}.weight_ih_l0{suffix}"]).T,
            "bias": _np(sd[f"{key}.bias_ih_l0{suffix}"])
            + _np(sd[f"{key}.bias_hh_l0{suffix}"]),
        },
        "w_hh": _np(sd[f"{key}.weight_hh_l0{suffix}"]).T,
    }


def _bilstm(sd: Mapping, key: str) -> Dict:
    return {"fwd": _lstm_seq(sd, key), "bwd": _lstm_seq(sd, key, "_reverse")}


def _attention_share(sd: Mapping, key: str) -> Dict:
    """AttentionShare (sublayer.py:10-43): K/Q/V bias-free Linears +
    output_layer = Sequential(Linear(no bias), Tanh, LayerNorm, Dropout)."""
    return {
        "K": _lin(sd, f"{key}.K", bias=False),
        "Q": _lin(sd, f"{key}.Q", bias=False),
        "V": _lin(sd, f"{key}.V", bias=False),
        "out": _lin(sd, f"{key}.output_layer.0", bias=False),
        "ln": _ln(sd, f"{key}.output_layer.2"),
    }


def _self_attention(sd: Mapping, key: str) -> Dict:
    """SelfAttention (sublayer.py:46-82): K/Q/V + output_layer.0 (no LN)."""
    return {
        "K": _lin(sd, f"{key}.K", bias=False),
        "Q": _lin(sd, f"{key}.Q", bias=False),
        "V": _lin(sd, f"{key}.V", bias=False),
        "out": _lin(sd, f"{key}.output_layer.0", bias=False),
    }


def _latent_psl(sd: Mapping, key: str) -> Dict:
    """LatentPSL (sublayer.py:176-198): theta [P, D] (same layout) +
    out_norm = Sequential(Tanh, LayerNorm, Dropout)."""
    return {"theta": _np(sd[f"{key}.theta"]), "ln": _ln(sd, f"{key}.out_norm.1")}


def _encoder_visual(sd: Mapping, key: str) -> Dict:
    return {
        "linear_embed": _lin(sd, f"{key}.linear_embed"),
        "lstm": _bilstm(sd, f"{key}.lstm"),
        "layernorm_lstm": _ln(sd, f"{key}.layernorm_lstm"),
        "self_attention": _self_attention(sd, f"{key}.self_attention"),
        "layernorm_sa": _ln(sd, f"{key}.layernorm_sa"),
    }


def _graph_tun(
    sd: Mapping, key: str, use_embed: bool, num_obj: int, own_obj_embed: bool = True
) -> Dict:
    """`own_obj_embed=False` when the caller fuses the region projection of
    both branches into one encoder-level kernel (CapGnnEncoder
    obj_embed_joint); the per-branch norms always stay here."""
    out = {
        "visual_norm": _tanh_ln(sd, f"{key}.visual_norm.1"),
        "v2l_layer": _latent_psl(sd, f"{key}.v2l_layer"),
    }
    if use_embed:
        out["visual_embed"] = _lin(sd, f"{key}.visual_embed")
    if num_obj > 4:
        if own_obj_embed:
            out["obj_embed"] = _lin(sd, f"{key}.obj_embed")
        out["obj_norm"] = _tanh_ln(sd, f"{key}.obj_norm.1")
        out["obj_visual_norm"] = _tanh_ln(sd, f"{key}.obj_visual_norm.1")
    return out


def _split_query_lstm(sd: Mapping, key: str, cfg: DLSGConfig) -> Dict:
    """Reference query LSTM input order is [lang_h, global, word]
    (layer.py:570-571); ours is dyn=[lang_h, word] + static=[global]
    (models/decoder.py). Re-slice weight_ih's input rows to match."""
    w_ih = _np(sd[f"{key}.weight_ih"]).T  # [in, 4H]
    hd = cfg.decode_hidden_size
    gf = 2 * cfg.visual_hidden_size  # multi-modal global feat (layer.py:315-316)
    ws = cfg.word_size
    if w_ih.shape[0] != hd + gf + ws:
        raise ValueError(
            f"query_lstm input dim {w_ih.shape[0]} != decode({hd}) + global({gf}) "
            f"+ word({ws}); was the checkpoint trained with a different config?"
        )
    return {
        "ih_dyn": {
            "kernel": np.concatenate([w_ih[:hd], w_ih[hd + gf :]], axis=0),
            "bias": _np(sd[f"{key}.bias_ih"]) + _np(sd[f"{key}.bias_hh"]),
        },
        "ih_static": {"kernel": w_ih[hd : hd + gf]},
        "w_hh": _np(sd[f"{key}.weight_hh"]).T,
    }


def _decoder(sd: Mapping, key: str, cfg: DLSGConfig) -> Dict:
    return {
        "step": {
            "word_embed": _emb(sd, f"{key}.word_embed"),
            "query_lstm": _split_query_lstm(sd, f"{key}.query_lstm", cfg),
            "query_lstm_layernorm": _ln(sd, f"{key}.query_lstm_layernorm"),
            "context_att": _attention_share(sd, f"{key}.context_att"),
            "context_att_2": _attention_share(sd, f"{key}.context_att_2"),
            "lang_lstm": _lstm_cell(sd, f"{key}.lang_lstm"),
            "lang_lstm_layernorm": _ln(sd, f"{key}.lang_lstm_layernorm"),
            "word_restore": _lin(sd, f"{key}.word_restore"),
        }
    }


def _psl_score2(sd: Mapping, key: str) -> Dict:
    """PSLScore2 (layer.py:661-715): Sequential indices -> named modules."""
    return {
        "psl_embed": _lin(sd, f"{key}.psl_embed.0"),
        "psl_embed_norm": {"ln": _ln(sd, f"{key}.psl_embed.2")},
        "att_norm_dense": _lin(sd, f"{key}.att_norm.0"),
        "att_norm": {"ln": _ln(sd, f"{key}.att_norm.2")},
        "psl_norm": {"ln": _ln(sd, f"{key}.psl_norm.1")},
        "psl_scorer": {
            "classify": _lin(sd, f"{key}.psl_scorer.classify"),
            "visual_embed": _lin(sd, f"{key}.psl_scorer.visual_embed.0"),
            "sent_embed": _lin(sd, f"{key}.psl_scorer.sent_embed.0"),
        },
    }


def convert_capgnn_state_dict(sd: Mapping, cfg: DLSGConfig) -> Dict:
    """CapGnnModel.state_dict() -> {'params': ...} for models/generator.py.

    Maps the live parameter set of the reference's multi-modal generator
    (model.py:25-53): CapGnnEncoder{obj_encoder TUN, motion_pre_encoder
    EncoderVisual, motion_encoder TUN(use_embed=False)} + Decoder.
    """
    joint = cfg.joint_region_projection
    encoder = {
        "obj_encoder": _graph_tun(
            sd, "encoder.obj_encoder", use_embed=True, num_obj=cfg.num_obj,
            own_obj_embed=not joint,
        ),
        "motion_pre_encoder": _encoder_visual(sd, "encoder.motion_pre_encoder"),
        "motion_encoder": _graph_tun(
            sd, "encoder.motion_encoder", use_embed=False, num_obj=cfg.num_obj,
            own_obj_embed=not joint,
        ),
    }
    if cfg.num_obj > 4 and joint:
        # both branches' region projections, fused side by side (the joint
        # [2048, 2*rps] kernel of CapGnnEncoder; exact: split == two matmuls)
        encoder["obj_embed_joint"] = {
            "kernel": np.concatenate(
                [
                    _np(sd["encoder.obj_encoder.obj_embed.weight"]).T,
                    _np(sd["encoder.motion_encoder.obj_embed.weight"]).T,
                ],
                axis=1,
            ),
            "bias": np.concatenate(
                [
                    _np(sd["encoder.obj_encoder.obj_embed.bias"]),
                    _np(sd["encoder.motion_encoder.obj_embed.bias"]),
                ]
            ),
        }
    params = {"encoder": encoder, "decoder": _decoder(sd, "decoder", cfg)}
    return {"params": params}


def convert_discv2_state_dict(sd: Mapping, cfg: DLSGConfig) -> Dict:
    """DiscV2.state_dict() -> {'params': ...} for models/discriminator.py."""
    conv_w = _np(sd["conv1d.weight"])  # [512, V, 1]
    res_w = _np(sd["block.0.res_block.1.weight"])  # [512, 512, 3]
    params = {
        "conv1d": {
            "kernel": conv_w[:, :, 0].T,  # k=1 conv == Dense (model.py:122)
            "bias": _np(sd["conv1d.bias"]),
        },
        "block": {
            "conv": {
                # torch [out, in, k] -> flax nn.Conv [k, in, out]
                "kernel": np.transpose(res_w, (2, 1, 0)),
                "bias": _np(sd["block.0.res_block.1.bias"]),
            }
        },
        "lstm": _lstm_seq(sd, "lstm"),
        "layer_norm": _ln(sd, "layer_norm"),
        "att": _self_attention(sd, "att"),
        "att_norm": _tanh_ln(sd, "att_norm.1"),
        "obj_psl_score": _psl_score2(sd, "obj_psl_score"),
        "motion_psl_score": _psl_score2(sd, "motion_psl_score"),
        "text_sum": _latent_psl(sd, "text_sum"),
        "fusion": _np(sd["fusion"]),
    }
    return {"params": params}


def capgnn_from_reference(sd: Mapping, cfg: DLSGConfig) -> Dict[str, torch.Tensor]:
    """The reference's CapGnnModel.state_dict() -> this package's
    CapGnnModel state_dict."""
    return params_from_jax(convert_capgnn_state_dict(sd, cfg)["params"])


def discv2_from_reference(sd: Mapping, cfg: DLSGConfig) -> Dict[str, torch.Tensor]:
    """The reference's DiscV2.state_dict() -> this package's DiscV2
    state_dict."""
    return params_from_jax(convert_discv2_state_dict(sd, cfg)["params"])


def load_reference_checkpoint(path: str, cfg: DLSGConfig) -> Dict:
    """Load an epoch checkpoint saved by the reference trainer
    (run_gun.py:302-310) and convert both models to this package's
    state_dicts.

    Loads with `weights_only=True`: a reference-trained `.pt` is an untrusted
    external artifact and full unpickling executes arbitrary code. The numpy
    globals the reference's `cap_list` payload needs are explicitly
    allowlisted; any other global in the pickle stream is refused.

    Returns {'generator': state_dict, 'discriminator': state_dict | None,
             'cap_list': ndarray | None, 'epoch': int | None}.
    """
    allow = [np.ndarray, np.dtype]
    # numpy >= 2 renamed numpy.core -> numpy._core (same objects; the
    # pickle stream's numpy.core.multiarray path resolves to them)
    mod = getattr(np, "_core", None) or getattr(np, "core", None)
    ma = getattr(mod, "multiarray", None) if mod else None
    if ma is not None:
        allow += [ma._reconstruct, ma.scalar]
    dtypes_mod = getattr(np, "dtypes", None)
    if dtypes_mod is not None:
        allow += [getattr(dtypes_mod, n) for n in dir(dtypes_mod) if n.endswith("DType")]
    with torch.serialization.safe_globals(allow):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    out = {
        "generator": capgnn_from_reference(ckpt["model_state_dict"], cfg),
        # the discriminator is absent from CE-only checkpoints (train.py path)
        "discriminator": (
            discv2_from_reference(ckpt["model_d_state_dict"], cfg)
            if "model_d_state_dict" in ckpt
            else None
        ),
        "cap_list": np.asarray(ckpt["cap_list"]) if "cap_list" in ckpt else None,
        "epoch": ckpt.get("epoch"),
    }
    return out
