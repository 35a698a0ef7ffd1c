"""Configuration of the Kimi-VL-A3B captioner (`models/kimi_vl.py`).

`KimiVLConfig` holds the language model's settings under the names of the
published `config.json` (moonshotai/Kimi-VL-A3B-Instruct, its
`text_config`), the vision side's sizes that the projector needs, and the
captioning prompt. It is kept apart from `DLSGConfig`, whose fields are the
JAX package's; the serving knobs (beam size, batch, caption length, dtype)
stay there.

The vision tower (MoonViT) runs ahead of the program: a clip arrives as its
output, `frames` x `tokens_per_frame` merged tokens of `merge` patches of
`vision_hidden_size` each (`feature_shape`), as D-LSG's clips arrive as
precomputed CNN features. This module imports nothing heavy, so that
`serve.py` can hold a config without loading the model.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

START_ID = 1  # the synthetic vocabulary's `<start>` (vocab.py): the prompt's last token


@dataclass(frozen=True)
class KimiVLConfig:
    # ---- the language model, by the published keys ----
    vocab_size: int = 163840
    max_position_embeddings: int = 131072
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    ep_size: int = 1
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_experts_per_tok: int = 6
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    seq_aux: bool = True
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    # ---- the vision side (the model's vision_config) and the clip ----
    vision_hidden_size: int = 1152
    merge_kernel_size: Tuple[int, int] = (2, 2)
    projector_ln_eps: float = 1e-5
    frames: int = 26
    tokens_per_frame: int = 99
    # the captioning prompt after the visual tokens; its last token is fed
    # as the beam's start token, the rest are prefilled
    prompt_ids: Tuple[int, ...] = (START_ID,)

    def __post_init__(self):
        supported = dict(q_lora_rank=None, rope_scaling=None, scoring_func="sigmoid",
                         topk_method="noaux_tc", n_group=1, topk_group=1, moe_layer_freq=1,
                         hidden_act="silu", attention_bias=False, tie_word_embeddings=False)
        for k, v in supported.items():
            if getattr(self, k) != v:
                raise NotImplementedError(f"KimiVLConfig: {k}={getattr(self, k)!r} (only {v!r})")
        if self.num_key_value_heads != self.num_attention_heads:
            raise NotImplementedError("KimiVLConfig: MLA has one key per head")
        if not self.prompt_ids or self.prompt_ids[-1] != START_ID:
            raise ValueError(f"the prompt must end with <start> ({START_ID}), got {self.prompt_ids}")
        object.__setattr__(self, "merge_kernel_size", tuple(self.merge_kernel_size))
        object.__setattr__(self, "prompt_ids", tuple(int(t) for t in self.prompt_ids))

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_width(self) -> int:
        """Values a token and layer in the latent cache: c_kv and k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def merge(self) -> int:
        return self.merge_kernel_size[0] * self.merge_kernel_size[1]

    @property
    def feature_shape(self) -> Tuple[int, int, int, int]:
        """One clip's input: [frames, tokens_per_frame, merge, vision_hidden_size]."""
        return (self.frames, self.tokens_per_frame, self.merge, self.vision_hidden_size)

    @property
    def prefix_len(self) -> int:
        """Tokens prefilled a clip: the visual tokens and the prompt but its last."""
        return self.frames * self.tokens_per_frame + len(self.prompt_ids) - 1

    @classmethod
    def from_dict(cls, d: dict) -> "KimiVLConfig":
        """The fields of `d` that the dataclass has (a configuration file
        holds more)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})

    def build_generator(self):
        """The generator (`models/kimi_vl.py::KimiVLGenerator`) on the meta
        device, ready for `load_state_dict`, which takes the given tensors
        as its parameters; its module is imported here, on first use."""
        from dlsg_tpu_torch.models.kimi_vl import KimiVLGenerator

        return KimiVLGenerator.on_meta(self)


def tiny_kimi_vl_config(**overrides) -> KimiVLConfig:
    """The architecture at test widths: every kind of layer and every path,
    small enough for the CPU."""
    base = dict(vocab_size=300, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
                num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
                n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
                qk_rope_head_dim=8, v_head_dim=16, qk_nope_head_dim=16, vision_hidden_size=12,
                frames=3, tokens_per_frame=5, prompt_ids=(7, 9, 11, START_ID))
    base.update(overrides)
    return KimiVLConfig(**base)
