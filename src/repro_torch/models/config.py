"""Model configuration (``repro.models.config``): the configs of every
family (the MoE, MLA, SSM, hybrid and VLM parts, with the reference's
defaults) and the dry-run shapes."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_dense_layers: int = 0      # leading layers with dense FFN (deepseek-v2)
    d_ff_dense: int = 0              # FFN width of those dense layers
    capacity_factor: float = 1.25
    dispatch: str = "sparse"         # sparse (sort-based) | dense (all-experts) | adaptive


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    # xLSTM: one sLSTM block per `slstm_every` mLSTM blocks (0 = none)
    slstm_every: int = 0


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """zamba2-style: groups of SSM blocks with a shared attention block."""
    attn_every: int = 6          # one shared-attn application per group
    shared_d_ff: int = 8192
    # sliding window for the shared attention sites (0 = full attention)
    attn_window: int = 0


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    cross_attn_every: int = 5
    vision_dim: int = 7680
    vision_tokens: int = 1601


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 → d_model // n_heads
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 → full attention
    encoder_only: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    vlm: Optional[VLMConfig] = None
    # input frontend: "tokens" (LM) or "frames" (audio stub: precomputed embeds)
    frontend: str = "tokens"
    frontend_dim: int = 0
    # int8 KV cache (per-token scales); halves the decode cache
    kv_quant: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        """Supports long_500k (O(1)/O(w) decode state)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
