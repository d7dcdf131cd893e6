"""Architecture registry (``repro.models.zoo``) for the reference's ten
archs: config lookup, the model, parameter counts without allocation, the
shapes each arch runs, their input specs (tensors on the ``meta``
device, where JAX gives ``ShapeDtypeStruct``s), and the family-faithful
reduced config of the CPU tests."""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, List

import torch

from repro_torch.models.attention import TensorSpec
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.params import spec_leaves
from repro_torch.models.transformer import Model, build_model, cache_specs, model_specs

# the reference's order
ARCH_IDS: List[str] = [
    "deepseek-v2-lite-16b",
    "mixtral-8x22b",
    "xlstm-1.3b",
    "deepseek-7b",
    "qwen1.5-32b",
    "mistral-nemo-12b",
    "minitron-4b",
    "hubert-xlarge",
    "zamba2-1.2b",
    "llama-3.2-vision-11b",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; the archs are {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}").CONFIG


def get_model(arch_id: str, device=None) -> Model:
    return build_model(get_config(arch_id), device)


def count_params(cfg: ModelConfig) -> int:
    return sum(math.prod(spec.shape) for _, spec in spec_leaves(model_specs(cfg)))


def active_params(cfg: ModelConfig) -> int:
    """Per-token active parameters (MoE: top-k of routed + shared)."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    routed_layers = cfg.n_layers - m.first_dense_layers
    return total - routed_layers * (m.n_experts - m.top_k) * per_expert


def reduced_config(arch_id: str, scale: float = 0.08) -> ModelConfig:
    """The reference's reduced config for smoke tests: same topology
    (segments, MoE/MLA/SSM/hybrid/VLM wiring), small dims, float32. As in
    the reference it drops an explicit head_dim (d_model // n_heads),
    turns the int8 cache off and caps the window at 32. For
    deepseek-v2-lite it keeps 8 experts with top-6 (density 0.75), so it
    runs ``moe_dense``: a test of the sparse dispatch replaces ``moe``.
    An SSM keeps chunks of at most 32 and Mamba2 heads of di / 8; xLSTM
    takes an sLSTM every 2 blocks and zamba2 a shared site every 2
    layers."""
    cfg = get_config(arch_id)

    def r8(x):
        return max(8, int(x * scale) // 8 * 8)

    d_model = r8(cfg.d_model)
    moe, mla, ssm, hybrid, vlm = cfg.moe, cfg.mla, cfg.ssm, cfg.hybrid, cfg.vlm
    n_layers = max(2, int(cfg.n_layers * scale))
    n_heads = 4 if d_model % 4 == 0 else 2
    n_kv = max(1, min(cfg.n_kv_heads * n_heads // max(cfg.n_heads, 1), n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    if moe is not None:
        moe = dataclasses.replace(
            moe, d_ff_expert=r8(moe.d_ff_expert),
            d_ff_dense=r8(moe.d_ff_dense) if moe.d_ff_dense else 0,
            n_experts=min(moe.n_experts, 8),
            top_k=min(moe.top_k, min(moe.n_experts, 8)),
            capacity_factor=4.0)
        if moe.first_dense_layers:
            n_layers = max(n_layers, moe.first_dense_layers + 1)
    if mla is not None:
        mla = dataclasses.replace(mla, kv_lora_rank=max(16, r8(mla.kv_lora_rank)),
                                  rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
    if ssm is not None:
        di = 2 * d_model            # expand stays 2
        ssm = dataclasses.replace(
            ssm, chunk=min(ssm.chunk, 32),
            head_dim=(di // 8 if ssm.head_dim else ssm.head_dim),
            slstm_every=(2 if ssm.slstm_every else 0))
        if cfg.family == "ssm" and ssm.slstm_every:
            n_layers = max(2, n_layers // ssm.slstm_every * ssm.slstm_every)
            n_heads = 4 if di % (4 * 8) == 0 else 2
            n_kv = n_heads
    if hybrid is not None:
        hybrid = dataclasses.replace(hybrid, attn_every=2, shared_d_ff=r8(hybrid.shared_d_ff))
    if vlm is not None:
        vlm = dataclasses.replace(vlm, cross_attn_every=2, vision_dim=48, vision_tokens=5)
        n_layers = max(2, n_layers // 2 * 2)
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        d_ff=r8(cfg.d_ff) if cfg.d_ff else 0, vocab=min(cfg.vocab, 512), head_dim=0,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        frontend_dim=min(cfg.frontend_dim, 24) if cfg.frontend_dim else 0,
        dtype=torch.float32, kv_quant=False, moe=moe, mla=mla, ssm=ssm, hybrid=hybrid,
        vlm=vlm)


def arch_shapes(cfg: ModelConfig) -> List[str]:
    """Which of the four assigned shapes apply."""
    if cfg.encoder_only:
        return ["train_4k", "prefill_32k"]          # no decode for encoders
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        shapes.append("long_500k")                  # sub-quadratic archs only
    return shapes


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_tree(tree):
    if isinstance(tree, TensorSpec):
        return _meta(tree.shape, tree.dtype)
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    return type(tree)(*(_meta_tree(v) for v in tree))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Meta-device stand-ins for the step functions' data arguments.

    train   -> batch dict for a train step
    prefill -> batch dict and cache for ``Model.prefill``
    decode  -> (token, cache) for the serve step (cache with seq_len capacity)
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def inputs(with_labels: bool) -> dict:
        if cfg.frontend == "frames":
            batch = {"frames": _meta((b, s, cfg.frontend_dim), torch.bfloat16)}
        else:
            batch = {"tokens": _meta((b, s), i32)}
        if with_labels:
            batch["labels"] = _meta((b, s), i32)
        if cfg.family == "vlm":
            batch["image_embeds"] = _meta((b, cfg.vlm.vision_tokens, cfg.vlm.vision_dim),
                                          torch.bfloat16)
        return batch

    if shape.kind == "train":
        return {"batch": inputs(True)}
    if shape.kind == "prefill":
        return {"batch": inputs(False), "cache": _meta_tree(cache_specs(cfg, b, s))}
    specs = {"token": _meta((b, 1), i32), "cache": _meta_tree(cache_specs(cfg, b, s))}
    if cfg.family == "vlm":
        specs["vision_kv"] = _meta((b, cfg.vlm.vision_tokens, cfg.d_model), cfg.dtype)
    return specs
