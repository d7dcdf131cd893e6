"""Architecture registry (``repro.models.zoo``) for the ported archs:
config lookup, parameter counts without allocation, and the
family-faithful reduced config of the CPU tests."""
from __future__ import annotations

import dataclasses
import importlib
import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import spec_leaves
from repro_torch.models.transformer import model_specs

ARCH_IDS = ["deepseek-v2-lite-16b"]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"{arch_id!r} is not ported yet; ported: {ARCH_IDS} "
                       "(ROADMAP.md §1 has the order)")
    return importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}").CONFIG


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
    (segments, MoE and MLA wiring), small dims, float32. For
    deepseek-v2-lite it keeps 8 experts with top-6 (density 0.75), so it
    runs ``moe_dense``: a test of the sparse dispatch replaces ``moe``."""
    cfg = get_config(arch_id)

    def r8(x):
        return max(8, int(x * scale) // 8 * 8)

    d_model = r8(cfg.d_model)
    moe, mla = cfg.moe, cfg.mla
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
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        d_ff=r8(cfg.d_ff) if cfg.d_ff else 0, vocab=min(cfg.vocab, 512), head_dim=0,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        frontend_dim=min(cfg.frontend_dim, 24) if cfg.frontend_dim else 0,
        dtype=torch.float32, kv_quant=False, moe=moe, mla=mla)
