"""DeepSeek-V2 multi-head latent attention (``repro.models.attention``,
the MLA half): the expanded form for a whole sequence, prefill that also
fills the compressed-latent cache, and the absorbed single-token decode.

The cache is updated in place (the JAX functions return a new one): the
returned ``MLACache`` holds the same tensors with ``pos`` advanced.
GQA, its ring-buffer and int8 caches, and cross-attention are not ported
yet (ROADMAP §1).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import flash_attention, rms_norm, rope
from repro_torch.models.params import P_

Tensor = torch.Tensor


class MLACache(NamedTuple):
    c_kv: Tensor    # [B, S, kv_lora] compressed latents
    k_rope: Tensor  # [B, S, rope_dim] shared rotary key
    pos: int        # tokens written so far


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def mla_specs(cfg: ModelConfig, layer_dim: Tuple[int, ...] = ()) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    ld = layer_dim
    return {
        "wq": P_(ld + (d, h * qd), dtype=cfg.dtype),
        "wkv_a": P_(ld + (d, m.kv_lora_rank + m.rope_head_dim), dtype=cfg.dtype),
        "kv_norm": P_(ld + (m.kv_lora_rank,), init="ones", dtype=cfg.dtype),
        "wk_b": P_(ld + (m.kv_lora_rank, h * m.nope_head_dim), dtype=cfg.dtype),
        "wv_b": P_(ld + (m.kv_lora_rank, h * m.v_head_dim), dtype=cfg.dtype),
        "wo": P_(ld + (h * m.v_head_dim, d), dtype=cfg.dtype),
    }


def _positions(start: int, t: int, device) -> Tensor:
    return (start + torch.arange(t, device=device))[None, :]


def _mla_qc(p, x: Tensor, cfg: ModelConfig, positions: Tensor):
    m = cfg.mla
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (x @ p["wkv_a"]).split([m.kv_lora_rank, m.rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expanded(p, x: Tensor, cfg: ModelConfig, q_offset: int):
    """The expanded form: per-head k/v materialised, chunked causal
    attention. Returns (out, c_kv, k_rope) so prefill can fill its cache
    without recomputing the projections."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qc(p, x, cfg, _positions(q_offset, t, x.device))
    k_nope = (c_kv @ p["wk_b"]).reshape(b, t, h, m.nope_head_dim)
    v = (c_kv @ p["wv_b"]).reshape(b, t, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, m.rope_head_dim)], dim=-1)
    # the reference pads v to q's head dim for its shared kernel and slices
    # the pad off again; this attention takes v's own width
    o = flash_attention(q, k, v, causal=True, q_offset=q_offset)
    return o.reshape(b, t, -1) @ p["wo"], c_kv, k_rope


def mla_forward(p, x: Tensor, cfg: ModelConfig, *, q_offset: int = 0) -> Tensor:
    """Expanded form (training / whole-sequence forward)."""
    return _mla_expanded(p, x, cfg, q_offset)[0]


def _cache_write(cache: MLACache, c_kv: Tensor, k_rope: Tensor) -> MLACache:
    t = c_kv.shape[1]
    end = cache.pos + t
    if end > cache.c_kv.shape[1]:
        raise ValueError(f"MLA cache overflow: {end} tokens, capacity {cache.c_kv.shape[1]}")
    cache.c_kv[:, cache.pos:end] = c_kv.to(cache.c_kv.dtype)
    cache.k_rope[:, cache.pos:end] = k_rope.to(cache.k_rope.dtype)
    return MLACache(cache.c_kv, cache.k_rope, end)


def mla_prefill(p, x: Tensor, cfg: ModelConfig, cache: MLACache) -> Tuple[Tensor, MLACache]:
    out, c_kv, k_rope = _mla_expanded(p, x, cfg, cache.pos)
    return out, _cache_write(cache, c_kv, k_rope)


def mla_decode(p, x: Tensor, cfg: ModelConfig, cache: MLACache) -> Tuple[Tensor, MLACache]:
    """Absorbed decode: attention runs in the compressed latent space, the
    cache stays [S, kv_lora + rope] instead of [S, H, 2·hd]."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qc(p, x, cfg,
                                                   _positions(cache.pos, t, x.device))
    cache = _cache_write(cache, c_kv_new, k_rope_new)
    wk_b = p["wk_b"].reshape(m.kv_lora_rank, h, m.nope_head_dim)
    q_eff = torch.einsum("bthn,lhn->bthl", q_nope, wk_b)              # absorb k up-proj
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    s = (torch.einsum("bthl,bsl->bhts", q_eff, cache.c_kv) +
         torch.einsum("bthr,bsr->bhts", q_rope, cache.k_rope)).float() * scale
    valid = torch.arange(cache.c_kv.shape[1], device=x.device) < cache.pos
    s = torch.where(valid, s, -1e30)
    pr = torch.softmax(s, dim=-1).to(cache.c_kv.dtype)
    o_c = torch.einsum("bhts,bsl->bthl", pr, cache.c_kv)              # latent-space output
    wv_b = p["wv_b"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bthl,lhv->bthv", o_c, wv_b)                     # absorb v up-proj
    return o.reshape(b, t, -1) @ p["wo"], cache


def mla_cache_spec(cfg: ModelConfig, batch: int, max_seq: int,
                   layer_dim: Tuple[int, ...]) -> MLACache:
    """Shapes and dtypes of a segment's caches, stacked over its layers as
    the reference's are (``pos`` one int32 per layer)."""
    m = cfg.mla
    return MLACache(
        c_kv=TensorSpec(layer_dim + (batch, max_seq, m.kv_lora_rank), cfg.dtype),
        k_rope=TensorSpec(layer_dim + (batch, max_seq, m.rope_head_dim), cfg.dtype),
        pos=TensorSpec(layer_dim, torch.int32),
    )
