"""Attention variants (``repro.models.attention``): GQA self-attention
(whole sequence, prefill, decode; the linear, ring-buffer and int8
caches), DeepSeek-V2 multi-head latent attention (the expanded form,
prefill that also fills the compressed-latent cache, the absorbed
single-token decode) and the gated cross-attention of the VLM.

Caches are updated in place (the JAX functions return new ones): the
returned cache holds the same tensors with ``pos`` advanced.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    AnyKVCache, KVCache, QuantKVCache, cache_update, decode_attention, flash_attention,
    quant_cache_update, rms_norm, rope,
)
from repro_torch.models.params import P_, layer_names

Tensor = torch.Tensor


class MLACache(NamedTuple):
    c_kv: Tensor    # [B, S, kv_lora] compressed latents
    k_rope: Tensor  # [B, S, rope_dim] shared rotary key
    pos: int        # tokens written so far


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _positions(start: int, t: int, device) -> Tensor:
    return (start + torch.arange(t, device=device))[None, :]


# ----------------------------- GQA self-attention --------------------------


def gqa_specs(cfg: ModelConfig, layer_dim: Tuple[int, ...] = ()) -> dict:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    ld, ln = layer_dim, layer_names(layer_dim)
    specs = {
        "wq": P_(ld + (d, cfg.n_heads * hd), ln + ("embed", "qk_fused"), dtype=cfg.dtype),
        "wk": P_(ld + (d, cfg.n_kv_heads * hd), ln + ("embed", "qk_fused"), dtype=cfg.dtype),
        "wv": P_(ld + (d, cfg.n_kv_heads * hd), ln + ("embed", "qk_fused"), dtype=cfg.dtype),
        "wo": P_(ld + (cfg.n_heads * hd, d), ln + ("qk_fused", "embed"), dtype=cfg.dtype),
    }
    if cfg.qkv_bias:
        specs["bq"] = P_(ld + (cfg.n_heads * hd,), ln + ("qk_fused",), init="zeros", dtype=cfg.dtype)
        specs["bk"] = P_(ld + (cfg.n_kv_heads * hd,), ln + ("qk_fused",), init="zeros", dtype=cfg.dtype)
        specs["bv"] = P_(ld + (cfg.n_kv_heads * hd,), ln + ("qk_fused",), init="zeros", dtype=cfg.dtype)
    return specs


def _qkv(p, x: Tensor, cfg: ModelConfig, positions: Tensor):
    hd = cfg.resolved_head_dim
    b, t, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.reshape(b, t, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, t, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, t, cfg.n_kv_heads, hd)


def _out(p, o: Tensor) -> Tensor:
    b, t = o.shape[:2]
    return o.reshape(b, t, -1) @ p["wo"]


def gqa_forward(p, x: Tensor, cfg: ModelConfig, *, causal: bool = True,
                q_offset: int = 0) -> Tensor:
    """Whole-sequence self-attention (no cache)."""
    q, k, v = _qkv(p, x, cfg, _positions(q_offset, x.shape[1], x.device))
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window, q_offset=q_offset)
    return _out(p, o)


def _update(cache: AnyKVCache):
    return quant_cache_update if isinstance(cache, QuantKVCache) else cache_update


def gqa_prefill(p, x: Tensor, cfg: ModelConfig, cache: AnyKVCache) -> Tuple[Tensor, AnyKVCache]:
    """Prompt self-attention that also fills the cache. On a ring cache
    (``max_seq`` ≥ window) only the last ``window`` keys are kept, written
    from slot ``cache.pos`` on, as the reference writes them: for a prompt
    longer than the window whose length is not a multiple of it, the
    slots disagree with ``ring_slot_positions`` (ROADMAP §3)."""
    t = x.shape[1]
    q, k, v = _qkv(p, x, cfg, _positions(cache.pos, t, x.device))
    o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window, q_offset=cache.pos)
    w = cfg.sliding_window
    if w and cache.k.shape[1] == w:
        new = _update(cache)(cache, k[:, -w:], v[:, -w:], window=w)
        new = new._replace(pos=cache.pos + t)
    else:
        new = _update(cache)(cache, k, v)
    return _out(p, o), new


def gqa_decode(p, x: Tensor, cfg: ModelConfig, cache: AnyKVCache) -> Tuple[Tensor, AnyKVCache]:
    """Single-token decode. x [B, 1, D]."""
    q, k, v = _qkv(p, x, cfg, _positions(cache.pos, x.shape[1], x.device))
    cache = _update(cache)(cache, k, v, window=cfg.sliding_window)
    return _out(p, decode_attention(q, cache, window=cfg.sliding_window)), cache


def gqa_cache_spec(cfg: ModelConfig, batch: int, max_seq: int, layer_dim: Tuple[int, ...]):
    """Shapes and dtypes of a segment's GQA caches, stacked over its layers:
    a ring of ``window`` slots when ``max_seq`` ≥ window, int8 with
    per-token scales when ``cfg.kv_quant``."""
    hd = cfg.resolved_head_dim
    s = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = layer_dim + (batch, s, cfg.n_kv_heads, hd)
    pos = TensorSpec(layer_dim, torch.int32)
    if cfg.kv_quant:
        sshape = layer_dim + (batch, s)
        return QuantKVCache(k=TensorSpec(shape, torch.int8), v=TensorSpec(shape, torch.int8),
                            k_scale=TensorSpec(sshape, torch.float32),
                            v_scale=TensorSpec(sshape, torch.float32), pos=pos)
    return KVCache(k=TensorSpec(shape, cfg.dtype), v=TensorSpec(shape, cfg.dtype), pos=pos)


# --------------------------------- MLA -------------------------------------


def mla_specs(cfg: ModelConfig, layer_dim: Tuple[int, ...] = ()) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    ld, ln = layer_dim, layer_names(layer_dim)
    return {
        "wq": P_(ld + (d, h * qd), ln + ("embed", "qk_fused"), dtype=cfg.dtype),
        "wkv_a": P_(ld + (d, m.kv_lora_rank + m.rope_head_dim), ln + ("embed", "kv_lora"), dtype=cfg.dtype),
        "kv_norm": P_(ld + (m.kv_lora_rank,), ln + ("kv_lora",), init="ones", dtype=cfg.dtype),
        "wk_b": P_(ld + (m.kv_lora_rank, h * m.nope_head_dim), ln + ("kv_lora", "qk_fused"), dtype=cfg.dtype),
        "wv_b": P_(ld + (m.kv_lora_rank, h * m.v_head_dim), ln + ("kv_lora", "qk_fused"), dtype=cfg.dtype),
        "wo": P_(ld + (h * m.v_head_dim, d), ln + ("qk_fused", "embed"), dtype=cfg.dtype),
    }


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


# ----------------------------- cross-attention ------------------------------


def cross_attn_specs(cfg: ModelConfig, layer_dim: Tuple[int, ...] = ()) -> dict:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    ld, ln = layer_dim, layer_names(layer_dim)
    return {
        "wq": P_(ld + (d, cfg.n_heads * hd), ln + ("embed", "qk_fused"), dtype=cfg.dtype),
        "wk": P_(ld + (d, cfg.n_kv_heads * hd), ln + ("embed", "qk_fused"), dtype=cfg.dtype),
        "wv": P_(ld + (d, cfg.n_kv_heads * hd), ln + ("embed", "qk_fused"), dtype=cfg.dtype),
        "wo": P_(ld + (cfg.n_heads * hd, d), ln + ("qk_fused", "embed"), dtype=cfg.dtype),
        "gate": P_(ld + (1,), ln + (None,), init="zeros", dtype=cfg.dtype),
    }


def cross_attn(p, x: Tensor, kv_src: Tensor, cfg: ModelConfig) -> Tensor:
    """Gated cross-attention (llama-3.2-vision style): q from the text, k/v
    from the (already d_model-projected) vision sequence; the gate is
    tanh(gate), zero at init."""
    hd = cfg.resolved_head_dim
    b, t, _ = x.shape
    s = kv_src.shape[1]
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, hd)
    k = (kv_src @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (kv_src @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    o = flash_attention(q, k, v, causal=False)
    return torch.tanh(p["gate"]) * _out(p, o)
