"""Shared layers (``repro.models.layers``): RMSNorm, RoPE, SwiGLU, the
chunked running-softmax attention with its causal, sliding-window and
int8 variants, and the GQA caches: the static KV cache, its ring buffer
for sliding-window archs, and the int8 cache with per-token scales.

``flash_attention`` is the reference's KV-chunked attention with fp32
running statistics, written in plain PyTorch: a loop over KV chunks, no
[Tq, Tk] score tensor over the whole sequence. It is not a Pallas kernel
in the JAX package either, so it has no kernel to port. Without grad it
updates its score chunk in place; with grad enabled (train mode) the
exponent takes a new tensor instead, since ``amax`` saved the scores for
its backward. The arithmetic is the same either way.

The caches are updated in place (the JAX functions return new ones): the
returned cache holds the same tensors with ``pos``, a Python int,
advanced. A write past a linear cache's end raises where the reference's
``dynamic_update_slice`` would clamp it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

NEG_INF = -1e30
# key position of a masked-out slot: beyond any query position
_FAR = 2**30


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * gamma


def rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Rotate-half RoPE. x [..., T, H, D]; positions [..., T]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., :, None].float() * freqs                  # [..., T, D/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def swiglu(x: Tensor, w1: Tensor, w3: Tensor, w2: Tensor) -> Tensor:
    """SwiGLU MLP: (silu(x·w1) * (x·w3)) · w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 0, q_offset: int = 0, k_offset: int = 0,
                    kv_chunk: int = 1024, kv_len: Optional[int] = None,
                    k_positions: Optional[Tensor] = None,
                    k_scale: Optional[Tensor] = None,
                    v_scale: Optional[Tensor] = None) -> Tensor:
    """Chunked attention. q [B,Tq,H,D]; k [B,Tk,KH,D]; v [B,Tk,KH,Dv]; GQA
    via H = KH·G. A key is masked when ``causal`` and it lies after the
    query, or when ``window`` and (q_pos − k_pos) ≥ window. ``kv_len``
    masks a partially filled cache: keys past it get a position no query
    reaches (so, as in the reference, it masks only under ``causal``).
    ``k_positions`` [Tk] overrides the key positions (ring-buffer caches);
    ``k_scale``/``v_scale`` [B, Tk] mark int8 K/V, dequantised one chunk
    at a time to q's dtype, so the whole cache never exists above int8.
    Without ``causal`` the zero keys that pad the last chunk are not
    masked: they take a share of the softmax, as in the reference."""
    b, tq, h, d = q.shape
    _, tk, kh, _ = k.shape
    dv = v.shape[-1]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qr = q.reshape(b, tq, kh, g, d).permute(0, 2, 3, 1, 4)           # [B,K,G,Tq,D]
    dev = q.device
    q_pos = q_offset + torch.arange(tq, device=dev)

    c = min(kv_chunk, tk)
    n_chunks = -(-tk // c)
    pad = n_chunks * c - tk
    slots = torch.arange(n_chunks * c, device=dev)
    if k_positions is not None:
        k_pos = F.pad(k_positions.to(dev), (0, pad), value=_FAR)
    else:
        k_pos = k_offset + slots
    if kv_len is not None:
        k_pos = torch.where(slots < kv_len, k_pos, _FAR)
    elif pad:
        k_pos = torch.where(slots < tk, k_pos, _FAR)

    m = torch.full((b, kh, g, tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, g, tq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, kh, g, tq, dv), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        lo, hi = i * c, min((i + 1) * c, tk)
        kc, vc = k[:, lo:hi], v[:, lo:hi]
        if k_scale is not None:
            kc = (kc.float() * k_scale[:, lo:hi, None, None]).to(q.dtype)
            vc = (vc.float() * v_scale[:, lo:hi, None, None]).to(q.dtype)
        if hi - lo < c:                                                 # the padded last chunk
            kc = F.pad(kc, (0, 0, 0, 0, 0, c - (hi - lo)))
            vc = F.pad(vc, (0, 0, 0, 0, 0, c - (hi - lo)))
        s = torch.einsum("bkgqd,bckd->bkgqc", qr, kc).float().mul_(scale)
        kp = k_pos[lo:lo + c]
        if causal or window:
            keep = torch.ones((tq, c), dtype=torch.bool, device=dev)
            if causal:
                keep &= q_pos[:, None] >= kp[None, :]
            if window:
                keep &= (q_pos[:, None] - kp[None, :]) < window
            s.masked_fill_(~keep, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = (s - m_new[..., None] if torch.is_grad_enabled() else s.sub_(m_new[..., None])).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p.to(vc.dtype), vc).float()
        m = m_new
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, tq, h, dv).to(q.dtype)


class KVCache(NamedTuple):
    """Static-size KV cache; sliding-window archs use a ring buffer of size
    ``window`` so a long context still stores only O(window)."""
    k: Tensor   # [B, S, KH, D]
    v: Tensor
    pos: int    # tokens written so far


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-token f32 scales: half the bytes of a bf16
    cache. Scales are per token (not per head), [B, S]."""
    k: Tensor        # [B, S, KH, D] int8
    v: Tensor        # int8
    k_scale: Tensor  # [B, S] f32
    v_scale: Tensor
    pos: int


AnyKVCache = Union[KVCache, QuantKVCache]


def _write(buf: Tensor, new: Tensor, start: int, window: int) -> None:
    """buf[:, slots] = new along dim 1: ring slots (start + i) % window
    when the buffer is the window's ring, else the contiguous run from
    ``start``."""
    t, s = new.shape[1], buf.shape[1]
    if window and s == window:
        idx = (start + torch.arange(t, device=buf.device)) % window
        buf[:, idx] = new.to(buf.dtype)
        return
    if start + t > s:
        raise ValueError(f"KV cache overflow: {start + t} tokens, capacity {s}")
    buf[:, start:start + t] = new.to(buf.dtype)


def cache_update(cache: KVCache, k_new: Tensor, v_new: Tensor, window: int = 0,
                 start: Optional[int] = None) -> KVCache:
    """Append k/v [B, T, KH, D] in place. ``start`` is the absolute
    position of k_new[0] (defaults to cache.pos); ring-buffer writes use
    slot position % window."""
    start = cache.pos if start is None else start
    _write(cache.k, k_new, start, window)
    _write(cache.v, v_new, start, window)
    return KVCache(cache.k, cache.v, cache.pos + k_new.shape[1])


def quantize_kv(x: Tensor):
    """Symmetric per-token int8. x [B,T,KH,D] -> (q int8, scale [B,T] f32).
    The scale is max|x| times f32(1/127): the compiled reference's
    ``max / 127.0``, which XLA folds into a product with the constant's
    reciprocal. The codes divide by the scale (a true division: a product
    with its reciprocal would move codes at the rounding edges);
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=(-2, -1)) * (1.0 / 127.0), 1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127).to(torch.int8)
    return q, scale


def quant_cache_update(cache: QuantKVCache, k_new: Tensor, v_new: Tensor, window: int = 0,
                       start: Optional[int] = None) -> QuantKVCache:
    start = cache.pos if start is None else start
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    for buf, new in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks), (cache.v_scale, vs)):
        _write(buf, new, start, window)
    return QuantKVCache(cache.k, cache.v, cache.k_scale, cache.v_scale,
                        cache.pos + k_new.shape[1])


def ring_slot_positions(pos: int, window: int, device=None) -> Tensor:
    """Absolute token position stored in each ring-buffer slot (invalid
    slots → 2**30). Slot s holds the latest token t with t % window == s."""
    slots = torch.arange(window, device=device)
    full_cycles = torch.div(pos - 1 - slots, window, rounding_mode="floor")
    last_pos = slots + torch.clamp_min(full_cycles, 0) * window
    valid = slots < min(pos, window)
    return torch.where(valid, torch.where(last_pos < pos, last_pos, last_pos - window), _FAR)


def decode_attention(q: Tensor, cache: AnyKVCache, *, window: int = 0) -> Tensor:
    """Single-token attention over the cache (KVCache or QuantKVCache).
    q [B,1,H,D]."""
    scales = ({"k_scale": cache.k_scale, "v_scale": cache.v_scale}
              if isinstance(cache, QuantKVCache) else {})
    if window and cache.k.shape[1] == window:
        k_pos = ring_slot_positions(cache.pos, window, q.device)
        return flash_attention(q, cache.k, cache.v, causal=True, window=window,
                               q_offset=cache.pos - 1, k_positions=k_pos, **scales)
    return flash_attention(q, cache.k, cache.v, causal=True, window=window,
                           q_offset=cache.pos - 1, kv_len=cache.pos, **scales)
