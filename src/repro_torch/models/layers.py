"""Shared layers (``repro.models.layers``): RMSNorm, RoPE, SwiGLU and the
chunked running-softmax attention.

``flash_attention`` is the reference's KV-chunked attention with fp32
running statistics, written in plain PyTorch: a loop over KV chunks, no
[Tq, Tk] score tensor over the whole sequence. It is not a Pallas kernel
in the JAX package either, so it has no kernel to port.
"""
from __future__ import annotations

import math
from typing import Optional

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
                    q_offset: int = 0, kv_chunk: int = 1024,
                    kv_len: Optional[int] = None) -> Tensor:
    """Chunked attention. q [B,Tq,H,D]; k [B,Tk,KH,D]; v [B,Tk,KH,Dv]; GQA
    via H = KH·G. ``kv_len`` masks a partially filled cache: keys past it
    get a position no query reaches (so, as in the reference, it masks
    only under ``causal``)."""
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
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    slots = torch.arange(n_chunks * c, device=dev)
    k_pos = slots
    if kv_len is not None:
        k_pos = torch.where(slots < kv_len, slots, _FAR)
    elif pad:
        k_pos = torch.where(slots < tk, slots, _FAR)

    m = torch.full((b, kh, g, tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, g, tq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, kh, g, tq, dv), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        kc, vc = k[:, i * c:(i + 1) * c], v[:, i * c:(i + 1) * c]
        s = torch.einsum("bkgqd,bckd->bkgqc", qr, kc).float() * scale
        if causal:
            s = torch.where(q_pos[:, None] >= k_pos[None, i * c:(i + 1) * c], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p.to(v.dtype), vc).float()
        m = m_new
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, tq, h, dv).to(q.dtype)
