"""Sub-quadratic sequence mixers (``repro.models.ssm``): one chunked
gated-linear-attention (GLA) core serves both Mamba2 (SSD duality: a
scalar decay per head) and xLSTM's mLSTM (matrix memory with gating),
plus the simplified sLSTM.

Chunked form (chunk L): within a chunk the attention-like products run as
batched matmuls; across chunks a Python loop carries the f32
[B, H, Dk, Dv] state, so the work is linear in the sequence and the decode
state O(1). Every exponent in the chunked path (cum_i − cum_j for i ≥ j,
total − cum_j) is ≤ 0, since the log-decay g is ≤ 0 throughout.

None of this is a Pallas kernel in the JAX package (``gla_chunked`` is
jnp under ``lax.scan``, ``slstm_scan`` a ``lax.associative_scan``), so it
has no kernel to port: it is plain PyTorch on tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class GLAState(NamedTuple):
    s: Tensor   # [B, H, Dk, Dv] matrix memory
    n: Tensor   # [B, H, Dk]     normalizer (mLSTM); zeros when unused


def gla_chunked(q: Tensor, k: Tensor, v: Tensor, g: Tensor, *, chunk: int = 256,
                state: Optional[GLAState] = None,
                normalize: bool = False) -> Tuple[Tensor, GLAState]:
    """q/k [B,T,H,Dk], v [B,T,H,Dv], g [B,T,H] log-decay ≤ 0. Returns y
    [B,T,H,Dv] in v's dtype and the final f32 state. The last chunk is
    padded with zeros (g = 0 there, so the state takes no extra decay)."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    l = min(chunk, t)
    n_chunks = -(-t // l)
    pad = n_chunks * l - t
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        g = F.pad(g, (0, 0, 0, pad))
    if state is None:
        state = GLAState(torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device),
                         torch.zeros((b, h, dk), dtype=torch.float32, device=q.device))
    s, n = state
    causal = torch.ones((l, l), dtype=torch.bool, device=q.device).tril()
    ys = []
    for c in range(n_chunks):
        sl = slice(c * l, (c + 1) * l)
        qc, kc, vc = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()   # [B,L,H,*]
        cum = torch.cumsum(g[:, sl].float(), dim=1)                          # [B,L,H]
        total = cum[:, -1]                                                   # [B,H]
        # inter-chunk: y_i += (q_i · S) e^{cum_i}
        y = torch.einsum("blhd,bhdv->blhv", qc, s) * torch.exp(cum)[..., None]
        # intra-chunk: pairwise decayed attention (l ≥ m)
        dmat = cum[:, :, None, :] - cum[:, None, :, :]                      # [B,L,L,H]
        dmat = dmat.masked_fill(~causal[None, :, :, None], float("-inf"))
        att = torch.einsum("blhd,bmhd->blmh", qc, kc) * torch.exp(dmat)
        y = y + torch.einsum("blmh,bmhv->blhv", att, vc)
        if normalize:
            n_inter = torch.einsum("blhd,bhd->blh", qc, n) * torch.exp(cum)
            denom = torch.abs(n_inter + att.sum(dim=2))   # Σ_m decayed q·k: n's recursion
            y = y / torch.clamp_min(denom, 1.0)[..., None]
        ys.append(y)
        # state update: S' = e^{total} S + Σ_m k_m e^{total−cum_m} v_mᵀ
        kw = kc * torch.exp(total[:, None] - cum)[..., None]
        decay = torch.exp(total)
        s = decay[..., None, None] * s + torch.einsum("blhd,blhv->bhdv", kw, vc)
        n = decay[..., None] * n + kw.sum(dim=1)
    y = torch.cat(ys, dim=1) if n_chunks > 1 else ys[0]
    return y[:, :t].to(v.dtype), GLAState(s, n)


def gla_step(q: Tensor, k: Tensor, v: Tensor, g: Tensor, state: GLAState, *,
             normalize: bool = False) -> Tuple[Tensor, GLAState]:
    """Single-token recurrence. q/k [B,H,Dk], v [B,H,Dv], g [B,H]."""
    dec = torch.exp(g.float())
    kf = k.float()
    s_new = dec[..., None, None] * state.s + torch.einsum("bhd,bhv->bhdv", kf, v.float())
    n_new = dec[..., None] * state.n + kf
    qf = q.float()
    y = torch.einsum("bhd,bhdv->bhv", qf, s_new)
    if normalize:
        denom = torch.abs(torch.einsum("bhd,bhd->bh", qf, n_new))
        y = y / torch.clamp_min(denom, 1.0)[..., None]
    return y.to(v.dtype), GLAState(s_new, n_new)


def causal_conv1d(x: Tensor, w: Tensor, state: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv. x [B,T,C], w [K,C]. Returns (y, the new state:
    the last K−1 inputs [B,K−1,C])."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    new_state = xp[:, -(k - 1):] if k > 1 else state
    t = x.shape[1]
    y = xp[:, 0:t] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + t] * w[i]
    return y, new_state


# ------------------------------- sLSTM --------------------------------------
# Head-diagonal simplification: the recurrence is elementwise per channel,
# c_t = f_t·c_{t-1} + i_t·z_t, solved in parallel over T; n_t normalizes
# like the paper's stabilizer state.


def _linrec_scan(f: Tensor, u: Tensor) -> Tensor:
    """Inclusive scan of c_t = f_t·c_{t-1} + u_t along dim 1 of f [B,T,C],
    for every u [..., B, T, C] at once: the reference's associative scan
    of the combine (f₂f₁, f₂u₁ + u₂), as a Hillis–Steele scan of ⌈log₂ T⌉
    steps."""
    t = f.shape[1]
    d = 1
    while d < t:
        u = torch.cat([u[..., :d, :], f[:, d:] * u[..., :-d, :] + u[..., d:, :]], dim=-2)
        f = torch.cat([f[:, :d], f[:, d:] * f[:, :-d]], dim=1)
        d *= 2
    return u


def slstm_scan(f: Tensor, i: Tensor, z: Tensor, o: Tensor,
               state: Optional[Tuple[Tensor, Tensor]] = None
               ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Parallel sLSTM over a sequence. All inputs [B,T,C]: f/i gates in
    (0,1), z cell input, o output gate. Returns y [B,T,C] and the final
    (c, n) state [B,C], both f32."""
    ff = f.float()
    u = (i * z).float()
    un = i.float()
    if state is not None:
        c0, n0 = state
        # fold the carried state into the first step's additive term
        u = torch.cat([u[:, :1] + ff[:, :1] * c0[:, None], u[:, 1:]], dim=1)
        un = torch.cat([un[:, :1] + ff[:, :1] * n0[:, None], un[:, 1:]], dim=1)
    c, n = _linrec_scan(ff, torch.stack([u, un]))
    y = o.float() * c / torch.clamp_min(n, 1.0)
    return y.to(z.dtype), (c[:, -1], n[:, -1])


def slstm_step(f: Tensor, i: Tensor, z: Tensor, o: Tensor,
               state: Tuple[Tensor, Tensor]) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Single-token sLSTM recurrence. Inputs [B,C]; state (c, n) [B,C]."""
    c0, n0 = state
    ff = f.float()
    c = ff * c0 + (i * z).float()
    n = ff * n0 + i.float()
    y = o.float() * c / torch.clamp_min(n, 1.0)
    return y.to(z.dtype), (c, n)
