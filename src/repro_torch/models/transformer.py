"""Model assembly (``repro.models.transformer``) for every family:
segments of identical pre-norm layers (GQA or MLA attention, then a dense
SwiGLU or the routed MoE), each a list of per-layer modules run by a
Python loop. The VLM runs groups of ``cross_attn_every`` self layers,
each group followed by one gated cross-attention layer over the projected
vision sequence; the audio encoder takes precomputed frames through a
linear frontend, attends without a causal mask and reads its logits off
the embedding. xLSTM (``ssm``) runs groups of one sLSTM block followed by
``slstm_every − 1`` mLSTM blocks; zamba2 (``hybrid``) runs groups of one
shared attention+MLP block (one set of weights, a KV cache per site)
followed by ``attn_every`` Mamba2 blocks, and a last site before the
remainder layers.

Four modes share the layer bodies:
  * train   — full-sequence forward with grad, no cache; each MoE layer
    also returns its load-balance statistics, and with ``remat`` each layer body
    runs under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
    around each scanned body)
  * forward — the same without grad or auxiliary loss (serving's encoder)
  * prefill — full-sequence forward that also fills the caches
  * decode  — single-token step against the caches

The parameter specs are the reference's tree, so counts and init match
it. The recurrent states (mLSTM, sLSTM, Mamba2) carry no position, as in
the reference; prefill and decode write them into the tensors that
``init_cache`` allocated, so a cache keeps its storage from prefill
through every decode step.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import operator
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.attention import TensorSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.models.moe import balance_loss, moe_ffn
from repro_torch.models.params import P_, ParamTree, init_param_, layer_names
from repro_torch.models.ssm import (
    GLAState, causal_conv1d, gla_chunked, gla_step, slstm_scan, slstm_step,
)

Tensor = torch.Tensor

PORTED_FAMILIES = ("dense", "audio", "moe", "ssm", "hybrid", "vlm")
# parameters outside the layer stacks, in the reference's tree order
_TOP_LEVEL = ("final_norm", "frontend", "embed", "lm_head", "w_vision")


def _norm_spec(cfg: ModelConfig, ld):
    return P_(ld + (cfg.d_model,), layer_names(ld) + ("embed",), init="ones", dtype=cfg.dtype)


def _mlp_specs(cfg: ModelConfig, ld, d_ff: int = 0) -> dict:
    ln = layer_names(ld)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w1": P_(ld + (d, f), ln + ("embed", "mlp"), dtype=cfg.dtype),
        "w3": P_(ld + (d, f), ln + ("embed", "mlp"), dtype=cfg.dtype),
        "w2": P_(ld + (f, d), ln + ("mlp", "embed"), dtype=cfg.dtype),
    }


def _moe_specs(cfg: ModelConfig, ld) -> dict:
    ln = layer_names(ld)
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    specs = {
        "router": P_(ld + (d, e), ln + ("embed", "experts"), dtype=cfg.dtype),
        "w1": P_(ld + (e, d, f), ln + ("experts", "embed", "expert_mlp"), dtype=cfg.dtype),
        "w3": P_(ld + (e, d, f), ln + ("experts", "embed", "expert_mlp"), dtype=cfg.dtype),
        "w2": P_(ld + (e, f, d), ln + ("experts", "expert_mlp", "embed"), dtype=cfg.dtype),
    }
    if m.n_shared:
        fs = m.n_shared * f
        specs["shared_w1"] = P_(ld + (d, fs), ln + ("embed", "mlp"), dtype=cfg.dtype)
        specs["shared_w3"] = P_(ld + (d, fs), ln + ("embed", "mlp"), dtype=cfg.dtype)
        specs["shared_w2"] = P_(ld + (fs, d), ln + ("mlp", "embed"), dtype=cfg.dtype)
    return specs


def body_kind(kind: str) -> Tuple[str, str]:
    """(attention kind, FFN kind) of a plan's body: ``gqa_mlp`` →
    (gqa, mlp), ``mla_moe`` → (mla, moe), ``gqa_mlp_dense`` → (gqa, mlp)."""
    a, f = kind.split("_")[:2]
    return a, f


def attn_mlp_specs(cfg: ModelConfig, kind: str, ld=(), d_ff: int = 0) -> dict:
    """A pre-norm layer: attn + (mlp | moe). The MLP is ``d_ff`` wide when
    given (zamba2's shared block), else a ``*_dense`` body takes the MoE
    config's ``d_ff_dense`` and any other ``cfg.d_ff``."""
    a, f = body_kind(kind)
    s = {"norm1": _norm_spec(cfg, ld),
         "attn": (attn.mla_specs if a == "mla" else attn.gqa_specs)(cfg, ld),
         "norm2": _norm_spec(cfg, ld)}
    if f == "moe":
        s["moe"] = _moe_specs(cfg, ld)
    else:
        s["mlp"] = _mlp_specs(cfg, ld, d_ff or (cfg.moe.d_ff_dense if kind.endswith("_dense")
                                                else 0))
    return s


def cross_specs(cfg: ModelConfig, ld=()) -> dict:
    """A gated cross-attention layer (VLM)."""
    return {"norm": _norm_spec(cfg, ld), "xattn": attn.cross_attn_specs(cfg, ld)}


def plan(cfg: ModelConfig) -> list[tuple[str, str, int]]:
    """The reference's segment plan: (segment name, body kind, layers),
    the dense-FFN layers of a ``moe`` config first; xLSTM, zamba2 and the
    VLM are one group segment each."""
    fam = cfg.family
    if fam not in PORTED_FAMILIES:
        raise ValueError(f"unknown model family {fam!r}; the families are {PORTED_FAMILIES}")
    if fam in ("dense", "audio"):
        return [("layers", "gqa_mlp", cfg.n_layers)]
    if fam in ("ssm", "hybrid", "vlm"):
        return [({"ssm": "xlstm", "hybrid": "zamba"}.get(fam, fam), "group", cfg.n_layers)]
    a = "mla" if cfg.mla else "gqa"
    segs = []
    nd = cfg.moe.first_dense_layers
    if nd:
        segs.append(("dense_layers", f"{a}_mlp_dense", nd))
    segs.append(("moe_layers", f"{a}_moe", cfg.n_layers - nd))
    return segs


def vlm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, self layers per group) of a VLM."""
    per = cfg.vlm.cross_attn_every
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.n_layers} layers are not groups of {per}")
    return cfg.n_layers // per, per


def xlstm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, mLSTM blocks per group) of xLSTM: each group is one sLSTM
    block and ``slstm_every − 1`` mLSTM blocks."""
    per = cfg.ssm.slstm_every or cfg.n_layers
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.n_layers} layers are not groups of {per}")
    return cfg.n_layers // per, per - 1


def zamba_groups(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(full groups, Mamba2 layers per group, remainder layers) of zamba2:
    a shared-attention site before each group, and one more before the
    remainder when there is one."""
    every = cfg.hybrid.attn_every
    full = cfg.n_layers // every
    return full, every, cfg.n_layers - full * every


def hybrid_attn_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config of zamba2's shared-attention sites: ``attn_window`` > 0
    gives them a sliding window (a ring cache)."""
    if cfg.hybrid.attn_window:
        return dataclasses.replace(cfg, sliding_window=cfg.hybrid.attn_window)
    return cfg


def model_specs(cfg: ModelConfig) -> dict:
    """The reference's parameter spec tree, segments stacked over layers
    (the VLM's self layers over [groups, per], its cross layers over
    [groups]; xLSTM's sLSTM blocks over [groups], its mLSTM blocks over
    [groups, per]; zamba2's Mamba2 blocks over [layers] and its shared
    block unstacked)."""
    d = cfg.d_model
    s: dict = {"final_norm": P_((d,), ("embed",), init="ones", dtype=cfg.dtype)}
    if cfg.frontend == "frames":
        s["frontend"] = P_((cfg.frontend_dim, d), ("vision", "embed"), dtype=cfg.dtype)
    s["embed"] = P_((cfg.vocab, d), ("vocab", "embed"), init="embed", dtype=cfg.dtype)
    if not cfg.tie_embeddings and not cfg.encoder_only:
        s["lm_head"] = P_((d, cfg.vocab), ("embed", "vocab"), dtype=cfg.dtype)
    if cfg.family == "vlm":
        g, per = vlm_groups(cfg)
        s["self_layers"] = attn_mlp_specs(cfg, "gqa_mlp", (g, per))
        s["cross_layers"] = cross_specs(cfg, (g,))
        s["w_vision"] = P_((cfg.vlm.vision_dim, d), ("vision", "embed"), dtype=cfg.dtype)
        return s
    if cfg.family == "ssm":
        g, per = xlstm_groups(cfg)
        s["slstm"] = slstm_specs(cfg, (g,))
        s["mlstm"] = mlstm_specs(cfg, (g, per))
        return s
    if cfg.family == "hybrid":
        s["mamba"] = mamba2_specs(cfg, (cfg.n_layers,))
        s["shared_attn"] = attn_mlp_specs(cfg, "gqa_mlp", d_ff=cfg.hybrid.shared_d_ff)
        return s
    for name, kind, n in plan(cfg):
        s[name] = attn_mlp_specs(cfg, kind, (n,))
    return s


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Per segment, the cache shapes stacked over its layers (the VLM's
    on its self layers only; an encoder has none; xLSTM's mLSTM states
    over [groups, per]; zamba2's KV caches over its attention sites)."""
    if cfg.encoder_only:
        return {}
    if cfg.family == "vlm":
        return {"self": attn.gqa_cache_spec(cfg, batch, max_seq, (cfg.n_layers,))}
    if cfg.family == "ssm":
        g, per = xlstm_groups(cfg)
        return {"slstm": slstm_cache_spec(cfg, batch, (g,)),
                "mlstm": mlstm_cache_spec(cfg, batch, (g, per))}
    if cfg.family == "hybrid":
        full, _, rem = zamba_groups(cfg)
        return {"attn": attn.gqa_cache_spec(hybrid_attn_cfg(cfg), batch, max_seq,
                                            (full + (1 if rem else 0),)),
                "mamba": mamba2_cache_spec(cfg, batch, (cfg.n_layers,))}
    return {name: (attn.mla_cache_spec if kind.startswith("mla") else attn.gqa_cache_spec)(
        cfg, batch, max_seq, (n,)) for name, kind, n in plan(cfg)}


class Block(ParamTree):
    """One pre-norm layer: GQA or MLA attention, then a dense SwiGLU or
    the routed MoE. Holds one layer's slice of its segment's stacked specs
    (``layer_dims`` leading dims dropped)."""

    def __init__(self, cfg: ModelConfig, specs: dict, kind: str, device: torch.device,
                 layer_dims: int = 1):
        super().__init__(specs, device, layer_dims=layer_dims)
        self.cfg = cfg
        self.attn_kind, self.ffn = body_kind(kind)

    def _attn(self, h: Tensor, cache, mode: str):
        p, cfg = self["attn"], self.cfg
        if self.attn_kind == "mla":
            if mode in ("forward", "train"):
                return attn.mla_forward(p, h, cfg), None
            if mode == "prefill":
                return attn.mla_prefill(p, h, cfg, cache)
            return attn.mla_decode(p, h, cfg, cache)
        if mode in ("forward", "train"):
            return attn.gqa_forward(p, h, cfg, causal=not cfg.encoder_only), None
        if mode == "prefill":
            return attn.gqa_prefill(p, h, cfg, cache)
        return attn.gqa_decode(p, h, cfg, cache)

    def forward(self, x: Tensor, cache, mode: str):
        """(x, cache); in train mode a MoE layer returns its load-balance
        statistics (``moe.load_balance_parts``) in the cache's place, as the
        reference's train body returns its loss."""
        cfg = self.cfg
        a, cache = self._attn(rms_norm(x, self["norm1"], cfg.norm_eps), cache, mode)
        x = x + a
        h = rms_norm(x, self["norm2"], cfg.norm_eps)
        if self.ffn == "moe" and mode == "train":
            y, aux = moe_ffn(h, self["moe"], cfg.moe, with_aux=True)
            return x + y, aux
        if self.ffn == "moe":
            x = x + moe_ffn(h, self["moe"], cfg.moe)
        else:
            mlp = self["mlp"]
            x = x + swiglu(h, mlp["w1"], mlp["w3"], mlp["w2"])
        return x, cache


class CrossBlock(ParamTree):
    """A VLM cross-attention site: x attends to the projected vision
    sequence; without one it passes x through. It holds no cache."""

    def __init__(self, cfg: ModelConfig, specs: dict, device: torch.device):
        super().__init__(specs, device, layer_dims=1)
        self.cfg = cfg

    def forward(self, x: Tensor, vision_kv: Optional[Tensor]) -> Tensor:
        if vision_kv is None:
            return x
        h = rms_norm(x, self["norm"], self.cfg.norm_eps)
        return x + attn.cross_attn(self["xattn"], h, vision_kv, self.cfg)


# ------------------------------- recurrent bodies ---------------------------


class SSMCache(NamedTuple):
    """One mLSTM or Mamba2 layer's state: the last K−1 conv inputs
    [B, K−1, di] in the model's dtype and the f32 GLA state."""
    conv: Tensor
    gla: GLAState


class SLSTMState(NamedTuple):
    """One sLSTM layer's f32 state, [B, d] each."""
    c: Tensor
    n: Tensor


def mlstm_specs(cfg: ModelConfig, ld=()) -> dict:
    ln = layer_names(ld)
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    h = cfg.n_heads
    dk = di // h
    return {
        "norm": _norm_spec(cfg, ld),
        "w_in": P_(ld + (d, 2 * di), ln + ("embed", "mlp"), dtype=cfg.dtype),
        "conv_w": P_(ld + (s.d_conv, di), ln + ("conv", "mlp"), scale=0.5, dtype=cfg.dtype),
        # block-diagonal per-head q/k projections (xLSTM style)
        "wq": P_(ld + (h, dk, dk), ln + ("heads", None, None), dtype=cfg.dtype),
        "wk": P_(ld + (h, dk, dk), ln + ("heads", None, None), dtype=cfg.dtype),
        "w_gate": P_(ld + (d, 2 * h), ln + ("embed", None), init="zeros", dtype=cfg.dtype),
        "f_bias": P_(ld + (h,), ln + (None,), init="ones", dtype=cfg.dtype),
        "w_down": P_(ld + (di, d), ln + ("mlp", "embed"), dtype=cfg.dtype),
    }


def mlstm_cache_spec(cfg: ModelConfig, batch: int, ld=()) -> SSMCache:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    h = cfg.n_heads
    dk = di // h
    return SSMCache(TensorSpec(ld + (batch, s.d_conv - 1, di), cfg.dtype),
                    GLAState(TensorSpec(ld + (batch, h, dk, dk), torch.float32),
                             TensorSpec(ld + (batch, h, dk), torch.float32)))


def slstm_specs(cfg: ModelConfig, ld=()) -> dict:
    ln = layer_names(ld)
    d = cfg.d_model
    return {
        "norm": _norm_spec(cfg, ld),
        "w_gates": P_(ld + (d, 4 * d), ln + ("embed", "mlp"), dtype=cfg.dtype),
        "w_out": P_(ld + (d, d), ln + ("embed", "embed_out"), dtype=cfg.dtype),
    }


def slstm_cache_spec(cfg: ModelConfig, batch: int, ld=()) -> SLSTMState:
    c = TensorSpec(ld + (batch, cfg.d_model), torch.float32)
    return SLSTMState(c, c)


def mamba2_specs(cfg: ModelConfig, ld=()) -> dict:
    ln = layer_names(ld)
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    h = di // s.head_dim
    return {
        "norm": _norm_spec(cfg, ld),
        "w_in": P_(ld + (d, 2 * di), ln + ("embed", "mlp"), dtype=cfg.dtype),
        "conv_w": P_(ld + (s.d_conv, di), ln + ("conv", "mlp"), scale=0.5, dtype=cfg.dtype),
        "w_B": P_(ld + (d, s.d_state), ln + ("embed", "state"), dtype=cfg.dtype),
        "w_C": P_(ld + (d, s.d_state), ln + ("embed", "state"), dtype=cfg.dtype),
        "w_dt": P_(ld + (d, h), ln + ("embed", "heads"), dtype=cfg.dtype),
        "dt_bias": P_(ld + (h,), ln + ("heads",), init="zeros", dtype=cfg.dtype),
        "A_log": P_(ld + (h,), ln + ("heads",), init="zeros", dtype=torch.float32),
        "D": P_(ld + (h,), ln + ("heads",), init="ones", dtype=torch.float32),
        "w_down": P_(ld + (di, d), ln + ("mlp", "embed"), dtype=cfg.dtype),
    }


def mamba2_cache_spec(cfg: ModelConfig, batch: int, ld=()) -> SSMCache:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    h = di // s.head_dim
    return SSMCache(TensorSpec(ld + (batch, s.d_conv - 1, di), cfg.dtype),
                    GLAState(TensorSpec(ld + (batch, h, s.d_state, s.head_dim), torch.float32),
                             TensorSpec(ld + (batch, h, s.d_state), torch.float32)))


def _store(cache, new):
    """Write ``new``'s tensors into ``cache``'s (same structure), so the
    cache keeps its storage; returns ``cache``."""
    for dst, src in zip(_leaves(cache, Tensor), _leaves(new, Tensor)):
        dst.copy_(src)
    return cache


def _leaves(tree, leaf_type):
    """The ``leaf_type`` leaves of a cache container (nested tuples), in
    order."""
    if isinstance(tree, leaf_type):
        yield tree
    else:
        for v in tree:
            yield from _leaves(v, leaf_type)


class _Recurrent(ParamTree):
    """A recurrent layer: holds one layer's slice of its segment's stacked
    specs (``layer_dims`` leading dims dropped). ``forward(x, cache, mode)``
    returns (x, cache): no cache in ``forward`` mode, else the given cache
    with the new state written into its tensors."""

    def __init__(self, cfg: ModelConfig, specs: dict, device: torch.device, layer_dims: int = 1):
        super().__init__(specs, device, layer_dims=layer_dims)
        self.cfg = cfg

    def _conv(self, u: Tensor, cache: Optional[SSMCache], mode: str) -> Tuple[Tensor, Tensor]:
        uc, conv = causal_conv1d(u, self["conv_w"], None if mode == "forward" else cache.conv)
        return F.silu(uc), conv

    def _gla(self, q, k, v, g, cache: Optional[SSMCache], mode: str, normalize: bool):
        if mode == "decode":
            y, gla = gla_step(q[:, 0], k[:, 0], v[:, 0], g[:, 0], cache.gla, normalize=normalize)
            return y[:, None], gla
        return gla_chunked(q, k, v, g, chunk=self.cfg.ssm.chunk,
                           state=None if mode == "forward" else cache.gla, normalize=normalize)


class MLSTMBlock(_Recurrent):
    """xLSTM's mLSTM block: in-projection, causal conv, per-head q/k, a
    sigmoid input gate folded into k, a log-sigmoid forget gate, the
    normalised GLA core and an output gate."""

    def __init__(self, cfg: ModelConfig, specs: dict, device: torch.device, layer_dims: int = 1):
        super().__init__(cfg, specs, device, layer_dims)
        self.dk = cfg.ssm.expand * cfg.d_model // cfg.n_heads
        # k is divided by √dk rounded to the model's dtype, as in the reference
        self.k_scale = torch.tensor(math.sqrt(self.dk)).to(cfg.dtype).item()

    def _qkvg(self, xn: Tensor, uc: Tensor, u: Tensor):
        h, dk = self.cfg.n_heads, self.dk
        lead = uc.shape[:-1]
        uh = uc.reshape(lead + (h, dk))
        q = torch.einsum("...hk,hkq->...hq", uh, self["wq"])
        k = torch.einsum("...hk,hkq->...hq", uh, self["wk"]) / self.k_scale
        v = u.reshape(lead + (h, dk))
        gates = (xn @ self["w_gate"]).float()
        i_raw, f_raw = gates.chunk(2, dim=-1)
        i = torch.sigmoid(i_raw)                                          # input gate
        g = F.logsigmoid(f_raw + self["f_bias"].float())                  # log forget
        return q, k * i[..., None].to(k.dtype), v, g

    def forward(self, x: Tensor, cache: Optional[SSMCache], mode: str):
        cfg = self.cfg
        xn = rms_norm(x, self["norm"], cfg.norm_eps)
        u, z = (xn @ self["w_in"]).chunk(2, dim=-1)
        uc, conv = self._conv(u, cache, mode)
        q, k, v, g = self._qkvg(xn, uc, u)
        y, gla = self._gla(q, k, v, g, cache, mode, normalize=True)
        out = y.reshape(y.shape[:2] + (-1,)) * F.silu(z)
        x = x + out @ self["w_down"]
        return x, None if mode == "forward" else _store(cache, SSMCache(conv, gla))


class SLSTMBlock(_Recurrent):
    """xLSTM's sLSTM block (head-diagonal): tanh cell input, sigmoid
    input, forget and output gates, the scanned (c, n) recurrence."""

    def forward(self, x: Tensor, cache: Optional[SLSTMState], mode: str):
        xn = rms_norm(x, self["norm"], self.cfg.norm_eps)
        zr, ir, fr, orr = (xn @ self["w_gates"]).chunk(4, dim=-1)
        z, i, f, o = torch.tanh(zr), torch.sigmoid(ir), torch.sigmoid(fr), torch.sigmoid(orr)
        if mode == "decode":
            y, state = slstm_step(f[:, 0], i[:, 0], z[:, 0], o[:, 0], cache)
            y = y[:, None]
        else:
            y, state = slstm_scan(f, i, z, o, None if mode == "forward" else cache)
        x = x + y.to(x.dtype) @ self["w_out"]
        return x, None if mode == "forward" else _store(cache, state)


class Mamba2Block(_Recurrent):
    """Mamba2 through the SSD mapping onto GLA: k = B and q = C shared by
    every head, a per-head decay g = softplus(x·w_dt + dt_bias)·(−e^{A_log}),
    v = the conv output scaled by dt, and the D skip."""

    def forward(self, x: Tensor, cache: Optional[SSMCache], mode: str):
        s = self.cfg.ssm
        xn = rms_norm(x, self["norm"], self.cfg.norm_eps)
        z, u = (xn @ self["w_in"]).chunk(2, dim=-1)
        uc, conv = self._conv(u, cache, mode)
        lead = uc.shape[:-1]
        h = uc.shape[-1] // s.head_dim
        bm, cm = xn @ self["w_B"], xn @ self["w_C"]
        dt = F.softplus((xn @ self["w_dt"]).float() + self["dt_bias"].float())
        g = dt * -torch.exp(self["A_log"])                      # log-decay ≤ 0, [.., h]
        uh = uc.reshape(lead + (h, s.head_dim))
        v = uh * dt[..., None].to(uc.dtype)
        k = bm[..., None, :].expand(lead + (h, s.d_state))
        q = cm[..., None, :].expand(lead + (h, s.d_state))
        y, gla = self._gla(q, k, v, g, cache, mode, normalize=False)
        y = y + uh * self["D"][:, None].to(uc.dtype)
        x = x + (y.reshape(lead + (-1,)) * F.silu(z)) @ self["w_down"]
        return x, None if mode == "forward" else _store(cache, SSMCache(conv, gla))


class LossParts(NamedTuple):
    """The train objective's sums over some rows of a batch
    (``Model.loss_parts``): what devices that split the rows exchange."""
    nll_sum: Tensor          # f32: Σ NLL over the labels ≥ 0
    tokens: Tensor           # f32: the count of labels ≥ 0
    routed: int              # tokens each MoE layer routed: rows × sequence
    counts: Tuple[Tensor, ...]    # per MoE layer: top-1 counts [E], no gradient
    p_mean: Tuple[Tensor, ...]    # per MoE layer: mean router probability [E]


def loss_from_parts(parts: Sequence[LossParts], cfg: ModelConfig,
                    moe_aux_coeff: float = 0.01) -> Tuple[Tensor, dict]:
    """The train objective of the rows of every part, as ``Model.loss``
    returns it, each sum folded left to right in part order: the NLL the
    mean over every part's labels ≥ 0; each MoE layer's aux from the
    folded counts and the routed-weighted fold of the parts' means. The
    gradient flows into the parts that carry one: with every part but one
    detached, it is that part's rows' share of the whole objective's
    gradient, and the shares sum to it."""
    fold = functools.partial(functools.reduce, operator.add)
    tokens = fold([p.tokens for p in parts])
    nll = fold([p.nll_sum for p in parts]) / torch.clamp_min(tokens, 1.0)
    routed = sum(p.routed for p in parts)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for j in range(len(parts[0].counts)):
        counts = fold([p.counts[j] for p in parts])
        p_mean = fold([(p.routed / routed) * p.p_mean[j] for p in parts])
        aux = aux + balance_loss(counts, p_mean, cfg.moe.n_experts).float()
    total = nll + moe_aux_coeff * aux
    return total, {"loss": nll, "moe_aux": aux, "tokens": tokens}


class Model(nn.Module):
    """A model of a ported family. Parameters are allocated on ``device``
    (the CUDA card unless named; with no card and no ``device=`` the
    constructor raises) and filled by ``init`` or ``load_state_dict``;
    they are made with ``requires_grad`` off, and
    ``train.train_loop.init_train_state`` turns it on.
    Public API: init / forward / forward_with_aux / loss / loss_parts / cache_specs /
    init_cache / vision_kv / prefill / decode. ``forward``, ``prefill``,
    ``decode`` and ``vision_kv`` run without grad; ``forward_with_aux``,
    ``loss`` and ``loss_parts`` are the train mode."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = plan(cfg)
        specs = model_specs(cfg)
        self.specs = specs
        for name in _TOP_LEVEL:
            if name in specs:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(specs[name].shape, dtype=specs[name].dtype, device=self.device),
                    requires_grad=False))
        if cfg.family == "vlm":
            g, per = vlm_groups(cfg)
            self.self_layers = nn.ModuleList(
                [Block(cfg, specs["self_layers"], "gqa_mlp", self.device, layer_dims=2)
                 for _ in range(g * per)])
            self.cross_layers = nn.ModuleList(
                [CrossBlock(cfg, specs["cross_layers"], self.device) for _ in range(g)])
            self.stacks = ("self_layers", "cross_layers")
        elif cfg.family == "ssm":
            g, per = xlstm_groups(cfg)
            self.slstm = nn.ModuleList(
                [SLSTMBlock(cfg, specs["slstm"], self.device) for _ in range(g)])
            self.mlstm = nn.ModuleList(
                [MLSTMBlock(cfg, specs["mlstm"], self.device, layer_dims=2)
                 for _ in range(g * per)])
            self.stacks = ("slstm", "mlstm")
        elif cfg.family == "hybrid":
            self.shared_attn = Block(hybrid_attn_cfg(cfg), specs["shared_attn"], "gqa_mlp",
                                     self.device, layer_dims=0)
            self.mamba = nn.ModuleList(
                [Mamba2Block(cfg, specs["mamba"], self.device) for _ in range(cfg.n_layers)])
            self.stacks = ("shared_attn", "mamba")
        else:
            for name, kind, n in self.segments:
                self.add_module(name, nn.ModuleList(
                    [Block(cfg, specs[name], kind, self.device) for _ in range(n)]))
            self.stacks = tuple(name for name, _, _ in self.segments)

    def stack_modules(self):
        """(name, layers) of each layer stack: a ModuleList, or zamba2's
        one shared block as a list of one."""
        for name in self.stacks:
            m = self.get_submodule(name)
            yield name, m if isinstance(m, nn.ModuleList) else [m]

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None, *, seed: int = 0) -> "Model":
        """Fill every parameter by its spec's rule, layer by layer, from
        ``generator`` (a generator on the model's device seeded with
        ``seed`` when none is given)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        for name in _TOP_LEVEL:
            if name in self.specs:
                init_param_(getattr(self, name), self.specs[name], generator)
        for _, blocks in self.stack_modules():
            for block in blocks:
                block.init_(generator)
        return self

    # ---- embedding / head ------------------------------------------------

    def _embed_in(self, tokens: Optional[Tensor], frames: Optional[Tensor] = None) -> Tensor:
        if self.cfg.frontend == "frames":
            return frames.to(self.cfg.dtype) @ self.frontend
        return self.embed[tokens]

    def _head(self, x: Tensor) -> Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if cfg.encoder_only:
            return x @ self.embed.T
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        return x @ w

    def _vision_kv(self, image_embeds: Optional[Tensor]) -> Optional[Tensor]:
        if self.cfg.family != "vlm" or image_embeds is None:
            return None
        return image_embeds.to(self.cfg.dtype) @ self.w_vision

    @torch.no_grad()
    def vision_kv(self, image_embeds: Optional[Tensor]) -> Optional[Tensor]:
        """The vision sequence projected to d_model, [B, Sv, D]: the k/v
        source of every cross layer (None unless a VLM is given
        ``image_embeds`` [B, Sv, vision_dim])."""
        return self._vision_kv(image_embeds)

    @staticmethod
    def _layer(mode: str, remat: bool):
        """The call of one layer body, ``(layer, x, cache) -> (x, cache)``:
        in train mode the recurrent blocks run their ``forward`` mode, and
        with ``remat`` every body runs under a non-reentrant checkpoint."""
        if mode != "train":
            return lambda layer, x, cache: layer(x, cache, mode)

        def call(layer, x, cache):
            m = "train" if isinstance(layer, Block) else "forward"
            return checkpoint(layer, x, None, m, use_reentrant=False) if remat else layer(x, None, m)
        return call

    def _run_stack(self, x: Tensor, caches: dict | None, mode: str,
                   vision_kv: Optional[Tensor] = None, remat: bool = False):
        run = self._layer(mode, remat)
        if self.cfg.family == "vlm":
            g, per = vlm_groups(self.cfg)
            seg = []
            for gi in range(g):
                for i in range(gi * per, (gi + 1) * per):
                    x, c = run(self.self_layers[i], x,
                               None if caches is None else caches["self"][i])
                    seg.append(c)
                cross = self.cross_layers[gi]
                x = (checkpoint(cross, x, vision_kv, use_reentrant=False)
                     if remat and mode == "train" else cross(x, vision_kv))
            return x, {"self": seg}
        if self.cfg.family == "ssm":
            return self._run_xlstm(x, caches, run)
        if self.cfg.family == "hybrid":
            return self._run_zamba(x, caches, run)
        new_caches = {}
        for name, blocks in self.stack_modules():
            seg = []
            for i, block in enumerate(blocks):
                x, c = run(block, x, None if caches is None else caches[name][i])
                seg.append(c)
            new_caches[name] = seg
        return x, new_caches

    def _run_xlstm(self, x: Tensor, caches: dict | None, run):
        """Each group: its sLSTM block, then its mLSTM blocks."""
        g, per = xlstm_groups(self.cfg)
        new = {"slstm": [], "mlstm": []}
        for gi in range(g):
            x, c = run(self.slstm[gi], x, None if caches is None else caches["slstm"][gi])
            new["slstm"].append(c)
            for i in range(gi * per, (gi + 1) * per):
                x, c = run(self.mlstm[i], x, None if caches is None else caches["mlstm"][i])
                new["mlstm"].append(c)
        return x, new

    def _run_zamba(self, x: Tensor, caches: dict | None, run):
        """Each group: the shared block at its own site (its own KV cache),
        then ``attn_every`` Mamba2 layers; a remainder gets one more site
        before its layers."""
        full, every, rem = zamba_groups(self.cfg)
        starts = [gi * every for gi in range(full)] + ([full * every] if rem else [])
        new = {"attn": [], "mamba": []}
        for site, lo in enumerate(starts):
            x, c = run(self.shared_attn, x, None if caches is None else caches["attn"][site])
            new["attn"].append(c)
            for i in range(lo, min(lo + every, self.cfg.n_layers)):
                x, c = run(self.mamba[i], x, None if caches is None else caches["mamba"][i])
                new["mamba"].append(c)
        return x, new

    # ---- public API --------------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens: Optional[Tensor] = None, *, frames: Optional[Tensor] = None,
                image_embeds: Optional[Tensor] = None) -> Tensor:
        """Full-sequence logits [B, T, V] (no cache, no auxiliary loss),
        from ``tokens`` [B, T] or, for a frames frontend, ``frames``
        [B, T, frontend_dim]."""
        x, _ = self._run_stack(self._embed_in(tokens, frames), None, "forward",
                               self.vision_kv(image_embeds))
        return self._head(x)

    def _train_forward(self, tokens, frames, image_embeds, remat: bool):
        """Train mode: (logits [B, T, V], each MoE layer's load-balance
        statistics in layer order)."""
        x, extras = self._run_stack(self._embed_in(tokens, frames), None, "train",
                                    self._vision_kv(image_embeds), remat)
        stats = [a for seg in extras.values() for a in seg if a is not None]
        return self._head(x), stats

    def forward_with_aux(self, tokens: Optional[Tensor] = None, *,
                         frames: Optional[Tensor] = None,
                         image_embeds: Optional[Tensor] = None,
                         remat: bool = False) -> Tuple[Tensor, Tensor]:
        """Train mode: (logits [B, T, V], aux), with grad. ``aux`` is the
        f32 sum of every MoE layer's load-balance loss (0 without MoE);
        the VLM projects ``image_embeds`` with grad. ``remat`` recomputes
        each layer body in the backward instead of keeping its
        activations."""
        logits, stats = self._train_forward(tokens, frames, image_embeds, remat)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        for counts, p_mean in stats:
            aux = aux + balance_loss(counts, p_mean, self.cfg.moe.n_experts).float()
        return logits, aux

    def loss_parts(self, batch: dict, remat: bool = False) -> "LossParts":
        """The sums of the train objective over ``batch``'s rows, with
        grad, as ``loss_from_parts`` folds them: ``batch`` as for
        ``loss``."""
        logits, stats = self._train_forward(
            batch.get("tokens"), batch.get("frames"), batch.get("image_embeds"), remat)
        logits = logits.float()
        labels = batch["labels"]
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
        mask = (labels >= 0).float()
        return LossParts(torch.sum((lse - ll) * mask), torch.sum(mask), labels.numel(),
                         tuple(c for c, _ in stats), tuple(p for _, p in stats))

    def loss(self, batch: dict, remat: bool = False,
             moe_aux_coeff: float = 0.01) -> Tuple[Tensor, dict]:
        """The train objective: (total, {"loss", "moe_aux", "tokens"}), total
        = NLL + ``moe_aux_coeff``·aux. ``batch`` holds ``tokens`` [B, T]
        (or ``frames``), ``labels`` [B, T] and, for a VLM, optionally
        ``image_embeds``; the NLL is the mean over the labels ≥ 0, from
        f32 logits."""
        return loss_from_parts([self.loss_parts(batch, remat)], self.cfg, moe_aux_coeff)

    def cache_specs(self, batch: int, max_seq: int) -> dict:
        return cache_specs(self.cfg, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int) -> dict:
        """Zero caches on the model's device: per segment, one cache per
        layer or site (``MLACache``, ``KVCache`` or ``QuantKVCache`` at
        position 0; ``SSMCache`` or ``SLSTMState``, which have none). The
        mLSTM states, stacked [groups, per], come group-major."""
        out = {}
        for name, spec in self.cache_specs(batch, max_seq).items():
            lead = 2 if name == "mlstm" else 1
            n = math.prod(next(_leaves(spec, TensorSpec)).shape[:lead])
            out[name] = [_zero_cache(spec, lead, self.device) for _ in range(n)]
        return out

    @torch.no_grad()
    def prefill(self, tokens: Optional[Tensor] = None, cache: dict | None = None, *,
                frames: Optional[Tensor] = None,
                image_embeds: Optional[Tensor] = None) -> Tuple[Tensor, dict]:
        """Process a prompt [B, T], filling the caches in place. Returns
        (last-token logits [B, V], cache). An encoder has no cache: its
        prefill is the forward, returning the full logits and ``{}``."""
        if self.cfg.encoder_only:
            return self.forward(tokens, frames=frames), {}
        x, new_cache = self._run_stack(self._embed_in(tokens, frames), cache, "prefill",
                                       self.vision_kv(image_embeds))
        return self._head(x[:, -1:])[:, 0], new_cache

    @torch.no_grad()
    def decode(self, token: Tensor, cache: dict,
               vision_kv: Optional[Tensor] = None) -> Tuple[Tensor, dict]:
        """One decode step. token [B, 1] int; ``vision_kv`` [B, Sv, D] (a
        VLM's ``vision_kv(image_embeds)``). Returns (logits [B, V], cache)."""
        x, new_cache = self._run_stack(self.embed[token], cache, "decode", vision_kv)
        return self._head(x)[:, 0], new_cache


def _zero_cache(spec, lead: int, device: torch.device):
    """One layer's cache from a stacked spec container: zero tensors
    without the ``lead`` layer dims, and a ``pos`` field at 0."""
    if isinstance(spec, TensorSpec):
        return torch.zeros(spec.shape[lead:], dtype=spec.dtype, device=device)
    return type(spec)(*(0 if f == "pos" else _zero_cache(v, lead, device)
                        for f, v in zip(spec._fields, spec)))


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model for ``cfg`` with its parameters allocated on ``device``;
    raises for an unknown family."""
    plan(cfg)
    return Model(cfg, device)
