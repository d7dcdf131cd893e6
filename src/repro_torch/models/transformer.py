"""Model assembly (``repro.models.transformer``) for the ``dense``,
``audio``, ``moe`` and ``vlm`` families: segments of identical pre-norm
layers (GQA or MLA attention, then a dense SwiGLU or the routed MoE), each
a list of per-layer modules run by a Python loop. The VLM runs groups of
``cross_attn_every`` self layers, each group followed by one gated
cross-attention layer over the projected vision sequence; the audio
encoder takes precomputed frames through a linear frontend, attends
without a causal mask and reads its logits off the embedding.

Three modes share the layer bodies:
  * forward — full-sequence logits, no cache (the reference's train mode)
  * prefill — full-sequence forward that also fills the caches
  * decode  — single-token step against the caches

The parameter specs are the reference's tree, so counts and init match
it; ``build_model`` raises for the families not ported yet (ssm, hybrid).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import P_, ParamTree, init_param_

Tensor = torch.Tensor

PORTED_FAMILIES = ("dense", "audio", "moe", "vlm")
# parameters outside the layer stacks, in the reference's tree order
_TOP_LEVEL = ("final_norm", "frontend", "embed", "lm_head", "w_vision")


def _norm_spec(cfg: ModelConfig, ld):
    return P_(ld + (cfg.d_model,), init="ones", dtype=cfg.dtype)


def _mlp_specs(cfg: ModelConfig, ld, d_ff: int = 0) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w1": P_(ld + (d, f), dtype=cfg.dtype),
        "w3": P_(ld + (d, f), dtype=cfg.dtype),
        "w2": P_(ld + (f, d), dtype=cfg.dtype),
    }


def _moe_specs(cfg: ModelConfig, ld) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    specs = {
        "router": P_(ld + (d, e), dtype=cfg.dtype),
        "w1": P_(ld + (e, d, f), dtype=cfg.dtype),
        "w3": P_(ld + (e, d, f), dtype=cfg.dtype),
        "w2": P_(ld + (e, f, d), dtype=cfg.dtype),
    }
    if m.n_shared:
        fs = m.n_shared * f
        specs["shared_w1"] = P_(ld + (d, fs), dtype=cfg.dtype)
        specs["shared_w3"] = P_(ld + (d, fs), dtype=cfg.dtype)
        specs["shared_w2"] = P_(ld + (fs, d), dtype=cfg.dtype)
    return specs


def body_kind(kind: str) -> Tuple[str, str]:
    """(attention kind, FFN kind) of a plan's body: ``gqa_mlp`` →
    (gqa, mlp), ``mla_moe`` → (mla, moe), ``gqa_mlp_dense`` → (gqa, mlp)."""
    a, f = kind.split("_")[:2]
    return a, f


def attn_mlp_specs(cfg: ModelConfig, kind: str, ld=()) -> dict:
    """A pre-norm layer: attn + (mlp | moe); a ``*_dense`` body takes the
    MoE config's ``d_ff_dense``."""
    a, f = body_kind(kind)
    s = {"norm1": _norm_spec(cfg, ld),
         "attn": (attn.mla_specs if a == "mla" else attn.gqa_specs)(cfg, ld),
         "norm2": _norm_spec(cfg, ld)}
    if f == "moe":
        s["moe"] = _moe_specs(cfg, ld)
    else:
        s["mlp"] = _mlp_specs(cfg, ld, cfg.moe.d_ff_dense if kind.endswith("_dense") else 0)
    return s


def cross_specs(cfg: ModelConfig, ld=()) -> dict:
    """A gated cross-attention layer (VLM)."""
    return {"norm": _norm_spec(cfg, ld), "xattn": attn.cross_attn_specs(cfg, ld)}


def plan(cfg: ModelConfig) -> list[tuple[str, str, int]]:
    """The reference's segment plan: (segment name, body kind, layers),
    the dense-FFN layers of a ``moe`` config first; the VLM is one group
    segment."""
    fam = cfg.family
    if fam not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {fam!r} is not ported yet (ROADMAP.md §1: the rest of the LM stack)")
    if fam in ("dense", "audio"):
        return [("layers", "gqa_mlp", cfg.n_layers)]
    if fam == "vlm":
        return [("vlm", "group", cfg.n_layers)]
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


def model_specs(cfg: ModelConfig) -> dict:
    """The reference's parameter spec tree, segments stacked over layers
    (the VLM's self layers over [groups, per], its cross layers over
    [groups])."""
    d = cfg.d_model
    s: dict = {"final_norm": P_((d,), init="ones", dtype=cfg.dtype)}
    if cfg.frontend == "frames":
        s["frontend"] = P_((cfg.frontend_dim, d), dtype=cfg.dtype)
    s["embed"] = P_((cfg.vocab, d), init="embed", dtype=cfg.dtype)
    if not cfg.tie_embeddings and not cfg.encoder_only:
        s["lm_head"] = P_((d, cfg.vocab), dtype=cfg.dtype)
    if cfg.family == "vlm":
        g, per = vlm_groups(cfg)
        s["self_layers"] = attn_mlp_specs(cfg, "gqa_mlp", (g, per))
        s["cross_layers"] = cross_specs(cfg, (g,))
        s["w_vision"] = P_((cfg.vlm.vision_dim, d), dtype=cfg.dtype)
        return s
    for name, kind, n in plan(cfg):
        s[name] = attn_mlp_specs(cfg, kind, (n,))
    return s


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Per segment, the cache shapes stacked over its layers (the VLM's
    on its self layers only; an encoder has none)."""
    if cfg.encoder_only:
        return {}
    if cfg.family == "vlm":
        return {"self": attn.gqa_cache_spec(cfg, batch, max_seq, (cfg.n_layers,))}
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
            if mode == "forward":
                return attn.mla_forward(p, h, cfg), None
            if mode == "prefill":
                return attn.mla_prefill(p, h, cfg, cache)
            return attn.mla_decode(p, h, cfg, cache)
        if mode == "forward":
            return attn.gqa_forward(p, h, cfg, causal=not cfg.encoder_only), None
        if mode == "prefill":
            return attn.gqa_prefill(p, h, cfg, cache)
        return attn.gqa_decode(p, h, cfg, cache)

    def forward(self, x: Tensor, cache, mode: str):
        cfg = self.cfg
        a, cache = self._attn(rms_norm(x, self["norm1"], cfg.norm_eps), cache, mode)
        x = x + a
        h = rms_norm(x, self["norm2"], cfg.norm_eps)
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


class Model(nn.Module):
    """A model of a ported family. Parameters are allocated on ``device``
    (the CUDA card unless named; with no card and no ``device=`` the
    constructor raises) and filled by ``init`` or ``load_state_dict``.
    Public API: init / forward / cache_specs / init_cache / vision_kv /
    prefill / decode."""

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
        else:
            for name, kind, n in self.segments:
                self.add_module(name, nn.ModuleList(
                    [Block(cfg, specs[name], kind, self.device) for _ in range(n)]))
            self.stacks = tuple(name for name, _, _ in self.segments)

    def stack_modules(self):
        """(name, ModuleList) of each layer stack, in run order."""
        for name in self.stacks:
            yield name, self.get_submodule(name)

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

    @torch.no_grad()
    def vision_kv(self, image_embeds: Optional[Tensor]) -> Optional[Tensor]:
        """The vision sequence projected to d_model, [B, Sv, D]: the k/v
        source of every cross layer (None unless a VLM is given
        ``image_embeds`` [B, Sv, vision_dim])."""
        if self.cfg.family != "vlm" or image_embeds is None:
            return None
        return image_embeds.to(self.cfg.dtype) @ self.w_vision

    def _run_stack(self, x: Tensor, caches: dict | None, mode: str,
                   vision_kv: Optional[Tensor] = None):
        if self.cfg.family == "vlm":
            g, per = vlm_groups(self.cfg)
            seg = []
            for gi in range(g):
                for i in range(gi * per, (gi + 1) * per):
                    x, c = self.self_layers[i](x, None if caches is None else caches["self"][i],
                                               mode)
                    seg.append(c)
                x = self.cross_layers[gi](x, vision_kv)
            return x, {"self": seg}
        new_caches = {}
        for name, blocks in self.stack_modules():
            seg = []
            for i, block in enumerate(blocks):
                x, c = block(x, None if caches is None else caches[name][i], mode)
                seg.append(c)
            new_caches[name] = seg
        return x, new_caches

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

    def cache_specs(self, batch: int, max_seq: int) -> dict:
        return cache_specs(self.cfg, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int) -> dict:
        """Zero caches on the model's device: per segment, one cache per
        layer (``MLACache``, ``KVCache`` or ``QuantKVCache``) at
        position 0."""
        out = {}
        for name, spec in self.cache_specs(batch, max_seq).items():
            out[name] = [type(spec)(*(torch.zeros(f.shape[1:], dtype=f.dtype, device=self.device)
                                      for f in spec[:-1]), 0)
                         for _ in range(spec.pos.shape[0])]
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


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model for ``cfg`` with its parameters allocated on ``device``;
    raises for a family that is not ported yet."""
    plan(cfg)
    return Model(cfg, device)
