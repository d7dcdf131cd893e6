"""Model assembly (``repro.models.transformer``) for the ``moe`` family
with MLA attention (DeepSeek-V2-Lite): a leading segment of dense-FFN
layers and a segment of routed-MoE layers, each a list of per-layer
modules run by a Python loop.

Three modes share the layer bodies:
  * forward — full-sequence logits, no cache (the reference's train mode)
  * prefill — full-sequence forward that also fills the caches
  * decode  — single-token step against the caches

The parameter specs are the reference's tree, so counts and init match
it; ``build_model`` raises for the families not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.attention import MLACache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import P_, ParamTree, init_param_

Tensor = torch.Tensor

PORTED_FAMILIES = ("moe",)


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


def attn_mlp_specs(cfg: ModelConfig, ffn: str, ld=(), d_ff_dense: int = 0) -> dict:
    """A pre-norm MLA layer: attn + (mlp | moe)."""
    s = {"norm1": _norm_spec(cfg, ld), "attn": attn.mla_specs(cfg, ld),
         "norm2": _norm_spec(cfg, ld)}
    if ffn == "moe":
        s["moe"] = _moe_specs(cfg, ld)
    else:
        s["mlp"] = _mlp_specs(cfg, ld, d_ff_dense)
    return s


def plan(cfg: ModelConfig) -> list[tuple[str, str, int]]:
    """(segment name, FFN kind, layers): the dense-FFN layers first."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md §1: the rest of the LM stack)")
    if cfg.mla is None:
        raise NotImplementedError("GQA attention is not ported yet (ROADMAP.md §1)")
    segs = []
    nd = cfg.moe.first_dense_layers
    if nd:
        segs.append(("dense_layers", "mlp", nd))
    segs.append(("moe_layers", "moe", cfg.n_layers - nd))
    return segs


def model_specs(cfg: ModelConfig) -> dict:
    """The reference's parameter spec tree, segments stacked over layers."""
    d = cfg.d_model
    s: dict = {"final_norm": P_((d,), init="ones", dtype=cfg.dtype),
               "embed": P_((cfg.vocab, d), init="embed", dtype=cfg.dtype)}
    if not cfg.tie_embeddings and not cfg.encoder_only:
        s["lm_head"] = P_((d, cfg.vocab), dtype=cfg.dtype)
    for name, ffn, n in plan(cfg):
        s[name] = attn_mlp_specs(cfg, ffn, (n,), cfg.moe.d_ff_dense)
    return s


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """Per segment, the MLA cache shapes stacked over its layers."""
    return {name: attn.mla_cache_spec(cfg, batch, max_seq, (n,))
            for name, _, n in plan(cfg)}


class Block(ParamTree):
    """One pre-norm layer: MLA attention, then a dense SwiGLU or the
    routed MoE. Holds one layer's slice of its segment's stacked specs."""

    def __init__(self, cfg: ModelConfig, specs: dict, ffn: str, device: torch.device):
        super().__init__(specs, device, layer_dims=1)
        self.cfg = cfg
        self.ffn = ffn

    def forward(self, x: Tensor, cache: MLACache | None, mode: str):
        cfg = self.cfg
        h = rms_norm(x, self["norm1"], cfg.norm_eps)
        if mode == "forward":
            a = attn.mla_forward(self["attn"], h, cfg)
        elif mode == "prefill":
            a, cache = attn.mla_prefill(self["attn"], h, cfg, cache)
        else:
            a, cache = attn.mla_decode(self["attn"], h, cfg, cache)
        x = x + a
        h = rms_norm(x, self["norm2"], cfg.norm_eps)
        if self.ffn == "moe":
            x = x + moe_ffn(h, self["moe"], cfg.moe)
        else:
            mlp = self["mlp"]
            x = x + swiglu(h, mlp["w1"], mlp["w3"], mlp["w2"])
        return x, cache


class Model(nn.Module):
    """The ``moe`` family model. Parameters are allocated on ``device``
    (the CUDA card unless named; with no card and no ``device=`` the
    constructor raises) and filled by ``init`` or ``load_state_dict``.
    Public API: init / forward / cache_specs / init_cache / prefill /
    decode."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = plan(cfg)
        specs = model_specs(cfg)
        self.specs = specs
        for name in ("final_norm", "embed", "lm_head"):
            if name in specs:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(specs[name].shape, dtype=specs[name].dtype, device=self.device),
                    requires_grad=False))
        for name, ffn, n in self.segments:
            self.add_module(name, nn.ModuleList(
                [Block(cfg, specs[name], ffn, self.device) for _ in range(n)]))

    def layers(self):
        for name, _, _ in self.segments:
            yield name, self.get_submodule(name)

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None, *, seed: int = 0) -> "Model":
        """Fill every parameter by its spec's rule, layer by layer, from
        ``generator`` (a generator on the model's device seeded with
        ``seed`` when none is given)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        for name in ("final_norm", "embed", "lm_head"):
            if name in self.specs:
                init_param_(getattr(self, name), self.specs[name], generator)
        for _, blocks in self.layers():
            for block in blocks:
                block.init_(generator)
        return self

    # ---- embedding / head ------------------------------------------------

    def _embed_in(self, tokens: Tensor) -> Tensor:
        return self.embed[tokens]

    def _head(self, x: Tensor) -> Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ w

    def _run_stack(self, x: Tensor, caches: dict | None, mode: str):
        new_caches = {}
        for name, blocks in self.layers():
            seg = []
            for i, block in enumerate(blocks):
                x, c = block(x, None if caches is None else caches[name][i], mode)
                seg.append(c)
            new_caches[name] = seg
        return x, new_caches

    # ---- public API --------------------------------------------------------

    @torch.no_grad()
    def forward(self, tokens: Tensor) -> Tensor:
        """Full-sequence logits [B, T, V] (no cache, no auxiliary loss)."""
        x, _ = self._run_stack(self._embed_in(tokens), None, "forward")
        return self._head(x)

    def cache_specs(self, batch: int, max_seq: int) -> dict:
        return cache_specs(self.cfg, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int) -> dict:
        """Zero caches on the model's device: per segment, one
        ``MLACache`` per layer at position 0."""
        out = {}
        for name, spec in self.cache_specs(batch, max_seq).items():
            n = spec.pos.shape[0]
            out[name] = [MLACache(torch.zeros(spec.c_kv.shape[1:], dtype=spec.c_kv.dtype,
                                              device=self.device),
                                  torch.zeros(spec.k_rope.shape[1:], dtype=spec.k_rope.dtype,
                                              device=self.device), 0)
                         for _ in range(n)]
        return out

    @torch.no_grad()
    def prefill(self, tokens: Tensor, cache: dict) -> Tuple[Tensor, dict]:
        """Process a prompt [B, T], filling the caches in place. Returns
        (last-token logits [B, V], cache)."""
        x, new_cache = self._run_stack(self._embed_in(tokens), cache, "prefill")
        return self._head(x[:, -1:])[:, 0], new_cache

    @torch.no_grad()
    def decode(self, token: Tensor, cache: dict) -> Tuple[Tensor, dict]:
        """One decode step. token [B, 1] int. Returns (logits [B, V], cache)."""
        x, new_cache = self._run_stack(self._embed_in(token), cache, "decode")
        return self._head(x)[:, 0], new_cache


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model for ``cfg`` with its parameters allocated on ``device``;
    raises for a family that is not ported yet."""
    plan(cfg)
    return Model(cfg, device)
