"""Batched LM serving (``repro.serve.engine``): the prefill and decode
steps and a static-batch request loop.

``ServingEngine.run`` left-pads the prompts to the longest (padding is not
masked, and RoPE positions start at the cache position, as in the
reference), prefills once, then decodes greedily until every request has
its token budget or hit EOS. It takes one host sync per decode step, to
read the new tokens. Its requests are token prompts only, as the
reference's are: a VLM serves them with no vision sequence (its cross
layers pass through); ``make_prefill_step`` and ``make_serve_step`` take
``image_embeds`` and ``vision_kv``. ``serve_shardings`` gives the
parameter, cache and token shardings of the reference's jitted steps on
a mesh; the engine itself takes no mesh, as the reference's takes none.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.distributed.sharding import NamedSharding, batch_axes, param_shardings
from repro_torch.models.transformer import Model, model_specs
from repro_torch.serve.kv_cache import cache_shardings


def make_prefill_step(model: Model):
    """(tokens [B, T], cache, [image_embeds], [frames]) -> (last-token
    logits [B, V], cache); an encoder takes ``frames`` [B, T, frontend_dim]
    and returns its full logits and ``{}``."""

    def prefill_step(tokens, cache, image_embeds=None, frames=None):
        return model.prefill(tokens, cache, frames=frames, image_embeds=image_embeds)

    return prefill_step


def make_serve_step(model: Model):
    """(token [B, 1], cache, [vision_kv]) -> (next token [B, 1] int32,
    logits, cache)."""

    def serve_step(token, cache, vision_kv=None):
        logits, cache = model.decode(token, cache, vision_kv=vision_kv)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step


def serve_shardings(mesh, model: Model, batch: int, max_seq: int):
    """(param, cache, token) shardings of the prefill and decode steps."""
    p_sh = param_shardings(mesh, model_specs(model.cfg))
    c_sh = cache_shardings(mesh, model.cfg, batch, max_seq)
    return p_sh, c_sh, NamedSharding(mesh, (batch_axes(mesh) or None, None))


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    generated: Optional[List[int]] = None


class ServingEngine:
    """Static-batch engine on ``device`` (the CUDA card unless named; with
    no card and no ``device=`` it raises), which must be the model's."""

    def __init__(self, model: Model, max_seq: int = 512, eos_id: int = -1, device=None):
        self.device = resolve_device(device)
        if model.embed.device.type != self.device.type:
            raise ValueError(f"the model is on {model.device}, the engine on {self.device}")
        self.model = model
        self.max_seq = max_seq
        self.eos_id = eos_id
        self._prefill = make_prefill_step(model)
        self._decode = make_serve_step(model)

    def run(self, requests: List[Request]) -> List[Request]:
        b = len(requests)
        lens = [len(r.prompt) for r in requests]
        toks = np.zeros((b, max(lens)), np.int32)
        for i, r in enumerate(requests):
            toks[i, -lens[i]:] = r.prompt      # left-pad so last token aligns
        cache = self.model.init_cache(b, self.max_seq)
        logits, cache = self._prefill(torch.from_numpy(toks).to(self.device), cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out = [[t] for t in tok[:, 0].tolist()]
        budget = max(r.max_new_tokens for r in requests)
        done = np.zeros(b, bool)
        for _ in range(budget - 1):
            tok, logits, cache = self._decode(tok, cache)
            t_host = tok[:, 0].cpu().numpy()
            for i in range(b):
                if not done[i] and len(out[i]) < requests[i].max_new_tokens:
                    out[i].append(int(t_host[i]))
                    if t_host[i] == self.eos_id:
                        done[i] = True
                else:
                    done[i] = True
            if done.all():
                break
        for r, gen in zip(requests, out):
            r.generated = gen
        return requests
