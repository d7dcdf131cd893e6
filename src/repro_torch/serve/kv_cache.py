"""Cache planning for serving (``repro.serve.kv_cache``): per-arch cache
byte accounting and whether parameters plus caches fit the devices. The
mesh shardings wait for the mesh layer (ROADMAP §1)."""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.models.attention import MLACache, TensorSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import KVCache, QuantKVCache
from repro_torch.models.ssm import GLAState
from repro_torch.models.transformer import SLSTMState, SSMCache, cache_specs
from repro_torch.models.zoo import count_params

# NVIDIA H100 SXM device memory
H100_BYTES = 80e9


def _leaves(tree):
    """Every TensorSpec of a cache spec tree: a dict of segments, each an
    ``MLACache``, ``KVCache`` or ``QuantKVCache`` of TensorSpecs (``pos``
    included, one int32 per layer, as the reference counts it), or a
    recurrent state: ``SSMCache`` (conv and a ``GLAState``) or
    ``SLSTMState``."""
    if isinstance(tree, TensorSpec):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (MLACache, KVCache, QuantKVCache, SSMCache, GLAState, SLSTMState)):
        for v in tree:
            yield from _leaves(v)
    else:
        raise TypeError(f"not a cache spec: {type(tree).__name__}")


def cache_bytes(cfg: ModelConfig, batch: int, max_seq: int) -> int:
    """Total cache bytes for one request batch (all layers)."""
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
               for s in _leaves(cache_specs(cfg, batch, max_seq)))


def plan(cfg: ModelConfig, batch: int, max_seq: int, chips: int = 1,
         bytes_per_chip: float = H100_BYTES) -> Dict:
    """Serving memory plan: do bf16 parameters plus the caches fit?"""
    p_bytes = count_params(cfg) * 2
    c_bytes = cache_bytes(cfg, batch, max_seq)
    per_chip = (p_bytes + c_bytes) / chips
    return {
        "param_bytes": p_bytes,
        "cache_bytes": c_bytes,
        "per_chip_bytes": per_chip,
        "fits": per_chip < 0.9 * bytes_per_chip,
    }
