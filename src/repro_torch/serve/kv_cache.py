"""Cache planning for serving (``repro.serve.kv_cache``): per-arch cache
byte accounting, whether parameters plus caches fit the devices, and the
caches' shardings on a mesh (``cache_shardings``, spec trees held leaf for
leaf to the reference's)."""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.distributed.sharding import NamedSharding, batch_axes
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


def _map_specs(fn, tree, key: str = ""):
    """``fn(key path, spec)`` over a cache spec tree, keys joined by "/"."""
    if isinstance(tree, TensorSpec):
        return fn(key, tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, f"{key}/{k}" if key else k) for k, v in tree.items()}
    return type(tree)(*(_map_specs(fn, v, f"{key}/{f}") for f, v in zip(tree._fields, tree)))


def cache_shardings(mesh, cfg: ModelConfig, batch: int, max_seq: int):
    """Shard caches: batch over data(+pod); the first remaining dim the
    model axis divides takes it, per kind of leaf.

    Per leaf: dim 0 is layers (replicated); the batch dim (the first dim
    after it equal to ``batch``) takes the data axes if they divide it.
    On the model axis: a recurrent state [.., B, H, Dk, Dv] tries H, Dv,
    then Dk; MLA's latent cache (c_kv, k_rope) only its sequence; any
    other leaf (attention k/v [.., B, S, KH, HD], conv [.., B, K-1, C]) the
    dims after the sequence slot."""
    data_axes = batch_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in data_axes)
    msize = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def one(key: str, leaf: TensorSpec):
        key = key.lower()
        nd = len(leaf.shape)
        entries = [None] * nd
        bidx = next((i for i, s in enumerate(leaf.shape) if s == batch and i >= 1), None)
        if bidx is not None and data_axes and batch % dsize == 0:
            entries[bidx] = data_axes
        if msize > 1 and bidx is not None:
            if "gla" in key:
                order = [bidx + 1, nd - 1] + list(range(nd - 2, bidx + 1, -1))
            elif "c_kv" in key or "k_rope" in key:
                order = [bidx + 1]
            else:
                order = list(range(bidx + 2, nd))
            for i in order:
                if entries[i] is None and leaf.shape[i] % msize == 0 and leaf.shape[i] >= msize:
                    entries[i] = "model"
                    break
        while entries and entries[-1] is None:
            entries.pop()
        return NamedSharding(mesh, tuple(entries))

    return _map_specs(one, cache_specs(cfg, batch, max_seq))
