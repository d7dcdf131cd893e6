"""Carry matrices, model parameters and caches across from the JAX package.

Each ``*_from_numpy`` takes the arrays of a ``repro.core.formats``
container, passed as ``np.asarray``, and returns the port's container on
``device`` (the CUDA card unless named), so both packages can run on
literally the same matrix. ``to_numpy`` goes the other way, field by field.
``model_params_from_numpy`` takes a JAX params pytree with numpy leaves
(segments stacked [L, ...], the VLM's self layers [groups, per, ...]) and
returns the port's model state, one entry per layer, and
``model_params_to_numpy`` stacks a state (the parameters, or their
``.grad``) back into that tree; ``opt_state_from_numpy`` and
``opt_state_to_numpy`` carry the AdamW state (step, master, mu, nu) both
ways;
``mla_cache_from_numpy``/``mla_cache_to_numpy``,
``gqa_cache_from_numpy``/``gqa_cache_to_numpy`` and
``ssm_cache_from_numpy``/``ssm_cache_to_numpy`` carry a segment's MLA,
GQA (KVCache, QuantKVCache) and recurrent (mLSTM, Mamba2, sLSTM) caches
both ways. ``partitioned_from_numpy`` carries a
JAX ``PartitionedMatrix`` (stacked leaves, grid, shapes, format, plan) into
the port's. Nothing here imports the JAX package: the caller hands over
plain arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.formats import (
    BSRMatrix, COOMatrix, CSCMatrix, CSRMatrix, PaddedBSR, SlicedELL,
)
from repro_torch.core.partition import PartitionedMatrix, PartitionPlan
from repro_torch.models.attention import MLACache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import AnyKVCache, KVCache, QuantKVCache
from repro_torch.models.params import spec_leaves
from repro_torch.models.ssm import GLAState
from repro_torch.models.transformer import SLSTMState, SSMCache, model_specs
from repro_torch.train.optimizer import OptState


def _t(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def padded_bsr_from_numpy(tiles: np.ndarray, tile_cols: np.ndarray,
                          shape: Tuple[int, int], block: Tuple[int, int],
                          device=None) -> PaddedBSR:
    device = resolve_device(device)
    return PaddedBSR(_t(tiles, device), _t(np.asarray(tile_cols, np.int32), device),
                     tuple(shape), tuple(block))


def sliced_ell_from_numpy(tiles: np.ndarray, tile_cols: np.ndarray, row_meta: np.ndarray,
                          shape: Tuple[int, int], block: Tuple[int, int], slice_height: int,
                          sigma: int, device=None) -> SlicedELL:
    device = resolve_device(device)
    return SlicedELL(_t(tiles, device), _t(np.asarray(tile_cols, np.int32), device),
                     _t(np.asarray(row_meta, np.int32), device), tuple(shape), tuple(block),
                     int(slice_height), int(sigma))


def bsr_from_numpy(tiles: np.ndarray, tile_cols: np.ndarray, tile_row_ptr: np.ndarray,
                   shape: Tuple[int, int], block: Tuple[int, int], device=None) -> BSRMatrix:
    device = resolve_device(device)
    return BSRMatrix(_t(tiles, device), _t(np.asarray(tile_cols, np.int32), device),
                     _t(np.asarray(tile_row_ptr, np.int32), device), tuple(shape), tuple(block))


def coo_from_numpy(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, nnz,
                   shape: Tuple[int, int], device=None) -> COOMatrix:
    device = resolve_device(device)
    return COOMatrix(_t(rows, device), _t(cols, device), _t(vals, device),
                     int(nnz), tuple(shape))


def csr_from_numpy(row_ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   seg_ids: np.ndarray, nnz, shape: Tuple[int, int],
                   device=None) -> CSRMatrix:
    device = resolve_device(device)
    return CSRMatrix(_t(row_ptr, device), _t(cols, device), _t(vals, device),
                     _t(seg_ids, device), int(nnz), tuple(shape))


def csc_from_numpy(col_ptr: np.ndarray, rows: np.ndarray, vals: np.ndarray, nnz,
                   shape: Tuple[int, int], max_col_nnz: int,
                   device=None) -> CSCMatrix:
    device = resolve_device(device)
    return CSCMatrix(_t(col_ptr, device), _t(rows, device), _t(vals, device),
                     int(nnz), tuple(shape), int(max_col_nnz))


_STACKED = {"coo": (COOMatrix, ("rows", "cols", "vals")),
            "csr": (CSRMatrix, ("row_ptr", "cols", "vals", "seg_ids")),
            "csc": (CSCMatrix, ("col_ptr", "rows", "vals")),
            "bsr": (PaddedBSR, ("tiles", "tile_cols"))}


def partitioned_from_numpy(leaves: dict, fmt: str, grid: Tuple[int, int],
                           shape: Tuple[int, int], local_shape: Tuple[int, int],
                           plan: dict | None = None, block: Tuple[int, int] | None = None,
                           max_col_nnz: int | None = None, device=None) -> PartitionedMatrix:
    """A JAX ``PartitionedMatrix`` as the port's. ``leaves`` maps each field
    of the stacked container to its numpy array with the leading device
    axis (``nnz`` a [D] array, for the element formats); ``plan`` maps each
    field of the JAX ``PartitionPlan`` to its value (tuples, numpy orders or
    None). ``block`` is the BSR tile and ``max_col_nnz`` the CSC bound."""
    device = resolve_device(device)
    cls, names = _STACKED[fmt]
    kw = {n: _t(leaves[n], device) for n in names}
    for n in ("tile_cols", "row_ptr", "col_ptr", "seg_ids"):
        if n in kw:
            kw[n] = kw[n].to(torch.int32)
    if fmt == "bsr":
        parts = cls(**kw, shape=tuple(local_shape), block=tuple(block))
    else:
        kw["nnz"] = tuple(int(v) for v in np.asarray(leaves["nnz"]).reshape(-1))
        if fmt == "csc":
            kw["max_col_nnz"] = int(max_col_nnz)
        parts = cls(**kw, shape=tuple(local_shape))
    port_plan = None
    if plan is not None:
        port_plan = PartitionPlan(
            grid=tuple(plan["grid"]), balance=plan["balance"], shape=tuple(plan["shape"]),
            row_starts=tuple(int(v) for v in plan["row_starts"]),
            col_starts=tuple(int(v) for v in plan["col_starts"]),
            local_shape=tuple(plan["local_shape"]),
            tile_nnz=tuple(int(v) for v in plan["tile_nnz"]),
            row_order=None if plan.get("row_order") is None else np.asarray(plan["row_order"]),
            col_order=None if plan.get("col_order") is None else np.asarray(plan["col_order"]))
    return PartitionedMatrix(parts=parts, grid=tuple(grid), shape=tuple(shape),
                             local_shape=tuple(local_shape), fmt=fmt, plan=port_plan)


def to_numpy(m) -> dict:
    """Every field of a port container, tensors as numpy arrays."""
    return {f.name: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(m) for v in [getattr(m, f.name)]}


def _float_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A float array (numpy, or ml_dtypes bfloat16 as JAX hands it over) as
    a tensor of ``dtype`` on ``device``; bfloat16 crosses bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def leaf_at(tree: dict, dotted: str):
    """The leaf of a nested dict at a dotted path."""
    for k in dotted.split("."):
        tree = tree[k]
    return tree


# segments whose leaves are not stacked over one layer dim: the VLM's self
# layers and xLSTM's mLSTM blocks [g, per, ...], zamba2's one shared block
_LAYER_DIMS = {"self_layers": 2, "mlstm": 2, "shared_attn": 0}


def model_params_from_numpy(cfg: ModelConfig, params_np: dict, device=None,
                            dtype: torch.dtype | None = None) -> dict:
    """The port's model state (``Model.load_state_dict``) from the JAX
    params pytree: each segment's stacked leaf [L, ...] split into its L
    layers (the VLM's self layers and xLSTM's mLSTM blocks [g, per, ...]
    into g·per, group-major; zamba2's ``shared_attn`` is one block and
    stays whole), every leaf in the spec's dtype (or ``dtype``) and
    checked against its shape."""
    device = resolve_device(device)
    state = {}
    for name, spec in spec_leaves(model_specs(cfg)):
        a = np.asarray(leaf_at(params_np, name))
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{name}: shape {a.shape}, the spec has {spec.shape}")
        seg, _, rest = name.partition(".")
        lead = _LAYER_DIMS.get(seg, 1)
        if not rest or lead == 0:                  # a top-level leaf, or an unstacked block
            state[name] = _float_tensor(a, dtype or spec.dtype, device)
            continue
        a = a.reshape((-1,) + a.shape[lead:])
        for i in range(a.shape[0]):
            state[f"{seg}.{i}.{rest}"] = _float_tensor(a[i], dtype or spec.dtype, device)
    return state


def model_params_to_numpy(cfg: ModelConfig, state) -> dict:
    """The JAX params tree, float32 numpy leaves, from a port state keyed
    as ``Model.named_parameters()`` (a ``state_dict``, or ``{name:
    p.grad}``): each segment's layers stacked back into [L, ...] ([g, per,
    ...] for the VLM's self layers and xLSTM's mLSTM blocks). A missing or
    None entry (a parameter the loss never reached) gives zeros."""
    def host(name, shape):
        t = state.get(name)
        if t is None:
            return np.zeros(shape, np.float32)
        return t.detach().float().cpu().numpy()

    tree: dict = {}
    for name, spec in spec_leaves(model_specs(cfg)):
        seg, _, rest = name.partition(".")
        lead = _LAYER_DIMS.get(seg, 1)
        if not rest or lead == 0:
            a = host(name, spec.shape)
        else:
            n = int(np.prod(spec.shape[:lead]))
            a = np.stack([host(f"{seg}.{i}.{rest}", spec.shape[lead:]) for i in range(n)])
            a = a.reshape(spec.shape)
        node = tree
        keys = name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return tree


def param_layout(cfg: ModelConfig) -> list:
    """(dotted path in the JAX params tree, its spec, [(the port's parameter
    name, its index in the stacked leaf)]) for every leaf, in the spec
    tree's order: a top-level leaf or zamba2's shared block is one
    parameter at index (); a segment's stacked leaf [L, ...] holds layer i
    at (i,); the VLM's self layers and xLSTM's mLSTM blocks [g, per, ...]
    hold block i at (i // per, i % per)."""
    out = []
    for name, spec in spec_leaves(model_specs(cfg)):
        seg, _, rest = name.partition(".")
        lead = _LAYER_DIMS.get(seg, 1)
        if not rest or lead == 0:
            out.append((name, spec, [(name, ())]))
            continue
        dims = spec.shape[:lead]
        n = int(np.prod(dims))
        out.append((name, spec, [(f"{seg}.{i}.{rest}", tuple(int(v) for v in np.unravel_index(i, dims)))
                                 for i in range(n)]))
    return out


def stack_model_params(cfg: ModelConfig, state, dtype: torch.dtype | None = None) -> dict:
    """The JAX params tree as tensors on their device (no host copy) from a
    port state keyed as ``Model.named_parameters()``: each segment's layers
    stacked into its leaf, in ``dtype`` when given."""
    tree: dict = {}
    for name, spec, parts in param_layout(cfg):
        leaf = torch.stack([state[p].detach() for p, _ in parts]) if parts[0][1] else \
            state[parts[0][0]].detach()
        leaf = leaf.reshape(spec.shape).to(dtype or leaf.dtype)
        node = tree
        keys = name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def opt_state_from_numpy(cfg: ModelConfig, step, master: dict, mu: dict, nu: dict,
                         device=None) -> OptState:
    """The port's ``OptState`` from the reference's (step, and master, mu
    and nu as JAX params trees of numpy leaves): f32 leaves per layer on
    ``device``, keyed by parameter name."""
    device = resolve_device(device)

    def per_layer(tree):
        return model_params_from_numpy(cfg, tree, device, dtype=torch.float32)

    return OptState(torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                    per_layer(master), per_layer(mu), per_layer(nu))


def opt_state_to_numpy(cfg: ModelConfig, opt: OptState) -> dict:
    """``{"step": int32, "master", "mu", "nu"}``, the three as JAX params
    trees of float32 numpy leaves."""
    return {"step": np.int32(int(opt.step)),
            **{f: model_params_to_numpy(cfg, getattr(opt, f)) for f in ("master", "mu", "nu")}}


def mla_cache_from_numpy(c_kv: np.ndarray, k_rope: np.ndarray, pos: np.ndarray,
                         dtype: torch.dtype, device=None) -> list[MLACache]:
    """A segment's JAX ``MLACache`` (c_kv [L, B, S, kv_lora], k_rope
    [L, B, S, rope], pos [L]) as the port's per-layer caches."""
    device = resolve_device(device)
    return [MLACache(_float_tensor(c_kv[i], dtype, device), _float_tensor(k_rope[i], dtype, device),
                     int(pos[i])) for i in range(len(pos))]


def mla_cache_to_numpy(caches: list[MLACache]) -> dict:
    """The port's per-layer caches of a segment, stacked as the JAX
    ``MLACache`` is: c_kv and k_rope as float32, pos as int32."""
    return {"c_kv": np.stack([c.c_kv.float().cpu().numpy() for c in caches]),
            "k_rope": np.stack([c.k_rope.float().cpu().numpy() for c in caches]),
            "pos": np.array([c.pos for c in caches], np.int32)}


def gqa_cache_from_numpy(k: np.ndarray, v: np.ndarray, pos: np.ndarray, dtype: torch.dtype,
                         k_scale: np.ndarray | None = None, v_scale: np.ndarray | None = None,
                         device=None) -> list[AnyKVCache]:
    """A segment's JAX ``KVCache`` (k, v [L, B, S, KH, D], pos [L]) as the
    port's per-layer caches, k/v in ``dtype``; with ``k_scale``/``v_scale``
    ([L, B, S]) a ``QuantKVCache``: int8 k/v, f32 scales."""
    device = resolve_device(device)
    if k_scale is None:
        return [KVCache(_float_tensor(k[i], dtype, device), _float_tensor(v[i], dtype, device),
                        int(pos[i])) for i in range(len(pos))]
    return [QuantKVCache(_t(np.asarray(k[i], np.int8), device), _t(np.asarray(v[i], np.int8), device),
                         _t(np.asarray(k_scale[i], np.float32), device),
                         _t(np.asarray(v_scale[i], np.float32), device), int(pos[i]))
            for i in range(len(pos))]


def gqa_cache_to_numpy(caches: list[AnyKVCache]) -> dict:
    """The port's per-layer GQA caches of a segment, stacked as the JAX
    cache is: a ``KVCache``'s k/v as float32, a ``QuantKVCache``'s as int8
    with float32 scales, pos as int32."""
    out = {"pos": np.array([c.pos for c in caches], np.int32)}
    quant = isinstance(caches[0], QuantKVCache)
    for f in ("k", "v", "k_scale", "v_scale") if quant else ("k", "v"):
        out[f] = np.stack([(getattr(c, f) if quant else getattr(c, f).float()).cpu().numpy()
                           for c in caches])
    return out


def ssm_cache_from_numpy(stack, dtype: torch.dtype, device=None) -> list:
    """A segment's recurrent states from the reference's stacks, as the
    port's per-layer containers: an mLSTM or Mamba2 ``{"conv": [..., B,
    K−1, C], "gla": (s, n)}`` as ``SSMCache``s (conv in ``dtype``, the
    GLA state in f32), an sLSTM ``(c, n)`` [..., B, d] as ``SLSTMState``s.
    The leading dims are the layers ([L], or mLSTM's [g, per], taken
    group-major)."""
    device = resolve_device(device)
    f32 = torch.float32
    if isinstance(stack, dict):
        conv, s, n = (np.asarray(a) for a in (stack["conv"], *stack["gla"]))
        lead = conv.ndim - 3                       # conv is [B, K−1, C] a layer
        conv, s, n = (a.reshape((-1,) + a.shape[lead:]) for a in (conv, s, n))
        return [SSMCache(_float_tensor(conv[i], dtype, device),
                         GLAState(_float_tensor(s[i], f32, device),
                                  _float_tensor(n[i], f32, device)))
                for i in range(conv.shape[0])]
    c, n = (np.asarray(a) for a in stack)
    c, n = (a.reshape((-1,) + a.shape[-2:]) for a in (c, n))
    return [SLSTMState(_float_tensor(c[i], f32, device), _float_tensor(n[i], f32, device))
            for i in range(c.shape[0])]


def ssm_cache_to_numpy(caches: list, lead: Tuple[int, ...] | None = None):
    """The port's per-layer recurrent states of a segment, stacked as the
    reference's are, float32: ``{"conv", "gla": GLAState(s, n)}`` for
    ``SSMCache``s, ``SLSTMState(c, n)`` for sLSTM states. ``lead`` gives
    the leading dims (mLSTM's (g, per)); by default [L]."""
    lead = (len(caches),) if lead is None else tuple(lead)

    def stack(get):
        a = np.stack([get(c).float().cpu().numpy() for c in caches])
        return a.reshape(lead + a.shape[1:])

    if isinstance(caches[0], SSMCache):
        return {"conv": stack(lambda c: c.conv),
                "gla": GLAState(stack(lambda c: c.gla.s), stack(lambda c: c.gla.n))}
    return SLSTMState(stack(lambda c: c.c), stack(lambda c: c.n))
