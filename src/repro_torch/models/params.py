"""Parameter specs and their initialisation (``repro.models.params``).

A spec carries the shape the JAX package gives the leaf, so a segment's
per-layer weight has the stacked shape ``(n_layers,) + shape``. The init
rule is the reference's as written: std = scale / √fan_in with
``fan_in = shape[0]`` of that shape. For a stacked leaf that is the
segment's layer count, not the input width (every weight of
deepseek-v2-lite's 26 MoE layers is drawn with std 1/√26, of its one dense
layer with std 1); only the unstacked ``lm_head`` gets 1/√d_model.

The port holds a segment as one module per layer, so each layer's slice
is drawn on its own: no fp32 temporary covers a whole stacked leaf
(``moe_layers.w1`` stacked is 4.8 G elements, 19 GB in fp32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class P_:
    """Parameter spec: shape (stacked for a segment's layers), the logical
    name of each dim (the keys of ``distributed.sharding.RULES``; None for
    a dim no rule shards), init rule (normal | zeros | ones | embed),
    scale and dtype."""

    shape: Tuple[int, ...]
    dims: Tuple[Optional[str], ...]
    init: str = "normal"
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.dims):
            raise ValueError(f"spec of shape {self.shape} names {len(self.dims)} dims: {self.dims}")


def layer_names(layer_dim: Tuple[int, ...]) -> Tuple[str, ...]:
    """The logical names of a segment's stacking dims, as the reference
    names them: ``("layers",)`` or ``("layers", "layers2")``."""
    return ("layers", "layers2")[:len(layer_dim)]


def init_std(spec: P_) -> float:
    """The reference's std: 1 for ``embed``, else scale / √shape[0]."""
    if spec.init == "embed":
        return 1.0
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[0], 1)
    return spec.scale / math.sqrt(fan_in)


@torch.no_grad()
def init_param_(param: torch.Tensor, spec: P_, generator: torch.Generator) -> None:
    """Fill ``param`` (the whole leaf, or one layer's slice of a stacked
    one) by ``spec``'s rule: normal draws in fp32, rounded to the
    parameter's dtype."""
    if spec.init == "zeros":
        param.zero_()
    elif spec.init == "ones":
        param.fill_(1)
    else:
        draw = torch.randn(param.shape, generator=generator, dtype=torch.float32,
                           device=param.device)
        param.copy_(draw.mul_(init_std(spec)))


def spec_leaves(tree: dict, prefix: str = ""):
    """(dotted name, spec) for every leaf of a spec tree, in tree order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from spec_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


class ParamTree(nn.Module):
    """Parameters named and nested as a spec tree, ``p["wq"]`` reading as
    the JAX params dict does. ``layer_dims`` leading dims of every spec
    are the segment's stacking and are dropped: the module holds one
    layer. Parameters are allocated, not initialised."""

    def __init__(self, specs: dict, device: torch.device, layer_dims: int = 0):
        super().__init__()
        self.specs = specs
        for k, v in specs.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, device, layer_dims))
            else:
                self.register_parameter(k, nn.Parameter(
                    torch.empty(v.shape[layer_dims:], dtype=v.dtype, device=device),
                    requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def init_(self, generator: torch.Generator) -> None:
        params = dict(self.named_parameters())
        for name, spec in spec_leaves(self.specs):
            init_param_(params[name], spec, generator)
