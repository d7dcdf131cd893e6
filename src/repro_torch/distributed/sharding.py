"""Logical-axis sharding rules with divisibility-aware fallback
(``repro.distributed.sharding``), on ``core/mesh.py``'s mesh of virtual
devices.

A logical dim takes a mesh axis only when the axis size divides the dim;
otherwise the rule is dropped for that tensor (qwen1.5-32b's 40 heads on a
16-way model axis stay whole, while its fused projections still shard on
the 5120-wide output dim).

A spec is a tuple with one entry per dim: None, one axis name, or a tuple
of two or more names (the batch dim's ``("pod", "data")``), trailing Nones
stripped; entry for entry it is the reference's ``PartitionSpec``. A
``NamedSharding`` is (mesh, spec): it cuts a full tensor into its
``[D, *block]`` stack of per-device blocks (an axis the spec leaves out
holds copies) and gathers the stack back, through the mesh's
``scatter_full`` and ``gather_full``. ``Sharded`` is a tensor held that
way; ``shard_state`` and ``unshard_state`` move a whole parameter and
optimizer tree (``convert.py``'s JAX-layout trees) onto the mesh and back.
On ``core/rank_mesh.py``'s ``RankMesh`` the stack is the rank's own
block, ``[1, *block]``, cut from the full tensor before it moves to the
rank's device; the gather is an all-gather across the ranks, and
``primary_devices`` stays global.

The ``constrain*`` helpers are the reference's layout hints to XLA. The
port places every block itself, so they return their inputs; the
activation mesh they read is process-global, set by the step builders,
and ``models/moe.py`` reads it to choose expert parallelism.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.params import P_

Tensor = torch.Tensor
Spec = Tuple[Any, ...]

# logical dim name → candidate mesh axes (first that divides wins)
RULES: dict[str, Tuple[str, ...]] = {
    "vocab": ("model",),
    "embed": ("data",),           # FSDP: weights 2D-sharded (model x data)
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),            # FFN hidden (column-parallel in, row-parallel out)
    "experts": ("model",),        # expert parallelism
    "expert_mlp": ("model",),     # TP fallback inside experts when E doesn't divide
    "kv_lora": (),
    "layers": (),                 # the stacking dim of a segment
    "groups": (),
    "conv": (),
    "state": (),
    "qk_fused": ("model",),       # fused n_heads*head_dim projections
    "vision": (),
    "batch": ("pod", "data"),
    "seq": (),
}

BATCH_AXES = ("pod", "data")


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def normalize(spec) -> Spec:
    """A spec as ``PartitionSpec`` holds it: a one-axis tuple entry is that
    axis's name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh's batch axes, ``("pod", "data")`` as far as it has them."""
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


# --------------------- activation sharding constraints ----------------------

_ACT_MESH: list = [None]


def set_activation_mesh(mesh) -> None:
    _ACT_MESH[0] = mesh


def activation_mesh():
    return _ACT_MESH[0]


def constrain(x, entries):
    """The reference pins ``x`` to ``P(*entries)`` for XLA; the port places
    blocks itself, so ``x`` comes back unchanged."""
    return x


def constrain_batch_tree(tree):
    return tree


def constrain_attention(q, k, v):
    return q, k, v


def constrain_block_out(x):
    return x


# ------------------------------- specs --------------------------------------


def spec_for(mesh, shape: Sequence[int], dims: Sequence[Optional[str]],
             rules: dict | None = None) -> Spec:
    """Per dim, the first rule axis that divides it (the batch dim takes
    all its axes jointly, or none); trailing Nones stripped. Reads only
    ``mesh.axis_names`` and ``mesh.shape``."""
    rules = rules or RULES
    out, used = [], set()
    for size, dim in zip(shape, dims):
        entry: object = None
        if dim is not None:
            cands = rules.get(dim, ())
            if dim == "batch":
                axes = tuple(a for a in cands if a in mesh.axis_names and a not in used)
                if axes and size % math.prod(mesh.shape[a] for a in axes) == 0:
                    entry = axes[0] if len(axes) == 1 else axes
                    used.update(axes)
            else:
                for a in cands:
                    if a in mesh.axis_names and a not in used and size % mesh.shape[a] == 0:
                        entry = a
                        used.add(a)
                        break
        out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _zero1_spec(mesh, spec: Spec, shape: Sequence[int], zero_axis: str) -> Spec:
    """``spec`` plus ``zero_axis`` on the largest unsharded dim it divides,
    when the spec does not use that axis yet."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries for a in entry_axes(e)}
    if zero_axis in mesh.axis_names and zero_axis not in used:
        z = mesh.shape[zero_axis]
        best, best_size = -1, 0
        for i, (size, e) in enumerate(zip(shape, entries)):
            if e is None and size % z == 0 and size > best_size:
                best, best_size = i, size
        if best >= 0:
            entries[best] = zero_axis
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


class NamedSharding:
    """(mesh, spec): how a tensor of any shape the spec fits lies in
    per-device blocks."""

    def __init__(self, mesh, spec: Spec = ()):
        self.mesh = mesh
        self.spec = normalize(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({getattr(self.mesh, 'shape', self.mesh)}, {self.spec})"

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block shape, as ``jax.sharding.NamedSharding.shard_shape``."""
        entries = list(self.spec) + [None] * (len(global_shape) - len(self.spec))
        out = []
        for size, e in zip(global_shape, entries):
            n = math.prod(self.mesh.shape[a] for a in entry_axes(e))
            if size % n:
                raise ValueError(f"dim {size} does not split over {e} ({n} ways)")
            out.append(size // n)
        return tuple(out)

    def primary_devices(self) -> list:
        """The flat ids of the devices at position 0 along every axis the
        spec leaves out: one holder of each distinct block, in device order."""
        used = {a for e in self.spec for a in entry_axes(e)}
        g = np.arange(self.mesh.n_devices).reshape(self.mesh.grid)
        idx = tuple(slice(None) if a in used else 0 for a in self.mesh.axis_names)
        return sorted(int(v) for v in np.asarray(g[idx]).reshape(-1))

    def shard(self, full: Tensor, dtype: torch.dtype | None = None) -> Tensor:
        """[D, *block]: every device's block of ``full`` (moved to the mesh's
        device and, when given, ``dtype``); a rank's own block alone on a
        ``RankMesh``, cut before the move."""
        full = torch.as_tensor(full)
        if self.mesh.stack_size < self.mesh.n_devices:
            return self.mesh.scatter_full(full, self.spec).to(self.mesh.device, dtype=dtype)
        return self.mesh.scatter_full(full.to(self.mesh.device, dtype=dtype), self.spec)

    def gather(self, blocks: Tensor) -> Tensor:
        """The full tensor from its [D, *block] stack."""
        return self.mesh.gather_full(blocks, self.spec)


class Sharded:
    """A tensor held as its ``sharding``'s [D, *block] stack on the mesh."""

    def __init__(self, blocks: Tensor, sharding: NamedSharding, shape: Sequence[int]):
        self.blocks = blocks
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        if tuple(blocks.shape) != (sharding.mesh.stack_size,) + sharding.shard_shape(self.shape):
            raise ValueError(f"blocks {tuple(blocks.shape)} do not hold {self.shape} "
                             f"under {sharding}")

    @classmethod
    def of(cls, full: Tensor, sharding: NamedSharding, dtype: torch.dtype | None = None):
        full = torch.as_tensor(full)
        return cls(sharding.shard(full, dtype), sharding, full.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def block_shape(self) -> Tuple[int, ...]:
        return tuple(self.blocks.shape[1:])

    def full(self) -> Tensor:
        return self.sharding.gather(self.blocks)

    def __repr__(self) -> str:
        return f"Sharded({self.shape}, {self.dtype}, {self.sharding})"


# ------------------------------- trees --------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of nested dicts, NamedTuples, lists and tuples,
    with the matching nodes of ``rest``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _is_spec(x) -> bool:
    return isinstance(x, P_)


def param_shardings(mesh, tree, rules: dict | None = None):
    """A NamedSharding tree for a ``P_`` spec tree."""
    return tree_map(lambda s: NamedSharding(mesh, spec_for(mesh, s.shape, s.dims, rules)),
                    tree, is_leaf=_is_spec)


def zero1_shardings(mesh, tree, rules: dict | None = None, zero_axis: str = "data"):
    """Optimizer-state shardings: the parameter spec plus ZeRO-1 sharding of
    the largest still-unsharded dim over the data axis."""
    def one(s: P_):
        spec = spec_for(mesh, s.shape, s.dims, rules)
        return NamedSharding(mesh, _zero1_spec(mesh, spec, s.shape, zero_axis))
    return tree_map(one, tree, is_leaf=_is_spec)


def shard_state(tree, shardings, dtype: torch.dtype | None = None):
    """Every leaf of ``tree`` (tensors or numpy arrays, full) as ``Sharded``
    under the matching leaf of ``shardings``, in ``dtype`` when given; a
    None sharding keeps the leaf whole on the first sharding's device."""
    def one(leaf, sh):
        if sh is None:
            return leaf
        return Sharded.of(torch.from_numpy(np.ascontiguousarray(leaf))
                          if isinstance(leaf, np.ndarray) else leaf, sh, dtype)
    return tree_map(one, tree, shardings)


def rank_mesh_of(tree):
    """The ``core.rank_mesh.RankMesh`` that the ``Sharded`` and
    ``NamedSharding`` leaves of ``tree`` lie on, or None when none lies on
    one; every such leaf must lie on the ranks of one process group."""
    from repro_torch.core.rank_mesh import RankMesh

    found = []

    def note(leaf):
        mesh = (leaf.sharding.mesh if isinstance(leaf, Sharded)
                else leaf.mesh if isinstance(leaf, NamedSharding) else None)
        if isinstance(mesh, RankMesh):
            if found and mesh.world is not found[0].world:
                raise ValueError("the tree's leaves lie on the ranks of two process groups")
            found.append(mesh)
        return leaf
    tree_map(note, tree, is_leaf=lambda x: isinstance(x, (Sharded, NamedSharding)))
    return found[0] if found else None


def unshard_state(tree):
    """``tree`` with every ``Sharded`` leaf gathered into its full tensor."""
    return tree_map(lambda x: x.full() if isinstance(x, Sharded) else x, tree,
                    is_leaf=lambda x: isinstance(x, Sharded))
