"""A device mesh of D virtual devices on one card, and the collectives that
``shard_map`` bodies issue in the JAX package.

``Mesh(shape=(R, C))`` stands in for ``jax.sharding.Mesh`` with axes
``("dr", "dc")``: flat device g is ``r*C + c``, as in JAX. Every sharded
array is one tensor with a leading device axis ``[D, ...]``, the outer
view that the callers of ``shard_map`` in ``core/distributed.py`` use; a
device's block is its slice ``x[g]``. A collective is an explicit data
movement over that axis (one indexing copy), and a per-device body runs
once per device on its slice. The index tables of a collective are built
on the host at its first use and kept on the device, so later calls copy
nothing from the host and never wait for the card.

An axis argument names one mesh axis (``"dr"``, ``"dc"``) or both
(``("dr", "dc")``, the flat axis over all D devices). Along an axis the
devices fall into groups that share their other coordinate; a device's
position in its group is its ``axis_index``. ``perm`` pairs and
``all_gather``'s order are in those positions, as in JAX.

No primitive reduces over the device axis. A ⊕ across devices is the
caller's, with ``sr.add`` in an order it states (``core/collectives.py``
folds in position order, left to right): ``torch.sum`` or ``amin`` over
the axis would leave the order to CUDA, and a float ⊕ would then not give
the same bits on every call. A process-group mesh (one rank per card) can
implement the same primitives.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device

Tensor = torch.Tensor
Axis = Union[str, Tuple[str, ...]]


class Mesh:
    """An (R, C) grid of virtual devices on one card."""

    def __init__(self, shape: Tuple[int, int] = (1, 1),
                 axis_names: Sequence[str] = ("dr", "dc"), device=None):
        r, c = (int(v) for v in shape)
        if r < 1 or c < 1:
            raise ValueError(f"mesh shape must be positive, got {shape}")
        if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
            raise ValueError(f"a mesh has two distinct axis names, got {axis_names}")
        self.grid = (r, c)
        self.axis_names = tuple(axis_names)
        self.device = resolve_device(device)
        self._index: dict = {}
        self._perms: dict = {}

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def n_devices(self) -> int:
        return self.grid[0] * self.grid[1]

    def _members(self, axis: Axis) -> np.ndarray:
        """[groups, size] flat device ids of each group along ``axis``, in
        position order."""
        ar, ac = self.axis_names
        r, c = self.grid
        g = np.arange(r * c, dtype=np.int64).reshape(r, c)
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if names == (ar,):
            return g.T.copy()
        if names == (ac,):
            return g
        if names == (ar, ac):
            return g.reshape(1, -1)
        raise ValueError(f"unknown mesh axis {axis!r}; expected {ar!r}, {ac!r} or "
                         f"({ar!r}, {ac!r})")

    def _tables(self, axis: Axis):
        """(members [D, size] and position [D] on the device, members
        [groups, size] on the host): row g of the first lists the group of
        device g in position order; position[g] is g's place in it."""
        key = axis if isinstance(axis, str) else tuple(axis)
        if key not in self._index:
            members = self._members(axis)
            group = np.empty(self.n_devices, np.int64)
            pos = np.empty(self.n_devices, np.int64)
            for gi, row in enumerate(members):
                group[row] = gi
                pos[row] = np.arange(row.shape[0])
            self._index[key] = (torch.from_numpy(members[group]).to(self.device),
                                torch.from_numpy(pos).to(self.device), members)
        return self._index[key]

    def axis_size(self, axis: Axis) -> int:
        return self._members(axis).shape[1]

    def axis_index(self, axis: Axis) -> Tensor:
        """[D] int64: each device's position along ``axis``."""
        return self._tables(axis)[1]

    def _check(self, x: Tensor) -> None:
        if x.dim() < 1 or x.shape[0] != self.n_devices:
            raise ValueError(f"expected a leading device axis of {self.n_devices}, "
                             f"got {tuple(x.shape)}")

    def all_gather(self, x: Tensor, axis: Axis, dim: int = 1) -> Tensor:
        """Tiled all-gather: device g gets its group's blocks concatenated in
        position order along ``dim`` (a dim of the stacked tensor, >= 1).
        The result is a new tensor: the Load's copy."""
        self._check(x)
        if not 1 <= dim < x.dim():
            raise ValueError(f"dim {dim} is not a per-device dim of {tuple(x.shape)}")
        members = self._tables(axis)[0]
        g = x[members]                                     # [D, S, ...]
        g = g.movedim(1, dim)                              # S just before dim's block
        shape = list(x.shape)
        shape[dim] *= members.shape[1]
        return g.reshape(shape)

    def _perm_tables(self, axis: Axis, perm: Sequence[Tuple[int, int]]):
        """(source [D], receivers of nothing [k] or None) on the device for
        one ``perm``, built on its first use and kept: a later ppermute with
        the same perm copies nothing from the host (a blocking copy would
        drain the stream)."""
        key = (axis if isinstance(axis, str) else tuple(axis),
               tuple((int(s), int(t)) for s, t in perm))
        if key not in self._perms:
            members = self._tables(axis)[2]
            src_of = np.full(self.n_devices, -1, np.int64)
            for s, t in key[1]:
                src_of[members[:, t]] = members[:, s]
            empty = np.flatnonzero(src_of < 0)
            self._perms[key] = (torch.from_numpy(np.maximum(src_of, 0)).to(self.device),
                                torch.from_numpy(empty).to(self.device) if empty.size else None)
        return self._perms[key]

    def ppermute(self, x: Tensor, axis: Axis, perm: Sequence[Tuple[int, int]]) -> Tensor:
        """Device at position dst receives the block of the device at
        position src of its group, for every (src, dst) in ``perm``;
        devices that receive nothing get zeros, as in JAX."""
        self._check(x)
        src, empty = self._perm_tables(axis, perm)
        out = x[src]
        if empty is not None:
            out.index_fill_(0, empty, 0)
        return out

    def all_to_all(self, x: Tensor, axis: Axis) -> Tensor:
        """x [D, S, ...], S the axis size: device at position i gets
        out[j] = the chunk i of the device at position j (JAX's
        ``all_to_all`` with split and concat on the first per-device dim)."""
        self._check(x)
        members, pos = self._tables(axis)[:2]
        if x.dim() < 2 or x.shape[1] != members.shape[1]:
            raise ValueError(f"all_to_all over {axis!r} needs [D, {members.shape[1]}, ...], "
                             f"got {tuple(x.shape)}")
        return x[members, pos[:, None]]

    def take(self, x: Tensor, idx: Tensor) -> Tensor:
        """Per-device ``dynamic_index_in_dim``: out[g] = x[g, idx[g]] for
        x [D, S, ...] and idx [D]."""
        self._check(x)
        return x[torch.arange(self.n_devices, device=x.device), idx]

    def grid_view(self, x: Tensor) -> Tensor:
        """[D, ...] as [R, C, ...] (same memory)."""
        self._check(x)
        return x.view(*self.grid, *x.shape[1:])

    def flat_view(self, x: Tensor) -> Tensor:
        """[R, C, ...] as [D, ...] (same memory)."""
        if tuple(x.shape[:2]) != self.grid:
            raise ValueError(f"expected a leading {self.grid} grid, got {tuple(x.shape)}")
        return x.reshape(self.n_devices, *x.shape[2:])
