"""A device mesh of D virtual devices on one card, and the collectives that
``shard_map`` bodies issue in the JAX package.

``Mesh(shape, axis_names)`` stands in for ``jax.sharding.Mesh`` with one
to three named axes: the graph layer's ``("dr", "dc")`` grid, and the LM
train meshes ``("data", "model")`` and ``("pod", "data", "model")``. Flat
device ids are row-major over the axes, as in JAX (on an (R, C) mesh
device g is ``r*C + c``). Every sharded array is one tensor with a
leading device axis ``[D, ...]``, the outer view that the callers of
``shard_map`` in ``core/distributed.py`` use; a device's block is its
slice ``x[g]``. A collective is an explicit data movement over that axis
(one indexing copy), and a per-device body runs once per device on its
slice. The index tables of a collective are built on the host at its
first use and kept on the device, so later calls copy nothing from the
host and never wait for the card.

An axis argument names one mesh axis (``"dr"``) or an ordered tuple of
them (``("pod", "data")``; all of them in mesh order is the flat axis
over all D devices). Along an axis the devices fall into groups that
share their other coordinates; a device's position in its group is its
``axis_index``, row-major over the named axes in the order given, as in
JAX; ``all_gather``'s order is in those positions. ``ppermute``'s pairs
number the positions over the named axes in mesh order, as JAX's does.

``gather_full`` and ``scatter_full`` are the layout moves of a
``NamedSharding``: the full tensor an all-gather of the blocks over every
axis of a spec leaves on each device, and each device's block of a full
tensor (``jax.device_put``, or what a reduce-scatter leaves of one
contribution). Every device's gather result is the same tensor, so on one
card the devices share one copy of it.

``gather_root`` and ``share`` serve a checkpoint and the async server's
decisions: the full tensor of a sharding's blocks where the root writes
it, and one host byte string from the root. Here both are local.

``row_shares``, ``all_true`` and ``gather_rows`` hold a batch row-sharded
over an axis (the reference's ``P(axis, None)`` block in
``graphs/multi.py``): the rows each position owns, a stopping test over
every position's rows and the gather of the rows back into the batch.
Here they are local; on a ``RankMesh`` the last two are collectives, so
one code path serves both meshes.

No primitive reduces over the device axis. A ⊕ across devices is the
caller's, with ``sr.add`` in an order it states (``core/collectives.py``
folds in position order, left to right): ``torch.sum`` or ``amin`` over
the axis would leave the order to CUDA, and a float ⊕ would then not give
the same bits on every call. ``core/rank_mesh.py``'s ``RankMesh`` is the
same mesh over a process group, one rank per device: each rank holds its
own block, ``[1, ...]``, and every primitive is a collective that gives
it block ``rank`` of this mesh's result.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device

Tensor = torch.Tensor
Axis = Union[str, Tuple[str, ...]]


class Mesh:
    """A grid of virtual devices on one card, one to three named axes."""

    def __init__(self, shape: Tuple[int, ...] = (1, 1),
                 axis_names: Sequence[str] = ("dr", "dc"), device=None):
        grid = tuple(int(v) for v in shape)
        if not 1 <= len(grid) <= 3 or min(grid) < 1:
            raise ValueError(f"mesh shape must be one to three positive sizes, got {shape}")
        if len(axis_names) != len(grid) or len(set(axis_names)) != len(grid):
            raise ValueError(f"a mesh of shape {grid} has {len(grid)} distinct axis names, "
                             f"got {axis_names}")
        self.grid = grid
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
        return math.prod(self.grid)

    @property
    def stack_size(self) -> int:
        """The leading axis of a stacked tensor on this mesh: one block per
        device, so ``n_devices``. A view that holds one device's block alone
        (``launch/device_view.py``) holds 1; its grid is still the mesh's."""
        return self.n_devices

    def _names(self, axis: Axis) -> Tuple[str, ...]:
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if not names or len(set(names)) != len(names) or any(
                a not in self.axis_names for a in names):
            raise ValueError(f"unknown mesh axis {axis!r}; expected one of {self.axis_names} "
                             f"or an ordered tuple of them")
        return names

    def _members(self, axis: Axis) -> np.ndarray:
        """[groups, size] flat device ids of each group along ``axis``, in
        position order: the other axes index the groups (row-major, in
        mesh order), the named axes the positions (row-major, in the
        order given)."""
        names = self._names(axis)
        g = np.arange(self.n_devices, dtype=np.int64).reshape(self.grid)
        rest = [i for i, a in enumerate(self.axis_names) if a not in names]
        order = rest + [self.axis_names.index(a) for a in names]
        size = math.prod(self.grid[self.axis_names.index(a)] for a in names)
        return g.transpose(order).reshape(-1, size).copy()

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
        if x.dim() < 1 or x.shape[0] != self.stack_size:
            raise ValueError(f"expected a leading device axis of {self.stack_size}, "
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
            # JAX numbers a ppermute's positions over a tuple of axes in mesh
            # order, whatever order the tuple gives
            names = self._names(axis)
            members = self._tables(tuple(a for a in self.axis_names if a in names))[2]
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

    def fold_blocks(self, fn, x: Tensor, devices: Sequence[int]) -> Tensor:
        """``fn(x[d])`` for each flat id d of ``devices``, folded with ``+``
        left to right in the order given: the fixed-order sum of per-device
        partials (one holder of each distinct block)."""
        self._check(x)
        total = fn(x[devices[0]])
        for d in devices[1:]:
            total = total + fn(x[d])
        return total

    def take(self, x: Tensor, idx: Tensor) -> Tensor:
        """Per-device ``dynamic_index_in_dim``: out[g] = x[g, idx[g]] for
        x [D, S, ...] and idx [D]."""
        self._check(x)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def positions(self, axis: Axis) -> list:
        """The positions along ``axis`` that this mesh holds blocks of: all
        of them (a rank of ``RankMesh`` holds its own). No axis, ``()``, is
        one position."""
        return list(range(self.axis_size(axis) if axis else 1))

    def split_rows(self, x: Tensor, axis: Axis) -> list:
        """The rows of a batch tensor ``x`` [B, ...] that each position
        along ``axis`` this mesh holds owns, in position order: B/S
        contiguous rows a position, S the axis size (views)."""
        n = self.axis_size(axis) if axis else 1
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {axis!r} ({n} ways)")
        r = x.shape[0] // n
        return [x[q * r:(q + 1) * r] for q in self.positions(axis)]

    def gather_positions(self, values: Sequence[Tensor], axis: Axis) -> list:
        """Every position's value along ``axis``, in position order, from
        the values of the positions this mesh holds (``positions``): here
        all of them already; across ranks an all-gather."""
        n = self.axis_size(axis) if axis else 1
        if len(values) != n:
            raise ValueError(f"expected {n} values along {axis!r}, got {len(values)}")
        return list(values)

    # ---- a row-sharded batch (the reference's P(axis, None)) -------------

    def row_shares(self, batch: int, axis: Axis) -> list:
        """(lo, hi) of the rows of a [batch, ...] block that each position
        along ``axis`` this mesh holds owns, in position order: ⌈batch / S⌉
        rows a position for S positions, so when S does not divide batch
        the last positions hold fewer, or none (lo == hi), as XLA pads an
        uneven split. Here every position's: together rows [0, batch)."""
        c = -(-batch // self.axis_size(axis))
        return [(min(batch, q * c), min(batch, (q + 1) * c)) for q in self.positions(axis)]

    def all_true(self, flags: Tensor, axis: Axis) -> bool:
        """Whether ``flags`` (a bool per row this mesh holds) is true on
        every row of every position along ``axis``: here one host read of
        the block's flags; across ranks an all-gather of one flag a
        position, folded on the host."""
        self._names(axis)
        return bool(flags.all())

    def gather_rows(self, tensors: Sequence[Tensor], batch: int, axis: Axis) -> list:
        """Each of ``tensors`` (the rows this mesh holds, ``row_shares``)
        as the whole [batch, ...] block, every position's rows in position
        order: here the tensors themselves; across ranks one all-gather."""
        self._names(axis)
        for t in tensors:
            if t.shape[0] != batch:
                raise ValueError(f"expected {batch} rows, got {tuple(t.shape)}")
        return list(tensors)

    def fold_scatter(self, fulls: Sequence[Tensor], entries, over: Axis) -> Tensor:
        """[D, *block] f32: each device's block (``scatter_full`` by
        ``entries``) of the ⊕ of one full tensor a position along ``over``
        (``fulls``, of the positions this mesh holds, in order), folded
        left to right in position order with ``+`` in f32. It is the
        gradient's reduce-scatter over the axes of ``over`` that
        ``entries`` names and all-reduce over the others, with no sum on
        the wire: each device folds the blocks it receives."""
        n = self.axis_size(over) if over else 1
        if len(fulls) != n:
            raise ValueError(f"expected {n} tensors along {over!r}, got {len(fulls)}")
        total = self.scatter_full(fulls[0], entries).float()
        for f in fulls[1:]:
            total = total + self.scatter_full(f, entries)
        return total

    # ---- a checkpoint and a served decision ------------------------------

    def gather_root(self, x: Tensor, entries) -> Tensor:
        """The full tensor of a sharding's blocks ``x`` (``gather_full`` by
        ``entries``) on the host, where the root writes it: here every
        block is at hand; on a ``RankMesh`` a gather to rank 0, None on
        the other ranks."""
        return self.gather_full(x, entries).cpu()

    def share(self, data: bytes) -> bytes:
        """The root's ``data`` (a small host byte string: a step, a
        decision) on every rank: here ``data`` itself; on a ``RankMesh``
        rank 0's, broadcast."""
        return bytes(data)

    def local(self, x: Tensor) -> Tensor:
        """The blocks of a [D, ...] stack of every device's that this mesh
        holds: all of them (a rank of ``RankMesh`` holds its own)."""
        self._check(x)
        return x

    def grid_view(self, x: Tensor) -> Tensor:
        """[D, ...] as [*grid, ...] (same memory)."""
        self._check(x)
        return x.view(*self.grid, *x.shape[1:])

    def flat_view(self, x: Tensor) -> Tensor:
        """[*grid, ...] as [D, ...] (same memory)."""
        k = len(self.grid)
        if tuple(x.shape[:k]) != self.grid:
            raise ValueError(f"expected a leading {self.grid} grid, got {tuple(x.shape)}")
        return x.reshape(self.n_devices, *x.shape[k:])

    # ---- the layout moves of a sharding ---------------------------------

    def _entries(self, entries, ndim: int, keep: Axis) -> Tuple[list, Tuple[str, ...]]:
        """(per-dim axis tuples, padded to ``ndim``; the kept axes), checked:
        every axis named once at most."""
        ents = [() if e is None else ((e,) if isinstance(e, str) else tuple(e))
                for e in entries]
        if len(ents) > ndim:
            raise ValueError(f"{len(ents)} spec entries for {ndim} dims")
        ents += [()] * (ndim - len(ents))
        kept = self._names(keep) if keep else ()
        named = [a for e in ents for a in e] + list(kept)
        if len(set(named)) != len(named) or any(a not in self.axis_names for a in named):
            raise ValueError(f"spec {entries} (keeping {kept}) names an axis twice or an axis "
                             f"not in {self.axis_names}")
        return ents, kept

    def _sizes(self, names) -> list:
        return [self.shape[a] for a in names]

    def gather_full(self, x: Tensor, entries, keep: Axis = ()) -> Tensor:
        """The full tensor that an all-gather of ``x``'s blocks [D, *block]
        over every axis of ``entries`` (one entry per block dim: None, an
        axis or a tuple of axes, major first) leaves on each device. A dim
        sharded over axes A is the blocks of the devices at positions
        0..|A|-1 along A, concatenated; an axis no entry names holds
        copies, and the copy at position 0 is read. ``keep`` names axes
        (the manual axes of a ``shard_map``) whose devices hold different
        tensors: the result is then [|keep|, *full], one per position."""
        self._check(x)
        block = tuple(x.shape[1:])
        ents, kept = self._entries(entries, len(block), keep)
        live = {a for e in ents for a in e} | set(kept)
        xv = x.view(*self.grid, *block)
        xv = xv[tuple(slice(None) if a in live else 0 for a in self.axis_names)]
        rem = [a for a in self.axis_names if a in live]
        order = [rem.index(a) for a in kept]
        for j, e in enumerate(ents):
            order += [rem.index(a) for a in e] + [len(rem) + j]
        xv = xv.permute(order)
        lead = [math.prod(self._sizes(kept))] if kept else []
        full = [b * math.prod(self._sizes(e)) for b, e in zip(block, ents)]
        out = torch.empty(lead + full, dtype=x.dtype, device=x.device)
        out.view(xv.shape).copy_(xv)
        return out

    def scatter_full(self, full: Tensor, entries, keep: Axis = ()) -> Tensor:
        """Each device's block of ``full``, as [D, *block]: the inverse of
        ``gather_full`` (with ``keep``, ``full`` is [|keep|, *full] and a
        device takes the tensor of its position along the kept axes).
        Devices that differ only along an axis no entry names get copies."""
        ents, kept = self._entries(entries, full.dim() - (1 if keep else 0), keep)
        shape = list(full.shape[1:] if kept else full.shape)
        block = []
        for f, e in zip(shape, ents):
            n = math.prod(self._sizes(e))
            if f % n:
                raise ValueError(f"a dim of {f} does not split over {e} ({n} ways)")
            block.append(f // n)
        split, labels = [], []
        if kept:
            if full.shape[0] != math.prod(self._sizes(kept)):
                raise ValueError(f"expected {math.prod(self._sizes(kept))} tensors along "
                                 f"{kept}, got {full.shape[0]}")
            split += self._sizes(kept)
            labels += list(kept)
        for j, (b, e) in enumerate(zip(block, ents)):
            split += self._sizes(e) + [b]
            labels += list(e) + [j]
        v = full.reshape(split)
        live = [a for a in self.axis_names if a in labels]
        v = v.permute([labels.index(t) for t in live + list(range(len(block)))])
        for i, a in enumerate(self.axis_names):
            if a not in live:
                v = v.unsqueeze(i)
        out = torch.empty((self.n_devices, *block), dtype=full.dtype, device=full.device)
        out.view(*self.grid, *block).copy_(v.expand(*self.grid, *block))
        return out
