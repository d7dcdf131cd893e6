"""A mesh of one rank per device over a ``torch.distributed`` process
group: one rank's view of ``core/mesh.py``'s mesh.

``RankMesh(shape, axis_names, device)`` has the grid, axis names, flat
ids and axis positions of the global mesh, as ``Mesh`` does, but a
stacked tensor holds the rank's own block alone, ``[1, *block]``
(``stack_size`` is 1), and the rank's flat id is its rank in the default
group. Each primitive of ``Mesh`` is a collective across the ranks and
returns what this rank's device holds after it, so the graph layer's
four phases (``core/distributed.py``, ``core/collectives.py``,
``core/pipeline.py``) and the mesh train steps (``train/train_loop.py``)
run on it as they are, each rank issuing the same collectives in the
same order:

* ``all_gather`` is one all-gather over the rank's group along the axis;
* ``ppermute`` is ``batch_isend_irecv`` with the (src, dst) pairs,
  positions numbered over the named axes in mesh order, as
  ``Mesh.ppermute`` numbers them; a rank that receives nothing gets zeros;
* ``all_to_all`` is ``all_to_all_single`` over the group;
* ``take`` and ``axis_index`` are local;
* ``gather_full`` is an all-gather over the axes the spec names, then a
  local reorder; with ``keep`` it returns ``[1, *full]``, the tensor of
  the rank's own position along the kept axes;
* ``scatter_full`` is the rank's block of a tensor that every rank (of
  one kept position) holds whole: a local cut, as ``Mesh.scatter_full``
  gives each device its block of one full tensor;
* ``fold_scatter`` is an all-to-all over the group along ``over``, each
  member sent its block of the rank's own tensor, then the received
  blocks folded in position order: the gradient's reduce-scatter (or,
  over axes the spec does not name, its all-reduce) of the train step;
* ``gather_positions`` is an all-gather over the group along the axis;
  ``split_rows`` is local, the rank's own rows;
* ``fold_blocks`` all-gathers every rank's partial over the default group
  and folds those of ``devices`` left to right on each rank;
* a row-sharded batch (``graphs/multi.py``): ``row_shares`` is local, the
  rows of the rank's position; ``all_true``, the stopping test, is an
  all-gather along the axis of one flag a position, folded on the host;
  ``gather_rows`` is one all-gather along the axis of the share's rows of
  every tensor given, as bytes side by side, padded to ⌈B / S⌉ rows;
* a checkpoint and a served decision: ``gather_root`` is one
  ``dist.gather`` of every rank's block to rank 0 over the default group
  (only rank 0 receives, and it alone gets the full tensor, on the host);
  ``own_block`` is local, the rank's block of a full array (numpy or
  torch), so a restore reads no more than it; ``share`` is two broadcasts
  from rank 0 (a length, then the bytes) of one small host byte string:
  a step number, or the tickets a poll dispatches.

No primitive reduces on the wire: every collective moves bytes (each
tensor is sent as its ``uint8`` view), and a ⊕ across ranks is the
caller's fold in position order with ``sr.add``, as on the virtual mesh.
So a rank's block equals block ``rank`` of ``Mesh``'s result bit for bit,
floats included. ``all_reduce`` and ``reduce_scatter`` with a sum are
never used.

Transport. The subgroups of every set of axes are created when the mesh
is built, on every rank in the same order (``dist.new_group`` is
collective over the default group). With ``backend="nccl"`` the blocks
stay on the card and NCCL moves them. With ``backend="gloo"`` and CUDA
blocks, each collective copies its operand into a pinned host buffer,
runs on the host and copies the result back: the transport of several
ranks that share one card, where NCCL refuses two ranks on one GPU. The
backend decides it; no backend error is caught and retried on another
transport.

``init_rank_mesh`` joins the process group (from ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` as
``torchrun`` sets them, unless given) and builds the mesh; a process
group that is already joined must be of the backend asked for.
``launch/ranks.py`` starts the ranks of a mesh on one host without
``torchrun``.
"""
from __future__ import annotations

import itertools
import math
import os
from collections import Counter
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.mesh import Axis, Mesh

Tensor = torch.Tensor


def _all_gather_single(out: Tensor, inp: Tensor, group) -> None:
    """``dist.all_gather_single`` where the installed torch has it, else
    its older name ``all_gather_into_tensor``."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _bytes(x: Tensor) -> Tensor:
    """x's bytes as a flat uint8 tensor (a view when x is contiguous)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: Tensor, dtype: torch.dtype, shape) -> Tensor:
    return b.view(dtype).reshape(shape)


class RankMesh(Mesh):
    """One rank's view of a mesh of one rank per device (see the module
    docstring). The default process group must be initialised, with one
    rank per device of ``shape``."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Sequence[str], device):
        if device is None:
            raise ValueError("a RankMesh needs its device named (init_rank_mesh resolves it)")
        super().__init__(shape, axis_names, device=device)
        if not dist.is_initialized():
            raise RuntimeError("RankMesh needs an initialised default process group")
        world = dist.get_world_size()
        if world != self.n_devices:
            raise ValueError(f"a mesh of {self.n_devices} devices needs as many ranks, "
                             f"the process group has {world}")
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend()).lower()
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"the nccl backend moves CUDA tensors; the blocks are on "
                             f"{self.device}")
        self.host_staged = self.backend == "gloo" and self.device.type == "cuda"
        #: the default process group this mesh was built on: two meshes
        #: span the same ranks exactly when they share it
        self.world = dist.group.WORLD
        #: bytes this rank received from other ranks, and the collectives it
        #: issued, by primitive
        self.wire_bytes: Counter = Counter()
        self.calls: Counter = Counter()
        self._pinned: dict = {}
        self._positions: dict = {}
        self._assemblers: dict = {}
        # one group per set of axes, created on every rank in the same order
        self._groups: dict = {}
        for k in range(1, len(self.grid) + 1):
            for names in itertools.combinations(self.axis_names, k):
                if len(names) == len(self.axis_names):
                    self._groups[names] = (None, list(range(self.n_devices)))
                    continue
                mine = None
                for row in self._members(names):
                    ranks = sorted(int(v) for v in row)
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = (g, ranks)
                self._groups[names] = mine
        # the first collective of a group is called by all of its ranks
        self._all_gather_bytes(torch.zeros(1, dtype=torch.uint8, device=self.device), None,
                               self.n_devices, "setup")
        self.wire_bytes.clear()
        self.calls.clear()

    @property
    def stack_size(self) -> int:
        return 1

    # ---- positions and groups ------------------------------------------

    def _row(self, axis: Axis) -> list:
        """This rank's group along ``axis``, flat ids in position order."""
        names = self._names(axis)
        key = tuple(names)
        if key not in self._positions:
            for row in self._members(names):
                if self.rank in row:
                    self._positions[key] = [int(v) for v in row]
        return self._positions[key]

    def _group(self, axis: Axis):
        """(process group, its flat ids ascending) of this rank along
        ``axis`` (the group is a set: every order of the same axes shares it)."""
        names = self._names(axis)
        return self._groups[tuple(a for a in self.axis_names if a in names)]

    def position(self, axis: Axis) -> int:
        """This rank's position along ``axis``."""
        return self._row(axis).index(self.rank)

    def positions(self, axis: Axis) -> list:
        return [self.position(axis)] if axis else [0]

    def _position_of(self, flat: int, axis: Axis) -> int:
        """Device ``flat``'s position along ``axis``."""
        return int(np.nonzero(self._members(axis) == flat)[1][0])

    def axis_index(self, axis: Axis) -> Tensor:
        key = ("index",) + tuple(self._names(axis))
        if key not in self._positions:
            self._positions[key] = torch.tensor([self.position(axis)], dtype=torch.int64,
                                                device=self.device)
        return self._positions[key]

    def local(self, x: Tensor) -> Tensor:
        """This rank's block of a ``[D, ...]`` stack of every device's, as
        ``[1, ...]`` (a copy)."""
        if x.shape[0] != self.n_devices:
            raise ValueError(f"expected a leading device axis of {self.n_devices}, "
                             f"got {tuple(x.shape)}")
        return x[self.rank:self.rank + 1].clone()

    # ---- transport -----------------------------------------------------

    def _host(self, name: str, nbytes: int) -> Tensor:
        """A pinned host buffer of at least ``nbytes``, kept per role and
        grown to twice its size at least (pinning is slow)."""
        buf = self._pinned.get(name)
        if buf is None or buf.numel() < nbytes:
            size = max(nbytes, 1 << 12, 2 * (0 if buf is None else buf.numel()))
            del buf
            self._pinned.pop(name, None)
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            self._pinned[name] = buf
        return buf[:nbytes]

    def _stage_in(self, b: Tensor, name: str) -> Tensor:
        if not self.host_staged:
            return b
        return self._host(name, b.numel()).copy_(b)

    def _out(self, n: int, name: str) -> Tensor:
        if not self.host_staged:
            return torch.empty(n, dtype=torch.uint8, device=self.device)
        return self._host(name, n)

    def _stage_out(self, b: Tensor) -> Tensor:
        return b.to(self.device) if self.host_staged else b

    def _all_gather_bytes(self, b: Tensor, group, size: int, what: str) -> Tensor:
        """[size · n] uint8: every member's n bytes, in ascending flat id."""
        src = self._stage_in(b, "send")
        out = self._out(size * b.numel(), "recv")
        _all_gather_single(out, src, group)
        self.wire_bytes[what] += (size - 1) * b.numel()
        self.calls[what] += 1
        return self._stage_out(out)

    def _gather_blocks(self, block: Tensor, axis: Axis, what: str) -> Tensor:
        """[S, *block]: the blocks of this rank's group along ``axis``, in
        ascending flat id (row-major over the axes in mesh order)."""
        group, ranks = self._group(axis)
        out = self._all_gather_bytes(_bytes(block), group, len(ranks), what)
        return _from_bytes(out, block.dtype, (len(ranks),) + tuple(block.shape))

    # ---- the primitives ------------------------------------------------

    def all_gather(self, x: Tensor, axis: Axis, dim: int = 1) -> Tensor:
        self._check(x)
        if not 1 <= dim < x.dim():
            raise ValueError(f"dim {dim} is not a per-device dim of {tuple(x.shape)}")
        row = self._row(axis)
        _, ranks = self._group(axis)
        got = self._gather_blocks(x[0], axis, "all_gather")        # ascending flat id
        order = torch.tensor([ranks.index(r) for r in row], device=got.device)
        g = got.index_select(0, order).movedim(0, dim - 1)          # position order
        shape = list(x.shape)
        shape[dim] *= len(row)
        return g.reshape(shape[1:])[None]

    def ppermute(self, x: Tensor, axis: Axis, perm: Sequence[Tuple[int, int]]) -> Tensor:
        self._check(x)
        names = self._names(axis)
        row = self._row(tuple(a for a in self.axis_names if a in names))
        me = row.index(self.rank)
        block = x[0].contiguous()
        out = torch.zeros_like(block)
        ops, recv = [], None
        for s, t in perm:
            s, t = int(s), int(t)
            if s == me and t == me:
                out.copy_(block)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, self._stage_in(_bytes(block), "send"), row[t]))
            elif t == me:
                recv = self._out(block.numel() * block.element_size(), "recv")
                ops.append(dist.P2POp(dist.irecv, recv, row[s]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self.calls["ppermute"] += 1
        if recv is not None:
            out.copy_(_from_bytes(self._stage_out(recv), block.dtype, block.shape))
            self.wire_bytes["ppermute"] += recv.numel()
        return out[None]

    def all_to_all(self, x: Tensor, axis: Axis, what: str = "all_to_all") -> Tensor:
        self._check(x)
        row = self._row(axis)
        group, ranks = self._group(axis)
        s = len(row)
        if x.dim() < 2 or x.shape[1] != s:
            raise ValueError(f"all_to_all over {axis!r} needs [1, {s}, ...], "
                             f"got {tuple(x.shape)}")
        # the chunk for the member of ascending index k is chunk pos(member k)
        pos = torch.tensor([row.index(r) for r in ranks], device=x.device)
        send = x[0].index_select(0, pos)
        chunk = send[0].numel() * send.element_size()
        src = self._stage_in(_bytes(send), "send")
        out = self._out(s * chunk, "recv")
        dist.all_to_all_single(out, src, group=group)
        self.wire_bytes[what] += (s - 1) * chunk
        self.calls[what] += 1
        got = _from_bytes(self._stage_out(out), x.dtype, (s,) + tuple(x.shape[2:]))
        inv = torch.argsort(pos)
        return got.index_select(0, inv)[None]                # out[pos(member k)] = got[k]

    def fold_blocks(self, fn, x: Tensor, devices: Sequence[int]) -> Tensor:
        self._check(x)
        part = fn(x[0])
        parts = _from_bytes(self._all_gather_bytes(_bytes(part), None, self.n_devices,
                                                   "fold_blocks"),
                            part.dtype, (self.n_devices,) + tuple(part.shape))
        total = parts[devices[0]]
        for d in devices[1:]:
            total = total + parts[d]
        return total

    def take(self, x: Tensor, idx: Tensor) -> Tensor:
        self._check(x)
        return x[torch.zeros(1, dtype=torch.int64, device=x.device), idx]

    # ---- the layout moves of a sharding ---------------------------------

    def gather_full(self, x: Tensor, entries, keep: Axis = ()) -> Tensor:
        self._check(x)
        block = tuple(x.shape[1:])
        ents, kept = self._entries(entries, len(block), keep)
        named = {a for e in ents for a in e}
        live = [a for a in self.axis_names if a in named]
        full = [b * math.prod(self._sizes(e)) for b, e in zip(block, ents)]
        if live:
            got = self._gather_blocks(x[0], tuple(live), "gather_full")
        else:
            got = x[0][None]
        xv = got.view(*self._sizes(live), *block)
        order = []
        for j, e in enumerate(ents):
            order += [live.index(a) for a in e] + [len(live) + j]
        out = torch.empty(full, dtype=x.dtype, device=x.device)
        out.view([xv.shape[i] for i in order]).copy_(xv.permute(order))
        return out[None] if kept else out

    def _block_of(self, full: Tensor, ents, flat: int) -> Tensor:
        """Device ``flat``'s block of ``full`` by the per-dim axis tuples
        ``ents`` (a view)."""
        idx = []
        for f, e in zip(full.shape, ents):
            n = math.prod(self._sizes(e))
            if f % n:
                raise ValueError(f"a dim of {f} does not split over {e} ({n} ways)")
            b = f // n
            p = self._position_of(flat, e) if e else 0
            idx.append(slice(p * b, (p + 1) * b))
        return full[tuple(idx)]

    def scatter_full(self, full: Tensor, entries, keep: Axis = ()) -> Tensor:
        ents, kept = self._entries(entries, full.dim() - (1 if keep else 0), keep)
        if kept:
            if full.shape[0] != 1:
                raise ValueError(f"a rank holds the tensor of its own position along {kept}: "
                                 f"expected [1, ...], got {tuple(full.shape)}")
            full = full[0]
        return self._block_of(full, ents, self.rank).clone()[None]

    def own_block(self, full, entries):
        """This rank's block of ``full`` (a torch tensor or a numpy array,
        a memory map included) under the spec ``entries``: a view, so a
        copy of it reads the block's bytes alone."""
        ents, _ = self._entries(entries, full.ndim, ())
        return self._block_of(full, ents, self.rank)

    # ---- a checkpoint and a served decision --------------------------------

    def gather_root(self, x: Tensor, entries) -> Tensor | None:
        """The full tensor of a sharding's blocks (``gather_full`` of
        ``x`` [1, *block] by ``entries``) on rank 0, on the host, and None
        on every other rank: one ``dist.gather`` of every rank's block over
        the default group. Only rank 0 receives."""
        self._check(x)
        b = _bytes(x[0])
        n = b.numel()
        src = self._stage_in(b, "send")
        self.calls["gather_root"] += 1
        if self.rank != 0:
            dist.gather(src, None, dst=0)
            return None
        out = self._out(self.n_devices * n, "gather")
        dist.gather(src, list(out.view(self.n_devices, n)), dst=0)
        self.wire_bytes["gather_root"] += (self.n_devices - 1) * n
        if out.device not in self._assemblers:      # the virtual mesh reorders the stack
            self._assemblers[out.device] = Mesh(self.grid, self.axis_names, device=out.device)
        stack = _from_bytes(out, x.dtype, (self.n_devices,) + tuple(x.shape[1:]))
        return self._assemblers[out.device].gather_full(stack, entries).cpu()

    def share(self, data: bytes) -> bytes:
        """Rank 0's ``data`` on every rank (the other ranks' is ignored):
        its length, then its bytes, broadcast from rank 0 over the default
        group; an empty string is one broadcast."""
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        n = torch.tensor([len(data) if self.rank == 0 else 0], dtype=torch.int64, device=dev)
        dist.broadcast(n, src=0)
        k = int(n.item())
        self.calls["share"] += 1
        if self.rank == 0:
            if k:
                dist.broadcast(torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev), src=0)
            return bytes(data)
        buf = torch.empty(k, dtype=torch.uint8, device=dev)
        if k:
            dist.broadcast(buf, src=0)
        self.wire_bytes["share"] += 8 + k
        return buf.cpu().numpy().tobytes()

    def gather_positions(self, values: Sequence[Tensor], axis: Axis) -> list:
        if len(values) != 1:
            raise ValueError(f"a rank holds its own position's value, got {len(values)}")
        if not axis:
            return list(values)
        _, ranks = self._group(axis)
        got = self._gather_blocks(values[0], axis, "gather_positions")     # ascending flat id
        return [got[ranks.index(r)] for r in self._row(axis)]

    # ---- a row-sharded batch ---------------------------------------------

    def all_true(self, flags: Tensor, axis: Axis) -> bool:
        group, ranks = self._group(axis)
        src = self._stage_in(flags.all().reshape(1).to(torch.uint8), "flag")
        out = self._out(len(ranks), "flags")        # on the host when staged
        _all_gather_single(out, src, group)
        self.wire_bytes["all_true"] += len(ranks) - 1
        self.calls["all_true"] += 1
        return bool(out.all())

    def gather_rows(self, tensors: Sequence[Tensor], batch: int, axis: Axis) -> list:
        """One all-gather along ``axis`` of every tensor's rows: each row
        of the rank's share as its bytes, all tensors side by side, padded
        to ⌈batch / S⌉ rows (``all_gather`` needs one shape on every
        rank); the padding is dropped after."""
        (lo, hi), = self.row_shares(batch, axis)
        c = -(-batch // self.axis_size(axis))
        widths = [math.prod(t.shape[1:]) * t.element_size() for t in tensors]
        share = torch.zeros((c, sum(widths)), dtype=torch.uint8, device=self.device)
        a = 0
        for t, w in zip(tensors, widths):
            if t.shape[0] != hi - lo:
                raise ValueError(f"the rank holds rows [{lo}, {hi}), got {tuple(t.shape)}")
            share[: hi - lo, a:a + w] = _bytes(t).view(hi - lo, w)
            a += w
        _, ranks = self._group(axis)
        got = self._gather_blocks(share, axis, "gather_rows")       # ascending flat id
        full = torch.cat([got[ranks.index(r)] for r in self._row(axis)])[:batch]
        out, a = [], 0
        for t, w in zip(tensors, widths):
            out.append(full[:, a:a + w].contiguous().view(t.dtype).view(batch, *t.shape[1:]))
            a += w
        return out

    def fold_scatter(self, fulls: Sequence[Tensor], entries, over: Axis) -> Tensor:
        if len(fulls) != 1:
            raise ValueError(f"a rank holds its own position's tensor, got {len(fulls)}")
        full = fulls[0]
        if not over:
            return self.scatter_full(full, entries).float()
        ents, _ = self._entries(entries, full.dim(), ())
        # the chunk for each member of the group: that member's block
        chunks = torch.stack([self._block_of(full, ents, r) for r in self._row(over)])
        got = self.all_to_all(chunks[None], over, "fold_scatter")[0]    # position order
        total = got[0].float()
        for c in got[1:]:
            total = total + c
        return total[None]


def _env_int(name: str, given) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(f"{name} is not set: run under torchrun or pass it")
    return int(os.environ[name])


def init_rank_mesh(shape, axis_names, backend: str, device=None, init_method: str | None = None,
                   rank: int | None = None, world_size: int | None = None) -> RankMesh:
    """Join the default process group (unless joined, and then over
    ``backend``: another backend raises) and build this rank's
    ``RankMesh``.

    ``rank``, ``world_size`` and ``init_method`` default to ``RANK``,
    ``WORLD_SIZE`` and ``env://`` (``MASTER_ADDR``/``MASTER_PORT``), as
    ``torchrun`` sets them. ``device=None`` is the card ``cuda:LOCAL_RANK``
    and raises if it does not exist; ranks share a card only when the
    caller names it (``device="cuda:0"``), and run on the host only when
    the caller passes ``device="cpu"``."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if device is None:
        local = _env_int("LOCAL_RANK", None) if "LOCAL_RANK" in os.environ else 0
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device cuda:{local} for this rank; pass device= "
                               f"('cpu' to run on the host)")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        joined = str(dist.get_backend()).lower()
        if joined != backend:
            raise RuntimeError(f"the process group is already joined over {joined!r}, "
                               f"not {backend!r}")
    else:
        if init_method is None:
            for k in ("MASTER_ADDR", "MASTER_PORT"):
                if k not in os.environ:
                    raise RuntimeError(f"{k} is not set: run under torchrun or pass init_method")
            init_method = "env://"
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method,
                                rank=_env_int("RANK", rank),
                                world_size=_env_int("WORLD_SIZE", world_size), **kw)
    return RankMesh(tuple(shape), tuple(axis_names), device)
