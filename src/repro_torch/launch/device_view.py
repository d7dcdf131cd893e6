"""One device of a mesh as the dry run counts it (``launch/dryrun.py``).

``DeviceView`` stands for device 0 of a ``core.mesh.Mesh``: a step run on
it holds that device's blocks alone and reports each mesh primitive as
the collective it stands for. ``device_step`` builds device 0's step of
a dry-run cell on it, with its arguments: the train cells through
``train_loop.make_train_step``, prefill and decode through the serve
steps with the weights and the cache gathered from their blocks (see
``launch/dryrun.py`` for the placement and how it differs from XLA's).
Every device's counts are the same, so device 0's are the record's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.convert import leaf_at, param_layout
from repro_torch.core.mesh import Mesh
from repro_torch.distributed.sharding import (
    Sharded, batch_axes, entry_axes, param_shardings, tree_map, zero1_shardings,
)
from repro_torch.launch import op_analysis
from repro_torch.models.attention import TensorSpec
from repro_torch.models.params import P_
from repro_torch.models.transformer import Model, cache_specs, model_specs
from repro_torch.serve.engine import make_prefill_step, make_serve_step
from repro_torch.serve.kv_cache import cache_shardings
from repro_torch.train.optimizer import OptState
from repro_torch.train.train_loop import make_train_step


class DeviceView(Mesh):
    """One device's view of ``mesh`` for a dry run on meta: device 0's
    step, the step of one rank of a mesh of one rank per card.

    The axes and their sizes are the mesh's, so every sharding, spec and
    block shape is; but a stacked tensor holds this device's block alone,
    ``[1, *block]`` (``stack_size`` is 1). Each primitive returns what
    device 0 holds after it, as a new (meta) tensor, and reports the
    collective it stands for to the op counter
    (``op_analysis.note_collective``), with device 0's group:

    * ``gather_full`` is an all-gather over the axes its spec names, of
      the full tensor (one per kept position);
    * ``all_gather`` is an all-gather over its axis, of the result;
    * ``fold_scatter`` (the mesh train step's gradient cut) and
      ``scatter_full`` are only given a contribution: its block of the sum
      over the batch axes. It is a reduce-scatter of the block over the
      batch axes the spec names and an all-reduce of the block over the
      batch axes it does not: the devices of one (pod, data) group
      computed the same contribution, and the cut along their other axes
      is local;
    * the step's batch is the device's own rows (``device_step``), so
      ``split_rows`` keeps it whole, and ``positions`` is device 0's;
      ``gather_positions`` is an all-gather over its axis;
    * ``fold_blocks`` is an all-reduce of the partial over the holders;
    * ``ppermute`` is a collective-permute, ``all_to_all`` an all-to-all.
    """

    def __init__(self, mesh: Mesh):
        super().__init__(mesh.grid, mesh.axis_names, device="meta")

    @property
    def stack_size(self) -> int:
        return 1

    def group(self, axes) -> list:
        """Flat ids of device 0's group over ``axes`` (none: itself)."""
        return [int(v) for v in self._members(axes)[0]] if axes else [0]

    def _note(self, kind: str, nbytes: int, axes) -> None:
        op_analysis.note_collective(kind, nbytes, self.group(axes))

    @staticmethod
    def _nbytes(shape, dtype) -> int:
        return math.prod(shape) * torch.empty((), dtype=dtype).element_size()

    def gather_full(self, x, entries, keep=()):
        self._check(x)
        block = tuple(x.shape[1:])
        ents, kept = self._entries(entries, len(block), keep)
        full = [b * math.prod(self._sizes(e)) for b, e in zip(block, ents)]
        lead = [math.prod(self._sizes(kept))] if kept else []
        self._note("all-gather", self._nbytes(full, x.dtype),
                   tuple(a for e in ents for a in e))
        return torch.empty(lead + full, dtype=x.dtype, device=x.device)

    def scatter_full(self, full, entries, keep=()):
        ents, kept = self._entries(entries, full.dim() - (1 if keep else 0), keep)
        shape = list(full.shape[1:] if kept else full.shape)
        block = [f // math.prod(self._sizes(e)) for f, e in zip(shape, ents)]
        named = {a for e in ents for a in e}
        batch = [a for a in ("pod", "data") if a in self.axis_names]
        nbytes = self._nbytes(block, full.dtype)
        self._note("reduce-scatter", nbytes, tuple(a for a in batch if a in named))
        self._note("all-reduce", nbytes, tuple(a for a in batch if a not in named))
        return torch.empty([1] + block, dtype=full.dtype, device=full.device)

    def fold_scatter(self, fulls, entries, over):
        return self.scatter_full(fulls[0], entries)

    def positions(self, axis) -> list:
        return [0]

    def split_rows(self, x, axis) -> list:
        return [x]

    def gather_positions(self, values, axis) -> list:
        n = self.axis_size(axis) if axis else 1
        v = values[0]
        self._note("all-gather", n * self._nbytes(v.shape, v.dtype), self._names(axis) if axis
                   else ())
        return [torch.empty_like(v) for _ in range(n)]

    def all_gather(self, x, axis, dim: int = 1):
        self._check(x)
        shape = list(x.shape)
        shape[dim] *= self.axis_size(axis)
        self._note("all-gather", self._nbytes(shape[1:], x.dtype), self._names(axis))
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    def fold_blocks(self, fn, x, devices):
        self._check(x)
        part = fn(x[0])
        op_analysis.note_collective("all-reduce", self._nbytes(part.shape, part.dtype),
                                    list(devices))
        return part

    def ppermute(self, x, axis, perm):
        self._check(x)
        self._note("collective-permute", self._nbytes(x.shape[1:], x.dtype), self._names(axis))
        return torch.empty_like(x)

    def all_to_all(self, x, axis):
        self._check(x)
        self._note("all-to-all", self._nbytes(x.shape[1:], x.dtype), self._names(axis))
        return torch.empty_like(x)


def _is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def blocks_of(tree):
    """The block stacks of a tree of ``Sharded`` leaves, for the counter."""
    return tree_map(lambda s: s.blocks if _is_sharded(s) else s, tree, is_leaf=_is_sharded)


def _device_blocks(specs, shardings, is_leaf, dtype=None):
    """Device 0's blocks of every leaf of a spec tree, as ``Sharded`` on a
    ``DeviceView`` ([1, *block] meta tensors, in each spec's dtype unless
    ``dtype`` is given)."""
    def one(spec, sh):
        return Sharded(torch.empty((1,) + sh.shard_shape(spec.shape),
                                   dtype=dtype or spec.dtype, device="meta"), sh, spec.shape)
    return tree_map(one, specs, shardings, is_leaf=is_leaf)


def _rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """A device's own [rows, ...] of a [GB, ...] input (a new tensor, so
    its storage holds those rows alone)."""
    return torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)


def _unstack_cache(stacked, specs) -> dict:
    """The model's cache (per segment, one cache per layer or site, as
    ``Model.init_cache``) as views of stacked [L, ...] tensors."""
    out = {}
    for name, spec in specs.items():
        lead = 2 if name == "mlstm" else 1

        def layer(tree, sp, i):
            if isinstance(sp, TensorSpec):
                return tree.reshape((-1,) + tuple(tree.shape[lead:]))[i]
            return type(sp)(*(0 if f == "pos" else layer(t, v, i)
                              for f, t, v in zip(sp._fields, tree, sp)))

        first = stacked[name]
        while not isinstance(first, torch.Tensor):
            first = first[0]
        out[name] = [layer(stacked[name], spec, i)
                     for i in range(math.prod(first.shape[:lead]))]
    return out


def _mesh_serve_step(model: Model, view: DeviceView, inner, c_specs):
    """``inner`` (a prefill or serve step) as device 0 runs it on the
    mesh: every leaf gathered from its parameter blocks into the model's
    working copy, each cache leaf gathered from its block over its axes
    other than the batch's (the device's rows, whole), the step, and each
    leaf's new rows cut back to the device's block."""
    layout = param_layout(model.cfg)
    own = dict(model.named_parameters())
    data = set(batch_axes(view))

    def step(params, cache, *args):
        with torch.no_grad():
            for name, _, parts in layout:
                full = leaf_at(params, name).full()
                for p, idx in parts:
                    own[p].copy_(full[idx] if idx else full)
                del full

        def gather(s: Sharded):
            ents = [None if set(entry_axes(e)) <= data else e for e in s.sharding.spec]
            return view.gather_full(s.blocks, ents)

        rows = tree_map(gather, cache, is_leaf=_is_sharded)
        *out, new = inner(*args, _unstack_cache(rows, c_specs))
        del new

        def cut(g: torch.Tensor, s: Sharded):
            idx = tuple(slice(0, b) for b in s.block_shape)
            return g[idx].clone()[None]

        return (*out, tree_map(cut, rows, cache, is_leaf=lambda x: isinstance(x, torch.Tensor)))

    return step


def device_step(model: Model, view: DeviceView, cfg, shape, tcfg, ins):
    """(device 0's step, its arguments) for one cell: ``tcfg`` (train) is
    already clamped; ``ins`` are ``zoo.input_specs``' meta inputs."""
    dsize = math.prod(view.shape[a] for a in batch_axes(view))
    b = shape.global_batch
    rows = b // dsize if b % dsize == 0 else b
    specs = model_specs(cfg)
    is_p = lambda x: isinstance(x, P_)                   # noqa: E731
    params = _device_blocks(specs, param_shardings(view, specs), is_p)
    if shape.kind == "train":
        zs = zero1_shardings(view, specs)
        opt = OptState(torch.zeros((), dtype=torch.int32, device="meta"),
                       *(_device_blocks(specs, zs, is_p, torch.float32) for _ in range(3)))
        batch = {k: _rows(v, rows) for k, v in ins["batch"].items()}
        return make_train_step(model, view, tcfg), (params, opt, batch)
    c_specs = cache_specs(cfg, b, shape.seq_len)
    is_t = lambda x: isinstance(x, TensorSpec)           # noqa: E731
    cache = _device_blocks(c_specs, cache_shardings(view, cfg, b, shape.seq_len), is_t)
    if shape.kind == "prefill":
        batch = ins["batch"]
        args = tuple(None if batch.get(k) is None else _rows(batch[k], rows)
                     for k in ("tokens", "image_embeds", "frames"))
        inner = make_prefill_step(model)

        def prefill(tokens, image_embeds, frames, c):
            return inner(tokens, c, image_embeds, frames)
        return _mesh_serve_step(model, view, prefill, c_specs), (params, cache, *args)
    vis = ins.get("vision_kv")
    args = (_rows(ins["token"], rows), None if vis is None else _rows(vis, rows))
    inner = make_serve_step(model)

    def decode(token, vision_kv, c):
        return inner(token, c, vision_kv)
    return _mesh_serve_step(model, view, decode, c_specs), (params, cache, *args)
