"""Op-level roofline of one step on one card: the port's counterpart of
``src/repro/launch/hlo_analysis.py``, named for what it reads.

The reference lowers a step through XLA and reads the compiled HLO. Eager
PyTorch has no HLO: every op is its own kernel, and every loop trip runs.
So the port runs the step once under one counting ``TorchDispatchMode``
(``OpCounter``): on meta tensors for a dry run, or on the card to hold the
dry run to it. One pass counts:

* FLOPs, by ``torch.utils.flop_counter``'s formulas, with an op that has
  none decomposed as ``FlopCounterMode`` decomposes it, so the total equals
  ``FlopCounterMode``'s. The count is split by the dtype of the product
  (its first tensor operand).
* HBM bytes: the inputs and outputs of every op that is neither a view
  nor a metadata op (``FREE_OPS``, the counterpart of the reference's
  ``_FREE_OPS``). This is the reference's rule for fusion boundaries, and
  here each op is a boundary. An in-place op counts its read and its
  write. An op that only writes (a fill, a copy into its destination, a
  factory) counts the write; ``empty`` counts nothing. A tensor counts the
  elements it addresses: a broadcast (stride 0) dim counts once.
* A kernel launched through ctypes is no aten op. Its wrapper reports the
  bytes it moves through ``OpCounter.kernel_traffic``, recorded as an op
  of 0 FLOPs (``kernels/moe_dispatch.py``).
* Live and peak bytes: the arguments' storages (``resident``), then each
  new storage's size, added when an op makes it and taken off when it is
  freed (``weakref.finalize``). This works on meta tensors too.
* Each op's caller: the innermost frame in ``src/repro_torch/``, as
  ``file:function``. An op that the autograd engine runs outside any such
  frame is named for its node, as ``autograd:MmBackward0``.

* Collectives: a mesh primitive that one device's step calls on
  ``launch/mesh.py``'s ``DeviceView`` reports itself through
  ``note_collective`` (kind, the bytes the reference's formula reads,
  the flat ids of its group). Its wire bytes per device are the
  reference's (``hlo_analysis.py``), n the group size:
      all-reduce          2 * S * (n-1)/n     (ring RS+AG)
      all-gather          S_full * (n-1)/n
      reduce-scatter      S_shard * (n-1)
      all-to-all          S * (n-1)/n
      collective-permute  S
  A group within one NVLink domain (``NODE_SIZE`` consecutive flat ids,
  one HGX H100 node: the counterpart of the reference's ``pod_size``)
  adds to ``ici_bytes``, a group that spans nodes to ``dcn_bytes``; the
  keys keep the reference's names. A collective moves no HBM bytes here,
  as in the reference.

What has no counterpart: the HLO parser, the multiplication of while
bodies by their trip counts (eager runs every trip) and
``normalize_cost_analysis`` (there is no ``cost_analysis`` to normalise).
On one card the collective fields are 0; ``unknown_trip_loops`` is 0.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM, data sheet, dense rates: the card that chip_smoke.py runs
# on reports "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi --query-gpu=
# name,power.limit --format=csv,noheader), and these rates assume that
# 700 W limit. The port leaves TF32 off, so an f32 product runs at the CUDA
# cores' fp32 rate; a dtype not listed is priced at it too.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12            # bytes/s
HBM_BYTES = 80e9            # the data sheet's memory; a present card's own is read
# The interconnect of a multi-node H100 SXM cluster, data-sheet constants:
# NVLink 4 gives each H100 SXM 900 GB/s, 450 GB/s a direction, to the
# other cards of its 8-card HGX node; between nodes each card has one NDR
# InfiniBand link of 400 Gb/s, 50 GB/s.
NODE_SIZE = 8
NVLINK_BW = 450e9           # bytes/s a direction per card, inside a node
IB_BW = 50e9                # bytes/s per card, between nodes

_PRIM_DEVICE = torch.ops.prim.device.default
# ops that move no HBM bytes beside the views (``OpOverload.is_view``):
# allocation without a fill, aliasing and metadata; none is recorded.
# ``lift_fresh`` marks a tensor made from Python data (``torch.tensor``),
# and is dispatched for one on the card or the host but not on meta
FREE_OPS = frozenset({
    "aten.lift_fresh", "aten._unsafe_view", "aten.empty", "aten.empty_like",
    "aten.empty_strided", "aten.new_empty", "aten.new_empty_strided", "aten.resize_",
    "aten.set_", "aten.record_stream", "aten._has_compatible_shallow_copy_type",
    "aten.is_same_size", "prim.device",
})
# in-place ops that write self without reading it
_WRITE_ONLY = frozenset({
    "aten.fill_", "aten.zero_", "aten.copy_", "aten.normal_", "aten.uniform_",
    "aten.random_", "aten.bernoulli_", "aten.exponential_", "aten.geometric_",
    "aten.log_normal_", "aten.cauchy_",
})
# factories that take a tensor for its metadata only
_LIKE = frozenset({
    "aten.zeros_like", "aten.ones_like", "aten.full_like", "aten.rand_like",
    "aten.randn_like", "aten.randint_like", "aten.new_zeros", "aten.new_ones",
    "aten.new_full",
})

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_SELF = os.path.abspath(__file__)


class OpRecord(NamedTuple):
    op: str                 # "aten.mm", or the name of a kernel that reported its bytes
    caller: str             # "models/moe.py:moe_sparse", or "autograd:<node>"
    flops: int
    dtype: Optional[str]    # the product's dtype where flops > 0
    bytes: int


@dataclasses.dataclass
class Analysis:
    flops: float                    # the step's, every loop trip run
    hbm_bytes: float
    wire_bytes: float               # collectives: 0 on one card
    by_kind: Dict[str, float]
    n_collectives: int
    unknown_trip_loops: int         # eager runs every trip: 0
    ici_bytes: float
    dcn_bytes: float
    flops_by_dtype: Dict[str, float]
    argument_bytes: int             # the resident storages' bytes when the step began
    peak_bytes: int                 # the most live bytes, arguments included
    ops: List[OpRecord]
    collectives: List["CollectiveRecord"] = dataclasses.field(default_factory=list)


class CollectiveRecord(NamedTuple):
    kind: str               # "all-gather", "reduce-scatter", ...
    caller: str
    nbytes: int             # S of the wire-bytes formula
    group: int              # n, the group size
    crosses_node: bool
    wire_bytes: float


def wire_bytes(kind: str, size: int, n: int) -> float:
    """Bytes one device puts on the wire (the reference's formulas)."""
    frac = (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return 2.0 * size * frac
    if kind == "all-gather":
        return size * frac                    # size = the full gathered result
    if kind == "reduce-scatter":
        return float(size * (n - 1))          # size = the scattered shard
    if kind == "all-to-all":
        return size * frac
    if kind == "collective-permute":
        return float(size)                    # one hop
    raise ValueError(f"unknown collective {kind!r}")


def note_collective(kind: str, nbytes: int, members) -> None:
    """Report one collective to each active dispatch mode that counts
    them (``OpCounter.collective``); with none active this does nothing."""
    if torch._C._len_torch_dispatch_stack():
        for mode in _get_current_dispatch_mode_stack():
            note = getattr(mode, "collective", None)
            if note is not None:
                note(kind, nbytes, members)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a dim of stride 0 counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride or not size:
            n *= size
    return n * t.element_size()


def tree_tensors(tree):
    """The tensors of a tree of lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)


def _op_bytes(name: str, func, args, kwargs, out) -> int:
    """HBM bytes of one op by the module's rule."""
    if func.is_view:
        return 0
    written = sum(tensor_bytes(t) for t in tree_tensors(out))
    if name in _LIKE:
        return written
    read = 0
    schema = func._schema.arguments
    for i, a in enumerate(args):
        if name in _WRITE_ONLY and i == 0:
            continue
        read += sum(tensor_bytes(t) for t in tree_tensors(a))
    outs = {a.name for a in schema if a.is_out}
    for k, v in kwargs.items():
        if k not in outs:
            read += sum(tensor_bytes(t) for t in tree_tensors(v))
    return read + written


class OpCounter(TorchDispatchMode):
    """Counts every op run under it (see the module). ``resident``: the
    tensors alive when the step begins (parameters, optimizer state,
    inputs, caches); their distinct storages are the argument bytes.
    ``held``: tensors alive when it begins that are none of its arguments
    (a mesh step's working copy of the weights): live bytes, and so
    temps, but not arguments."""

    def __init__(self, resident=(), held=()):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.collectives: List[CollectiveRecord] = []
        self.flops_by_dtype: Dict[str, float] = {}
        self.hbm_bytes = 0
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        for t in tree_tensors(resident):
            self._track(t)
        self.argument_bytes = self.live_bytes
        for t in tree_tensors(held):
            self._track(t)
        self.peak_bytes = self.live_bytes
        self._callers: Dict[object, str] = {}     # code object -> caller name, "" outside

    # ---- live bytes -------------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # ---- callers ----------------------------------------------------------

    def _caller(self, depth: int = 2) -> str:
        f = sys._getframe(depth)
        while f is not None:
            code = f.f_code
            name = self._callers.get(code)
            if name is None:
                fn = os.path.abspath(code.co_filename)
                name = ""
                if fn.startswith(_PKG) and fn != _SELF:
                    rel = os.path.relpath(fn, _PKG).replace(os.sep, "/")
                    name = f"{rel}:{code.co_qualname}"
                self._callers[code] = name
            if name:
                return name
            if code.co_name == "_engine_run_backward":
                break       # an engine-run op: the card runs it on a thread with no frames
            f = f.f_back
        node = torch._C._current_autograd_node()
        return f"autograd:{node.name()}" if node is not None else "(outside the port)"

    # ---- the mode ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not _PRIM_DEVICE:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not func.is_view:
            for t in tree_tensors(out):
                self._track(t)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        name = str(func._overloadpacket)
        if name in FREE_OPS:
            return out
        flops, dtype = 0, None
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = int(formula(*args, **kwargs, out_val=out))
            first = next(tree_tensors(args), None)
            dtype = str(first.dtype).removeprefix("torch.") if first is not None else None
            self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0) + flops
        nbytes = _op_bytes(name, func, args, kwargs, out)
        self.hbm_bytes += nbytes
        self.ops.append(OpRecord(name, self._caller(), flops, dtype, nbytes))
        return out

    def kernel_traffic(self, name: str, nbytes: int) -> None:
        """A hand-written kernel's launch (or its meta stand-in) and the
        bytes it moves: an op of 0 FLOPs."""
        self.hbm_bytes += nbytes
        # the frame that called the kernel's wrapper (through ``_note_traffic``)
        self.ops.append(OpRecord(name, self._caller(4), 0, None, int(nbytes)))

    def collective(self, kind: str, nbytes: int, members) -> None:
        """One collective of one device: ``members`` are the flat ids of
        its group; a group of one moves nothing and is not recorded."""
        ids = [int(m) for m in members]
        if len(ids) < 2:
            return
        crosses = len({m // NODE_SIZE for m in ids}) > 1
        self.collectives.append(CollectiveRecord(
            kind, self._caller(4), int(nbytes), len(ids), crosses,
            wire_bytes(kind, int(nbytes), len(ids))))

    def analysis(self) -> Analysis:
        by_kind: Dict[str, float] = {}
        ici = dcn = 0.0
        for c in self.collectives:
            by_kind[c.kind] = by_kind.get(c.kind, 0.0) + c.wire_bytes
            if c.crosses_node:
                dcn += c.wire_bytes
            else:
                ici += c.wire_bytes
        return Analysis(
            flops=float(sum(self.flops_by_dtype.values())), hbm_bytes=float(self.hbm_bytes),
            wire_bytes=ici + dcn, by_kind=by_kind, n_collectives=len(self.collectives),
            unknown_trip_loops=0, ici_bytes=ici, dcn_bytes=dcn,
            flops_by_dtype=dict(self.flops_by_dtype), argument_bytes=self.argument_bytes,
            peak_bytes=self.peak_bytes, ops=self.ops, collectives=list(self.collectives))


def analyze(fn, *args, resident=(), held=(), **kwargs):
    """Run ``fn(*args, **kwargs)`` once under an ``OpCounter``; returns
    (its result, the ``Analysis``). ``resident`` and ``held`` as
    ``OpCounter``'s."""
    with OpCounter(resident, held) as counter:
        out = fn(*args, **kwargs)
    return out, counter.analysis()


def roofline_terms(analysis: Analysis) -> Dict:
    """The step's least time on one card, in seconds, with the reference's
    keys: FLOPs at the peak of their dtype, bytes at the HBM rate, wire
    bytes inside a node at NVLink's rate and between nodes at
    InfiniBand's (0 on one card)."""
    compute_s = sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                    for dt, f in analysis.flops_by_dtype.items())
    memory_s = analysis.hbm_bytes / HBM_BW
    collective_s = analysis.ici_bytes / NVLINK_BW + analysis.dcn_bytes / IB_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "ici_bytes": analysis.ici_bytes,
        "dcn_bytes": analysis.dcn_bytes,
        "dominant": dominant,
        "bound_s": max(compute_s, memory_s, collective_s),
    }
