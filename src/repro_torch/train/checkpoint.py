"""Checkpoints with a manifest, an atomic commit and async saves
(``repro.train.checkpoint``), restored onto one device or any mesh.

Layout: <dir>/step_<N>/
    manifest.json        {"step", "metadata", "arrays": {key: {file, shape, dtype}}}
    <key>.npy            one array per leaf (the key path, "/" as "__")
    COMMITTED            sentinel written last: readers ignore dirs without it

The tree is written under ``.tmp_step_<N>`` and renamed into place, as in
the reference, so its ``latest_step`` finds the port's checkpoints. Keys
join dict keys, NamedTuple field names and list indices with "/". numpy
has no bfloat16 of its own, so a bf16 leaf is written as its uint16 bits
with the manifest dtype ``"bfloat16"``, and restored bit for bit.

``restore`` copies each array into the matching tensor of ``like``, which
keeps its storage, device and dtype: a model's parameters stay the
parameters the model holds. A ``distributed.sharding.Sharded`` leaf (a
tensor held as per-device blocks on a mesh) is written as its full
tensor and restored into its blocks. With ``shardings`` (a tree of
``NamedSharding`` leaves, as ``like``) each full leaf is cut into the
blocks of that sharding instead: a checkpoint written on one mesh
restores onto another, the reference's elastic re-shard.

On a ``core.rank_mesh.RankMesh`` a checkpoint is still one directory for
the whole mesh, in this layout and byte for byte the virtual mesh's:
``save`` is a collective whose leaves are gathered to rank 0, which alone
writes; ``restore`` needs no collective, each rank memory-mapping the
files and reading its own blocks. So a run on (2, 2) ranks restores onto
(4, 1), (1, 4), fewer ranks or one process, and the reference's
``latest_step`` and ``restore`` read it.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.rank_mesh import RankMesh
from repro_torch.distributed.sharding import NamedSharding, Sharded, rank_mesh_of

_SENTINEL = "COMMITTED"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{key path: leaf} in tree order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_host(t: torch.Tensor, fresh: bool = False) -> np.ndarray:
    """A tensor as a numpy array of its own (bf16 as uint16 bits); a
    ``fresh`` host tensor is not copied again."""
    t = t.detach()
    if not (fresh and t.device.type == "cpu"):
        t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(ckpt_dir: str, step: int, tree, metadata: Optional[dict] = None,
         blocking: bool = True) -> threading.Thread | None:
    """Write one checkpoint. The leaves are copied to the host before this
    returns; ``blocking=False`` then writes them from a daemon thread (off
    the step's critical path) and returns it.

    On a ``RankMesh`` (the tree's ``Sharded`` leaves lie on one) the save
    is a collective: every rank calls it with the same tree. Leaf by leaf,
    in the tree's order, each ``Sharded`` leaf is gathered to rank 0
    (``RankMesh.gather_root``); rank 0 alone keeps the host copy, copies
    the plain leaves and writes the one ``step_<N>`` directory, the same
    files as the virtual mesh's. Every other rank writes nothing and
    returns None."""
    flat = _flatten(tree)
    mesh = rank_mesh_of(tree)
    writer = mesh is None or mesh.rank == 0
    host, dtypes = {}, {}
    for key, leaf in flat.items():
        if isinstance(leaf, Sharded):
            full = leaf.sharding.mesh.gather_root(leaf.blocks, leaf.sharding.spec)
            if full is not None:
                host[key] = _to_host(full, fresh=True)
        elif writer:
            host[key] = (_to_host(leaf) if isinstance(leaf, torch.Tensor)
                         else np.array(leaf))
        if writer:
            dtypes[key] = ("bfloat16" if isinstance(leaf, (torch.Tensor, Sharded))
                           and leaf.dtype == torch.bfloat16 else str(host[key].dtype))
    if not writer:
        return None

    def write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "metadata": metadata or {}, "arrays": {}}
        for key, arr in host.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["arrays"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": dtypes[key]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, _SENTINEL), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, _SENTINEL)):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _load(path: str, entry: dict, key: str, like, sharding):
    """One leaf of the checkpoint at ``path`` into ``like``'s place: into
    ``like``'s blocks (a ``Sharded``) or its storage (a tensor) in place,
    or, with a ``NamedSharding``, a new ``Sharded`` of it; any other leaf
    as a numpy array. The file is memory-mapped: a rank of a ``RankMesh``
    reads its own block alone, and no more than one leaf is on the host."""
    def as_tensor(arr: np.ndarray) -> torch.Tensor:     # bf16 from its uint16 bits
        if entry["dtype"] == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)

    shape = tuple(entry["shape"])
    dtype = (torch.bfloat16 if entry["dtype"] == "bfloat16"
             else torch.from_numpy(np.empty(0, np.dtype(entry["dtype"]))).dtype)
    if isinstance(like, (torch.Tensor, Sharded)) and (
            shape != tuple(like.shape) or dtype != like.dtype):
        raise ValueError(f"checkpoint leaf {key}: {dtype} {shape}, "
                         f"expected {like.dtype} {tuple(like.shape)}")
    mapped = math.prod(shape) > 0
    arr = np.load(os.path.join(path, entry["file"]), mmap_mode="r" if mapped else None)
    target = (sharding if isinstance(sharding, NamedSharding)
              else like.sharding if isinstance(like, Sharded) else None)
    if target is None:
        full = as_tensor(np.array(arr))
        if not isinstance(like, torch.Tensor):
            return full.numpy()
        with torch.no_grad():
            like.copy_(full)
        return like
    mesh = target.mesh
    if isinstance(mesh, RankMesh):
        own = np.array(mesh.own_block(arr, target.spec))
        blocks = as_tensor(own).to(mesh.device)[None]
    else:
        blocks = target.shard(as_tensor(np.array(arr)))
    del arr
    if isinstance(sharding, NamedSharding):
        return Sharded(blocks, target, shape)
    with torch.no_grad():
        like.blocks.copy_(blocks)
    return like


def _rebuild(like, load, prefix: str = "", shardings=None):
    """``like``'s structure with each leaf replaced by ``load(key, leaf,
    its shardings entry)``, leaf by leaf in the tree's order."""
    def sub(key):   # the shardings of a child: keyed as ``like``'s (positions for tuples)
        return None if shardings is None else shardings[key]
    if isinstance(like, dict):
        return {k: _rebuild(v, load, f"{prefix}/{k}" if prefix else str(k), sub(k))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, load, f"{prefix}/{k}" if prefix else k, sub(i))
                            for i, (k, v) in enumerate(zip(like._fields, like))))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, load, f"{prefix}/{i}" if prefix else str(i), sub(i))
                          for i, v in enumerate(like))
    return load(prefix, like, shardings)


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """Load checkpoint ``step`` into ``like``'s tensors (in place), or, with
    ``shardings``, into new blocks of those shardings; returns (the tree,
    the saved metadata). No collective: on a ``RankMesh`` each rank reads
    the manifest and then, leaf by leaf, its own block of each file."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = manifest["arrays"]
    tree = _rebuild(like, lambda key, leaf, sh: _load(path, arrays[key], key, leaf, sh),
                    shardings=shardings)
    return tree, manifest["metadata"]
