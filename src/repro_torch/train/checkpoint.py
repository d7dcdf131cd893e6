"""Checkpoints with a manifest, an atomic commit and async saves
(``repro.train.checkpoint``), restored onto one device.

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
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import NamedSharding, Sharded

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


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (bf16 as uint16 bits; a
    ``Sharded`` leaf as its full tensor)."""
    if isinstance(leaf, Sharded):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def save(ckpt_dir: str, step: int, tree, metadata: Optional[dict] = None,
         blocking: bool = True) -> threading.Thread | None:
    """Write one checkpoint. The leaves are copied to the host before this
    returns; ``blocking=False`` then writes them from a daemon thread (off
    the step's critical path) and returns it."""
    flat = _flatten(tree)
    host = {key: _to_host(leaf) for key, leaf in flat.items()}
    dtypes = {key: ("bfloat16" if isinstance(leaf, (torch.Tensor, Sharded))
                    and leaf.dtype == torch.bfloat16 else str(host[key].dtype))
              for key, leaf in flat.items()}

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


def _load(path: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"]))
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(like, loaded: Dict[str, torch.Tensor], prefix: str = "", shardings=None):
    """``like``'s structure with each tensor leaf overwritten in place by its
    loaded array (shape and dtype checked) and any other leaf replaced; a
    leaf whose ``shardings`` entry is a ``NamedSharding`` comes back as a
    new ``Sharded`` in that sharding, in ``like``'s dtype."""
    def sub(key):   # the shardings of a child: keyed as ``like``'s (positions for tuples)
        return None if shardings is None else shardings[key]
    if isinstance(like, dict):
        return {k: _rebuild(v, loaded, f"{prefix}/{k}" if prefix else str(k), sub(k))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(v, loaded, f"{prefix}/{k}" if prefix else k, sub(i))
                            for i, (k, v) in enumerate(zip(like._fields, like))))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, loaded, f"{prefix}/{i}" if prefix else str(i), sub(i))
                          for i, v in enumerate(like))
    src = loaded[prefix]
    if not isinstance(like, (torch.Tensor, Sharded)):
        return src.numpy()
    if tuple(src.shape) != tuple(like.shape) or src.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {prefix}: {src.dtype} {tuple(src.shape)}, "
                         f"expected {like.dtype} {tuple(like.shape)}")
    if isinstance(shardings, NamedSharding):
        return Sharded.of(src, shardings)
    with torch.no_grad():
        if isinstance(like, Sharded):
            like.blocks.copy_(like.sharding.shard(src))
        else:
            like.copy_(src)
    return like


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """Load checkpoint ``step`` into ``like``'s tensors (in place), or, with
    ``shardings``, into new blocks of those shardings; returns (the tree,
    the saved metadata)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = {key: _load(path, manifest["arrays"][key]) for key in _flatten(like)}
    return _rebuild(like, loaded, shardings=shardings), manifest["metadata"]
