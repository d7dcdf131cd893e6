"""Meshes (``repro.launch.mesh``) as ``core/mesh.py``'s grid of virtual
devices on one card.

``make_mesh``, ``small_mesh`` and ``make_production_mesh`` build a
``Mesh`` of one to three named axes, the reference's ``("data", "model")``
and ``("pod", "data", "model")`` among them: every sharded tensor is one
tensor ``[D, ...]`` on the card (the CUDA card unless ``device=`` names
another). The LM sharding layer, the mesh train steps and the elastic
restore run on it (``distributed/sharding.py``, ``train/train_loop.py``,
``train/checkpoint.py``). The production meshes of 256 and 512 virtual
devices are built like any other; what runs on them is bounded by the
card's memory, since every device's blocks live on the one card.

``rank_mesh`` is the same (data, model) or (pod, data, model) mesh with
one rank per device over a process group (``core/rank_mesh.py``): each
rank holds its own blocks on its own card (``cuda:LOCAL_RANK``, or the
device named), and every mesh primitive is a collective across the
ranks. ``launch/device_view.py`` is one device of such a mesh as the dry
run counts it.
"""
from __future__ import annotations

from repro_torch.core.mesh import Mesh
from repro_torch.core.rank_mesh import RankMesh, init_rank_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's 16x16 pod (256 devices) or 2x16x16 pods (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device)


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` (one to three of each)."""
    return Mesh(tuple(shape), tuple(axes), device=device)


def small_mesh(data: int = 2, model: int = 2, pod: int = 0, device=None) -> Mesh:
    """The test mesh (data, model), or (pod, data, model) when ``pod`` is set."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"), device=device)
    return make_mesh((data, model), ("data", "model"), device=device)


def rank_mesh(data: int = 2, model: int = 2, pod: int = 0, backend: str = "nccl",
              device=None, **init) -> RankMesh:
    """This rank's view of ``small_mesh(data, model, pod)`` with one rank
    per device, over the default process group (joined by
    ``init_rank_mesh`` from the torchrun environment unless ``init`` gives
    ``init_method``, ``rank`` and ``world_size``)."""
    if pod:
        return init_rank_mesh((pod, data, model), ("pod", "data", "model"), backend,
                              device=device, **init)
    return init_rank_mesh((data, model), ("data", "model"), backend, device=device, **init)
