"""Meshes (``repro.launch.mesh``) as ``core/mesh.py``'s grid of virtual
devices on one card.

``make_mesh`` and ``small_mesh`` build the two-axis ``Mesh``: every sharded
tensor is one tensor ``[D, ...]`` on the card (the CUDA card unless
``device=`` names another). The reference's three-axis pod mesh and its
production meshes of 256 and 512 chips span cards; they wait for the
process-group mesh (ROADMAP.md §1 item 3) and raise.
"""
from __future__ import annotations

from repro_torch.core.mesh import Mesh

_NEEDS_PROCESS_GROUP = ("the process-group mesh (ROADMAP.md §1 item 3), which the port does "
                        "not have yet; the port's mesh is two axes of virtual devices on one card")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 pod (256 chips) or 2x16x16 pods (512 chips):
    raises, since both span cards."""
    chips = 512 if multi_pod else 256
    raise NotImplementedError(f"make_production_mesh ({chips} chips) needs {_NEEDS_PROCESS_GROUP}")


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of ``shape`` (two sizes) named ``axes`` (two names)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != 2 or len(axes) != 2:
        raise NotImplementedError(f"a mesh of shape {shape} over {axes} needs "
                                  f"{_NEEDS_PROCESS_GROUP}")
    return Mesh(shape, axes, device=device)


def small_mesh(data: int = 2, model: int = 2, pod: int = 0, device=None) -> Mesh:
    """The test mesh (data, model); a ``pod`` axis raises."""
    if pod:
        raise NotImplementedError(f"small_mesh(pod={pod}) needs {_NEEDS_PROCESS_GROUP}")
    return make_mesh((data, model), ("data", "model"), device=device)
