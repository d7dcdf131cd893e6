"""``core.rank_mesh.RankMesh`` on 4 and 8 gloo ranks on the CPU, held to
the virtual mesh (``core.mesh.Mesh``) bit for bit and to the JAX
package's distributed matvec.

The ranks are started once per world size (module-scoped fixtures,
``run_ranks`` from a fork server: a ``file://`` rendezvous in a fresh
directory, one torch thread each) and run every case of ``torch_rank_cases``; each test holds
each rank's result to block ``rank`` of the same call on ``Mesh``:

* every primitive (``all_gather``, ``ppermute``, ``all_to_all``,
  ``axis_index``, ``take``, ``gather_full``, ``scatter_full``,
  ``fold_blocks``, and the train step's ``fold_scatter``,
  ``gather_positions`` and ``split_rows``) over every axis and axis
  tuple of one-, two- and three-axis meshes, ``torch.equal``;
* the distributed matvec (row, col, 2d; spmv, spmspv, fused, every Merge
  topology, the compressed Load, csr/csc/coo parts), the batched calls,
  SpGEMM (masked and not) and ``iterate_phases`` at depth 0 and 2 on a
  (2, 4) mesh of float ⟨+,×⟩ and ⟨min,+⟩ and ⟨∨,∧⟩ data, ``torch.equal``;
* the row, col and 2d flat unfused matvec (the cases the JAX mesh runs
  under jax 0.9, ``test_torch_distributed.py``'s module subprocess on 8
  forced host devices) equal to the JAX package's: ⟨min,+⟩ and ⟨∨,∧⟩
  exactly, ⟨+,×⟩ within rtol 1e-5 (XLA's ``psum_scatter`` order is its own).

Also: ``init_rank_mesh`` with no card and ``device=None`` raises, and so
does its call over another backend than a joined group's; a ``RankMesh``
without a process group raises.
"""
import numpy as np
import pytest
import torch

import torch_rank_cases as cases
from repro_torch.core import semiring as tsemiring
from repro_torch.core.mesh import Mesh
from repro_torch.core.rank_mesh import RankMesh, init_rank_mesh
from repro_torch.launch.ranks import run_ranks
from test_torch_distributed import STRATEGIES, check, jax_mesh_outputs  # noqa: F401

tpart = cases.tpart


@pytest.fixture(scope="module")
def primitive_runs():
    """{world: every rank's results}, one start of the ranks per world size."""
    return {w: run_ranks(cases.run_primitives, w, timeout=300) for w in (4, 8)}


@pytest.fixture(scope="module")
def jax_inputs(jax_mesh_outputs):
    out = jax_mesh_outputs
    inputs = {}
    for key in out:
        if key.count("/") != 4:
            continue
        sr_name, strategy, fmt, kernel, balance = key.split("/")
        fill = np.inf if sr_name == "min_plus" else 0
        inputs[key] = (out["rows"], out["cols"], out[f"{sr_name}/vals"], out[f"{sr_name}/x"],
                       fill, fmt, strategy, kernel, balance)
    return inputs


@pytest.fixture(scope="module")
def graph_runs(jax_inputs):
    return run_ranks(cases.run_graph, 8, jax_inputs, timeout=300)


@pytest.mark.parametrize("world,shape", [(w, s) for w, ms in cases.MESHES.items()
                                         for s, _ in ms])
@pytest.mark.parametrize("kind", cases.PRIMITIVES)
def test_primitive_equals_the_virtual_mesh(primitive_runs, world, shape, kind):
    names = dict(cases.MESHES[world])[shape]
    vm = Mesh(shape, names, device="cpu")
    runs = primitive_runs[world]
    n = 0
    for key, fn in cases.primitive_cases(vm).items():
        if key[0] != kind:
            continue
        want = fn(vm)
        for rank, got in enumerate(runs):
            w = cases.rank_view(vm, key, want, rank)
            assert torch.equal(got[(shape,) + key], w), (shape, key, rank)
        n += 1
    assert n > 0


def test_wire_bytes_are_counted(primitive_runs):
    """Every primitive that crosses ranks counts what each rank received."""
    for world, runs in primitive_runs.items():
        for shape, _ in cases.MESHES[world]:
            for rank, got in enumerate(runs):
                wire = got[(shape, "wire")]
                assert set(wire) == {"all_gather", "ppermute", "all_to_all", "gather_full",
                                     "fold_blocks", "fold_scatter", "gather_positions"}, (
                    shape, rank, wire)
                assert all(v > 0 for v in wire.values())


@pytest.mark.parametrize("sr_name", cases.SEMIRINGS)
@pytest.mark.parametrize("group", ["matvec", "batched", "spgemm", "iterate"])
def test_graph_calls_equal_the_virtual_mesh(graph_runs, sr_name, group):
    vm = Mesh((2, 4), ("dr", "dc"), device="cpu")
    n = 0
    for key, fn in cases.graph_cases(vm, sr_name).items():
        label = key[2]
        kind = label.split("/")[0]
        if {"batched": "batched", "spgemm": "spgemm", "iterate": "iterate"}.get(
                kind, "matvec") != group:
            continue
        want = fn()
        for rank, got in enumerate(graph_runs):
            assert torch.equal(got[key], want[rank:rank + 1]), (key, rank)
        n += 1
    assert n > 0


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "bool_or_and"])
def test_flat_unfused_matvec_equals_the_jax_mesh(graph_runs, jax_mesh_outputs, jax_inputs,
                                                 sr_name):
    sr = tsemiring.SEMIRINGS[sr_name]
    keys = [k for k in jax_inputs if k.startswith(f"{sr_name}/")]
    assert len(keys) == 14
    for key in keys:
        rows, cols, vals, x, fill, fmt, strategy, kernel, balance = jax_inputs[key]
        pm = tpart.partition(rows, cols, vals, (128, 128), STRATEGIES[strategy], fmt, sr,
                             block=cases.BLOCK, balance=balance, device="cpu")
        ys = torch.cat([r[("jax", key)] for r in graph_runs])
        check(sr_name, tpart.unshard_tensor(pm.plan, ys).numpy(), jax_mesh_outputs[key], key)


def test_rank_part_is_the_stacked_part():
    """``partition(..., part=g)`` is device g's slice of the whole stack,
    in every format, with the plan and shapes global."""
    rows, cols, vals, _, _, _ = cases.graph_problem("min_plus")
    sr = tsemiring.SEMIRINGS["min_plus"]
    for fmt, grid in (("bsr", (2, 4)), ("csr", (8, 1)), ("csc", (1, 8)), ("coo", (2, 4))):
        whole = tpart.partition(rows, cols, vals, (128, 128), grid, fmt, sr, block=(16, 16),
                                device="cpu")
        for g in (0, 5):
            one = tpart.partition(rows, cols, vals, (128, 128), grid, fmt, sr, block=(16, 16),
                                  device="cpu", part=g)
            assert repr(one.plan) == repr(whole.plan) and one.shape == whole.shape
            want, got = tpart.device_part(whole.parts, g), tpart.device_part(one.parts, 0)
            for f in want.__dataclass_fields__:
                a, b = getattr(want, f), getattr(got, f)
                assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, (fmt, g, f)


def test_nothing_falls_back_silently(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_rank_mesh((2, 2), ("data", "model"), "gloo", init_method="file:///nonexistent",
                       rank=0, world_size=4)
    with pytest.raises(RuntimeError, match="process group"):
        RankMesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        init_rank_mesh((2, 2), ("data", "model"), "mpi", device="cpu")
    # a group already joined keeps its transport: another backend raises
    import torch.distributed as tdist
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                             world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already joined over 'gloo', not 'nccl'"):
            init_rank_mesh((1,), ("x",), "nccl", device="cpu")
        assert init_rank_mesh((1,), ("x",), "gloo", device="cpu").backend == "gloo"
    finally:
        tdist.destroy_process_group()
