"""One checkpoint for a whole ``core.rank_mesh.RankMesh`` (gloo ranks on the
CPU, one torch thread each), at ``scaled_config(deepseek-v2-lite-16b,
0.05)`` top-2, the config of the chip run's phase 21d:

* a (2, 2) state on 4 ranks saved into one directory: its manifest and
  every ``.npy`` byte-equal to the virtual (2, 2) mesh's checkpoint of the
  same state; rank 0 alone writes; one rooted gather a ``Sharded`` leaf,
  and ranks 1–3 receive nothing;
* restored onto (4, 1) and (1, 4) on the 4 ranks, onto (2, 1) on 2 ranks
  and with no mesh in this process: every rank's blocks ``torch.equal``
  to the virtual mesh's restore of that shape, no collective issued;
* ``TrainDriver`` on 4 ranks, 12 steps, a checkpoint every 4, failures at
  steps 5 and 9: equal bit for bit to the uninterrupted 4-rank run (the
  reference's ``test_restart_reproduces_uninterrupted_run`` property)
  and to the virtual mesh's driver;
* the launcher, 4 steps on (2, 2), then relaunched on (4, 1) to step 8
  from the one directory: losses and final blocks equal to the same
  sequence on virtual meshes;
* the JAX package's ``latest_step`` finds the ranks' checkpoint and its
  ``restore`` loads every f32 leaf equal to the port's and every bf16
  leaf as the same uint16 bits.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

import torch_rank_ckpt_cases as cases
from repro.train import checkpoint as jckpt
from repro_torch.distributed.sharding import Sharded, set_activation_mesh, unshard_state
from repro_torch.launch.mesh import small_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.train import checkpoint as ckpt


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("rank_ckpt"))


@pytest.fixture(scope="module")
def ranks(workdir, one_thread):
    return run_ranks(cases.run_ckpt, 4, workdir, timeout=300)


@pytest.fixture(scope="module")
def ranks2(ranks, workdir):
    return run_ranks(cases.run_restore, 2, os.path.join(workdir, "save"), timeout=120)


@pytest.fixture(scope="module")
def virtual(tmp_path_factory, one_thread):
    """The virtual (2, 2) mesh's state and checkpoint, its restores, its
    driver and its launcher sequence."""
    tmp = str(tmp_path_factory.mktemp("virtual_ckpt"))
    mesh = small_mesh(2, 2, device="cpu")
    _, params, opt = cases.trained_state(mesh)
    set_activation_mesh(None)
    tree = {"params": params, "opt": opt}
    ckpt.save(os.path.join(tmp, "save"), 1, tree)
    out = {"dir": os.path.join(tmp, "save"), "tree": tree, "blocks": cases.blocks_of(tree)}
    out["restore"] = {shape: cases.restore_onto(out["dir"], tree,
                                                small_mesh(*shape, device="cpu"))
                      for shapes in cases.RESTORE_SHAPES.values() for shape in shapes}
    out["driver"] = cases.drive(mesh, os.path.join(tmp, "driver"), list(cases.FAILURES))
    out["launcher"] = cases.relaunch(["--data", "2", "--model", "2"],
                                     ["--data", "4", "--model", "1"], os.path.join(tmp, "launch"))
    set_activation_mesh(None)
    return out


def assert_blocks(got: dict, want: dict, rank: int, label) -> None:
    assert got.keys() == want.keys(), label
    for k, w in want.items():
        exp = w if k.startswith("plain:") else w[rank:rank + 1]
        assert torch.equal(got[k], exp), (label, rank, k)


def test_one_directory_byte_equal_to_the_virtual_mesh(ranks, workdir, virtual):
    rank_dir = os.path.join(workdir, "save")
    assert sorted(os.listdir(workdir)) == ["clean", "faulty", "launch", "save"]
    assert os.listdir(rank_dir) == ["step_1"]
    a, b = os.path.join(rank_dir, "step_1"), os.path.join(virtual["dir"], "step_1")
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and "manifest.json" in names
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


def test_rank_zero_alone_writes(ranks):
    n_files = len(ranks[0]["save"]["writes"])
    assert n_files > 0
    for r in ranks[1:]:
        assert r["save"]["writes"] == [] and r["save"]["returned"] is None


def test_one_rooted_gather_a_sharded_leaf(ranks, virtual):
    n_sharded = sum(isinstance(v, Sharded) for v in ckpt._flatten(virtual["tree"]).values())
    for rank, r in enumerate(ranks):
        calls = {k: v for k, v in r["save"]["calls"].items() if v}
        assert calls == {"gather_root": n_sharded}, (rank, calls)
        wire = {k: v for k, v in r["save"]["wire"].items() if v}
        if rank:
            assert wire == {}, (rank, wire)
        else:
            assert wire["gather_root"] == 3 * sum(
                v.blocks[0].numel() * v.blocks.element_size()
                for v in ckpt._flatten(virtual["tree"]).values() if isinstance(v, Sharded))


def test_saved_state_is_the_virtual_meshs(ranks, virtual):
    for rank, r in enumerate(ranks):
        assert_blocks(r["save"]["blocks"], virtual["blocks"], rank, "saved")


@pytest.mark.parametrize("shape", cases.RESTORE_SHAPES[4])
def test_restore_onto_another_shape(ranks, virtual, shape):
    want = virtual["restore"][shape]
    for rank, r in enumerate(ranks):
        assert_blocks(r["restore"][shape], want, rank, shape)


def test_restore_onto_fewer_ranks(ranks2, virtual):
    want = virtual["restore"][(2, 1)]
    for rank, r in enumerate(ranks2):
        assert r["calls"], rank                     # the restore issued no collective
        assert_blocks(r["blocks"], want, rank, (2, 1))


def test_restore_with_no_mesh(ranks, workdir, virtual):
    like = unshard_state(virtual["tree"])
    got, _ = ckpt.restore(os.path.join(workdir, "save"), 1, _zeros(like))
    want = ckpt._flatten(like)
    for k, v in ckpt._flatten(got).items():
        assert torch.equal(v, want[k]), k


def _zeros(tree):
    from repro_torch.distributed.sharding import tree_map
    return tree_map(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else t, tree)


def test_driver_restarts_equal_the_uninterrupted_run(ranks):
    for rank, r in enumerate(ranks):
        clean, faulty = r["driver"]["clean"], r["driver"]["faulty"]
        assert clean["restarts"] == 0 and faulty["restarts"] == len(cases.FAILURES)
        by_step = dict(zip(faulty["steps"], faulty["losses"]))
        assert [by_step[i] for i in range(cases.FT_STEPS)] == clean["losses"], rank
        assert clean["blocks"].keys() == faulty["blocks"].keys()
        for k, v in clean["blocks"].items():
            assert torch.equal(faulty["blocks"][k], v), (rank, k)
    # one directory for the whole mesh, every 4 steps, and the step-0 anchor
    assert ranks[0]["driver_dirs"] == ["step_0", "step_12", "step_4", "step_8"]


def test_driver_on_ranks_equals_the_virtual_mesh(ranks, virtual):
    want = virtual["driver"]
    for rank, r in enumerate(ranks):
        got = r["driver"]["faulty"]
        assert got["losses"] == want["losses"] and got["steps"] == want["steps"], rank
        assert_blocks(got["blocks"], want["blocks"], rank, "driver")


def test_launcher_relaunched_on_another_shape(ranks, virtual):
    want = virtual["launcher"]
    assert want[1]["losses"] and len(want[0]["losses"]) == 4 and len(want[1]["losses"]) == 4
    for rank, r in enumerate(ranks):
        for part, (g, w) in enumerate(zip(r["launcher"], want)):
            assert g["losses"] == w["losses"], (rank, part)
            assert_blocks(g["blocks"], w["blocks"], rank, ("launcher", part))


def test_the_reference_reads_the_rank_checkpoint(ranks, workdir):
    d = os.path.join(workdir, "save")
    assert jckpt.latest_step(d) == ckpt.latest_step(d) == 1
    import json
    with open(os.path.join(d, "step_1", "manifest.json")) as f:
        arrays = json.load(f)["arrays"]
    like = _nested({k: np.zeros(e["shape"], np.uint16 if e["dtype"] == "bfloat16"
                                else np.dtype(e["dtype"])) for k, e in arrays.items()})
    ref, _ = jckpt.restore(d, 1, like)
    ref_flat = jckpt._flatten(ref)
    port = ckpt._flatten(ckpt.restore(d, 1, _plain_like(arrays))[0])
    assert ref_flat.keys() == port.keys() == arrays.keys()
    for key, e in arrays.items():
        got, mine = np.asarray(ref_flat[key]), port[key]
        if e["dtype"] == "bfloat16":
            assert got.dtype == np.uint16
            np.testing.assert_array_equal(got, mine.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(got, mine.numpy())


def _nested(flat: dict) -> dict:
    """Nested dicts of ``flat``'s "/"-joined keys."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _plain_like(arrays: dict) -> dict:
    """A tree of zero tensors of the manifest's keys, shapes and dtypes."""
    def zeros(e):
        dtype = (torch.bfloat16 if e["dtype"] == "bfloat16"
                 else torch.from_numpy(np.empty(0, np.dtype(e["dtype"]))).dtype)
        return torch.zeros(e["shape"], dtype=dtype)
    return _nested({k: zeros(e) for k, e in arrays.items()})
