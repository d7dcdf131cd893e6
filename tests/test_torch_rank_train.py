"""The mesh train steps on ``core.rank_mesh.RankMesh`` (gloo ranks on the
CPU, one torch thread each), at the reduced DeepSeek config (top-2 of 8
experts, the sparse dispatch through kernel 7's plain version and its
transpose), from the reference's initial weights:

* ``make_train_step`` on a (data 2, model 2) mesh of 4 ranks, 3 steps:
  each rank's loss, grad norm and every block of the parameters and of
  master, mu and nu ``torch.equal`` to block ``rank`` of the virtual
  ``small_mesh(2, 2)``'s run, step for step;
* its losses within rtol 1e-5 and grad norms within 1e-4
  (``test_torch_mesh_train.py``'s tolerances) of the JAX package's mesh
  step on an ``AxisType.Auto`` mesh (the reference worker of that file);
* ``make_compressed_train_step`` on (pod 2, data 2, model 2), 8 ranks, 2
  steps, ``torch.equal`` to the virtual mesh, each pod's error-feedback
  blocks included;
* each rank runs the forward of its own (pod, data) position's rows
  alone, the virtual mesh every position's;
* the launcher with ``--backend gloo`` on the 4 ranks: every rank's
  losses equal the virtual-mesh launcher's, and the ranks checkpoint into
  the one directory they share.
"""
import pytest
import torch

import torch_rank_cases as cases
from repro_torch.launch.ranks import run_ranks
from repro_torch.distributed.sharding import set_activation_mesh
from repro_torch.launch.mesh import small_mesh
from test_torch_mesh_train import run_reference

PLAIN_STEPS = 3
COMPRESSED_STEPS = 2


@pytest.fixture(scope="module")
def ref_path(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rank_train_ref")
    run_reference(tmp, "deepseek-v2-lite-16b", 2, 0, "plain")
    return str(tmp / "ref.npz")


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _virtual(ref_path: str, kind: str, steps: int) -> list:
    import numpy as np
    mesh = small_mesh(2, 2, 2 if kind == "compressed" else 0, device="cpu")
    try:
        return cases.train_steps(mesh, kind, dict(np.load(ref_path)), steps)
    finally:
        set_activation_mesh(None)


@pytest.fixture(scope="module")
def plain(ref_path, one_thread, tmp_path_factory):
    ranks = run_ranks(cases.run_train, 4, ref_path, "plain", PLAIN_STEPS,
                      str(tmp_path_factory.mktemp("rank_ckpt")), timeout=300)
    want = _virtual(ref_path, "plain", PLAIN_STEPS)
    launcher = cases.launcher_losses([], str(tmp_path_factory.mktemp("virtual_ckpt")))
    set_activation_mesh(None)
    return ranks, want, launcher


@pytest.fixture(scope="module")
def compressed(ref_path, one_thread):
    ranks = run_ranks(cases.run_train, 8, ref_path, "compressed", COMPRESSED_STEPS, "",
                      timeout=300)
    return ranks, _virtual(ref_path, "compressed", COMPRESSED_STEPS)


def _hold(ranks: list, want: list, step: int) -> None:
    w = want[step]
    for rank, r in enumerate(ranks):
        got = r["steps"][step]
        assert set(got) == set(w)
        for k, v in w.items():
            if k == "rows":
                continue
            exp = v if k in ("loss", "grad_norm") else v[rank:rank + 1]
            assert torch.equal(got[k], exp), (rank, step, k)


@pytest.mark.parametrize("step", range(PLAIN_STEPS))
def test_rank_plain_step_equals_the_virtual_mesh(plain, step):
    ranks, want, _ = plain
    _hold(ranks, want, step)


def test_rank_plain_steps_match_the_reference(plain, ref_path):
    import numpy as np
    ref = dict(np.load(ref_path))
    ranks, _, _ = plain
    for i in range(PLAIN_STEPS):
        got = ranks[0]["steps"][i]
        np.testing.assert_allclose(float(got["loss"]), ref[f"plain/s{i}/loss"], rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), ref[f"plain/s{i}/grad_norm"],
                                   rtol=1e-4)


@pytest.mark.parametrize("step", range(COMPRESSED_STEPS))
def test_rank_compressed_step_equals_the_virtual_mesh(compressed, step):
    ranks, want = compressed
    assert any(k.startswith("ef") for k in want[step])
    _hold(ranks, want, step)


@pytest.mark.parametrize("kind", ["plain", "compressed"])
def test_each_rank_runs_its_own_rows(plain, compressed, kind):
    """8 rows a step in 2 microbatches: the virtual mesh runs the forward
    of every (pod, data) position's rows, a rank of its own alone (2 rows
    a microbatch on (data 2, model 2); 1 row of its pod's 4 on (pod 2,
    data 2, model 2))."""
    ranks, want = (plain[0], plain[1]) if kind == "plain" else compressed
    own = [2, 2] if kind == "plain" else [1, 1]
    for step, w in enumerate(want):
        assert w["rows"] == own * (2 if kind == "plain" else 4), w["rows"]
        for r in ranks:
            assert r["steps"][step]["rows"] == own, (step, r["steps"][step]["rows"])


def test_launcher_on_ranks_equals_the_virtual_mesh(plain):
    ranks, _, launcher = plain
    for r in ranks:
        assert r["launcher"] == launcher, (r["launcher"], launcher)
        assert r["launcher_ckpt"] == ["step_0", "step_4"]
    assert launcher[-1] < launcher[0]
