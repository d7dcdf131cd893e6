"""BFS/SSSP/PPR/PageRank through the port's ``build_engine`` against the JAX
package on the tile route (``fmt_spmv = fmt_spmspv = "bsr"``): the JAX side
runs its two Pallas kernels in interpret mode, the port their plain
versions. Same equalities and tolerances as ``test_torch_graphs.py``."""
import numpy as np
import pytest

from test_torch_graphs import APPS, POLICIES, graph_pair, run_both


@pytest.fixture(scope="module")
def face():
    return graph_pair("face", 0.15, 1)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("app", list(APPS))
def test_tile_route_matches_jax(face, app, policy):
    run_both(app, "bsr", policy, *face)


def test_tile_route_adaptive_bfs_uses_both_kernels(face):
    _, tr = run_both("bfs", "bsr", "adaptive", *face)
    used = tr.kernel_used[: tr.iterations].tolist()
    assert used == [0, 0, 1, 0]


def test_tile_route_bfs_on_regular_fixture():
    """The ca-Q fixture of tests/test_graphs.py::test_bfs_on_bsr_kernels."""
    from repro_torch.graphs.bfs import bfs_reference

    jg, tg, src = graph_pair("ca-Q", 0.12, 2)
    _, tr = run_both("bfs", "bsr", "adaptive", jg, tg, src)
    np.testing.assert_array_equal(tr.levels.numpy(), bfs_reference(tg.rows, tg.cols, tg.n, src))
    assert set(tr.kernel_used[: tr.iterations].tolist()) == {0, 1}
