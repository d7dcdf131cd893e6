"""The port's multi-source traversals on the tile route (``fmt_spmv =
fmt_spmspv = "bsr"``) against the JAX package's, whose batched closures are
``jax.vmap`` of its Pallas kernels 1 and 2 (interpret mode on the CPU); the
port runs kernels 1 and 2 over the [B, n] block through ``kernels/ops.py``,
on the CPU their plain versions. B = 8 on the scale-free stand-in of
``tests/test_multi_query.py``; the regular one is held to the port's
single-source runs. Same equalities and tolerances as
``test_torch_multi.py``."""
import numpy as np
import pytest
import torch

from test_torch_multi import (
    APPS, POLICIES, check_rows, engines, graph_pair, run_both, tmulti,
)


@pytest.fixture(scope="module")
def face():
    return graph_pair("face", 0.15)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("app", list(APPS))
def test_tile_route_matches_jax_and_single(face, app, policy):
    run_both(app, "bsr", policy, *face)


def test_tile_route_goes_through_the_block_front_door(face, monkeypatch):
    """Every level of an adaptive batched BFS on the tile route calls kernel
    1 or kernel 2 over the whole block, never a single-vector tile call."""
    from repro_torch.kernels import ops

    calls = []
    for name in ("semiring_spmv_batch", "semiring_spmspv_batch", "semiring_spmv",
                 "semiring_spmspv"):
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, args[1].shape[0] if args[1].dim() == 2 else 1))
            return _real(*args, **kw)

        monkeypatch.setattr(ops, name, spy)
    _, tg, sources = face
    _, teng = engines("bfs", "bsr", *face[:2])
    res = tmulti.bfs_multi(teng, sources)
    monkeypatch.undo()
    assert {c[0] for c in calls} == {"semiring_spmv_batch", "semiring_spmspv_batch"}
    assert all(b == len(sources) for _, b in calls)
    # one call a level, two on a level whose rows chose both kernels
    assert int(res.iterations.max()) <= len(calls) <= 2 * int(res.iterations.max())
    assert (res.kernel_used == 1).any() and (res.kernel_used == 0).any()


@pytest.mark.parametrize("app", list(APPS))
def test_tile_route_regular_graph_rows_equal_single(app):
    """On the regular stand-in (20% threshold) every row of the tile route's
    batched run equals the port's single-source run on the same engine."""
    jg, tg, sources = graph_pair("p2p-24", 0.12)
    from repro_torch.core import semiring as tsemiring
    from repro_torch.graphs import cost_model as tcost
    from repro_torch.graphs import engine as tengine

    name, kw, _, _ = APPS[app]
    eng = tengine.build_engine(tg, tsemiring.SEMIRINGS[name], tcost.trained_stump(),
                               fmt_spmv="bsr", fmt_spmspv="bsr", device="cpu", **kw)
    assert eng.graph_class == "regular"
    res = getattr(tmulti, f"{app}_multi")(eng, sources[:4])
    check_rows(app, "adaptive", res, eng, sources[:4])


def test_tile_route_bfs_matches_oracle(face):
    from repro_torch.graphs.bfs import bfs_reference

    _, tg, sources = face
    _, teng = engines("bfs", "bsr", *face[:2])
    res = tmulti.bfs_multi(teng, sources)
    for i, s in enumerate(sources):
        np.testing.assert_array_equal(res.levels[i].numpy(),
                                      bfs_reference(tg.rows, tg.cols, tg.n, s))
    assert res.levels.dtype == torch.int32
