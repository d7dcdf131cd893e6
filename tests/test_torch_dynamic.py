"""The port's dynamic-graph layer against the JAX package's: the copied
``core/delta.py`` on random deltas and on every edge case (empty,
duplicate and nonexistent edges, out-of-range ids), ``DynamicGraph``
snapshots and fingerprints, ``plan_repair``, and ``bfs/sssp/cc_incremental``
equal to the port's cold runs and to the JAX package's incremental ones;
``pagerank_warm`` held as ``tests/test_dynamic.py`` holds it (rtol 1e-4,
atol 1e-7 of a cold run, no more iterations). On the fixture of
``tests/test_dynamic.py``: a 676-vertex road lattice."""
import importlib

import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import semiring as jsemiring
from repro.graphs import datasets as jdatasets
from repro.graphs import dynamic as jdynamic
from repro.graphs import engine as jengine
from repro_torch.core import delta as tdelta
from repro_torch.core import semiring as tsemiring
from repro_torch.graphs import datasets as tdatasets
from repro_torch.graphs import dynamic as tdynamic
from repro_torch.graphs import engine as tengine

tanalytics = importlib.import_module("repro_torch.graphs.analytics")
tmulti = importlib.import_module("repro_torch.graphs.multi")
tppr = importlib.import_module("repro_torch.graphs.ppr")

MAX_IT = 256
KINDS = ["grow", "churn", "shrink"]


@pytest.fixture(scope="module")
def base():
    jg = jdatasets.road_graph(700, 2.5, seed=3)
    tg = tdatasets.road_graph(700, 2.5, seed=3)
    np.testing.assert_array_equal(jg.rows, tg.rows)
    return jg, tg


def deltas(g, kind, seed=8):
    """The JAX suite's deltas, as (jax EdgeDelta, port EdgeDelta)."""
    rng = np.random.default_rng(seed)
    ins = rng.integers(0, g.n, (8, 2))
    drop = rng.choice(g.nnz, 10 if kind == "shrink" else 6, replace=False)
    parts = {"grow": (ins[:, 0], ins[:, 1], [], []),
             "churn": (ins[:, 0], ins[:, 1], g.rows[drop], g.cols[drop]),
             "shrink": ([], [], g.rows[drop], g.cols[drop])}[kind]
    return jdelta.EdgeDelta(*parts), tdelta.EdgeDelta(*parts)


def same_delta(a, b):
    for f in ("insert_rows", "insert_cols", "delete_rows", "delete_cols"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("seed", range(4))
def test_delta_algebra_matches_jax_on_random_deltas(base, seed):
    jg, g = base
    rng = np.random.default_rng(seed)
    ins = rng.integers(0, g.n, (12, 2))
    drop = rng.choice(g.nnz, 9, replace=False)
    # duplicates, a self loop and an absent edge ride along
    ir = np.concatenate([ins[:, 0], ins[:1, 0], [5]])
    ic = np.concatenate([ins[:, 1], ins[:1, 1], [5]])
    dr = np.concatenate([g.rows[drop], [0]])
    dc = np.concatenate([g.cols[drop], [g.n - 1]])
    jd, td = jdelta.EdgeDelta(ir, ic, dr, dc), tdelta.EdgeDelta(ir, ic, dr, dc)
    same_delta(tdelta.canonicalize(td, g.n), jdelta.canonicalize(jd, g.n))
    r1, c1 = tdelta.apply_edge_delta(g.rows, g.cols, g.n, td)
    jr1, jc1 = jdelta.apply_edge_delta(jg.rows, jg.cols, g.n, jd)
    np.testing.assert_array_equal(r1, jr1)
    np.testing.assert_array_equal(c1, jc1)
    assert r1.dtype == jr1.dtype == np.int32
    eff = tdelta.edge_diff(g.rows, g.cols, r1, c1, g.n)
    same_delta(eff, jdelta.edge_diff(jg.rows, jg.cols, jr1, jc1, g.n))
    np.testing.assert_array_equal(tdelta.touched_vertices(eff), jdelta.touched_vertices(eff))
    r2, c2 = tdelta.apply_edge_delta(g.rows, g.cols, g.n, eff)
    np.testing.assert_array_equal(r2, r1)
    np.testing.assert_array_equal(c2, c1)


def test_delta_edge_cases(base):
    _, g = base
    n = 64
    empty = tdatasets.Graph(np.zeros(0, np.int32), np.zeros(0, np.int32), n, "empty")
    pairs = [(0, 1), (1, 2), (2, 2), (5, 4), (0, 1)]
    g1 = tdynamic.DynamicGraph(empty).apply(
        tdelta.EdgeDelta(insert_rows=[p[0] for p in pairs], insert_cols=[p[1] for p in pairs]))
    want_r, want_c = tdatasets._symmetrize(np.array([0, 1, 5]), np.array([1, 2, 4]), n)
    np.testing.assert_array_equal(g1.rows, want_r)
    np.testing.assert_array_equal(g1.cols, want_c)
    u, v = int(g.rows[0]), int(g.cols[0])
    dup = tdynamic.DynamicGraph(g).apply(tdelta.EdgeDelta(insert_rows=[u], insert_cols=[v]))
    np.testing.assert_array_equal(dup.rows, g.rows)
    present = set((g.rows.astype(np.int64) * g.n + g.cols).tolist())
    w = next(w for w in range(1, g.n) if w not in present)
    gone = tdynamic.DynamicGraph(g).apply(tdelta.EdgeDelta(delete_rows=[0], delete_cols=[w]))
    np.testing.assert_array_equal(gone.cols, g.cols)
    with pytest.raises(ValueError):
        tdelta.canonicalize(tdelta.EdgeDelta(insert_rows=[0], insert_cols=[g.n]), g.n)
    with pytest.raises(ValueError):
        tdelta.canonicalize(tdelta.EdgeDelta(delete_rows=[-1], delete_cols=[0]), g.n)
    with pytest.raises(ValueError):
        tdelta.EdgeDelta(insert_rows=[0, 1], insert_cols=[0])
    d = tdelta.canonicalize(tdelta.EdgeDelta(), g.n)
    assert d.n_inserts == d.n_deletes == 0


def test_dynamic_graph_fingerprints_match_jax(base):
    jg, g = base
    jd, td = deltas(g, "churn")
    jdg, tdg = jdynamic.DynamicGraph(jg), tdynamic.DynamicGraph(g)
    assert tdg.fingerprint == jdg.fingerprint
    for _ in range(2):
        jdg.apply(jd)
        tdg.apply(td)
        assert tdg.fingerprint == jdg.fingerprint and tdg.version == jdg.version
    fp = tdg.fingerprint
    tdg.apply(tdelta.EdgeDelta())
    assert tdg.fingerprint != fp and tdg.fingerprint.split(":")[1] == fp.split(":")[1]
    np.testing.assert_array_equal(tdg.snapshot.rows, jdg.snapshot.rows)


def snapshots(base, kind):
    jg, g = base
    jd, td = deltas(g, kind)
    return (jdynamic.DynamicGraph(jg).apply(jd), tdynamic.DynamicGraph(g).apply(td),
            jdelta.canonicalize(jd, g.n), tdelta.canonicalize(td, g.n))


@pytest.mark.parametrize("kind", KINDS)
def test_plan_repair_matches_jax(base, kind):
    jg1, g1, jd, td = snapshots(base, kind)
    jr = jdynamic.plan_repair(jengine.build_engine(jg1, jsemiring.MIN_PLUS, weighted=False), jd)
    tr = tdynamic.plan_repair(tengine.build_engine(g1, tsemiring.MIN_PLUS, weighted=False,
                                                   device="cpu"), td)
    np.testing.assert_array_equal(tr.touched, jr.touched)
    assert (tr.stale is None) == (jr.stale is None) == (kind == "grow")
    if tr.stale is not None:
        np.testing.assert_array_equal(tr.stale, jr.stale)
        assert tr.stale.any()
    assert tr.traffic == jr.traffic


@pytest.mark.parametrize("kind", KINDS)
def test_bfs_sssp_incremental_equal_cold_and_jax(base, kind):
    jg, g = base
    jg1, g1, jd, td = snapshots(base, kind)
    srcs = [int(s) for s in np.random.default_rng(2).integers(0, g.n, 3)]

    old_lv = tmulti.bfs_multi(tengine.build_engine(g, tsemiring.BOOL_OR_AND, device="cpu"),
                              srcs, max_iters=MAX_IT).levels
    e1_unit = tengine.build_engine(g1, tsemiring.MIN_PLUS, weighted=False, device="cpu")
    repair = tdynamic.plan_repair(e1_unit, td)
    inc = tdynamic.bfs_incremental(e1_unit, srcs, old_lv, td, repair=repair, max_iters=MAX_IT)
    cold = tmulti.bfs_multi(tengine.build_engine(g1, tsemiring.BOOL_OR_AND, device="cpu"), srcs,
                            max_iters=MAX_IT)
    np.testing.assert_array_equal(inc.values, cold.levels.numpy())
    assert inc.values.dtype == np.int32
    j_inc = jdynamic.bfs_incremental(
        jengine.build_engine(jg1, jsemiring.MIN_PLUS, weighted=False), srcs,
        old_lv.numpy(), jd, max_iters=MAX_IT)
    np.testing.assert_array_equal(inc.values, j_inc.values)
    np.testing.assert_array_equal(inc.result.iterations.numpy(),
                                  np.asarray(j_inc.result.iterations))
    assert inc.traffic == j_inc.traffic

    kw = dict(weighted=True, seed=5, content_keyed=True)
    e0_w = tengine.build_engine(g, tsemiring.MIN_PLUS, device="cpu", **kw)
    e1_w = tengine.build_engine(g1, tsemiring.MIN_PLUS, device="cpu", **kw)
    old_d = tmulti.sssp_multi(e0_w, srcs, max_iters=MAX_IT).dist
    inc_w = tdynamic.sssp_incremental(e1_w, srcs, old_d, td, repair=repair, max_iters=MAX_IT)
    cold_w = tmulti.sssp_multi(e1_w, srcs, max_iters=MAX_IT)
    np.testing.assert_array_equal(inc_w.values, cold_w.dist.numpy())
    assert inc_w.traffic > 0 and tdynamic.traffic_of(cold_w) > 0
    j_w = jdynamic.sssp_incremental(jengine.build_engine(jg1, jsemiring.MIN_PLUS, **kw), srcs,
                                    old_d.numpy(), jd, max_iters=MAX_IT)
    np.testing.assert_array_equal(inc_w.values, j_w.values)
    assert inc_w.traffic == j_w.traffic


@pytest.mark.parametrize("kind", KINDS)
def test_cc_incremental_equals_cold_and_jax(base, kind):
    jg, g = base
    jg1, g1, jd, td = snapshots(base, kind)
    old = tanalytics.connected_components(
        tengine.build_engine(g, tsemiring.MIN_TIMES, device="cpu")).labels
    e1 = tengine.build_engine(g1, tsemiring.MIN_TIMES, device="cpu")
    inc = tdynamic.cc_incremental(e1, old, td)
    cold = tanalytics.connected_components(e1)
    assert torch.equal(inc.labels, cold.labels)
    assert int(inc.n_components) == int(cold.n_components)
    np.testing.assert_array_equal(cold.labels.numpy(),
                                  tanalytics.cc_reference(g1.rows, g1.cols, g1.n))
    j_inc = jdynamic.cc_incremental(jengine.build_engine(jg1, jsemiring.MIN_TIMES),
                                    old.numpy(), jd)
    np.testing.assert_array_equal(inc.labels.numpy(), np.asarray(j_inc.labels))
    assert inc.iterations == int(j_inc.iterations)


def test_empty_delta_incremental_is_free(base):
    _, g = base
    d = tdelta.canonicalize(tdelta.EdgeDelta(), g.n)
    srcs = [1, 5]
    e_unit = tengine.build_engine(g, tsemiring.MIN_PLUS, weighted=False, device="cpu")
    old_lv = tmulti.bfs_multi(tengine.build_engine(g, tsemiring.BOOL_OR_AND, device="cpu"), srcs,
                              max_iters=MAX_IT).levels
    inc = tdynamic.bfs_incremental(e_unit, srcs, old_lv, d, max_iters=MAX_IT)
    np.testing.assert_array_equal(inc.values, old_lv.numpy())
    assert inc.traffic == 0.0 and inc.repair.traffic == 0.0


def test_pagerank_warm_same_fixpoint(base):
    _, g = base
    _, g1, _, _ = snapshots(base, "grow")
    e0 = tengine.build_engine(g, tsemiring.PLUS_TIMES, normalize=True, device="cpu")
    e1 = tengine.build_engine(g1, tsemiring.PLUS_TIMES, normalize=True, device="cpu")
    old = tppr.pagerank(e0, max_iters=200).rank
    cold = tppr.pagerank(e1, max_iters=200)
    warm = tdynamic.pagerank_warm(e1, old, max_iters=200)
    assert float(warm.residual) <= 1e-6 and float(cold.residual) <= 1e-6
    np.testing.assert_allclose(warm.rank.numpy(), cold.rank.numpy(), rtol=1e-4, atol=1e-7)
    assert warm.iterations <= cold.iterations


def test_incremental_checks(base):
    _, g = base
    e = tengine.build_engine(g, tsemiring.BOOL_OR_AND, device="cpu")
    with pytest.raises(ValueError, match="min_plus"):
        tdynamic.plan_repair(e, tdelta.EdgeDelta())
    with pytest.raises(ValueError, match="min_times"):
        tdynamic.cc_incremental(e, np.zeros(g.n, np.int32), tdelta.EdgeDelta())
    e_unit = tengine.build_engine(g, tsemiring.MIN_PLUS, device="cpu")
    with pytest.raises(ValueError, match="old values"):
        tdynamic.sssp_incremental(e_unit, [0, 1], np.zeros((1, g.n), np.float32),
                                  tdelta.EdgeDelta())
