"""The port's whole-graph analytics (``repro_torch.graphs.analytics``:
connected components, triangle count, k-core) against the JAX package and
the numpy references, on ``tests/test_analytics.py``'s three generator
families (r-TX 0.001, p2p-24 0.04, face 0.1, seed 2) and its path graph.
The JAX side runs once per family. The port runs on the CPU; its tile
route takes the kernels' plain versions there.

Labels, coreness, triangle totals, per-edge counts and iteration counts
must be equal: every value is an integer or an integer-valued float. The
port's "bsr" triangle count (on the CPU, the tile kernel's plain version)
is held to the JAX "bsr_ref" result, the Pallas kernel's oracle: the
Pallas kernel itself takes 10 s in interpret mode on p2p-24, and is held
to the port's plain version in ``test_torch_spgemm.py``."""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core import semiring as jsemiring
from repro.graphs import analytics as janalytics
from repro.graphs import cost_model as jcost
from repro.graphs import datasets as jdatasets
from repro.graphs import engine as jengine
from repro_torch.core import semiring as tsemiring
from repro_torch.graphs import analytics as tanalytics
from repro_torch.graphs import cost_model as tcost
from repro_torch.graphs import datasets as tdatasets
from repro_torch.graphs import engine as tengine

# the package's __init__ re-exports a function named like this module
tppr = importlib.import_module("repro_torch.graphs.ppr")

FAMILY_CASES = [("r-TX", 0.001), ("p2p-24", 0.04), ("face", 0.1)]
TRIANGLE_IMPLS = ["csr", "bsr", "bsr_ref", "dense"]
JAX_TRIANGLE_IMPL = {"csr": "csr", "bsr": "bsr_ref", "bsr_ref": "bsr_ref", "dense": "dense"}
# (fmt_spmv, fmt_spmspv) of the port's engine: the element route and the tile route
ROUTES = {"csr": ("csr", "csc"), "bsr": ("bsr", "bsr")}


def seed_labels(g, seed=4):
    """A labels0 seed: component minima of the graph with ~30% of its edge
    entries dropped, which are pointwise ≥ the true minima."""
    keep = np.random.default_rng(seed).random(g.nnz) < 0.7
    return janalytics.cc_reference(g.rows[keep], g.cols[keep], g.n)


def jax_engine(g, name, **kw):
    return jengine.build_engine(g, jsemiring.SEMIRINGS[name], jcost.trained_stump(), **kw)


def port_engine(g, name, route):
    fmt_spmv, fmt_spmspv = ROUTES[route]
    return tengine.build_engine(g, tsemiring.SEMIRINGS[name], tcost.trained_stump(),
                                fmt_spmv=fmt_spmv, fmt_spmspv=fmt_spmspv, device="cpu")


@pytest.fixture(scope="module", params=FAMILY_CASES, ids=[c[0] for c in FAMILY_CASES])
def family(request):
    """Both packages' graph and every JAX result for one family."""
    name, scale = request.param
    jg = jdatasets.generate(name, scale=scale, seed=2)
    tg = tdatasets.generate(name, scale=scale, seed=2)
    labels0 = seed_labels(jg)
    ceng = jax_engine(jg, "min_times")
    keng = jax_engine(jg, "plus_times")
    return {
        "jg": jg, "tg": tg, "labels0": labels0,
        "cc": jax.jit(lambda: janalytics.connected_components(ceng))(),
        "cc0": janalytics.connected_components(ceng, labels0=labels0),
        "kcore": jax.jit(lambda: janalytics.kcore(keng))(),
        "triangles": {impl: janalytics.triangle_count(jg, impl=impl)
                      for impl in set(JAX_TRIANGLE_IMPL.values())},
        "cc_ref": janalytics.cc_reference(jg.rows, jg.cols, jg.n),
        "kcore_ref": janalytics.kcore_reference(jg.rows, jg.cols, jg.n),
        "tri_ref": janalytics.triangle_reference(jg.rows, jg.cols, jg.n),
    }


def assert_cc(got, want, ref):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.labels.numpy(), ref)
    assert got.labels.dtype == torch.int32 and got.n_components.dtype == torch.int32
    assert int(got.n_components) == int(want.n_components) == len(np.unique(ref))
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("route", list(ROUTES))
def test_connected_components(family, route):
    eng = port_engine(family["tg"], "min_times", route)
    assert_cc(tanalytics.connected_components(eng), family["cc"], family["cc_ref"])


@pytest.mark.parametrize("route", list(ROUTES))
def test_connected_components_from_labels0(family, route):
    eng = port_engine(family["tg"], "min_times", route)
    got = tanalytics.connected_components(eng, labels0=family["labels0"])
    assert_cc(got, family["cc0"], family["cc_ref"])


@pytest.mark.parametrize("impl", TRIANGLE_IMPLS)
def test_triangle_count(family, impl):
    got = tanalytics.triangle_count(family["tg"], impl=impl, device="cpu")
    want = family["triangles"][JAX_TRIANGLE_IMPL[impl]]
    assert got.total.dtype == torch.int32 and got.per_edge.dtype == torch.int32
    assert int(got.total) == int(want.total) == family["tri_ref"]
    np.testing.assert_array_equal(got.per_edge.numpy(), np.asarray(want.per_edge))


@pytest.mark.parametrize("route", list(ROUTES))
def test_kcore(family, route):
    got = tanalytics.kcore(port_engine(family["tg"], "plus_times", route))
    want = family["kcore"]
    np.testing.assert_array_equal(got.coreness.numpy(), np.asarray(want.coreness))
    np.testing.assert_array_equal(got.coreness.numpy(), family["kcore_ref"])
    assert got.coreness.dtype == torch.int32
    assert int(got.max_core) == int(want.max_core) == family["kcore_ref"].max()
    assert got.iterations == int(want.iterations)


def test_triangle_problem_matches_jax(family):
    """L, Lᵀ and the mask built on the device by a scatter equal the JAX
    package's host-built arrays, for each container."""
    jg, tg = family["jg"], family["tg"]
    for impl in TRIANGLE_IMPLS:
        ja, jb, jm, jkw = janalytics.triangle_problem(jg, impl)
        ta, tb, tm, tkw = tanalytics.triangle_problem(tg, impl, device="cpu")
        assert tkw == jkw
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        if impl.startswith("bsr"):
            np.testing.assert_array_equal(ta.tiles.numpy(), np.asarray(ja.tiles))
            np.testing.assert_array_equal(ta.tile_cols.numpy(), np.asarray(ja.tile_cols))
    with pytest.raises(ValueError):
        tanalytics.triangle_problem(tg, "coo", device="cpu")


@pytest.mark.parametrize("route", list(ROUTES))
def test_cc_on_a_path_graph(route):
    """A path graph's label flood takes O(n) rounds, the worst case the
    max_iters default must cover."""
    n = 24
    rows = np.arange(n - 1, dtype=np.int32)
    jr, jc = jdatasets._symmetrize(rows, rows + 1, n)
    tr, tc = tdatasets._symmetrize(rows, rows + 1, n)
    want = janalytics.connected_components(jax_engine(jdatasets.Graph(jr, jc, n, "path"),
                                                      "min_times"))
    got = tanalytics.connected_components(
        port_engine(tdatasets.Graph(tr, tc, n, "path"), "min_times", route))
    assert_cc(got, want, np.zeros(n, np.int32))
    assert got.iterations == n


def test_analytics_reject_the_wrong_semiring_and_seed():
    g = tdatasets.generate("face", scale=0.02, seed=0)
    with pytest.raises(ValueError, match="min_times"):
        tanalytics.connected_components(port_engine(g, "plus_times", "csr"))
    with pytest.raises(ValueError, match="plus_times"):
        tanalytics.kcore(port_engine(g, "min_times", "csr"))
    eng = port_engine(g, "min_times", "csr")
    with pytest.raises(ValueError, match="labels0"):
        tanalytics.connected_components(eng, labels0=np.zeros(g.n + 1, np.int32))
    big = tengine.GraphEngine(eng.spmv_fn, eng.spmspv_fn, n=2**24 + 1, n_true=2**24 + 1,
                              threshold=eng.threshold, graph_class=eng.graph_class, sr=eng.sr,
                              device=eng.device)
    with pytest.raises(ValueError, match="2\\^24"):
        tanalytics.connected_components(big)


def test_pagerank_is_re_exported_and_its_sparse_reference_equals_the_dense_one():
    assert tanalytics.pagerank is tppr.pagerank
    assert tanalytics.pagerank_reference is tppr.pagerank_reference
    g = tdatasets.generate("face", scale=0.1, seed=2)
    np.testing.assert_allclose(tppr.pagerank_reference(g.rows, g.cols, g.n, sparse=True),
                               tppr.pagerank_reference(g.rows, g.cols, g.n),
                               rtol=1e-12, atol=1e-15)
