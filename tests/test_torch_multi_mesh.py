"""The port's row-sharded multi-source traversals (``graphs/multi.py``'s
``mesh``/``axis_name``) and ``GraphQueryServer(mesh=...)`` on the CPU.

* Every row of ``bfs_multi``, ``sssp_multi``, ``relax_multi``,
  ``ppr_multi`` and ``traverse_multi_buckets`` (depth 0 and 2) on a
  ``("batch",)`` mesh of D = 1, 2, 4 or 8 virtual devices, and on a
  (2, 4) mesh with a tuple ``axis_name``, is ``torch.equal`` to the
  ``mesh=None`` run: the result, iteration counts, densities and kernel
  traces, on the element route (csr/csc) and the tile route (bsr), at
  B = 8, 32 and 6 (which 4 and 8 do not divide). PPR too: on the CPU every
  row folds in one order whatever the rows beside it.
* Each level calls the engine's block closures once per device, on that
  device's rows (⌈B / S⌉ a position, the last ones fewer).
* The same rows against the JAX package's row-sharded run on an
  ``AxisType.Auto`` mesh of 8 forced host devices, in one subprocess:
  levels and distances exactly, with iteration counts and traces; PPR
  ranks within rtol 1e-3, atol 1e-6.
* ``GraphQueryServer(mesh=...)`` and ``AsyncGraphServer`` tenants with a
  mesh answer as the mesh-less servers do.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import semiring as tsemiring
from repro_torch.core.mesh import Mesh
from repro_torch.graphs import cost_model as tcost
from repro_torch.graphs import datasets as tdatasets
from repro_torch.graphs import engine as tengine
from repro_torch.serve.graph_engine import AsyncGraphServer, GraphQueryServer, LRUCache
from repro_torch.serve.scheduler import FakeClock

tmulti = importlib.import_module("repro_torch.graphs.multi")

GRAPH = ("face", 0.15, 1)
APPS = {
    "bfs": ("bool_or_and", {}),
    "sssp": ("min_plus", {"weighted": True, "seed": 5}),
    "ppr": ("plus_times", {"normalize": True}),
}
ROUTES = ("csr", "bsr")
DEVICES = (1, 2, 4, 8)
BATCHES = (8, 32, 6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tests, restored after: the
    bsr route's plain versions make many small ops, and with the suite's
    other workers on the same cores torch's pool would spend its time
    waiting (as in ``tests/test_torch_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    abbrev, scale, seed = GRAPH
    return tdatasets.generate(abbrev, scale=scale, seed=seed)


@pytest.fixture(scope="module")
def engines(graph):
    out = {}
    for app, (name, kw) in APPS.items():
        for fmt in ROUTES:
            msv = "csc" if fmt == "csr" else fmt
            out[app, fmt] = tengine.build_engine(
                graph, tsemiring.SEMIRINGS[name], tcost.trained_stump(), fmt_spmv=fmt,
                fmt_spmspv=msv, device="cpu", **kw)
    return out


@pytest.fixture(scope="module")
def unsharded():
    """The mesh=None runs, by (app, route, B), made once."""
    return {}


def sources_of(n, b, seed=42):
    return [int(s) for s in np.random.default_rng(seed).integers(0, n, b)]


def run(app, eng, sources, **kw):
    return getattr(tmulti, f"{app}_multi")(eng, sources, **kw)


def assert_rows_equal(got, want):
    assert type(got) is type(want)
    for field, g, w in zip(want._fields, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, field
        assert torch.equal(g, w), field


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("fmt", ROUTES)
@pytest.mark.parametrize("app", list(APPS))
def test_rows_equal_unsharded(engines, graph, unsharded, app, fmt, d, b):
    eng = engines[app, fmt]
    src = sources_of(graph.n, b)
    if (app, fmt, b) not in unsharded:
        unsharded[app, fmt, b] = run(app, eng, src)
    mesh = Mesh((d,), ("batch",), device="cpu")
    assert_rows_equal(run(app, eng, src, mesh=mesh), unsharded[app, fmt, b])


@pytest.mark.parametrize("axis", [("a", "b"), ("b", "a"), "b"])
@pytest.mark.parametrize("app", list(APPS))
def test_two_axis_mesh(engines, graph, app, axis):
    """A (2, 4) mesh: the tuple axes split the rows 8 ways (in the order
    given); one axis of the two splits them 4 ways, the other axis's
    devices holding copies."""
    eng = engines[app, "bsr"]
    src = sources_of(graph.n, 8)
    mesh = Mesh((2, 4), ("a", "b"), device="cpu")
    assert_rows_equal(run(app, eng, src, mesh=mesh, axis_name=axis), run(app, eng, src))


@pytest.mark.parametrize("fmt", ROUTES)
def test_relax_multi(engines, graph, fmt):
    """The warm start on a mesh: the cold seed and a seed with stale rows."""
    eng = engines["sssp", fmt]
    src = sources_of(graph.n, 6)
    cold = tmulti.sssp_multi(eng, src)
    dist0 = cold.dist.clone()
    dist0[:, ::3] = float("inf")
    changed0 = torch.where(torch.isinf(dist0), float("inf"), dist0)
    for d in DEVICES:
        mesh = Mesh((d,), ("batch",), device="cpu")
        assert_rows_equal(tmulti.relax_multi(eng, dist0, changed0, mesh=mesh),
                          tmulti.relax_multi(eng, dist0, changed0))
        assert_rows_equal(tmulti.sssp_multi(eng, src, mesh=mesh), cold)


@pytest.mark.parametrize("app", list(APPS))
def test_bucket_drain_on_a_mesh(engines, graph, app):
    eng = engines[app, "bsr"]
    src = sources_of(graph.n, 11)
    buckets = [src[:4], src[4:7], src[7:]]
    mesh = Mesh((4,), ("batch",), device="cpu")
    want = tmulti.traverse_multi_buckets(eng, app, buckets, pipeline_depth=0, pad_to=4)
    for depth in (0, 2):
        got = tmulti.traverse_multi_buckets(eng, app, buckets, pipeline_depth=depth,
                                            mesh=mesh, pad_to=4)
        for g, w in zip(got, want):
            assert_rows_equal(g, w)


@pytest.mark.parametrize("b,d,shares", [(8, 4, [2, 2, 2, 2]), (6, 4, [2, 2, 2]),
                                        (6, 8, [1] * 6), (5, 2, [3, 2])])
def test_block_calls_per_device(graph, b, d, shares):
    """Each level calls the block closure once per device that holds rows,
    on its rows alone; the runner is keyed on the mesh's layout and axis."""
    eng = tengine.build_engine(graph, tsemiring.BOOL_OR_AND, device="cpu")
    seen = []
    inner = eng.spmv_batch_fn
    eng.spmv_batch_fn = lambda xs: seen.append(xs.shape[0]) or inner(xs)
    mesh = Mesh((d,), ("batch",), device="cpu")
    res = tmulti.bfs_multi(eng, sources_of(graph.n, b), policy="spmv", mesh=mesh)
    levels = int(res.iterations.max())
    assert seen == shares * levels
    again = Mesh((d,), ("batch",), device="cpu")
    tmulti.bfs_multi(eng, sources_of(graph.n, b), policy="spmv", mesh=again)
    assert len(eng.__dict__["_multi_runners"]) == 1        # same layout: one runner
    tmulti.bfs_multi(eng, sources_of(graph.n, b), policy="spmv")
    assert len(eng.__dict__["_multi_runners"]) == 2


def test_mesh_device_must_match(engines, graph):
    mesh = Mesh((2,), ("batch",), device="meta")
    with pytest.raises(ValueError, match="mesh is on"):
        tmulti.bfs_multi(engines["bfs", "csr"], [0, 1], mesh=mesh)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tmulti.bfs_multi(engines["bfs", "csr"], [0, 1],
                         mesh=Mesh((2,), ("batch",), device="cpu"), axis_name="data")


# ---------------------------------------------------------------- the JAX side

# (app, batch, mesh shape, axis names, axis_name): B = 6 on 8 devices is
# the reference's uneven split (XLA pads it); (2, 4) takes a tuple axis
REF_CASES = [("bfs", 8, (4,), ("batch",), "batch"),
             ("sssp", 8, (4,), ("batch",), "batch"),
             ("ppr", 8, (4,), ("batch",), "batch"),
             ("bfs", 6, (8,), ("batch",), "batch"),
             ("ppr", 6, (8,), ("batch",), "batch"),
             ("sssp", 8, (2, 4), ("a", "b"), ("a", "b"))]

_REF_WORKER = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import numpy as np
    from repro.core import semiring
    from repro.graphs import cost_model, datasets, engine, multi

    cases, graph, apps, out = json.loads(sys.argv[1])
    g = datasets.generate(graph[0], scale=graph[1], seed=graph[2])
    engines, res = {}, {}
    for k, (app, b, shape, names, axis) in enumerate(cases):
        if app not in engines:
            name, kw = apps[app]
            engines[app] = engine.build_engine(g, semiring.SEMIRINGS[name],
                                               cost_model.trained_stump(), **kw)
        mesh = jax.make_mesh(tuple(shape), tuple(names),
                             axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
        axis = axis if isinstance(axis, str) else tuple(axis)
        src = [int(s) for s in np.random.default_rng(42).integers(0, g.n, b)]
        r = getattr(multi, app + "_multi")(engines[app], src, mesh=mesh, axis_name=axis)
        for f, v in zip(r._fields, r):
            res[f"{k}/{f}"] = np.asarray(v)
    np.savez(out, **res)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref_mesh") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    arg = json.dumps([REF_CASES, GRAPH, APPS, out])
    proc = subprocess.run([sys.executable, "-c", _REF_WORKER, arg], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("k", range(len(REF_CASES)))
def test_rows_match_jax_row_sharded(engines, graph, reference, k):
    app, b, shape, names, axis = REF_CASES[k]
    eng = engines[app, "csr"]
    mesh = Mesh(shape, names, device="cpu")
    got = run(app, eng, sources_of(graph.n, b), mesh=mesh, axis_name=axis)
    for field, g in zip(got._fields, got):
        want = torch.from_numpy(reference[f"{k}/{field}"])
        assert g.shape == want.shape, field
        if app == "ppr" and field in ("rank", "residual"):
            torch.testing.assert_close(g, want, rtol=1e-3, atol=1e-6)
        else:
            assert torch.equal(g.to(want.dtype), want), field


# ---------------------------------------------------------------- the servers

QUERIES = [("bfs", 0), ("bfs", 3), ("bfs", 5), ("bfs", 3), ("bfs", 7), ("bfs", 11),
           ("sssp", 1), ("sssp", 2), ("sssp", 9), ("ppr", 4), ("ppr", 9), ("ppr", 13),
           ("ppr", 17), ("ppr", 21), ("cc", None)]


def assert_payload_equal(got, want, label):
    assert got is not None and want is not None and set(got) == set(want), label
    for key, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(w),
                                      err_msg=f"{label}[{key}]")
        assert type(got[key]) is type(w), (label, key)


@pytest.mark.parametrize("mesh_shape,axis", [((4,), "batch"), ((8,), "batch"),
                                             ((2, 2), ("batch", "x"))])
def test_server_on_a_mesh(graph, mesh_shape, axis):
    names = ("batch",) if len(mesh_shape) == 1 else ("batch", "x")
    mesh = Mesh(mesh_shape, names, device="cpu")
    plain = GraphQueryServer(graph, batch_size=4, device="cpu")
    sharded = GraphQueryServer(graph, batch_size=4, mesh=mesh, axis_name=axis, device="cpu")
    assert sharded.mesh is mesh and sharded.engine_key == plain.engine_key
    for srv in (plain, sharded):
        for a, s in QUERIES:
            srv.submit(a, s)
    for p, q in zip(plain.flush(), sharded.flush()):
        assert (p.algorithm, p.source) == (q.algorithm, q.source)
        assert_payload_equal(q.result, p.result, f"{p.algorithm}/{p.source}")
    assert sharded.counters == plain.counters


def test_async_tenant_on_a_mesh(graph):
    clock = FakeClock()
    srv = AsyncGraphServer(clock=clock, max_wait=10.0)
    srv.add_tenant("plain", graph, batch_size=4, device="cpu")
    # a cache of its own: on the shared one every answer would be a hit
    srv.add_tenant("mesh", graph, batch_size=4, device="cpu", cache=LRUCache(64),
                   mesh=Mesh((4,), ("batch",), device="cpu"), axis_name="batch")
    assert srv.tenant("mesh").mesh is not None
    pairs = [(srv.submit("plain", a, s), srv.submit("mesh", a, s)) for a, s in QUERIES]
    clock.advance(11.0)
    srv.poll()
    for p, q in pairs:
        assert p.done() and q.done() and not q.cached
        assert_payload_equal(q.result, p.result, "async")


def test_server_mesh_device_must_match(graph):
    with pytest.raises(ValueError, match="mesh is on"):
        GraphQueryServer(graph, mesh=Mesh((2,), ("batch",), device="meta"), device="cpu")
