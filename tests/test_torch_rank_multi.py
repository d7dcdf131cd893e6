"""The row-sharded multi-source traversals and ``GraphQueryServer`` on a
``core.rank_mesh.RankMesh`` of gloo ranks on the CPU, one rank per
position, each running only its own rows.

The ranks start once per world size (module-scoped, ``run_ranks`` from a
fork server) and run ``torch_rank_multi_cases.run_multi``: 4 ranks on
``("batch",)``, 8 on ``(8,)`` and on a (2, 4) mesh with the tuple axis
``("a", "b")`` and with ``"b"`` alone. On face 0.15, csr/csc and bsr:

* every field of ``bfs/sssp/ppr_multi`` at B = 8, 32 and 6 (and
  ``relax_multi``, ``traverse_multi_buckets`` at depth 0 and 2) on every
  rank is ``torch.equal`` to the ``mesh=None`` run (PPR too: on the CPU a
  row folds in one order whatever rows are beside it);
* a rank's own rows, as it hands them to the gather, are those rows of the
  virtual ``Mesh``'s run; every step call a rank makes is on its own rows
  (a spy on the engine's batched closures), and a rank with none makes
  none;
* each run issues one ``all_true`` a stopping test and one
  ``gather_rows``;
* the gathered rows match the JAX package's row-sharded run (the subprocess
  worker of ``test_torch_multi_mesh.py``): levels and distances exactly,
  with iteration counts and traces; PPR within rtol 1e-3, atol 1e-6;
* ``GraphQueryServer(mesh=RankMesh)`` gives every rank the mesh-less
  server's payloads, report, counters and LRU keys across a ``mutate``;
  ``partitioned_matvec`` on the 8-rank (2, 4) mesh builds the rank's part
  alone and equals block ``rank`` of the virtual mesh's call;
* a ``RankMesh`` and a ``Mesh`` of one layout get different runners, and
  an ``AsyncGraphServer`` tenant on a world-of-one ``RankMesh`` serves the
  virtual tenant's payloads, each flush one shared decision.
"""
import importlib

import numpy as np
import pytest
import torch

import torch_rank_multi_cases as cases
from repro_torch.core.mesh import Mesh
from repro_torch.core.rank_mesh import RankMesh
from repro_torch.graphs import multi as tmulti
from repro_torch.launch.ranks import run_ranks
from repro_torch.serve.graph_engine import AsyncGraphServer, GraphQueryServer
from repro_torch.serve.scheduler import FakeClock
from test_torch_multi_mesh import REF_CASES, reference  # noqa: F401
from torch_rank_cases import position

tpart = importlib.import_module("repro_torch.core.partition")
CASES = [(w, c) for w, cs in cases.TRAVERSALS.items() for c in cs]
MAX_ITERS = {"bfs": 64, "sssp": 64, "ppr": 50}


@pytest.fixture(scope="module")
def rank_runs():
    """{world: every rank's results}, one start of the ranks per world size."""
    return {w: run_ranks(cases.run_multi, w, timeout=300) for w in (4, 8)}


@pytest.fixture(scope="module")
def graph():
    return cases.graph()


@pytest.fixture(scope="module")
def engines(graph):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cases.build_engines(graph)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(engines, graph):
    """The mesh=None and virtual-mesh runs of a case, made once each."""
    memo = {}

    def get(case, virtual):
        _, shape, names, axis, app, fmt, b = case
        key = (app, fmt, b) + ((shape, names, axis) if virtual else ())
        if key not in memo:
            kw = {"mesh": Mesh(shape, names, device="cpu"), "axis_name": axis} if virtual else {}
            memo[key] = tuple(cases.run_app(app, engines[app, fmt],
                                            cases.sources_of(graph.n, b), **kw))
        return memo[key]
    return get


def assert_fields_equal(got, want, label):
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (label, i)
        assert torch.equal(g, w), (label, i)


def share_of(world, case, rank):
    """(lo, hi): the rows rank ``rank``'s position owns on the virtual mesh."""
    _, shape, names, axis, _, _, b = case
    vm = Mesh(shape, names, device="cpu")
    return vm.row_shares(b, axis)[position(vm, axis, rank)]


@pytest.mark.parametrize("world,case", CASES, ids=[f"{w}/{c[0]}" for w, c in CASES])
def test_rows_equal_unsharded(rank_runs, runs, world, case):
    want = runs(case, virtual=False)
    assert_fields_equal(runs(case, virtual=True), want, "virtual")
    for rank, out in enumerate(rank_runs[world]):
        assert_fields_equal(out["traversals"][case[0]]["result"], want, (case[0], rank))


@pytest.mark.parametrize("world,case", CASES, ids=[f"{w}/{c[0]}" for w, c in CASES])
def test_own_rows_are_the_virtual_meshs(rank_runs, runs, world, case):
    virtual = runs(case, virtual=True)
    for rank, out in enumerate(rank_runs[world]):
        rec = out["traversals"][case[0]]
        lo, hi = share_of(world, case, rank)
        assert tuple(rec["share"]) == (lo, hi), rank
        (own,) = rec["own"]
        # the gather's inputs: the result rows (cut to n_true), then the traces
        assert_fields_equal(own, [v[lo:hi] for v in virtual], (case[0], rank))


@pytest.mark.parametrize("world,case", CASES, ids=[f"{w}/{c[0]}" for w, c in CASES])
def test_each_rank_steps_only_its_rows(rank_runs, world, case):
    for rank, out in enumerate(rank_runs[world]):
        rec = out["traversals"][case[0]]
        lo, hi = share_of(world, case, rank)
        levels = int(rec["result"][1].max())
        if hi == lo:
            assert rec["rows_seen"] == [], rank          # an empty share launches nothing
        else:
            assert set(rec["rows_seen"]) == {hi - lo}, (rank, rec["rows_seen"])
            assert len(rec["rows_seen"]) >= levels, rank


@pytest.mark.parametrize("world,case", CASES, ids=[f"{w}/{c[0]}" for w, c in CASES])
def test_one_gather_a_level(rank_runs, world, case):
    """A stopping test a level (one more when the batch converges before
    max_iters) and the final gather, on every rank, empty shares too."""
    app = case[4]
    for rank, out in enumerate(rank_runs[world]):
        rec = out["traversals"][case[0]]
        levels = int(rec["result"][1].max())
        tests = levels + 1 if levels < MAX_ITERS[app] else levels
        assert rec["calls"] == {"all_true": tests, "gather_rows": 1}, (rank, rec["calls"])


@pytest.mark.parametrize("fmt", cases.ROUTES)
def test_relax_multi(rank_runs, engines, graph, fmt):
    eng = engines["sssp", fmt]
    d0, c0 = cases.relax_inputs(eng, graph.n)
    want = tuple(tmulti.relax_multi(eng, d0, c0))
    assert_fields_equal(tuple(tmulti.relax_multi(eng, d0, c0, mesh=Mesh((4,), ("batch",),
                                                                         device="cpu"))),
                        want, "virtual")
    for rank, out in enumerate(rank_runs[4]):
        assert_fields_equal(out["relax"][fmt]["result"], want, rank)
        assert out["relax"][fmt]["calls"]["gather_rows"] == 1


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("app", list(cases.APPS))
def test_bucket_drain(rank_runs, engines, graph, app, depth):
    src = cases.sources_of(graph.n, cases.BUCKET_SOURCES)
    buckets = [src[:4], src[4:7], src[7:]]
    want = tmulti.traverse_multi_buckets(engines[app, "bsr"], app, buckets, pipeline_depth=0,
                                         pad_to=4)
    for rank, out in enumerate(rank_runs[4]):
        rec = out["buckets"][app, depth]
        assert len(rec["result"]) == len(want)
        for got, w in zip(rec["result"], want):
            assert_fields_equal(got, tuple(w), (app, depth, rank))
        assert rec["calls"]["gather_rows"] == len(buckets)


def test_rank_and_virtual_meshes_get_their_own_runners(rank_runs, engines, graph):
    want = tuple(tmulti.bfs_multi(engines["bfs", "csr"], cases.sources_of(graph.n, 8)))
    for out in rank_runs[4]:
        assert out["runners"]["added"] == 1
        assert_fields_equal(out["runners"]["virtual"], want, "virtual on a rank")


def test_wire_bytes_are_counted(rank_runs):
    for world, outs in rank_runs.items():
        for out in outs:
            for key, wire in out["wire"].items():
                if "dr" not in key:
                    assert wire["all_true"] > 0 and wire["gather_rows"] > 0, (world, key)


# ---------------------------------------------------------------- the JAX side

def ref_label(k):
    app, b, shape, _, axis = REF_CASES[k]
    if shape == (4,):
        return 4, f"{app}/csr/B{b}"
    return 8, f"{app}/csr/B{b}/" + ("8" if shape == (8,) else "ab")


@pytest.mark.parametrize("k", range(len(REF_CASES)))
def test_rows_match_jax_row_sharded(rank_runs, reference, k):  # noqa: F811
    app = REF_CASES[k][0]
    world, label = ref_label(k)
    for rank, out in enumerate(rank_runs[world]):
        got = tmulti.__dict__[{"bfs": "BFSBatchResult", "sssp": "SSSPBatchResult",
                               "ppr": "PPRBatchResult"}[app]](*out["traversals"][label]["result"])
        for field, g in zip(got._fields, got):
            want = torch.from_numpy(reference[f"{k}/{field}"])
            assert g.shape == want.shape, (rank, field)
            if app == "ppr" and field in ("rank", "residual"):
                torch.testing.assert_close(g, want, rtol=1e-3, atol=1e-6)
            else:
                assert torch.equal(g.to(want.dtype), want), (rank, field)


# ---------------------------------------------------------------- the server

@pytest.fixture(scope="module")
def meshless_server(graph):
    return cases.serve(graph)


def assert_payload_equal(got, want, label):
    assert got is not None and want is not None and set(got) == set(want), label
    for key, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(w),
                                      err_msg=f"{label}[{key}]")
        assert type(got[key]) is type(w), (label, key)


def test_server_on_a_rank_mesh(rank_runs, meshless_server):
    want = meshless_server
    for rank, out in enumerate(rank_runs[4]):
        got = out["server"]["result"]
        for phase, (g_round, w_round) in enumerate(zip(got["rounds"], want["rounds"])):
            for (ga, gs, gc, gp), (wa, ws, wc, wp) in zip(g_round, w_round):
                assert (ga, gs, gc) == (wa, ws, wc), (rank, phase)
                assert_payload_equal(gp, wp, f"rank {rank} phase {phase} {wa}/{ws}")
        assert got["report"] == want["report"]
        assert got["counters"] == want["counters"]
        assert got["lru"] == want["lru"]
        assert out["server"]["calls"]["gather_rows"] > 0


@pytest.mark.parametrize("algorithm,kernel", cases.MATVECS)
def test_partitioned_matvec_on_a_rank_mesh(rank_runs, graph, algorithm, kernel):
    vm = Mesh((2, 4), ("dr", "dc"), device="cpu")
    srv = GraphQueryServer(graph, device="cpu")
    pm, fn, choice = srv.partitioned_matvec(algorithm, vm, kernel=kernel)
    sr = srv.engine(algorithm).sr
    xs = tpart.shard_tensor(pm.plan, cases.matvec_input(algorithm, pm, sr, graph.n), sr.zero)
    want = fn(pm.parts, xs)
    for rank, out in enumerate(rank_runs[8]):
        rec = out["partitioned"]["result"][algorithm, kernel]
        assert rec["strategy"] == choice.strategy
        assert rec["stacks"] == {1}, rank                 # the rank's own part alone
        assert torch.equal(rec["y"], want[rank:rank + 1]), rank


def test_a_world_of_one_and_the_async_server(graph, engines, tmp_path):
    """On one gloo rank: the rank mesh's bfs_multi equals the mesh-less
    run and gets a runner of its own; an async tenant on it serves what a
    tenant on the virtual mesh serves, rank 0 sharing each decision."""
    import torch.distributed as tdist
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                             world_size=1)
    try:
        m = RankMesh((1,), ("batch",), device="cpu")
        eng = engines["bfs", "csr"]
        src = cases.sources_of(graph.n, 6)
        want = tuple(tmulti.bfs_multi(eng, src, mesh=Mesh((1,), ("batch",), device="cpu")))
        before = len(eng.__dict__["_multi_runners"])
        assert_fields_equal(tuple(tmulti.bfs_multi(eng, src, mesh=m)), want, "world 1")
        assert len(eng.__dict__["_multi_runners"]) == before + 1
        assert m.calls["gather_rows"] == 1 and m.calls["all_true"] >= 1
        srv = AsyncGraphServer(clock=FakeClock())
        srv.add_tenant("ranks", graph, device="cpu", mesh=m)
        srv.add_tenant("virtual", graph, device="cpu", mesh=Mesh((1,), ("batch",),
                                                                 device="cpu"))
        shares = m.calls["share"]
        tickets = [(srv.submit("ranks", a, s), srv.submit("virtual", a, s))
                   for a, s in cases.QUERIES]
        srv.close()
        assert m.calls["share"] == shares + 1            # close: one shared decision
        for (a, s), (tr, tv) in zip(cases.QUERIES, tickets):
            assert tr.done() and tv.done()
            assert_payload_equal(tr.result, tv.result, f"world 1 {a}/{s}")
    finally:
        tdist.destroy_process_group()
