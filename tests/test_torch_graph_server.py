"""The port's ``GraphQueryServer`` (``repro_torch.serve.graph_engine``) on
the CPU, held to the JAX package's server on the same workloads:

* one fixed workload on ``face`` at scale 0.15, seed 1: every payload of
  bfs, sssp, cc, kcore and triangles exact, ppr and pagerank within rtol
  1e-3 and atol 1e-6; the ``engine_key`` strings, every counter, the cache
  stats and the latency section's keys and observation counts equal;
* a mutate on the split ``r-TX`` graph at scale 0.001, seed 3: the
  retained/invalidated split, ``plan_repairs``/``plan_replans``, version
  and the payloads after it equal, and every retained entry equals a cold
  run on the new snapshot;
* the partition choice equal, ``partitioned_matvec`` on a 2×4 virtual mesh
  equal to the single-device engine.

The JAX runs happen once per module (fixtures); the port's own behaviour
(dedup, LRU, fan-out, pipelining, stats copies, mutate semantics, the
device argument, and a mesh's answers equal to the mesh-less server's) is
checked on the port alone.
"""
import importlib
import json

import numpy as np
import pytest
import torch

from repro.core.delta import EdgeDelta as JDelta
from repro.graphs import generate as jgenerate
from repro.serve.graph_engine import GraphQueryServer as JServer
from repro_torch.core.delta import EdgeDelta
from repro_torch.core.mesh import Mesh
from repro_torch.core.semiring import MIN_PLUS
from repro_torch.graphs import (
    bfs, build_engine, cc_reference, connected_components, generate, kcore, ppr, sssp,
    triangle_count,
)
from repro_torch.graphs.ppr import pagerank
from repro_torch.serve.graph_engine import GLOBAL, GraphQueryServer, LRUCache

tpart = importlib.import_module("repro_torch.core.partition")

FLOAT_ALGS = ("ppr", "pagerank")
ALGS = ("bfs", "sssp", "ppr", "cc", "pagerank", "kcore", "triangles")
# flush 1: repeats inside the flush (dedup), 6 distinct bfs sources (two
# buckets of 4), every global twice; flush 2: re-asks (LRU hits) and one
# new source
WORKLOAD = [
    [("bfs", 0), ("bfs", 3), ("bfs", 5), ("bfs", 3), ("bfs", 7), ("bfs", 11),
     ("bfs", 13), ("sssp", 1), ("sssp", 2), ("sssp", 1), ("ppr", 4), ("ppr", 9),
     ("cc", None), ("pagerank", None), ("cc", None), ("kcore", None),
     ("triangles", None), ("pagerank", None), ("triangles", None)],
    [("bfs", 3), ("bfs", 17), ("sssp", 1), ("ppr", 9), ("cc", None), ("kcore", None),
     ("triangles", None)],
]


def assert_payload_close(got, want, algorithm, label=""):
    """Port payload against the JAX payload: same keys, dtypes and types;
    exact, except ppr/pagerank values within rtol 1e-3, atol 1e-6. PageRank
    may stop one iteration apart: XLA's fused update can move the crossing
    of ``tol`` by one (ROADMAP §3)."""
    assert got is not None and want is not None, label
    assert set(got) == set(want), label
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, np.generic)) or hasattr(w, "dtype"):
            w = np.asarray(w)
            assert isinstance(g, (np.ndarray, np.generic)), (label, k, type(g))
            assert np.asarray(g).dtype == w.dtype, (label, k)
            if algorithm in FLOAT_ALGS:
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6, err_msg=f"{label}[{k}]")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{label}[{k}]")
        else:
            assert type(g) is type(w), (label, k, type(g), type(w))
            if algorithm in FLOAT_ALGS and k == "residual":
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6)
            elif algorithm == "pagerank" and k == "iterations":
                assert abs(g - w) <= 1, (label, g, w)
            else:
                assert g == w, (label, k, g, w)


def run_workload(server, workload):
    flushes = []
    for batch in workload:
        reqs = [server.submit(a, s) for a, s in batch]
        assert server.flush() == reqs
        flushes.append(reqs)
    return flushes


@pytest.fixture(scope="module")
def face():
    return generate("face", scale=0.15, seed=1), jgenerate("face", scale=0.15, seed=1)


@pytest.fixture(scope="module")
def served(face):
    """The fixed workload through both servers (batch 4, LRU 64)."""
    tg, jg = face
    assert np.array_equal(tg.rows, jg.rows) and np.array_equal(tg.cols, jg.cols)
    ts = GraphQueryServer(tg, batch_size=4, cache_capacity=64, device="cpu")
    js = JServer(jg, batch_size=4, cache_capacity=64)
    return ts, js, run_workload(ts, WORKLOAD), run_workload(js, WORKLOAD)


@pytest.mark.parametrize("algorithm", ALGS)
def test_payloads_match_jax(served, algorithm):
    ts, js, tf, jf = served
    n = 0
    for fi, (treqs, jreqs) in enumerate(zip(tf, jf)):
        for tr, jr in zip(treqs, jreqs):
            assert (tr.algorithm, tr.source, tr.cached) == (jr.algorithm, jr.source, jr.cached)
            if tr.algorithm == algorithm:
                assert_payload_close(tr.result, jr.result, algorithm,
                                     f"flush {fi} {algorithm}/{tr.source}")
                n += 1
    assert n >= 2


def test_engine_key_counters_and_cache_match_jax(served):
    ts, js, _, _ = served
    assert ts.engine_key == js.engine_key
    st, sj = ts.stats(), js.stats()
    assert st.keys() == sj.keys()
    for k in sj:
        if k != "latency":
            assert st[k] == sj[k], k
    assert st["cache"] == ts.cache.stats()
    assert st["global_runs"] == 4 and st["deduped"] > 0 and st["cache_hits"] > 0


def test_latency_section_matches_jax(served):
    """Same instruments, same observation counts (times differ)."""
    lt, lj = served[0].stats()["latency"], served[1].stats()["latency"]
    assert lt.keys() == lj.keys()
    for k, w in lj.items():
        if isinstance(w, dict):
            assert w.keys() == lt[k].keys(), k
            for c in ("count", "writes"):
                if c in w:
                    assert lt[k][c] == w[c], (k, c)
            if k in ("batch_size", "queue_depth"):
                assert lt[k] == w, k
        else:
            assert lt[k] == w, k
    json.dumps(served[0].stats())


@pytest.mark.parametrize("spec", ["auto", "row:nnz", "col", "2d:rows"])
def test_partition_choice_matches_jax(face, spec):
    tg, jg = face
    ct = GraphQueryServer(tg, strategy=spec, device="cpu").partition_choice
    cj = JServer(jg, strategy=spec).partition_choice
    assert (ct.strategy, ct.balance, ct.merge, ct.merge_order, ct.grid) == \
        (cj.strategy, cj.balance, cj.merge, cj.merge_order, cj.grid)
    assert ct.costs.keys() == cj.costs.keys()
    assert ct.plan.imbalance() == pytest.approx(cj.plan.imbalance())


def engine_input(algorithm, n, rng):
    """A vector in the algorithm's semiring domain on which every fold order
    gives the same result (0/1 or small integers)."""
    if algorithm == "bfs":
        return (rng.random(n) < 0.3).astype(np.int32)
    if algorithm == "sssp":
        return np.where(rng.random(n) < 0.3, rng.integers(0, 5, n), np.inf).astype(np.float32)
    if algorithm == "cc":
        return rng.integers(1, 50, n).astype(np.float32)
    return (rng.random(n) < 0.3).astype(np.float32)


@pytest.mark.parametrize("kernel", ["spmv", "spmspv"])
@pytest.mark.parametrize("algorithm", ["bfs", "sssp", "ppr", "cc", "kcore"])
def test_partitioned_matvec_equals_single_device_engine(face, algorithm, kernel):
    tg, _ = face
    srv = GraphQueryServer(tg, strategy="auto", device="cpu")
    mesh = Mesh((2, 4), device="cpu")
    pm, fn, choice = srv.partitioned_matvec(algorithm, mesh, kernel=kernel)
    assert choice.strategy == srv.partition_choice.strategy
    eng = srv.engine(algorithm)
    if algorithm == "sssp":
        # as in the JAX server, the partitioned SSSP matrix carries seeded
        # random weights, not the served engine's content-keyed ones
        eng = build_engine(tg, MIN_PLUS, srv.stump, weighted=True, seed=srv.weight_seed,
                           device="cpu")
    sr = eng.sr
    x = engine_input(algorithm, tg.n, np.random.default_rng(7))
    xp = np.full(pm.plan.shape[1], sr.zero, x.dtype)
    xp[: tg.n] = x
    xs = tpart.shard_tensor(pm.plan, torch.from_numpy(xp), sr.zero)
    y = tpart.unshard_tensor(pm.plan, fn(pm.parts, xs))[: tg.n]
    xe = torch.full((eng.n,), sr.zero, dtype=sr.dtype)
    xe[: tg.n] = torch.from_numpy(x)
    want = eng.spmv_fn(xe)[: tg.n]
    if algorithm == "ppr":
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-7)
    else:
        assert torch.equal(y, want)
    with pytest.raises(ValueError):
        srv.partitioned_matvec(algorithm, Mesh((2, 2), device="cpu"))


def test_mesh_and_device_arguments(face):
    tg, _ = face
    # a mesh row-shards each traversal block: the answers do not move
    plain = GraphQueryServer(tg, batch_size=4, device="cpu")
    sharded = GraphQueryServer(tg, batch_size=4, mesh=Mesh((2, 4), device="cpu"),
                               axis_name=("dr", "dc"), device="cpu")
    queries = [("bfs", 0), ("bfs", 3), ("bfs", 5), ("sssp", 1), ("sssp", 2), ("ppr", 4),
               ("ppr", 9)]
    for srv in (plain, sharded):
        for a, s in queries:
            srv.submit(a, s)
    for p, q in zip(plain.flush(), sharded.flush()):
        assert set(q.result) == set(p.result)
        for k, v in p.result.items():
            np.testing.assert_array_equal(q.result[k], v)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GraphQueryServer(tg)
    srv = GraphQueryServer(tg, device="cpu")
    assert srv.device == torch.device("cpu")
    assert srv.engine("bfs").device == torch.device("cpu")
    assert srv.engine("ppr") is srv.engine("pagerank")
    with pytest.raises(ValueError):
        srv.engine("diameter")


def test_triangles_dense_limit_fallback(face):
    """Above triangle_dense_limit the served count is the sequential
    counter's, equal to the SpGEMM count, as in the JAX server."""
    tg, _ = face
    want = int(triangle_count(tg, device="cpu").total)
    for limit in (1, 8192):
        srv = GraphQueryServer(tg, triangle_dense_limit=limit, device="cpu")
        req = srv.submit("triangles")
        srv.flush()
        assert req.result == {"total": want, "iterations": 1}


# ---------------------------------------------------------------------------
# mutate on the split r-TX graph, against the JAX server
# ---------------------------------------------------------------------------

def delta_for(graph, delta_cls):
    """A delta confined to the largest component, and the sources whose
    cached answers must survive it (in other components): the rule of
    tests/test_graph_server.py::_delta_for."""
    labels = cc_reference(graph.rows, graph.cols, graph.n)
    uniq, counts = np.unique(labels, return_counts=True)
    big = int(uniq[np.argmax(counts)])
    big_nodes = np.nonzero(labels == big)[0]
    ins = np.stack([big_nodes[2:6], big_nodes[8:12]], 1)
    outside = [int(np.nonzero(labels == u)[0][0]) for u, c in zip(uniq, counts) if u != big][:2]
    e = int(np.nonzero(labels[graph.rows] == big)[0][0])
    delta = delta_cls(insert_rows=ins[:, 0], insert_cols=ins[:, 1],
                      delete_rows=[graph.rows[e]], delete_cols=[graph.cols[e]])
    return delta, int(big_nodes[0]), outside


@pytest.fixture(scope="module")
def mutated():
    """Both servers on split r-TX: answer, mutate, answer again."""
    tg, jg = generate("r-TX", scale=0.001, seed=3), jgenerate("r-TX", scale=0.001, seed=3)
    delta, inside, outside = delta_for(tg, EdgeDelta)
    jdelta, _, _ = delta_for(jg, JDelta)
    assert outside, "the fixture graph must have several components"
    before = ([(a, s) for s in outside for a in ("bfs", "sssp", "ppr")]
              + [("bfs", inside), ("sssp", inside), ("cc", None), ("kcore", None)])
    after = before + [("bfs", outside[0] + 1), ("pagerank", None)]
    out = {}
    for name, srv, d in (("torch", GraphQueryServer(tg, batch_size=4, cache_capacity=128,
                                                    device="cpu"), delta),
                         ("jax", JServer(jg, batch_size=4, cache_capacity=128), jdelta)):
        srv.partition_choice                       # planned, so mutate repairs it
        pre = run_workload(srv, [before])[0]
        key0, size0 = srv.engine_key, len(srv.cache)
        report = srv.mutate(d)
        post = run_workload(srv, [after])[0]
        out[name] = dict(srv=srv, pre=pre, post=post, report=report, key0=key0, size0=size0)
    return out, outside


def test_mutate_matches_jax(mutated):
    out, outside = mutated
    t, j = out["torch"], out["jax"]
    assert t["report"] == j["report"]
    assert t["report"]["retained"] == 3 * len(outside)
    assert t["report"]["retained"] + t["report"]["invalidated"] == t["size0"]
    assert t["key0"] == j["key0"] and t["srv"].engine_key == j["srv"].engine_key
    assert t["srv"].engine_key != t["key0"]
    st, sj = t["srv"].stats(), j["srv"].stats()
    for k in sj:
        if k != "latency":
            assert st[k] == sj[k], k
    assert st["version"] == 1 and st["plan_repairs"] + st["plan_replans"] == 1
    for phase in ("pre", "post"):
        for tr, jr in zip(t[phase], j[phase]):
            assert (tr.algorithm, tr.source, tr.cached) == (jr.algorithm, jr.source, jr.cached)
            assert_payload_close(tr.result, jr.result, tr.algorithm,
                                 f"{phase} {tr.algorithm}/{tr.source}")


def test_retained_entries_equal_cold_runs(mutated):
    """Every entry the LRU carried across the mutate equals a cold run on
    the new snapshot, bit for bit (ppr too: same engine, same loop)."""
    out, _ = mutated
    srv = out["torch"]["srv"]
    cached = [r for r in out["torch"]["post"] if r.cached]
    assert len(cached) == out["torch"]["report"]["retained"]
    cold = GraphQueryServer(srv.graph, batch_size=4, cache_capacity=0, device="cpu")
    reqs = [cold.submit(r.algorithm, None if r.source == GLOBAL else r.source) for r in cached]
    cold.flush()
    for r, c in zip(cached, reqs):
        assert r.result.keys() == c.result.keys()
        for k in r.result:
            np.testing.assert_array_equal(r.result[k], c.result[k])
    np.testing.assert_array_equal(
        bfs(srv.engine("bfs"), cached[0].source).levels.numpy(), cached[0].result["levels"])


# ---------------------------------------------------------------------------
# the port's own serving behaviour
# ---------------------------------------------------------------------------

@pytest.fixture()
def server(face):
    return GraphQueryServer(face[0], batch_size=4, cache_capacity=64, device="cpu")


def test_results_match_single_source(server, face):
    g = face[0]
    srcs = [int(s) for s in np.random.default_rng(0).integers(0, g.n, 5)]
    reqs = [server.submit("bfs", s) for s in srcs]
    reqs += [server.submit("sssp", srcs[0]), server.submit("ppr", srcs[1])]
    assert server.flush() == reqs
    ref = bfs(server.engine("bfs"), srcs[2])
    np.testing.assert_array_equal(reqs[2].result["levels"], ref.levels.numpy())
    assert reqs[2].result["iterations"] == ref.iterations
    np.testing.assert_array_equal(reqs[5].result["dist"],
                                  sssp(server.engine("sssp"), srcs[0]).dist.numpy())
    np.testing.assert_allclose(reqs[6].result["rank"],
                               ppr(server.engine("ppr"), srcs[1]).rank.numpy(),
                               rtol=1e-5, atol=1e-8)


def test_globals_match_apps_and_compute_once(server, face):
    g = face[0]
    reqs = {alg: [server.submit(alg) for _ in range(3)]
            for alg in ("cc", "pagerank", "triangles", "kcore")}
    server.flush()
    st = server.stats()
    assert st["global_runs"] == 4 and st["cache_hits"] == 8 == server.cache.hits
    for rs in reqs.values():
        assert not rs[0].cached and rs[1].cached and rs[2].cached
    np.testing.assert_array_equal(reqs["cc"][0].result["labels"],
                                  connected_components(server.engine("cc")).labels.numpy())
    np.testing.assert_array_equal(reqs["kcore"][1].result["coreness"],
                                  kcore(server.engine("kcore")).coreness.numpy())
    assert reqs["triangles"][2].result["total"] == int(triangle_count(g, device="cpu").total)
    pr = pagerank(server.engine("pagerank"), alpha=server.alpha, max_iters=server.max_iters)
    np.testing.assert_array_equal(reqs["pagerank"][0].result["rank"], pr.rank.numpy())
    assert reqs["pagerank"][0].result["iterations"] == pr.iterations
    r4 = server.submit("cc")
    server.flush()
    assert r4.cached and server.stats()["global_runs"] == 4


def test_global_compute_once_with_caching_disabled(face):
    srv = GraphQueryServer(face[0], cache_capacity=0, device="cpu")
    reqs = [srv.submit("cc") for _ in range(4)]
    srv.flush()
    st = srv.stats()
    assert st["global_runs"] == 1 and st["deduped"] == 3 and st["cache_hits"] == 0
    for r in reqs[1:]:
        np.testing.assert_array_equal(r.result["labels"], reqs[0].result["labels"])


def test_dedup_cache_and_chunking(server):
    s = 33
    r1, r2 = server.submit("bfs", s), server.submit("bfs", s)
    server.flush()
    assert server.stats()["deduped"] == 1 and server.stats()["batches"] == 1
    assert not r1.cached and not r2.cached
    r3 = server.submit("bfs", s)
    server.flush()
    assert r3.cached and server.stats()["batches"] == 1
    np.testing.assert_array_equal(r3.result["levels"], r1.result["levels"])
    done = [server.submit("bfs", v) for v in range(10)]
    assert server.flush() == done and server.stats()["batches"] == 4   # 1 + ceil(10/4)


def test_submit_validation(server, face):
    n = face[0].n
    for bad in (("pagerank_global", 0), ("bfs", n + 5), ("bfs", None), ("cc", 0),
                ("triangles", 3), ("bfs", -1)):
        with pytest.raises(ValueError):
            server.submit(*bad)
    assert server.stats()["submitted"] == 0


def test_lru_eviction_and_counters():
    c = LRUCache(capacity=2)
    assert c.stats() == {"lookups": 0, "hits": 0, "misses": 0, "evictions": 0,
                         "size": 0, "capacity": 2}
    c.put(("k", "bfs", 1), {})
    c.put(("k", "bfs", 2), {})
    c.put(("k", "bfs", 3), {})
    c.get(("k", "bfs", 3))
    assert c.get(("k", "bfs", 1)) is None
    c.get(("k", "bfs", 2))
    c.put(("k", "bfs", 4), {})
    assert c.get(("k", "bfs", 3)) is None and c.get(("k", "bfs", 2)) is not None
    assert c.stats() == {"lookups": 5, "hits": 3, "misses": 2, "evictions": 2,
                         "size": 2, "capacity": 2}
    z = LRUCache(capacity=0)
    z.put(("k", "bfs", 1), {})
    assert len(z) == 0


def test_shared_cache_keys_by_graph_content(face):
    g = face[0]
    shared = LRUCache(128)
    other = generate("face", scale=0.15, seed=7)
    s1 = GraphQueryServer(g, batch_size=4, cache=shared, device="cpu")
    s2 = GraphQueryServer(other, batch_size=4, cache=shared, device="cpu")
    assert s1.engine_key != s2.engine_key
    a = s1.submit("bfs", 3)
    s1.flush()
    b = s2.submit("bfs", 3)
    s2.flush()
    assert not b.cached
    np.testing.assert_array_equal(b.result["levels"], bfs(s2.engine("bfs"), 3).levels.numpy())
    s3 = GraphQueryServer(generate("face", scale=0.15, seed=1), batch_size=4, cache=shared,
                          device="cpu")
    assert s3.engine_key == s1.engine_key
    c = s3.submit("bfs", 3)
    s3.flush()
    assert c.cached
    np.testing.assert_array_equal(c.result["levels"], a.result["levels"])
    s4 = GraphQueryServer(g, batch_size=4, cache=shared, weight_seed=6, device="cpu")
    d = s4.submit("sssp", 1)
    s4.flush()
    assert not d.cached and s4.engine_key != s1.engine_key


def test_flush_pipelining_equality(face):
    g = face[0]
    seq = GraphQueryServer(g, batch_size=4, cache_capacity=0, pipeline_depth=0, device="cpu")
    pip = GraphQueryServer(g, batch_size=4, cache_capacity=0, pipeline_depth=3,
                           strategy="auto", device="cpu")
    for alg in ("bfs", "sssp", "ppr"):
        for s in range(10):
            seq.submit(alg, s)
            pip.submit(alg, s)
    done_seq, done_pip = seq.flush(), pip.flush()
    assert seq.stats()["batches"] == pip.stats()["batches"] == 9
    for a, b in zip(done_seq, done_pip):
        assert (a.algorithm, a.source) == (b.algorithm, b.source)
        for k, v in a.result.items():
            np.testing.assert_array_equal(v, b.result[k])


def test_stats_deep_copy_and_latency(face):
    srv = GraphQueryServer(face[0], batch_size=4, device="cpu")
    assert srv.stats()["latency"]["queue_depth"]["writes"] == 0
    assert srv.flush() == [] and "flush_s" not in srv.stats()["latency"]
    for s in (1, 2, 3, 4, 5):
        srv.submit("bfs", s)
    srv.flush()
    srv.submit("bfs", 1)
    srv.flush()
    lat = srv.stats()["latency"]
    assert lat["queue_depth"]["max"] == 5.0 and lat["queue_depth"]["writes"] == 2
    assert lat["enqueue_wait_s"]["count"] == 6 and lat["flush_s"]["count"] == 2
    assert lat["batch_size"]["count"] == 2 and lat["batch_size"]["max"] == 4.0
    assert lat["bucket_s"]["count"] == 2 and lat["lru_hit_rate"] > 0.0
    st = srv.stats()
    st["served"] = 999
    st["cache"]["hits"] = 999
    st["latency"]["flush_s"]["count"] = 999
    fresh = srv.stats()
    assert fresh["served"] == 6 and fresh["cache"]["hits"] != 999
    assert fresh["latency"]["flush_s"]["count"] == 2


def test_payloads_are_host_arrays_in_jax_dtypes(server):
    reqs = [server.submit(a, 2) for a in ("bfs", "sssp", "ppr")]
    reqs += [server.submit(a) for a in ("cc", "pagerank", "kcore", "triangles")]
    server.flush()
    want = {"levels": np.int32, "dist": np.float32, "rank": np.float32,
            "labels": np.int32, "coreness": np.int32}
    for r in reqs:
        for k, v in r.result.items():
            if k in want:
                assert isinstance(v, np.ndarray) and v.dtype == want[k], (r.algorithm, k)
            elif k == "residual" and r.algorithm == "ppr":
                assert isinstance(v, np.float32)
            elif k == "residual":
                assert isinstance(v, float)
            else:
                assert type(v) is int, (r.algorithm, k, type(v))


def test_mutate_semantics_on_the_port():
    """Queued requests see the old snapshot; a no-op delta keeps every key;
    whole-graph entries always invalidate."""
    g = generate("r-TX", scale=0.001, seed=3)
    delta, inside, _ = delta_for(g, EdgeDelta)
    srv = GraphQueryServer(g, batch_size=4, device="cpu")
    ref_old = bfs(srv.engine("bfs"), inside).levels.numpy()
    r0 = srv.submit("bfs", 0)
    srv.flush()
    key = srv.engine_key
    u, v = int(g.rows[0]), int(g.cols[0])
    assert srv.mutate(EdgeDelta(insert_rows=[u], insert_cols=[v])) == {
        "version": 1, "inserted": 0, "deleted": 0, "retained": 0, "invalidated": 0,
        "replanned": False}
    assert srv.engine_key == key
    r1 = srv.submit("bfs", 0)
    srv.submit("cc")
    srv.flush()
    assert r1.cached and r1.result is not r0.result
    queued = srv.submit("bfs", inside)
    srv.mutate(delta)
    assert srv._engines == {}
    np.testing.assert_array_equal(queued.result["levels"], ref_old)
    again = srv.submit("cc")
    fresh = srv.submit("bfs", inside)
    srv.flush()
    assert not again.cached and srv.stats()["global_runs"] == 2
    np.testing.assert_array_equal(fresh.result["levels"],
                                  bfs(srv.engine("bfs"), inside).levels.numpy())
