"""The port's ``AsyncGraphServer`` (``repro_torch.serve.graph_engine``) on
the CPU.

* **differential** — seeded workloads (traversals and whole-graph kinds, a
  live ``mutate()`` between two phases) through the async server on a
  ``FakeClock`` (windows flushing at arbitrary points) and the port's
  synchronous server (one flush per phase): payloads element-exact, as
  ``tests/test_async_server.py`` holds the JAX servers. One workload is
  also held to the JAX package's async server: payloads (ppr/pagerank
  within rtol 1e-3, atol 1e-6), cached flags, request and window ids,
  the scheduler's stats and the SLO ledger.
* **fake-clock scheduling** — time window, bucket fill, deadline-pulled
  flush, EDF, mutation interleaving, multi-tenant isolation over the
  shared LRU, eager validation, backpressure, SLO accounting, abandonment,
  the flush edge semantics, and tracing (every ``serve/*`` span carries
  its ``window_id``; traced payloads equal untraced).
* **threads** — ``start()``/``close()`` on the real clock with concurrent
  submitters, a mutator and a stats sampler: no ticket lost or left
  unresolved, conservation in every snapshot. Every wait and join has a
  timeout.
"""
import threading
import time

import numpy as np
import pytest

from repro.core.delta import EdgeDelta as JDelta
from repro.graphs import generate as jgenerate
from repro.serve.graph_engine import AsyncGraphServer as JAsync
from repro.serve.scheduler import FakeClock as JClock
from repro_torch.core.delta import EdgeDelta
from repro_torch.graphs import generate
from repro_torch.obs import trace
from repro_torch.serve.graph_engine import (
    GLOBAL_ALGORITHMS, AsyncGraphServer, GraphQueryServer,
)
from repro_torch.serve.scheduler import BackpressureError, FakeClock, QueryTicket

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def graph():
    return generate("face", scale=0.15, seed=1)


def assert_payload_equal(got, want, label=""):
    """Element-exact payload equality (arrays bitwise, scalars ==)."""
    assert got is not None and want is not None, f"unresolved: {label}"
    assert set(got) == set(want), label
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f"{label}[{k}]")
        else:
            assert g == w, f"{label}[{k}]: {g} != {w}"


def random_queries(rng, n, k):
    algs = ("bfs", "sssp", "ppr", "cc", "pagerank")
    out = []
    for _ in range(k):
        a = algs[int(rng.integers(0, len(algs)))]
        out.append((a, None if a in GLOBAL_ALGORITHMS else int(rng.integers(0, n))))
    return out


def random_delta(rng, g, delta_cls, k=3):
    ir = rng.integers(0, g.n, k)
    ic = (ir + 1 + rng.integers(0, g.n - 1, k)) % g.n
    idx = rng.integers(0, len(g.rows), 2)
    return delta_cls(insert_rows=ir, insert_cols=ic, delete_rows=np.asarray(g.rows)[idx],
                     delete_cols=np.asarray(g.cols)[idx])


def run_differential(asrv, clock, ssrv, g, seed, delta_cls):
    """Two phases of seeded queries around one mutate; the async side
    flushes at random interior points, the sync side once per phase.
    Returns the (ticket, request) pairs and the two mutate reports."""
    rng = np.random.default_rng(100 + seed)
    pairs = []

    def run_phase(queries):
        for a, s in queries:
            dl = float(rng.uniform(0.005, 0.1)) if rng.random() < 0.3 else None
            pr = int(rng.integers(0, 3))
            pairs.append((asrv.submit("t", a, s, deadline=dl, priority=pr),
                          ssrv.submit(a, s) if ssrv is not None else None))
            if rng.random() < 0.25:
                clock.advance(float(rng.uniform(0.0, 0.08)))
                asrv.poll()
        asrv.drain()
        if ssrv is not None:
            ssrv.flush()

    run_phase(random_queries(rng, g.n, 10))
    delta = random_delta(rng, asrv.tenant("t").graph, delta_cls)
    reports = (asrv.mutate("t", delta), ssrv.mutate(delta) if ssrv is not None else None)
    run_phase(random_queries(rng, g.n, 8))
    return pairs, reports


@pytest.mark.parametrize("pipeline_depth", [0, 2])
@pytest.mark.parametrize("strategy", ["auto", "col"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_differential_matches_sync_server(seed, strategy, pipeline_depth):
    g = generate("face", scale=0.15, seed=seed)
    clock = FakeClock()
    asrv = AsyncGraphServer(clock=clock, max_pending=1024, max_wait=0.05)
    asrv.add_tenant("t", g, batch_size=4, pipeline_depth=pipeline_depth, strategy=strategy,
                    **CPU)
    ssrv = GraphQueryServer(g, batch_size=4, pipeline_depth=pipeline_depth, strategy=strategy,
                            **CPU)
    pairs, (ra, rs) = run_differential(asrv, clock, ssrv, g, seed, EdgeDelta)
    assert (ra["version"], ra["inserted"], ra["deleted"]) == \
        (rs["version"], rs["inserted"], rs["deleted"])
    for i, (tk, req) in enumerate(pairs):
        assert tk.done()
        assert_payload_equal(tk.result, req.result, label=f"q{i}:{tk.algorithm}/{tk.source}")


@pytest.fixture(scope="module")
def both_async():
    """One differential workload (seed 1, pipeline depth 2) through the
    port's and the JAX package's async servers on fake clocks."""
    out = {}
    for name, mod_gen, srv_cls, clock_cls, delta_cls, kw in (
            ("torch", generate, AsyncGraphServer, FakeClock, EdgeDelta, CPU),
            ("jax", jgenerate, JAsync, JClock, JDelta, {})):
        g = mod_gen("face", scale=0.15, seed=1)
        clock = clock_cls()
        asrv = srv_cls(clock=clock, max_pending=1024, max_wait=0.05)
        asrv.add_tenant("t", g, batch_size=4, pipeline_depth=2, **kw)
        pairs, (report, _) = run_differential(asrv, clock, None, g, 1, delta_cls)
        out[name] = (asrv, [tk for tk, _ in pairs], report)
    return out


def test_async_matches_jax_async_server(both_async):
    ta, tt, trep = both_async["torch"]
    ja, jt, jrep = both_async["jax"]
    assert trep == jrep
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        assert (a.algorithm, a.source, a.cached, a.request_id, a.window_id, a.deadline,
                a.dispatched_at, a.resolved_at) == \
            (b.algorithm, b.source, b.cached, b.request_id, b.window_id, b.deadline,
             b.dispatched_at, b.resolved_at)
        assert a.result.keys() == b.result.keys()
        for k, w in b.result.items():
            if a.algorithm in ("ppr", "pagerank") and k != "iterations":
                np.testing.assert_allclose(a.result[k], w, rtol=1e-3, atol=1e-6)
            elif a.algorithm == "pagerank":
                assert abs(a.result[k] - w) <= 1     # tol crossing, ROADMAP §3
            else:
                np.testing.assert_array_equal(a.result[k], w)
    st, sj = ta.stats("t"), ja.stats("t")
    assert st["scheduler"] == sj["scheduler"]
    for k in ("admitted", "dispatched", "pending", "abandoned", "resolved", "goodput",
              "deadline_misses", "no_deadline", "wait_timeouts", "window_id"):
        assert st["slo"][k] == sj["slo"][k], k
    assert st["slo"]["slack_s"] == sj["slo"]["slack_s"]
    for k in sj:
        if k not in ("latency", "scheduler", "slo"):
            assert st[k] == sj[k], k
    assert st["latency"].keys() == sj["latency"].keys()


def test_differential_across_mutate_epochs_cache_retention(graph):
    clock = FakeClock()
    asrv = AsyncGraphServer(clock=clock, max_pending=64, max_wait=0.02)
    asrv.add_tenant("t", graph, batch_size=4, **CPU)
    ssrv = GraphQueryServer(graph, batch_size=4, **CPU)
    src = int(graph.n // 3)
    t1, r1 = asrv.submit("t", "bfs", src), ssrv.submit("bfs", src)
    asrv.drain()
    ssrv.flush()
    assert_payload_equal(t1.result, r1.result)
    delta = random_delta(np.random.default_rng(9), asrv.tenant("t").graph, EdgeDelta, k=2)
    asrv.mutate("t", delta)
    ssrv.mutate(delta)
    t2, r2 = asrv.submit("t", "bfs", src), ssrv.submit("bfs", src)
    asrv.drain()
    ssrv.flush()
    assert_payload_equal(t2.result, r2.result)
    assert t2.cached == r2.cached


# ---------------------------------------------------------------------------
# fake-clock scheduling
# ---------------------------------------------------------------------------

def test_time_window_fill_and_deadline_flush(graph):
    clock = FakeClock()
    srv = AsyncGraphServer(clock=clock, max_wait=0.05)
    srv.add_tenant("t", graph, batch_size=8, **CPU)
    tks = [srv.submit("t", "bfs", s) for s in (0, 1)]
    assert srv.poll() == 0
    clock.advance(0.049)
    assert srv.poll() == 0
    clock.advance(0.002)
    assert srv.poll() == 2 and all(t.done() for t in tks)

    srv.submit("t", "bfs", 0)
    tk = srv.submit("t", "bfs", 1, deadline=0.01)
    clock.advance(0.011)
    assert srv.poll() == 2 and tk.done()
    assert tk.dispatched_at == pytest.approx(clock.now())

    fill = AsyncGraphServer(clock=clock, max_wait=10.0)
    fill.add_tenant("t", graph, batch_size=4, **CPU)
    tks = [fill.submit("t", "bfs", s) for s in range(4)]
    assert fill.poll() == 4 and all(t.done() for t in tks)
    occ = fill.stats("t")["latency"]["window_occupancy"]
    assert occ["count"] == 1 and occ["max"] == pytest.approx(1.0)


def test_edf_order_reaches_the_server(graph):
    """The executor receives the window in EDF order and submits it to the
    synchronous server in that order."""
    clock = FakeClock()
    srv = AsyncGraphServer(clock=clock, max_wait=1.0)
    srv.add_tenant("t", graph, batch_size=16, **CPU)
    specs = [(None, 0), (0.5, 0), (0.1, 0), (None, 2), (0.1, 1)]
    tks = [srv.submit("t", "bfs", i, deadline=dl, priority=pr)
           for i, (dl, pr) in enumerate(specs)]
    seen = []
    server = srv.tenant("t")
    real_submit = server.submit
    server.submit = lambda a, s=None: (seen.append(s), real_submit(a, s))[1]
    srv.drain()
    assert seen == [4, 2, 1, 3, 0]
    assert all(t.done() for t in tks)


def test_mutate_interleaves_with_pending_window(graph):
    clock = FakeClock()
    asrv = AsyncGraphServer(clock=clock, max_wait=10.0)
    asrv.add_tenant("t", graph, batch_size=64, **CPU)
    oracle_pre = GraphQueryServer(graph, batch_size=64, **CPU)
    tk_pre = asrv.submit("t", "bfs", 3)
    report = asrv.mutate("t", EdgeDelta(insert_rows=[3], insert_cols=[4]))
    assert tk_pre.done() and report["version"] == 1
    r_pre = oracle_pre.submit("bfs", 3)
    oracle_pre.flush()
    assert_payload_equal(tk_pre.result, r_pre.result, label="pre-mutation")
    tk_post = asrv.submit("t", "bfs", 3)
    asrv.drain()
    oracle_post = GraphQueryServer(asrv.tenant("t").graph, batch_size=64, **CPU)
    r_post = oracle_post.submit("bfs", 3)
    oracle_post.flush()
    assert_payload_equal(tk_post.result, r_post.result, label="post-mutation")


def test_multi_tenant_shared_cache_and_isolated_stats():
    ga, gb = generate("face", scale=0.15, seed=1), generate("face", scale=0.15, seed=7)
    srv = AsyncGraphServer(clock=FakeClock(), max_wait=10.0, cache_capacity=64)
    sa = srv.add_tenant("a", ga, batch_size=4, **CPU)
    sb = srv.add_tenant("b", gb, batch_size=4, **CPU)
    assert sa.cache is srv.cache and sb.cache is srv.cache
    assert sa.engine_key != sb.engine_key and sa.device.type == "cpu"
    with pytest.raises(ValueError):
        srv.add_tenant("a", ga, **CPU)
    ta = [srv.submit("a", "bfs", s) for s in range(4)]
    tb = [srv.submit("b", "bfs", s) for s in range(2)]
    srv.drain()
    assert all(t.done() for t in ta + tb)
    st_a, st_b = srv.stats("a"), srv.stats("b")
    assert st_a["served"] == 4 and st_b["served"] == 2
    assert st_a["cache"] == st_b["cache"] and st_a["cache"]["size"] == 6
    assert st_a["scheduler"]["dispatched"] == 6
    t2 = srv.submit("a", "bfs", 0)
    srv.drain()
    assert t2.cached
    np.testing.assert_array_equal(t2.result["levels"], ta[0].result["levels"])


def test_submit_validates_eagerly(graph):
    srv = AsyncGraphServer(clock=FakeClock())
    srv.add_tenant("t", graph, **CPU)
    for bad in (("t", "bfs"), ("t", "cc", 0), ("t", "bfs", graph.n + 5), ("ghost", "bfs", 0)):
        with pytest.raises(ValueError):
            srv.submit(*bad)
    assert srv.scheduler.stats()["admitted"] == 0


def test_backpressure_typed_and_counted(graph):
    srv = AsyncGraphServer(clock=FakeClock(), max_pending=8, max_wait=10.0)
    srv.add_tenant("t", graph, batch_size=64, **CPU)
    tks = [srv.submit("t", "bfs", s) for s in range(8)]
    with pytest.raises(BackpressureError) as ei:
        srv.submit("t", "bfs", 0)
    assert (ei.value.tenant, ei.value.depth, ei.value.max_pending) == ("t", 8, 8)
    st = srv.stats("t")
    assert st["latency"]["rejected"] == 1
    assert st["scheduler"]["rejected"] == 1 and st["scheduler"]["pending"] == 8
    assert srv.drain() == 8 and all(t.done() for t in tks)
    tk = srv.submit("t", "bfs", 1)
    srv.drain()
    assert tk.done()


def test_flush_edge_semantics(graph):
    srv = GraphQueryServer(graph, batch_size=4, **CPU)
    assert srv.flush() == []
    assert srv.stats()["latency"]["queue_depth"]["writes"] == 0
    req = srv.submit("bfs", 2)
    srv.flush()
    payload, before = req.result, srv.stats()
    srv._queue.append(req)
    fresh = srv.submit("bfs", 5)
    assert srv.flush() == [req, fresh] and req.result is payload
    after = srv.stats()
    assert after["served"] == before["served"] + 1
    assert after["batches"] == before["batches"] + 1
    srv._queue.append(req)
    assert srv.flush() == [req] and srv.stats()["served"] == after["served"]


def test_slo_deadline_miss_accounting(graph):
    clock = FakeClock()
    srv = AsyncGraphServer(clock=clock, max_wait=0.05)
    srv.add_tenant("t", graph, batch_size=8, **CPU)
    hit = srv.submit("t", "bfs", 0, deadline=10.0)
    miss = srv.submit("t", "bfs", 1, deadline=0.01)
    free = srv.submit("t", "bfs", 2)
    clock.advance(0.06)
    assert srv.poll() == 3
    assert hit.slack() == pytest.approx(10.0 - 0.06)
    assert miss.slack() == pytest.approx(0.01 - 0.06)
    assert free.slack() is None
    slo = srv.stats("t")["slo"]
    assert (slo["goodput"], slo["deadline_misses"], slo["no_deadline"]) == (1, 1, 1)
    assert slo["resolved"] == slo["dispatched"] == 3
    assert slo["admitted"] == slo["dispatched"] + slo["pending"] + slo["abandoned"]
    assert slo["slack_s"]["count"] == 2 and slo["lateness_s"]["count"] == 1
    assert slo["lateness_s"]["min"] == pytest.approx(0.05)
    srv.poll()
    srv.drain()
    again = srv.stats("t")["slo"]
    assert all(again[k] == slo[k] for k in ("resolved", "goodput", "deadline_misses"))
    tl = miss.timeline()
    assert tl["admitted_at"] <= tl["dispatched_at"] <= tl["resolved_at"]


def test_ticket_abandonment_accounting(graph):
    srv = AsyncGraphServer(clock=FakeClock(), max_wait=10.0)
    srv.add_tenant("t", graph, batch_size=64, **CPU)
    gone, kept = srv.submit("t", "bfs", 0), srv.submit("t", "bfs", 1)
    with pytest.raises(TimeoutError):
        gone.wait(timeout=0.01)
    assert gone.abandoned and not gone.done()
    slo = srv.stats("t")["slo"]
    assert (slo["abandoned"], slo["wait_timeouts"], slo["pending"], slo["dispatched"]) == \
        (1, 1, 1, 0)
    assert srv.drain() == 1 and kept.done() and not gone.done()
    with pytest.raises(TimeoutError):
        gone.wait(timeout=0)
    after = srv.stats("t")["slo"]
    assert after["wait_timeouts"] == 1 and after["abandoned"] == 1
    assert after["resolved"] == 1 and kept.wait(timeout=0) is kept.result


def test_ticket_reresolution_is_noop():
    tk = QueryTicket("t", "bfs", 0)
    first = {"levels": np.arange(3)}
    assert tk.resolve(first) is first
    assert tk.resolve({"levels": np.zeros(3)}, cached=True) is first
    assert tk.result is first and tk.cached is False


def test_traced_window_equals_untraced_and_stitches_ids(graph):
    """Every serve/* span of a traced window carries its window_id; the
    payloads equal the same window untraced, bit for bit."""
    queries = [("bfs", 1), ("sssp", 2), ("ppr", 3), ("bfs", 4), ("cc", None)]
    results = []
    for traced in (False, True):
        srv = AsyncGraphServer(clock=FakeClock(), max_wait=10.0, cache_capacity=0)
        srv.add_tenant("t", graph, batch_size=4, **CPU)
        if traced:
            with trace.tracing() as tr:
                tks = [srv.submit("t", a, s) for a, s in queries]
                srv.drain()
        else:
            tks = [srv.submit("t", a, s) for a, s in queries]
            srv.drain()
        results.append([t.result for t in tks])
    for a, b in zip(*results):
        assert_payload_equal(b, a)
    serve = tr.filter("serve/")
    names = {s.name for s in serve}
    assert {"serve/submit", "serve/window", "serve/enqueue_wait", "serve/flush",
            "serve/bucket_compute", "serve/payload"} <= names
    wid = tks[0].window_id
    assert all(s.attrs.get("window_id") == wid for s in serve)
    for s in tr.filter("serve/bucket_compute"):
        assert s.duration >= 0.0 and s.attrs["tenant"] == "t"


# ---------------------------------------------------------------------------
# threads
# ---------------------------------------------------------------------------

@pytest.mark.timeout(120)
def test_threaded_stress_no_lost_or_torn_state():
    graphs = {"a": generate("face", scale=0.1, seed=1), "b": generate("face", scale=0.1, seed=7)}
    errors: list = []
    tickets: dict = {}
    stop = threading.Event()
    srv = AsyncGraphServer(max_pending=256, max_wait=0.005)
    for name, g in graphs.items():
        srv.add_tenant(name, g, batch_size=4, **CPU)
    srv.start()
    assert srv.start() is srv                        # idempotent

    def submitter(tid):
        tenant = ("a", "b")[tid % 2]
        rng = np.random.default_rng(1000 + tid)
        got = []
        for _ in range(30):
            alg = ("bfs", "sssp")[int(rng.integers(0, 2))]
            try:
                got.append(srv.submit(tenant, alg, int(rng.integers(0, graphs[tenant].n)),
                                      deadline=float(rng.uniform(0.001, 0.02)),
                                      priority=int(rng.integers(0, 3))))
            except BackpressureError:
                time.sleep(0.001)
        tickets[tid] = got

    def mutator():
        rng = np.random.default_rng(77)
        n = graphs["a"].n
        for _ in range(3):
            time.sleep(0.02)
            ir = rng.integers(0, n, 2)
            ic = (ir + 1 + rng.integers(0, n - 1, 2)) % n
            try:
                srv.mutate("a", EdgeDelta(insert_rows=ir, insert_cols=ic))
            except Exception as e:                   # pragma: no cover
                errors.append(e)

    def sampler():
        while not stop.is_set():
            try:
                cs = srv.cache.stats()
                if cs["hits"] + cs["misses"] != cs["lookups"]:
                    errors.append(AssertionError(f"torn cache snapshot: {cs}"))
                for t in graphs:
                    slo = srv.stats(t)["slo"]
                    if slo["admitted"] != slo["dispatched"] + slo["pending"] + slo["abandoned"]:
                        errors.append(AssertionError(f"admission leak: {slo}"))
                    if slo["goodput"] + slo["deadline_misses"] + slo["no_deadline"] \
                            != slo["resolved"]:
                        errors.append(AssertionError(f"resolve leak: {slo}"))
                    if slo["resolved"] > slo["dispatched"]:
                        errors.append(AssertionError(f"resolved ahead: {slo}"))
            except Exception as e:                   # pragma: no cover
                errors.append(e)
            time.sleep(0.001)

    threads = ([threading.Thread(target=submitter, args=(i,)) for i in range(4)]
               + [threading.Thread(target=mutator), threading.Thread(target=sampler)])
    try:
        for t in threads:
            t.start()
        for t in threads[:5]:
            t.join(timeout=60)
            assert not t.is_alive(), "a submitter or the mutator hung"
        for tks in tickets.values():
            for tk in tks:
                payload = tk.wait(timeout=30)
                assert payload is tk.result and ("levels" in payload or "dist" in payload)
    finally:
        stop.set()
        threads[-1].join(timeout=10)
        srv.close()
    assert srv._thread is None and not threads[-1].is_alive()
    assert not errors, errors[:3]
    sched = srv.scheduler.stats()
    assert sched["pending"] == 0 and sched["admitted"] == sched["dispatched"]
    assert sched["admitted"] == sum(len(v) for v in tickets.values())
    assert sched["depth_high_water"] <= sched["max_pending"]
    for t in graphs:
        slo = srv.stats(t)["slo"]
        assert slo["resolved"] == slo["dispatched"] == slo["admitted"]
        assert slo["slack_s"]["count"] == slo["goodput"] + slo["deadline_misses"]


@pytest.mark.timeout(60)
def test_close_resolves_every_admitted_ticket(graph):
    """Tickets admitted while the loop runs with a long window are resolved
    by close(); the threaded answers equal the fake-clock server's."""
    queries = [("bfs", s) for s in range(6)] + [("sssp", 3), ("ppr", 4), ("cc", None)]
    with AsyncGraphServer(max_wait=30.0) as srv:
        srv.add_tenant("t", graph, batch_size=64, **CPU)
        tks = [srv.submit("t", a, s) for a, s in queries]
        time.sleep(0.05)
        assert not any(t.done() for t in tks)      # the window is still open
    assert all(t.done() for t in tks)
    fake = AsyncGraphServer(clock=FakeClock())
    fake.add_tenant("t", graph, batch_size=64, **CPU)
    want = [fake.submit("t", a, s) for a, s in queries]
    fake.drain()
    for a, b in zip(tks, want):
        assert_payload_equal(a.wait(timeout=1.0), b.result)
