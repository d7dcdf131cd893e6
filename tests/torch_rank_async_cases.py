"""The rank bodies of ``tests/test_torch_rank_async.py``, importable by the
ranks' processes (no ``jax``, no ``repro``): ``AsyncGraphServer`` with a
tenant on a ``core.rank_mesh.RankMesh`` and a local one, every rank on a
``FakeClock`` of its own that advances by a different amount, rank 0
deciding every flush. ``workload`` also drives the mesh-less servers of
the test (the port's and the JAX package's), so every server sees the
same calls in the same order.
"""
import numpy as np
import torch

#: the tenants: one on the rank mesh (``mesh`` given), one local
TENANTS = ("ranks", "local")
#: rank r's clock advances 1 / (1 + SKEW·r) as far as rank 0's: on a
#: follower fewer windows are due than rank 0 flushes
SKEW = 3.0


def graph():
    from repro_torch.graphs import datasets
    return datasets.generate("face", scale=0.15, seed=1)


def random_queries(rng, n, k):
    """``test_torch_async_server.random_queries``: bfs/sssp/ppr and the
    globals cc and pagerank."""
    algs = ("bfs", "sssp", "ppr", "cc", "pagerank")
    out = []
    for _ in range(k):
        a = algs[int(rng.integers(0, len(algs)))]
        out.append((a, None if a in ("cc", "pagerank") else int(rng.integers(0, n))))
    return out


def random_delta(rng, g, delta_cls, k=3):
    ir = rng.integers(0, g.n, k)
    ic = (ir + 1 + rng.integers(0, g.n - 1, k)) % g.n
    idx = rng.integers(0, len(g.rows), 2)
    return delta_cls(insert_rows=ir, insert_cols=ic, delete_rows=np.asarray(g.rows)[idx],
                     delete_cols=np.asarray(g.cols)[idx])


def workload(srv, clock, delta_cls, skew: float = 1.0, seed: int = 1, on_poll=None) -> dict:
    """Two epochs of seeded queries to every tenant around one ``mutate``
    of tenant "ranks", the clock advanced by ``skew`` times the seeded
    steps and the server polled at random points, each epoch drained, then
    ``close()``. ``on_poll(dispatched)`` runs after each poll. Returns the
    tickets by tenant and the mutate report."""
    rng = np.random.default_rng(100 + seed)
    tickets = {t: [] for t in TENANTS}

    def epoch(queries):
        for a, s in queries:
            dl = float(rng.uniform(0.005, 0.1)) if rng.random() < 0.3 else None
            pr = int(rng.integers(0, 3))
            for t in TENANTS:
                tickets[t].append(srv.submit(t, a, s, deadline=dl, priority=pr))
            if rng.random() < 0.25:
                clock.advance(float(rng.uniform(0.0, 0.08)) * skew)
                n = srv.poll()
                if on_poll is not None:
                    on_poll(n)
        srv.drain()

    epoch(random_queries(rng, srv.tenant("ranks").graph.n, 10))
    report = srv.mutate("ranks", random_delta(rng, srv.tenant("ranks").graph, delta_cls))
    epoch(random_queries(rng, srv.tenant("ranks").graph.n, 8))
    srv.close()
    return {"tickets": tickets, "report": report}


def snapshot_ok(st: dict) -> bool:
    """``stats()``'s conservation laws."""
    s = st["slo"]
    return (s["admitted"] == s["dispatched"] + s["pending"] + s["abandoned"]
            and s["goodput"] + s["deadline_misses"] + s["no_deadline"] == s["resolved"]
            and s["resolved"] <= s["dispatched"])


def _local_due(srv, clock) -> int:
    """The tickets this rank's own clock would flush now."""
    sched = srv.scheduler
    return sum(len(tq.tickets) for tq in sched._tenants.values()
               if (d := sched._due_at(tq)) is not None and d <= clock.now())


def run_async(rank: int, world: int, init: str) -> dict:
    """A rank of 4 (see the module): the payloads, each poll's count and
    what the rank's own clock held due, the snapshots, the shares, the
    backpressure refusals, a wait's timeout on one rank, ``start()``'s
    refusal and a tenant on another process group."""
    import torch.distributed as tdist

    from repro_torch.core.delta import EdgeDelta
    from repro_torch.core.rank_mesh import RankMesh, init_rank_mesh
    from repro_torch.serve.graph_engine import AsyncGraphServer
    from repro_torch.serve.scheduler import BackpressureError, FakeClock
    torch.set_num_threads(1)
    m = init_rank_mesh((world,), ("batch",), "gloo", device="cpu", init_method=init, rank=rank,
                       world_size=world)
    g = graph()
    clock = FakeClock()
    srv = AsyncGraphServer(clock=clock, max_pending=1024, max_wait=0.05)
    srv.add_tenant("ranks", g, batch_size=4, pipeline_depth=2, device="cpu", mesh=m)
    srv.add_tenant("local", g, batch_size=4, pipeline_depth=2, device="cpu")
    polls, snaps = [], []

    def on_poll(n):
        polls.append(n)
        snaps.append({t: srv.stats(t) for t in TENANTS})

    # what this rank's own clock holds due just before each poll
    due = []
    poll = srv.poll
    srv.poll = lambda: due.append(_local_due(srv, clock)) or poll()
    shares = m.calls["share"]
    out = workload(srv, clock, EdgeDelta, skew=1.0 / (1.0 + SKEW * rank), on_poll=on_poll)
    out["share_calls"] = m.calls["share"] - shares
    out["share_bytes"] = m.wire_bytes["share"]
    out["polls"], out["due"], out["snapshots"] = polls, due, snaps
    out["final"] = {t: srv.stats(t) for t in TENANTS}
    out["tickets"] = {t: [(tk.algorithm, tk.source, tk.seq, tk.done(), tk.result)
                          for tk in tks] for t, tks in out["tickets"].items()}
    try:
        srv.start()
        out["start"] = None
    except ValueError as e:
        out["start"] = str(e)

    # backpressure: at max_pending every rank refuses the same submit
    bp = AsyncGraphServer(clock=FakeClock(), max_pending=5, max_wait=0.05)
    bp.add_tenant("ranks", g, batch_size=8, device="cpu", mesh=m)
    refused = []
    for i in range(16):
        try:
            bp.submit("ranks", "bfs", i)
            refused.append(False)
        except BackpressureError:
            refused.append(True)
        if i % 4 == 3:
            bp.clock.advance(0.02 / (1.0 + SKEW * rank))
            bp.poll()
    bp.close()
    out["refused"] = refused
    out["bp_stats"] = bp.stats("ranks")["slo"]

    # a wait that times out on one rank (rank 0 for one ticket, rank 1 for
    # the other) abandons nothing: both stay queued on every rank and the
    # shared close serves them everywhere
    wt = AsyncGraphServer(clock=FakeClock(), max_pending=16, max_wait=0.05)
    wt.add_tenant("ranks", g, batch_size=8, device="cpu", mesh=m)
    held = [wt.submit("ranks", "bfs", 3), wt.submit("ranks", "sssp", 5)]
    out["wait_errors"] = {}
    for waiter, tk in enumerate(held):
        if rank == waiter:
            try:
                tk.wait(timeout=0)
            except TimeoutError as e:
                out["wait_errors"][waiter] = str(e)
    out["wait_pending"] = wt.scheduler.pending()
    wt.close()
    out["wait_tickets"] = [(tk.done(), tk.result) for tk in held]
    out["wait_slo"] = wt.stats("ranks")["slo"]

    # a tenant on the ranks of another process group
    tdist.destroy_process_group()
    m2 = init_rank_mesh((world,), ("batch",), "gloo", device="cpu", init_method=init + "_2",
                        rank=rank, world_size=world)
    try:
        srv.add_tenant("other", g, device="cpu", mesh=m2)
        out["other_world"] = None
    except ValueError as e:
        out["other_world"] = str(e)
    out["other_is_rank_mesh"] = isinstance(m2, RankMesh)
    return out
