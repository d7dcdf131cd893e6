"""The port's ``serve.scheduler`` against the JAX package's: the same
seeded action sequences (submit, advance, poll, drain, abandon) through
both ``WindowScheduler``s on a ``FakeClock`` give the same dispatch order,
window ids, stamps, stats and SLO snapshots. Then the port's counterparts
of ``tests/test_scheduler_props.py``'s invariants, under hypothesis."""
import numpy as np
import pytest

from repro.serve import scheduler as jsched
from repro_torch.serve import scheduler as tsched

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.serve.scheduler import (  # noqa: E402
    BackpressureError, FakeClock, QueryTicket, SLOAccount, WindowScheduler, _edf_key,
)

TENANTS = [("t0", 4, 0.05), ("t1", 3, 0.02)]  # (name, batch_size, max_wait)
MAX_PENDING = 8


# ---------------------------------------------------------------------------
# differential: the same actions through both schedulers
# ---------------------------------------------------------------------------

def replay(mod, actions, max_pending: int):
    """Run ``actions`` through ``mod``'s scheduler; the executor resolves
    every ticket at the clock's instant and records it in a per-tenant
    SLO account. Returns everything observable."""
    clock = mod.FakeClock()
    batches, slo = [], {name: mod.SLOAccount() for name, _, _ in TENANTS}

    def executor(name, tickets):
        batches.append((name, [(t.request_id, t.window_id, t.dispatched_at) for t in tickets]))
        for t in tickets:
            t.resolve({"seq": t.seq}, at=clock.now())
            slo[name].record(t)

    sched = mod.WindowScheduler(executor, clock=clock, max_pending=max_pending)
    for name, bs, mw in TENANTS:
        sched.register(name, batch_size=bs, max_wait=mw)
    log, tickets = [], []
    for act in actions:
        kind = act[0]
        if kind == "submit":
            _, ti, pr, ddl = act
            tk = mod.QueryTicket(TENANTS[ti][0], "bfs", len(tickets), priority=pr,
                                 deadline=None if ddl is None else clock.now() + ddl)
            try:
                sched.submit(tk)
                tickets.append(tk)
                log.append(("admit", tk.request_id, tk.window_id, tk.admitted_at))
            except mod.BackpressureError as e:
                log.append(("reject", e.tenant, e.depth, e.max_pending))
        elif kind == "advance":
            clock.advance(act[1])
            log.append(("advance", clock.now()))
        elif kind == "poll":
            log.append(("poll", sched.poll(), sched.next_wakeup()))
        elif kind == "drain":
            log.append(("drain", sched.drain(act[1])))
        else:                                         # abandon a queued ticket
            live = [t for t in tickets if not t.done() and not t.abandoned]
            if live:
                tk = live[act[1] % len(live)]
                try:
                    tk.wait(timeout=0)
                except TimeoutError:
                    pass
                log.append(("abandon", tk.request_id, tk.abandoned))
        log.append(("pending", sched.pending(), sched.pending("t0"), sched.pending("t1")))
    timelines = [t.timeline() for t in tickets]
    return (log, batches, sched.stats(), {n: a.snapshot() for n, a in slo.items()},
            timelines, [t.slack() for t in tickets])


def random_actions(seed: int, k: int = 120) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        u = rng.random()
        if u < 0.5:
            ddl = None if rng.random() < 0.4 else float(rng.uniform(0.001, 0.2))
            out.append(("submit", int(rng.integers(0, 2)), int(rng.integers(0, 4)), ddl))
        elif u < 0.7:
            out.append(("advance", float(rng.uniform(0.0, 0.06))))
        elif u < 0.85:
            out.append(("poll",))
        elif u < 0.92:
            out.append(("drain", [None, "t0", "t1"][int(rng.integers(0, 3))]))
        else:
            out.append(("abandon", int(rng.integers(0, 100))))
    return out


@pytest.mark.parametrize("max_pending", [5, 64])
@pytest.mark.parametrize("seed", range(10))
def test_same_actions_same_schedule(seed, max_pending):
    actions = random_actions(seed)
    got = replay(tsched, actions, max_pending)
    want = replay(jsched, actions, max_pending)
    for g, w, what in zip(got, want, ("log", "batches", "stats", "slo", "timelines", "slack")):
        assert g == w, what


def test_edf_key_and_ticket_behave_as_jax():
    specs = [(None, 0), (0.5, 0), (0.1, 0), (None, 2), (0.1, 1)]
    for mod in (tsched, jsched):
        batches = []
        sched = mod.WindowScheduler(lambda n, t: batches.append(t), clock=mod.FakeClock(),
                                    max_pending=64)
        sched.register("t", batch_size=16, max_wait=1.0)
        for dl, pr in specs:
            sched.submit(mod.QueryTicket("t", "bfs", 0, priority=pr, deadline=dl))
        sched.drain()
        (tks,) = batches
        assert [(t.deadline, t.priority) for t in tks] == \
            [(0.1, 1), (0.1, 0), (0.5, 0), (None, 2), (None, 0)]
        assert [mod._edf_key(t) for t in tks] == sorted(mod._edf_key(t) for t in tks)
    tk = tsched.QueryTicket("t", "bfs", 0)
    first = {"x": 1}
    assert tk.resolve(first) is first and tk.resolve({"x": 2}, cached=True) is first
    assert tk.wait(timeout=0) is first and tk.cached is False
    with pytest.raises(TimeoutError):
        tsched.QueryTicket("t").wait(timeout=0.01)


def test_register_and_submit_errors():
    sched = WindowScheduler(lambda n, t: None, clock=FakeClock())
    with pytest.raises(ValueError):
        WindowScheduler(lambda n, t: None, max_pending=0)
    with pytest.raises(ValueError):
        sched.register("t", batch_size=0)
    sched.register("t")
    with pytest.raises(ValueError):
        sched.register("t")
    with pytest.raises(ValueError):
        sched.submit(QueryTicket("ghost"))
    assert tsched.SystemClock().now() <= tsched.SystemClock().now()


# ---------------------------------------------------------------------------
# the invariants of tests/test_scheduler_props.py, on the port
# ---------------------------------------------------------------------------

submit_action = st.tuples(
    st.just("submit"),
    st.integers(min_value=0, max_value=len(TENANTS) - 1),
    st.integers(min_value=0, max_value=5),
    st.one_of(st.none(), st.floats(min_value=0.001, max_value=0.2,
                                   allow_nan=False, allow_infinity=False)))
advance_action = st.tuples(
    st.just("advance"),
    st.floats(min_value=0.0, max_value=0.1, allow_nan=False, allow_infinity=False))
actions_strategy = st.lists(st.one_of(submit_action, advance_action), min_size=1, max_size=60)


@settings(max_examples=60, deadline=None)
@given(actions=actions_strategy)
def test_scheduler_invariants(actions):
    clock = FakeClock()
    batches = []
    sched = WindowScheduler(lambda name, tks: batches.append((name, tks)),
                            clock=clock, max_pending=MAX_PENDING)
    for name, bs, mw in TENANTS:
        sched.register(name, batch_size=bs, max_wait=mw)

    admitted, attempts, rejections = [], 0, 0
    for act in actions:
        if act[0] == "submit":
            _, ti, pr, ddl = act
            tk = QueryTicket(TENANTS[ti][0], "q", 0, priority=pr,
                             deadline=None if ddl is None else clock.now() + ddl)
            attempts += 1
            try:
                sched.submit(tk)
                admitted.append(tk)
            except BackpressureError as e:
                rejections += 1
                assert e.depth == MAX_PENDING == e.max_pending
                assert not tk.done()
            assert sched.pending() <= MAX_PENDING
        else:
            clock.advance(act[1])
            sched.poll()
            nw = sched.next_wakeup()
            assert nw is None or nw > clock.now()

    sched.drain()
    stats = sched.stats()
    assert stats["rejected"] == rejections
    assert stats["admitted"] == len(admitted) == attempts - rejections
    assert stats["depth_high_water"] <= MAX_PENDING
    assert stats["pending"] == 0 and not any(stats["windows"].values())
    assert stats["dispatched"] == len(admitted)
    seen = [tk for _, tks in batches for tk in tks]
    assert {id(t) for t in seen} == {id(t) for t in admitted} and len(seen) == len(admitted)
    for name, tks in batches:
        assert all(t.tenant == name for t in tks)
        keys = [_edf_key(t) for t in tks]
        assert keys == sorted(keys)
        assert all(t.dispatched_at >= t.admitted_at for t in tks)


@settings(max_examples=30, deadline=None)
@given(fills=st.integers(min_value=1, max_value=12))
def test_bucket_fill_is_due_immediately(fills):
    batches = []
    sched = WindowScheduler(lambda name, tks: batches.append(tks), clock=FakeClock(),
                            max_pending=64)
    sched.register("t", batch_size=4, max_wait=10.0)
    for _ in range(fills):
        sched.submit(QueryTicket("t", "q", 0))
    sched.poll()
    flushed = sum(len(b) for b in batches)
    assert flushed == (fills if fills >= 4 else 0)
    assert sched.pending() == fills - flushed


@settings(max_examples=30, deadline=None)
@given(dt=st.floats(max_value=-1e-9, min_value=-1e6, allow_nan=False, allow_infinity=False))
def test_fake_clock_rejects_time_travel(dt):
    with pytest.raises(ValueError):
        FakeClock().advance(dt)


@settings(max_examples=60, deadline=None)
@given(latencies=st.lists(st.floats(min_value=0.0, max_value=1.0, allow_nan=False,
                                    allow_infinity=False), min_size=1, max_size=40),
       b1=st.floats(min_value=0.0, max_value=1.0, allow_nan=False, allow_infinity=False),
       b2=st.floats(min_value=0.0, max_value=1.0, allow_nan=False, allow_infinity=False))
def test_slo_miss_count_monotone_in_deadline_tightness(latencies, b1, b2):
    def misses(budget):
        acct = SLOAccount()
        for j, lat in enumerate(latencies):
            tk = QueryTicket("t", "q", 0, deadline=None if j % 5 == 4 else budget)
            tk.resolve({"j": j}, at=lat)
            acct.record(tk)
            snap = acct.snapshot()
            assert snap["goodput"] + snap["deadline_misses"] + snap["no_deadline"] \
                == snap["resolved"] == j + 1
        snap = acct.snapshot()
        deadlined = sum(1 for j in range(len(latencies)) if j % 5 != 4)
        assert snap["slack_s"]["count"] == deadlined == snap["goodput"] + snap["deadline_misses"]
        assert snap["lateness_s"]["count"] == snap["deadline_misses"]
        if snap["deadline_misses"]:
            assert snap["lateness_s"]["min"] > 0
        return snap["deadline_misses"]

    tight, loose = sorted((b1, b2))
    assert misses(tight) >= misses(loose)


@settings(max_examples=40, deadline=None)
@given(actions=st.lists(st.one_of(submit_action, advance_action,
                                  st.tuples(st.just("poll")),
                                  st.tuples(st.just("abandon"), st.integers(0, 50))),
                        min_size=1, max_size=50))
def test_port_and_jax_agree_under_hypothesis(actions):
    """Hypothesis-drawn interleavings, abandonment included, give the same
    schedule and accounting in both packages."""
    assert replay(tsched, actions, MAX_PENDING) == replay(jsched, actions, MAX_PENDING)
