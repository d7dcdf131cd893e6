"""Event-loop scheduling for the async serving layer: a copy of the JAX
package's ``repro.serve.scheduler``, which imports no JAX (the port keeps
its own; only the metrics import points at ``repro_torch.obs``).

The synchronous :class:`~repro_torch.serve.graph_engine.GraphQueryServer` is a
submit/flush batch: callers block until someone explicitly drains the
queue.  This module adds *when* those drains happen — the host-side
event loop the paper's end-to-end story (one host orchestrating many PIM
queries at once) assumes:

* **Windowed batch formation** — a tenant's first queued query opens a
  *window*; the window flushes when the bucket fills (``batch_size``
  queries pending) **or** its latency budget expires (``max_wait``
  seconds after opening, pulled earlier by any query's deadline),
  whichever comes first.  Adaptive batching: floods flush at full
  occupancy, trickles flush on time.

* **Admission control + backpressure** — at most ``max_pending`` queries
  may be queued (across all tenants).  A submit beyond the bound raises
  the typed :class:`BackpressureError` — callers *always* learn about
  shedding; nothing is silently dropped.

* **EDF within a window** — when a window flushes, its queries are
  dispatched in earliest-deadline-first order (ties: higher ``priority``
  first, then FIFO).  Deadlines order service and pull the window's
  expiry earlier; they never drop work.

* **Determinism** — all timing flows through an injectable clock.
  :class:`SystemClock` serves production; :class:`FakeClock` gives tests
  a manually-advanced timeline, so every scheduling decision is
  reproducible single-threaded: ``submit → clock.advance → poll``.

:class:`WindowScheduler` is the pure state machine (it knows nothing
about graphs or engines — execution is delegated to an injected
``executor(tenant, tickets)`` callable), which is what the
property-based suite drives directly (tests/test_torch_scheduler.py).
:class:`~repro_torch.serve.graph_engine.AsyncGraphServer` composes it with one
:class:`~repro_torch.serve.graph_engine.GraphQueryServer` per tenant.

Invariants the tests pin (tests/test_torch_scheduler.py):

* dispatch order inside a window is deadline-sorted (EDF);
* no admitted query waits past ``max_wait`` once the clock reaches its
  window's expiry and the scheduler is polled;
* queued depth never exceeds ``max_pending``; over-bound submissions
  raise :class:`BackpressureError` and are counted, never lost;
* every admitted ticket is dispatched exactly once — or abandoned by a
  timed-out waiter — never both (conservation:
  ``admitted == dispatched + pending + abandoned`` per tenant, in every
  ``stats()`` snapshot).

Shared decisions (``decide``): ranks of one SPMD program each run a
scheduler, each with its own clock, and are given the same ``submit``
calls in the same order, so ticket ``seq`` numbers agree across ranks.
With ``decide`` set, every ``poll()`` and ``drain()`` hands it a
function that encodes this scheduler's own choice, the windows it would
take in EDF order as ``[[tenant, [seq, ...]], ...]``; ``decide`` returns
the root's encoding on every rank (the root alone calls the function;
``AsyncGraphServer`` shares it with ``RankMesh.share``), and every rank
pops exactly those tickets, by ``seq`` and in that order, whatever its own
clock says. So every rank flushes the same windows in the same order and
keeps the same pending count. A decision is shared on every call, an
empty one included: a rank that skipped it would hang the others. A
ticket leaves its window only by such a decision: ``QueryTicket.wait``
that times out raises and leaves the ticket queued, abandoning nothing,
since one rank's abandonment would leave the ranks holding different
tickets.

SLO accounting (tests/test_torch_async_server.py): every ticket carries a
``request_id`` and the window it was batched into (``window_id``), plus
its full timeline — admitted → dispatched → resolved — on the
scheduler's clock.  :class:`SLOAccount` classifies resolved tickets
against their deadline (``slack = deadline - resolved_at``; >= 0 is
goodput, < 0 a deadline miss) into per-tenant counters and signed slack
histograms; :class:`~repro_torch.serve.graph_engine.AsyncGraphServer` owns one
account per tenant and surfaces it as ``stats(tenant)["slo"]``.
"""
from __future__ import annotations

import itertools
import json
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import Histogram


class SystemClock:
    """Monotonic wall clock — the production timeline."""

    def now(self) -> float:
        return time.monotonic()


class FakeClock:
    """A manually-advanced timeline for deterministic scheduler tests.

    Nothing happens when time advances — the test advances the clock and
    then *drives* the scheduler (``poll()``), so every flush decision is
    attributable to one explicit step.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"time only moves forward, got dt={dt}")
        self._t += dt
        return self._t


class BackpressureError(RuntimeError):
    """Typed admission rejection: the scheduler's queue is saturated.

    Carries enough to make shedding observable and actionable: the
    tenant that was refused, the queue depth at refusal, and the bound.
    Callers should back off and retry (closed-loop) or surface the
    rejection (open-loop) — the query was **never** enqueued.
    """

    def __init__(self, tenant: str, depth: int, max_pending: int):
        super().__init__(
            f"queue saturated: {depth}/{max_pending} pending; "
            f"rejected submit for tenant {tenant!r}")
        self.tenant = tenant
        self.depth = depth
        self.max_pending = max_pending


class QueryTicket:
    """One admitted (or to-be-admitted) query's handle.

    The scheduler stamps the admission half of the timeline —
    ``admitted_at``/``seq``/``request_id`` plus the ``window_id`` of the
    window the ticket was batched into — and ``dispatched_at`` when that
    window flushes; the executor resolves it with the result payload,
    stamping ``resolved_at``.  ``resolve()`` on an already-resolved
    ticket is a no-op that returns the cached payload — a ticket can
    never be clobbered by a duplicate drain.

    A waiter that gives up (``wait()`` timeout) reports back to the
    scheduler: a still-queued ticket is pulled from its window and
    counted ``abandoned`` (so conservation stays checkable), a ticket
    already in dispatch only counts the timeout and will still resolve.
    """

    __slots__ = ("tenant", "algorithm", "source", "priority", "deadline",
                 "admitted_at", "dispatched_at", "resolved_at", "seq",
                 "request_id", "window_id", "submitted_pc", "abandoned",
                 "result", "cached", "_event", "_sched", "_timed_out")

    def __init__(self, tenant: str, algorithm: str = "", source: int = -1,
                 priority: int = 0, deadline: Optional[float] = None):
        self.tenant = tenant
        self.algorithm = algorithm
        self.source = source
        self.priority = priority
        self.deadline = deadline
        self.admitted_at = 0.0
        self.dispatched_at = 0.0
        self.resolved_at = 0.0
        self.seq = -1
        self.request_id = ""
        self.window_id = -1
        # perf_counter stamp set by the tracing submit path — the t0 of
        # the retrospective serve/window span (0.0 = tracing disabled).
        self.submitted_pc = 0.0
        self.abandoned = False
        self.result: Optional[Dict[str, Any]] = None
        self.cached = False
        self._event = threading.Event()
        self._sched: Optional["WindowScheduler"] = None
        self._timed_out = False

    def done(self) -> bool:
        return self._event.is_set()

    def resolve(self, payload: Optional[Dict[str, Any]],
                cached: bool = False,
                at: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Attach the result and wake waiters. Re-resolution is a no-op
        returning the already-cached payload (never overwrites — and
        never re-stamps ``resolved_at``).  ``at`` is the resolve instant
        on the scheduler's clock (slack is measured against it)."""
        if self._event.is_set():
            return self.result
        self.result = payload
        self.cached = cached
        self.resolved_at = self.dispatched_at if at is None else at
        self._event.set()
        return payload

    def slack(self) -> Optional[float]:
        """Seconds of deadline margin at resolve time: positive = met,
        negative = missed.  None while unresolved or without a deadline."""
        if self.deadline is None or not self._event.is_set():
            return None
        return self.deadline - self.resolved_at

    def timeline(self) -> Dict[str, Any]:
        """The request lifecycle as one dict (scheduler-clock instants)."""
        return {"request_id": self.request_id, "tenant": self.tenant,
                "window_id": self.window_id,
                "admitted_at": self.admitted_at,
                "dispatched_at": self.dispatched_at,
                "resolved_at": self.resolved_at,
                "deadline": self.deadline, "abandoned": self.abandoned}

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until resolved (threaded serving) and return the payload.
        On a fake clock nothing resolves tickets in the background —
        drive the scheduler (``poll()``/``drain()``) first.

        A timeout abandons the ticket: the scheduler counts it per
        tenant (``wait_timeouts``; ``abandoned`` too when it was still
        queued, in which case it leaves the window and will never
        dispatch) before the TimeoutError is raised. With shared
        decisions (``decide``) a timeout abandons and counts nothing: the
        ticket stays queued until a shared ``poll()`` or ``drain()``."""
        if not self._event.wait(timeout):
            if self._sched is not None:
                self._sched._on_wait_timeout(self)
            raise TimeoutError(
                f"ticket ({self.tenant}/{self.algorithm}/{self.source}) "
                f"unresolved after {timeout}s — is the event loop running?")
        assert self.result is not None
        return self.result


class SLOAccount:
    """Per-tenant SLO truth over resolved requests.

    ``record(ticket)`` classifies one freshly resolved ticket by its
    signed slack (``deadline - resolved_at`` on the scheduler clock):
    slack >= 0 counts toward ``goodput``, slack < 0 is a
    ``deadline_miss``; deadline-less requests land in ``no_deadline``.
    The signed slack is observed into the ``slack_s`` histogram
    (negative values share the lowest bucket; the exact ``min`` is the
    worst slack seen) and each miss's positive lateness additionally
    into ``lateness_s``.  The caller records each request exactly once
    (``QueryTicket.resolve`` re-resolution is a no-op, so "first
    resolve" is well-defined even under duplicate drains).

    One lock guards the counters *and* both histograms, so conservation
    holds in **every** ``snapshot()``, never just at quiescence::

        goodput + deadline_misses + no_deadline == resolved
        slack_s["count"] == goodput + deadline_misses
        lateness_s["count"] == deadline_misses
    """

    __slots__ = ("_lock", "resolved", "goodput", "deadline_misses",
                 "no_deadline", "slack_s", "lateness_s")

    def __init__(self):
        self._lock = threading.Lock()
        self.resolved = 0
        self.goodput = 0
        self.deadline_misses = 0
        self.no_deadline = 0
        self.slack_s = Histogram("slack_s")
        self.lateness_s = Histogram("lateness_s")

    def record(self, ticket: QueryTicket) -> Optional[float]:
        """Classify one resolved ticket; returns its signed slack."""
        slack = ticket.slack()
        with self._lock:
            self.resolved += 1
            if slack is None:
                self.no_deadline += 1
            else:
                if slack >= 0:
                    self.goodput += 1
                else:
                    self.deadline_misses += 1
                    self.lateness_s.observe(-slack)
                self.slack_s.observe(slack)
        return slack

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict copy (counters + histogram summaries)."""
        with self._lock:
            return {"resolved": self.resolved, "goodput": self.goodput,
                    "deadline_misses": self.deadline_misses,
                    "no_deadline": self.no_deadline,
                    "slack_s": self.slack_s.summary(),
                    "lateness_s": self.lateness_s.summary()}


def _edf_key(tk: QueryTicket) -> Tuple[float, int, int]:
    """Earliest deadline first; ties broken by priority (higher first),
    then admission order (FIFO)."""
    return (tk.deadline if tk.deadline is not None else math.inf,
            -tk.priority, tk.seq)


class _TenantQueue:
    """One tenant's open window — the queued tickets, when the window
    opened (first pending ticket's admission time), its id — plus the
    tenant's lifetime accounting.  Per-tenant conservation, guaranteed
    in every locked snapshot::

        admitted == dispatched + len(tickets) + abandoned
    """

    __slots__ = ("name", "batch_size", "max_wait", "tickets", "opened_at",
                 "window_id", "admitted", "dispatched", "abandoned",
                 "wait_timeouts")

    def __init__(self, name: str, batch_size: int, max_wait: float):
        self.name = name
        self.batch_size = batch_size
        self.max_wait = max_wait
        self.tickets: List[QueryTicket] = []
        self.opened_at = 0.0
        self.window_id = -1
        self.admitted = 0
        self.dispatched = 0
        self.abandoned = 0
        self.wait_timeouts = 0


class WindowScheduler:
    """Time-/size-window batch scheduler with admission control.

    Pure state machine: ``submit()`` admits tickets into per-tenant
    windows, ``poll()`` flushes every *due* window (bucket full, latency
    budget expired, or a deadline reached) through the injected
    ``executor(tenant_name, tickets_in_EDF_order)``.  ``drain()`` flushes
    regardless of due-ness (shutdown, pre-mutation barriers).

    Thread-safe: state mutates under one condition variable; the executor
    runs **outside** the lock so submissions never block on engine work.
    ``run_loop()`` is the threaded driver (sleep until the next window
    expiry, flush, repeat); single-threaded callers on a
    :class:`FakeClock` call ``poll()`` themselves.
    """

    def __init__(self, executor: Callable[[str, List[QueryTicket]], None],
                 clock=None, max_pending: int = 256,
                 default_max_wait: float = 0.05):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.executor = executor
        self.clock = clock if clock is not None else SystemClock()
        self.max_pending = max_pending
        self.default_max_wait = default_max_wait
        self._cond = threading.Condition()
        self._tenants: Dict[str, _TenantQueue] = {}
        self._seq = itertools.count()
        self._window_seq = itertools.count()
        self._pending = 0
        self.admitted = 0
        self.rejected = 0
        self.dispatched = 0
        self.abandoned = 0
        self.depth_high_water = 0
        #: None, or ``decide(view) -> bytes``: the root's ``view()`` on
        #: every rank (see the module docstring)
        self.decide: Optional[Callable[[Callable[[], bytes]], bytes]] = None

    # ------------------------------------------------------------- setup
    def register(self, name: str, batch_size: int = 8,
                 max_wait: Optional[float] = None) -> None:
        """Declare a tenant: its bucket size (fill threshold) and latency
        budget (window expiry, defaulting to the scheduler-wide one)."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        with self._cond:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[name] = _TenantQueue(
                name, batch_size,
                self.default_max_wait if max_wait is None else max_wait)

    # --------------------------------------------------------- admission
    def submit(self, ticket: QueryTicket) -> QueryTicket:
        """Admit one ticket into its tenant's window, or raise the typed
        :class:`BackpressureError` when the queue bound is hit."""
        with self._cond:
            tq = self._tenants.get(ticket.tenant)
            if tq is None:
                raise ValueError(f"unknown tenant {ticket.tenant!r}; "
                                 f"registered: {sorted(self._tenants)}")
            if self._pending >= self.max_pending:
                self.rejected += 1
                raise BackpressureError(ticket.tenant, self._pending,
                                        self.max_pending)
            now = self.clock.now()
            ticket.admitted_at = now
            ticket.seq = next(self._seq)
            ticket.request_id = f"r{ticket.seq}"
            ticket._sched = self
            if not tq.tickets:
                tq.opened_at = now
                tq.window_id = next(self._window_seq)
            ticket.window_id = tq.window_id
            tq.tickets.append(ticket)
            self._pending += 1
            self.admitted += 1
            tq.admitted += 1
            self.depth_high_water = max(self.depth_high_water, self._pending)
            self._cond.notify_all()
        return ticket

    # ------------------------------------------------------- due windows
    def _due_at(self, tq: _TenantQueue) -> Optional[float]:
        """The instant this tenant's window must flush: immediately when
        the bucket is full, else the earlier of window expiry and the
        earliest per-query deadline. None when nothing is pending."""
        if not tq.tickets:
            return None
        if len(tq.tickets) >= tq.batch_size:
            return tq.opened_at          # already due (bucket filled)
        due = tq.opened_at + tq.max_wait
        for tk in tq.tickets:
            if tk.deadline is not None and tk.deadline < due:
                due = tk.deadline
        return due

    def next_wakeup(self) -> Optional[float]:
        """Earliest instant any window becomes due (None = queue empty)."""
        with self._cond:
            dues = [d for d in map(self._due_at, self._tenants.values())
                    if d is not None]
        return min(dues) if dues else None

    def _take(self, tq: _TenantQueue, now: float) -> List[QueryTicket]:
        """Pop a window's tickets in EDF dispatch order (lock held).
        The per-tenant ``dispatched`` counter moves here — inside the
        lock, atomically with the pending decrement — so per-tenant
        conservation holds in every snapshot, not just after the
        executor returns (the global ``dispatched`` keeps its
        post-executor semantics)."""
        return self._take_seqs(tq, [tk.seq for tk in sorted(tq.tickets, key=_edf_key)], now)

    def _run(self, batches: List[Tuple[str, List[QueryTicket]]]) -> int:
        """Execute popped windows outside the lock; returns #tickets."""
        n = 0
        for name, tickets in batches:
            self.executor(name, tickets)
            n += len(tickets)
        if n:
            with self._cond:
                self.dispatched += n
        return n

    def _take_seqs(self, tq: _TenantQueue, seqs: List[int],
                   now: float) -> List[QueryTicket]:
        """Pop exactly the tickets ``seqs`` of a window, in that order
        (lock held), and account for them as ``_take`` says. A ``seq``
        this scheduler has not queued means the ranks' calls differ: it
        raises."""
        by_seq = {tk.seq: tk for tk in tq.tickets}
        missing = [q for q in seqs if q not in by_seq]
        if missing:
            raise RuntimeError(
                f"the shared decision dispatches tickets {missing} of tenant "
                f"{tq.name!r} that this scheduler has not queued: the ranks' "
                f"submit calls differ")
        tickets = [by_seq[q] for q in seqs]
        taken = set(seqs)
        tq.tickets = [tk for tk in tq.tickets if tk.seq not in taken]
        self._pending -= len(tickets)
        tq.dispatched += len(tickets)
        for tk in tickets:
            tk.dispatched_at = now
        return tickets

    def _flush(self, due_only: bool, tenant: Optional[str] = None) -> int:
        """Flush the due windows (``due_only``) or every pending window
        (of ``tenant`` when given): this scheduler's choice, or with
        ``decide`` the root's."""
        def chosen(now: float) -> List[_TenantQueue]:
            tqs = ([self._tenants[tenant]] if tenant is not None
                   else list(self._tenants.values()))
            if due_only:
                return [tq for tq in tqs
                        if (d := self._due_at(tq)) is not None and d <= now]
            return [tq for tq in tqs if tq.tickets]

        if self.decide is None:
            with self._cond:
                now = self.clock.now()
                batches = [(tq.name, self._take(tq, now)) for tq in chosen(now)]
            return self._run(batches)

        def view() -> bytes:
            with self._cond:
                return json.dumps(
                    [[tq.name, [tk.seq for tk in sorted(tq.tickets, key=_edf_key)]]
                     for tq in chosen(self.clock.now())]).encode()

        decision = json.loads(self.decide(view))
        with self._cond:
            now = self.clock.now()
            batches = [(name, self._take_seqs(self._tenants[name], seqs, now))
                       for name, seqs in decision]
        return self._run(batches)

    def poll(self) -> int:
        """Flush every window due at ``clock.now()``; returns the number
        of tickets dispatched. The manual pump for fake-clock tests and
        the body of the threaded ``run_loop``."""
        return self._flush(due_only=True)

    def drain(self, tenant: Optional[str] = None) -> int:
        """Flush every pending window *now*, due or not — the shutdown
        and pre-mutation barrier. ``tenant`` restricts to one tenant."""
        return self._flush(due_only=False, tenant=tenant)

    # ------------------------------------------------------- abandonment
    def _on_wait_timeout(self, ticket: QueryTicket) -> bool:
        """A waiter gave up on ``ticket`` (``QueryTicket.wait`` timeout).

        The timeout is counted once per ticket (``wait_timeouts``); a
        ticket still sitting in its window is additionally pulled out
        and counted ``abandoned`` (per tenant and globally) so it never
        dispatches and ``admitted == dispatched + pending + abandoned``
        stays exact.  A ticket that already left the window (dispatched,
        or mid-dispatch on another thread) is left alone — its executor
        will still resolve it.  Returns True when the ticket was
        abandoned before dispatch.

        With ``decide`` set it raises TimeoutError and leaves the ticket
        queued: every rank holds the ticket, and only a shared decision
        may take it out of its window."""
        if self.decide is not None:
            raise TimeoutError(
                f"ticket {ticket.seq} ({ticket.tenant}/{ticket.algorithm}) stays "
                "queued: its window is a decision the ranks share, so a wait on "
                "one rank cannot abandon it; poll() or drain() on every rank")
        with self._cond:
            tq = self._tenants.get(ticket.tenant)
            if tq is None:
                return False
            if not ticket._timed_out:
                ticket._timed_out = True
                tq.wait_timeouts += 1
            if ticket in tq.tickets:
                tq.tickets.remove(ticket)
                self._pending -= 1
                tq.abandoned += 1
                self.abandoned += 1
                ticket.abandoned = True
                return True
        return False

    def pending(self, tenant: Optional[str] = None) -> int:
        with self._cond:
            if tenant is not None:
                return len(self._tenants[tenant].tickets)
            return self._pending

    def kick(self) -> None:
        """Wake a blocked ``run_loop`` (shutdown, config change)."""
        with self._cond:
            self._cond.notify_all()

    def stats(self) -> Dict[str, Any]:
        """One locked snapshot.  Global counters keep their original
        semantics (``dispatched`` moves after the executor returns); the
        per-tenant section under ``"tenants"`` is snapshot-exact —
        ``admitted == dispatched + pending + abandoned`` holds for every
        tenant in every snapshot (dispatched moves at window pop)."""
        with self._cond:
            return {"admitted": self.admitted, "rejected": self.rejected,
                    "dispatched": self.dispatched, "pending": self._pending,
                    "abandoned": self.abandoned,
                    "max_pending": self.max_pending,
                    "depth_high_water": self.depth_high_water,
                    "windows": {n: len(tq.tickets)
                                for n, tq in self._tenants.items()},
                    "tenants": {n: {"admitted": tq.admitted,
                                    "dispatched": tq.dispatched,
                                    "pending": len(tq.tickets),
                                    "abandoned": tq.abandoned,
                                    "wait_timeouts": tq.wait_timeouts,
                                    "window_id": tq.window_id}
                                for n, tq in self._tenants.items()}}

    # ---------------------------------------------------------- threaded
    def run_loop(self, stop: threading.Event) -> None:
        """The event loop: sleep until the next window expiry (woken early
        by submissions — a filling bucket becomes due immediately), flush
        due windows, repeat until ``stop`` is set. Real-clock only; fake
        clocks are driven by ``poll()``."""
        while not stop.is_set():
            with self._cond:
                dues = [d for d in map(self._due_at, self._tenants.values())
                        if d is not None]
                due = min(dues) if dues else None
                now = self.clock.now()
                if due is None:
                    self._cond.wait(timeout=1.0)
                    continue
                if due > now:
                    self._cond.wait(timeout=due - now)
                    continue
            self.poll()
