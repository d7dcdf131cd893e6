"""Structured phase-level tracing with a zero-overhead no-op default.

A copy of the JAX package's ``repro.obs.trace``, which imports no JAX:
the port keeps its own. A :class:`Tracer` collects :class:`Span` records
(name, wall-clock interval, free-form attributes: phase, strategy, device
count, bytes on wire) and exports them as Chrome-trace JSON (the
``traceEvents`` array format), loadable in ``chrome://tracing`` and
https://ui.perfetto.dev.

Design constraints, in order:

1. **Disabled is free.**  No tracer installed (the default) means every
   instrumentation site is one module-global ``None`` check; the
   module-level :func:`span` helper returns the shared :data:`NULL_SPAN`
   identity context manager, the same object every call, zero
   allocations.  Hot paths that would otherwise build a kwargs dict
   should fetch :func:`active` once and branch on ``None`` (see
   core.pipeline for the idiom).
2. **Enabled is blocking-accurate.**  CUDA launches are asynchronous, so
   a span around a bare launch measures the enqueue.  An instrumented
   site synchronises the device (``torch.cuda.synchronize``) *inside*
   its span when a tracer is installed, so span sums are comparable to
   wall time.  Values never change with the extra syncs: traced and
   untraced runs give the same results.
3. **Spans are data.**  A span is (name, t0, t1, attrs); retrospective
   intervals (e.g. a request's enqueue wait, known only at flush time)
   are first-class via :meth:`Tracer.add_span`.
4. **Stitching is ambient.**  :meth:`Tracer.context` opens a
   thread-local block of ambient attributes: every span recorded on
   that thread while the block is open, from any instrumentation site
   however deep in the call stack, inherits them (explicit attrs win).
   Thread-local, so concurrent flushes never cross-contaminate; nothing
   changes while tracing is disabled (ambient merging happens inside
   ``_record``, which only runs with a tracer installed).

Install/uninstall is explicit and process-global (:func:`install` /
:func:`uninstall`, or the :func:`tracing` context manager); thread-safe
recording via one lock per tracer.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    """One recorded interval. Times are ``time.perf_counter()`` seconds."""

    name: str
    t0: float
    t1: float
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """The shared identity context manager returned while tracing is
    disabled: entering/exiting does nothing, ``set()`` swallows attrs.
    One module-level instance exists (:data:`NULL_SPAN`); no call path
    allocates a new one."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _LiveSpan:
    """An in-flight span: context-manager entry stamps t0, exit stamps t1
    and hands the record to the tracer. ``set(**attrs)`` adds attributes
    mid-flight (e.g. bytes known only after the phase ran)."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0

    def __enter__(self) -> "_LiveSpan":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        self._tracer._record(Span(self.name, self.t0, self.t1, self.attrs))
        return False

    def set(self, **attrs) -> "_LiveSpan":
        self.attrs.update(attrs)
        return self


class _AmbientContext:
    """One entry on a tracer's thread-local ambient-attrs stack (see
    :meth:`Tracer.context`)."""

    __slots__ = ("_tracer", "_attrs")

    def __init__(self, tracer: "Tracer", attrs: Dict[str, Any]):
        self._tracer = tracer
        self._attrs = attrs

    def __enter__(self) -> "_AmbientContext":
        tl = self._tracer._ambient
        stack = getattr(tl, "stack", None)
        if stack is None:
            stack = tl.stack = []
        stack.append(self._attrs)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._ambient.stack.pop()
        return False


class Tracer:
    """A process-local span collector with a Chrome-trace exporter."""

    def __init__(self):
        self.spans: List[Span] = []
        self._lock = threading.Lock()
        self._ambient = threading.local()
        self.epoch = time.perf_counter()   # ts origin for the export

    # -- recording ------------------------------------------------------
    def span(self, name: str, **attrs) -> _LiveSpan:
        """A context manager recording one interval around its body."""
        return _LiveSpan(self, name, attrs)

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> Span:
        """Record a retrospective interval from explicit perf_counter
        stamps (e.g. enqueue wait: submit time → flush time)."""
        s = Span(name, t0, t1, attrs)
        self._record(s)
        return s

    def context(self, **attrs) -> _AmbientContext:
        """Thread-local ambient attributes for a block: every span this
        thread records while the block is open inherits ``attrs``
        (explicit span attrs win on clashes; nested contexts merge,
        inner-most winning).  Other threads are unaffected — concurrent
        tenant flushes each stitch their own ``window_id``."""
        return _AmbientContext(self, attrs)

    def _ambient_attrs(self) -> Optional[Dict[str, Any]]:
        stack = getattr(self._ambient, "stack", None)
        if not stack:
            return None
        merged: Dict[str, Any] = {}
        for frame in stack:
            merged.update(frame)
        return merged

    def _record(self, span: Span) -> None:
        ambient = self._ambient_attrs()
        if ambient:
            for k, v in ambient.items():
                span.attrs.setdefault(k, v)
        with self._lock:
            self.spans.append(span)

    def clear(self) -> None:
        with self._lock:
            self.spans = []

    # -- queries --------------------------------------------------------
    def by_name(self) -> Dict[str, List[Span]]:
        out: Dict[str, List[Span]] = {}
        for s in list(self.spans):
            out.setdefault(s.name, []).append(s)
        return out

    def total(self, prefix: str = "") -> float:
        """Summed duration (seconds) of every span whose name starts with
        ``prefix`` (empty prefix: all spans)."""
        return sum(s.duration for s in list(self.spans)
                   if s.name.startswith(prefix))

    def filter(self, prefix: str = "", **attrs) -> List[Span]:
        """Spans matching a name prefix and (exact-equality) attrs."""
        out = []
        for s in list(self.spans):
            if not s.name.startswith(prefix):
                continue
            if all(s.attrs.get(k) == v for k, v in attrs.items()):
                out.append(s)
        return out

    # -- export ---------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome-trace JSON object (``traceEvents`` complete events,
        microsecond timestamps relative to the tracer's epoch). Loads in
        chrome://tracing and ui.perfetto.dev unchanged."""
        events = []
        for s in list(self.spans):
            events.append({
                "name": s.name,
                "cat": str(s.attrs.get("phase", s.name.split("/", 1)[0])),
                "ph": "X",
                "ts": (s.t0 - self.epoch) * 1e6,
                "dur": s.duration * 1e6,
                "pid": 0,
                "tid": 0,
                "args": {k: (v if isinstance(v, (int, float, str, bool))
                             or v is None else str(v))
                         for k, v in s.attrs.items()},
            })
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path) -> int:
        """Write the Chrome-trace JSON to ``path``; returns event count."""
        doc = self.chrome_trace()
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, default=float)
        return len(doc["traceEvents"])


# ---------------------------------------------------------------------------
# The process-global active tracer (None = tracing disabled, the default)
# ---------------------------------------------------------------------------

_active: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    """The installed tracer, or None when tracing is disabled. Hot paths
    fetch this once and branch — the disabled branch is one comparison."""
    return _active


def enabled() -> bool:
    return _active is not None


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-global active tracer."""
    global _active
    _active = tracer
    return tracer


def uninstall() -> None:
    global _active
    _active = None


class tracing:
    """``with tracing(tracer):`` installs the tracer for the block and
    restores the previous one (usually None) on exit, exceptions included."""

    def __init__(self, tracer: Optional[Tracer] = None):
        self.tracer = tracer if tracer is not None else Tracer()
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        global _active
        self._prev = _active
        _active = self.tracer
        return self.tracer

    def __exit__(self, *exc) -> bool:
        global _active
        _active = self._prev
        return False


def span(name: str, **attrs):
    """Module-level convenience: a span on the active tracer, or the
    shared :data:`NULL_SPAN` identity context manager when disabled.

    Note the kwargs dict is built before the enabled check — per-element
    hot loops should use ``t = active()`` + an explicit ``None`` branch
    instead (the phase closures and pipelines do)."""
    t = _active
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)
