"""Serving: the LM prefill/decode steps, the static-batch request loop and
the cache planner (``serve.engine``, ``serve.kv_cache``); the graph query
servers, synchronous and event-loop (``serve.graph_engine``), and their
window scheduler (``serve.scheduler``)."""
from repro_torch.serve.graph_engine import (  # noqa: F401
    ALGORITHMS, GLOBAL, GLOBAL_ALGORITHMS, AsyncGraphServer, GraphQueryServer,
    GraphRequest, LRUCache, graph_fingerprint,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    BackpressureError, FakeClock, QueryTicket, SLOAccount, SystemClock,
    WindowScheduler,
)
