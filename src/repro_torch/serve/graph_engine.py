"""Multi-query graph server: batches (algorithm, source) traversal requests
through the batched engine (graphs/multi.py) and serves whole-graph
analytics (graphs/analytics.py) as compute-once global results.

PyTorch counterpart of ``repro.serve.graph_engine``, with the same names,
counters, ``stats()`` structure and cache-key strings. Three differences:

* **device** — the server takes ``device=`` (the CUDA card unless named;
  with no card and no ``device=`` construction raises) and builds every
  engine there. The device moves no answer, so it is not in ``engine_key``.
  Flushes run with that device current, also on the async server's loop
  thread.
* **host pulls** — each bucket's device result is pulled with
  ``.cpu().numpy()`` in the JAX payload dtypes (int32 levels, float32
  dist/rank/residual, Python-int iterations), so the LRU holds host numpy
  arrays only and ``mutate``'s proofs and every checksum read them there.
  The first pull is the host's wait for the card (``serve/bucket_compute``).
* **mesh** — ``mesh``/``axis_name`` row-shard each [B, n] traversal
  block (graphs/multi.py) over a ``core.mesh.Mesh`` of virtual devices on
  the server's card, or over a ``core.rank_mesh.RankMesh``, one rank per
  device, each rank running its own rows: each position's rows run their
  own launches of the block kernels, and every answer equals the
  mesh-less server's. ``partitioned_matvec`` runs on either mesh.

  On a ``RankMesh`` the server runs SPMD, the contract a ``torchrun``
  program keeps: every rank builds the same server over the same graph
  (with ``device=`` its own card, or the card the ranks share) and is
  given the same ``submit``, ``mutate`` and ``flush`` calls in the same
  order. A flush then drains the same buckets in the same order on every
  rank, each bucket's traversal issuing its collectives (one a level, one
  at the end) in one order everywhere, and every rank ends it with the
  same payloads, LRU contents and counters. Whole-graph analytics run on
  every rank, as the mesh-less server runs them, and ``mutate`` migrates
  each rank's copy of the cache on its own, from the same payloads, so
  every rank takes the same branch.

  ``AsyncGraphServer`` serves ``RankMesh`` tenants under the same
  contract: every rank builds the same server (each with its own clock)
  and makes the same ``add_tenant``, ``submit``, ``mutate``, ``poll``,
  ``drain`` and ``close`` calls in the same order, so ticket ``seq``
  numbers agree across ranks. Windows would close on each process's own
  clock, so once a tenant is on a ``RankMesh``, rank 0 decides: each
  ``poll()``, ``drain()`` and ``close()``, and the drain inside
  ``mutate()``, takes the windows due on rank 0's clock in EDF order by
  its deadlines, shares them as ``[[tenant, [seq, ...]], ...]``
  (``RankMesh.share``; an empty decision too) and every rank pops exactly
  those tickets in that order (``WindowScheduler.decide``), the server's
  local tenants included. So every rank drains the same buckets in the
  same order and issues the same traversal collectives, and every rank
  keeps the same pending count, so the same ``submit`` is refused on
  every rank. Each rank's SLO account judges its own tickets on its own
  clock: ``admitted``, ``dispatched`` and ``resolved`` agree across
  ranks, ``goodput`` and ``deadline_misses`` may not, and ``stats()``'s
  conservation laws hold on every rank. A ticket's ``wait(timeout)`` that
  times out abandons nothing there: it raises and the ticket stays queued
  on every rank until a shared flush takes it. Every ``RankMesh`` tenant must
  span the ranks of one process group. ``start()`` refuses such a server:
  a follower rank's ``submit`` would race its own loop thread, so
  admission could differ by rank.

The request-batching idiom mirrors serve/engine.py's ServingEngine: callers
``submit`` requests, then ``flush`` resolves them. Two request kinds share
the same submit/flush path:

* **traversal** (bfs / sssp / ppr) — per-source queries, padded to fixed
  batch buckets and run as one jitted multi-source traversal per bucket.
* **global** (pagerank / cc / triangles / kcore) — source-less whole-graph
  analytics: the answer is a property of the graph, so it is computed once,
  cached, and fanned out to every asker (within a flush and across
  flushes via the LRU).

Serving-side optimizations:

* **dedup** — repeated sources inside a flush compute once and fan out;
* **LRU result cache** — answers served before skip the engine entirely,
  bounded by ``cache_capacity``. Keys carry the server's **graph/engine
  fingerprint** (edge-content hash + engine parameters), so a cache shared
  by several servers — or kept across an engine rebuild — can never return
  stale cross-graph results.

* **partition planning** — at construction the server runs the paper's
  strategy-selection problem through the cost-model planner
  (graphs.cost_model.choose_partition): ``strategy="auto"`` picks the
  Fig.-3 strategy + balance mode with the lowest estimated per-device
  Load/Kernel/Retrieve cost for this graph's degree histogram; a fixed
  ``"row"``/``"col"``/``"2d"`` (optionally ``:rows``/``:nnz``) pins it.
  The same pass prices the Merge phase per interconnect topology
  (core.collectives: flat/ring/tree/staged2d, bytes-on-wire α-β model)
  and records the cheapest as ``partition_choice.merge``.  The decision
  drives ``partitioned_matvec()`` (the mesh execution path); it never
  changes answers — collectives are bit-identical by construction — so
  it is deliberately NOT part of the cache key.

* **pipelined flush** — traversal misses drain in fixed-size buckets
  through the bucket pipeline (graphs.multi.traverse_multi_buckets over
  core.pipeline; phase vocabulary: core.distributed): bucket *t+1*'s
  jitted traversal is dispatched while bucket *t*'s payloads are pulled to
  host. ``pipeline_depth`` bounds the in-flight buckets; 0 restores the
  strictly sequential drain with bit-identical results (it never enters
  cache keys — only host sync order changes, never answers).

* **live mutation** — ``mutate(delta)`` applies a batched edge delta
  (core.delta.EdgeDelta) and advances the server to a new immutable
  snapshot epoch: queued requests drain first against the pre-mutation
  snapshot, the version bumps, and the LRU **selectively invalidates** —
  entries whose cached payloads prove the delta cannot reach them (every
  touched vertex unreached from their source) migrate to the new
  fingerprint instead of dying in an all-or-nothing flush. ``stats()``
  exposes the retained/invalidated split plus the cache's
  hit/miss/eviction counters, so the win is measurable, not asserted.

:class:`AsyncGraphServer` is the event-loop front-end over all of the
above: several tenants (graphs) in one process behind a shared LRU
memory budget, with time-/size-window adaptive batch formation,
admission control + typed backpressure, per-query deadlines/priorities
(EDF within a window), and mutation interleaving — scheduling policy in
:mod:`repro_torch.serve.scheduler`, driven by an injectable clock so tests
run deterministically (tests/test_torch_async_server.py replays identical
workloads through both servers and requires element-exact equality).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.adaptive import DecisionStump
from repro_torch.core.delta import apply_edge_delta, edge_diff, touched_vertices
from repro_torch.core.device import resolve_device
from repro_torch.core.rank_mesh import RankMesh
from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, MIN_TIMES, PLUS_TIMES
from repro_torch.graphs.analytics import (
    connected_components, kcore, triangle_count, triangle_reference,
)
from repro_torch.graphs.cost_model import (
    candidate_space, parse_strategy, plan_for_graph, repair_choice,
    trained_stump,
)
from repro_torch.graphs.datasets import Graph
from repro_torch.graphs.engine import GraphEngine, build_engine
from repro_torch.graphs.multi import traverse_multi_buckets
from repro_torch.graphs.ppr import pagerank
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.scheduler import (
    BackpressureError, QueryTicket, SLOAccount, SystemClock, WindowScheduler,
)

ALGORITHMS = ("bfs", "sssp", "ppr")
GLOBAL_ALGORITHMS = ("pagerank", "cc", "triangles", "kcore")
GLOBAL = -1  # source sentinel for global (whole-graph) requests


def _pinned(device) -> torch.device:
    """``resolve_device(device)`` with a CUDA index: a bare ``"cuda"`` means
    the current device of the calling thread, and the async server flushes
    on a thread of its own."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _host(t: torch.Tensor) -> np.ndarray:
    """A device result as a host numpy array, in its own dtype. On a CUDA
    tensor the copy waits for the work that produces it."""
    return t.detach().cpu().numpy()


def graph_fingerprint(graph: Graph) -> str:
    """Content hash of the graph's edge structure (not its object identity:
    a rebuilt-but-identical graph hits the same cache entries). Memoized
    per Graph instance (datasets.Graph.fingerprint) — the submit hot path
    builds cache keys from it and must not rehash full edge arrays."""
    return graph.fingerprint()


@dataclasses.dataclass
class GraphRequest:
    """One query. Traversal kinds carry a source vertex; global kinds use
    the GLOBAL sentinel. ``result`` is filled by flush(); ``cached`` marks
    answers served from the LRU instead of the engine."""

    algorithm: str
    source: int
    result: Optional[Dict[str, Any]] = None
    cached: bool = False
    # perf_counter stamp set by submit(); flush() turns it into the
    # per-query enqueue-wait observation (stats()["latency"]).
    submitted_at: float = 0.0


class LRUCache:
    """Bounded (engine_key, algorithm, source) -> result-dict map, LRU
    eviction. The engine_key component makes the cache safe to share
    across servers / graphs / rebuilt engines. Counts lookups / hits /
    misses / capacity evictions (``stats()``) so the serving layer can
    *prove* cache behaviour — e.g. that a mutate() preserved entries —
    instead of asserting it.

    Thread-safe: one lock guards the map and every counter, so a cache
    shared by several tenants of an :class:`AsyncGraphServer` (the
    multi-tenant memory budget) stays consistent under concurrent
    flushes — ``hits + misses == lookups`` holds in every ``stats()``
    snapshot, never just at quiescence."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict[Tuple[str, str, int], Dict[str, Any]] = OrderedDict()
        self._lock = threading.Lock()
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def get(self, key: Tuple[str, str, int]) -> Optional[Dict[str, Any]]:
        with self._lock:
            self.lookups += 1
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key: Tuple[str, str, int], value: Dict[str, Any]) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self.evictions += 1

    def migrate(self, old_prefix: str, new_prefix: str,
                keep) -> Tuple[int, int]:
        """Selective invalidation for one engine epoch: every entry keyed
        under ``old_prefix`` either re-keys to ``new_prefix`` (when
        ``keep(algorithm, source, value)`` vouches its payload is still
        exact) or drops. Recency order is preserved; entries under other
        prefixes (a shared cache serving other graphs) are untouched.
        Returns (retained, invalidated)."""
        retained = invalidated = 0
        with self._lock:
            moved: OrderedDict[Tuple[str, str, int], Dict[str, Any]] = \
                OrderedDict()
            for key, value in self._d.items():
                if key[0] != old_prefix:
                    moved[key] = value
                elif keep(key[1], key[2], value):
                    moved[(new_prefix,) + key[1:]] = value
                    retained += 1
                else:
                    invalidated += 1
            self._d = moved
        return retained, invalidated

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"lookups": self.lookups, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "size": len(self._d), "capacity": self.capacity}


class GraphQueryServer:
    """Batching front-end over one graph: build per-semiring engines lazily,
    queue queries, drain them in fixed-size buckets (traversal) or as
    compute-once global results (analytics)."""

    def __init__(self, graph: Graph, stump: DecisionStump | None = None,
                 batch_size: int = 8, cache_capacity: int = 1024,
                 max_iters: int = 64, policy: str = "adaptive",
                 alpha: float = 0.85, weight_seed: int = 5,
                 mesh=None, axis_name="batch",
                 cache: LRUCache | None = None,
                 triangle_dense_limit: int = 8192,
                 pipeline_depth: int = 2,
                 strategy: str = "auto",
                 partition_devices: int = 8,
                 device=None):
        # Every engine of this server lives here. Not in engine_key: the
        # device moves no answer.
        self.device = _pinned(device)
        # Row-sharding of each traversal block: moves no answer either.
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device}, the server on {self.device}")
        self.mesh = mesh
        self.axis_name = axis_name
        self.graph = graph
        self.stump = stump or trained_stump()
        self.batch_size = batch_size
        self.max_iters = max_iters
        self.policy = policy
        self.alpha = alpha
        self.weight_seed = weight_seed
        self.triangle_dense_limit = triangle_dense_limit
        # Bucket-pipeline depth for the flush drain (0 = blocking drain).
        # Deliberately NOT part of engine_key: it moves host sync points,
        # never answers.
        self.pipeline_depth = pipeline_depth
        # Partition planning (paper §4.1.1): the spec is validated now so a
        # bad one fails at construction, but the plans themselves (O(nnz)
        # per candidate) are built lazily on first partition_choice access
        # — the default submit/flush path never needs them.  Like
        # pipeline_depth, the choice moves data placement, never answers —
        # not in engine_key.
        self.strategy_spec = strategy
        self.partition_devices = partition_devices
        self._strategy, self._balance = parse_strategy(strategy)
        self._partition_choice = None
        self.cache = cache if cache is not None else LRUCache(cache_capacity)
        # Monotonic snapshot epoch: mutate() bumps it with every applied
        # delta batch, giving (version, fingerprint) the ordering a pure
        # content hash lacks.
        self.version = 0
        self.engine_key = self._engine_key_for(graph)
        self._engines: Dict[str, GraphEngine] = {}
        self._queue: List[GraphRequest] = []
        self.counters = {"submitted": 0, "served": 0, "cache_hits": 0,
                         "deduped": 0, "batches": 0, "global_runs": 0,
                         "mutations": 0, "edges_inserted": 0,
                         "edges_deleted": 0, "entries_retained": 0,
                         "entries_invalidated": 0, "plan_repairs": 0,
                         "plan_replans": 0}
        # Per-server latency instruments (repro_torch.obs.metrics): enqueue
        # wait / flush latency / bucket+payload times as streaming
        # histograms, queue depth and LRU hit rate as gauges. Surfaced
        # (as plain copies) under stats()["latency"].
        self.metrics = MetricsRegistry()

    def _engine_key_for(self, graph: Graph) -> str:
        """Cache-key prefix for one graph snapshot under this server's
        engine parameters. Everything that changes answers must be in it:
        the graph's edge content plus the engine-shaping parameters — the
        stump included, since it moves the adaptive switch point and with
        it the kernels' float accumulation order."""
        stump_key = (f"{self.stump.feature}:{self.stump.threshold:g}:"
                     f"{self.stump.left_class}:{self.stump.right_class}")
        return (f"{graph_fingerprint(graph)}"
                f"/w{self.weight_seed}/a{self.alpha}/i{self.max_iters}"
                f"/{self.policy}/s{stump_key}")

    def stats(self) -> Dict[str, Any]:
        """One coherent counter snapshot: the server's serving/mutation
        counters, the current snapshot version, the LRU's
        hit/miss/eviction accounting (shared caches aggregate across
        servers), and a ``latency`` section — per-query enqueue wait,
        flush latency, bucket/payload times (p50/p90/p99 streaming
        histograms), queue depth at flush, and the LRU hit rate.

        The returned structure is a **deep copy**: callers may mutate it
        freely (or hand it to a JSON encoder) without corrupting the live
        counters."""
        cs = self.cache.stats()
        snap = self.metrics.snapshot()
        probes = cs["hits"] + cs["misses"]
        latency: Dict[str, Any] = dict(snap["histograms"])
        # registry counters ride along (the async layer counts typed
        # backpressure rejections here, per tenant)
        latency.update(snap["counters"])
        latency["queue_depth"] = snap["gauges"].get(
            "queue_depth", {"value": 0.0, "min": 0.0, "max": 0.0,
                            "writes": 0})
        latency["lru_hit_rate"] = cs["hits"] / probes if probes else 0.0
        return copy.deepcopy({**self.counters, "version": self.version,
                              "cache": cs, "latency": latency})

    # ------------------------------------------------------------------
    def _on_device(self):
        """The server's device as the thread's current one (CUDA), so a
        flush on any thread launches there."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def engine(self, algorithm: str) -> GraphEngine:
        """The per-algorithm GraphEngine (built on first use, on the
        server's device). Global apps reuse the traversal engines where
        the semiring matches: pagerank shares ppr's normalized ⟨+,×⟩
        engine; kcore gets an unnormalized one; cc gets ⟨min,×⟩; triangles
        is engine-free (the masked SpGEMM on its own operands)."""
        if algorithm not in self._engines:
            g, stump, dev = self.graph, self.stump, self.device
            if algorithm == "bfs":
                eng = build_engine(g, BOOL_OR_AND, stump, device=dev)
            elif algorithm == "sssp":
                # content-keyed weights: a delta snapshot keeps every
                # surviving edge's weight, which is what lets mutate()
                # carry unaffected cached SSSP answers across versions
                eng = build_engine(g, MIN_PLUS, stump, weighted=True,
                                   seed=self.weight_seed,
                                   content_keyed=True, device=dev)
            elif algorithm in ("ppr", "pagerank"):
                eng = build_engine(g, PLUS_TIMES, stump, normalize=True,
                                   device=dev)
                self._engines["ppr"] = self._engines["pagerank"] = eng
                return eng
            elif algorithm == "cc":
                eng = build_engine(g, MIN_TIMES, stump, device=dev)
            elif algorithm == "kcore":
                eng = build_engine(g, PLUS_TIMES, stump, device=dev)
            else:
                raise ValueError(f"unknown algorithm {algorithm!r}; "
                                 f"expected one of "
                                 f"{ALGORITHMS + GLOBAL_ALGORITHMS}")
            self._engines[algorithm] = eng
        return self._engines[algorithm]

    @property
    def partition_choice(self):
        """The planner's strategy+balance decision for this graph
        (graphs.cost_model.PlannerChoice), computed on first access."""
        if self._partition_choice is None:
            strategies, balances = candidate_space(self._strategy,
                                                   self._balance)
            self._partition_choice = plan_for_graph(
                self.graph, n_devices=self.partition_devices,
                strategies=strategies, balances=balances)
        return self._partition_choice

    def partitioned_matvec(self, algorithm: str, mesh, kernel: str = "spmv",
                           batched: bool = False, topology: str = "auto"):
        """The mesh execution path for this server's planned partition:
        partition the graph for ``algorithm``'s semiring per
        ``partition_choice`` and build the distributed matvec
        (graphs.multi.partitioned_matvec) on ``mesh``, a
        ``core.mesh.Mesh`` of ``partition_devices`` virtual devices (axes
        ``dr``/``dc``), or a ``RankMesh`` of as many ranks, each rank
        building its own part and returning its own output block.  The
        Merge collective rides the same choice — ``topology="auto"`` runs
        whichever of flat/ring/tree/staged2d the wire-cost model picked
        alongside the partition (``partition_choice.merge``); a fixed name
        pins it.
        Returns ``(pm, fn, choice)``; ``pm.plan`` owns the shard/unshard
        layout helpers."""
        from repro_torch.graphs.multi import partitioned_matvec as _pmv

        if mesh.n_devices != self.partition_devices:
            raise ValueError(
                f"the mesh has {mesh.n_devices} devices, the partition was "
                f"planned for partition_devices={self.partition_devices}")
        if algorithm == "bfs":
            sr, kw = BOOL_OR_AND, {}
        elif algorithm == "sssp":
            sr, kw = MIN_PLUS, {"weighted": True, "seed": self.weight_seed}
        elif algorithm in ("ppr", "pagerank"):
            sr, kw = PLUS_TIMES, {"normalize": True}
        elif algorithm == "cc":
            sr, kw = MIN_TIMES, {}
        elif algorithm == "kcore":
            sr, kw = PLUS_TIMES, {}
        else:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        c = self.partition_choice
        if topology == "auto":
            topology, order = c.merge, c.merge_order
        else:
            order = "rc"
        return _pmv(self.graph, sr, mesh, strategy=c.strategy,
                    balance=c.balance, kernel=kernel, batched=batched,
                    topology=topology, merge_order=order, **kw)

    # ------------------------------------------------------------------
    def mutate(self, delta, max_imbalance: float = 1.5) -> Dict[str, Any]:
        """Apply one edge-delta batch (or a sequence, folded in order) to
        the served graph and advance to the new snapshot epoch.

        Consistency: any queued requests drain first, against the
        pre-mutation snapshot — a query observes the graph it was
        submitted under, never a half-applied delta. The snapshot swap
        itself is a plain rebind (Graph objects are immutable), so
        results materialised from in-flight buckets stay valid.

        Cache: instead of the old all-or-nothing fingerprint flush (every
        key died with the old fingerprint), the LRU **migrates**: entries
        whose payloads prove the delta cannot have reached them — every
        touched vertex unreached in the cached BFS levels / SSSP
        distances / PPR ranks, i.e. in a different component both before
        and after — re-key to the new fingerprint and keep serving; the
        rest (and every whole-graph kind) invalidate. The proof obligations
        are exactness-preserving because unit/normalized/content-keyed
        edge values never change on untouched edges.

        Partition plan: an already-computed partition_choice is patched in
        O(|delta|) (PartitionPlan.apply_delta); if the patched imbalance
        drifts past ``max_imbalance`` the cost-model planner reruns in
        full and may switch strategy (graphs.cost_model.repair_choice).

        Returns a report dict; cumulative counts land in ``stats()``."""
        if self._queue:
            self.flush()
        deltas = delta if isinstance(delta, (list, tuple)) else (delta,)
        g = self.graph
        rows, cols = g.rows, g.cols
        for d in deltas:
            rows, cols = apply_edge_delta(rows, cols, g.n, d)
        eff = edge_diff(g.rows, g.cols, rows, cols, g.n)
        self.version += 1
        self.counters["mutations"] += 1
        report = {"version": self.version, "inserted": eff.n_inserts,
                  "deleted": eff.n_deletes, "retained": 0,
                  "invalidated": 0, "replanned": False}
        if eff.n_inserts == 0 and eff.n_deletes == 0:
            return report       # no-op epoch: same content, keys stay live
        touched = touched_vertices(eff)
        new_graph = dataclasses.replace(g, rows=rows, cols=cols)
        new_key = self._engine_key_for(new_graph)

        payload_field = {"bfs": "levels", "sssp": "dist", "ppr": "rank"}

        def keep(algorithm: str, source: int, payload: Dict[str, Any]) -> bool:
            if source == GLOBAL or algorithm not in payload_field:
                return False    # whole-graph answers see every edge
            vals = np.asarray(payload[payload_field[algorithm]])[touched]
            if algorithm == "bfs":
                return bool(np.all(vals < 0))
            if algorithm == "sssp":
                return bool(np.all(np.isinf(vals)))
            # ppr: mass is exactly 0.0 on vertices the walk cannot reach
            return bool(np.all(vals == 0.0))

        retained, invalidated = self.cache.migrate(self.engine_key, new_key,
                                                   keep)
        replanned = False
        if self._partition_choice is not None:
            strategies, balances = candidate_space(self._strategy,
                                                   self._balance)
            self._partition_choice, replanned = repair_choice(
                self._partition_choice, new_graph, eff,
                n_devices=self.partition_devices,
                strategies=strategies, balances=balances,
                max_imbalance=max_imbalance)
            self.counters["plan_replans" if replanned
                          else "plan_repairs"] += 1
        self.graph = new_graph
        self.engine_key = new_key
        # old-snapshot closures must never serve; dropping them frees the
        # old snapshot's device tensors
        self._engines = {}
        self.counters["edges_inserted"] += eff.n_inserts
        self.counters["edges_deleted"] += eff.n_deletes
        self.counters["entries_retained"] += retained
        self.counters["entries_invalidated"] += invalidated
        report.update(retained=retained, invalidated=invalidated,
                      replanned=replanned)
        return report

    def validate_request(self, algorithm: str,
                         source: int | None = None) -> Tuple[str, int]:
        """Validate one (algorithm, source) pair -> the normalized
        ``(algorithm, source)`` with global kinds mapped to the GLOBAL
        sentinel. Raises ValueError on anything unservable — shared by
        the synchronous submit() and the async admission path (so a bad
        query is rejected at submit time, never inside a flush)."""
        if algorithm in GLOBAL_ALGORITHMS:
            if source is not None:
                raise ValueError(f"{algorithm!r} is a whole-graph query; "
                                 f"it takes no source")
            return algorithm, GLOBAL
        if algorithm in ALGORITHMS:
            if source is None:
                raise ValueError(f"{algorithm!r} requires a source vertex")
            if not 0 <= source < self.graph.n:
                raise ValueError(
                    f"source {source} out of range [0, {self.graph.n})")
            return algorithm, int(source)
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one "
                         f"of {ALGORITHMS + GLOBAL_ALGORITHMS}")

    def submit(self, algorithm: str, source: int | None = None) -> GraphRequest:
        """Enqueue one query; resolution happens at the next flush().
        Traversal kinds require a source vertex; global kinds take none."""
        algorithm, src = self.validate_request(algorithm, source)
        req = GraphRequest(algorithm, src)
        req.submitted_at = time.perf_counter()
        self._queue.append(req)
        self.counters["submitted"] += 1
        return req

    # ------------------------------------------------------------------
    def _run_batches(self, algorithm: str, misses: List[int]
                     ) -> Dict[int, Dict[str, Any]]:
        """Drain the deduped ``misses`` as padded fixed-size buckets through
        the bucket pipeline -> per-source result dicts. With
        ``pipeline_depth > 0`` bucket t+1's traversal is already computing
        while bucket t is materialised here; depth 0 is the sequential
        drain (same runner, same buckets, identical results)."""
        eng = self.engine(algorithm)
        chunks = [misses[lo: lo + self.batch_size]
                  for lo in range(0, len(misses), self.batch_size)]
        kw = dict(policy=self.policy, max_iters=self.max_iters)
        if algorithm == "ppr":
            kw["alpha"] = self.alpha

        # materialize runs inside the pipeline's overlap window, so
        # payload conversion of bucket t happens while bucket t+1
        # computes; pad_to keeps one compiled runner for every bucket
        def to_payloads(bucket, res) -> Dict[int, Dict[str, Any]]:
            self.counters["batches"] += 1
            self.metrics.histogram("batch_size", least=1.0).observe(
                float(len(bucket)))
            tr = trace.active()
            t0 = time.perf_counter()
            if tr is None:
                rows, iters = self._to_host(algorithm, res)
                out = self._payloads(rows, iters, bucket)
            else:
                # split the bucket's wait-for-compute (the first host
                # pull blocks on the device result) from the pure
                # payload-dict conversion
                with tr.span("serve/bucket_compute", algorithm=algorithm,
                             size=len(bucket)):
                    rows, iters = self._to_host(algorithm, res)
                with tr.span("serve/payload", algorithm=algorithm,
                             size=len(bucket)):
                    out = self._payloads(rows, iters, bucket)
            self.metrics.histogram("bucket_s").observe(
                time.perf_counter() - t0)
            return out

        results = traverse_multi_buckets(
            eng, algorithm, chunks, pipeline_depth=self.pipeline_depth,
            mesh=self.mesh, axis_name=self.axis_name,
            materialize=to_payloads, pad_to=self.batch_size, **kw)
        out: Dict[int, Dict[str, Any]] = {}
        for payloads in results:
            out.update(payloads)
        return out

    @staticmethod
    def _to_host(algorithm: str, res) -> Tuple[Dict[str, np.ndarray],
                                               np.ndarray]:
        """Pull one bucket's device result to host arrays. The first
        ``.cpu()`` waits for the bucket's traversal on the card, so this is
        the wait-for-compute half of materialisation (traced as
        ``serve/bucket_compute``)."""
        if algorithm == "bfs":
            rows = {"levels": _host(res.levels)}
        elif algorithm == "sssp":
            rows = {"dist": _host(res.dist)}
        else:
            rows = {"rank": _host(res.rank),
                    "residual": _host(res.residual)}
        return rows, _host(res.iterations)

    @staticmethod
    def _payloads(rows: Dict[str, np.ndarray], iters: np.ndarray,
                  sources: List[int]) -> Dict[int, Dict[str, Any]]:
        """Host arrays -> per-source payload dicts (padding rows beyond
        ``sources`` are dropped); the conversion half (``serve/payload``)."""
        out = {}
        for i, s in enumerate(sources):
            payload = {k: v[i] for k, v in rows.items()}
            payload["iterations"] = int(iters[i])
            out[s] = payload
        return out

    @classmethod
    def _materialize(cls, algorithm: str, res, sources: List[int]
                     ) -> Dict[int, Dict[str, Any]]:
        """One bucket's device result -> host payload dicts, keyed by
        source (= _to_host + _payloads in one step)."""
        rows, iters = cls._to_host(algorithm, res)
        return cls._payloads(rows, iters, sources)

    def _run_global(self, algorithm: str) -> Dict[str, Any]:
        """One whole-graph analytics run (computed at most once per graph
        thanks to the LRU; every asker shares the payload)."""
        self.counters["global_runs"] += 1
        if algorithm == "pagerank":
            res = pagerank(self.engine("pagerank"), alpha=self.alpha,
                           max_iters=self.max_iters)
            return {"rank": _host(res.rank),
                    "residual": float(res.residual),
                    "iterations": int(res.iterations)}
        if algorithm == "cc":
            res = connected_components(self.engine("cc"))
            return {"labels": _host(res.labels),
                    "n_components": int(res.n_components),
                    "iterations": int(res.iterations)}
        if algorithm == "triangles":
            # The masked-SpGEMM path holds a dense [n, n] Lᵀ operand AND
            # the CSR kernel's [nnz(L), n] gather/product intermediates —
            # memory cliffs the serve path must not walk off for big
            # graphs. triangle_dense_limit² is the element budget for the
            # larger of the two; beyond it, fall back to the sequential
            # intersection counter: identical exact answer, work ∝ Σdeg²
            # (asymptotically less than the SpGEMM path's nnz·n), but a
            # host-Python loop — like every global kind, it runs on the
            # flush thread, so big-graph triangle queries are slow-lane.
            g = self.graph
            footprint = max(g.n, g.nnz // 2) * g.n
            if footprint > self.triangle_dense_limit ** 2:
                total = triangle_reference(g.rows, g.cols, g.n)
            else:
                total = int(triangle_count(g, device=self.device).total)
            return {"total": total, "iterations": 1}
        res = kcore(self.engine("kcore"))
        return {"coreness": _host(res.coreness),
                "max_core": int(res.max_core),
                "iterations": int(res.iterations)}

    def flush(self) -> List[GraphRequest]:
        """Resolve every queued request: cache -> dedup -> padded batches
        (traversal) / one shared run (global). Returns the requests in
        submission order, results attached.

        Observability per flush: queue depth and per-query enqueue wait
        are recorded into the metrics registry (stats()["latency"]); with
        a tracer installed each query additionally gets a retrospective
        ``serve/enqueue_wait`` span (submit stamp → flush start) and the
        flush itself a ``serve/flush`` span.

        Edge semantics (pinned in tests/test_torch_async_server.py): flushing
        an **empty** queue is a free no-op — ``[]``, no engine work, no
        metrics observations (an idle event-loop tick must not skew the
        latency histograms).  A queued request that is **already
        resolved** (a ticket flushed twice) passes through untouched:
        its cached payload is returned as-is, nothing recomputes, and no
        counter moves for it."""
        with self._on_device():
            return self._flush()

    def _flush(self) -> List[GraphRequest]:
        queue, self._queue = self._queue, []
        if not queue:
            return []
        pending = [req for req in queue if req.result is None]
        if not pending:
            return queue       # every ticket already resolved: no-op
        t0 = time.perf_counter()
        tr = trace.active()
        reg = self.metrics
        reg.gauge("queue_depth").set(float(len(queue)))
        wait_h = reg.histogram("enqueue_wait_s")
        for req in pending:
            if req.submitted_at:
                wait_h.observe(t0 - req.submitted_at)
                if tr is not None:
                    tr.add_span("serve/enqueue_wait", req.submitted_at, t0,
                                algorithm=req.algorithm, source=req.source)
        by_alg: Dict[str, List[GraphRequest]] = {}
        for req in pending:
            by_alg.setdefault(req.algorithm, []).append(req)

        for algorithm, reqs in by_alg.items():
            if algorithm in GLOBAL_ALGORITHMS:
                # Probe the LRU once per request, exactly like the
                # traversal path, so stats["cache_hits"] and
                # LRUCache.hits stay reconcilable across query kinds.
                # The first miss computes once into a flush-local payload;
                # fan-out askers resolve from the LRU when it accepted the
                # put, and from the local payload (counted as dedup, like
                # the traversal path) when caching is disabled/evicting —
                # the compute-once contract never depends on the cache.
                key = (self.engine_key, algorithm, GLOBAL)
                fresh = None
                for req in reqs:
                    hit = self.cache.get(key)
                    if hit is not None:
                        # shallow copy: numpy payloads stay shared (read-only)
                        req.result = dict(hit)
                        req.cached = True
                        self.counters["cache_hits"] += 1
                    elif fresh is not None:
                        req.result = dict(fresh)
                        self.counters["deduped"] += 1
                    else:
                        fresh = self._run_global(algorithm)
                        self.cache.put(key, fresh)
                        req.result = dict(fresh)
                continue

            misses: List[int] = []
            seen = set()
            for req in reqs:
                hit = self.cache.get((self.engine_key, algorithm, req.source))
                if hit is not None:
                    # shallow copy: the dict is per-request, the numpy
                    # payloads stay shared (treat them as read-only)
                    req.result = dict(hit)
                    req.cached = True
                    self.counters["cache_hits"] += 1
                elif req.source not in seen:
                    seen.add(req.source)
                    misses.append(req.source)
                else:
                    self.counters["deduped"] += 1
            fresh: Dict[int, Dict[str, Any]] = (
                self._run_batches(algorithm, misses) if misses else {})
            for src, payload in fresh.items():
                self.cache.put((self.engine_key, algorithm, src), payload)
            for req in reqs:
                if req.result is None:
                    req.result = dict(fresh[req.source])

        self.counters["served"] += len(pending)
        t1 = time.perf_counter()
        reg.histogram("flush_s").observe(t1 - t0)
        cs = self.cache.stats()
        probes = cs["hits"] + cs["misses"]
        reg.gauge("lru_hit_rate").set(cs["hits"] / probes if probes else 0.0)
        if tr is not None:
            tr.add_span("serve/flush", t0, t1, n_requests=len(pending))
        return queue


class AsyncGraphServer:
    """Event-loop serving front-end: many graphs ("tenants") in one
    process, queries admitted asynchronously and drained by a scheduler
    instead of explicit caller flushes.

    Each tenant is a full :class:`GraphQueryServer` (lazy engines,
    dedup, pipelined flush drain, live ``mutate()``), all sharing **one**
    :class:`LRUCache` — the multi-tenant memory budget: entries carry
    per-tenant engine fingerprints, so tenants compete for capacity but
    can never read each other's answers.  Scheduling policy
    (time-/size-window batch formation, EDF ordering, admission control
    with typed backpressure) lives in
    :class:`repro_torch.serve.scheduler.WindowScheduler`; this class binds it
    to the engines:

    * ``submit()`` validates eagerly (a bad query raises here, never
      inside the loop), admits a :class:`QueryTicket` or raises the
      typed :class:`BackpressureError` — counted per tenant in
      ``stats(tenant)["latency"]["rejected"]``.
    * the executor drains one tenant's window through its synchronous
      server under a per-tenant lock (engines are not reentrant), so
      flushes of *different* tenants interleave freely with each other
      and with mutations.
    * ``mutate()`` drains the tenant's pending window first — exactly
      the synchronous server's queued-requests-see-the-old-snapshot
      contract, lifted to the async queue.
    * every first resolve is judged against its ticket's deadline into a
      per-tenant :class:`~repro_torch.serve.scheduler.SLOAccount`:
      ``stats(tenant)["slo"]`` carries goodput / deadline_misses /
      abandoned plus signed slack histograms, with snapshot-exact
      conservation invariants (see :meth:`stats`).

    Run it threaded (``start()``/``close()``, real clock) for serving
    and benchmarks, or single-threaded on a
    :class:`~repro_torch.serve.scheduler.FakeClock` (``submit → advance →
    poll``) for deterministic tests — the differential suite
    (tests/test_torch_async_server.py) replays identical workloads through
    both this and the synchronous server and requires element-exact
    payload equality.
    """

    def __init__(self, clock=None, max_pending: int = 256,
                 max_wait: float = 0.05, cache_capacity: int = 4096,
                 cache: LRUCache | None = None):
        self.clock = clock if clock is not None else SystemClock()
        self.cache = cache if cache is not None else LRUCache(cache_capacity)
        self.scheduler = WindowScheduler(
            self._drain_tenant, clock=self.clock, max_pending=max_pending,
            default_max_wait=max_wait)
        self._tenants: Dict[str, GraphQueryServer] = {}
        self._tenant_locks: Dict[str, threading.Lock] = {}
        self._slo: Dict[str, SLOAccount] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: the first RankMesh tenant's mesh: rank 0 of it decides every flush
        self._ranks: Optional[RankMesh] = None

    _THREADED_RANKS = (
        "an AsyncGraphServer with a RankMesh tenant runs no loop thread: a follower "
        "rank's submit would race its own loop thread, so admission could differ by "
        "rank; drive it with poll(), drain() and close() in the same order on every rank")

    def _decide(self, view) -> bytes:
        """Rank 0's flush decision on every rank (``WindowScheduler.decide``)."""
        return self._ranks.share(view() if self._ranks.rank == 0 else b"")

    # ------------------------------------------------------------ tenants
    def add_tenant(self, name: str, graph: Graph,
                   max_wait: float | None = None,
                   **server_kwargs) -> GraphQueryServer:
        """Host ``graph`` under ``name``: builds its GraphQueryServer on
        the shared LRU (pass ``cache=`` to override) and registers its
        window with the scheduler. ``server_kwargs`` are the synchronous
        server's knobs (batch_size, pipeline_depth, strategy, mesh,
        axis_name, device, ...);
        ``max_wait`` overrides the server-wide latency budget."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already exists")
        mesh = server_kwargs.get("mesh")
        if isinstance(mesh, RankMesh):
            if self._thread is not None:
                raise ValueError(self._THREADED_RANKS)
            if self._ranks is not None and mesh.world is not self._ranks.world:
                raise ValueError(
                    f"tenant {name!r}'s RankMesh spans the ranks of another process "
                    f"group than the server's other RankMesh tenants: one decision "
                    f"cannot order both")
        server_kwargs.setdefault("cache", self.cache)
        server = GraphQueryServer(graph, **server_kwargs)
        if isinstance(mesh, RankMesh) and self._ranks is None:
            self._ranks = mesh
            self.scheduler.decide = self._decide
        self.scheduler.register(name, batch_size=server.batch_size,
                                max_wait=max_wait)
        self._tenants[name] = server
        self._tenant_locks[name] = threading.Lock()
        self._slo[name] = SLOAccount()
        return server

    def tenant(self, name: str) -> GraphQueryServer:
        if name not in self._tenants:
            raise ValueError(f"unknown tenant {name!r}; "
                             f"hosted: {sorted(self._tenants)}")
        return self._tenants[name]

    # ------------------------------------------------------------- submit
    def submit(self, tenant: str, algorithm: str, source: int | None = None,
               deadline: float | None = None,
               priority: int = 0) -> QueryTicket:
        """Admit one query for ``tenant`` and return its ticket.

        ``deadline`` is a relative latency budget in seconds — it pulls
        the window flush earlier, orders dispatch (EDF), and is the SLO
        the resolve is judged against (``stats(tenant)["slo"]``); it
        never drops admitted work.  ``priority`` breaks deadline ties
        (higher first).  Raises ValueError on an unservable query and
        :class:`BackpressureError` when the queue is saturated (counted
        in ``stats(tenant)["latency"]["rejected"]``).

        With a tracer installed, admission emits a ``serve/submit`` span
        carrying the ticket's ``request_id``/``window_id`` — the top of
        the stitched request lifecycle."""
        server = self.tenant(tenant)
        algorithm, src = server.validate_request(algorithm, source)
        abs_deadline = (None if deadline is None
                        else self.clock.now() + deadline)
        ticket = QueryTicket(tenant, algorithm, src, priority=priority,
                             deadline=abs_deadline)
        tr = trace.active()
        t0 = time.perf_counter() if tr is not None else 0.0
        try:
            self.scheduler.submit(ticket)
        except BackpressureError:
            server.metrics.counter("rejected").inc()
            raise
        if tr is not None:
            ticket.submitted_pc = t0
            tr.add_span("serve/submit", t0, time.perf_counter(),
                        tenant=tenant, algorithm=algorithm,
                        request_id=ticket.request_id,
                        window_id=ticket.window_id,
                        deadline=abs_deadline)
        return ticket

    # ----------------------------------------------------------- executor
    def _drain_tenant(self, name: str, tickets: List[QueryTicket]) -> None:
        """Scheduler executor: resolve one tenant window (already in EDF
        order) through its synchronous server. The per-tenant lock keeps
        the non-reentrant engine safe while other tenants' windows — and
        other tenants' mutations — proceed concurrently.

        With a tracer installed, each ticket gets a retrospective
        ``serve/window`` span (its submit stamp → dispatch) and the
        whole drain runs inside an ambient ``window_id``/``tenant``/
        ``request_ids`` context (obs.trace.Tracer.context) — every span
        the flush emits below here (``serve/flush``, bucket pipeline,
        phase closures) inherits the ids, stitching the lifecycle."""
        server = self._tenants[name]
        slo = self._slo[name]
        tr = trace.active()
        with self._tenant_locks[name]:
            if tr is None or not tickets:
                self._drain_window(server, slo, tickets)
                return
            wid = tickets[0].window_id
            now_pc = time.perf_counter()
            for tk in tickets:
                if tk.submitted_pc:
                    tr.add_span("serve/window", tk.submitted_pc, now_pc,
                                tenant=name, request_id=tk.request_id,
                                window_id=tk.window_id,
                                algorithm=tk.algorithm)
            rids = ",".join(tk.request_id for tk in tickets)
            with tr.context(window_id=wid, tenant=name, request_ids=rids):
                self._drain_window(server, slo, tickets)

    def _drain_window(self, server: GraphQueryServer, slo: SLOAccount,
                      tickets: List[QueryTicket]) -> None:
        """The drain body (tenant lock held): observe queue metrics,
        submit + flush through the synchronous server, resolve tickets
        and record each **first** resolve into the tenant's SLO account
        (re-resolution is a no-op, so a double drain can never double-
        count a goodput or a miss)."""
        reg = server.metrics
        now = self.clock.now()
        wait_h = reg.histogram("time_in_queue_s")
        occ_h = reg.histogram("window_occupancy", least=1e-3)
        occ_h.observe(len(tickets) / server.batch_size)
        reqs = []
        for tk in tickets:
            wait_h.observe(max(0.0, now - tk.admitted_at))
            reqs.append(server.submit(
                tk.algorithm,
                None if tk.source == GLOBAL else tk.source))
        server.flush()
        resolved_at = self.clock.now()
        for tk, req in zip(tickets, reqs):
            fresh = not tk.done()
            tk.resolve(req.result, cached=req.cached, at=resolved_at)
            if fresh:
                slo.record(tk)

    # --------------------------------------------------------- scheduling
    def poll(self) -> int:
        """Flush every due window now (the fake-clock pump)."""
        return self.scheduler.poll()

    def drain(self, tenant: str | None = None) -> int:
        """Flush every pending window, due or not."""
        return self.scheduler.drain(tenant)

    def mutate(self, tenant: str, delta, **kwargs) -> Dict[str, Any]:
        """Apply an edge delta to one tenant: its pending window drains
        first (queued queries observe the pre-mutation snapshot — the
        synchronous server's contract, lifted to the async queue), then
        the snapshot advances. Other tenants are untouched."""
        server = self.tenant(tenant)
        self.scheduler.drain(tenant)
        with self._tenant_locks[tenant]:
            return server.mutate(delta, **kwargs)

    def stats(self, tenant: str) -> Dict[str, Any]:
        """One tenant's coherent snapshot: the synchronous server's
        stats() (latency section now carrying the async instruments —
        time_in_queue_s, window_occupancy, rejected) plus the scheduler's
        admission/dispatch accounting under ``"scheduler"`` and the
        tenant's SLO truth under ``"slo"``.

        ``"slo"`` merges the scheduler's per-tenant lifecycle counters
        (admitted / dispatched / pending / abandoned / wait_timeouts)
        with the SLO account (resolved / goodput / deadline_misses /
        no_deadline + signed ``slack_s`` and ``lateness_s`` histogram
        summaries).  Conservation holds in **every** snapshot, threaded
        serving included::

            admitted == dispatched + pending + abandoned
            goodput + deadline_misses + no_deadline == resolved
            resolved <= dispatched

        The last inequality is guaranteed by read order: the SLO account
        is snapshotted *before* the scheduler (a request is dispatched
        before it resolves, so reading resolutions first can only
        undercount them relative to dispatches)."""
        server = self.tenant(tenant)
        slo = self._slo[tenant].snapshot()
        st = server.stats()
        st["scheduler"] = sched = self.scheduler.stats()
        st["slo"] = {**sched["tenants"][tenant], **slo}
        return st

    # ----------------------------------------------------------- threaded
    def start(self) -> "AsyncGraphServer":
        """Run the event loop on a background thread (real clock); a server
        with a ``RankMesh`` tenant raises (see the module docstring)."""
        if self._ranks is not None:
            raise ValueError(self._THREADED_RANKS)
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self.scheduler.run_loop, args=(self._stop,),
                name="graph-serve-loop", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop the loop thread (if running) and drain every pending
        window so no admitted ticket is left unresolved."""
        if self._thread is not None:
            self._stop.set()
            self.scheduler.kick()
            self._thread.join()
            self._thread = None
        self.scheduler.drain()

    def __enter__(self) -> "AsyncGraphServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
