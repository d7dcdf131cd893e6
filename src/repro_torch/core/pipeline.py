"""Pipelined phase execution: the paper's non-blocking-DMA recommendation,
in software. The four-phase vocabulary (Load / Kernel / Retrieve / Merge)
is defined in ``core/distributed.py``; this module decides *when* the
phases run relative to each other and to the host.

* :func:`iterate_phases` — the iteration-level pipeline over the closures
  of ``core.distributed.build_phase_fns``. At ``depth >= 1`` the phases are
  enqueued on the current CUDA stream without host synchronisation; a CUDA
  event is recorded after each iteration and the host waits only on the
  oldest pending one once more than ``depth`` iterations are in flight
  (the counterpart of the JAX package's ``block_until_ready(head)``).
  ``depth=0`` is the blocking schedule the paper measures on UPMEM:
  ``torch.cuda.synchronize`` after every phase. Every depth runs the same
  work on the same inputs in the same stream order, so the results are the
  same bits.

* :func:`pipeline_buckets` — the bucket-level pipeline behind the
  multi-query traversals (``graphs.multi.traverse_multi_buckets``): issuing
  bucket *t+1* may overlap the host-side materialisation of bucket *t*,
  with at most ``depth`` buckets in flight. A bucket's runner is a host
  loop that synchronises with the card every level, so ``issue`` returns a
  finished result and the pipeline reorders host work only.

On a CPU tensor there is nothing to wait for: every sync is a no-op.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Mapping, Optional, Sequence

import torch

from repro_torch.obs import trace

#: A build_phase_fns product: phase name -> closure (or None when the
#: strategy folds that phase away). See repro_torch.core.distributed.
PhaseFns = Mapping[str, Optional[Callable]]


def _no_sync(a):
    return a


def _synchronize(a):
    """Wait for the card if ``a`` (a tensor or a tuple of them) lives there:
    the blocking schedule's sync after a phase."""
    t = a[0] if isinstance(a, tuple) else a
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return a


def run_phases_once(fns: PhaseFns, parts, x, sync: Callable[[Any], Any] = _no_sync):
    """One Load → Kernel → Retrieve+Merge → feedback step through a
    ``build_phase_fns`` dict.

    ``sync`` is applied to every phase's output: the default leaves the
    work enqueued (non-blocking); ``depth=0`` of :func:`iterate_phases`
    passes a ``torch.cuda.synchronize``. Strategies with a folded phase
    (``None`` entry) skip it; a strategy whose Kernel exists only fused
    with its Load (the compressed Load) runs the ``e2e`` closure for the
    compute step. ``fused=True`` dicts run unchanged: their ``kernel``
    already contains the Retrieve+Merge.
    """
    load = fns.get("load")
    kern = fns.get("kernel")
    rm = fns.get("retrieve_merge")
    feedback = fns.get("feedback")

    if kern is None:
        return sync(fns["e2e"](parts, x))
    xf = sync(load(parts, x)) if load is not None else x
    y = sync(kern(parts, x, xf))
    if rm is not None:
        y = sync(rm(parts, y))
    if feedback is not None:
        y = sync(feedback(y))
    return y


def iterate_phases(fns: PhaseFns, parts, x0, n_iters: int, depth: int = 2):
    """Iterate ``x ← A ⊕.⊗ x`` for ``n_iters`` steps through per-phase
    closures, keeping at most ``depth`` iterations in flight.

    ``depth >= 1``: every phase of every iteration is enqueued without host
    synchronisation; after each iteration a CUDA event is recorded, and the
    host waits on the oldest pending event only while more than ``depth``
    are pending (backpressure). ``depth <= 0``: ``torch.cuda.synchronize``
    after every phase. The same work runs in the same order at every
    depth, so the results are bit-identical.

    Returns the final vector, finished (synchronised) on the caller's side.
    """
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    # With a tracer installed the phases trace themselves (each closure
    # from build_phase_fns syncs inside its span, so an observed pipeline
    # runs the blocking schedule); here only the backpressure waits, the
    # part no phase span can see, become spans.
    t = trace.active()
    x = x0
    if depth <= 0:
        for _ in range(n_iters):
            x = run_phases_once(fns, parts, x, sync=_synchronize)
        return _synchronize(x)

    cuda = (x0[0] if isinstance(x0, tuple) else x0).device.type == "cuda"
    in_flight: deque = deque()          # one event per pending iteration
    for _ in range(n_iters):
        x = run_phases_once(fns, parts, x)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        in_flight.append(ev)
        while len(in_flight) > depth:
            head = in_flight.popleft()      # None on the host: nothing to wait for
            if t is None:
                if head is not None:
                    head.synchronize()
            else:
                with t.span("pipeline/drain", depth=depth):
                    if head is not None:
                        head.synchronize()
    if t is None:
        return _synchronize(x)
    with t.span("pipeline/drain", depth=depth, final=True):
        return _synchronize(x)


def pipeline_buckets(issue: Callable[[Any], Any],
                     materialize: Callable[[Any, Any], Any],
                     items: Sequence[Any] | Iterable[Any],
                     depth: int = 2) -> list:
    """Bounded-depth software pipeline over independent work buckets.

    ``issue(item)`` starts the bucket's device work and returns a handle;
    ``materialize(item, handle)`` waits for it and converts it to the
    caller's result type. At most ``depth`` issued but unmaterialised
    handles are kept. ``depth <= 0`` is the strictly sequential
    issue-then-materialize loop. Results come back in item order and are
    the same at any depth: only the order of host work changes.
    """
    results: list = []
    pending: deque[tuple[Any, Any]] = deque()
    limit = max(0, depth)
    t = trace.active()
    if t is None:                       # hot path: no tracing cost
        for item in items:
            pending.append((item, issue(item)))
            while len(pending) > limit:
                it, handle = pending.popleft()
                results.append(materialize(it, handle))
        while pending:
            it, handle = pending.popleft()
            results.append(materialize(it, handle))
        return results

    # Traced: the issue window and the materialize window become spans,
    # indexed by bucket.
    n_issued = 0
    for item in items:
        with t.span("pipeline/issue", bucket=n_issued, depth=limit):
            pending.append((item, issue(item)))
        n_issued += 1
        while len(pending) > limit:
            it, handle = pending.popleft()
            with t.span("pipeline/materialize",
                        bucket=n_issued - len(pending) - 1, depth=limit):
                results.append(materialize(it, handle))
    while pending:
        it, handle = pending.popleft()
        with t.span("pipeline/materialize",
                    bucket=n_issued - len(pending) - 1, depth=limit):
            results.append(materialize(it, handle))
    return results
