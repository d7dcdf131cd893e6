"""Bucket-level software pipeline behind the multi-query traversals
(``graphs.multi.traverse_multi_buckets``).

The JAX package's ``pipeline_buckets``: issuing query bucket *t+1* may
overlap the host-side materialisation of bucket *t*'s results, with at
most ``depth`` buckets in flight. In the port a bucket's runner is a host
loop that synchronises with the card every level, so ``issue`` returns a
finished result and the pipeline reorders host work only; the results are
the same at every depth. The iteration-level pipeline over the mesh
layer's phase closures (``iterate_phases``, ``run_phases_once``) waits for
that layer (ROADMAP §1).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Sequence

from repro_torch.obs import trace


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
