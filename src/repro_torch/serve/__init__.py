"""LM serving: the prefill/decode steps, the static-batch request loop and
the cache planner (``repro.serve.engine`` and ``kv_cache``)."""
