"""Observability: phase-level tracing (``obs.trace``), process-local
counters, gauges and streaming histograms (``obs.metrics``, the serving
layer's latency accounting) and cost-model calibration (``obs.calibrate``,
predicted against traced phase costs). Copies of the JAX package's
pure-Python modules. Instrumented sites: the phase closures of
``core.distributed.build_phase_fns``, the overlap windows of
``core.pipeline``, the Merge collectives and the submit → flush → payload
path of ``serve.graph_engine``."""
from repro_torch.obs import calibrate, metrics, trace  # noqa: F401
