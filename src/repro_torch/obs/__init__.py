"""Observability: phase-level tracing (``obs.trace``, a copy of the JAX
package's pure-Python module). Metrics and calibration are not ported yet
(ROADMAP §1)."""
from repro_torch.obs import trace  # noqa: F401
