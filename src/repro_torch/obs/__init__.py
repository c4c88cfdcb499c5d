"""Observability for the port: span tracing and the metrics registry.

* :mod:`.trace`   — contextvar-scoped span tracing (JSON + Chrome
  trace-event export; near-zero overhead when disabled).
* :mod:`.metrics` — the pull-based metrics registry (counters, gauges,
  fixed-bucket histograms; Prometheus text exposition).

``EXPLAIN [ANALYZE]`` (``obs/explain.py``) comes with the service slice.
"""

from . import metrics, trace  # noqa: F401
from .metrics import REGISTRY, MetricsRegistry, get_registry  # noqa: F401
from .trace import GLOBAL_TRACER, Span, Tracer, chrome_trace, span  # noqa: F401
