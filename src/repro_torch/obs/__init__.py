"""Observability for the port: span tracing and the metrics registry.

* :mod:`.trace`   — contextvar-scoped span tracing (JSON + Chrome
  trace-event export; near-zero overhead when disabled).
* :mod:`.metrics` — the pull-based metrics registry (counters, gauges,
  fixed-bucket histograms; Prometheus text exposition).
* :mod:`.explain` — ``EXPLAIN [ANALYZE]``: the annotated operator tree.

``trace``/``metrics`` are dependency-free leaves (the engine, kernels and
service all import them); ``explain`` sits *above* :mod:`repro_torch.core`
and is loaded lazily so importing :mod:`repro_torch.obs` from core never
cycles.
"""

from . import metrics, trace  # noqa: F401
from .metrics import REGISTRY, MetricsRegistry, get_registry  # noqa: F401
from .trace import GLOBAL_TRACER, Span, Tracer, chrome_trace, span  # noqa: F401


def __getattr__(name):
    # importlib (not ``from . import``): the from-import form re-enters this
    # __getattr__ before the submodule is bound and recurses forever.
    if name in ("explain", "explain_plan", "explain_analyze", "render_text"):
        import importlib

        explain = importlib.import_module(".explain", __name__)
        return explain if name == "explain" else getattr(explain, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
