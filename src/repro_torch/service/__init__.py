"""MaskSearch interactive query service (DESIGN.md §5).

The serving layer between the SQL front-end and the engine: plan/result
caching, incremental top-k sessions, and cross-query fused verification —
the demo paper's interactive GUI loop as a subsystem.

Public surface:
  * :class:`MaskSearchService` — the stateful facade (:mod:`.api`).
  * :class:`ServiceClient`     — stdlib HTTP client (:mod:`.client`).
  * :func:`make_server` / ``python -m repro_torch.service.server`` — HTTP front.
  * :class:`AsyncTier` / :func:`serve_in_thread` /
    ``python -m repro_torch.service.asyncserver`` — the high-concurrency async
    front (admission control + cross-tenant batch fusion).
  * :mod:`.planner` / :mod:`.session` / :mod:`.scheduler` /
    :mod:`.routes` / :mod:`.admission` — the pieces.
"""

from .api import MaskSearchService  # noqa: F401
from .client import ServiceClient, ServiceError  # noqa: F401
from .planner import Planner, bounds_key, result_key, roi_signature  # noqa: F401
from .scheduler import FusedScheduler  # noqa: F401
from .session import Session, SessionManager  # noqa: F401


def __getattr__(name):
    # Lazy so `python -m repro_torch.service.server` doesn't pre-import the module
    # through the package (runpy's double-import warning).
    if name == "make_server":
        from .server import make_server
        return make_server
    if name in ("AsyncTier", "serve_in_thread"):
        from . import asyncserver
        return getattr(asyncserver, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
