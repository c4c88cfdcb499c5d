"""Unified pull-based metrics registry (DESIGN.md §10).

One registry absorbs every counter the system already keeps — the engine's
:class:`~repro_torch.core.engine.ExecStats`, the store's ``IOStats``/``CacheStats``,
the scheduler's ``SchedulerStats``, the planner's ``CacheInfo`` — plus the
new first-class instruments: query/phase latency **histograms** (fixed
log-spaced buckets; p50/p95/p99 derivable at read time), per-kernel launch
counters + dispatch timing, and jit-recompile counters
(:mod:`repro_torch.kernels.ops`).

Pull-based: live stats objects are wired in as *collectors* (callables
sampled at scrape time), so ``/metrics`` always reflects current state
without any push traffic on the hot path.  The exposition format is the
Prometheus text format (``GET /metrics`` serves it verbatim)::

    # HELP masksearch_query_phase_seconds ...
    # TYPE masksearch_query_phase_seconds histogram
    masksearch_query_phase_seconds_bucket{phase="verify",le="0.01"} 3
    ...

Naming convention: ``masksearch_<subsystem>_<quantity>[_<unit>]``, counters
end in ``_total``, durations in ``_seconds``, sizes in ``_bytes``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Callable, Optional, Sequence

from .. import lockcheck

__all__ = ["MetricsRegistry", "REGISTRY", "get_registry",
           "DEFAULT_TIME_BUCKETS", "dataclass_sampler"]

#: Log-spaced latency buckets, 100 µs … 10 s (upper bounds, seconds).
DEFAULT_TIME_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt(v) -> str:
    """Prometheus sample-value formatting (integers without the .0)."""
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == -math.inf:
        return "-Inf"
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


class _Child:
    """One labeled sample of a counter/gauge."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = lockcheck.make_lock("metrics.child")

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def get(self) -> float:
        return self.value


class _HistChild:
    """One labeled fixed-bucket histogram."""

    __slots__ = ("buckets", "counts", "total", "count", "_lock")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +1 → +Inf
        self.total = 0.0
        self.count = 0
        self._lock = lockcheck.make_lock("metrics.hist")

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            i = 0
            for i, ub in enumerate(self.buckets):        # noqa: B007
                if value <= ub:  # masklint: ignore[bounds-soundness] -- histogram bucket edge, not a CHI bound
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            self.total += value
            self.count += 1

    def quantile(self, q: float) -> float:
        """Derive an approximate quantile (e.g. 0.5/0.95/0.99) from the
        bucket counts: linear interpolation inside the target bucket,
        clamped to the last finite edge for the +Inf bucket."""
        with self._lock:
            counts, total_n = list(self.counts), self.count
        if total_n == 0:
            return float("nan")
        rank = q * total_n
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1]

    def summary(self) -> dict:
        with self._lock:
            count, total = self.count, self.total
        return {"count": count, "sum_s": total,
                "p50": self.quantile(0.5), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class _Family:
    """A named metric family; children are keyed by label values."""

    def __init__(self, name: str, mtype: str, help: str,
                 labelnames: Sequence[str] = (), buckets=None):
        self.name = name
        self.type = mtype
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self._children: "OrderedDict[tuple, object]" = OrderedDict()
        self._lock = lockcheck.make_lock("metrics.family")

    def labels(self, **labels):
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"metric {self.name} expects labels {self.labelnames}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = (_HistChild(self.buckets)
                         if self.type == "histogram" else _Child())
                self._children[key] = child
            return child

    # Unlabeled convenience surface.
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def samples(self):
        """→ iterable of (label_dict, child)."""
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            yield dict(zip(self.labelnames, key)), child


class MetricsRegistry:
    """Owns metric families and scrape-time collectors; renders the
    Prometheus text exposition."""

    def __init__(self):
        self._families: "OrderedDict[str, _Family]" = OrderedDict()
        self._collectors: list = []
        self._lock = lockcheck.make_lock("metrics.registry")

    # -- family constructors (idempotent by name) -------------------------
    def _family(self, name, mtype, help, labelnames, buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, mtype, help, labelnames, buckets)
                self._families[name] = fam
            elif fam.type != mtype:
                raise ValueError(f"metric {name} already registered as "
                                 f"{fam.type}, not {mtype}")
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> _Family:
        return self._family(name, "histogram", help, labelnames,
                            buckets=tuple(buckets))

    def register_collector(self, fn: Callable[[], list]) -> None:
        """``fn() -> [(name, type, help, [(labels_dict, value), ...]), ...]``
        sampled at scrape time — the pull seam that absorbs live stats
        objects (ExecStats aggregates, CacheStats, SchedulerStats,
        CacheInfo) without copying them on the hot path."""
        with self._lock:
            self._collectors.append(fn)

    # -- scraping ---------------------------------------------------------
    def prometheus_text(self) -> str:
        lines: list = []
        with self._lock:
            families = list(self._families.values())
            collectors = list(self._collectors)
        for fam in families:
            samples = list(fam.samples())
            if not samples:
                continue
            lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for labels, child in samples:
                if fam.type == "histogram":
                    cum = 0
                    for i, ub in enumerate(child.buckets):
                        cum += child.counts[i]
                        bl = dict(labels)
                        bl["le"] = _fmt(ub)
                        lines.append(f"{fam.name}_bucket{_label_str(bl)} "
                                     f"{cum}")
                    bl = dict(labels)
                    bl["le"] = "+Inf"
                    lines.append(f"{fam.name}_bucket{_label_str(bl)} "
                                 f"{child.count}")
                    lines.append(f"{fam.name}_sum{_label_str(labels)} "
                                 f"{_fmt(child.total)}")
                    lines.append(f"{fam.name}_count{_label_str(labels)} "
                                 f"{child.count}")
                else:
                    lines.append(f"{fam.name}{_label_str(labels)} "
                                 f"{_fmt(child.get())}")
        for fn in collectors:
            for name, mtype, help, samples in fn():
                if not samples:
                    continue
                lines.append(f"# HELP {name} {_escape(help)}")
                lines.append(f"# TYPE {name} {mtype}")
                for labels, value in samples:
                    lines.append(f"{name}{_label_str(labels)} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-friendly view of the first-class families (histograms as
        count/sum/p50/p95/p99 summaries) — what ``/stats`` embeds."""
        out: dict = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            fam_out: dict = {}
            for labels, child in fam.samples():
                key = ",".join(f"{k}={v}" for k, v in labels.items()) or "_"
                fam_out[key] = (child.summary()
                                if fam.type == "histogram" else child.get())
            if fam_out:
                out[fam.name] = fam_out
        return out


def dataclass_sampler(name_prefix: str, mtype: str, help: str,
                      getter: Callable[[], object],
                      labels: Optional[dict] = None) -> Callable[[], list]:
    """Build a collector that reflects every numeric field of a (live)
    stats dataclass into ``<name_prefix>_<field>`` samples — the adapter
    that puts ``IOStats``/``CacheStats``/``SchedulerStats``/``CacheInfo``
    behind the registry without hand-listing fields (a field added to the
    dataclass shows up at the next scrape automatically)."""
    labels = labels or {}

    def collect() -> list:
        obj = getter()
        out = []
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            out.append((f"{name_prefix}_{f.name}", mtype, help,
                        [(labels, float(v))]))
        return out

    return collect


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry (kernel launch/jit counters live here)."""
    return REGISTRY
