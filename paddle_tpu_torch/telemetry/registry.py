"""Metric primitives + the registry that owns them (the port's copy of
``paddle_tpu/telemetry/registry.py``).

A :class:`MetricsRegistry` holds named counters / gauges / histograms
with labeled series (pull side) and a list of sinks (push side: one dict
per emitted record).  Records carry the JAX package's schema string, so
its offline tools (``tools/metrics_to_md.py``) read the port's serving
records unchanged.  The collective-comm accounting of the JAX registry
belongs to the parallel slices and is not here yet."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Any

SCHEMA = "paddle_tpu.metrics/15"

# histogram bucket upper bounds (ms-oriented default; values above the
# last edge land in the +Inf bucket)
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._registry = registry
        self._series: dict[tuple, Any] = {}

    def _lock(self):
        return self._registry._lock


class Counter(_Metric):
    """Monotonically increasing value per label set."""

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        key = _label_key(labels)
        with self._lock():
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)


class Gauge(_Metric):
    """Last-set value per label set."""

    def set(self, value: float, **labels) -> None:
        with self._lock():
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float | None:
        return self._series.get(_label_key(labels))


@dataclasses.dataclass
class _Hist:
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    buckets: list[int] = dataclasses.field(default_factory=list)


class Histogram(_Metric):
    """Fixed-bucket distribution per label set (bucket edges are upper
    bounds; one overflow bucket beyond the last edge)."""

    def __init__(self, name, help, registry, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, registry)
        self.bucket_edges = tuple(sorted(buckets))

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock():
            h = self._series.get(key)
            if h is None:
                h = self._series[key] = _Hist(
                    buckets=[0] * (len(self.bucket_edges) + 1))
            h.count += 1
            h.total += value
            h.min = min(h.min, value)
            h.max = max(h.max, value)
            for i, edge in enumerate(self.bucket_edges):
                if value <= edge:
                    h.buckets[i] += 1
                    break
            else:
                h.buckets[-1] += 1

    def _percentile_of(self, h: _Hist, q: float) -> float:
        """Linear-interpolated q-th percentile from the bucket counts.

        Within the bucket containing the target rank, values are assumed
        uniform between the bucket's bounds (first bucket's lower bound =
        observed min; overflow bucket's upper bound = observed max), so
        the estimate is exact at bucket edges and clamped to [min, max]."""
        rank = (q / 100.0) * h.count
        cum = 0
        lower = h.min
        for i, cnt in enumerate(h.buckets):
            upper = (self.bucket_edges[i] if i < len(self.bucket_edges)
                     else h.max)
            if cnt:
                cum += cnt
                if cum >= rank:
                    lo = max(lower, h.min)
                    hi = min(upper, h.max)
                    frac = (rank - (cum - cnt)) / cnt
                    return float(min(max(lo + (hi - lo) * frac, h.min),
                                     h.max))
            lower = upper
        return float(h.max)

    def percentile(self, q: float, **labels) -> float | None:
        """Estimated q-th percentile (0..100) for a label set, or None
        with no observations."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock():
            h = self._series.get(_label_key(labels))
            if h is None or not h.count:
                return None
            return self._percentile_of(h, q)

    def summary(self, **labels) -> dict | None:
        with self._lock():
            h = self._series.get(_label_key(labels))
            if h is None:
                return None
            pct = ({f"p{q}": self._percentile_of(h, q)
                    for q in (50, 90, 99)}
                   if h.count else {"p50": 0.0, "p90": 0.0, "p99": 0.0})
            # zero observations: min/max are the ±inf init sentinels —
            # clamp to 0 so an empty histogram's summary stays JSON-safe
            return {"count": h.count, "sum": h.total,
                    "avg": h.total / h.count if h.count else 0.0,
                    "min": h.min if h.count else 0.0,
                    "max": h.max if h.count else 0.0, **pct,
                    "buckets": dict(zip(
                        [str(e) for e in self.bucket_edges]
                        + ["+Inf"], h.buckets))}


class MetricsRegistry:
    """Named metrics + sink fan-out.

    ``counter/gauge/histogram`` are get-or-create (re-registering the
    same name with a different type is an error).  ``emit`` stamps the
    record with schema/ts/host and writes it to every sink; with no
    sinks it is a no-op (``active`` lets callers skip record assembly)."""

    def __init__(self, name: str = "default"):
        self.name = name
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}
        self._sinks: list = []

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, self, **kw)
            elif type(m) is not cls:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(sink)

    @property
    def sinks(self) -> list:
        return list(self._sinks)

    @property
    def active(self) -> bool:
        return bool(self._sinks)

    def emit(self, record: dict, kind: str | None = None) -> dict:
        """Stamp + fan a record out to every sink; returns the stamped
        record."""
        rec = dict(record)
        rec.setdefault("schema", SCHEMA)
        if kind is not None:
            rec.setdefault("kind", kind)
        rec.setdefault("ts", time.time())
        rec.setdefault("host", host_index())
        for sink in self._sinks:
            try:
                sink.write(rec)
            except Exception as e:
                # telemetry must never abort serving: a full disk or a
                # revoked path drops records, not the run (warn once per
                # sink so a long run doesn't drown in repeats)
                if not getattr(sink, "_write_failed", False):
                    sink._write_failed = True
                    from paddle_tpu_torch.core import logger

                    logger.get_logger("paddle_tpu_torch.metrics").warning(
                        "metrics sink %s write failed (%s); further "
                        "records to it may be lost", type(sink).__name__, e)
        return rec

    def flush(self) -> None:
        for sink in self._sinks:
            with swallow("sink_flush", self):
                sink.flush()


def host_index() -> int:
    """This process's worker index as a launcher stamps it
    (``PADDLE_TPU_TRAINER_ID``); 0 for a lone process."""
    return int(os.environ.get("PADDLE_TPU_TRAINER_ID", "0") or 0)


_default = MetricsRegistry()


def get_default_registry() -> MetricsRegistry:
    return _default


def safe_inc(name: str, help: str = "", amount: float = 1.0,
             registry: MetricsRegistry | None = None, **labels) -> None:
    """Best-effort counter increment for fault paths: accounting must
    never break the operation it observes, so every failure is
    swallowed."""
    try:
        (registry or _default).counter(name, help).inc(amount, **labels)
    except Exception:
        pass


@contextlib.contextmanager
def swallow(scope: str, registry: MetricsRegistry | None = None):
    """Accounting guard for telemetry side work: a failure inside the
    block is logged at debug, counted (``telemetry_errors{scope}``) and
    swallowed."""
    try:
        yield
    except Exception as e:
        try:
            from paddle_tpu_torch.core import logger

            logger.get_logger("paddle_tpu_torch.metrics").debug(
                "telemetry accounting failed in %s: %s: %s", scope,
                type(e).__name__, e)
            (registry or _default).counter(
                "telemetry_errors",
                "accounting failures swallowed by telemetry.swallow").inc(
                1.0, scope=scope)
        except Exception:
            pass  # the guard of last resort stays silent by design
