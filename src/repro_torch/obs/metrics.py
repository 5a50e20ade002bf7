"""Typed metrics instruments behind a process-wide registry.

Three instrument kinds, all label-aware and all locked per instrument:

- :class:`Counter` — monotonically increasing floats.
- :class:`Gauge` — last-write-wins floats.
- :class:`Histogram` — count/sum/min/max plus a bounded reservoir
  (``deque(maxlen=...)``) from which exact p50/p95/p99 are computed.

A *label set* turns one instrument into a family of series: an
instrument declared with ``labelnames=("tier",)`` keeps an independent
series per observed ``tier=...`` value.  :class:`CounterView` wraps a
single-label counter in a read-only ``Mapping`` (``view["narrow"]``,
``dict(view)``) for telemetry dicts that are views over a counter.

Timing everywhere in this package goes through an injectable ``Clock``
(any zero-arg callable returning float seconds); :class:`ManualClock`
makes span timing and latency histograms deterministic under test.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import (
    Callable,
    Deque,
    Dict,
    Iterator,
    List,
    Mapping,
    Optional,
    Tuple,
)

import numpy as np

# A clock is any zero-arg callable returning seconds as float.
Clock = Callable[[], float]

MONOTONIC: Clock = time.monotonic

DEFAULT_RESERVOIR = 4096


class ManualClock:
    """Deterministic clock for tests: starts at ``start``, moves only
    when :meth:`advance` is called."""

    def __init__(self, start: float = 0.0) -> None:
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t


class _Instrument:
    """Base: name, label schema, and the per-instrument write lock."""

    kind = "instrument"

    def __init__(self, name: str, description: str = "", labelnames: Tuple[str, ...] = ()) -> None:
        self.name = str(name)
        self.description = str(description)
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Mapping[str, object]) -> Tuple[str, ...]:
        if len(labels) != len(self.labelnames) or any(n not in labels for n in self.labelnames):
            raise ValueError(
                f"instrument {self.name!r} takes labels {self.labelnames}, got {tuple(labels)}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _label_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))


class Counter(_Instrument):
    """Monotonic counter.  ``inc()`` rejects negative deltas."""

    kind = "counter"

    def __init__(self, name: str, description: str = "", labelnames: Tuple[str, ...] = ()) -> None:
        super().__init__(name, description, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def touch(self, **labels: object) -> None:
        """Ensure a series exists at 0 (so views expose stable key sets)."""
        key = self._key(labels)
        with self._lock:
            self._values.setdefault(key, 0.0)

    def inc(self, amount: float = 1, **labels: object) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (amount={amount})")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: object) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def series(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())


class Gauge(_Instrument):
    """Last-write-wins value (queue depths, rates, fleet sizes)."""

    kind = "gauge"

    def __init__(self, name: str, description: str = "", labelnames: Tuple[str, ...] = ()) -> None:
        super().__init__(name, description, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def value(self, default: float = 0.0, **labels: object) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, default)

    def series(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)


class _HistSeries:
    __slots__ = ("count", "total", "vmin", "vmax", "reservoir")

    def __init__(self, maxlen: int) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.reservoir: Deque[float] = deque(maxlen=maxlen)


class Histogram(_Instrument):
    """Exact-stats histogram over a bounded reservoir.

    Keeps exact ``count``/``sum``/``min``/``max`` for the full stream
    and a ``deque(maxlen=reservoir)`` of recent samples from which
    percentiles are computed (exact while the stream fits, sliding
    window after) — the same semantics the old ad-hoc
    ``Deque[float]`` tier-latency buffers had.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        labelnames: Tuple[str, ...] = (),
        reservoir: int = DEFAULT_RESERVOIR,
    ) -> None:
        super().__init__(name, description, labelnames)
        self.reservoir_size = int(reservoir)
        self._series: Dict[Tuple[str, ...], _HistSeries] = {}

    def touch(self, **labels: object) -> None:
        key = self._key(labels)
        with self._lock:
            self._series.setdefault(key, _HistSeries(self.reservoir_size))

    def observe(self, value: float, **labels: object) -> None:
        v = float(value)
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(self.reservoir_size)
            s.count += 1
            s.total += v
            s.vmin = v if s.vmin is None else min(s.vmin, v)
            s.vmax = v if s.vmax is None else max(s.vmax, v)
            s.reservoir.append(v)

    def count(self, **labels: object) -> int:
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            return s.count if s is not None else 0

    def percentile(self, q: float, **labels: object) -> Optional[float]:
        """Exact percentile over the reservoir; None when empty."""
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            samples = list(s.reservoir) if s is not None else []
        if not samples:
            return None
        return float(np.percentile(samples, q))

    def stats(self, **labels: object) -> Dict[str, Optional[float]]:
        key = self._key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None or s.count == 0:
                return {
                    "count": 0,
                    "sum": 0.0,
                    "min": None,
                    "max": None,
                    "p50": None,
                    "p95": None,
                    "p99": None,
                }
            samples = list(s.reservoir)
            count, total, vmin, vmax = s.count, s.total, s.vmin, s.vmax
        p50, p95, p99 = (float(np.percentile(samples, q)) for q in (50, 95, 99))
        return {
            "count": count,
            "sum": total,
            "min": vmin,
            "max": vmax,
            "p50": p50,
            "p95": p95,
            "p99": p99,
        }

    def series_keys(self) -> List[Tuple[str, ...]]:
        with self._lock:
            return list(self._series)


class CounterView(Mapping):
    """Read-only ``Mapping`` facade over a single-label :class:`Counter`.

    Back-compat for the pre-registry telemetry dicts: supports
    ``view["narrow"]``, ``dict(view)``, ``sum(view.values())`` with the
    label values as keys.  Counts surface as ``int`` (the old dicts
    held ints).
    """

    def __init__(self, counter: Counter) -> None:
        if len(counter.labelnames) != 1:
            raise ValueError(
                f"CounterView needs a single-label counter, {counter.name!r} has {counter.labelnames}"
            )
        self._counter = counter

    def __getitem__(self, key: str) -> int:
        series = self._counter.series()
        k = (str(key),)
        if k not in series:
            raise KeyError(key)
        return int(series[k])

    def __iter__(self) -> Iterator[str]:
        return iter(k[0] for k in self._counter.series())

    def __len__(self) -> int:
        return len(self._counter.series())

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"CounterView({dict(self)!r})"


class MetricsRegistry:
    """Get-or-create home for instruments, with snapshot/flat exports.

    A component (in the port so far, ``CampaignRunner``) owns a
    registry and saves its snapshot with its telemetry.  Re-registering
    a name with a different kind or label schema is an error — same
    kind/schema returns the existing instrument.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, description: str, labelnames: Tuple[str, ...], **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls) or inst.labelnames != labelnames:
                    raise ValueError(
                        f"instrument {name!r} already registered as {inst.kind} with "
                        f"labels {inst.labelnames}, requested {cls.kind} with {labelnames}"
                    )
                return inst
            inst = cls(name, description, labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, description: str = "", labelnames: Tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, description, labelnames)

    def gauge(self, name: str, description: str = "", labelnames: Tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, description, labelnames)

    def histogram(
        self,
        name: str,
        description: str = "",
        labelnames: Tuple[str, ...] = (),
        reservoir: int = DEFAULT_RESERVOIR,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, description, labelnames, reservoir=reservoir)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._instruments)

    def snapshot(self) -> Dict[str, Dict]:
        """Structured dump: ``{name: {type, description, labels, series}}``."""
        with self._lock:
            instruments = list(self._instruments.values())
        out: Dict[str, Dict] = {}
        for inst in instruments:
            entry: Dict[str, object] = {
                "type": inst.kind,
                "description": inst.description,
                "labels": list(inst.labelnames),
            }
            if isinstance(inst, (Counter, Gauge)):
                entry["series"] = [
                    {"labels": inst._label_dict(k), "value": v}
                    for k, v in sorted(inst.series().items())
                ]
            elif isinstance(inst, Histogram):
                entry["series"] = [
                    {"labels": inst._label_dict(k), **inst.stats(**inst._label_dict(k))}
                    for k in sorted(inst.series_keys())
                ]
            out[inst.name] = entry
        return out

    def flat(self) -> Dict[str, float]:
        """Flat ``{series_name: value}`` map (histograms expand to
        ``name_count``/``name_sum``/``name_p50``/...)."""
        out: Dict[str, float] = {}
        for name, entry in self.snapshot().items():
            for s in entry["series"]:
                labels = s["labels"]
                suffix = (
                    "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
                    if labels
                    else ""
                )
                if entry["type"] in ("counter", "gauge"):
                    out[f"{name}{suffix}"] = float(s["value"])
                else:
                    for stat in ("count", "sum", "min", "max", "p50", "p95", "p99"):
                        v = s[stat]
                        if v is not None:
                            out[f"{name}_{stat}{suffix}"] = float(v)
        return out

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def csv_lines(self) -> List[str]:
        """Flat snapshot as ``metric,value`` CSV lines (header first)."""
        lines = ["metric,value"]
        for key, value in sorted(self.flat().items()):
            lines.append(f"{key},{value:.9g}")
        return lines
