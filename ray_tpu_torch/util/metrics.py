"""Process-local metrics: Counter and Gauge over a named registry.

A copy of the ``Metric``, ``Counter``, ``Gauge`` and registry parts of
``ray_tpu/util/metrics.py`` (the port imports nothing of ``ray_tpu``).
A registry aggregates tagged series per metric name; re-registering a
name with the same signature returns the same series store.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

_REGISTRY: Dict[str, "Metric"] = {}
_REGISTRY_LOCK = threading.Lock()


class Metric:
    metric_type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name required")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._series: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()
        with _REGISTRY_LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None:
                # Re-registration with the SAME signature returns the same
                # series store; a conflicting signature is a programming
                # error.
                if self._signature() != existing._signature():
                    raise ValueError(
                        f"metric {name!r} already registered with a "
                        f"different signature: existing "
                        f"{existing._signature()}, new {self._signature()}")
                self.__dict__ = existing.__dict__
            else:
                _REGISTRY[name] = self

    def _signature(self) -> Tuple:
        return (self.metric_type, self.description, self.tag_keys)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        merged = {**self._default_tags, **(tags or {})}
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(f"Unknown tag keys {sorted(extra)}; declared "
                             f"tag_keys={self.tag_keys}")
        return tuple(merged.get(k, "") for k in self.tag_keys)

    def series(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._series)


class Counter(Metric):
    metric_type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counters only increase")
        key = self._key(tags)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(Metric):
    metric_type = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._series[self._key(tags)] = float(value)


def registry() -> Dict[str, Metric]:
    with _REGISTRY_LOCK:
        return dict(_REGISTRY)


def clear_registry() -> None:
    """Test hook: forget every registered metric. Live Metric objects keep
    working but stop being registered; the next registration under a name
    starts a fresh series store."""
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
