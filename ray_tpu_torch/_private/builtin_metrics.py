"""Built-in serve metrics of the port (the decode-loop pair of
``ray_tpu/_private/builtin_metrics.py``, under the same names).

Each accessor (re-)binds its metric through the registry, so
``util.metrics.clear_registry()`` in tests cannot orphan the
instrumentation: the next event simply re-registers.
"""

from __future__ import annotations

from ray_tpu_torch.util.metrics import Counter, Gauge


def serve_decode_active_slots() -> Gauge:
    return Gauge(
        "ray_tpu_serve_decode_active_slots",
        "Occupied slots in a continuous-batching decode loop, per "
        "engine (fixed-shape batch; free slots admit new sequences at "
        "iteration boundaries).",
        tag_keys=("engine",))


def serve_decode_admitted() -> Counter:
    return Counter(
        "ray_tpu_serve_decode_admitted_total",
        "Sequences admitted into a continuous-batching decode loop, "
        "by admission kind (fresh = loop was idle, running = joined a "
        "live decode batch at an iteration boundary).",
        tag_keys=("engine", "kind"))
