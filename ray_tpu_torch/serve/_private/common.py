"""Serve's config access: the part of ``ray_tpu/serve/_private/common.py``
that ``serve/batching.py`` reads."""

from __future__ import annotations

from typing import Any

from ray_tpu_torch._private.ray_config import runtime_config_value


def serve_config(name: str, default: Any) -> Any:
    """A serve flag: the ``RAY_TPU_<name>`` env var coerced to the
    default's type, else the default (the port has no runtime config
    table; ``_private/ray_config.py``)."""
    return runtime_config_value(name, default)
