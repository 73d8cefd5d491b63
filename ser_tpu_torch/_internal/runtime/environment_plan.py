"""Typed runtime-environment deltas applied around workflows.

Counterpart of ``ser_tpu/_internal/runtime/environment_plan.py``: the Hugging
Face and ModelScope cache roots (and offline mode) of the active settings,
applied for a workflow's scope by ``temporary_process_env`` and restored after.
The port's loaders pass explicit cache paths; the plan steers only libraries
that read these variables when first imported inside the scope.
"""

from __future__ import annotations

import os
from collections.abc import Iterator
from contextlib import contextmanager
from dataclasses import dataclass, field

from ser_tpu_torch._internal.config.schema import AppConfig


@dataclass(frozen=True)
class RuntimeEnvironmentPlan:
    """Environment variable deltas for one workflow execution."""

    set_vars: dict[str, str] = field(default_factory=dict)
    unset_vars: tuple[str, ...] = ()


def build_runtime_environment_plan(settings: AppConfig) -> RuntimeEnvironmentPlan:
    """Builds the cache-root env plan for the active settings snapshot."""
    hub_cache = settings.models.huggingface_cache_root / "hub"
    return RuntimeEnvironmentPlan(
        set_vars={
            "HF_HOME": str(settings.models.huggingface_cache_root),
            # Both hub-cache spellings: libraries disagree on which one they honour.
            "HF_HUB_CACHE": str(hub_cache),
            "HUGGINGFACE_HUB_CACHE": str(hub_cache),
            "HF_HUB_OFFLINE": "1",  # this runtime never downloads at inference time
            "MODELSCOPE_CACHE": str(settings.models.modelscope_cache_root),
        }
    )


@contextmanager
def temporary_process_env(plan: RuntimeEnvironmentPlan) -> Iterator[None]:
    """Applies one env plan for the scope, restoring previous values after.

    Originals are saved on FIRST sight of a key only — a key in both
    ``set_vars`` and ``unset_vars`` would otherwise have its saved value
    clobbered by the plan's own, leaking the delta past the scope.
    """
    saved: dict[str, str | None] = {}

    def remember(key: str) -> None:
        if key not in saved:
            saved[key] = os.environ.get(key)

    try:
        for key, value in plan.set_vars.items():
            remember(key)
            os.environ[key] = value
        for key in plan.unset_vars:
            remember(key)
            os.environ.pop(key, None)
        yield
    finally:
        for key, previous in saved.items():
            if previous is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = previous


__all__ = [
    "RuntimeEnvironmentPlan",
    "build_runtime_environment_plan",
    "temporary_process_env",
]
