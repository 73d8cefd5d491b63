"""Public utils facade of the PyTorch port (``ser_tpu/utils/__init__.py``'s names).

Lazily re-exports the supported helper surface: audio IO, timeline build/
render/persist, logging, and elapsed-time display.
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "build_timeline",
    "display_elapsed_time",
    "get_logger",
    "print_timeline",
    "read_audio_file",
    "save_timeline_to_csv",
]

_LAZY = {
    "read_audio_file": ("ser_tpu_torch._internal.utils.audio_io", "read_audio_file"),
    "build_timeline": ("ser_tpu_torch._internal.utils.timeline", "build_timeline"),
    "print_timeline": ("ser_tpu_torch._internal.utils.timeline", "print_timeline"),
    "save_timeline_to_csv": ("ser_tpu_torch._internal.utils.timeline", "save_timeline_to_csv"),
    "get_logger": ("ser_tpu_torch._internal.utils.logger", "get_logger"),
    "display_elapsed_time": ("ser_tpu_torch._internal.utils.common", "display_elapsed_time"),
}


def __getattr__(name: str) -> Any:
    try:
        module_name, attr = _LAZY[name]
    except KeyError as err:
        raise AttributeError(f"module 'ser_tpu_torch.utils' has no attribute {name!r}") from err
    import importlib

    return getattr(importlib.import_module(module_name), attr)
