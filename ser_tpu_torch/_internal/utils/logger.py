"""Namespaced logging with scoped suppression of known dependency warnings.

Counterpart of ``ser_tpu/_internal/utils/logger.py``: ``get_logger`` puts a
module's logger under the package root (``ser_tpu_torch``),
``configure_logging(level)`` sets the root's handler once (the level from
the argument, else ``LOG_LEVEL``, else INFO), and
``suppressed_dependency_warnings`` silences known warnings of third-party
packages for one scope without hiding the port's own. The JAX package's
policy for jax's TPU warning has no counterpart here: the port loads no jax.
"""

from __future__ import annotations

import logging
import os
import warnings
from collections.abc import Iterator
from contextlib import contextmanager
from dataclasses import dataclass

_ROOT_NAME = "ser_tpu_torch"
_configured = False


def get_logger(name: str) -> logging.Logger:
    """A logger under the package root (``name`` is prefixed when it lies outside it)."""
    if not name.startswith(_ROOT_NAME):
        name = f"{_ROOT_NAME}.{name}"
    return logging.getLogger(name)


def configure_logging(level: str | int | None = None) -> None:
    """Gives the package root one stream handler, once; later calls only set the level."""
    global _configured
    resolved = level if level is not None else os.environ.get("LOG_LEVEL", "INFO")
    if isinstance(resolved, str):
        resolved = getattr(logging, resolved.upper(), logging.INFO)
    root = logging.getLogger(_ROOT_NAME)
    if not _configured:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    root.setLevel(resolved)


@dataclass(frozen=True)
class WarningPolicy:
    """One suppressed warning: a message pattern of one category, from modules matching a pattern."""

    message_regex: str
    category: type[Warning]
    module_regex: str


#: Known warnings of numeric dependencies that ask nothing of the user.
DEPENDENCY_WARNING_POLICIES: tuple[WarningPolicy, ...] = (
    WarningPolicy(r"os\.fork\(\) was called", RuntimeWarning, r".*"),
)


@contextmanager
def suppressed_dependency_warnings(
    policies: tuple[WarningPolicy, ...] = DEPENDENCY_WARNING_POLICIES,
) -> Iterator[None]:
    """Applies ``policies`` as warning filters for the scope only."""
    with warnings.catch_warnings():
        for policy in policies:
            warnings.filterwarnings(
                "ignore", message=policy.message_regex, category=policy.category, module=policy.module_regex
            )
        yield


__all__ = [
    "DEPENDENCY_WARNING_POLICIES",
    "WarningPolicy",
    "configure_logging",
    "get_logger",
    "suppressed_dependency_warnings",
]
