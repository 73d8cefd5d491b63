"""Consumed-key audit for checkpoint conversion.

Copied from ``ser_tpu/models/checkpoint_audit.py`` (the part the Whisper
encoder loader uses): converters read tensors through :class:`AuditedState`,
and any in-scope tensor the conversion never consumed refuses the load, so a
layout variant cannot convert into a model that silently drops weights.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

__all__ = ["AuditedState", "unconsumed_key_error"]


class AuditedState:
    """Tracks which checkpoint tensors a conversion actually consumed.

    The converter reads through :meth:`take` (and tests presence with ``in``);
    :meth:`unconsumed` afterwards names the tensors it never looked at, so a
    layout variant that only ADDS keys fails loudly instead of converting into
    a forward that silently omits those weights.
    """

    def __init__(self, state: Mapping[str, np.ndarray]):
        self._state = dict(state)
        self.consumed: set[str] = set()

    def __contains__(self, key: str) -> bool:
        return key in self._state

    def take(self, key: str) -> np.ndarray:
        """Reads one tensor; raises ``KeyError`` naming it when missing."""
        if key not in self._state:
            raise KeyError(f"Missing weight {key!r} in checkpoint.")
        self.consumed.add(key)
        return np.asarray(self._state[key])

    def unconsumed(self, *, scope_prefixes: tuple[str, ...], ignore_exact: tuple[str, ...] = ()) -> list[str]:
        """Names every tensor under ``scope_prefixes`` that no read touched.

        ``scope_prefixes`` restricts the audit to one subtree (the encoder
        loader must not flag decoder tensors); ``ignore_exact`` names
        documented-benign leftovers (a fixed position table).
        """
        return sorted(
            key
            for key in self._state
            if key not in self.consumed and key.startswith(scope_prefixes) and key not in ignore_exact
        )


def unconsumed_key_error(leftovers: list[str], *, model: str) -> KeyError:
    """The error that refuses a partial conversion, naming a few leftovers."""
    preview = ", ".join(leftovers[:8])
    return KeyError(
        f"{model} checkpoint layout variant not understood: {len(leftovers)} "
        f"unconsumed tensor(s) (e.g. {preview}). Refusing to load a partial "
        "conversion — the dropped weights would silently change the model."
    )
