"""Artifact filename of a transformer profile's head, per (profile, model id).

Counterpart of ``ser_tpu/_internal/config/artifact_naming.py``: the same stable
sha1-suffixed names, so a head trained by ``ser_tpu`` is found by the port.
"""

from __future__ import annotations

import re
from hashlib import sha1


def artifact_model_id_suffix(model_id: str) -> str:
    """A stable, filename-safe suffix for one backend model id.

    The suffix is ``<sanitized-model-id[:48]>_<sha1(model_id)[:10]>`` so distinct
    model ids can never collide after sanitization.
    """
    sanitized = re.sub(r"[^a-zA-Z0-9._-]+", "_", model_id.strip().lower()).strip("._-")
    digest = sha1(model_id.encode("utf-8")).hexdigest()[:10]
    return f"{sanitized[:48] or 'model'}_{digest}"


def profile_artifact_file_name(*, profile: str, model_id: str) -> str:
    """The head artifact's filename (``ser_model_<profile>_<suffix>.pkl``)."""
    token = profile.replace("-", "_")
    return f"ser_model_{token}_{artifact_model_id_suffix(model_id)}.pkl"


__all__ = ["artifact_model_id_suffix", "profile_artifact_file_name"]
