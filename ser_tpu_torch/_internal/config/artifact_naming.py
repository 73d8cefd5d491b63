"""Artifact filenames of a profile's head and training report, per (profile, model id).

Counterpart of ``ser_tpu/_internal/config/artifact_naming.py``: the same stable
sha1-suffixed names, so a head trained by either package is found by the other.
"""

from __future__ import annotations

import re
from hashlib import sha1
from typing import Literal

type ArtifactProfileName = Literal["fast", "medium", "accurate", "accurate-research"]

FAST_MODEL_FILE_NAME = "ser_model.pkl"
FAST_SECURE_MODEL_FILE_NAME = "ser_model.skops"
FAST_TRAINING_REPORT_FILE_NAME = "training_report.json"


def artifact_profile_from_runtime_flags(
    *,
    medium_profile: bool,
    accurate_profile: bool,
    accurate_research_profile: bool,
) -> ArtifactProfileName:
    """The artifact profile of the runtime flags, by the runtime's precedence."""
    if accurate_research_profile:
        return "accurate-research"
    if accurate_profile:
        return "accurate"
    if medium_profile:
        return "medium"
    return "fast"


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
    return profile_artifact_file_names(profile=profile, model_id=model_id)[0]


def profile_artifact_file_names(*, profile: str, model_id: str | None) -> tuple[str, str, str]:
    """``(model, secure_model, training_report)`` filenames; the fast profile's are fixed."""
    if profile == "fast":
        return (FAST_MODEL_FILE_NAME, FAST_SECURE_MODEL_FILE_NAME, FAST_TRAINING_REPORT_FILE_NAME)
    if not model_id:
        raise ValueError(f"Profile {profile!r} needs a model id for its artifact names.")
    token = profile.replace("-", "_")
    suffix = artifact_model_id_suffix(model_id)
    return (
        f"ser_model_{token}_{suffix}.pkl",
        f"ser_model_{token}_{suffix}.skops",
        f"training_report_{token}_{suffix}.json",
    )


__all__ = [
    "ArtifactProfileName",
    "FAST_MODEL_FILE_NAME",
    "FAST_SECURE_MODEL_FILE_NAME",
    "FAST_TRAINING_REPORT_FILE_NAME",
    "artifact_model_id_suffix",
    "artifact_profile_from_runtime_flags",
    "profile_artifact_file_name",
    "profile_artifact_file_names",
]
