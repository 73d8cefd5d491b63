"""The port's restricted-backend gate against ``ser_tpu``'s, on the CPU.

- The policy table, its fingerprint and the consent store's path are the JAX
  package's, so a consent recorded by either package opens the other's gate
  (and the store's bytes are the same whichever wrote it).
- The gate matrix: flag off, no consent, the env allowlist, a persisted
  consent, a consent to a changed policy (another fingerprint).
- A gated profile gets no hook; ``api.infer(profile="accurate-research")``
  then raises ``UnsupportedProfileError`` in both packages.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import ser_tpu.api as jax_api
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.runtime import backend_hooks as jax_hooks
from ser_tpu._internal.runtime import restricted_backends as jax_rb
from ser_tpu._internal.runtime.registry import UnsupportedProfileError as JaxUnsupportedProfileError
from ser_tpu._internal.utils.audio_io import write_wav
import ser_tpu_torch.api as torch_api
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.runtime import backend_hooks
from ser_tpu_torch._internal.runtime import restricted_backends as rb
from ser_tpu_torch._internal.runtime.errors import UnsupportedProfileError


@pytest.fixture(autouse=True)
def data_home(tmp_path, monkeypatch):
    """Both packages' data root under a test directory, no explicit consent file."""
    monkeypatch.setenv("XDG_DATA_HOME", str(tmp_path / "data"))
    monkeypatch.delenv("SER_RESTRICTED_BACKENDS_CONSENT_FILE", raising=False)
    return tmp_path / "data"


def _jax_settings(env: dict):
    return build_settings_from_inputs(capture_settings_inputs(env))


def test_policy_and_fingerprint_match_ser_tpu() -> None:
    assert set(rb.RESTRICTED_BACKEND_POLICIES) == set(jax_rb.RESTRICTED_BACKEND_POLICIES) == {"emotion2vec"}
    for backend_id, policy in rb.RESTRICTED_BACKEND_POLICIES.items():
        reference = jax_rb.RESTRICTED_BACKEND_POLICIES[backend_id]
        assert vars(policy) == vars(reference)
        assert policy.fingerprint == reference.fingerprint
        assert len(policy.fingerprint) == 16


def test_consent_store_path_matches_ser_tpu(data_home, tmp_path, monkeypatch) -> None:
    assert rb.consent_store_path() == jax_rb._consent_store_path()
    assert rb.consent_store_path() == data_home / "ser" / "consents" / "restricted_backends.json"
    monkeypatch.setenv("SER_RESTRICTED_BACKENDS_CONSENT_FILE", str(tmp_path / "elsewhere.json"))
    assert rb.consent_store_path() == jax_rb._consent_store_path() == tmp_path / "elsewhere.json"


@pytest.mark.parametrize("writer", ["ser_tpu", "ser_tpu_torch"])
def test_consent_is_shared_between_the_packages(writer) -> None:
    assert not rb.has_backend_consent("emotion2vec") and not jax_rb.has_backend_consent("emotion2vec")
    (jax_rb if writer == "ser_tpu" else rb).record_backend_consent("emotion2vec")
    written = rb.consent_store_path().read_bytes()
    assert rb.has_backend_consent("emotion2vec") and jax_rb.has_backend_consent("emotion2vec")
    # The other package writes the same bytes.
    rb.consent_store_path().unlink()
    (rb if writer == "ser_tpu" else jax_rb).record_backend_consent("emotion2vec")
    assert rb.consent_store_path().read_bytes() == written


def test_persist_all_consents_counts_the_policies() -> None:
    assert rb.persist_all_restricted_backend_consents() == 1
    assert jax_rb.has_backend_consent("emotion2vec")
    with pytest.raises(ValueError, match="no restricted policy"):
        rb.record_backend_consent("handcrafted")


#: (environment, consent store contents or None) → access granted?
GATES = {
    "flag_off": ({}, None, False),
    "flag_off_with_allowlist": ({"SER_ALLOWED_RESTRICTED_BACKENDS": "emotion2vec"}, None, False),
    "no_consent": ({"SER_ENABLE_RESTRICTED_BACKENDS": "1"}, None, False),
    "allowlist": ({"SER_ENABLE_RESTRICTED_BACKENDS": "1", "SER_ALLOWED_RESTRICTED_BACKENDS": "x, emotion2vec"}, None, True),
    "other_allowlist": ({"SER_ENABLE_RESTRICTED_BACKENDS": "1", "SER_ALLOWED_RESTRICTED_BACKENDS": "other"}, None, False),
    "persisted": ({"SER_ENABLE_RESTRICTED_BACKENDS": "1"}, "current", True),
    "changed_fingerprint": ({"SER_ENABLE_RESTRICTED_BACKENDS": "1"}, "0123456789abcdef", False),
    "unreadable_store": ({"SER_ENABLE_RESTRICTED_BACKENDS": "1"}, "{not json", False),
}


def _stage_store(stored: str | None) -> None:
    """The consent store as a case has it: absent, the current fingerprint, another one, or garbage."""
    if stored is None:
        return
    path = rb.consent_store_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    if stored.startswith("{"):
        path.write_text(stored, encoding="utf-8")
        return
    fingerprint = rb.RESTRICTED_BACKEND_POLICIES["emotion2vec"].fingerprint if stored == "current" else stored
    path.write_text(json.dumps({"emotion2vec": fingerprint}), encoding="utf-8")


@pytest.mark.parametrize("case", sorted(GATES))
def test_gate_matrix_matches_ser_tpu(case) -> None:
    env, stored, granted = GATES[case]
    _stage_store(stored)
    outcomes = []
    for module, settings in ((rb, build_settings(env)), (jax_rb, _jax_settings(env))):
        try:
            module.ensure_backend_access("emotion2vec", settings=settings)
            outcomes.append(True)
        except module.RestrictedBackendError:
            outcomes.append(False)
    assert outcomes == [granted, granted]
    rb.ensure_backend_access("handcrafted", settings=build_settings(env))  # not restricted


@pytest.mark.parametrize("case", sorted(GATES))
def test_a_gated_profile_gets_no_hook(case) -> None:
    env, stored, granted = GATES[case]
    _stage_store(stored)
    env = {**env, "SER_ENABLE_ACCURATE_RESEARCH_PROFILE": "1"}
    ours = set(backend_hooks.build_backend_hooks(build_settings(env)))
    theirs = set(jax_hooks.build_backend_hooks(_jax_settings(env)))
    assert ours == theirs
    assert ("emotion2vec" in ours) == granted
    assert "handcrafted" in ours


def test_gated_accurate_research_request_is_refused_in_both(tmp_path) -> None:
    clip = tmp_path / "clip.wav"
    write_wav(clip, (0.1 * np.random.default_rng(0).standard_normal(16000)).astype(np.float32), 16000)
    env = {"SER_TORCH_DEVICE": "cpu", "SER_MODELS_FOLDER": str(tmp_path / "models"),
           "SER_CACHE_DIR": str(tmp_path / "cache")}
    with pytest.raises(UnsupportedProfileError, match="restricted backend is gated"):
        torch_api.infer(clip, profile="accurate-research", include_transcript=False, settings=build_settings(env))
    with pytest.raises(JaxUnsupportedProfileError):
        jax_api.infer(clip, profile="accurate-research", include_transcript=False, settings=_jax_settings(env))
