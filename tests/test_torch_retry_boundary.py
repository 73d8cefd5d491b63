"""The inference boundary's retry ladder and single flight, against ``ser_tpu``'s, on the CPU.

- ``run_with_retry_policy``: the same planted outcome sequences (timeouts,
  transient errors, hard OOMs, success) run through both packages' policies
  with a recording ``sleep``: the same attempts, the same backoff sleeps and
  the same result or error kind as the JAX policy without its fallback hook;
  against the JAX policy with its hook (its CPU attempt, the hard-OOM
  shortcut), the same up to the hook, where the port raises.
- ``run_profile_inference`` (the accurate profile's budgets) in both packages
  over a stub backend whose encodes follow a planted script: the same
  attempts, backoff sleeps, error kinds and segments up to where
  ``ser_tpu`` falls back to the CPU; there the port raises the last
  ``TransientInferenceError``, ``hard_oom`` kept (deliberate difference 25).
- A device OOM's attempt frees its tensors before the retry, in the thread
  path and in the direct path; the single flight serializes two threads and
  is re-entrant, pruned and keyed as ``ser_tpu``'s; the fast boundary takes
  the same single flight and budgets.
- The accurate profile with ``SER_ACCURATE_PROCESS_ISOLATION=1`` on a tiny
  random-init Whisper: a spawned worker on the CPU gives the in-process
  request's segments. (The fast boundary has no isolated attempt in either
  package, so the spawned case runs the windowed boundary.)
"""

from __future__ import annotations

import functools
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.models.artifacts import LoadedModel as JaxLoadedModel
from ser_tpu._internal.repr.backend import EncodedSequence as JaxEncodedSequence
from ser_tpu._internal.runtime import errors as jax_errors
from ser_tpu._internal.runtime import policy as jax_policy
from ser_tpu._internal.runtime import profile_boundary as jax_pb
from ser_tpu._internal.runtime.single_flight import SingleFlightRegistry as JaxSingleFlightRegistry
from ser_tpu.runtime.contracts import InferenceRequest as JaxInferenceRequest
import ser_tpu_torch.api as torch_api
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.repr import EncodedSequence
from ser_tpu_torch._internal.runtime import errors, fast_boundary, policy
from ser_tpu_torch._internal.runtime import profile_boundary as pb
from ser_tpu_torch._internal.runtime.single_flight import GLOBAL_SINGLE_FLIGHT, SingleFlightRegistry
from ser_tpu_torch._internal.utils.audio_io import write_wav
from ser_tpu_torch.runtime.contracts import InferenceRequest

REPO_ROOT = Path(__file__).resolve().parents[1]
OOM_MESSAGE = "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of 79.19 GiB"
#: The stub encodes are exact and identical in both packages; the head and the
#: postprocessing are numpy in both: segments and probabilities agree to rounding.
PROB_TOL = 1e-12

# --------------------------------------------------------------------------- #
# The policy alone
# --------------------------------------------------------------------------- #

_RAISES = {
    "timeout": lambda pkg: pkg.InferenceTimeoutError("slow", profile="accurate"),
    "transient": lambda pkg: pkg.TransientInferenceError("flaky", profile="accurate"),
    "hard_oom": lambda pkg: pkg.TransientInferenceError("oom", profile="accurate", hard_oom=True),
}


def _run_policy(run, pkg, script: list[str], budgets: dict, *, hook: bool = False):
    """Runs ``script`` (one outcome an attempt) through one package's policy; returns what happened."""
    events: list[str] = []
    outcomes = iter(script)

    def attempt():
        outcome = next(outcomes)
        events.append(outcome)
        if outcome == "ok":
            return "ok"
        raise _RAISES[outcome](pkg)

    def fallback():
        events.append("fallback")
        return "fallback"

    sleeps: list[float] = []
    try:
        hooks = {"on_exhausted_transient": fallback} if hook else {}
        result = run(attempt, policy=budgets["policy"], sleep=sleeps.append, **hooks)
        return events, sleeps, ("return", result)
    except (pkg.InferenceTimeoutError, pkg.TransientInferenceError) as err:
        return events, sleeps, ("raise", type(err).__name__, getattr(err, "hard_oom", False))


POLICY_CASES = {
    "ok": (["ok"], dict(max_timeout_retries=0, max_transient_retries=0)),
    "transient-then-ok": (["transient", "ok"], dict(max_transient_retries=1)),
    "transient-spent": (["transient", "transient", "transient"], dict(max_transient_retries=1)),
    "timeout-then-ok": (["timeout", "ok"], dict(max_timeout_retries=1)),
    "timeout-spent": (["timeout", "timeout"], dict(max_timeout_retries=1)),
    "budgets-apart": (["timeout", "transient", "timeout", "ok"], dict(max_timeout_retries=2, max_transient_retries=1)),
    "hard-oom": (["hard_oom", "hard_oom", "ok"], dict(max_transient_retries=2)),
    "hard-oom-spent": (["hard_oom", "hard_oom", "hard_oom"], dict(max_transient_retries=1)),
}


def _budgets(package_policy, fields: dict) -> dict:
    return {"policy": package_policy.RetryPolicy(retry_backoff_seconds=0.25, **fields)}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_matches_ser_tpu_without_its_hook(case: str) -> None:
    """Without a hook the JAX policy raises where its budget is spent, as the port's always does."""
    script, fields = POLICY_CASES[case]
    ours = _run_policy(policy.run_with_retry_policy, errors, script, _budgets(policy, fields))
    theirs = _run_policy(jax_policy.run_with_retry_policy, jax_errors, script, _budgets(jax_policy, fields))
    assert ours == theirs


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_without_hook_follows_ser_tpu_until_its_fallback(case: str) -> None:
    """The port's boundaries pass no hook: up to the JAX package's fallback the
    attempts and sleeps are the same; where it would fall back, the port raises."""
    script, fields = POLICY_CASES[case]
    events, sleeps, outcome = _run_policy(policy.run_with_retry_policy, errors, script, _budgets(policy, fields))
    jax_events, jax_sleeps, jax_outcome = _run_policy(
        jax_policy.run_with_retry_policy, jax_errors, script, _budgets(jax_policy, fields), hook=True
    )
    if "fallback" not in jax_events:
        assert (events, sleeps, outcome) == (jax_events, jax_sleeps, jax_outcome)
        return
    prefix = jax_events[: jax_events.index("fallback")]
    assert events[: len(prefix)] == prefix
    assert sleeps[: len(prefix) - 1] == jax_sleeps[: len(prefix) - 1]
    # Past that point the port goes on within its budgets (a hard OOM is one
    # more transient error to it): it ends in the script's success, or raises
    # the last error as it came, a hard OOM with its mark.
    assert len(events) <= 1 + fields.get("max_timeout_retries", 0) + fields.get("max_transient_retries", 0)
    if outcome[0] == "return":
        assert events[-1] == "ok"
    else:
        assert outcome == ("raise", "TransientInferenceError", events[-1] == "hard_oom")


# --------------------------------------------------------------------------- #
# The windowed boundary, both packages, planted encodes
# --------------------------------------------------------------------------- #


class _StubHead:
    classes_ = np.array(["happy", "sad"])

    def predict_proba(self, x):
        x = np.asarray(x, dtype=np.float64)
        p = 1.0 / (1.0 + np.exp(-(x[:, 0] - x[:, 1])))
        return np.stack([p, 1.0 - p], axis=1)

    def predict(self, x):
        return self.classes_[np.argmax(self.predict_proba(x), axis=1)]


def _stub_encode(audio: np.ndarray, sample_rate: int, sequence_type):
    """Deterministic 4-wide frames every 0.5 s, the same in both packages."""
    n = max(1, int(audio.size // (sample_rate * 0.5)))
    starts = np.arange(n, dtype=np.float64) * 0.5
    phase = np.sin(np.arange(n, dtype=np.float64))[:, None]
    embeddings = np.concatenate([phase, -phase, np.ones((n, 2))], axis=1).astype(np.float32)
    return sequence_type(
        embeddings=embeddings, frame_start_seconds=starts, frame_end_seconds=starts + 0.5, backend_id="jax_whisper_encoder"
    )


class _ScriptedBackend:
    """An encode that follows the next outcome of a shared script."""

    backend_id = "jax_whisper_encoder"
    feature_dim = 4

    def __init__(self, script: list[str], log: list[str], *, port: bool, device_kind: str = "auto") -> None:
        self._script, self._log, self._port, self._device_kind = script, log, port, device_kind

    def encode_sequence(self, audio, sample_rate):
        sequence_type = EncodedSequence if self._port else JaxEncodedSequence
        if self._device_kind == "cpu":
            self._log.append("cpu")
            return _stub_encode(audio, sample_rate, sequence_type)
        outcome = self._script.pop(0) if self._script else "ok"
        self._log.append(outcome)
        pkg = errors if self._port else jax_errors
        if outcome == "transient":
            raise pkg.TransientInferenceError("flaky card", profile="accurate")
        if outcome == "hard_oom":
            raise (torch.cuda.OutOfMemoryError if self._port else RuntimeError)(OOM_MESSAGE)
        if outcome == "error":
            raise RuntimeError("novel defect")
        if outcome == "value":
            raise ValueError("audio must be non-empty mono.")
        if outcome == "timeout":
            time.sleep(3.0)  # far past the 1 s budget, and a success far inside it, on a loaded host too
        return _stub_encode(audio, sample_rate, sequence_type)


def _clip(tmp_path: Path) -> str:
    clip = tmp_path / "clip.wav"
    sample_rate = 16000
    t = np.arange(sample_rate * 3) / sample_rate
    write_wav(clip, (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), sample_rate)
    return str(clip)


def _run_port(tmp_path, monkeypatch, script, env):
    log: list[str] = []
    sleeps: list[float] = []
    settings = build_settings({"SER_TORCH_DEVICE": "cpu", "SER_MODELS_FOLDER": str(tmp_path / "models"), **env})
    monkeypatch.setattr(pb, "_load_model", lambda *_: artifacts.LoadedModel(model=_StubHead(), expected_feature_size=8))
    monkeypatch.setattr(pb, "run_with_retry_policy", functools.partial(policy.run_with_retry_policy, sleep=sleeps.append))
    spec = pb.ProfileBoundarySpec(
        profile="accurate", backend_id="jax_whisper_encoder", model_id=None,
        backend_factory=lambda _: _ScriptedBackend(script, log, port=True), artifact_file_name="head.pkl",
    )
    try:
        result = pb.run_profile_inference(InferenceRequest(file_path=_clip(tmp_path), language="en"), spec=spec, settings=settings)
        return log, sleeps, ("ok", result)
    except (errors.InferenceError, ValueError) as err:
        return log, sleeps, ("raise", type(err).__name__, getattr(err, "hard_oom", False))


def _run_jax(tmp_path, monkeypatch, script, env):
    log: list[str] = []
    sleeps: list[float] = []
    settings = build_settings_from_inputs(
        capture_settings_inputs(
            {"SER_MODELS_FOLDER": str(tmp_path / "models"), "SER_DATASET_FOLDER": str(tmp_path / "ds"), **env}
        )
    )
    monkeypatch.setattr(jax_pb, "_load_model", lambda *_: JaxLoadedModel(model=_StubHead(), expected_feature_size=8))
    monkeypatch.setattr(
        jax_pb, "run_with_retry_policy", functools.partial(jax_policy.run_with_retry_policy, sleep=sleeps.append)
    )
    spec = jax_pb.ProfileBoundarySpec(
        profile="accurate", backend_id="jax_whisper_encoder", model_id=None, pooling_strategy="mean_std",
        backend_factory=lambda _, device_kind: _ScriptedBackend(script, log, port=False, device_kind=device_kind),
        artifact_file_name="head.pkl",
    )
    try:
        result = jax_pb.run_profile_inference(
            JaxInferenceRequest(file_path=_clip(tmp_path), language="en"), spec=spec, settings=settings
        )
        return log, sleeps, ("ok", result)
    except (jax_errors.InferenceError, ValueError) as err:
        return log, sleeps, ("raise", type(err).__name__, getattr(err, "hard_oom", False))


def _segments(result) -> list[tuple]:
    return [(s.emotion, s.start_seconds, s.end_seconds) for s in result.segments]


def _assert_same_result(ours, theirs) -> None:
    assert _segments(ours) == _segments(theirs)
    for a, b in zip(ours.frames, theirs.frames, strict=True):
        assert a.emotion == b.emotion and (a.start_seconds, a.end_seconds) == (b.start_seconds, b.end_seconds)
        for label, value in a.probabilities.items():
            assert abs(value - b.probabilities[label]) <= PROB_TOL


#: name → (the planted script, the environment). The accurate profile's
#: catalog budgets: no timeout retry, one transient retry, 0.25 s backoff.
BOUNDARY_CASES = {
    "ok": (["ok"], {}),
    "transient-then-ok": (["transient", "ok"], {}),
    "transient-spent": (["transient", "transient", "transient"], {}),
    "hard-oom": (["hard_oom", "hard_oom", "hard_oom"], {}),
    "hard-oom-no-shortcut": (["hard_oom", "hard_oom", "hard_oom"], {"SER_TRANSCRIPTION_HBM_HARD_OOM_SHORTCUT": "0"}),
    "timeout-spent": (["timeout", "ok"], {"SER_ACCURATE_TIMEOUT_SECONDS": "1.0"}),
    "timeout-then-ok": (
        ["timeout", "ok"], {"SER_ACCURATE_TIMEOUT_SECONDS": "1.0", "SER_ACCURATE_MAX_TIMEOUT_RETRIES": "1"}
    ),
    "timeout-transient-ok": (
        ["timeout", "transient", "ok"],
        {"SER_ACCURATE_TIMEOUT_SECONDS": "1.0", "SER_ACCURATE_MAX_TIMEOUT_RETRIES": "1"},
    ),
    "unknown-error": (["error"], {}),
    "validation-error": (["value"], {}),
    "two-transient-retries": (
        ["transient", "transient", "ok"], {"SER_ACCURATE_MAX_TRANSIENT_RETRIES": "2", "SER_ACCURATE_RETRY_BACKOFF_SECONDS": "0.5"}
    ),
}


@pytest.mark.parametrize("case", sorted(BOUNDARY_CASES))
def test_boundary_attempts_match_ser_tpu_until_its_cpu_fallback(tmp_path, monkeypatch, case: str) -> None:
    script, env = BOUNDARY_CASES[case]
    log, sleeps, outcome = _run_port(tmp_path, monkeypatch, list(script), env)
    jax_log, jax_sleeps, jax_outcome = _run_jax(tmp_path, monkeypatch, list(script), env)
    if "cpu" not in jax_log:
        assert log == jax_log and sleeps == jax_sleeps
        assert outcome[0] == jax_outcome[0]
        if outcome[0] == "ok":
            _assert_same_result(outcome[1], jax_outcome[1])
        else:
            assert outcome == jax_outcome
        return
    # ser_tpu's next attempt runs on the CPU; the port has none and raises instead.
    prefix = jax_log[: jax_log.index("cpu")]
    assert log[: len(prefix)] == prefix and sleeps[: len(prefix) - 1] == jax_sleeps[: len(prefix) - 1]
    assert outcome[:2] == ("raise", "TransientInferenceError")
    assert outcome[2] == (log[-1] == "hard_oom")
    assert jax_outcome[0] == "ok"


def test_boundary_budgets_read_the_same_variables(tmp_path) -> None:
    env = {"SER_ACCURATE_TIMEOUT_SECONDS": "0.5", "SER_ACCURATE_MAX_TIMEOUT_RETRIES": "2",
           "SER_ACCURATE_MAX_TRANSIENT_RETRIES": "3", "SER_ACCURATE_RETRY_BACKOFF_SECONDS": "0.75"}
    ours = build_settings(env).accurate_runtime
    theirs = build_settings_from_inputs(capture_settings_inputs(env)).accurate_runtime
    for knob in ("timeout_seconds", "max_timeout_retries", "max_transient_retries", "retry_backoff_seconds"):
        assert getattr(ours, knob) == getattr(theirs, knob)


# --------------------------------------------------------------------------- #
# The port's own: freed OOM attempts, the single flight, the fast boundary
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("timeout", ["0", "120"], ids=["direct", "thread"])
def test_oom_attempt_frees_its_tensors_before_the_retry(tmp_path, monkeypatch, timeout: str) -> None:
    """The failed attempt's tensors (held by its frames, which its traceback keeps)
    are gone when the retry starts, without a garbage-collector pass."""
    held: list[weakref.ref] = []
    alive_at_retry: list[bool] = []

    class _OomOnceBackend(_ScriptedBackend):
        def encode_sequence(self, audio, sample_rate):
            if not held:
                workspace = torch.zeros(1 << 20)
                held.append(weakref.ref(workspace))
                raise torch.cuda.OutOfMemoryError(OOM_MESSAGE)
            alive_at_retry.append(held[0]() is not None)
            return _stub_encode(audio, sample_rate, EncodedSequence)

    settings = build_settings({"SER_TORCH_DEVICE": "cpu", "SER_ACCURATE_TIMEOUT_SECONDS": timeout,
                               "SER_ACCURATE_RETRY_BACKOFF_SECONDS": "0"})
    monkeypatch.setattr(pb, "_load_model", lambda *_: artifacts.LoadedModel(model=_StubHead(), expected_feature_size=8))
    spec = pb.ProfileBoundarySpec(
        profile="accurate", backend_id="jax_whisper_encoder", model_id=None,
        backend_factory=lambda _: _OomOnceBackend([], [], port=True), artifact_file_name="head.pkl",
    )
    result = pb.run_profile_inference(InferenceRequest(file_path=_clip(tmp_path), language="en"), spec=spec, settings=settings)
    assert result.segments and alive_at_retry == [False]


def test_single_flight_serializes_two_threads(tmp_path, monkeypatch) -> None:
    active = {"now": 0, "peak": 0}
    guard = threading.Lock()

    class _SlowBackend(_ScriptedBackend):
        def encode_sequence(self, audio, sample_rate):
            with guard:
                active["now"] += 1
                active["peak"] = max(active["peak"], active["now"])
            time.sleep(0.15)
            with guard:
                active["now"] -= 1
            return _stub_encode(audio, sample_rate, EncodedSequence)

    settings = build_settings({"SER_TORCH_DEVICE": "cpu"})
    monkeypatch.setattr(pb, "_load_model", lambda *_: artifacts.LoadedModel(model=_StubHead(), expected_feature_size=8))
    spec = pb.ProfileBoundarySpec(
        profile="accurate", backend_id="jax_whisper_encoder", model_id=None,
        backend_factory=lambda _: _SlowBackend([], [], port=True), artifact_file_name="head.pkl",
    )
    request = InferenceRequest(file_path=_clip(tmp_path), language="en")
    results = []
    threads = [threading.Thread(target=lambda: results.append(pb.run_profile_inference(request, spec=spec, settings=settings)))
               for _ in range(2)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert len(results) == 2 and active["peak"] == 1
    assert GLOBAL_SINGLE_FLIGHT.active_keys() == []


@pytest.mark.parametrize("registry_type", [SingleFlightRegistry, JaxSingleFlightRegistry], ids=["port", "ser_tpu"])
def test_single_flight_is_reentrant_keyed_and_pruned(registry_type) -> None:
    registry = registry_type()
    with registry.acquire("accurate", "default"):
        with registry.acquire("accurate", "default"):  # re-entrant in one thread
            assert registry.active_keys() == [("accurate", "default")]
        entered = threading.Event()

        def other_key():
            with registry.acquire("medium", "default"):
                entered.set()

        thread = threading.Thread(target=other_key)
        thread.start()
        assert entered.wait(5.0)  # another key does not wait for this one
        thread.join()
    assert registry.active_keys() == []


def test_fast_boundary_takes_the_single_flight_and_its_budgets(tmp_path, monkeypatch) -> None:
    """The fast profile's catalog budgets are zero: one attempt; its key is ("fast", "default")."""
    from ser_tpu_torch._internal.models import emotion_model

    seen_keys, attempts = [], []
    monkeypatch.setattr(emotion_model, "load_model", lambda **_: artifacts.LoadedModel(model=None, expected_feature_size=193))

    def predict(*_args, **_kwargs):
        seen_keys.extend(GLOBAL_SINGLE_FLIGHT.active_keys())
        attempts.append(1)
        raise errors.TransientInferenceError("flaky", profile="fast")

    monkeypatch.setattr(emotion_model, "predict_emotions_detailed", predict)
    settings = build_settings({"SER_TORCH_DEVICE": "cpu"})
    with pytest.raises(errors.TransientInferenceError):
        fast_boundary.run_fast_inference(InferenceRequest(file_path="clip.wav", language="en"), settings=settings)
    assert seen_keys == [("fast", "default")] and attempts == [1]
    # One transient retry when the budget allows it.
    settings = build_settings({"SER_TORCH_DEVICE": "cpu", "SER_FAST_MAX_TRANSIENT_RETRIES": "1"})
    attempts.clear()
    with pytest.raises(errors.TransientInferenceError):
        fast_boundary.run_fast_inference(InferenceRequest(file_path="clip.wav", language="en"), settings=settings)
    assert attempts == [1, 1]


def test_fast_boundary_classifies_errors_as_ser_tpu(monkeypatch) -> None:
    from ser_tpu_torch._internal.models import emotion_model

    monkeypatch.setattr(emotion_model, "load_model", lambda **_: artifacts.LoadedModel(model=None, expected_feature_size=193))
    settings = build_settings({"SER_TORCH_DEVICE": "cpu"})
    request = InferenceRequest(file_path="clip.wav", language="en")
    for raised, expected in ((RuntimeError("boom"), errors.InferenceExecutionError), (ValueError("bad"), ValueError)):
        monkeypatch.setattr(emotion_model, "predict_emotions_detailed", lambda *_a, _e=raised, **_k: (_ for _ in ()).throw(_e))
        with pytest.raises(expected):
            fast_boundary.run_fast_inference(request, settings=settings)


# --------------------------------------------------------------------------- #
# A spawned worker on the CPU
# --------------------------------------------------------------------------- #


def _write_tiny_head(path: Path, feature_size: int) -> None:
    rng = np.random.default_rng(5)
    labels = ["angry", "happy", "neutral", "sad"]
    state = {
        "kind": "ser_tpu_mlp", "hidden_layer_sizes": [16], "alpha": 0.01, "batch_size": 256, "epsilon": 1e-8,
        "max_iter": 500, "random_state": 42, "classes": labels,
        "weights": [rng.standard_normal((feature_size, 16)).astype(np.float32),
                    rng.standard_normal((16, len(labels))).astype(np.float32)],
        "biases": [np.zeros(16, np.float32), np.zeros(len(labels), np.float32)],
        "n_iter": 1, "loss": 1.0,
    }
    metadata = artifacts.build_artifact_metadata(
        feature_vector_size=feature_size, training_samples=8, labels=labels, backend_id="jax_whisper_encoder",
        profile="accurate", pooling_strategy="mean_std", backend_model_id="openai/whisper-large-v3",
    )
    artifacts.save_model_artifact(artifacts.build_model_artifact(state, metadata), path)


def test_isolated_accurate_attempt_runs_in_a_spawned_worker(tmp_path, monkeypatch) -> None:
    """The isolated request's worker rebuilds its settings from the environment
    (tiny random-init Whisper on the CPU) and returns the in-process request's result."""
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name

    _write_tiny_head(
        tmp_path / "models" / profile_artifact_file_name(profile="accurate", model_id="openai/whisper-large-v3"),
        feature_size=2 * 64,
    )
    clip = tmp_path / "clip.wav"
    t = np.arange(16000 * 4) / 16000
    write_wav(clip, (0.3 * np.sin(2 * np.pi * 330 * t) * (1 + np.sin(t))).astype(np.float32), 16000)
    env = {"SER_TORCH_DEVICE": "cpu", "SER_ENABLE_ACCURATE_PROFILE": "1", "SER_MODELS_FOLDER": str(tmp_path / "models"),
           "SER_CACHE_DIR": str(tmp_path / "cache"), "SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": "tiny",
           "PYTHONPATH": str(REPO_ROOT)}
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.chdir(REPO_ROOT)
    in_process = torch_api.infer(clip, profile="accurate", include_transcript=False, settings=build_settings())
    spawned_calls = []
    real_spawn = pb.worker_lifecycle.run_attempt_in_spawned_process
    monkeypatch.setattr(
        pb.worker_lifecycle, "run_attempt_in_spawned_process",
        lambda **kwargs: spawned_calls.append(kwargs) or real_spawn(**kwargs),
    )
    monkeypatch.setenv("SER_ACCURATE_PROCESS_ISOLATION", "1")
    isolated = torch_api.infer(clip, profile="accurate", include_transcript=False, settings=build_settings())
    assert len(spawned_calls) == 1
    _assert_same_result(isolated.detailed_result, in_process.detailed_result)
