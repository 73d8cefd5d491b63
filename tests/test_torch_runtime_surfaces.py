"""The port's runtime surfaces against ``ser_tpu``'s, on the CPU.

Held exactly: the registry's capability for each profile under each hook set
(availability, backend, message); ``ensure_profile_supported``'s refusal (the
port's class is the one its pipeline raises); the HF and ModelScope
environment plan for the same settings, and ``temporary_process_env``'s
restore; the exit code of each exception class in each workflow, and
``run_command``'s; ``run_latency_benchmark``'s statistics on fixed timings
(bit for bit, the nearest-rank p95 included); ``list_profiles`` and
``load_profile`` on the same settings (which profiles pass, which refuse), and
the scoped settings a workflow's pipeline builder sees; the ``utils`` facade.
``device_trace`` writes a Chrome trace naming a ``span`` inside it.
"""

from __future__ import annotations

import dataclasses
import json
import os

import pytest

from ser_tpu._internal.api import runtime as jax_runtime_api
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs as jax_build
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs as jax_capture
from ser_tpu._internal.runtime import benchmarks as jax_benchmarks
from ser_tpu._internal.runtime import commands as jax_commands
from ser_tpu._internal.runtime import environment_plan as jax_plan
from ser_tpu._internal.runtime import registry as jax_registry
from ser_tpu_torch._internal.api import runtime as runtime_api
from ser_tpu_torch._internal.config.bootstrap import build_settings, get_settings
from ser_tpu_torch._internal.runtime import benchmarks, commands, environment_plan, errors, registry

PROFILES = ("fast", "medium", "accurate", "accurate-research")
BACKENDS = ("handcrafted", "jax_xlsr", "jax_whisper_encoder", "emotion2vec")


@pytest.fixture
def env(tmp_path) -> dict[str, str]:
    return {"SER_CACHE_DIR": str(tmp_path / "cache"), "SER_DATA_DIR": str(tmp_path / "data"),
            "SER_TORCH_DEVICE": "cpu"}


@pytest.mark.parametrize("hooks", [None, (), BACKENDS[:1], BACKENDS], ids=["no-registry", "none", "fast", "all"])
@pytest.mark.parametrize("profile", PROFILES)
def test_capability_matches(profile: str, hooks) -> None:
    available = None if hooks is None else frozenset(hooks)
    ours = registry.resolve_runtime_capability(profile, available_hooks=available)
    theirs = jax_registry.resolve_runtime_capability(profile, available_hooks=available)
    assert (ours.profile, ours.backend_id, ours.available, ours.message) == (
        theirs.profile, theirs.backend_id, theirs.available, theirs.message)
    if not ours.available:
        with pytest.raises(errors.UnsupportedProfileError, match=ours.message.split(" backend")[0]):
            registry.ensure_profile_supported(ours)
        with pytest.raises(jax_registry.UnsupportedProfileError):
            jax_registry.ensure_profile_supported(theirs)


def test_missing_module_reported_alike(monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setattr(registry, "_module_available", lambda name: False)
    monkeypatch.setattr(jax_registry, "_module_available", lambda name: False)
    ours = registry.resolve_runtime_capability("accurate")
    theirs = jax_registry.resolve_runtime_capability("accurate")
    assert (ours.available, ours.missing_modules) == (False, ("torch",))
    assert theirs.available is False and ours.message.split(":")[0] == theirs.message.split(":")[0]
    # The fast profile needs no module in either package.
    assert registry.resolve_runtime_capability("fast").available
    assert jax_registry.resolve_runtime_capability("fast").available


def test_unsupported_profile_is_one_class() -> None:
    from ser_tpu_torch._internal.runtime import pipeline

    assert registry.UnsupportedProfileError is errors.UnsupportedProfileError is pipeline.UnsupportedProfileError


def test_environment_plan_and_restore(env: dict[str, str], monkeypatch: pytest.MonkeyPatch) -> None:
    ours = environment_plan.build_runtime_environment_plan(build_settings(env))
    theirs = jax_plan.build_runtime_environment_plan(jax_build(jax_capture(env=dict(env))))
    assert (ours.set_vars, ours.unset_vars) == (theirs.set_vars, theirs.unset_vars)
    monkeypatch.setenv("HF_HOME", "/before")
    monkeypatch.delenv("MODELSCOPE_CACHE", raising=False)
    monkeypatch.setenv("SER_PLAN_PROBE", "kept")
    plan = environment_plan.RuntimeEnvironmentPlan(
        set_vars={**ours.set_vars, "SER_PLAN_PROBE": "set"}, unset_vars=("SER_PLAN_PROBE", "HF_HOME")
    )
    with environment_plan.temporary_process_env(plan):
        assert os.environ["MODELSCOPE_CACHE"] == ours.set_vars["MODELSCOPE_CACHE"]
        assert "SER_PLAN_PROBE" not in os.environ and "HF_HOME" not in os.environ
    assert os.environ["HF_HOME"] == "/before" and os.environ["SER_PLAN_PROBE"] == "kept"
    assert "MODELSCOPE_CACHE" not in os.environ


def _error_pairs() -> list[tuple[str, BaseException, BaseException]]:
    from ser_tpu._internal.models import training_orchestration as jax_orchestration
    from ser_tpu._internal.models import training_readiness as jax_readiness
    from ser_tpu._internal.runtime import errors as jax_errors
    from ser_tpu._internal.runtime import restricted_backends as jax_restricted
    from ser_tpu._internal.transcript import extractor as jax_extractor
    from ser_tpu_torch._internal.models import training_orchestration, training_readiness
    from ser_tpu_torch._internal.runtime import restricted_backends
    from ser_tpu_torch._internal.transcript import extractor

    pairs = [
        ("FileNotFoundError", FileNotFoundError("x"), FileNotFoundError("x")),
        ("UnsupportedProfileError", errors.UnsupportedProfileError("x"), jax_registry.UnsupportedProfileError("x")),
        ("RestrictedBackendError", restricted_backends.RestrictedBackendError("x"),
         jax_restricted.RestrictedBackendError("x")),
        ("TranscriptionError", extractor.TranscriptionError("x"), jax_extractor.TranscriptionError("x")),
        ("TrainingNotReadyError", training_orchestration.TrainingNotReadyError("x"),
         jax_orchestration.TrainingNotReadyError("x")),
        ("QuarantineBudgetExceeded", training_orchestration.QuarantineBudgetExceeded("x"),
         jax_orchestration.QuarantineBudgetExceeded("x")),
        ("PreparedPlanError", training_readiness.PreparedPlanError("x"), jax_readiness.PreparedPlanError("x")),
        ("ValueError", ValueError("x"), ValueError("x")),
        ("RuntimeError", RuntimeError("x"), RuntimeError("x")),
        ("OSError", OSError("x"), OSError("x")),
    ]
    for name in ("ModelUnavailableError", "RuntimeDependencyError", "ModelLoadError", "InferenceTimeoutError",
                 "TransientInferenceError", "InferenceExecutionError"):
        pairs.append((name, getattr(errors, name)("x"), getattr(jax_errors, name)("x")))
    return pairs


@pytest.mark.parametrize("workflow", ["general", "inference", "training"])
def test_exit_codes_match(workflow: str) -> None:
    codes = {}
    for name, ours, theirs in _error_pairs():
        code = commands.classify_exit_code(ours, workflow=workflow)
        assert code == jax_commands.classify_exit_code(theirs, workflow=workflow), name
        codes[name] = code
    expected_two = {"inference": {"FileNotFoundError", "UnsupportedProfileError", "RestrictedBackendError",
                                  "RuntimeDependencyError", "ModelLoadError", "ModelUnavailableError",
                                  "InferenceTimeoutError"},
                    "training": {"TrainingNotReadyError", "QuarantineBudgetExceeded", "PreparedPlanError"}}
    expected_two["general"] = expected_two["inference"] | {"ValueError", "PreparedPlanError"}
    assert {name for name, code in codes.items() if code == commands.EXIT_VALIDATION} == expected_two[workflow]
    if workflow != "training":
        assert codes["TranscriptionError"] == commands.EXIT_TRANSCRIPTION == 3


def test_run_command_matches() -> None:
    def raising(error):
        def operation():
            raise error
        return operation

    assert commands.run_command(lambda: 7, label="ok") == jax_commands.run_command(lambda: 7, label="ok") == (7, 0)
    unsupported = commands.run_command(raising(errors.UnsupportedProfileError("x")), label="p", workflow="inference")
    assert unsupported == jax_commands.run_command(
        raising(jax_registry.UnsupportedProfileError("x")), label="p", workflow="inference") == (None, 2)
    assert commands.run_command(raising(KeyboardInterrupt()), label="k") == (None, 1)
    assert jax_commands.run_command(raising(KeyboardInterrupt()), label="k") == (None, 1)


class _FixedClock:
    """``time.perf_counter`` that returns a fixed sequence."""

    def __init__(self, stamps: list[float]) -> None:
        self._stamps = iter(stamps)

    def perf_counter(self) -> float:
        return next(self._stamps)


@pytest.mark.parametrize("durations", [[0.5], [0.3, 0.1, 0.2, 0.5, 0.4], [0.01 * (i % 7 + 1) for i in range(23)]],
                         ids=["one", "five", "twenty-three"])
def test_latency_statistics_bit_for_bit(durations: list[float], monkeypatch: pytest.MonkeyPatch) -> None:
    stamps = []
    start = 10.0
    for duration in durations:
        stamps += [start, start + duration]
        start += 1.0
    reports = []
    for module in (benchmarks, jax_benchmarks):
        monkeypatch.setattr(module, "time", _FixedClock(list(stamps)))
        calls = []
        reports.append(module.run_latency_benchmark(lambda: calls.append(1), runs=len(durations), warmup_runs=2))
        assert len(calls) == len(durations) + 2
    ours, theirs = reports
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.to_json() == theirs.to_json()
    assert ours.p95_seconds == sorted(stamps[1::2][i] - stamps[0::2][i] for i in range(len(durations)))[
        min(len(durations) - 1, int(round(0.95 * (len(durations) - 1))))]
    with pytest.raises(ValueError):
        benchmarks.run_latency_benchmark(lambda: None, runs=0)


def test_list_profiles_matches() -> None:
    import ser_tpu.api as jax_api
    import ser_tpu_torch.api as api

    assert api.list_profiles() == jax_api.list_profiles() == PROFILES


@pytest.mark.parametrize("gate", ["shut", "open"])
@pytest.mark.parametrize("profile", PROFILES)
def test_load_profile_matches(profile: str, gate: str, env: dict[str, str]) -> None:
    if gate == "open":
        env = {**env, "SER_ENABLE_RESTRICTED_BACKENDS": "1", "SER_ALLOWED_RESTRICTED_BACKENDS": "emotion2vec"}
    outcomes = []
    for load, settings, error in (
        (runtime_api.load_profile, build_settings(env), errors.UnsupportedProfileError),
        (jax_runtime_api.load_profile, jax_build(jax_capture(env=dict(env))), jax_registry.UnsupportedProfileError),
    ):
        try:
            load(profile, settings=settings)
            outcomes.append("ok")
        except error as err:
            outcomes.append(str(err))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] == "ok") == (profile != "accurate-research" or gate == "open")


def test_workflow_runs_under_its_settings(env: dict[str, str]) -> None:
    settings = build_settings(env)
    seen = {}

    class _Pipeline:
        def __init__(self, built_with):
            seen["built_with"] = built_with

        def run_inference(self, request):
            seen["scoped"] = get_settings()
            seen["request"] = request
            return "execution"

        def run_training(self):
            seen["trained_under"] = get_settings()

    assert runtime_api.infer("clip.wav", profile="medium", settings=settings, pipeline_builder=_Pipeline) == "execution"
    assert seen["scoped"] is seen["built_with"]
    assert seen["scoped"].runtime_flags.medium_profile and seen["request"].language == settings.default_language
    assert get_settings() is not seen["scoped"]
    runtime_api.train(profile="fast", settings=settings, pipeline_builder=_Pipeline)
    assert seen["trained_under"].runtime_flags.profile_pipeline


def test_utils_facade_matches() -> None:
    import ser_tpu.utils as jax_utils
    import ser_tpu_torch.utils as utils

    assert utils.__all__ == jax_utils.__all__
    for seconds in (0.0, 5.257, 59.994, 61.5, 3725.0):
        for style in ("long", "short"):
            assert utils.display_elapsed_time(seconds, style) == jax_utils.display_elapsed_time(seconds, style)
    with pytest.raises(AttributeError):
        utils.not_a_helper  # noqa: B018


def test_device_trace_writes_a_chrome_trace(tmp_path) -> None:
    import torch

    from ser_tpu_torch._internal.utils.profiling import TRACE_FILE_NAME, device_trace, span

    with device_trace(tmp_path / "trace"):
        with span("operator-span"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "trace" / TRACE_FILE_NAME).read_text())
    assert any(event.get("name") == "operator-span" for event in trace["traceEvents"])
