"""Process-isolated transcription and the worker lifecycle of the port, against ``ser_tpu``.

The JAX package's cases (``tests/suites/unit/transcript/test_process_isolation.py``):
isolation is off by default, an opt-out never isolates, the opt-in is
honoured on the CPU, and words cross the spawn boundary intact. The port's
own: the opt-in is ignored when the transcript runs on a CUDA card (the card
is monkeypatched in), a worker's errors come back typed under the JAX
package's wire names, a compute timeout stops the worker, and the in-process
runner's soft timeout. The device OOM parser reads the JAX package's XLA
messages as it does, and CUDA's.
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from ser_tpu._internal.config.bootstrap import reload_settings as jax_reload_settings
from ser_tpu._internal.runtime import errors as jax_errors
from ser_tpu._internal.runtime import oom as jax_oom
from ser_tpu._internal.transcript.process_isolation import (
    should_use_process_isolated_path as jax_should_isolate,
)
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.runtime import errors, oom, worker_lifecycle
from ser_tpu_torch._internal.transcript.process_isolation import (
    run_isolated_transcription,
    should_use_process_isolated_path,
)
from ser_tpu_torch.domain import TranscriptWord


def _settings(*, isolation: bool, device: str = "cpu") -> AppConfig:
    base = build_settings({"SER_TORCH_DEVICE": device})
    return dataclasses.replace(base, transcription=dataclasses.replace(base.transcription, process_isolation=isolation))


def test_disabled_by_default() -> None:
    assert build_settings({}).transcription.process_isolation is False
    assert jax_reload_settings().transcription.process_isolation is False
    assert build_settings({}).transcription.isolation_timeout_seconds == jax_reload_settings().transcription.isolation_timeout_seconds


def test_opt_out_never_isolates() -> None:
    assert should_use_process_isolated_path("jax_whisper", settings=_settings(isolation=False)) is False


def test_opt_in_honored_on_the_cpu_as_in_ser_tpu() -> None:
    jax_settings = jax_reload_settings()
    jax_settings = dataclasses.replace(
        jax_settings, transcription=dataclasses.replace(jax_settings.transcription, process_isolation=True)
    )
    assert jax_should_isolate("jax_whisper", settings=jax_settings) is True  # JAX on its CPU backend here
    assert should_use_process_isolated_path("jax_whisper", settings=_settings(isolation=True)) is True


@pytest.mark.parametrize("device", ["auto", "cuda", "cuda:0"])
def test_opt_in_is_ignored_on_a_cuda_card(monkeypatch, device) -> None:
    """The JAX package never isolates an accelerator run; on the card the opt-in is ignored the same way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert should_use_process_isolated_path("jax_whisper", settings=_settings(isolation=True, device=device)) is False


def _setup():
    return "ready"


def _transcribe(context):
    assert context == "ready"  # compute receives setup's result
    return [TranscriptWord(word="hello", start_seconds=0.0, end_seconds=0.4)]


def test_words_cross_the_process_boundary_intact() -> None:
    words = run_isolated_transcription(setup=_setup, transcribe=_transcribe, timeout_seconds=120.0, backend_id="jax_whisper")
    assert [word.word for word in words] == ["hello"]
    assert words[0].end_seconds == 0.4 and isinstance(words[0], TranscriptWord)


def _setup_unavailable():
    raise errors.ModelUnavailableError("no staged weights")


def _sleep(context):
    time.sleep(60.0)


def _child_start_method(context):
    import multiprocessing

    return multiprocessing.get_start_method()


def test_worker_errors_come_back_typed() -> None:
    with pytest.raises(errors.ModelUnavailableError, match="no staged weights") as raised:
        worker_lifecycle.run_attempt_in_spawned_process(
            setup=_setup_unavailable, compute=_transcribe, timeout_seconds=60.0, profile="transcription:jax_whisper"
        )
    assert raised.value.profile == "transcription:jax_whisper"


def test_compute_timeout_stops_the_worker_and_the_child_is_spawned() -> None:
    assert worker_lifecycle.run_attempt_in_spawned_process(
        setup=_setup, compute=_child_start_method, timeout_seconds=60.0, profile="p"
    ) == "spawn"
    started = time.perf_counter()
    with pytest.raises(errors.InferenceTimeoutError, match="exceeded 1.0s"):
        worker_lifecycle.run_attempt_in_spawned_process(setup=_setup, compute=_sleep, timeout_seconds=1.0, profile="p")
    assert time.perf_counter() - started < 30.0


def test_in_process_soft_timeout() -> None:
    assert worker_lifecycle.run_attempt_in_process(setup=_setup, compute=lambda c: c + "!", timeout_seconds=5.0, profile="p") == "ready!"
    with pytest.raises(errors.InferenceTimeoutError):
        worker_lifecycle.run_attempt_in_process(setup=_setup, compute=lambda c: time.sleep(2.0), timeout_seconds=0.2, profile="p")


@pytest.mark.parametrize(
    "error",
    [
        errors.ModelUnavailableError("a"),
        errors.RuntimeDependencyError("b"),
        errors.ModelLoadError("c"),
        errors.InferenceTimeoutError("d"),
        errors.TransientInferenceError("e", hard_oom=True),
        errors.InferenceExecutionError("f"),
        ValueError("g"),
    ],
)
def test_error_wire_names_match_ser_tpu(error) -> None:
    kind = errors.error_kind(error)
    jax_twin = getattr(jax_errors, type(error).__name__, ValueError)("x")
    assert kind == jax_errors.error_kind(jax_twin)
    rebuilt = errors.rehydrate_error(kind, "msg", profile="p")
    assert type(rebuilt).__name__ == type(jax_errors.rehydrate_error(kind, "msg")).__name__ and rebuilt.profile == "p"


@pytest.mark.parametrize(
    "message",
    [
        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 8589934592 bytes.",
        "Attempting to allocate 16.6G. That was not possible. There are 2.1G free.",
        "XLA:TPU compile permanent error. Ran out of memory in memory space hbm. Used 15.48GiB of 15.75GiB hbm.",
        "requested: 2.1 MB, available: 512 KB, limit=16 GB",
        "file ROOM_101.wav not found",
        "some unrelated failure",
    ],
)
def test_oom_parser_reads_xla_messages_as_ser_tpu(message) -> None:
    assert oom.is_device_oom(message) == jax_oom.is_device_oom(message)
    assert dataclasses.astuple(oom.parse_device_oom(message)) == dataclasses.astuple(jax_oom.parse_device_oom(message))


def test_oom_parser_reads_cuda_messages() -> None:
    message = (
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of 79.19 GiB of which "
        "1.20 GiB is free. Including non-PyTorch memory, this process has 77.98 GiB memory in use."
    )
    info = oom.parse_device_oom(message)
    assert oom.is_device_oom(message) and oom.is_device_oom(torch.cuda.OutOfMemoryError("x"))
    assert info.requested_bytes == 2 * 1024**3 and info.available_bytes == int(1.20 * 1024**3)
    assert info.limit_bytes == int(79.19 * 1024**3) and info.is_informative
    assert oom.is_device_oom("CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate(handle)")


def test_emotion_pass_isolation_knob_raises_instead_of_running_in_process() -> None:
    """``SER_<PROFILE>_PROCESS_ISOLATION`` reads as in the JAX package; the port's
    emotion boundary has no spawned attempt yet and refuses it."""
    from ser_tpu_torch._internal.runtime.profile_boundary import ProfileBoundarySpec, run_profile_inference
    from ser_tpu_torch.runtime.contracts import InferenceRequest

    settings = build_settings({"SER_ACCURATE_PROCESS_ISOLATION": "1", "SER_TORCH_DEVICE": "cpu"})
    assert settings.accurate_runtime.process_isolation is True
    built = []
    spec = ProfileBoundarySpec(
        profile="accurate", backend_id="jax_whisper_encoder", model_id=None,
        backend_factory=lambda settings: built.append(settings), artifact_file_name="head.pkl",
    )
    with pytest.raises(NotImplementedError, match="Process isolation of the 'accurate' emotion pass"):
        run_profile_inference(InferenceRequest(file_path="clip.wav", language="en"), spec=spec, settings=settings)
    assert built == []
