"""The timeline's CSV and subtitle export of the port against ``ser_tpu``, on the CPU.

- the subtitle functions (format inference, export-request resolution and
  its refusals, cues, ASS/SRT/VTT rendering) give the JAX package's results,
  and both packages' writers give the same bytes for one timeline;
- the slice as a whole: ``api.infer(include_transcript=True,
  save_transcript=True, subtitle_output_path=...)`` on a tiny staged Whisper
  checkpoint (``tests/test_torch_transcription.py``'s), with the accurate
  profile's ``use_demucs`` on and a staged U-Net separator checkpoint
  (``SER_SEPARATION_MODEL_PATH``, weights the port drew), writes a CSV and an
  SRT file byte-equal to ``ser_tpu.api.infer``'s from the same environment,
  and its timeline's VTT and ASS renderings are byte-equal too;
- ``SER_TRANSCRIPTS_FOLDER`` and ``SER_DATA_DIR`` place the exports as in the
  JAX package;
- a blank subtitle path, or a path whose format cannot be inferred, is
  refused before any compute.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import ser_tpu.api as jax_api
import ser_tpu_torch.api as torch_api
from ser_tpu._internal.config.schema import profile_artifact_file_names
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.transcript import base as jax_base
from ser_tpu._internal.transcript import extractor as jax_extractor
from ser_tpu._internal.utils import source_separation as jax_separation
from ser_tpu._internal.utils import subtitles as jax_subtitles
from ser_tpu._internal.utils import timeline as jax_timeline
from ser_tpu._internal.utils.audio_io import write_wav
from ser_tpu.domain import TimelineEntry as JaxTimelineEntry
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.config.schema import TimelineConfig
from ser_tpu_torch._internal.runtime import pipeline
from ser_tpu_torch._internal.utils import source_separation, subtitles, timeline
from ser_tpu_torch.domain import TimelineEntry
from ser_tpu_torch.models import separation

from test_torch_transcription import MODEL_ID, _write_head_artifact, build_whisper_checkpoint

ROWS = [
    (0.0, "neutral", ""),
    (0.42, "neutral", "hello there"),
    (1.5, "happy", "general\nkenobi"),
    (1.5, "", "  "),
    (3.004, "sad", "a, \"quoted\" word"),
    (3726.5, "angry", "late"),
]


def _timelines():
    return [TimelineEntry(*row) for row in ROWS], [JaxTimelineEntry(*row) for row in ROWS]


@pytest.mark.parametrize("path", ["out.srt", "OUT.VTT", "x/y.ass", "clip.txt", "noext", ".srt"])
def test_format_inference_matches_jax(path) -> None:
    assert subtitles.infer_subtitle_format(path) == jax_subtitles.infer_subtitle_format(path)


@pytest.mark.parametrize(
    "output_path, subtitle_format",
    [(None, None), ("a.srt", None), ("a.srt", "vtt"), (None, "ass"), (" b.vtt ", None),
     ("", None), ("   ", "srt"), ("a.txt", None), ("a.srt", "sub"), (None, "SRT")],
)
def test_export_request_matches_jax(output_path, subtitle_format) -> None:
    kwargs = {"output_path": output_path, "subtitle_format": subtitle_format}
    try:
        expected = jax_subtitles.resolve_subtitle_export_request(**kwargs)
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            subtitles.resolve_subtitle_export_request(**kwargs)
        assert str(ours.value) == str(err)
    else:
        assert subtitles.resolve_subtitle_export_request(**kwargs) == expected


def test_cues_match_jax() -> None:
    ours, ref = _timelines()
    assert [dataclasses.astuple(c) for c in subtitles.timeline_to_subtitle_cues(ours)] == [
        dataclasses.astuple(c) for c in jax_subtitles.timeline_to_subtitle_cues(ref)
    ]
    assert subtitles.timeline_to_subtitle_cues(ours, default_duration_seconds=2.5)[-1].end_seconds == 3729.0
    with pytest.raises(ValueError, match="positive"):
        subtitles.timeline_to_subtitle_cues(ours, default_duration_seconds=0.0)


@pytest.mark.parametrize("fmt", ["ass", "srt", "vtt"])
@pytest.mark.parametrize("empty", [False, True], ids=["rows", "empty"])
def test_subtitle_files_are_byte_equal(tmp_path, fmt, empty) -> None:
    ours, ref = ([], []) if empty else _timelines()
    ours_path = subtitles.save_timeline_to_subtitles(ours, "clip.wav", subtitle_format=fmt,
                                                     output_path=str(tmp_path / "port" / f"clip.{fmt}"))
    ref_path = jax_subtitles.save_timeline_to_subtitles(ref, "clip.wav", subtitle_format=fmt,
                                                        output_path=str(tmp_path / "jax" / f"clip.{fmt}"))
    assert open(ours_path, "rb").read() == open(ref_path, "rb").read()
    assert subtitles._render(subtitles.timeline_to_subtitle_cues(ours), fmt) == jax_subtitles._render(
        jax_subtitles.timeline_to_subtitle_cues(ref), fmt
    )
    # Without a path the file goes to the timeline folder, named after the audio.
    folder = subtitles.save_timeline_to_subtitles(ours, "/audio/clip.wav", subtitle_format=fmt,
                                                  timeline_config=TimelineConfig(folder=tmp_path / "folder"))
    assert folder == str(tmp_path / "folder" / f"clip.{fmt}")


def test_csv_is_byte_equal(tmp_path) -> None:
    ours, ref = _timelines()
    from ser_tpu._internal.config.schema import TimelineConfig as JaxTimelineConfig

    ours_path = timeline.save_timeline_to_csv(ours, "/a/clip.wav", timeline_config=TimelineConfig(folder=tmp_path / "p"))
    ref_path = jax_timeline.save_timeline_to_csv(ref, "/a/clip.wav",
                                                 timeline_config=JaxTimelineConfig(folder=tmp_path / "j"))
    assert ours_path == str(tmp_path / "p" / "clip.csv")
    assert open(ours_path, "rb").read() == open(ref_path, "rb").read()


@pytest.mark.parametrize(
    "env",
    [{}, {"SER_TRANSCRIPTS_FOLDER": "/t/a"}, {"SER_TRANSCRIPTS_DIR": "/t/b"}, {"SER_DATA_DIR": "/t/data"},
     {"SER_DATA_DIR": "/t/data", "SER_TRANSCRIPTS_FOLDER": "~/t"}],
)
def test_timeline_folder_reads_like_jax(env) -> None:
    ours = build_settings(env).timeline.folder
    assert ours == build_settings_from_inputs(capture_settings_inputs(env)).timeline.folder


# --------------------------------------------------------------------------- #
# The slice: api.infer with the transcript, neural separation and both exports
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def staged(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("export")
    cache, models = root / "cache", root / "models"
    build_whisper_checkpoint(cache / "model-cache" / "huggingface" / MODEL_ID)
    build_whisper_checkpoint(cache / "model-cache" / "OpenAI" / "whisper" / "large")
    _write_head_artifact(models / profile_artifact_file_names(profile="accurate", accurate_model_id=MODEL_ID)[0])
    config = separation.SeparatorConfig.tiny()
    separator = root / "unet.npz"
    separation.save_separator_params(separation.init_separator_params(config, seed=2), separator, config=config)
    rng = np.random.default_rng(3)
    t = np.arange(int(12.0 * 22050)) / 22050
    mix = 0.5 + 0.5 * np.sin(2 * np.pi * t / 7.0)
    audio = mix * np.sin(2 * np.pi * 220 * t) + (1 - mix) * 0.5 * rng.standard_normal(t.size)
    clip = root / "clip.wav"
    write_wav(clip, (0.8 * audio / np.abs(audio).max()).astype(np.float32), 22050)
    env = {
        "SER_ENABLE_ACCURATE_PROFILE": "1",
        "SER_MODELS_FOLDER": str(models),
        "SER_CACHE_DIR": str(cache),
        "SER_TORCH_DEVICE": "cpu",
        "SER_SEPARATION_MODEL_PATH": str(separator),
    }
    return {"env": env, "clip": clip, "root": root}


@pytest.fixture(scope="module")
def exports(staged) -> dict:
    runs = {}
    for name in ("jax", "port"):
        env = {**staged["env"], "SER_TRANSCRIPTS_FOLDER": str(staged["root"] / name)}
        kwargs = dict(profile="accurate", include_transcript=True, save_transcript=True,
                      subtitle_output_path=str(staged["root"] / name / "subs" / "clip.srt"))
        if name == "jax":
            jax_separation._NEURAL_PARAM_CACHE.clear()
            with pytest.MonkeyPatch.context() as patch:
                # The port's CPU dtype is float32; the JAX lane would ask for bfloat16 first.
                patch.setattr(
                    jax_extractor,
                    "_runtime_request",
                    lambda resolved, settings: jax_base.BackendRuntimeRequest(
                        model_name=resolved.model_name, use_demucs=resolved.use_demucs, use_vad=resolved.use_vad,
                        precision_candidates=("float32",),
                    ),
                )
                runs[name] = jax_api.infer(staged["clip"], settings=build_settings_from_inputs(
                    capture_settings_inputs(env)), **kwargs)
            jax_separation._NEURAL_PARAM_CACHE.clear()
        else:
            separated: list[int] = []
            with pytest.MonkeyPatch.context() as patch:
                neural = separation.separate_vocals_neural
                patch.setattr(separation, "separate_vocals_neural",
                              lambda *a, **k: separated.append(1) or neural(*a, **k))
                runs[name] = torch_api.infer(staged["clip"], settings=build_settings(env), **kwargs)
            runs["separated"] = len(separated)
    return runs


def test_infer_exports_are_byte_equal_to_jax(exports, staged) -> None:
    ours, ref = exports["port"], exports["jax"]
    assert exports["separated"] == 1, "the staged U-Net did not separate the transcript's audio"
    assert any(entry.speech for entry in ours.timeline)
    assert [tuple(e) for e in ours.timeline] == [tuple(e) for e in ref.timeline]
    assert ours.timeline_csv_path == str(staged["root"] / "port" / "clip.csv")
    assert ours.subtitle_path == str(staged["root"] / "port" / "subs" / "clip.srt")
    for attribute in ("timeline_csv_path", "subtitle_path"):
        assert open(getattr(ours, attribute), "rb").read() == open(getattr(ref, attribute), "rb").read()
    assert "timeline_output" in ours.phase_timings_seconds
    rows = open(ours.timeline_csv_path, encoding="utf-8").read().splitlines()
    assert rows[0] == "Time (s),Emotion,Speech" and len(rows) == len(ours.timeline) + 1


@pytest.mark.parametrize("fmt", ["vtt", "ass"])
def test_infer_timeline_renders_byte_equal(exports, tmp_path, fmt) -> None:
    ours = subtitles.save_timeline_to_subtitles(exports["port"].timeline, "clip.wav", subtitle_format=fmt,
                                                output_path=str(tmp_path / f"port.{fmt}"))
    ref = jax_subtitles.save_timeline_to_subtitles(exports["jax"].timeline, "clip.wav", subtitle_format=fmt,
                                                   output_path=str(tmp_path / f"jax.{fmt}"))
    assert open(ours, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("options, match", [
    ({"subtitle_output_path": "   "}, "blank"),
    ({"subtitle_output_path": "clip.txt"}, "Cannot infer"),
    ({"subtitle_format": "sub"}, "not supported"),
])
def test_bad_subtitle_request_is_refused_before_compute(staged, monkeypatch, options, match) -> None:
    calls: list[str] = []
    monkeypatch.setattr(pipeline, "extract_transcript", lambda *a, **k: calls.append("transcript") or [])
    monkeypatch.setattr(pipeline, "build_backend_hooks", lambda settings: calls.append("hooks") or {})
    monkeypatch.setattr(source_separation, "separate_vocals_auto", lambda *a, **k: calls.append("separate"))
    with pytest.raises(ValueError, match=match):
        torch_api.infer(staged["clip"], profile="accurate", settings=build_settings(staged["env"]), **options)
    assert calls == ["hooks"]  # the pipeline is built; nothing runs
