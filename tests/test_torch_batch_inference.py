"""The port's ``infer_many`` against ``ser_tpu.parallel.batch_inference.infer_many``, on the CPU.

The medium profile on tiny random-init XLS-R: ``ser_tpu``'s backend holds
``Wav2Vec2Config.tiny()`` weights drawn from a seed (``jax.jit(model.init)``,
as ``tests/test_torch_xlsr_backend.py`` draws them, which is far quicker than
the backend's own ``SER_ALLOW_RANDOM_INIT`` draw), and they are carried
across with ``convert.py`` into the port's backend; each package's
``build_encoder_backend`` hands its backend to its ``infer_many``. Four clips (0.8 s and 1.5 s at
16 kHz, 1.7 s and 1.9 s at 22.05 kHz: ``chunked_encode_many`` batches the
last three together in the 2 s bucket and the first alone in the 1 s
bucket, each batch padded to its bucket's fixed row count), a corrupt WAV
and a missing path:

- row for row: the same files, the same contained errors, the same segments
  (labels and times), frame probabilities within 1e-5 (that file's
  tolerance), float32 on both sides;
- the gates: a disabled profile, a shut restricted-backend gate and the fast
  profile are refused as ``ser_tpu`` refuses them;
- a gloo world of 2 (each rank every second file, the rows gathered in
  input order) gives the rows of one process.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pickle
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu._internal.config.schema import profile_artifact_file_names
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.models import artifacts as jax_artifacts
from ser_tpu._internal.repr import encoders as jax_encoders
from ser_tpu._internal.repr.wav2vec2_backend import XlsrBackend as JaxXlsrBackend
from ser_tpu._internal.runtime.restricted_backends import RestrictedBackendError as JaxRestrictedBackendError
from ser_tpu._internal.utils.audio_io import write_wav
from ser_tpu.models import wav2vec2 as jax_w2v
from ser_tpu.models.mlp_head import JaxMLPClassifier
from ser_tpu.parallel.batch_inference import infer_many as jax_infer_many
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.pool import mean_std_pool, temporal_pooling_windows
from ser_tpu_torch._internal.repr import encoders
from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend
from ser_tpu_torch._internal.runtime.restricted_backends import RestrictedBackendError
from ser_tpu_torch._internal.utils.audio_io import read_audio_file
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import wav2vec2 as w2v
from ser_tpu_torch.parallel.batch_inference import infer_many
from ser_tpu_torch.scripts import evaluate_profile
from test_torch_distributed_config import REPO, run_world

MODEL_ID = "facebook/wav2vec2-xls-r-300m"
LABELS = ["angry", "happy", "neutral", "sad"]
PROBABILITY_ATOL = 1e-5
CLIPS = ((0.8, 16000), (1.7, 22050), (1.9, 22050), (1.5, 16000))

_WORKER = textwrap.dedent(
    """
    import pickle
    import sys

    import torch
    import torch.distributed as dist

    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend
    from ser_tpu_torch.models import wav2vec2 as w2v
    from ser_tpu_torch.parallel.batch_inference import infer_many
    from ser_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed

    weights = torch.load(sys.argv[1], weights_only=True)
    backend = XlsrBackend(
        model_id=weights["model_id"], cache_root="/nonexistent", device="cpu", dtype="float32",
        config=w2v.Wav2Vec2Config(**weights["config"]), state=weights["state"],
    )
    encoders.build_encoder_backend = lambda profile, settings: backend
    assert initialize_distributed()
    rows = infer_many(sys.argv[3].split(","), profile="medium")
    if dist.get_rank() == 0:
        with open(sys.argv[2], "wb") as handle:
            pickle.dump(rows, handle)
    shutdown_distributed()
    """
)


def _write_clip(path: Path, seconds: float, sample_rate: int, seed: int) -> None:
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    mix = 0.5 + 0.5 * np.sin(2 * np.pi * t / 5.0)
    noise = np.random.default_rng(seed).standard_normal(t.size)
    audio = mix * np.sin(2 * np.pi * (180 + 60 * seed) * t) + (1 - mix) * 0.5 * noise
    write_wav(path, (0.8 * audio / np.abs(audio).max()).astype(np.float32), sample_rate)


def _write_head(path: Path, feature_mean: np.ndarray) -> None:
    """``test_torch_xlsr_backend.py``'s seeded head at half its gain, centred on the clips' mean pooled features.

    At that file's full gain (8) the head turns the two encoders' float32
    difference on these clips (4.4e-6 at most, against that file's 1e-4)
    into 1.7e-5 of probability, above that file's 1e-5; at 4 it stays below.
    """
    rng = np.random.default_rng(0)
    dims = [feature_mean.size, 32, len(LABELS)]
    weights = [
        (rng.standard_normal((a, b)) * 4.0 * np.sqrt(2.0 / (a + b))).astype(np.float32)
        for a, b in zip(dims[:-1], dims[1:])
    ]
    state = {
        "kind": "ser_tpu_mlp", "hidden_layer_sizes": [32], "alpha": 0.01, "batch_size": 256, "epsilon": 1e-8,
        "max_iter": 500, "random_state": 42, "classes": LABELS, "weights": weights,
        "biases": [(-feature_mean @ weights[0]).astype(np.float32), np.zeros(dims[2], dtype=np.float32)],
        "n_iter": 1, "loss": 1.0,
    }
    metadata = jax_artifacts.build_artifact_metadata(
        feature_vector_size=feature_mean.size, training_samples=8, labels=LABELS, backend_id="jax_xlsr",
        profile="medium", pooling_strategy="mean_std", backend_model_id=MODEL_ID,
    )
    jax_artifacts.save_model_artifact(
        jax_artifacts.build_model_artifact(JaxMLPClassifier.from_state(state), metadata), path
    )


@pytest.fixture(scope="module")
def staged(tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp("batch_infer")
    env = {
        "SER_ENABLE_MEDIUM_PROFILE": "1",
        "SER_MODELS_FOLDER": str(root / "models"),
        "SER_CACHE_DIR": str(root / "cache"),
        "SER_TORCH_DEVICE": "cpu",
    }
    jax_settings = build_settings_from_inputs(capture_settings_inputs(env))
    jax_config = jax_w2v.Wav2Vec2Config.tiny()
    model = jax_w2v.Wav2Vec2Encoder(jax_config)
    params = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.zeros((1, 4000), jnp.float32))["params"]
    reference_backend = JaxXlsrBackend(
        model_id=MODEL_ID, cache_root="/nonexistent", dtype="float32", config=jax_config, params=params
    )
    config = w2v.Wav2Vec2Config(**dataclasses.asdict(jax_config))
    state = convert.wav2vec2_state_dict(params)
    files = []
    for seed, (seconds, rate) in enumerate(CLIPS):
        files.append(root / f"clip_{seed}.wav")
        _write_clip(files[-1], seconds, rate, seed)
    corrupt = root / "corrupt.wav"
    corrupt.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    paths = [str(files[0]), str(corrupt), str(files[1]), str(root / "missing.wav"), str(files[2]), str(files[3])]
    backend = XlsrBackend(
        model_id=MODEL_ID, cache_root="/nonexistent", device="cpu", dtype="float32", config=config, state=state
    )
    pooled = []
    for path in files:
        encoded = backend.encode_sequence(*read_audio_file(str(path)))
        windows = temporal_pooling_windows(encoded, window_size_seconds=1.0, window_stride_seconds=1.0)
        pooled.append(mean_std_pool(encoded, windows))
    _write_head(
        root / "models" / profile_artifact_file_names(profile="medium", medium_model_id=MODEL_ID)[0],
        np.concatenate(pooled).mean(axis=0),
    )
    torch.save(
        {"model_id": MODEL_ID, "config": dataclasses.asdict(config), "state": state}, root / "weights.pt"
    )
    return {
        "env": env, "root": root, "paths": paths, "jax_settings": jax_settings,
        "reference_backend": reference_backend, "backend": backend,
    }


@pytest.fixture(scope="module")
def rows(staged) -> tuple[list, list]:
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_encoders, "build_encoder_backend", lambda *a, **k: staged["reference_backend"])
        patch.setattr(encoders, "build_encoder_backend", lambda profile, settings: staged["backend"])
        reference = jax_infer_many(staged["paths"], profile="medium", settings=staged["jax_settings"])
        ours = infer_many(staged["paths"], profile="medium", settings=build_settings(staged["env"]))
    return reference, ours


def _assert_same_rows(ours, reference) -> None:
    assert [row.file_path for row in ours] == [row.file_path for row in reference]
    for mine, theirs in zip(ours, reference):
        assert (mine.result is None) == (theirs.result is None), mine.file_path
        if theirs.result is None:
            assert mine.error.split(":")[0] == theirs.error.split(":")[0], (mine.error, theirs.error)
            continue
        assert [(s.emotion, s.start_seconds, s.end_seconds) for s in mine.result.segments] == [
            (s.emotion, s.start_seconds, s.end_seconds) for s in theirs.result.segments
        ]
        assert len(mine.result.frames) == len(theirs.result.frames)
        for a, b in zip(mine.result.frames, theirs.result.frames):
            assert (a.start_seconds, a.end_seconds, a.emotion) == (b.start_seconds, b.end_seconds, b.emotion)
            for label, probability in b.probabilities.items():
                assert abs(a.probabilities[label] - probability) <= PROBABILITY_ATOL


def test_infer_many_matches_jax_row_for_row(rows) -> None:
    reference, ours = rows
    _assert_same_rows(ours, reference)
    assert [row.result is None for row in ours] == [False, True, False, True, False, False]
    labels = {segment.emotion for row in ours if row.result for segment in row.result.segments}
    assert len(labels) >= 2, "the clips should exercise more than one label"


def test_corrupt_and_missing_files_are_contained_in_their_rows(rows) -> None:
    _, ours = rows
    assert ours[3].error.startswith("FileNotFoundError")
    assert ours[1].result is None and ours[1].error


def test_gates_refuse_as_jax_refuses(staged) -> None:
    env = staged["env"]
    disabled = {key: value for key, value in env.items() if key != "SER_ENABLE_MEDIUM_PROFILE"}
    with pytest.raises(ValueError, match="disabled"):
        jax_infer_many(["x.wav"], profile="medium", settings=build_settings_from_inputs(capture_settings_inputs(disabled)))
    with pytest.raises(ValueError, match="disabled"):
        infer_many(["x.wav"], profile="medium", settings=build_settings(disabled))
    research = dict(env, SER_ENABLE_ACCURATE_RESEARCH_PROFILE="1")
    with pytest.raises(JaxRestrictedBackendError, match="restricted"):
        jax_infer_many(["x.wav"], profile="accurate-research",
                       settings=build_settings_from_inputs(capture_settings_inputs(research)))
    with pytest.raises(RestrictedBackendError, match="restricted"):
        infer_many(["x.wav"], profile="accurate-research", settings=build_settings(research))
    for run, settings in ((jax_infer_many, staged["jax_settings"]), (infer_many, build_settings(env))):
        with pytest.raises(ValueError, match="fast"):
            run(["x.wav"], profile="fast", settings=settings)


def test_a_world_of_two_gives_the_rows_of_one_process(staged, rows) -> None:
    _, ours = rows
    script = staged["root"] / "worker.py"
    script.write_text(_WORKER)
    out = staged["root"] / "world2.pkl"
    run_world(script, [str(staged["root"] / "weights.pt"), str(out), ",".join(staged["paths"])], 2, staged["env"])
    with open(out, "rb") as handle:
        gathered = pickle.load(handle)
    _assert_same_rows(gathered, ours)


#: RAVDESS emotion codes of the four clips, one per head label (angry, happy, neutral, sad).
_CODES = ("05", "03", "01", "04")


def _load_jax_script():
    spec = importlib.util.spec_from_file_location("jax_evaluate_profile", REPO / "scripts" / "evaluate_profile.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_evaluate_profile_reports_what_the_jax_script_reports(staged, monkeypatch, capsys) -> None:
    """Both ``evaluate_profile`` scripts over the same RAVDESS-named corpus: the same files and metrics."""
    dataset = staged["root"] / "ravdess" / "Actor_01"
    dataset.mkdir(parents=True)
    clips = [Path(path) for path in staged["paths"] if Path(path).name.startswith("clip_")]
    for code, clip in zip(_CODES, clips):
        (dataset / f"03-01-{code}-01-01-01-01.wav").write_bytes(clip.read_bytes())
    for key, value in dict(staged["env"], SER_DATASET_FOLDER=str(dataset.parent)).items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(jax_encoders, "build_encoder_backend", lambda *a, **k: staged["reference_backend"])
    monkeypatch.setattr(encoders, "build_encoder_backend", lambda profile, settings: staged["backend"])
    reports = {}
    for name, run in (("jax", lambda argv: _load_jax_script().main()), ("port", evaluate_profile.main)):
        out = staged["root"] / f"{name}_report.json"
        argv = ["--profile", "medium", "--output", str(out)]
        monkeypatch.setattr(sys, "argv", ["evaluate_profile.py", *argv])
        assert run(argv) == 0
        reports[name] = json.loads(out.read_text())
    capsys.readouterr()
    timing = ("elapsed_seconds", "audio_seconds_per_second")
    ours, theirs = ({k: v for k, v in reports[n].items() if k not in timing} for n in ("port", "jax"))
    assert ours == theirs and ours["files"] == 4
    assert reports["port"]["audio_seconds_per_second"] > 0
