"""``train_encoder_profile_model`` of the port against ``ser_tpu``'s, on the CPU.

- With the same injected numpy encoder (as
  ``tests/suites/integration/models/test_encoder_training_with_fakes.py``
  injects one) on ``scripts/build_synthetic_ravdess_dataset.py``'s corpus: the
  same split (files and metadata), the same training and test rows bit for bit,
  the same labels, sample ids and noise-control counts (with both controls
  on), the same report keys; a second run reads every clip from the embedding
  cache and writes the same rows. Given ``JaxMLPClassifier.fit``'s initial
  layers and epoch permutations (drawn here with ``jax.random`` as it draws
  them), the port's head gives the same test predictions, and the same window
  and grouped metrics at rtol 1e-5. The artifact each package writes loads in
  the other.
- With the tiny real backends on the same weights (a tiny HF Whisper
  checkpoint both packages load, for the accurate profile through its own
  backend construction; tiny XLS-R weights carried across with ``convert.py``,
  for the medium profile): the same split, and the rows within the encoder
  parity tests' pin, atol 1e-4.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.models import artifacts as jax_artifacts
from ser_tpu._internal.models import encoder_training as jax_encoder_training
from ser_tpu._internal.repr import encoders as jax_encoders
from ser_tpu._internal.repr.backend import EncodedSequence as JaxEncodedSequence
from ser_tpu._internal.repr.wav2vec2_backend import XlsrBackend as JaxXlsrBackend
from ser_tpu.models import wav2vec2 as jax_w2v
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.models import encoder_training
from ser_tpu_torch._internal.repr import encoders
from ser_tpu_torch._internal.repr.backend import EncodedSequence
from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import wav2vec2 as w2v
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from build_synthetic_ravdess_dataset import build_dataset  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on a few cores: one intra-op thread each keeps the CPU's many small
    feature and encoder ops from contending for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


METRIC_RTOL = 1e-5
#: The encoder parity tests' pin (tests/test_torch_whisper_encoder.py, tests/test_torch_xlsr_backend.py).
ROW_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _same_wav_decoder_in_both():
    """Both packages read WAVs through the same decoder: the native one when both libraries build (one
    C++ source, so the samples, and so the digests and the embedding cache's content keys, are the same
    bits), else both the Python one."""
    from ser_tpu._internal.utils import native_audio as jax_native_audio
    from ser_tpu_torch._internal.utils import native_audio

    with pytest.MonkeyPatch.context() as patch:
        if not (native_audio.native_decoder_available() and jax_native_audio.native_decoder_available()):
            patch.setattr(jax_native_audio, "native_decoder_available", lambda: False)
            patch.setattr(native_audio, "native_decoder_available", lambda: False)
        yield


class _TinyDsp:
    """A deterministic numpy encoder: per 20 ms frame, energy, mean, zero-crossing rate and peak."""

    backend_id = "jax_xlsr"
    feature_dim = 4

    def __init__(self, sequence_type) -> None:
        self.sequence_type = sequence_type
        self.calls = 0

    def encode_sequence(self, audio, sample_rate):
        self.calls += 1
        hop = int(0.02 * sample_rate)
        n = max(1, audio.size // hop)
        frames = audio[: n * hop].reshape(n, hop)
        emb = np.stack(
            [
                (frames**2).mean(axis=1),
                frames.mean(axis=1),
                (np.diff(np.sign(frames), axis=1) != 0).mean(axis=1),
                np.abs(frames).max(axis=1),
            ],
            axis=1,
        ).astype(np.float32)
        starts = np.arange(n, dtype=np.float64) * 0.02
        return self.sequence_type(embeddings=emb, frame_start_seconds=starts, frame_end_seconds=starts + 0.02,
                                  backend_id=self.backend_id)


def _pair(env: dict[str, str], **nn):
    ours = build_settings(env)
    theirs = build_settings_from_inputs(capture_settings_inputs(env=env))
    return (dataclasses.replace(ours, nn=dataclasses.replace(ours.nn, **nn)),
            dataclasses.replace(theirs, nn=dataclasses.replace(theirs.nn, **nn)))


class _Recorder:
    """Wraps a module's ``_windowed_dataset`` and keeps what each call returned."""

    def __init__(self, module, monkeypatch) -> None:
        self.calls: list[tuple] = []
        original = module._windowed_dataset

        def record(**kwargs):
            out = original(**kwargs)
            self.calls.append((kwargs["files"], out))
            return out

        monkeypatch.setattr(module, "_windowed_dataset", record)


def _jax_initial_layers(dims: list[int], random_state: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """``JaxMLPClassifier.fit``'s initial parameters, drawn as it draws them."""
    key = jax.random.PRNGKey(random_state)
    layers = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        key, sub = jax.random.split(key)
        bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
        weight = jax.random.uniform(sub, (fan_in, fan_out), minval=-bound, maxval=bound, dtype=jnp.float32)
        layers.append((np.asarray(weight), np.zeros(fan_out, dtype=np.float32)))
    return layers


class _JaxPermutations:
    """``JaxMLPClassifier.fit``'s epoch permutations, in order."""

    def __init__(self, random_state: int, padded: int) -> None:
        self._key = jax.random.PRNGKey(random_state + 1)

        def draw(key):
            key, sub = jax.random.split(key)
            return key, jax.random.permutation(sub, padded)

        self._draw = jax.jit(draw)

    def __call__(self, epoch: int) -> np.ndarray:
        self._key, permutation = self._draw(self._key)
        return np.asarray(permutation)


def _fit_with_jax_draws(self, X, y):
    n_classes = len(np.unique(np.asarray(y)))
    _, padded = self.batch_rows(X.shape[0])
    layers = _jax_initial_layers(self.layer_dims(X.shape[1], n_classes), self.random_state)
    return self.fit_from(X, y, layers=layers, permutation=_JaxPermutations(self.random_state, padded))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("encoder_training")
    build_dataset(root / "ds", actors=4, repetitions=2, seconds=1.6)
    return root


def _env(root: Path, tag: str, **extra: str) -> dict[str, str]:
    return {
        "SER_DATASET_FOLDER": str(root / "ds"),
        "SER_MODELS_FOLDER": str(root / tag / "models"),
        "SER_TMP_FOLDER": str(root / tag / "tmp"),
        "SER_TORCH_DEVICE": "cpu",
        **extra,
    }


@pytest.fixture(scope="module")
def injected_runs(corpus) -> dict:
    """Both packages' training with the injected encoder, the port's head fitted from JAX's draws."""
    monkeypatch = pytest.MonkeyPatch()
    try:
        ours_rec = _Recorder(encoder_training, monkeypatch)
        theirs_rec = _Recorder(jax_encoder_training, monkeypatch)
        monkeypatch.setattr(TorchMLPClassifier, "fit", _fit_with_jax_draws)
        controls = {"SER_MEDIUM_MIN_WINDOW_STD": "0.1", "SER_MEDIUM_MAX_WINDOWS_PER_CLIP": "1"}
        ours_s, theirs_s = _pair(_env(corpus, "injected", **controls), hidden_layer_sizes=(32,), max_iter=150)
        _, theirs_s = _pair(_env(corpus, "injected-jax", **controls), hidden_layer_sizes=(32,), max_iter=150)
        ours_backend = _TinyDsp(EncodedSequence)
        ours = encoder_training.train_encoder_profile_model(profile="medium", settings=ours_s, backend=ours_backend)
        first_calls = ours_backend.calls
        theirs = jax_encoder_training.train_encoder_profile_model(profile="medium", settings=theirs_s,
                                                                   backend=_TinyDsp(JaxEncodedSequence))
        rerun_backend = _TinyDsp(EncodedSequence)
        rerun = encoder_training.train_encoder_profile_model(profile="medium", settings=ours_s,
                                                             backend=rerun_backend)
    finally:
        monkeypatch.undo()
    return {"ours": ours, "theirs": theirs, "rerun": rerun, "ours_calls": ours_rec.calls,
            "theirs_calls": theirs_rec.calls, "first_encodes": first_calls, "rerun_encodes": rerun_backend.calls}


def test_same_split_as_ser_tpu(injected_runs) -> None:
    ours, theirs = injected_runs["ours"], injected_runs["theirs"]
    assert ours["split_metadata"] == theirs["split_metadata"]
    assert ours["split_metadata"]["split_strategy"] == "group_shuffle_split"
    assert (ours["train_samples"], ours["test_samples"]) == (theirs["train_samples"], theirs["test_samples"])
    (ours_train, _), (ours_test, _) = injected_runs["ours_calls"][:2]
    (theirs_train, _), (theirs_test, _) = injected_runs["theirs_calls"][:2]
    assert ours_train == theirs_train and ours_test == theirs_test


def test_same_rows_bit_for_bit_and_noise_stats(injected_runs) -> None:
    for (_, ours), (_, theirs) in zip(injected_runs["ours_calls"][:2], injected_runs["theirs_calls"][:2]):
        rows, labels, sample_ids, stats = ours
        j_rows, j_labels, j_sample_ids, j_stats = theirs
        assert rows.dtype == j_rows.dtype == np.float64
        np.testing.assert_array_equal(rows, j_rows)
        assert (labels, sample_ids) == (j_labels, j_sample_ids)
        assert stats.as_dict() == j_stats.as_dict()
    ours, theirs = injected_runs["ours"], injected_runs["theirs"]
    assert ours["train_noise_stats"] == theirs["train_noise_stats"]
    assert ours["test_noise_stats"] == theirs["test_noise_stats"]
    stats = ours["train_noise_stats"]
    assert stats["kept_windows"] < stats["total_windows"]


def test_same_report_keys(injected_runs) -> None:
    ours, theirs = injected_runs["ours"], injected_runs["theirs"]
    assert set(ours) == set(theirs)
    for key in ("profile", "backend_id", "backend_model_id", "artifact_version", "artifact_schema_version",
                "label_distribution", "labels", "training_windows", "test_windows", "feature_vector_size",
                "containment"):
        assert ours[key] == theirs[key], key


def test_same_predictions_and_metrics_given_jax_draws(injected_runs) -> None:
    ours, theirs = injected_runs["ours"], injected_runs["theirs"]
    for key in ("accuracy", "uar", "macro_f1"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=METRIC_RTOL)
    assert ours["per_class_recall"].keys() == theirs["per_class_recall"].keys()
    for label, recall in theirs["per_class_recall"].items():
        np.testing.assert_allclose(ours["per_class_recall"][label], recall, rtol=METRIC_RTOL)
    assert ours["metrics"]["confusion_matrix"] == theirs["metrics"]["confusion_matrix"]
    assert ours["grouped"]["samples_evaluated"] == theirs["grouped"]["samples_evaluated"]
    for key in ("uar", "macro_f1"):
        np.testing.assert_allclose(ours["grouped"][key], theirs["grouped"][key], rtol=METRIC_RTOL)
    assert ours["group_metrics"] == theirs["group_metrics"]


def test_second_run_reads_every_clip_from_the_cache(injected_runs) -> None:
    ours, rerun = injected_runs["ours"], injected_runs["rerun"]
    clips = ours["train_samples"] + ours["test_samples"]
    assert ours["cache_probes"] == injected_runs["theirs"]["cache_probes"] == {"hits": 0, "misses": clips}
    assert rerun["cache_probes"] == {"hits": clips, "misses": 0}
    smoke_probes = injected_runs["first_encodes"] - clips
    assert injected_runs["rerun_encodes"] == smoke_probes > 0  # only the smoke encodes again
    for (_, first), (_, again) in zip(injected_runs["ours_calls"][:2], injected_runs["ours_calls"][2:4]):
        np.testing.assert_array_equal(first[0], again[0])
        assert first[1:3] == again[1:3]
    for key in ("accuracy", "uar", "macro_f1", "grouped", "split_metadata"):
        assert rerun[key] == ours[key], key


def test_artifacts_load_in_the_other_package(injected_runs) -> None:
    ours, theirs = injected_runs["ours"], injected_runs["theirs"]
    loaded_by_jax = jax_artifacts.load_model_artifact(ours["model_path"], expected_backend_id="jax_xlsr",
                                                      expected_profile="medium")
    loaded_by_us = artifacts.load_model_artifact(theirs["model_path"], expected_backend_id="jax_xlsr",
                                                 expected_profile="medium", device="cpu")
    assert loaded_by_jax.expected_feature_size == loaded_by_us.expected_feature_size == 8
    own = artifacts.load_model_artifact(ours["model_path"], expected_backend_id="jax_xlsr", device="cpu")
    rows = injected_runs["ours_calls"][1][1][0]
    np.testing.assert_array_equal(loaded_by_jax.model.predict(rows), own.model.predict(rows))
    metadata = own.artifact_metadata
    assert metadata["provenance"]["framework"] == "ser_tpu_torch"
    assert metadata["provenance"]["trainer"] == "encoder_training"
    assert (metadata["device"], metadata["dtype"]) == ("cpu", "float32")
    assert set(metadata["provenance"]) == set(loaded_by_us.artifact_metadata["provenance"])
    assert Path(ours["report_path"]).name == Path(theirs["report_path"]).name


# --------------------------------------------------------------------------- #
# The tiny real backends
# --------------------------------------------------------------------------- #

transformers = pytest.importorskip("transformers")
WHISPER_ID = "openai/whisper-large-v3"
XLSR_ID = "facebook/wav2vec2-xls-r-300m"


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("encoder_training_real")
    build_dataset(root / "ds", actors=2, repetitions=1, seconds=1.2)
    cfg = transformers.WhisperConfig(
        vocab_size=320, num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        decoder_layers=1, decoder_attention_heads=4, encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=1500, max_target_positions=64, activation_function="gelu",
        decoder_start_token_id=1, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    torch.manual_seed(0)
    transformers.WhisperModel(cfg).eval().save_pretrained(
        root / "cache" / "model-cache" / "huggingface" / WHISPER_ID, safe_serialization=True)
    return root


def _rows_close(ours_calls, theirs_calls) -> None:
    assert len(ours_calls) == len(theirs_calls) == 2
    for (ours_files, ours), (theirs_files, theirs) in zip(ours_calls, theirs_calls):
        assert ours_files == theirs_files
        assert ours[1:3] == theirs[1:3]
        assert ours[0].shape == theirs[0].shape
        np.testing.assert_allclose(ours[0], theirs[0], atol=ROW_ATOL, rtol=0)


def test_accurate_rows_on_a_tiny_whisper_checkpoint_match_ser_tpu(small_corpus, monkeypatch) -> None:
    env = {**_env(small_corpus, "accurate"), "SER_CACHE_DIR": str(small_corpus / "cache")}
    ours_s, theirs_s = _pair(env, hidden_layer_sizes=(16,), max_iter=30)
    ours_rec = _Recorder(encoder_training, monkeypatch)
    theirs_rec = _Recorder(jax_encoder_training, monkeypatch)
    monkeypatch.setattr(encoders, "_BACKEND_CACHE", {})
    ours = encoder_training.train_encoder_profile_model(profile="accurate", settings=ours_s)
    theirs = jax_encoder_training.train_encoder_profile_model(profile="accurate", settings=theirs_s)
    assert ours["split_metadata"] == theirs["split_metadata"]
    assert ours["feature_vector_size"] == theirs["feature_vector_size"] == 128
    assert ours["backend_id"] == theirs["backend_id"] == "jax_whisper_encoder"
    _rows_close(ours_rec.calls, theirs_rec.calls)
    assert set(jax_encoders._BACKEND_CACHE) and set(encoders._BACKEND_CACHE)


def test_medium_rows_on_tiny_xlsr_weights_match_ser_tpu(small_corpus, monkeypatch) -> None:
    jax_cfg = jax_w2v.Wav2Vec2Config.tiny()
    params = jax.jit(jax_w2v.Wav2Vec2Encoder(jax_cfg).init)(jax.random.PRNGKey(5),
                                                            jnp.zeros((1, 4000), jnp.float32))["params"]
    ours_backend = XlsrBackend(model_id=XLSR_ID, cache_root=small_corpus, device="cpu", dtype="float32",
                               config=w2v.Wav2Vec2Config(**dataclasses.asdict(jax_cfg)),
                               state=convert.wav2vec2_state_dict(params))
    theirs_backend = JaxXlsrBackend(model_id=XLSR_ID, cache_root=small_corpus, dtype="float32", config=jax_cfg,
                                    params=params)
    ours_s, theirs_s = _pair(_env(small_corpus, "medium"), hidden_layer_sizes=(16,), max_iter=30)
    ours_rec = _Recorder(encoder_training, monkeypatch)
    theirs_rec = _Recorder(jax_encoder_training, monkeypatch)
    ours = encoder_training.train_encoder_profile_model(profile="medium", settings=ours_s, backend=ours_backend)
    theirs = jax_encoder_training.train_encoder_profile_model(profile="medium", settings=theirs_s,
                                                               backend=theirs_backend)
    assert ours["split_metadata"] == theirs["split_metadata"]
    assert ours["feature_vector_size"] == theirs["feature_vector_size"] == 2 * jax_cfg.hidden_size
    _rows_close(ours_rec.calls, theirs_rec.calls)
