"""Training readiness and orchestration of the port against ``ser_tpu``, on the CPU.

Both packages run ``run_training_readiness`` on ``scripts/build_synthetic_ravdess_dataset.py``'s
corpus with a corrupt, a too-short and a silent file planted, under the
default budgets (the per-class and global ratios blow), relaxed budgets, and a
blown per-class budget alone. Held alike: the finding codes, scopes,
severities and sample ids; the quarantined and usable files; the settings,
split, quarantine-ledger and recipe digests; the smoke's findings (the fast
backend; an injected hung backend under a 1 s deadline; invalid deadlines);
the stratified smoke sample. A prepared plan and a quarantine ledger written
by either package load in the other, and ``train_from_prepared`` fits from
the other's plan. ``ser_tpu`` reads the WAVs through its Python decoder here
(its native decoder, which the port has not copied, normalizes by a float32
reciprocal and lands 1 ulp away, so the normalized-PCM digests would differ).
The settings the slice reads keep ``ser_tpu``'s names and
defaults, and the readiness gate, the bounded retry and the mid-training
quarantine follow ``ser_tpu``'s ``training_orchestration``.
"""

from __future__ import annotations

import dataclasses
import errno
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ser_tpu._internal.config import schema as jax_schema
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.models import fast_training as jax_fast_training
from ser_tpu._internal.models import training_orchestration as jax_orchestration
from ser_tpu._internal.models import training_readiness as jax_tr
from ser_tpu._internal.repr.backend import EncodedSequence as JaxEncodedSequence
from ser_tpu_torch._internal.config import schema
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.models import fast_training
from ser_tpu_torch._internal.models import training_orchestration as orchestration
from ser_tpu_torch._internal.models import training_readiness as tr
from ser_tpu_torch._internal.repr.backend import EncodedSequence
from ser_tpu_torch._internal.utils.audio_io import AudioDecodeError, write_wav

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


PLANTED = {
    "corrupt": "Actor_01/03-01-03-01-02-03-01.wav",
    "short": "Actor_02/03-01-05-01-02-03-02.wav",
    "silent": "Actor_03/03-01-07-01-02-03-03.wav",
}


@pytest.fixture(scope="module", autouse=True)
def _python_wav_decoder_in_ser_tpu():
    from ser_tpu._internal.utils import native_audio

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(native_audio, "native_decoder_available", lambda: False)
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("readiness")
    ds = root / "ds"
    build_dataset(ds, actors=3, repetitions=2, seconds=1.2)
    (ds / PLANTED["corrupt"]).write_bytes(b"RIFF\x10\x00\x00\x00WAVEjunk")
    write_wav(ds / PLANTED["short"], np.zeros(400, np.float32) + 0.1, 16000)
    write_wav(ds / PLANTED["silent"], np.zeros(int(1.2 * 16000), np.float32), 16000)
    return root


def _env(root: Path, tag: str, **extra: str) -> dict[str, str]:
    return {
        "SER_DATASET_FOLDER": str(root / "ds"),
        "SER_TMP_FOLDER": str(root / tag / "tmp"),
        "SER_MODELS_FOLDER": str(root / tag / "models"),
        "SER_TORCH_DEVICE": "cpu",
        **extra,
    }


def _pair(env: dict[str, str]):
    return build_settings(env), build_settings_from_inputs(capture_settings_inputs(env=env))


def _findings(report) -> list[tuple]:
    return [(f.scope.value, f.severity.value, f.reason, f.sample_id) for f in report.findings]


BUDGETS = {
    "defaults": {},
    "relaxed": {"SER_MAX_FAILED_FILE_RATIO": "0.2"},
    "per-class-blown": {"SER_MAX_FAILED_FILE_RATIO": "0.2", "SER_MAX_FAILED_FILE_RATIO_PER_CLASS": "0.05"},
    "strict": {"SER_MAX_FAILED_FILE_RATIO": "0.2", "SER_STRICT_QUARANTINE": "1"},
    "absolute": {"SER_MAX_FAILED_FILE_RATIO": "0.2", "SER_MAX_FAILED_FILES": "1"},
}


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_readiness_findings_and_quarantine_match_ser_tpu(corpus, budget) -> None:
    ours_s, theirs_s = _pair(_env(corpus, budget, **BUDGETS[budget]))
    ours = tr.run_training_readiness(settings=ours_s, profile="fast")
    theirs = jax_tr.run_training_readiness(settings=theirs_s, profile="fast")
    assert _findings(ours) == _findings(theirs)
    assert ours.quarantined_files == theirs.quarantined_files
    assert ours.usable_files == theirs.usable_files
    assert ours.usable_digests == theirs.usable_digests
    assert [dataclasses.astuple(r) for r in ours.usable_records] == [
        dataclasses.astuple(r) for r in theirs.usable_records]
    assert ours.blocking == theirs.blocking == (budget != "relaxed")
    quarantined = {Path(path).relative_to(corpus / "ds").as_posix() for path in ours.quarantined_files}
    assert quarantined == {PLANTED["corrupt"], PLANTED["short"]}
    reasons = {f.reason for f in ours.findings if f.severity is tr.FindingSeverity.BLOCKING}
    expected = {
        "defaults": {"quarantine_budget_ratio", "quarantine_budget_per_corpus", "quarantine_budget_per_class"},
        "relaxed": set(),
        "per-class-blown": {"quarantine_budget_per_class"},
        "strict": {"quarantine_strict"},
        "absolute": {"quarantine_budget_absolute"},
    }[budget]
    assert reasons == expected


def test_config_and_resource_findings_match_ser_tpu(corpus, tmp_path) -> None:
    cases = [
        {"SER_TEST_SIZE": "0.95"},
        {"SER_DEV_SIZE": "0.0"},
        {"SER_TEST_SIZE": "0.6", "SER_DEV_SIZE": "0.5"},
        {"SER_MAX_FAILED_FILE_RATIO_PER_CLASS": "1.5"},
        {"SER_MAX_FAILURES_PER_REASON": "-1"},
        {"SER_MEDIUM_MIN_WINDOW_STD": "-0.1"},
        {"SER_TORCH_DTYPE": "int8"},
        {"SER_DATASET_FOLDER": str(tmp_path / "absent")},
        {"SER_DATASET_FOLDER": str(tmp_path)},
    ]
    for extra in cases:
        ours_s, theirs_s = _pair(_env(corpus, "config", **extra))
        ours = tr.run_training_readiness(settings=ours_s, profile="medium")
        theirs = jax_tr.run_training_readiness(settings=theirs_s, profile="medium")
        assert _findings(ours) == _findings(theirs), extra
        assert ours.blocking and theirs.blocking, extra


def test_restricted_backend_gate_blocks_accurate_research_in_both(corpus) -> None:
    ours_s, theirs_s = _pair(_env(corpus, "gate", SER_MAX_FAILED_FILE_RATIO="0.2"))
    ours = tr.run_training_readiness(settings=ours_s, profile="accurate-research")
    theirs = jax_tr.run_training_readiness(settings=theirs_s, profile="accurate-research")
    assert _findings(ours) == _findings(theirs)
    assert [f.reason for f in ours.findings] == ["restricted_backend_access"]
    opened = {"SER_ENABLE_RESTRICTED_BACKENDS": "1", "SER_ALLOWED_RESTRICTED_BACKENDS": "emotion2vec"}
    ours_s, theirs_s = _pair(_env(corpus, "gate", SER_MAX_FAILED_FILE_RATIO="0.2", **opened))
    ours = tr.run_training_readiness(settings=ours_s, profile="accurate-research")
    assert not ours.blocking
    assert _findings(ours) == _findings(jax_tr.run_training_readiness(settings=theirs_s,
                                                                      profile="accurate-research"))


@pytest.mark.parametrize("profile", ["fast", "medium", "accurate", "accurate-research"])
def test_digests_match_ser_tpu(corpus, profile, monkeypatch) -> None:
    monkeypatch.delenv("SER_SPLIT_SALT", raising=False)
    ours_s, theirs_s = _pair(_env(corpus, f"digests-{profile}", SER_MAX_FAILED_FILE_RATIO="0.2",
                                  SER_DATASET_RECIPE="research_v1"))
    assert tr._backend_fingerprint(ours_s, profile) == jax_tr._backend_fingerprint(theirs_s, profile)
    assert tr._settings_digest(ours_s, profile) == jax_tr._settings_digest(theirs_s, profile)
    assert tr.recipe_content_digest(ours_s) == jax_tr.recipe_content_digest(theirs_s)
    ours_s, theirs_s = _pair(_env(corpus, f"digests-{profile}", SER_MAX_FAILED_FILE_RATIO="0.2"))
    report = jax_tr.run_training_readiness(settings=theirs_s, profile="fast")
    ours_report = tr.run_training_readiness(settings=ours_s, profile="fast")
    assert tr.split_digest(ours_report, ours_s) == jax_tr.split_digest(report, theirs_s)
    assert tr.current_split_digest(ours_s, profile) == jax_tr.current_split_digest(theirs_s, profile)
    monkeypatch.setenv("SER_SPLIT_SALT", "other")
    assert tr.split_digest(ours_report, ours_s) == jax_tr.split_digest(report, theirs_s)


def test_quarantine_ledger_written_by_either_package_loads_in_the_other(corpus) -> None:
    env = _env(corpus, "ledger", SER_MAX_FAILED_FILE_RATIO="0.2")
    ours_s, theirs_s = _pair(env)
    report = jax_tr.run_training_readiness(settings=theirs_s, profile="fast")
    ledger = jax_tr.write_quarantine_ledger(report, settings=theirs_s)
    assert tr.quarantine_ledger_digest(ours_s, "fast") == jax_tr.quarantine_ledger_digest(theirs_s, "fast")
    assert tr.current_split_digest(ours_s, "fast") == jax_tr.current_split_digest(theirs_s, "fast")
    rows = ledger.read_text().splitlines()
    # The port re-appends nothing the JAX package recorded, and reads its rows alike.
    ours_report = tr.run_training_readiness(settings=ours_s, profile="fast")
    assert tr.write_quarantine_ledger(ours_report, settings=ours_s) == ledger
    assert ledger.read_text().splitlines() == rows
    ledger.unlink()
    tr.write_quarantine_ledger(ours_report, settings=ours_s)
    ours_rows = [json.loads(line) for line in ledger.read_text().splitlines()]
    assert [{k: v for k, v in row.items() if k != "recorded_at_unix"} for row in ours_rows] == [
        {k: v for k, v in json.loads(row).items() if k != "recorded_at_unix"} for row in rows]
    assert jax_tr.quarantine_ledger_digest(theirs_s, "fast") == tr.quarantine_ledger_digest(ours_s, "fast")


def test_prepared_plans_cross_load_and_train(corpus) -> None:
    env = _env(corpus, "plans", SER_MAX_FAILED_FILE_RATIO="0.2")
    # A small head: both packages' plans sign these settings, and both fits read them.
    ours_s, theirs_s = (dataclasses.replace(s, nn=dataclasses.replace(s.nn, hidden_layer_sizes=(32,), max_iter=100))
                        for s in _pair(env))
    ours_report = tr.run_training_readiness(settings=ours_s, profile="fast")
    theirs_report = jax_tr.run_training_readiness(settings=theirs_s, profile="fast")
    tr.write_quarantine_ledger(ours_report, settings=ours_s)
    ours_plan = tr.write_prepared_plan(settings=ours_s, profile="fast", report=ours_report,
                                       plan_dir=ours_s.tmp_folder / "prepared" / "ours")
    theirs_plan = jax_tr.write_prepared_plan(settings=theirs_s, profile="fast", report=theirs_report,
                                             plan_dir=theirs_s.tmp_folder / "prepared" / "theirs")
    ours_json, theirs_json = json.loads(ours_plan.read_text()), json.loads(theirs_plan.read_text())
    assert {k: v for k, v in ours_json.items() if k != "payload"} == {
        k: v for k, v in theirs_json.items() if k != "payload"}
    features, labels, groups = jax_tr.load_prepared_plan(ours_plan, settings=theirs_s, profile="fast")
    j_features, j_labels, j_groups = tr.load_prepared_plan(theirs_plan, settings=ours_s, profile="fast")
    assert (labels, groups) == (j_labels, j_groups)
    assert features.shape == j_features.shape == (len(labels), 193)
    report = fast_training.train_from_prepared(plan_path=theirs_plan, settings=ours_s)
    j_report = jax_fast_training.train_from_prepared(plan_path=ours_plan, settings=theirs_s)
    assert report["training_samples"] == j_report["training_samples"]
    assert report["backend_id"] == j_report["backend_id"] == "handcrafted"
    with pytest.raises(tr.PreparedPlanError, match="profile"):
        tr.load_prepared_plan(theirs_plan, settings=ours_s, profile="medium")
    changed = dataclasses.replace(ours_s, training=dataclasses.replace(ours_s.training, test_size=0.3))
    with pytest.raises(tr.PreparedPlanError, match="settings digest"):
        tr.load_prepared_plan(theirs_plan, settings=changed, profile="fast")


def test_readiness_cli_and_report_match_ser_tpu(corpus, capsys) -> None:
    for extra, code in (({}, 2), ({"SER_MAX_FAILED_FILE_RATIO": "0.2"}, 0)):
        ours_s, theirs_s = _pair(_env(corpus, f"cli{code}", **extra))
        assert tr.run_training_readiness_cli(settings=ours_s, profile="fast", dry_run=True, prepare_only=False,
                                             prepared_plan=None) == code
        ours_out = capsys.readouterr().out
        assert jax_tr.run_training_readiness_cli(settings=theirs_s, profile="fast", dry_run=True,
                                                 prepare_only=False, prepared_plan=None) == code
        theirs_out = capsys.readouterr().out
        assert len(ours_out.splitlines()) == len(theirs_out.splitlines())
        assert ours_out.splitlines()[-1] == theirs_out.splitlines()[-1]
        ours = json.loads(tr.default_readiness_report_path(ours_s, "fast").read_text())
        theirs = json.loads(jax_tr.default_readiness_report_path(theirs_s, "fast").read_text())
        for payload in (ours, theirs):
            payload.pop("generated_at_unix")
            for finding in payload["findings"]:
                finding.pop("message")
        assert ours == theirs


def test_fast_smoke_and_stratified_sample_match_ser_tpu(corpus, monkeypatch) -> None:
    monkeypatch.delenv("SER_TRAINING_SMOKE_TIMEOUT_SECONDS", raising=False)
    ours_s, theirs_s = _pair(_env(corpus, "smoke", SER_MAX_FAILED_FILE_RATIO="0.2"))
    report = tr.run_training_readiness(settings=ours_s, profile="fast")
    j_report = jax_tr.run_training_readiness(settings=theirs_s, profile="fast")
    for cap in (1, 4, 16, 64):
        assert [r.path for r in tr.select_smoke_samples(report.usable_records, cap=cap)] == [
            r.path for r in jax_tr.select_smoke_samples(j_report.usable_records, cap=cap)]
    assert tr._smoke_timeout_seconds(ours_s) == 120.0
    ours = tr.run_backend_smoke(settings=ours_s, profile="fast", usable_files=report.usable_files,
                                usable_records=report.usable_records)
    theirs = jax_tr.run_backend_smoke(settings=theirs_s, profile="fast", usable_files=j_report.usable_files,
                                      usable_records=j_report.usable_records)
    assert [(f.reason, f.severity.value, f.message) for f in ours] == [
        (f.reason, f.severity.value, f.message) for f in theirs]
    assert ours[0].reason == "backend_smoke_ok"


class _HungBackend:
    """An encoder double that never returns in time: it sleeps in short steps for 5 s."""

    backend_id = "jax_xlsr"
    feature_dim = 4

    def __init__(self, sequence_type) -> None:
        self.sequence_type = sequence_type

    def encode_sequence(self, audio, sample_rate):
        for _ in range(100):
            time.sleep(0.05)
        starts = np.zeros(1)
        return self.sequence_type(embeddings=np.zeros((1, 4), np.float32), frame_start_seconds=starts,
                                  frame_end_seconds=starts + 0.02, backend_id=self.backend_id)


def test_hung_smoke_backend_blocks_under_a_one_second_deadline(corpus, monkeypatch) -> None:
    monkeypatch.setenv("SER_TRAINING_SMOKE_TIMEOUT_SECONDS", "1")
    ours_s, theirs_s = _pair(_env(corpus, "hung", SER_MAX_FAILED_FILE_RATIO="0.2"))
    report = tr.run_training_readiness(settings=ours_s, profile="medium")
    for module, settings, sequence_type in ((tr, ours_s, EncodedSequence), (jax_tr, theirs_s, JaxEncodedSequence)):
        started = time.monotonic()
        findings = module.run_backend_smoke(settings=settings, profile="medium", usable_files=report.usable_files,
                                            usable_records=report.usable_records,
                                            backend=_HungBackend(sequence_type))
        assert time.monotonic() - started < 3.0
        assert [(f.reason, f.severity.value, f.scope.value) for f in findings] == [
            ("backend_smoke_timeout", "blocking", "resource")]
    with pytest.raises(orchestration.TrainingNotReadyError, match="backend smoke"):
        orchestration.ensure_entrypoint_readiness(settings=ours_s, profile="medium",
                                                  backend=_HungBackend(EncodedSequence))
    written = json.loads(tr.default_readiness_report_path(ours_s, "medium").read_text())
    assert written["blocking"] and written["findings"][-1]["reason"] == "backend_smoke_timeout"


@pytest.mark.parametrize("value", ["0", "-1", "600.5", "nan", "soon"])
def test_invalid_smoke_deadline_blocks_in_both(corpus, monkeypatch, value) -> None:
    monkeypatch.setenv("SER_TRAINING_SMOKE_TIMEOUT_SECONDS", value)
    ours_s, theirs_s = _pair(_env(corpus, "deadline"))
    ours = tr.run_backend_smoke(settings=ours_s, profile="fast", usable_files=("x.wav",))
    theirs = jax_tr.run_backend_smoke(settings=theirs_s, profile="fast", usable_files=("x.wav",))
    assert [(f.reason, f.message) for f in ours] == [(f.reason, f.message) for f in theirs]
    assert ours[0].reason == "smoke_timeout_invalid"


def test_smoke_default_deadline_follows_the_torch_device(corpus, monkeypatch) -> None:
    monkeypatch.delenv("SER_TRAINING_SMOKE_TIMEOUT_SECONDS", raising=False)
    assert tr._smoke_timeout_seconds(build_settings({"SER_TORCH_DEVICE": "cpu"})) == 120.0
    # No card here: "auto" resolves to nothing, so the CPU's deadline stands and the smoke reports the rest.
    assert tr._smoke_timeout_seconds(build_settings({"SER_TORCH_DEVICE": "auto"})) == 120.0
    monkeypatch.setattr("ser_tpu_torch._internal.repr.runtime_policy.torch.cuda.is_available", lambda: True)
    assert tr._smoke_timeout_seconds(build_settings({"SER_TORCH_DEVICE": "auto"})) == 420.0


def test_settings_of_the_slice_keep_ser_tpu_names_and_defaults() -> None:
    pairs = [
        (schema.DataLoaderConfig, jax_schema.DataLoaderConfig),
        (schema.TrainingConfig, jax_schema.TrainingConfig),
        (schema.MediumTrainingConfig, jax_schema.MediumTrainingConfig),
        (schema.NeuralNetConfig, jax_schema.NeuralNetConfig),
        (schema.FeatureFlags, jax_schema.FeatureFlags),
    ]
    for ours, theirs in pairs:
        assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())
    env = {"SER_MAX_FAILED_FILES": "3", "SER_MAX_FAILED_FILE_RATIO": "0.3", "SER_MAX_FAILED_FILE_RATIO_PER_CORPUS": "0",
           "SER_MAX_FAILURES_PER_REASON": "4", "SER_MIN_REMAINING_PER_CLASS_SPLIT": "2",
           "SER_STRICT_QUARANTINE": "true", "SER_DEV_SIZE": "0.2", "SER_TEST_SIZE": "0.3",
           "SER_MEDIUM_MIN_WINDOW_STD": "0.25", "SER_MEDIUM_MAX_WINDOWS_PER_CLIP": "7"}
    ours, theirs = _pair(env)
    for section in ("data_loader", "training", "medium_training", "nn"):
        assert dataclasses.asdict(getattr(ours, section)) == dataclasses.asdict(getattr(theirs, section))
    assert ours.data_loader.max_failed_file_ratio_per_class == 0.3
    assert ours.data_loader.max_failed_file_ratio_per_corpus == 0.0


def test_bounded_retry_and_mid_training_quarantine_match_ser_tpu(corpus, monkeypatch) -> None:
    monkeypatch.setattr(orchestration.time, "sleep", lambda _: None)
    monkeypatch.setattr(jax_orchestration.time, "sleep", lambda _: None)
    for module in (orchestration, jax_orchestration):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError(errno.EAGAIN, "busy")
            return "read"

        with module.training_operation_scope("fast") as state:
            assert module.bounded_retry_local_io(flaky, identity="a.wav") == "read"
            assert state.bounded_retries == 2
            assert dict(state.containment_counts) == {"sample:media_decode_failed:bounded_retry": 2}
        with pytest.raises(FileNotFoundError):
            module.bounded_retry_local_io(lambda: (_ for _ in ()).throw(FileNotFoundError("x")), identity="b")

    path = str(corpus / "ds" / "Actor_01" / "03-01-01-01-01-01-01.wav")
    labels = ["neutral"] * 10 + ["calm"] * 10
    cases = [
        ({"SER_MAX_FAILED_FILE_RATIO": "0.2"}, [], True),
        ({"SER_MAX_FAILED_FILE_RATIO": "0.2"}, ["neutral"], True),  # the class loses 2 of 10: at its budget
        ({"SER_MAX_FAILED_FILE_RATIO": "0.2"}, ["neutral", "neutral"], False),  # 3 of 10: over it
        ({"SER_MAX_FAILED_FILE_RATIO": "0.2", "SER_MAX_FAILED_FILES": "0"}, [], False),
        ({"SER_MAX_FAILED_FILE_RATIO": "0.2", "SER_STRICT_QUARANTINE": "1"}, [], False),
        ({"SER_MAX_FAILED_FILE_RATIO": "0.2", "SER_MIN_REMAINING_PER_CLASS_SPLIT": "10"}, [], False),
    ]
    for extra, already, allowed in cases:
        outcomes = []
        for module, settings in zip((orchestration, jax_orchestration), _pair(_env(corpus, "mid", **extra))):
            error = AudioDecodeError("corrupt") if module is orchestration else _jax_decode_error("corrupt")
            with module.training_operation_scope("medium") as state:
                try:
                    kept = module.handle_sample_encoding_failure(
                        settings=settings, sample_path=path, label="neutral", error=error,
                        all_labels=labels, quarantined_labels=list(already))
                    outcomes.append((kept, list(state.quarantined_sample_paths), dict(state.containment_counts)))
                except module.QuarantineBudgetExceeded as err:
                    outcomes.append(("exceeded", str(err)))
        assert outcomes[0] == outcomes[1], extra
        assert (outcomes[0][0] is True) == allowed, (extra, outcomes[0])
    for module, settings in zip((orchestration, jax_orchestration), _pair(_env(corpus, "mid"))):
        assert module.handle_sample_encoding_failure(
            settings=settings, sample_path=path, label="neutral", error=ValueError("novel"), all_labels=labels,
            quarantined_labels=[]) is False


def _jax_decode_error(message: str) -> Exception:
    from ser_tpu._internal.utils.audio_io import AudioDecodeError as JaxAudioDecodeError

    return JaxAudioDecodeError(message)
