"""The port's quality gate against ``ser_tpu``'s, on the CPU.

- The gate's maths and decision, on the strategies of
  ``tests/suites/parity/test_parity_quality_gate.py`` (25 examples each):
  per-clip stability, the duration-weighted clip label, the mean of per-clip
  rates, and the decision (promote bit and reasons) under drawn thresholds,
  exactly.
- The report: the same payload and the same bytes on disk for the same
  decision (the clock pinned), read back alike, and pass enforcement.
- The workflow's exit codes (0 promote or advisory hold, 1 hold under
  ``require_pass``, 2 an unusable corpus) and the report each writes.
- ``evaluate_candidate_gate`` for ``accurate`` on a staged tiny HF Whisper
  checkpoint and 12 synthetic RAVDESS-named clips (4 classes × 3 speakers):
  the fast rows within the golden fixtures' limits, the candidate's window
  rows within the encoder's 1e-4, the speaker-grouped folds equal, and, with a
  deterministic nearest-centroid stand-in for both heads (the MLP heads draw
  their weights differently, ``ROADMAP.md`` Queue 3 item 24), the same UAR,
  macro-F1, stability and decision. The stability pass runs through a planted
  backend hook in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ser_tpu._internal.config.schema import QualityGateConfig as JaxQualityGateConfig
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs as jax_build
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs as jax_capture
from ser_tpu._internal.runtime import quality_gate as jax_gate
from ser_tpu._internal.runtime import quality_gate_report as jax_report
from ser_tpu._internal.runtime import quality_gate_workflow as jax_workflow
from ser_tpu.runtime.schema import SegmentPrediction as JaxSegmentPrediction
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.config.schema import QualityGateConfig
from ser_tpu_torch._internal.runtime import quality_gate as gate
from ser_tpu_torch._internal.runtime import quality_gate_report as report
from ser_tpu_torch._internal.runtime import quality_gate_workflow as workflow
from ser_tpu_torch.runtime.schema import SegmentPrediction

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
from build_synthetic_ravdess_dataset import build_dataset  # noqa: E402

EMOTIONS = ["angry", "calm", "happy", "sad"]
#: The fast features' per-family limits (``tests/suites/unit/ops/test_dsp_golden_fixtures.py``, as in
#: ``tests/test_torch_loader_split.py``): rtol 2e-3 and an atol times max(1, |value|).
FAST_FAMILIES = {"mfcc": (slice(0, 40), 2e-3), "chroma": (slice(40, 52), 5e-3), "mel": (slice(52, 180), 2e-4),
                 "contrast": (slice(180, 187), 2e-3), "tonnetz": (slice(187, 193), 5e-3)}
FAST_RTOL = 2e-3
#: The encoder parity tests' pin (tests/test_torch_whisper_encoder.py, tests/test_torch_encoder_training.py).
ROW_ATOL = 1e-4


@st.composite
def segment_lists(draw) -> list[dict]:
    count = draw(st.integers(min_value=0, max_value=12))
    segments = []
    cursor = draw(st.floats(min_value=0.0, max_value=5.0, allow_nan=False))
    for _ in range(count):
        length = draw(st.sampled_from([0.0, 0.25, 1.0, 3.5]))  # zero-length segments: the vote floor
        segments.append({"emotion": draw(st.sampled_from(EMOTIONS)), "start_seconds": cursor,
                         "end_seconds": cursor + length})
        cursor += length + draw(st.sampled_from([0.0, 0.5]))
    return segments


def _ours(payload):
    return [SegmentPrediction(confidence=1.0, **item) for item in payload]


def _theirs(payload):
    return [JaxSegmentPrediction(confidence=1.0, **item) for item in payload]


@settings(max_examples=25, deadline=None)
@given(clips=st.lists(segment_lists(), min_size=0, max_size=4))
def test_stability_and_clip_label_match(clips) -> None:
    for payload in clips:
        assert gate.clip_stability_metrics(_ours(payload)) == jax_gate.clip_stability_metrics(_theirs(payload))
        assert gate.duration_weighted_clip_label(_ours(payload)) == jax_gate.duration_weighted_clip_label(
            _theirs(payload))
    ours = gate.temporal_stability_of([_ours(p) for p in clips])
    theirs = jax_gate.temporal_stability_of([_theirs(p) for p in clips])
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@settings(max_examples=25, deadline=None)
@given(
    uars=st.tuples(st.floats(0.0, 1.0), st.floats(0.0, 1.0)),
    f1s=st.tuples(st.floats(0.0, 1.0), st.floats(0.0, 1.0)),
    rate=st.floats(0.0, 60.0),
    duration=st.floats(0.0, 30.0),
    with_stability=st.booleans(),
    thresholds=st.tuples(st.sampled_from([0.0, 0.0025, 0.05]), st.sampled_from([0.0, 0.0025, 0.05]),
                         st.sampled_from([10.0, 25.0]), st.sampled_from([0.0, 2.5])),
)
def test_decision_matches(uars, f1s, rate, duration, with_stability, thresholds) -> None:
    decisions = []
    for module, config_class in ((gate, QualityGateConfig), (jax_gate, JaxQualityGateConfig)):
        decisions.append(module.decide_quality_gate(
            baseline=module.ProfileEvaluation("fast", uars[0], f1s[0], 4),
            candidate=module.ProfileEvaluation("accurate", uars[1], f1s[1], 4),
            candidate_stability=module.TemporalStability(rate, duration) if with_stability else None,
            config=config_class(*thresholds),
        ))
    ours, theirs = decisions
    assert (ours.promote, ours.reasons) == (theirs.promote, theirs.reasons)
    assert ours.to_json() == theirs.to_json()


def _decisions(promote: bool):
    out = []
    for module, config_class in ((gate, QualityGateConfig), (jax_gate, JaxQualityGateConfig)):
        out.append(module.decide_quality_gate(
            baseline=module.ProfileEvaluation("fast", 0.5, 0.5, 3),
            candidate=module.ProfileEvaluation("accurate", 0.75 if promote else 0.25, 0.7 if promote else 0.2, 3),
            candidate_stability=module.TemporalStability(12.0, 3.0),
            config=config_class(),
        ))
    return out


@pytest.mark.parametrize("promote", [True, False])
def test_report_bytes_match(promote: bool, tmp_path: Path, monkeypatch: pytest.MonkeyPatch) -> None:
    ours, theirs = _decisions(promote)
    monkeypatch.setattr(report.time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(jax_report.time, "time", lambda: 1700000000.25)
    payloads = (report.build_report_payload(ours, corpus="/corpus"),
                jax_report.build_report_payload(theirs, corpus="/corpus"))
    assert payloads[0] == payloads[1]
    written = report.write_gate_report(payloads[0], tmp_path / "ours" / "gate.json")
    jax_written = jax_report.write_gate_report(payloads[1], tmp_path / "theirs" / "gate.json")
    assert written.read_bytes() == jax_written.read_bytes()
    assert sorted(p.name for p in written.parent.iterdir()) == ["gate.json"]  # no staging file left
    assert report.load_gate_report(written) == jax_report.load_gate_report(written) == payloads[0]
    assert report.resolve_report_output_path(output_path=None, default_directory=tmp_path) == (
        tmp_path / report.DEFAULT_REPORT_FILE_NAME) == jax_report.resolve_report_output_path(
        output_path=None, default_directory=tmp_path)
    if promote:
        report.enforce_quality_gate(ours, require_pass=True)
    else:
        with pytest.raises(report.QualityGateFailedError):
            report.enforce_quality_gate(ours, require_pass=True)
        report.enforce_quality_gate(ours, require_pass=False)
    (tmp_path / "stale.json").write_text(json.dumps({**payloads[0], "schema_version": 0}))
    assert report.load_gate_report(tmp_path / "stale.json") is None is report.load_gate_report(tmp_path / "none")


@pytest.mark.parametrize("outcome", ["promote", "hold", "unusable"])
@pytest.mark.parametrize("require_pass", [False, True])
def test_workflow_exit_codes_match(outcome: str, require_pass: bool, tmp_path: Path,
                                   monkeypatch: pytest.MonkeyPatch, capsys) -> None:
    ours, theirs = _decisions(outcome == "promote")

    def evaluation(decision):
        def evaluate(**_):
            if outcome == "unusable":
                raise RuntimeError("Quality gate needs a labeled corpus of at least 8 clips (SER_DATASET_FOLDER).")
            return decision
        return evaluate

    monkeypatch.setattr(workflow, "evaluate_candidate_gate", evaluation(ours))
    monkeypatch.setattr(jax_workflow, "evaluate_candidate_gate", evaluation(theirs))
    codes = []
    for module, settings_ in ((workflow, build_settings({"SER_MODELS_FOLDER": str(tmp_path / "ours")})),
                              (jax_workflow, jax_build(jax_capture(env={"SER_MODELS_FOLDER": str(tmp_path / "jax")})))):
        codes.append(module.run_quality_gate_workflow(settings=settings_, candidate="accurate",
                                                      require_pass=require_pass))
    expected = {"promote": 0, "hold": 1 if require_pass else 0, "unusable": 2}[outcome]
    assert codes == [expected, expected]
    written = sorted((tmp_path / "ours").glob("*.json")), sorted((tmp_path / "jax").glob("*.json"))
    assert [p.name for p in written[0]] == [p.name for p in written[1]] == (
        [] if outcome == "unusable" else [report.DEFAULT_REPORT_FILE_NAME])
    for ours_path, theirs_path in zip(*written):
        ours_payload, theirs_payload = json.loads(ours_path.read_text()), json.loads(theirs_path.read_text())
        for payload in (ours_payload, theirs_payload):
            payload.pop("generated_at_unix")
            payload.pop("corpus")
        assert ours_payload == theirs_payload


class _NearestCentroid:
    """A deterministic stand-in for the MLP heads: each class's float64 mean, the nearest one wins."""

    def __init__(self) -> None:
        self.max_iter = 500

    @classmethod
    def from_config(cls, config, *, device=None):
        return cls()

    def fit(self, features, labels):
        features = np.asarray(features, dtype=np.float64)
        self.classes_ = sorted(set(labels))
        self.centroids_ = np.stack([features[[y == c for y in labels]].mean(axis=0) for c in self.classes_])
        return self

    def predict(self, features):
        distances = ((np.asarray(features, dtype=np.float64)[:, None, :] - self.centroids_[None]) ** 2).sum(-1)
        return np.asarray(self.classes_)[np.argmin(distances, axis=1)]


def _planted_hook(request):
    """A backend hook whose segments follow the clip's name: 2 or 3 segments over its 1.2 s."""
    name = Path(request.file_path).name
    cut = 0.4 + 0.1 * (int(name.split("-")[2]) % 3)
    segments = [{"emotion": "calm", "start_seconds": 0.0, "end_seconds": cut},
                {"emotion": "sad", "start_seconds": cut, "end_seconds": 1.2}]
    if name.endswith("-02.wav"):
        segments.append({"emotion": "sad", "start_seconds": 1.2, "end_seconds": 1.2})
    return segments


@pytest.fixture(scope="module")
def gate_runs(tmp_path_factory):
    import transformers

    from ser_tpu._internal.runtime import backend_hooks as jax_backend_hooks
    from ser_tpu_torch._internal.repr import encoders
    from ser_tpu_torch._internal.runtime import backend_hooks

    root = tmp_path_factory.mktemp("quality_gate")
    for path in build_dataset(root / "ds", actors=3, repetitions=1, seconds=1.2):
        if int(path.name.split("-")[2]) > 4:
            path.unlink()
    cfg = transformers.WhisperConfig(
        vocab_size=320, num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        decoder_layers=1, decoder_attention_heads=4, encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=1500, max_target_positions=64, activation_function="gelu",
        decoder_start_token_id=1, bos_token_id=1, eos_token_id=2, pad_token_id=0,
    )
    torch.manual_seed(0)
    transformers.WhisperModel(cfg).eval().save_pretrained(
        root / "cache" / "model-cache" / "huggingface" / "openai" / "whisper-large-v3", safe_serialization=True)
    env = {"SER_DATASET_FOLDER": str(root / "ds"), "SER_CACHE_DIR": str(root / "cache"),
           "SER_MODELS_FOLDER": str(root / "models"), "SER_TORCH_DEVICE": "cpu", "SER_ENABLE_ACCURATE_PROFILE": "1"}

    runs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(encoders, "_BACKEND_CACHE", {})
        for name, module, gate_module, hooks_module, settings_, segment in (
            ("ours", workflow, gate, backend_hooks, build_settings(env), SegmentPrediction),
            ("theirs", jax_workflow, jax_gate, jax_backend_hooks, jax_build(jax_capture(env=dict(env))),
             JaxSegmentPrediction),
        ):
            calls = []
            original = gate_module.evaluate_head_cross_folds

            def recording(features, labels, speakers, *, _original=original, _calls=calls, **options):
                _calls.append({"features": np.asarray(features), "labels": list(labels),
                               "speakers": list(speakers), "clip_ids": options.get("clip_ids")})
                return _original(features, labels, speakers, **options)

            def hooks(settings, _segment=segment):
                def hook(request):
                    return type("Result", (), {"segments": [_segment(confidence=1.0, **s)
                                                            for s in _planted_hook(request)]})()
                return {"jax_whisper_encoder": hook}

            patch.setattr(module, "evaluate_head_cross_folds", recording)
            patch.setattr(gate_module, "TorchMLPClassifier" if module is workflow else "JaxMLPClassifier",
                          _NearestCentroid)
            patch.setattr(hooks_module, "build_backend_hooks", hooks)
            decision = module.evaluate_candidate_gate(settings=settings_, candidate="accurate", folds=3)
            runs[name] = {"decision": decision, "calls": calls, "settings": settings_}
    torch.set_num_threads(threads)
    return runs


def test_gate_rows_match(gate_runs) -> None:
    ours, theirs = gate_runs["ours"]["calls"], gate_runs["theirs"]["calls"]
    assert len(ours) == len(theirs) == 2
    fast, fast_ref = ours[0]["features"], theirs[0]["features"]
    assert fast.shape == fast_ref.shape == (12, 193)
    for family, (cols, atol) in FAST_FAMILIES.items():
        np.testing.assert_allclose(fast[:, cols], fast_ref[:, cols], rtol=FAST_RTOL,
                                   atol=atol * max(1.0, float(np.abs(fast_ref[:, cols]).max())), err_msg=family)
    rows, rows_ref = ours[1]["features"], theirs[1]["features"]
    assert rows.shape == rows_ref.shape and rows.shape[1] == 128
    np.testing.assert_allclose(rows, rows_ref, atol=ROW_ATOL, rtol=0)
    for key in ("labels", "speakers"):
        assert ours[0][key] == theirs[0][key] and ours[1][key] == theirs[1][key]
    assert [Path(c).name for c in ours[1]["clip_ids"]] == [Path(c).name for c in theirs[1]["clip_ids"]]


def test_gate_folds_match(gate_runs) -> None:
    from ser_tpu._internal.train.eval import stratified_group_folds as jax_folds
    from ser_tpu_torch._internal.train.eval import stratified_group_folds

    for call in gate_runs["ours"]["calls"]:
        items = list(range(len(call["labels"])))
        options = {"speaker_of": lambda i: call["speakers"][i], "label_of": lambda i: call["labels"][i],
                   "n_folds": 3, "random_state": gate_runs["ours"]["settings"].training.random_state}
        assert stratified_group_folds(items, **options) == jax_folds(items, **options)


def test_gate_decision_matches(gate_runs) -> None:
    ours, theirs = gate_runs["ours"]["decision"], gate_runs["theirs"]["decision"]
    assert dataclasses.asdict(ours.baseline) == dataclasses.asdict(theirs.baseline)
    assert dataclasses.asdict(ours.candidate) == dataclasses.asdict(theirs.candidate)
    assert ours.candidate.folds == 3 and ours.candidate_stability is not None
    assert dataclasses.asdict(ours.candidate_stability) == dataclasses.asdict(theirs.candidate_stability)
    assert (ours.promote, ours.reasons) == (theirs.promote, theirs.reasons)
