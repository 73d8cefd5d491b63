"""The port's data layer against ``ser_tpu``'s, on the same inputs.

- ontology: ``normalize_label``, ``remap_label`` under each policy and
  ``resolve_label_ontology`` from the same variables give the same labels
  and raise alike;
- manifests: a file the port writes is byte for byte the JAX package's, and
  each package reads the other's (relative audio paths resolved against the
  manifest's folder); bad records raise ``ManifestError`` in both;
  ``normalized_pcm_sha256`` gives the same digests;
- recipes and audits: the built-in and a JSON recipe have byte-equal
  digests; routing, the findings audit and both ledgers (counters, ledger
  records, manifest and ledger digests, the strict errors) are equal;
- the registry: each package reads the records the other registered in the
  same file, the file's bytes are the same, and the health audits agree
  (missing root and manifest, count mismatch, unreadable manifest, Git LFS
  pointers);
- the embedding cache: the same file name for the same identity, entries read
  across packages, corrupt entries dropped and classified alike
  (``classify_failure``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
from collections.abc import Iterator
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.data import dataset_audit as jax_audit
from ser_tpu._internal.data import embedding_cache as jax_cache
from ser_tpu._internal.data import manifest as jax_manifest
from ser_tpu._internal.data import ontology as jax_ontology
from ser_tpu._internal.data import recipe as jax_recipe
from ser_tpu._internal.data import registry as jax_registry
from ser_tpu._internal.models import training_readiness as jax_readiness
from ser_tpu._internal.repr.backend import EncodedSequence as JaxEncodedSequence
from ser_tpu._internal.utils import audio_io as jax_audio_io
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.data import dataset_audit, embedding_cache, manifest, ontology, recipe, registry
from ser_tpu_torch._internal.models import training_readiness
from ser_tpu_torch._internal.repr import EncodedSequence
from ser_tpu_torch._internal.utils import audio_io


def _digest(seed: str) -> str:
    return hashlib.sha256(seed.encode()).hexdigest()


def _both_settings(env: dict):
    return build_settings(env), build_settings_from_inputs(capture_settings_inputs(env))


def _outcome(fn, *args, **kwargs):
    """``("ok", value)`` or ``("raise", error type name, message)``."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as err:  # noqa: BLE001 - the kind and message are compared
        return ("raise", type(err).__name__, str(err))


# --------------------------------------------------------------------------- #
# Ontology
# --------------------------------------------------------------------------- #

RAW_LABELS = ["Happy", " sad ", "01", "05", "boredom", "", "other", "NEUTRAL"]
MAPPINGS = [None, {"01": "neutral", "05": "angry", "happy": "happy"}]


@pytest.mark.parametrize("policy", ["drop", "map_to_other", "error"])
@pytest.mark.parametrize("mapping", MAPPINGS, ids=["no-map", "map"])
@pytest.mark.parametrize("allowed_other", [True, False], ids=["other-allowed", "other-not-allowed"])
def test_remap_label_matches_ser_tpu(policy, mapping, allowed_other) -> None:
    allowed = {"happy", "sad", "neutral", "angry"} | ({"other"} if allowed_other else set())
    ours = ontology.LabelOntology("t", frozenset(allowed), policy)
    theirs = jax_ontology.LabelOntology("t", frozenset(allowed), policy)
    for raw in RAW_LABELS:
        assert _outcome(ontology.remap_label, raw_label=raw, mapping=mapping, ontology=ours) == _outcome(
            jax_ontology.remap_label, raw_label=raw, mapping=mapping, ontology=theirs
        )
        assert ontology.normalize_label(raw) == jax_ontology.normalize_label(raw)


@pytest.mark.parametrize(
    "env",
    [{}, {"SER_ALLOWED_LABELS": "Happy, sad,other", "SER_UNKNOWN_LABEL_POLICY": "MAP_TO_OTHER",
          "SER_LABEL_ONTOLOGY_ID": "custom", "SER_OTHER_LABEL": " Other "},
     {"SER_UNKNOWN_LABEL_POLICY": "nonsense"}],
    ids=["defaults", "overrides", "bad-policy"],
)
def test_resolve_label_ontology_matches_ser_tpu(env) -> None:
    ours, theirs = _both_settings(env)
    assert dataclasses.asdict(ontology.resolve_label_ontology(ours)) == dataclasses.asdict(
        jax_ontology.resolve_label_ontology(theirs)
    )


# --------------------------------------------------------------------------- #
# Manifests
# --------------------------------------------------------------------------- #


def _records(base: Path) -> list[dict]:
    """v1 and v2 records over the optional fields, audio paths relative and absolute."""
    return [
        {"schema_version": 1, "sample_id": "r1", "corpus": "ravdess", "audio_path": "audio/a.wav", "label": "Happy",
         "speaker_id": "ravdess:01", "split": "train", "normalized_audio_sha256": _digest("a")},
        {"schema_version": 2, "sample_id": "r2", "corpus": "msp-podcast", "audio_path": str(base / "abs" / "b.wav"),
         "vad": {"valence": 0.5, "arousal": -0.25, "dominance": 1}, "language": "en", "transcript": "hello there",
         "annotations": [{"target": "vad", "source": "crowd", "confidence": 0.75}, {"target": "text", "source": "asr"}],
         "session_id": "msp-podcast:s1", "start_seconds": 1.5, "duration_seconds": 2.25, "dataset_revision": "v1.11",
         "dataset_policy_id": "p", "dataset_license_id": "l", "source_url": "https://example.org/b"},
        {"sample_id": "r3", "corpus": "att-hack", "path": "c.wav", "label": "friendly", "raw_label": "amical",
         "social_attitude": "friendly", "native_split": "test", "split": "validation"},
        {"schema_version": 2, "sample_id": "r4", "corpus": "coraa-ser", "audio_path": "d.wav",
         "binary_affect": "non_neutral_female", "language": "pt"},
    ]


def _write_raw(path: Path, records: list[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = ["# a comment", ""] + [json.dumps(record) for record in records]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def test_manifest_reads_alike_and_writes_the_same_bytes(tmp_path) -> None:
    source = tmp_path / "in" / "manifest.jsonl"
    _write_raw(source, _records(tmp_path))
    ours = manifest.read_manifest_jsonl(source)
    theirs = jax_manifest.read_manifest_jsonl(source)
    assert [u.to_record() for u in ours] == [u.to_record() for u in theirs]
    assert ours[0].audio_path == str(source.parent / "audio" / "a.wav")
    for package, utterances, name in ((manifest, ours, "port.jsonl"), (jax_manifest, theirs, "jax.jsonl")):
        package.write_manifest_jsonl(utterances, tmp_path / "in" / name)
    assert (tmp_path / "in" / "port.jsonl").read_bytes() == (tmp_path / "in" / "jax.jsonl").read_bytes()
    assert '"audio_path": "audio/a.wav"' in (tmp_path / "in" / "port.jsonl").read_text()


@pytest.mark.parametrize("writer", ["port", "ser_tpu"])
def test_manifest_round_trip_across_packages(tmp_path, writer: str) -> None:
    source = tmp_path / "manifest.jsonl"
    _write_raw(source, _records(tmp_path))
    write_with, read_with = (manifest, jax_manifest) if writer == "port" else (jax_manifest, manifest)
    written = tmp_path / "out" / "m.jsonl"
    write_with.write_manifest_jsonl(write_with.read_manifest_jsonl(source), written, base_dir=tmp_path)
    back = read_with.load_manifest_jsonl(written, base_dir=tmp_path)
    assert [u.to_record() for u in back] == [u.to_record() for u in write_with.read_manifest_jsonl(source)]


BAD_RECORDS = {
    "missing-fields": {"sample_id": "x", "corpus": "ravdess"},
    "v1-without-label": {"schema_version": 1, "sample_id": "x", "corpus": "c", "audio_path": "a.wav"},
    "v2-without-target": {"schema_version": 2, "sample_id": "x", "corpus": "c", "audio_path": "a.wav"},
    "bad-version": {"schema_version": 7, "sample_id": "x", "corpus": "c", "audio_path": "a.wav", "label": "sad"},
    "bool-version": {"schema_version": True, "sample_id": "x", "corpus": "c", "audio_path": "a.wav", "label": "sad"},
    "unknown-label": {"sample_id": "x", "corpus": "c", "audio_path": "a.wav", "label": "ecstatic"},
    "unscoped-speaker": {"sample_id": "x", "corpus": "c", "audio_path": "a.wav", "label": "sad", "speaker_id": "01"},
    "vad-out-of-range": {"schema_version": 2, "sample_id": "x", "corpus": "c", "audio_path": "a.wav",
                         "vad": {"valence": 2, "arousal": 0, "dominance": 0}},
    "bad-digest": {"sample_id": "x", "corpus": "c", "audio_path": "a.wav", "label": "sad",
                   "normalized_audio_sha256": "ABC"},
    "duplicate-annotation": {"schema_version": 2, "sample_id": "x", "corpus": "c", "audio_path": "a.wav",
                             "language": "en", "annotations": [{"target": "language", "source": "a"},
                                                               {"target": "language", "source": "b"}]},
    "negative-start": {"sample_id": "x", "corpus": "c", "audio_path": "a.wav", "label": "sad", "start_seconds": -1},
    "not-an-object": [1, 2],
}


@pytest.mark.parametrize("case", sorted(BAD_RECORDS))
def test_bad_manifest_records_raise_alike(tmp_path, case: str) -> None:
    path = tmp_path / "bad.jsonl"
    _write_raw(path, [BAD_RECORDS[case]])
    ours = _outcome(manifest.read_manifest_jsonl, path)
    theirs = _outcome(jax_manifest.read_manifest_jsonl, path)
    assert ours[0] == "raise" and ours == theirs


def test_duplicate_sample_ids_and_bad_json_raise_alike(tmp_path) -> None:
    record = {"sample_id": "x", "corpus": "c", "audio_path": "a.wav", "label": "sad"}
    duplicate = tmp_path / "dup.jsonl"
    _write_raw(duplicate, [record, record])
    assert _outcome(manifest.read_manifest_jsonl, duplicate) == _outcome(jax_manifest.read_manifest_jsonl, duplicate)
    broken = tmp_path / "broken.jsonl"
    broken.write_text('{"sample_id": \n', encoding="utf-8")
    ours = _outcome(manifest.read_manifest_jsonl, broken)
    assert ours[0] == "raise" and ours == _outcome(jax_manifest.read_manifest_jsonl, broken)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
def test_normalized_pcm_digest_matches_ser_tpu(dtype) -> None:
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(4001) * 1000).astype(dtype)
    assert manifest.normalized_pcm_sha256(audio) == jax_manifest.normalized_pcm_sha256(audio)
    strided = audio[::3]  # not contiguous
    assert manifest.normalized_pcm_sha256(strided) == jax_manifest.normalized_pcm_sha256(strided)


# --------------------------------------------------------------------------- #
# Recipes and audits
# --------------------------------------------------------------------------- #


def _corpus_rows(package, *, seed: int = 0, n: int = 60, with_revision: bool = True) -> list:
    """Utterances of several corpora and targets, in one package's type."""
    rng = np.random.default_rng(seed)
    corpora = ["ravdess", "crema-d", "emodb-2.0", "escorpus-pe", "att-hack", "unknown-corpus", "pavoque"]
    labels = list(package.PRIMARY_EMOTIONS)
    rows = []
    for i in range(n):
        corpus = corpora[i % len(corpora)]
        label = labels[int(rng.integers(len(labels)))] if corpus not in ("att-hack", "pavoque") else None
        raw = "boredom" if corpus in ("emodb-2.0", "escorpus-pe") and i % 3 == 0 else None
        rows.append(
            package.Utterance(
                sample_id=f"{corpus}-{i:03d}",
                corpus=corpus,
                audio_path=f"/data/{corpus}/{i}.wav",
                label=label,
                raw_label=raw,
                speaker_id=f"{corpus}:spk{int(rng.integers(6))}" if i % 11 else None,
                session_id=f"{corpus}:sess{i % 4}" if i % 5 == 0 else None,
                language="en" if i % 2 else None,
                transcript="words" if corpus == "att-hack" else None,
                social_attitude="friendly" if corpus == "att-hack" else None,
                normalized_audio_sha256=_digest(f"{i % 57}"),  # three content duplicates
                dataset_revision="r1" if with_revision else None,
                vad=package.VadTarget(0.1, 0.2, 0.3) if corpus == "escorpus-pe" else None,
            )
        )
    return rows


def _recipe_json(path: Path) -> Path:
    path.write_text(json.dumps({
        "schema_version": 1, "recipe_id": "custom", "revision": "3", "ontology_version": "canonical-eight-v1",
        "corpora": [
            {"corpus": "ravdess", "exact_primary_labels": ["Happy", "sad", "angry", "neutral"]},
            {"corpus": "crema-d", "exact_primary_labels": ["happy", "sad"], "approximate_labels": ["Boredom"],
             "auxiliary_tasks": ["vad", "language"]},
            {"corpus": "att-hack", "auxiliary_tasks": ["attitude", "text_alignment"]},
        ],
    }), encoding="utf-8")
    return path


@pytest.mark.parametrize("source", ["research-v1", "json"])
def test_recipe_digest_is_byte_equal(tmp_path, source: str) -> None:
    value = "research-v1" if source == "research-v1" else str(_recipe_json(tmp_path / "recipe.json"))
    ours, theirs = recipe.load_dataset_recipe(value), jax_recipe.load_dataset_recipe(value)
    assert ours.to_record() == theirs.to_record() and ours.digest == theirs.digest
    expected = hashlib.sha256(json.dumps(theirs.to_record(), sort_keys=True, separators=(",", ":")).encode()).hexdigest()
    assert ours.digest == expected


def test_bad_recipes_raise_alike(tmp_path) -> None:
    for index, payload in enumerate([
        [], {"corpora": "x"}, {"corpora": [{"corpus": ""}]}, {"corpora": [{"corpus": "a", "auxiliary_tasks": [1]}]},
        {"schema_version": 1, "recipe_id": "r", "revision": "1", "ontology_version": "o", "corpora": []},
        {"schema_version": 1, "recipe_id": "r", "revision": "1", "ontology_version": "o",
         "corpora": [{"corpus": "a", "exact_primary_labels": ["boredom"]}]},
        {"schema_version": 2, "recipe_id": "r", "revision": "1", "ontology_version": "o", "corpora": [{"corpus": "a"}]},
    ]):
        path = tmp_path / f"bad{index}.json"
        path.write_text(json.dumps(payload), encoding="utf-8")
        ours = _outcome(recipe.load_dataset_recipe, str(path))
        assert ours[0] == "raise" and ours == _outcome(jax_recipe.load_dataset_recipe, str(path))


@pytest.mark.parametrize("source", ["research-v1", "json"])
def test_routing_and_findings_audit_match_ser_tpu(tmp_path, source: str) -> None:
    value = "research-v1" if source == "research-v1" else str(_recipe_json(tmp_path / "recipe.json"))
    ours_recipe, theirs_recipe = recipe.load_dataset_recipe(value), jax_recipe.load_dataset_recipe(value)
    ours_rows, theirs_rows = _corpus_rows(manifest), _corpus_rows(jax_manifest)
    for ours, theirs in zip(ours_rows, theirs_rows, strict=True):
        a, b = recipe.route_utterance(ours, ours_recipe), jax_recipe.route_utterance(theirs, theirs_recipe)
        assert (a.disposition, sorted(a.tasks), a.reason) == (b.disposition, sorted(b.tasks), b.reason)
    for strict in (False, True):
        a = recipe.audit_recipe(ours_rows, ours_recipe, strict=strict)
        b = jax_recipe.audit_recipe(theirs_rows, theirs_recipe, strict=strict)
        assert [dataclasses.astuple(i) for i in a.issues] == [dataclasses.astuple(i) for i in b.issues]


def _report_view(report) -> dict:
    return {
        "manifest_digest": report.manifest_digest,
        "ledger_digest": report.ledger_digest,
        "counters": report.counters,
        "ledger": [entry.to_record() for entry in report.ledger],
        "recipe": (report.recipe_id, report.recipe_revision, report.recipe_digest),
    }


@pytest.mark.parametrize("strict", [False, True], ids=["lenient", "strict"])
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_split_ledger_matches_ser_tpu(strict: bool, seed: int) -> None:
    ours = _outcome(dataset_audit.build_split_ledger, _corpus_rows(manifest), seed=seed, strict=strict)
    theirs = _outcome(jax_audit.build_split_ledger, _corpus_rows(jax_manifest), seed=seed, strict=strict)
    if ours[0] == "ok":
        assert theirs[0] == "ok" and _report_view(ours[1]) == _report_view(theirs[1])
    else:
        assert ours == theirs


@pytest.mark.parametrize("strict", [False, True], ids=["lenient", "strict"])
@pytest.mark.parametrize("source", ["research-v1", "json"])
def test_recipe_audit_ledger_matches_ser_tpu(tmp_path, strict: bool, source: str) -> None:
    value = "research-v1" if source == "research-v1" else str(_recipe_json(tmp_path / "recipe.json"))
    # Strict audits refuse duplicate content: give every row its own digest there.
    def rows(package):
        out = _corpus_rows(package, seed=4)
        if strict:
            out = [dataclasses.replace(u, normalized_audio_sha256=_digest(u.sample_id)) for u in out]
        return out

    ours = _outcome(dataset_audit.audit_dataset_recipe, rows(manifest), recipe=recipe.load_dataset_recipe(value),
                    seed=17, strict=strict)
    theirs = _outcome(jax_audit.audit_dataset_recipe, rows(jax_manifest), recipe=jax_recipe.load_dataset_recipe(value),
                      seed=17, strict=strict)
    if ours[0] == "ok":
        assert theirs[0] == "ok" and _report_view(ours[1]) == _report_view(theirs[1])
    else:
        assert ours == theirs


def test_strict_recipe_audit_errors_match_ser_tpu() -> None:
    research = recipe.research_recipe_v1(), jax_recipe.research_recipe_v1()
    cases = {
        "duplicate-content": lambda pkg: _corpus_rows(pkg),
        "missing-revision": lambda pkg: [
            dataclasses.replace(u, normalized_audio_sha256=_digest(u.sample_id))
            for u in _corpus_rows(pkg, with_revision=False)
        ],
        "missing-digest": lambda pkg: [dataclasses.replace(u, normalized_audio_sha256=None) for u in _corpus_rows(pkg)],
    }
    for build in cases.values():
        ours = _outcome(dataset_audit.audit_dataset_recipe, build(manifest), recipe=research[0], strict=True)
        theirs = _outcome(jax_audit.audit_dataset_recipe, build(jax_manifest), recipe=research[1], strict=True)
        assert ours[0] == "raise" and ours == theirs


# --------------------------------------------------------------------------- #
# The registry
# --------------------------------------------------------------------------- #


def _registry_settings(tmp_path, *, registry_root: bool):
    env = {"SER_MODELS_FOLDER": str(tmp_path / "data" / "models"), "SER_DATASET_FOLDER": str(tmp_path / "ds")}
    if registry_root:
        env["SER_DATASET_REGISTRY_ROOT"] = str(tmp_path / "registry")
    return _both_settings(env)


@pytest.mark.parametrize("registry_root", [True, False], ids=["registry-root", "beside-models"])
@pytest.mark.parametrize("writer", ["port", "ser_tpu"])
def test_registry_file_is_shared(tmp_path, writer: str, registry_root: bool) -> None:
    ours_settings, theirs_settings = _registry_settings(tmp_path, registry_root=registry_root)
    assert registry._registry_path(ours_settings) == jax_registry._registry_path(theirs_settings)
    write_pkg, write_settings = (registry, ours_settings) if writer == "port" else (jax_registry, theirs_settings)
    read_pkg, read_settings = (jax_registry, theirs_settings) if writer == "port" else (registry, ours_settings)
    for dataset_id in ("ravdess", "crema-d"):
        write_pkg.register_dataset(
            write_pkg.DatasetRegistryRecord(
                dataset_id=dataset_id, dataset_root=str(tmp_path / dataset_id), manifest_path=str(tmp_path / "m.jsonl"),
                utterance_count=3, revision="r1", prepared_at_unix=1700000000.5, options={"labels_csv_path": "x.csv"},
            ),
            settings=write_settings,
        )
    records = [dataclasses.asdict(r) for r in read_pkg.list_registered_datasets(settings=read_settings)]
    assert records == [dataclasses.asdict(r) for r in write_pkg.list_registered_datasets(settings=write_settings)]
    path = registry._registry_path(ours_settings)
    written = path.read_bytes()
    # The other package rewrites the same bytes for the same records.
    read_pkg.register_dataset(read_pkg.DatasetRegistryRecord(**records[0]), settings=read_settings)
    assert path.read_bytes() == written
    removed = read_pkg.unregister_dataset("crema-d", settings=read_settings)
    assert removed is not None and dataclasses.asdict(removed) == {r["dataset_id"]: r for r in records}["crema-d"]
    assert [r.dataset_id for r in write_pkg.list_registered_datasets(settings=write_settings)] == ["ravdess"]


def test_registry_health_audit_matches_ser_tpu(tmp_path) -> None:
    ours_settings, theirs_settings = _registry_settings(tmp_path, registry_root=True)
    root = tmp_path / "corpus"
    root.mkdir()
    good = root / "good.jsonl"
    _write_raw(good, [{"sample_id": f"g{i}", "corpus": "ravdess", "audio_path": f"g{i}.wav", "label": "sad"}
                      for i in range(2)])
    lfs = root / "lfs.jsonl"
    pointer = root / "pointer.wav"
    pointer.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:" + "0" * 64 + "\nsize 12\n")
    _write_raw(lfs, [{"sample_id": "p", "corpus": "ravdess", "audio_path": "pointer.wav", "label": "sad"}])
    unreadable = root / "bad.jsonl"
    unreadable.write_text("{not json\n", encoding="utf-8")
    entries = [("good", root, good, 2), ("count", root, good, 5), ("lfs", root, lfs, 1),
               ("noroot", tmp_path / "absent", good, 2), ("nomanifest", root, root / "absent.jsonl", 1),
               ("unreadable", root, unreadable, 1)]
    for dataset_id, dataset_root, manifest_path, count in entries:
        registry.register_dataset(
            registry.DatasetRegistryRecord(dataset_id, str(dataset_root), str(manifest_path), count), settings=ours_settings
        )
    assert audio_io.is_git_lfs_pointer(pointer) and jax_audio_io.is_git_lfs_pointer(pointer)
    ours = [dataclasses.astuple(i) for i in registry.audit_registry_health(settings=ours_settings)]
    theirs = [dataclasses.astuple(i) for i in jax_registry.audit_registry_health(settings=theirs_settings)]
    assert ours == theirs
    assert {kind for _, kind, _ in ours} == {"count_mismatch", "lfs_pointer", "missing_root", "missing_manifest",
                                              "unreadable_manifest"}


# --------------------------------------------------------------------------- #
# The embedding cache and the failure taxonomy
# --------------------------------------------------------------------------- #

IDENTITY = dict(backend_id="jax_xlsr", model_id="facebook/wav2vec2-xls-r-300m", revision="main", device="cuda",
                dtype="bfloat16")


def _sequence(sequence_type, seed: int = 0):
    rng = np.random.default_rng(seed)
    starts = np.arange(5, dtype=np.float64) * 0.02
    return sequence_type(
        embeddings=rng.standard_normal((5, 8)).astype(np.float32), frame_start_seconds=starts,
        frame_end_seconds=starts + 0.02, backend_id="jax_xlsr",
    )


@pytest.mark.parametrize("keyed_by", ["audio", "file"])
@pytest.mark.parametrize("writer", ["port", "ser_tpu"])
def test_embedding_cache_entries_are_shared(tmp_path, writer: str, keyed_by: str) -> None:
    clip = tmp_path / "clip.wav"
    clip.write_bytes(b"RIFF-not-decoded-here" * 10)
    audio = np.random.default_rng(1).standard_normal(1600).astype(np.float32) if keyed_by == "audio" else None
    ours = embedding_cache.EmbeddingCache(root=tmp_path / "cache", **IDENTITY)
    theirs = jax_cache.EmbeddingCache(root=tmp_path / "cache", **IDENTITY)
    assert ours._path_for(ours._key(str(clip), audio)) == theirs._path_for(theirs._key(str(clip), audio))
    if writer == "port":
        stored = ours.store(str(clip), _sequence(EncodedSequence), audio=audio)
        loaded = theirs.load(str(clip), audio=audio)
    else:
        stored = theirs.store(str(clip), _sequence(JaxEncodedSequence), audio=audio)
        loaded = ours.load(str(clip), audio=audio)
    expected = _sequence(EncodedSequence)
    assert stored.exists() and loaded is not None and loaded.backend_id == "jax_xlsr"
    np.testing.assert_array_equal(loaded.embeddings, expected.embeddings)
    np.testing.assert_array_equal(loaded.frame_end_seconds, expected.frame_end_seconds)
    assert not list(stored.parent.glob("*.tmp.*"))


@contextmanager
def _package_records(caplog, package: str, level: int | str = logging.WARNING) -> Iterator[None]:
    """``caplog`` at ``level`` with its handler on ``package``'s root logger itself, for the scope.

    The package's ``configure_logging`` (which an in-process CLI run calls)
    stops that logger propagating, once per process; ``caplog`` listens on the
    root logger and would then miss the records of any later test in the
    process. Propagation is off for the scope, so each record reaches the
    handler once.
    """
    logger = logging.getLogger(package)
    propagate = logger.propagate
    logger.addHandler(caplog.handler)
    logger.propagate = False
    try:
        with caplog.at_level(level, logger=package):
            yield
    finally:
        logger.removeHandler(caplog.handler)
        logger.propagate = propagate


@pytest.mark.parametrize("package", ["port", "ser_tpu"])
def test_corrupt_cache_entry_is_dropped(tmp_path, package: str, caplog) -> None:
    cache_type = embedding_cache.EmbeddingCache if package == "port" else jax_cache.EmbeddingCache
    cache = cache_type(root=tmp_path / "cache", **IDENTITY)
    audio = np.ones(800, dtype=np.float32)
    path = cache._path_for(cache._key("clip.wav", audio))
    path.parent.mkdir(parents=True)
    path.write_bytes(b"PK\x03\x04 truncated")
    with _package_records(caplog, "ser_tpu_torch" if package == "port" else "ser_tpu", "WARNING"):
        assert cache.load("clip.wav", audio=audio) is None
    assert not path.exists()
    assert "cache_corrupt -> recompute" in caplog.text


def _errors(package_audio_io, package_readiness, tmp_path: Path) -> list:
    missing = tmp_path / "allowed" / "gone.wav"
    not_found = FileNotFoundError(2, "No such file", str(missing))
    return [
        (package_readiness.CacheEntryCorruptError("bad zip"), "cache", None),
        (package_readiness.WindowContainmentError("flat"), "window", None),
        (package_readiness.OptionalArtifactError("disk"), "optional_artifact", None),
        (package_audio_io.AudioIntegrityError("Git LFS pointer at x.wav"), "sample", None),
        (package_audio_io.AudioDecodeError("Not a RIFF/WAVE file."), "sample", None),
        (TimeoutError("slow disk"), "sample", None),
        (OSError(11, "try again"), "sample", None),
        (not_found, "sample", missing),
        (not_found, "sample", tmp_path / "other.wav"),
        (RuntimeError("novel"), "run", None),
        (ValueError(""), "cache", None),
    ]


def test_classify_failure_matches_ser_tpu(tmp_path) -> None:
    roots = (tmp_path / "allowed",)
    ours_cases = _errors(audio_io, training_readiness, tmp_path)
    theirs_cases = _errors(jax_audio_io, jax_readiness, tmp_path)
    for (error, scope, sample), (jax_error, _, _) in zip(ours_cases, theirs_cases, strict=True):
        a = training_readiness.classify_failure(
            error, scope=training_readiness.FailureScope(scope), sample_path=sample, allowed_roots=roots
        )
        b = jax_readiness.classify_failure(
            jax_error, scope=jax_readiness.FailureScope(scope), sample_path=sample, allowed_roots=roots
        )
        assert (a.scope.value, a.reason_code.value, a.disposition.value, a.severity.value, a.diagnostic) == (
            b.scope.value, b.reason_code.value, b.disposition.value, b.severity.value, b.diagnostic
        )


@pytest.mark.parametrize(
    "enum_name", ["FindingScope", "FindingSeverity", "FailureScope", "FailureDisposition", "FailureReasonCode"]
)
def test_taxonomy_values_match_ser_tpu(enum_name: str) -> None:
    ours = [(m.name, m.value) for m in getattr(training_readiness, enum_name)]
    assert ours == [(m.name, m.value) for m in getattr(jax_readiness, enum_name)]
