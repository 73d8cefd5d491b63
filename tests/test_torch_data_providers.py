"""The port's dataset-provider half of the data layer against ``ser_tpu``'s, offline, on the CPU.

Both packages get the same inputs and must give the same outputs:

- the 16 catalog specs, the capability profiles and the ``data catalog``
  JSON payload;
- the labels of the same file names for all 16 catalog ids (staged trees
  through ``prepare_dataset``: the manifests byte for byte), and of the
  label functions of ``strategies`` and ``adapters`` one name at a time;
- the same parses of the same Zenodo, OpenSLR, GitHub, Git LFS, Mendeley and
  JL-corpus payloads (or the same refusal);
- the same retry classification and the same attempts;
- ``fetch_url`` over ``file://``: a full fetch, a resumed one, a planted
  checksum mismatch; ``download_file``'s MD5 and size checks;
- RAVDESS's acquisition workflow over a ``file://`` Zenodo record;
- the registry records and consent files ``prepare_dataset`` and
  ``configure_dataset_consents`` write, each package reading the other's.

No test touches a network: every URL is ``file://``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import urllib.error
import zipfile
from pathlib import Path

import numpy as np
import pytest

from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu._internal.data import adapters as jax_adapters
from ser_tpu._internal.data import capabilities as jax_capabilities
from ser_tpu._internal.data import catalog as jax_catalog
from ser_tpu._internal.data import consents as jax_consents
from ser_tpu._internal.data import downloads as jax_downloads
from ser_tpu._internal.data import prepare as jax_prepare
from ser_tpu._internal.data import provider_prepare as jax_provider_prepare
from ser_tpu._internal.data import provider_resolution as jax_resolution
from ser_tpu._internal.data import provider_transport as jax_transport
from ser_tpu._internal.data import registry as jax_registry
from ser_tpu._internal.data import strategies as jax_strategies
from ser_tpu._internal.data.manifest import read_manifest_jsonl as jax_read_manifest
from ser_tpu._internal.utils.audio_io import write_wav
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.data import (
    adapters,
    capabilities,
    catalog,
    consents,
    downloads,
    prepare,
    provider_prepare,
    provider_resolution,
    provider_transport,
    registry,
    strategies,
)
from ser_tpu_torch._internal.data.manifest import read_manifest_jsonl

# --------------------------------------------------------------------------- #
# Helpers
# --------------------------------------------------------------------------- #


def _env(root: Path, extra: dict | None = None) -> dict:
    return {
        "SER_TMP_FOLDER": str(root / "tmp"),
        "SER_MODELS_FOLDER": str(root / "models"),
        "SER_TORCH_DEVICE": "cpu",
        **(extra or {}),
    }


def _both_settings(root: Path, extra: dict | None = None):
    env = _env(root, extra)
    return build_settings(env), build_settings_from_inputs(capture_settings_inputs(env=env))


def _outcome(call):
    """A call's value, or its exception's type name and message."""
    try:
        return ("ok", call())
    except Exception as err:  # noqa: BLE001 - the outcome is compared, whatever it is
        return ("raised", type(err).__name__, str(err))


def _plain(value):
    """Dataclasses and tuples as plain data, so the two packages' types compare by value."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {field.name: _plain(getattr(value, field.name)) for field in dataclasses.fields(value)}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return {name: _plain(getattr(value, name)) for name in value._fields}
    if isinstance(value, (list, tuple)):
        return [_plain(item) for item in value]
    if isinstance(value, dict):
        return {key: _plain(item) for key, item in value.items()}
    if isinstance(value, Path):
        return str(value)
    return value


def _wav(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tone = (0.3 * np.sin(2 * np.pi * 220 * np.arange(8000) / 16000)).astype(np.float32)
    write_wav(path, tone, 16000)


# --------------------------------------------------------------------------- #
# Catalog and capabilities
# --------------------------------------------------------------------------- #


def test_catalog_specs_match_ser_tpu() -> None:
    assert catalog.list_dataset_ids() == jax_catalog.list_dataset_ids()
    assert len(catalog.list_dataset_ids()) == 16
    for dataset_id in catalog.list_dataset_ids():
        assert _plain(catalog.get_dataset_spec(dataset_id)) == _plain(jax_catalog.get_dataset_spec(dataset_id))
    assert _outcome(lambda: catalog.get_dataset_spec("nope"))[:2] == _outcome(
        lambda: jax_catalog.get_dataset_spec("nope"))[:2]


def test_capability_profiles_match_ser_tpu() -> None:
    ours = [_plain(profile) for profile in capabilities.list_dataset_capability_profiles()]
    theirs = [_plain(profile) for profile in jax_capabilities.list_dataset_capability_profiles()]
    assert ours == theirs and len(ours) == 16
    for dataset_id in catalog.list_dataset_ids():
        assert _plain(capabilities.resolve_dataset_capability_profile(dataset_id)) == _plain(
            jax_capabilities.resolve_dataset_capability_profile(dataset_id))


def test_catalog_json_payload_matches_ser_tpu(tmp_path) -> None:
    """``data catalog --all --format json`` before and after one prepared corpus."""
    mine, theirs = _both_settings(tmp_path)
    root = tmp_path / "ravdess"
    _wav(root / "Actor_01" / "03-01-05-01-01-01-01.wav")
    _wav(root / "Actor_02" / "03-01-03-01-01-01-02.wav")
    for prepared in (False, True):
        if prepared:
            prepare.prepare_dataset(dataset_id="ravdess", dataset_root=root, skip_download=True, settings=mine)
        payloads = [
            json.dumps(module.build_dataset_capability_snapshot_json_payload(
                module.collect_dataset_capability_snapshot(settings=settings, include_uninstalled=True)),
                sort_keys=True)
            for module, settings in ((capabilities, mine), (jax_capabilities, theirs))
        ]
        assert payloads[0] == payloads[1]
        assert '"installed": true' in payloads[0] if prepared else '"installed": true' not in payloads[0]


# --------------------------------------------------------------------------- #
# Labels from file names, all 16 catalog ids
# --------------------------------------------------------------------------- #

#: dataset_id → relative WAV paths of a staged tree (the JAX suite's trees, a few names more).
STAGED_TREES: dict[str, list[str]] = {
    "ravdess": ["Actor_01/03-01-05-01-01-01-01.wav", "Actor_02/03-01-02-02-01-02-02.wav"],
    "crema-d": ["AudioWAV/1001_DFA_ANG_XX.wav", "AudioWAV/1002_IEO_HAP_HI.wav"],
    "emodb-2.0": ["wav/03a01Fa.wav", "wav/08b02Wb.wav"],
    "jl-corpus": ["female1_angry_1a_1.wav", "male2_sad_3b_2.wav"],
    "mesd": ["Anger_F_A_word.wav", "Sadness_M_B_word.wav"],
    "escorpus-pe": ["speaker1/clip-05-05-03.wav", "speaker2/clip-01-05-04.wav"],
    "spanish-meacorpus-2023": ["alegría/clip_001.wav", "tristeza/clip_002.wav"],
    "cafe": ["Colère/01-C-1-1.wav", "Joie/02-J-1-1.wav"],
    "oreau-french-esd": ["joie/f1_phrase1.wav", "colere/m2_phrase2.wav"],
    "att-hack": ["F01-friendly-001.wav", "M02-distant-002.wav"],
    "asvp-esd": ["happy/actor_12_clip.wav", "sad/actor_13_clip.wav"],
    "emov-db": ["amused_1-15_0001.wav", "angry_1-28_0002.wav"],
    "pavoque": ["angry/pavoque_000.wav", "happy/pavoque_001.wav"],
    "coraa-ser": ["neutral_001.wav", "non_neutral_female_002.wav"],
    "msp-podcast": ["audio/seg_0001.wav", "audio/seg_0002.wav"],
    "biic-podcast": ["audio/seg_0001.wav", "audio/seg_0002.wav"],
}
#: Corpora whose labels ship as annotation CSVs: a generated ``labels.csv`` at the root.
CSV_LABELS = {"msp-podcast": "audio/seg_0001.wav,happy\naudio/seg_0002.wav,sad\n",
              "biic-podcast": "audio/seg_0001.wav,angry\naudio/seg_0002.wav,neutral\n"}
#: Corpora whose label schema sits outside the 8 primaries need a widened ontology, in both packages.
EXTENDED_LABELS = {"att-hack": "friendly,distant,dominant,seductive",
                   "coraa-ser": "neutral,non_neutral_female,non_neutral_male"}


def test_staged_trees_cover_the_catalog() -> None:
    assert sorted(STAGED_TREES) == sorted(catalog.list_dataset_ids())


@pytest.mark.parametrize("dataset_id", sorted(STAGED_TREES))
def test_prepare_writes_the_same_manifest_bytes(tmp_path, dataset_id) -> None:
    root = tmp_path / "corpus" / dataset_id
    for rel in STAGED_TREES[dataset_id]:
        _wav(root / rel)
    if dataset_id in CSV_LABELS:
        (root / "labels.csv").write_text("FileName,emotion\n" + CSV_LABELS[dataset_id], encoding="utf-8")
    extra = {"SER_ALLOWED_LABELS": EXTENDED_LABELS[dataset_id]} if dataset_id in EXTENDED_LABELS else None
    written = {}
    for name, module, settings in (("port", prepare, build_settings(_env(tmp_path / "port", extra))),
                                   ("jax", jax_prepare, build_settings_from_inputs(
                                       capture_settings_inputs(env=_env(tmp_path / "jax", extra))))):
        manifest = tmp_path / name / "manifests" / f"{dataset_id}.jsonl"
        result = module.prepare_dataset(dataset_id=dataset_id, dataset_root=root, manifest_path=manifest,
                                        skip_download=True, settings=settings)
        assert result.utterance_count == len(STAGED_TREES[dataset_id])
        written[name] = (manifest.read_bytes(), _plain(result))
    assert written["port"][0] == written["jax"][0]
    port_result, jax_result = written["port"][1], written["jax"][1]
    assert {k: v for k, v in port_result.items() if k != "manifest_path"} == {
        k: v for k, v in jax_result.items() if k != "manifest_path"}
    labels = [u.label for u in read_manifest_jsonl(tmp_path / "port" / "manifests" / f"{dataset_id}.jsonl")]
    assert all(labels) and len(labels) == len(STAGED_TREES[dataset_id])


#: File names for the label functions one at a time: matching, near misses and junk.
LABEL_NAMES = [
    "Colère/clip.wav", "alegría/x.wav", "nothing/here.wav", "tristeza/a/b.wav", "x-05-05-03.wav",
    "x-01-05-04.wav", "x-01-05-01.wav", "x-01-01-03.wav", "x-03-05-03.wav", "x-02-03-03.wav",
    "x-03-03-03.wav", "x-9-9-9.wav", "Anger_F_A_word.wav", "Fear_M.wav", "Neutral.wav", "Happiness_x.wav",
    "F01-friendly-001.wav", "M02-seductive-9.wav", "F01-bored-001.wav", "neutral_001.wav",
    "non_neutral_female_002.wav", "non_neutral_male_3.wav", "other.wav", "1001_DFA_ANG_XX.wav",
    "1091_WSI_SAD_LO.wav", "1001_DFA.wav", "03a01Fa.wav", "16b10Td.wav", "zz.wav", "female1_angry_1a_1.wav",
    "male2_excited_3b_2.wav", "x_y.wav",
]
LABEL_FUNCTIONS = [
    ("token_label", strategies.token_label, jax_strategies.token_label),
    ("mesd_label", strategies.mesd_label, jax_strategies.mesd_label),
    ("escorpus_pe_label", strategies.escorpus_pe_label, jax_strategies.escorpus_pe_label),
    ("att_hack_label", strategies.att_hack_label, jax_strategies.att_hack_label),
    ("coraa_ser_label", strategies.coraa_ser_label, jax_strategies.coraa_ser_label),
    ("parse_crema_d", adapters.parse_crema_d, jax_adapters.parse_crema_d),
    ("parse_emodb", adapters.parse_emodb, jax_adapters.parse_emodb),
    ("parse_jl_corpus", adapters.parse_jl_corpus, jax_adapters.parse_jl_corpus),
]


@pytest.mark.parametrize(("name", "ours", "theirs"), LABEL_FUNCTIONS, ids=[f[0] for f in LABEL_FUNCTIONS])
def test_label_functions_match_ser_tpu(name, ours, theirs) -> None:
    for file_name in LABEL_NAMES:
        mine = _outcome(lambda: ours(Path(file_name)))
        reference = _outcome(lambda: theirs(Path(file_name)))
        if mine[0] == "ok" and mine[1] is not None and not isinstance(mine[1], tuple):
            mine, reference = ("ok", mine[1].to_record()), ("ok", reference[1].to_record())
        assert mine == reference, file_name


def test_strategy_registry_matches_ser_tpu() -> None:
    assert strategies.STRATEGY_IDS == jax_strategies.STRATEGY_IDS
    assert strategies.GENERATED_LABELS_FILE == jax_strategies.GENERATED_LABELS_FILE
    assert sorted(provider_prepare.AUTO_PREPARERS) == sorted(jax_provider_prepare.AUTO_PREPARERS)
    assert provider_prepare.EMODB_LABEL_MAP == jax_provider_prepare.EMODB_LABEL_MAP
    assert provider_prepare.MEACORPUS_LABEL_MAP == jax_provider_prepare.MEACORPUS_LABEL_MAP


# --------------------------------------------------------------------------- #
# Provider payload parses
# --------------------------------------------------------------------------- #

_POINTER = "version https://git-lfs.github.com/spec/v1\noid sha256:" + "a" * 64 + "\nsize 1234\n"
_ZENODO = {"files": [{"key": "other.zip", "links": {"self": "https://x/other"}},
                     {"key": "audio.zip", "links": {"self": "https://zenodo.org/api/files/audio.zip"},
                      "checksum": "md5:0123456789abcdef", "size": 42}]}
_HF_SCRIPT = ("_BASE = 1\n_RESOURCES = {'SLR88': {'Files': ['wav.tgz', ' txt.tgz ', 3]},"
              " 'SLR115': {'Files': ['a.tar.gz']}}\n")
_LISTING = ('<a href="wav.tgz">wav</a> <A HREF=\'/resources/88/txt.tgz\'>txt</A> <a href="readme.html">no</a>'
            ' <a href="ftp://x/y.tgz">scheme</a> <a href="wav.tgz">dupe</a>')
_RELEASE = {"tag_name": " v1.2 ", "assets": [{"name": "data.zip", "browser_download_url": "https://gh/data.zip",
                                              "size": 7}, {"name": "", "browser_download_url": "https://gh/skip"},
                                             {"name": "no-url"}, "junk"]}
_FOLDERS = [{"id": "f1", "name": "Audio Files!"}, {"id": "f2", "name": "angry/loud", "parent_id": "f1"},
            {"id": "f3", "name": "   ", "parent_id": "missing"}]
_MENDELEY_FILES = [{"filename": "a.wav", "content_details": {"download_url": "https://m/a"}, "size": 5},
                   {"filename": "", "content_details": {"download_url": "https://m/b"}}, {"filename": "c.wav"},
                   {"filename": "d.wav", "content_details": {}}, "junk"]

#: (case id, function name, positional arguments, keyword arguments).
PARSE_CASES = [
    ("zenodo_md5", "parse_zenodo_md5", ("MD5: DEF456 ",), {}),
    ("zenodo_md5_other", "parse_zenodo_md5", ("sha256:abc",), {}),
    ("zenodo_md5_none", "parse_zenodo_md5", (None,), {}),
    ("zenodo_select", "select_zenodo_file", (_ZENODO, "audio.zip"), {}),
    ("zenodo_missing", "select_zenodo_file", ({"files": []}, "missing.zip"), {}),
    ("zenodo_no_links", "select_zenodo_file", ({"files": [{"key": "audio.zip"}]}, "audio.zip"), {}),
    ("zenodo_not_dict", "select_zenodo_file", ("not-a-dict", "audio.zip"), {}),
    ("zenodo_url", "zenodo_record_url", ("1188976",), {}),
    ("openslr_pinned_88", "resolve_openslr_pinned_artifacts", ("88", (".tgz",)), {}),
    ("openslr_pinned_115", "resolve_openslr_pinned_artifacts", ("115", (".tar.gz", ".tgz")), {}),
    ("openslr_pinned_none", "resolve_openslr_pinned_artifacts", ("999", (".tgz",)), {}),
    ("openslr_mirrors", "build_openslr_mirror_urls", ("88", "wav.tgz"), {}),
    ("openslr_hf_script", "extract_openslr_files_from_hf_script", (_HF_SCRIPT, "88"), {}),
    ("openslr_hf_script_none", "extract_openslr_files_from_hf_script", ("x = 1\n", "88"), {}),
    ("openslr_canonical", "build_canonical_archive_urls", ("88", ["wav.tgz", "notes.txt", "wav.tgz"], (".tgz",)),
     {}),
    ("openslr_listing", "extract_archive_urls_from_listing_html",
     ("https://openslr.org/resources/88/", _LISTING, (".tgz",)), {}),
    ("hrefs", "extract_href_values", (_LISTING,), {}),
    ("github_assets", "parse_github_release_assets", (_RELEASE,), {"owner": "o", "repo": "r"}),
    ("github_no_assets", "parse_github_release_assets", ({"tag_name": "v1", "assets": []},),
     {"owner": "o", "repo": "r"}),
    ("github_latest", "github_latest_release_url", ("o", "r"), {}),
    ("lfs_pointer", "parse_lfs_pointer", (_POINTER,), {}),
    ("lfs_not_pointer", "parse_lfs_pointer", ("RIFF....WAVE",), {}),
    ("lfs_no_oid", "parse_lfs_pointer", ("version https://git-lfs.github.com/spec/v1\nsize 3\n",), {}),
    ("mendeley_folders", "build_mendeley_folder_paths", (_FOLDERS,), {}),
    ("mendeley_cycle", "build_mendeley_folder_paths",
     ([{"id": "a", "name": "a", "parent_id": "b"}, {"id": "b", "name": "b", "parent_id": "a"}],), {}),
    ("mendeley_files", "select_mendeley_files", (_MENDELEY_FILES,), {}),
    ("mendeley_not_list", "select_mendeley_files", ({"not": "a list"},), {}),
    ("mendeley_files_url", "mendeley_files_url", ("abc", 3), {}),
    ("mendeley_folders_url", "mendeley_folders_url", ("abc", 3), {}),
    ("jl_index", "sanitize_jl_corpus_index", (" 42 ",), {}),
    ("jl_index_traversal", "sanitize_jl_corpus_index", ("../42",), {}),
    ("jl_src", "extract_jl_corpus_audio_src", ([{"src": " https://x/a.wav "}],), {}),
    ("jl_src_dict", "extract_jl_corpus_audio_src", ({"src": "https://x/b.wav"},), {}),
    ("jl_src_none", "extract_jl_corpus_audio_src", ("str",), {}),
]


@pytest.mark.parametrize(("case", "function", "args", "kwargs"), PARSE_CASES, ids=[c[0] for c in PARSE_CASES])
def test_provider_parses_match_ser_tpu(case, function, args, kwargs) -> None:
    mine = _outcome(lambda: getattr(provider_resolution, function)(*args, **kwargs))
    reference = _outcome(lambda: getattr(jax_resolution, function)(*args, **kwargs))
    assert _plain(mine) == _plain(reference)


def test_lfs_tree_scan_matches_ser_tpu(tmp_path) -> None:
    (tmp_path / "real.wav").write_bytes(b"RIFF" + b"\x00" * 64)
    (tmp_path / "stub.wav").write_text(_POINTER)
    (tmp_path / "notes.txt").write_text(_POINTER)
    assert provider_resolution.scan_tree_for_lfs_pointers(tmp_path) == jax_resolution.scan_tree_for_lfs_pointers(
        tmp_path) == [tmp_path / "stub.wav"]
    assert provider_resolution.is_lfs_pointer_file(tmp_path / "stub.wav")
    assert not provider_resolution.is_lfs_pointer_file(tmp_path / "real.wav")


# --------------------------------------------------------------------------- #
# Retries
# --------------------------------------------------------------------------- #


def test_retry_classification_matches_ser_tpu() -> None:
    statuses = range(100, 700)
    assert [provider_transport.is_retryable_http_status(s) for s in statuses] == [
        jax_transport.is_retryable_http_status(s) for s in statuses]


def _http_error(code: int) -> urllib.error.HTTPError:
    return urllib.error.HTTPError("u", code, "status", None, None)


#: (case id, the errors raised before a success, retries): None at the end means "then succeed".
RETRY_SCRIPTS = [
    ("url_error_then_ok", [urllib.error.URLError("transient"), urllib.error.URLError("transient"), None], 3),
    ("timeout_then_ok", [TimeoutError("slow"), None], 3),
    ("http_503_then_ok", [_http_error(503), None], 3),
    ("http_429_exhausted", [_http_error(429)] * 2, 2),
    ("http_403_fails_fast", [_http_error(403)], 3),
    ("http_404_fails_fast", [_http_error(404)], 3),
    ("os_error_exhausted", [OSError("disk")] * 3, 3),
    ("value_error_escapes", [ValueError("not transport")], 3),
]


@pytest.mark.parametrize(("case", "script", "retries"), RETRY_SCRIPTS, ids=[s[0] for s in RETRY_SCRIPTS])
def test_retries_match_ser_tpu(case, script, retries) -> None:
    results = []
    for module in (provider_transport, jax_transport):
        calls, sleeps = [], []

        def action():
            step = script[len(calls)]
            calls.append(step)
            if step is None:
                return "ok"
            raise step

        outcome = _outcome(lambda: module.run_with_retries(
            description="fetch", action=action, retries=retries, sleep=sleeps.append))
        results.append((outcome, len(calls), len(sleeps)))
        assert all(0.0 <= s for s in sleeps)
    assert results[0] == results[1]
    with pytest.raises(ValueError, match="at least 1"):
        provider_transport.run_with_retries(description="x", action=lambda: None, retries=0)


# --------------------------------------------------------------------------- #
# fetch_url and download_file over file://
# --------------------------------------------------------------------------- #


def _fetch_both(tmp_path, name: str, fetch) -> list:
    """``fetch(module, dest)`` once per package into fresh destinations; the outcomes and file bytes."""
    outcomes = []
    for label, module in (("port", downloads), ("jax", jax_downloads)):
        dest = tmp_path / label / name
        outcome = _outcome(lambda: fetch(module, dest))
        if outcome[0] == "ok":
            outcome = ("ok", {**_plain(outcome[1]), "path": Path(outcome[1].path).relative_to(tmp_path / label)})
        files = sorted((p.relative_to(tmp_path / label).as_posix(), p.read_bytes())
                       for p in (tmp_path / label).rglob("*") if p.is_file())
        outcomes.append((outcome, files))
    return outcomes


def test_fetch_url_full_resumed_and_mismatched_matches_ser_tpu(tmp_path) -> None:
    payload = bytes(range(256)) * 64
    source = tmp_path / "source.bin"
    source.write_bytes(payload)
    digest = hashlib.sha256(payload).hexdigest()

    full = _fetch_both(tmp_path / "full", "archive.bin",
                       lambda m, dest: m.fetch_url(source.as_uri(), dest, expected_sha256=digest))
    assert full[0] == full[1] and full[0][0][1]["bytes_fetched"] == len(payload)

    def resumed_fetch(module, dest):
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.with_name(dest.name + ".part").write_bytes(payload[:1000])  # an interrupted attempt
        return module.fetch_url(source.as_uri(), dest, expected_sha256=digest)

    resumed = _fetch_both(tmp_path / "resumed", "archive.bin", resumed_fetch)
    assert resumed[0] == resumed[1]
    assert resumed[0][0][1]["resumed"] and resumed[0][0][1]["bytes_fetched"] == len(payload) - 1000

    mismatch = _fetch_both(tmp_path / "mismatch", "archive.bin",
                           lambda m, dest: m.fetch_url(source.as_uri(), dest, expected_sha256="0" * 64))
    assert mismatch[0] == mismatch[1]
    assert mismatch[0][0][:2] == ("raised", "ChecksumMismatchError") and mismatch[0][1] == []

    def planted_part(module, dest):
        """A staged part that is not a prefix of the source: the digest catches the splice."""
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.with_name(dest.name + ".part").write_bytes(b"\xff" * 1000)
        return module.fetch_url(source.as_uri(), dest, expected_sha256=digest)

    planted = _fetch_both(tmp_path / "planted", "archive.bin", planted_part)
    assert planted[0][0][0] == planted[1][0][0]
    assert planted[0] == planted[1]
    assert _outcome(lambda: downloads.fetch_url("ftp://host/x", tmp_path / "x"))[:2] == ("raised", "ValueError")


@pytest.mark.parametrize("case", ["md5_ok", "md5_mismatch", "size_mismatch", "zero_byte_refetched"])
def test_download_file_matches_ser_tpu(tmp_path, case) -> None:
    source = tmp_path / "src.bin"
    source.write_bytes(b"payload-bytes")
    md5 = provider_transport.compute_file_md5(source)
    assert md5 == jax_transport.compute_file_md5(source) == hashlib.md5(b"payload-bytes").hexdigest()
    kwargs = {"md5_ok": {"expected_md5": md5}, "md5_mismatch": {"expected_md5": "0" * 32},
              "size_mismatch": {"expected_size": 99}, "zero_byte_refetched": {}}[case]
    results = []
    for label, module in (("port", provider_transport), ("jax", jax_transport)):
        dest = tmp_path / label / "dst.bin"
        if case == "zero_byte_refetched":
            dest.parent.mkdir(parents=True)
            dest.write_bytes(b"")
        outcome = _outcome(lambda: module.download_file(source.as_uri(), dest, retries=1, **kwargs))
        results.append((outcome[0], outcome[1] if outcome[0] == "raised" else None,
                        dest.read_bytes() if dest.exists() else None))
    assert results[0] == results[1]


def test_safe_extraction_matches_ser_tpu(tmp_path) -> None:
    good, evil = tmp_path / "good.zip", tmp_path / "evil.zip"
    with zipfile.ZipFile(good, "w") as zf:
        zf.writestr("clips/a.wav", b"RIFFxxxx")
        zf.writestr("clips/b.wav", b"RIFFyyyy")
    with zipfile.ZipFile(evil, "w") as zf:
        zf.writestr("../escape.wav", b"RIFF")
    for archive in (good, evil):
        mine = _outcome(lambda: downloads.extract_archive(archive, tmp_path / "port" / archive.stem))
        theirs = _outcome(lambda: jax_downloads.extract_archive(archive, tmp_path / "jax" / archive.stem))
        assert mine[0] == theirs[0] and mine[1:2] == theirs[1:2]
    assert not (tmp_path / "escape.wav").exists()


# --------------------------------------------------------------------------- #
# Acquisition workflow: RAVDESS over a file:// Zenodo record
# --------------------------------------------------------------------------- #


def _zenodo_fixture(tmp_path: Path) -> str:
    """A Zenodo API base (``file://``) whose RAVDESS record points at a local archive."""
    record_id, file_key = provider_prepare.RAVDESS_ZENODO
    archive = tmp_path / "provider" / file_key
    archive.parent.mkdir(parents=True)
    staged = tmp_path / "provider" / "staged"
    for rel in STAGED_TREES["ravdess"]:
        _wav(staged / rel)
    with zipfile.ZipFile(archive, "w") as zf:
        for path in sorted(staged.rglob("*.wav")):
            zf.write(path, path.relative_to(staged).as_posix())
    data = archive.read_bytes()
    api = tmp_path / "provider" / "api" / "records"
    api.mkdir(parents=True)
    (api / record_id).write_text(json.dumps({"files": [{
        "key": file_key, "links": {"self": archive.as_uri()}, "size": len(data),
        "checksum": "md5:" + hashlib.md5(data).hexdigest()}]}), encoding="utf-8")
    return api.as_uri()


def test_ravdess_acquisition_over_file_urls_matches_ser_tpu(tmp_path) -> None:
    api_base = _zenodo_fixture(tmp_path)
    trees = []
    for label, module in (("port", provider_prepare), ("jax", jax_provider_prepare)):
        root = tmp_path / label / "ravdess"
        artifacts = module.acquire_dataset("ravdess", root, zenodo_api_base=api_base)
        assert artifacts.dataset_root == root and artifacts.source_manifest_path.is_file()
        source = json.loads(artifacts.source_manifest_path.read_text(encoding="utf-8"))
        source["source"]["archive_path"] = Path(source["source"]["archive_path"]).relative_to(root).as_posix()
        trees.append(((artifacts.files_seen, artifacts.labels_written, artifacts.labels_csv_path), source,
                      sorted((p.relative_to(root).as_posix(), p.read_bytes()) for p in root.rglob("*.wav"))))
    assert trees[0] == trees[1]
    assert trees[0][0][0] == len(trees[0][2]) == len(STAGED_TREES["ravdess"])


def test_offline_acquisition_raises_the_same_staging_error(tmp_path) -> None:
    missing = (tmp_path / "no-such-api").as_uri()
    mine = _outcome(lambda: provider_prepare.acquire_dataset(
        "ravdess", tmp_path / "port" / "ravdess", zenodo_api_base=missing))
    theirs = _outcome(lambda: jax_provider_prepare.acquire_dataset(
        "ravdess", tmp_path / "jax" / "ravdess", zenodo_api_base=missing))
    assert mine[:2] == theirs[:2] == ("raised", "DatasetDownloadUnavailableError")
    assert "skip_download=True" in mine[2]


# --------------------------------------------------------------------------- #
# Registry and consents, each package reading the other's files
# --------------------------------------------------------------------------- #


def _ravdess_root(tmp_path: Path) -> Path:
    root = tmp_path / "ravdess"
    for rel in STAGED_TREES["ravdess"]:
        _wav(root / rel)
    return root


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_registry_records_read_across_packages(tmp_path, writer) -> None:
    mine, theirs = _both_settings(tmp_path)
    root = _ravdess_root(tmp_path)
    module, settings = (prepare, mine) if writer == "port" else (jax_prepare, theirs)
    result = module.prepare_dataset(dataset_id="ravdess", dataset_root=root, skip_download=True, settings=settings,
                                    source_revision="v1")
    ours = registry.list_registered_datasets(settings=mine)
    reference = jax_registry.list_registered_datasets(settings=theirs)
    assert [_plain(r) for r in ours] == [_plain(r) for r in reference]
    assert [r.manifest_path for r in ours] == [result.manifest_path]
    assert _plain(registry.audit_registry_health(settings=mine)) == _plain(
        jax_registry.audit_registry_health(settings=theirs)) == []
    rows = read_manifest_jsonl(Path(result.manifest_path))
    assert [u.to_record() for u in rows] == [u.to_record() for u in jax_read_manifest(Path(result.manifest_path))]
    shutil.rmtree(root)
    assert _plain(registry.audit_registry_health(settings=mine)) == _plain(
        jax_registry.audit_registry_health(settings=theirs)) != []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_consent_files_read_across_packages(tmp_path, writer) -> None:
    mine, theirs = _both_settings(tmp_path)
    module, settings = (consents, mine) if writer == "port" else (jax_consents, theirs)
    record = module.configure_dataset_consents(accept_policy_ids=(" Academic_Only ", "share_alike"),
                                               accept_license_ids=("CC-BY-NC-SA-4.0",), settings=settings,
                                               source="ser configure")
    assert tuple(consents.show_dataset_consents(settings=mine)) == tuple(
        jax_consents.show_dataset_consents(settings=theirs)) == tuple(record)
    store = Path(settings.models.folder).parent / ".ser" / "dataset_consents.json"
    written = store.read_bytes()
    store.unlink()
    other_module, other_settings = (jax_consents, theirs) if writer == "port" else (consents, mine)
    other_module.configure_dataset_consents(accept_policy_ids=(" Academic_Only ", "share_alike"),
                                            accept_license_ids=("CC-BY-NC-SA-4.0",), settings=other_settings,
                                            source="ser configure")
    assert store.read_bytes() == written


def test_prepare_with_accept_license_records_the_same_consent(tmp_path) -> None:
    written = []
    for label, module, consent_module in (("port", prepare, consents), ("jax", jax_prepare, jax_consents)):
        mine, theirs = _both_settings(tmp_path / label)
        settings = mine if label == "port" else theirs
        root = tmp_path / label / "crema-d"
        _wav(root / "AudioWAV" / "1001_DFA_ANG_XX.wav")
        refused = _outcome(lambda: module.prepare_dataset(dataset_id="crema-d", dataset_root=root,
                                                          skip_download=True, compliance_mode="enforced",
                                                          settings=settings))
        module.prepare_dataset(dataset_id="crema-d", dataset_root=root, skip_download=True, accept_license=True,
                               settings=settings)
        store = Path(settings.models.folder).parent / ".ser" / "dataset_consents.json"
        written.append((refused[:2], store.read_bytes(), tuple(consent_module.show_dataset_consents(
            settings=settings))))
    assert written[0] == written[1]
    assert written[0][0] == ("raised", "ConsentError")
