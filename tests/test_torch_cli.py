"""The port's command line (``python -m ser_tpu_torch``) against ``ser_tpu``'s, in-process on the CPU.

- ``build_parser()``: both action trees, subparsers included, with the same
  option strings, dests, defaults, choices, ``nargs`` and ``required``; only
  the description differs (it names the card, not the TPU).
- A matrix of argv through both ``main``s, each package in its own folders
  of the same layout (``SER_TORCH_DEVICE=cpu`` for the port): the same exit
  codes and the same standard output once each package's folder reads
  ``<root>``. It runs the data subcommands (prepare, download, registry,
  health, catalog, audit, consents, uninstall) on a RAVDESS-named corpus,
  ``configure``, ``doctor --format json`` (whose accelerator finding names
  each package's device, by design), ``--train`` with ``--dry-run`` and
  ``--repair`` (network repairs off; the accurate profile's smoke on the
  tiny encoder), ``--file
  --no-transcript`` on the tiny accurate staging of
  ``test_torch_accurate_infer.py`` (with the ``Timeline CSV:`` and
  ``Subtitles:`` lines), ``--calibrate-transcription-runtime`` with no
  Whisper assets, ``gate`` behind a shut license gate, ``benchmark`` on a
  missing file, the restricted-backend opt-ins, bad flags (exit 2) and no
  arguments.
- With neither a card nor ``SER_TORCH_DEVICE=cpu``, ``python -m
  ser_tpu_torch --file ...`` exits 2 and names ``SER_TORCH_DEVICE=cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
from collections.abc import Iterator
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

import ser_tpu.__main__ as jax_main
import ser_tpu_torch.__main__ as torch_main
from ser_tpu._internal.utils import logger as jax_logger
from ser_tpu._internal.utils.audio_io import write_wav
from ser_tpu_torch._internal.utils import logger as torch_logger

REPO_ROOT = Path(__file__).resolve().parents[1]
_JAX_DESCRIPTION = "TPU-native speech emotion recognition."
_PORT_DESCRIPTION = "Speech emotion recognition on an NVIDIA H100 (PyTorch/CUDA)."

# --------------------------------------------------------------------------- #
# The parser trees
# --------------------------------------------------------------------------- #


def _tree(parser: argparse.ArgumentParser) -> list:
    """Every action of a parser and its subparsers, as comparable data."""
    rows = []
    for action in parser._actions:
        row = {
            "kind": type(action).__name__,
            "option_strings": list(action.option_strings),
            "dest": action.dest,
            "default": action.default,
            "choices": sorted(action.choices) if isinstance(action.choices, dict) else action.choices,
            "nargs": action.nargs,
            "required": action.required,
            "type": getattr(action.type, "__name__", action.type),
            "const": action.const,
        }
        if isinstance(action, argparse._SubParsersAction):
            row["subparsers"] = {name: _tree(sub) for name, sub in sorted(action.choices.items())}
        rows.append(row)
    return rows


def test_parser_trees_match_ser_tpu() -> None:
    ours, theirs = torch_main.build_parser(), jax_main.build_parser()
    assert _tree(ours) == _tree(theirs)
    assert ours.prog == theirs.prog
    assert (ours.description, theirs.description) == (_PORT_DESCRIPTION, _JAX_DESCRIPTION)
    subcommands = next(a for a in ours._actions if isinstance(a, argparse._SubParsersAction))
    assert sorted(subcommands.choices) == ["benchmark", "configure", "data", "doctor", "gate"]


# --------------------------------------------------------------------------- #
# The argv matrix
# --------------------------------------------------------------------------- #


def _corpus(root: Path) -> None:
    """32 RAVDESS-named 1 s clips: 4 actors, 4 emotions (a tone each), 2 takes."""
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000
    for actor in range(1, 5):
        (root / f"Actor_{actor:02d}").mkdir(parents=True, exist_ok=True)
        for emotion, frequency in (("01", 200), ("03", 400), ("04", 600), ("05", 800)):
            for take in ("01", "02"):
                audio = 0.5 * np.sin(2 * np.pi * frequency * t) + 0.05 * rng.standard_normal(t.size)
                write_wav(root / f"Actor_{actor:02d}" / f"03-01-{emotion}-01-{take}-01-{actor:02d}.wav",
                          audio.astype(np.float32), 16000)


def _environment(root: Path) -> dict[str, str]:
    return {
        "SER_DATA_DIR": str(root / "data"),
        "SER_MODELS_FOLDER": str(root / "models"),
        "SER_TMP_FOLDER": str(root / "tmp"),
        "SER_CACHE_DIR": str(root / "cache"),
        "SER_DATASET_FOLDER": str(root / "corpus"),
        "SER_DATASET_REGISTRY_ROOT": str(root / "registry"),
        "SER_DATASET_CONSENTS_FILE": str(root / "consents.json"),
        "SER_RESTRICTED_BACKENDS_CONSENT_FILE": str(root / "restricted.json"),
        "SER_TORCH_DEVICE": "cpu",
    }


@contextmanager
def _package_logging_kept() -> Iterator[None]:
    """Saves each package's root logger (propagate, handlers, level) and ``_configured``; restores them.

    ``main`` calls ``configure_logging``, which gives the package's root logger
    a handler of its own and stops it propagating, once per process. Left so,
    every later test in this process would lose the package's records to
    ``caplog``, which listens on the root logger.
    """
    saved = []
    for module in (torch_logger, jax_logger):
        root = logging.getLogger(module._ROOT_NAME)
        saved.append((module, root, root.propagate, list(root.handlers), root.level, module._configured))
    try:
        yield
    finally:
        for module, root, propagate, handlers, level, configured in saved:
            for handler in [h for h in root.handlers if h not in handlers]:
                root.removeHandler(handler)
            for handler in [h for h in handlers if h not in root.handlers]:
                root.addHandler(handler)
            root.propagate = propagate
            root.setLevel(level)
            module._configured = configured


def _run(main, root: Path, argv: list[str], capsys, extra_env: dict | None = None) -> tuple[int, str]:
    """One ``main(argv)`` with ``root``'s environment; its exit code and its standard output as ``<root>``.

    The packages' logging state is restored after it (``_package_logging_kept``).
    """
    saved = dict(os.environ)
    os.environ.update({**_environment(root), **(extra_env or {})})
    os.environ.pop("SER_TRAINING_REPAIR_ALLOW_NETWORK", None)
    capsys.readouterr()
    try:
        with _package_logging_kept():
            try:
                code = main([str(root / a[len("ROOT/"):]) if a.startswith("ROOT/") else a for a in argv])
            except SystemExit as exit_:
                code = exit_.code
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return code, capsys.readouterr().out.replace(str(root), "<root>")


#: (step id, argv): run in this order in both packages (each step sees the earlier ones' files).
STEPS: list[tuple[str, list[str]]] = [
    ("configure_show_empty", ["configure", "--show"]),
    ("configure_persist", ["configure", "--accept-dataset-license", "cc-by-nc-sa-4.0", "--persist"]),
    ("configure_refuses_without_persist", ["configure", "--accept-dataset-policy", "academic_only"]),
    ("consents_accept", ["data", "consents", "--accept-policy", "academic_only"]),
    ("consents_show", ["data", "consents"]),
    ("list", ["data", "list"]),
    ("registry_empty", ["data", "registry"]),
    ("audit_empty", ["data", "audit"]),
    ("prepare", ["data", "prepare", "ravdess", "--dataset-root", "ROOT/corpus", "--skip-download"]),
    ("registry_json", ["data", "registry", "--show", "--format", "json"]),
    ("registry_show", ["data", "registry", "--show"]),
    ("registry_strict", ["data", "registry", "--strict"]),
    ("health", ["data", "health"]),
    ("catalog_json", ["data", "catalog", "--format", "json"]),
    ("catalog_all", ["data", "catalog", "--all"]),
    ("audit_lenient", ["data", "audit", "--lenient", "--ledger-out", "ROOT/ledger.json"]),
    ("audit_strict", ["data", "audit"]),
    ("download_staged", ["data", "download", "--dataset", "ravdess", "--dataset-root", "ROOT/corpus",
                         "--skip-download"]),
    ("prepare_unknown", ["data", "prepare", "nope", "--skip-download"]),
    ("train_dry_run", ["--train", "--dry-run"]),
    ("train_repair", ["--train", "--repair", "--profile", "accurate"]),
    ("uninstall_keep_files", ["data", "uninstall", "--dataset", "ravdess", "--keep-files"]),
    ("uninstall_unregistered", ["data", "uninstall", "--dataset", "ravdess"]),
    ("data_no_subcommand", ["data"]),
    ("bad_profile", ["--profile", "nope"]),
    ("bad_flag", ["--no-such-flag"]),
    ("benchmark_needs_a_file", ["benchmark"]),
    ("calibrate_without_whisper_assets", ["--calibrate-transcription-runtime"]),
    ("calibrate_bad_iterations", ["--calibrate-transcription-runtime", "--calibration-iterations", "0"]),
    ("gate_research_refused", ["gate", "--candidate", "accurate-research"]),
    ("benchmark_missing_file", ["benchmark", "ROOT/missing.wav"]),
    ("restricted_opt_in_profile", ["--accept-restricted-backends", "--profile", "accurate-research"]),
    ("restricted_opt_in_standalone", ["--accept-all-restricted-backends"]),
    ("no_arguments", []),
]


@pytest.fixture(scope="module")
def matrix(tmp_path_factory) -> dict[str, Path]:
    root = tmp_path_factory.mktemp("cli")
    for package in ("port", "jax"):
        _corpus(root / package / "corpus")
    return {"root": root}


@pytest.fixture(scope="module")
def results(matrix, accurate_staging) -> dict[str, tuple]:
    """Each step's (port, ser_tpu) outcome, in order, with the tiny accurate staging's encoder enabled."""
    staged = {key: accurate_staging["env"][key] for key in ("SER_ENABLE_ACCURATE_PROFILE", "SER_CACHE_DIR")}
    capsys = _ModuleCapture()
    outcomes = {}
    for step, argv in STEPS:
        ours = _run(torch_main.main, matrix["root"] / "port", argv, capsys, extra_env=staged)
        theirs = _run(jax_main.main, matrix["root"] / "jax", argv, capsys, extra_env=staged)
        outcomes[step] = (ours, theirs)
    capsys.close()
    return outcomes


class _ModuleCapture:
    """A ``capsys``-like capture of standard output for a module-scoped fixture."""

    def __init__(self) -> None:
        import io

        self._io = io
        self._saved = sys.stdout
        self._buffer = io.StringIO()
        sys.stdout = self._buffer

    def readouterr(self):
        value = self._buffer.getvalue()
        self._buffer = self._io.StringIO()
        sys.stdout = self._buffer
        return type("Captured", (), {"out": value})()

    def close(self) -> None:
        sys.stdout = self._saved


def _normalized(step: str, outcome: tuple[int, str]) -> tuple[int, str]:
    code, out = outcome
    if step == "no_arguments":
        out = out.replace(_PORT_DESCRIPTION, _JAX_DESCRIPTION)
    return code, out


@pytest.mark.parametrize("step", [s for s, _ in STEPS])
def test_argv_matches_ser_tpu(results, step) -> None:
    ours, theirs = results[step]
    assert _normalized(step, ours) == _normalized(step, theirs)


def test_the_matrix_reaches_each_outcome(results) -> None:
    """The steps are not vacuous: successes, refusals and argparse errors, and real output."""
    codes = {step: results[step][0][0] for step, _ in STEPS}
    assert codes["prepare"] == codes["registry_json"] == codes["train_repair"] == codes["train_dry_run"] == 0
    assert codes["configure_refuses_without_persist"] == codes["audit_strict"] == codes["bad_flag"] == 2
    assert codes["no_arguments"] == codes["bad_profile"] == codes["uninstall_unregistered"] == 2
    assert codes["calibrate_without_whisper_assets"] == codes["gate_research_refused"] == 2
    assert codes["restricted_opt_in_profile"] == codes["restricted_opt_in_standalone"] == 0
    assert "Prepared ravdess: 32 utterances" in results["prepare"][0][1]
    entries = json.loads(results["registry_json"][0][1])["entries"]
    assert [(e["dataset_id"], e["utterance_count"]) for e in entries] == [("ravdess", 32)]
    assert "repair[ok] create_application_directory" in results["train_repair"][0][1]
    assert "repair: post-repair readiness usable=32" in results["train_repair"][0][1]
    assert "accurate backend smoke passed on 16" in results["train_repair"][0][1]
    assert "ledger written: <root>/ledger.json" in results["audit_lenient"][0][1]


def test_doctor_json_matches_ser_tpu(matrix, capsys) -> None:
    """The same findings; the accelerator finding names each package's device (by design)."""
    argv = ["doctor", "--format", "json", "--skip-transcription-checks"]
    ours = _run(torch_main.main, matrix["root"] / "port", argv, capsys)
    theirs = _run(jax_main.main, matrix["root"] / "jax", argv, capsys)
    assert ours[0] == theirs[0] == 0
    reports = [json.loads(out) for _, out in (ours, theirs)]
    devices = []
    for report in reports:
        for finding in report["findings"]:
            if finding["code"] == "accelerator":
                devices.append(finding.pop("message"))
    assert reports[0] == reports[1]
    assert devices[0].startswith("0 CUDA device(s) visible; torch device cpu") and "JAX device" in devices[1]


# --------------------------------------------------------------------------- #
# --file on the tiny accurate staging
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def accurate_staging(tmp_path_factory) -> dict:
    import test_torch_accurate_infer as accurate
    from ser_tpu._internal.config.schema import profile_artifact_file_names

    root = tmp_path_factory.mktemp("accurate_cli")
    accurate._write_hf_checkpoint(root / "shared" / "cache" / "model-cache" / "huggingface" / accurate.MODEL_ID)
    name = profile_artifact_file_names(profile="accurate", accurate_model_id=accurate.MODEL_ID)[0]
    accurate._write_head_artifact(root / "shared" / "models" / name)
    accurate._write_clip(root / "shared" / "clip.wav")
    return {"root": root, "env": {"SER_ENABLE_ACCURATE_PROFILE": "1",
                                  "SER_MODELS_FOLDER": str(root / "shared" / "models"),
                                  "SER_CACHE_DIR": str(root / "shared" / "cache")}}


@pytest.mark.parametrize("exports", [False, True], ids=["segments", "csv_and_subtitles"])
def test_file_no_transcript_matches_ser_tpu(accurate_staging, capsys, exports) -> None:
    clip = str(accurate_staging["root"] / "shared" / "clip.wav")
    outcomes = []
    for package, main in (("port", torch_main.main), ("jax", jax_main.main)):
        root = accurate_staging["root"] / package
        argv = ["--file", clip, "--profile", "accurate", "--no-transcript"]
        if exports:
            argv += ["--save_transcript", "--subtitle-output", "ROOT/out.srt"]
        env = {**accurate_staging["env"], "SER_TRANSCRIPTS_FOLDER": str(root / "transcripts")}
        outcomes.append(_run(main, root, argv, capsys, extra_env=env))
        if exports:
            assert (root / "out.srt").is_file() and (root / "transcripts" / "clip.csv").is_file()
    assert outcomes[0] == outcomes[1]
    code, out = outcomes[0]
    assert code == 0 and out.strip()
    if exports:
        assert "Timeline CSV: <root>/transcripts/clip.csv" in out and "Subtitles: <root>/out.srt" in out
        assert ((accurate_staging["root"] / "port" / "out.srt").read_bytes()
                == (accurate_staging["root"] / "jax" / "out.srt").read_bytes())


def test_module_entry_point_without_a_card_names_the_cpu_request(accurate_staging) -> None:
    """``python -m ser_tpu_torch --file ...`` with no card and no CPU request: exit 2 before any work."""
    env = {**os.environ, **accurate_staging["env"]}
    env.pop("SER_TORCH_DEVICE", None)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    clip = str(accurate_staging["root"] / "shared" / "clip.wav")
    completed = subprocess.run(
        [sys.executable, "-m", "ser_tpu_torch", "--file", clip, "--profile", "accurate", "--no-transcript"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert completed.returncode == 2, completed.stderr[-2000:]
    assert "SER_TORCH_DEVICE=cpu" in completed.stderr
    assert completed.stdout == ""
