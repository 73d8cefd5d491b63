"""The port's command line: ``python -m ser_tpu_torch`` (``ser-torch`` once installed).

Counterpart of ``ser_tpu/__main__.py``: the same flags, subcommands
(``configure``, ``doctor``, ``data``, ``benchmark``, ``gate``), defaults and
choices, the restricted-backend opt-ins and gate, the preflight gate,
``--calibrate-transcription-runtime``, ``--train`` with ``--repair``,
``--dry-run``, ``--prepare-only`` and ``--prepared-plan``, ``--file`` with
its ``Timeline CSV:`` and ``Subtitles:`` lines, and the exit codes
(validation 2, runtime 1, transcription 3). Only the parser's description
differs. Before any work ``main`` resolves ``SER_TORCH_DEVICE`` once
(``_internal/utils/torch_runtime.py``): with no CUDA card and no request
for the CPU it exits 2, naming ``SER_TORCH_DEVICE=cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from pathlib import Path

from ser_tpu_torch import api
from ser_tpu_torch._internal.runtime import restricted_backends
from ser_tpu_torch._internal.runtime.commands import (
    EXIT_OK,
    EXIT_VALIDATION,
    classify_exit_code,
    run_command,
)
from ser_tpu_torch._internal.utils.logger import configure_logging, get_logger
from ser_tpu_torch.config import reload_settings
from ser_tpu_torch.profiles import PROFILE_NAMES, get_profile_catalog, resolve_profile_name

logger = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ser", description="Speech emotion recognition on an NVIDIA H100 (PyTorch/CUDA)."
    )
    parser.add_argument("--file", type=str, help="Audio file to analyze.")
    parser.add_argument("--train", action="store_true", help="Train the active profile.")
    parser.add_argument("--profile", choices=PROFILE_NAMES, help="Runtime profile.")
    parser.add_argument("--language", type=str, default=None)
    parser.add_argument("--save_transcript", action="store_true")
    parser.add_argument("--no-transcript", action="store_true", dest="no_transcript")
    # Canonical reference flag name is --subtitle-output (__main__.py:201);
    # --subtitle-path stays as a compatibility alias.
    parser.add_argument(
        "--subtitle-output", "--subtitle-path", type=str, default=None,
        dest="subtitle_path",
        help="Write timeline subtitles to the given path (format inferred "
        "from the suffix when --subtitle-format is omitted).",
    )
    parser.add_argument("--subtitle-format", choices=("ass", "srt", "vtt"), default=None)
    parser.add_argument(
        "--disable-timeouts", "--no-timeout", action="store_true",
        dest="disable_timeouts",
        help="Disable inference timeout budgets for this CLI invocation.",
    )
    # Restricted-backend consent flags (reference __main__.py:240-254): both
    # persist policy-fingerprinted consents pre-command; standalone (no
    # --train/--file) invocations exit 0 after persisting.
    parser.add_argument(
        "--accept-restricted-backends", action="store_true",
        help="Persist consent for restricted backends required by the active profile.",
    )
    parser.add_argument(
        "--accept-all-restricted-backends", action="store_true",
        help="Persist consent for all known restricted backends (standalone ok).",
    )
    parser.add_argument(
        "--preflight", choices=("off", "warn", "strict"), default="warn",
        help="Startup preflight gate mode.",
    )
    parser.add_argument("--dry-run", action="store_true", help="Training readiness only.")
    parser.add_argument("--prepare-only", action="store_true")
    parser.add_argument("--prepared-plan", type=str, default=None)
    parser.add_argument("--dataset-recipe", type=str, default=None)
    parser.add_argument(
        "--strict-dataset-audit",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="Fail training on duplicate content, missing revisions/hashes, "
        "leakage, or empty classes.",
    )
    parser.add_argument(
        "--repair",
        action="store_true",
        help="Purge stale training caches/plans and re-run readiness.",
    )
    parser.add_argument(
        "--calibrate-transcription-runtime",
        action="store_true",
        help="Profile transcription candidates (WER + latency) and persist a recommendation.",
    )
    parser.add_argument("--log-level", type=str, default=None)
    parser.add_argument(
        "--calibration-iterations", type=int, default=2,
        help="Number of calibration runs per profile/model candidate.",
    )
    parser.add_argument(
        "--calibration-profiles", type=str,
        default="accurate,medium,accurate-research,fast",
        help="Comma-separated profile list for calibration "
        "(fast,medium,accurate,accurate-research).",
    )

    subparsers = parser.add_subparsers(dest="command")

    configure = subparsers.add_parser(
        "configure", help="Record dataset/restricted-backend consents."
    )
    configure.add_argument("--enable-backend", action="append", default=[])
    # Dataset-consent surface, reference `ser configure` (data/cli.py:108-154).
    configure.add_argument(
        "--accept-dataset-policy", nargs="+", default=[],
        help="Dataset policy IDs to acknowledge (e.g., academic_only share_alike).",
    )
    configure.add_argument(
        "--accept-dataset-license", nargs="+", default=[],
        help="Dataset license IDs to acknowledge (e.g., odbl-1.0 cc-by-nc-sa-4.0).",
    )
    configure.add_argument(
        "--persist", action="store_true",
        help="Persist acknowledgements to a local config file.",
    )
    configure.add_argument(
        "--show", action="store_true",
        help="Show currently persisted dataset consents.",
    )

    doctor = subparsers.add_parser("doctor", help="Run environment diagnostics.")
    doctor.add_argument(
        "--profile", choices=PROFILE_NAMES, default=None,
        help="Profile context for diagnostics "
        "(reference diagnostics/command.py:33-38).",
    )
    # Reference flag name is --format (text|json); --style adds the extra
    # 'brief' renderer and stays as the alias.
    doctor.add_argument(
        "--format", "--style", choices=("text", "brief", "json"), default="text",
        dest="style", help="Output format for diagnostics findings.",
    )
    doctor.add_argument(
        "--strict", action="store_true",
        help="Return non-zero exit code when warning or error findings are present.",
    )
    doctor.add_argument(
        "--include-noise-findings", action="store_true",
        help="Include informational environment-noise findings in output.",
    )
    doctor.add_argument(
        "--skip-transcription-checks", "--no-transcription-checks",
        action="store_true", dest="no_transcription_checks",
        help="Skip transcription backend checks.",
    )
    doctor.add_argument(
        "--training-readiness", action="store_true",
        help="Also run the full training-readiness contract.",
    )

    data = subparsers.add_parser("data", help="Dataset operations.")
    data_sub = data.add_subparsers(dest="data_command")
    data_sub.add_parser("list", help="List supported datasets.")
    registry = data_sub.add_parser(
        "registry", help="Inspect persisted dataset registry."
    )
    registry.add_argument(
        "--show", action="store_true",
        help="Show registered dataset roots/manifests/source provenance.",
    )
    registry.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="Registry output format.",
    )
    registry.add_argument(
        "--strict", action="store_true",
        help="Return non-zero when registry contains invalid/mismatched entries.",
    )
    data_sub.add_parser("health", help="Audit registry health.")
    def _add_acquisition_flags(sub):
        # Canonical reference flag names (data/cli.py:208-268) first; the
        # short names stay as compatibility aliases.
        sub.add_argument("--dataset-root", "--root", type=Path, default=None, dest="root")
        sub.add_argument(
            "--manifest-path", "--manifest", type=Path, default=None, dest="manifest"
        )
        sub.add_argument(
            "--labels-csv-path", "--labels-csv", type=Path, default=None,
            dest="labels_csv",
        )
        sub.add_argument(
            "--audio-base-dir", type=Path, default=None,
            help="Base directory used to resolve FileName entries in label CSV.",
        )
        sub.add_argument(
            "--source", type=str, default=None, dest="source_repo_id",
            help="Optional download source id override (provider mirror).",
        )
        sub.add_argument(
            "--source-revision", type=str, default=None,
            help="Optional download source revision/tag/commit override.",
        )
        sub.add_argument("--accept-license", action="store_true")
        sub.add_argument(
            "--skip-download", action="store_true", default=False,
            help="Skip download step (useful when the dataset is already present).",
        )

    prepare = data_sub.add_parser("prepare", help="Prepare one dataset from local files.")
    prepare.add_argument("dataset_id")
    _add_acquisition_flags(prepare)
    download = data_sub.add_parser(
        "download", help="Download/prepare one dataset (reference data/cli.py:163)."
    )
    download.add_argument("--dataset", dest="dataset_id", required=True)
    _add_acquisition_flags(download)
    uninstall = data_sub.add_parser(
        "uninstall", help="Remove one dataset registry entry and local artifacts."
    )
    uninstall.add_argument("--dataset", dest="dataset_id", required=True)
    uninstall.add_argument(
        "--keep-files", action="store_true",
        help="Only remove the registry entry (keep dataset_root and manifest files).",
    )
    catalog = data_sub.add_parser(
        "catalog", help="Show dataset capabilities and pipeline-use candidates."
    )
    catalog.add_argument("--all", action="store_true")
    catalog.add_argument("--format", choices=("text", "json"), default="text")
    audit = data_sub.add_parser(
        "audit", help="Build the leakage-safe split ledger for registered manifests."
    )
    audit.add_argument("--seed", type=int, default=17)
    audit.add_argument("--lenient", action="store_true", help="Do not fail on missing digests.")
    audit.add_argument("--ledger-out", type=Path, default=None)
    consents = data_sub.add_parser("consents", help="Show or record dataset consents.")
    consents.add_argument("--accept-policy", action="append", default=[])
    consents.add_argument("--accept-license", action="append", default=[])

    benchmark = subparsers.add_parser(
        "benchmark", help="Local fast-profile predict latency on one file."
    )
    benchmark.add_argument("file", type=str)
    benchmark.add_argument("--runs", type=int, default=5)

    gate = subparsers.add_parser(
        "gate", help="Run the fast-vs-candidate rollout quality gate."
    )
    gate.add_argument(
        "--candidate",
        choices=("medium", "accurate", "accurate-research"),
        default="medium",
    )
    # --n-splits is the reference gate's fold knob name
    # (quality_gate_cli.py:54); --out its report-path name (:131).
    gate.add_argument("--folds", "--n-splits", type=int, default=4, dest="folds")
    gate.add_argument("--output", "--out", type=Path, default=None, dest="output")
    gate.add_argument(
        "--require-pass",
        action="store_true",
        help="Exit non-zero (terminal failure) when the gate holds.",
    )
    # Threshold overrides (reference quality_gate_cli.py:106-129) projected
    # onto QualityGateConfig for this invocation.
    gate.add_argument("--min-uar-delta", type=float, default=None)
    gate.add_argument("--min-macro-f1-delta", type=float, default=None)
    gate.add_argument("--max-medium-segments-per-minute", type=float, default=None)
    gate.add_argument(
        "--min-medium-median-segment-duration", type=float, default=None,
        help="Optional lower bound for candidate median segment duration (s).",
    )
    return parser


def _disable_timeouts(settings):
    def zeroed(config):
        return dataclasses.replace(
            config, timeout_seconds=0.0, max_timeout_retries=0
        )

    return dataclasses.replace(
        settings,
        fast_runtime=zeroed(settings.fast_runtime),
        medium_runtime=zeroed(settings.medium_runtime),
        accurate_runtime=zeroed(settings.accurate_runtime),
        accurate_research_runtime=zeroed(settings.accurate_research_runtime),
    )


def _run_doctor(args, settings) -> int:
    from ser_tpu_torch._internal.diagnostics import service

    if args.profile:
        from ser_tpu_torch._internal.api.runtime import apply_cli_profile_override

        settings = apply_cli_profile_override(settings, args.profile)
    report = service.run_doctor_diagnostics(
        settings=settings,
        include_transcription_checks=not args.no_transcription_checks,
        include_training_readiness=args.training_readiness,
        include_noise_findings=args.include_noise_findings,
    )
    print(service.render_report(report, style=args.style))
    if args.strict and report.has_warning_or_higher:
        # Reference diagnostics/command.py:45-49: strict mode fails on any
        # warning-or-higher finding, not just errors.
        return 1
    return EXIT_OK if not report.has_error else 1


def _run_data(args, settings) -> int:
    if args.data_command == "list":
        for dataset_id in api.list_datasets():
            print(dataset_id)
        return EXIT_OK
    if args.data_command == "registry":
        # Reference registry inspection contract (data/cli.py:272-303):
        # --format json emits entries+issues, --strict exits 2 on any health
        # issue, text mode lists root/manifest/source-pin per entry.
        records = api.list_registered_datasets(settings=settings)
        issues = api.list_dataset_registry_health_issues(settings=settings)
        strict_block = EXIT_VALIDATION if args.strict and issues else None
        if args.format == "json":
            import json as json_module

            payload = {
                "entries": [
                    {
                        "dataset_id": r.dataset_id,
                        "dataset_root": r.dataset_root,
                        "manifest_path": r.manifest_path,
                        "utterance_count": r.utterance_count,
                        "options": dict(r.options),
                        "source_repo_id": r.options.get("source_repo_id"),
                        "source_revision": r.options.get("source_revision"),
                    }
                    for r in records
                ],
                "issues": [
                    {
                        "dataset_id": i.dataset_id,
                        "code": i.issue_kind,
                        "message": i.message,
                    }
                    for i in issues
                ],
            }
            print(json_module.dumps(payload, indent=2, sort_keys=True))
            return strict_block if strict_block is not None else EXIT_OK
        if not records:
            print("Dataset registry is empty.")
            return strict_block if strict_block is not None else EXIT_OK
        for record in records:
            if args.show:
                repo_id = record.options.get("source_repo_id")
                revision = record.options.get("source_revision")
                source_pin = f"{repo_id}@{revision}" if repo_id and revision else "(none)"
                print(f"- {record.dataset_id}")
                print(f"  dataset_root: {record.dataset_root}")
                print(f"  manifest_path: {record.manifest_path}")
                print(f"  source_pin: {source_pin}")
            else:
                print(
                    f"{record.dataset_id}: {record.utterance_count} utterances, "
                    f"manifest={record.manifest_path}"
                )
        if issues:
            print("Registry health issues:")
            for issue in issues:
                print(f"- [{issue.dataset_id}] {issue.issue_kind}: {issue.message}")
            if strict_block is not None:
                return strict_block
        else:
            print("Registry health: ok")
        return EXIT_OK
    if args.data_command == "health":
        issues = api.list_dataset_registry_health_issues(settings=settings)
        for issue in issues:
            print(f"{issue.dataset_id}: [{issue.issue_kind}] {issue.message}")
        if not issues:
            print("Registry healthy.")
        return EXIT_OK
    if args.data_command in ("prepare", "download"):
        # `download` is the reference's acquisition verb (data/cli.py:163):
        # same pipeline as prepare, acquisition ON unless --skip-download.
        result, code = run_command(
            lambda: api.prepare_dataset(
                dataset_id=args.dataset_id,
                dataset_root=args.root,
                manifest_path=args.manifest,
                labels_csv_path=args.labels_csv,
                audio_base_dir=args.audio_base_dir,
                source_repo_id=args.source_repo_id,
                source_revision=args.source_revision,
                accept_license=args.accept_license,
                skip_download=args.skip_download,
                settings=settings,
            ),
            label=f"dataset {args.data_command}",
        )
        if result is not None:
            print(
                f"Prepared {result.dataset_id}: {result.utterance_count} utterances "
                f"→ {result.manifest_path}"
            )
            for warning in result.warnings:
                print(f"warning: {warning}")
        return code
    if args.data_command == "uninstall":
        from ser_tpu_torch._internal.data.registry import unregister_dataset

        removed = unregister_dataset(args.dataset_id, settings=settings)
        if removed is None:
            print(f"Dataset {args.dataset_id!r} is not registered.", file=sys.stderr)
            return EXIT_VALIDATION
        if not args.keep_files:
            import shutil as _shutil

            root = Path(removed.dataset_root)
            if root.exists():
                _shutil.rmtree(root, ignore_errors=True)
            manifest = Path(removed.manifest_path)
            if manifest.exists():
                manifest.unlink(missing_ok=True)
        print(
            f"Uninstalled {removed.dataset_id}"
            + (" (files kept)" if args.keep_files else " (files removed)")
        )
        return EXIT_OK
    if args.data_command == "catalog":
        # Reference ``ser data catalog`` (data/cli.py:305-351): installed-
        # dataset capability snapshot with manifest audio stats; --all covers
        # the full supported catalog; --format json emits the payload shape.
        import json as json_module

        from ser_tpu_torch._internal.data.capabilities import (
            build_dataset_capability_snapshot_json_payload,
            collect_dataset_capability_snapshot,
        )

        rows = collect_dataset_capability_snapshot(
            settings=settings, include_uninstalled=bool(args.all)
        )
        if args.format == "json":
            payload = build_dataset_capability_snapshot_json_payload(rows)
            print(json_module.dumps(payload, indent=2, sort_keys=True))
            return EXIT_OK
        if not rows:
            print("No installed datasets found in registry.")
            return EXIT_OK
        for row in rows:
            print(f"- {row.dataset_id} ({row.display_name})")
            print(f"  registered: {'yes' if row.registered else 'no'}")
            print(f"  installed: {'yes' if row.installed else 'no'}")
            print(f"  manifest_exists: {'yes' if row.manifest_exists else 'no'}")
            if row.dataset_root is not None:
                print(f"  dataset_root: {row.dataset_root}")
            if row.manifest_path is not None:
                print(f"  manifest_path: {row.manifest_path}")
            print(
                "  audio_files: "
                f"referenced={row.referenced_audio_files}, "
                f"present={row.present_audio_files}, "
                f"nonempty={row.nonempty_audio_files}"
            )
            print(f"  dataset_size: {row.dataset_size_bytes} bytes")
            print(f"  source_url: {row.source_url}")
            print(f"  policy/license: {row.policy_id} / {row.license_id}")
            print(f"  modalities: {', '.join(row.modalities)}")
            print(f"  label_schema: {row.label_schema}")
            print(
                "  candidates: "
                f"supervised_ser={'yes' if row.supervised_ser_candidate else 'no'}, "
                f"ssl={'yes' if row.ssl_candidate else 'no'}, "
                f"multimodal={'yes' if row.multimodal_candidate else 'no'}, "
                "emotion_merge="
                f"{'yes' if row.mergeable_with_emotion_ontology else 'no'}"
            )
            print(f"  recommended_uses: {', '.join(row.recommended_uses)}")
            for note in row.notes:
                print(f"  note: {note}")
        return EXIT_OK
    if args.data_command == "audit":
        import json as json_module

        from ser_tpu_torch._internal.data.dataset_audit import DatasetAuditError, build_split_ledger
        from ser_tpu_torch._internal.data.manifest import read_manifest_jsonl

        utterances = []
        for record in api.list_registered_datasets(settings=settings):
            utterances.extend(read_manifest_jsonl(Path(record.manifest_path)))
        if not utterances:
            print("No registered manifests to audit.", file=sys.stderr)
            return EXIT_VALIDATION
        try:
            report = build_split_ledger(utterances, seed=args.seed, strict=not args.lenient)
        except DatasetAuditError as err:
            print(f"audit failed: {err}", file=sys.stderr)
            return EXIT_VALIDATION
        print(
            f"ledger: {dict(report.counters)} over {len(report.ledger)} rows "
            f"(seed={report.seed})"
        )
        print(f"manifest digest: {report.manifest_digest}")
        print(f"ledger digest:   {report.ledger_digest}")
        if args.ledger_out is not None:
            args.ledger_out.parent.mkdir(parents=True, exist_ok=True)
            args.ledger_out.write_text(
                json_module.dumps(
                    {
                        "seed": report.seed,
                        "manifest_digest": report.manifest_digest,
                        "ledger_digest": report.ledger_digest,
                        "counters": report.counters,
                        "ledger": [entry.to_record() for entry in report.ledger],
                    },
                    indent=2,
                ),
                encoding="utf-8",
            )
            print(f"ledger written: {args.ledger_out}")
        return EXIT_OK
    if args.data_command == "consents":
        if args.accept_policy or args.accept_license:
            record = api.configure_dataset_consents(
                accept_policy_ids=tuple(args.accept_policy),
                accept_license_ids=tuple(args.accept_license),
                settings=settings,
            )
        else:
            record = api.show_dataset_consents(settings=settings)
        print(f"policies: {', '.join(record.policy_ids) or '(none)'}")
        print(f"licenses: {', '.join(record.license_ids) or '(none)'}")
        return EXIT_OK
    print("Usage: ser data {list,registry,health,prepare,consents}", file=sys.stderr)
    return EXIT_VALIDATION


def _run_configure(args, settings) -> int:
    for backend_id in args.enable_backend:
        if backend_id not in restricted_backends.RESTRICTED_BACKEND_POLICIES:
            print(f"Backend {backend_id!r} is not restricted; nothing to record.")
            continue
        policy = restricted_backends.RESTRICTED_BACKEND_POLICIES[backend_id]
        print(policy.notice)
        restricted_backends.record_backend_consent(backend_id)
        print(f"Recorded consent for {backend_id} (policy {policy.policy_id}).")

    # Dataset-consent flow, reference semantics (data/cli.py:108-154): show
    # (or no accept flags) prints the persisted record; accepting without
    # --persist refuses with exit 2.
    accepts = bool(args.accept_dataset_policy or args.accept_dataset_license)
    if args.show or (not accepts and not args.enable_backend):
        record = api.show_dataset_consents(settings=settings)
        policies = ", ".join(sorted(record.policy_ids)) or "(none)"
        licenses = ", ".join(sorted(record.license_ids)) or "(none)"
        print(f"Persisted dataset policy consents: {policies}")
        print(f"Persisted dataset license consents: {licenses}")
        return EXIT_OK
    if accepts:
        if not args.persist:
            print("Refusing to modify local config without --persist.")
            return EXIT_VALIDATION
        api.configure_dataset_consents(
            accept_policy_ids=tuple(args.accept_dataset_policy),
            accept_license_ids=tuple(args.accept_dataset_license),
            settings=settings,
            source="ser configure",
        )
    return EXIT_OK


def _apply_dataset_recipe_override(settings, args):
    """CLI dataset recipe/audit overrides on one immutable settings snapshot.

    Parity surface: reference ``__main__.py:296-308``
    (``_apply_dataset_recipe_override``): ``--strict-dataset-audit`` /
    ``--no-strict-dataset-audit`` override the audit mode directly, and a
    CLI-passed recipe implies strict auditing unless explicitly relaxed.
    """
    recipe_arg = args.dataset_recipe if isinstance(args.dataset_recipe, str) else None
    strict_arg = args.strict_dataset_audit
    if recipe_arg is None and strict_arg is None:
        return settings
    recipe = recipe_arg or settings.dataset.recipe
    strict = (
        bool(strict_arg)
        if isinstance(strict_arg, bool)
        else True if recipe_arg is not None else settings.dataset.strict_audit
    )
    return dataclasses.replace(
        settings,
        dataset=dataclasses.replace(
            settings.dataset, recipe=recipe, strict_audit=strict
        ),
    )


def _persist_restricted_backend_opt_ins(args, settings) -> int | None:
    """Pre-command restricted-backend consent persistence.

    Parity surface: reference ``restricted_backends.py:100-141``
    (``prepare_restricted_backend_opt_in_state``): ``--accept-all-…`` records
    consent for every known restricted backend, ``--accept-…`` for the active
    profile's backend only; when neither ``--train`` nor ``--file`` is
    requested the flags act as a standalone management command and exit 0.
    """
    if args.accept_all_restricted_backends:
        count = restricted_backends.persist_all_restricted_backend_consents()
        print(f"Recorded consent for {count} restricted backend(s).")
    if args.accept_restricted_backends:
        profile = args.profile or resolve_profile_name(
            medium_profile=settings.runtime_flags.medium_profile,
            accurate_profile=settings.runtime_flags.accurate_profile,
            accurate_research_profile=settings.runtime_flags.accurate_research_profile,
        )
        backend_id = get_profile_catalog()[profile].backend_id
        if backend_id in restricted_backends.RESTRICTED_BACKEND_POLICIES:
            restricted_backends.record_backend_consent(backend_id)
            print(f"Recorded consent for restricted backend {backend_id!r}.")
    if not args.train and not args.file:
        return EXIT_OK
    return None


def _restricted_backend_gate(settings, profile) -> int | None:
    """CLI gate for restricted backends (reference __main__.py:311-325)."""
    spec = get_profile_catalog()[profile]
    if spec.backend_id not in restricted_backends.RESTRICTED_BACKEND_POLICIES:
        return None
    try:
        restricted_backends.ensure_backend_access(spec.backend_id, settings=settings)
    except restricted_backends.RestrictedBackendError as err:
        logger.error("%s", err)
        return EXIT_VALIDATION
    return None


def _preflight_gate(args, settings) -> int | None:
    """Startup preflight gate (reference __main__.py:328-347)."""
    if args.preflight == "off":
        return None
    from ser_tpu_torch._internal.diagnostics import service

    report = api.run_startup_preflight(
        include_transcription_checks=not args.no_transcript,
        settings=settings,
    )
    rendered = service.render_report(report, style="brief")
    if rendered and rendered != "All checks passed.":
        print(rendered, file=sys.stderr)
    if service.preflight_should_abort(report, args.preflight):
        logger.error("Preflight failed in %s mode.", args.preflight)
        return EXIT_VALIDATION
    return None


def _run_transcription_calibration(
    settings, *, iterations: int = 2,
    profiles_csv: str = "accurate,medium,accurate-research,fast",
) -> int:
    """Profiles transcription candidates against RAVDESS canonical sentences.

    Requires locally staged Whisper assets and a dataset of labeled clips;
    persists the recommendation consumed by admission control. Candidates are
    the distinct transcription models the requested profiles resolve to
    (reference ``--calibration-profiles``); ``iterations`` repeats each
    candidate's timed runs to widen the latency percentile matrix
    (reference ``--calibration-iterations``, ``commands.py:223-238``).
    """
    from ser_tpu_torch._internal.data.loader import discover_dataset_files
    from ser_tpu_torch._internal.transcript.calibration import (
        build_calibration_report,
        collect_reference_samples,
        parse_calibration_profiles,
        profile_candidate_matrix,
        save_calibration_report_v2,
        summarize_subset_coverage,
    )

    if iterations <= 0:
        logger.error("--calibration-iterations must be a positive integer.")
        return EXIT_VALIDATION
    try:
        profile_names = parse_calibration_profiles(profiles_csv)
    except ValueError as err:
        logger.error("%s", err)
        return EXIT_VALIDATION
    from ser_tpu_torch._internal.repr.runtime_policy import resolve_feature_runtime
    from ser_tpu_torch._internal.transcript.extractor import TranscriptionUnavailableError
    from ser_tpu_torch._internal.transcript.whisper_backend import BACKEND_ID, WhisperTranscriber

    # Only RAVDESS-coded files carry a KNOWN reference sentence (statement
    # code field 5: 01 → sentence 0, 02 → sentence 1). Scoring arbitrary
    # corpora against a canonical sentence would persist a garbage WER
    # recommendation that admission control then trusts. The subset is
    # stratified across (actor, statement) so a small probe still measures
    # speaker-diverse WER, not one voice's.
    samples = collect_reference_samples(
        list(discover_dataset_files(settings)),
        limit=int(os.environ.get("SER_CALIBRATION_SAMPLE_LIMIT", "12")),
        sampling_strategy="stratified",
    )
    if not samples:
        logger.error(
            "Calibration needs RAVDESS-coded clips with known reference "
            "sentences (SER_DATASET_FOLDER)."
        )
        return EXIT_VALIDATION

    candidates = []
    from ser_tpu_torch._internal.transcript.extractor import resolve_transcription_profile

    # The candidate set is the distinct models the requested profiles
    # resolve to — profiles sharing one transcription model profile once.
    model_names: list[str] = []
    for profile_name in profile_names:
        resolved_tx = resolve_transcription_profile(profile_name, settings)
        if resolved_tx.model_name not in model_names:
            model_names.append(resolved_tx.model_name)
    device = resolve_feature_runtime(BACKEND_ID, torch_runtime=settings.torch_runtime).device
    for model_name in model_names:
        transcriber = WhisperTranscriber(
            model_name=model_name,
            cache_root=settings.models.whisper_download_root,
            device=device,
            use_vad=settings.transcription.use_vad,
            use_demucs=settings.transcription.use_demucs,
            separation_model_path=settings.transcription.separation_model_path,
        )
        try:
            candidates.append(
                profile_candidate_matrix(
                    lambda path, t=transcriber: t.transcribe(path),
                    samples,
                    backend_id=BACKEND_ID,
                    model_name=model_name,
                    iterations=iterations,
                )
            )
        except TranscriptionUnavailableError as err:
            logger.error("%s", err)
            return EXIT_VALIDATION
    if all(entry.evaluated_samples == 0 for entry in candidates):
        # Per-candidate failures are recorded, not fatal — but a run where
        # NO candidate transcribed anything (no staged Whisper assets, every
        # warmup failed) must not persist a recommendation built from
        # placeholder WERs.
        detail = candidates[0].error_message or "no samples evaluated"
        logger.error("Calibration evaluated zero samples (%s).", detail)
        return EXIT_VALIDATION
    report = build_calibration_report(candidates)
    from ser_tpu_torch._internal.transcript.profiling import default_calibration_report_path

    report_path = settings.transcription.calibration_report_path or (
        default_calibration_report_path(settings.tmp_folder)
    )
    path = save_calibration_report_v2(report, report_path)
    recommendation = report["recommendation"]
    coverage = summarize_subset_coverage([Path(p) for p, _ in samples])
    print(
        f"Recommended: {recommendation['model_name']} "
        f"(WER {recommendation['mean_wer']:.2f}, "
        f"p50 {recommendation['p50_latency_seconds']:.1f}s, "
        f"confidence {recommendation['confidence']}; "
        f"{len(samples)} samples over {coverage['actors']} actors / "
        f"{coverage['statements']} statements) → {path}"
    )
    return EXIT_OK


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    configure_logging(args.log_level)

    from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
    from ser_tpu_torch._internal.utils.torch_runtime import honor_platform_env

    try:
        honor_platform_env()
    except RuntimeDependencyError as err:
        logger.error("%s", err)
        return EXIT_VALIDATION

    settings = reload_settings()

    if args.command == "configure":
        return _run_configure(args, settings)
    if args.command == "doctor":
        return _run_doctor(args, settings)
    if args.command == "data":
        return _run_data(args, settings)
    if args.command == "benchmark":
        from ser_tpu_torch._internal.runtime.benchmarks import benchmark_fast_predict

        def _run_benchmark():
            report = benchmark_fast_predict(args.file, runs=args.runs, settings=settings)
            print(report.to_json())

        _, code = run_command(_run_benchmark, label="benchmark")
        return code
    if args.command == "gate":
        # Same license/consent gate as --train/--file: the candidate may be
        # a restricted backend (emotion2vec), and evaluating it loads and
        # runs the restricted model.
        gate_block = _restricted_backend_gate(settings, args.candidate)
        if gate_block is not None:
            return gate_block
        overrides = {
            "min_uar_delta": args.min_uar_delta,
            "min_macro_f1_delta": args.min_macro_f1_delta,
            "max_medium_segments_per_minute": args.max_medium_segments_per_minute,
            "min_medium_median_segment_duration_seconds": (
                args.min_medium_median_segment_duration
            ),
        }
        overrides = {k: v for k, v in overrides.items() if v is not None}
        if overrides:
            settings = dataclasses.replace(
                settings,
                quality_gate=dataclasses.replace(settings.quality_gate, **overrides),
            )
        from ser_tpu_torch._internal.runtime.quality_gate_workflow import (
            run_quality_gate_workflow,
        )

        return run_quality_gate_workflow(
            settings=settings,
            candidate=args.candidate,
            folds=args.folds,
            output_path=args.output,
            require_pass=args.require_pass,
        )

    if args.accept_all_restricted_backends or args.accept_restricted_backends:
        code = _persist_restricted_backend_opt_ins(args, settings)
        if code is not None:
            return code

    if args.calibrate_transcription_runtime:
        if args.profile:
            from ser_tpu_torch._internal.api.runtime import apply_cli_profile_override

            # The profile projection must land BEFORE calibration so the
            # profile's own transcription model/flags are what get profiled.
            settings = apply_cli_profile_override(settings, args.profile)
        return _run_transcription_calibration(
            settings,
            iterations=args.calibration_iterations,
            profiles_csv=args.calibration_profiles,
        )

    if args.disable_timeouts:
        settings = _disable_timeouts(settings)

    active_profile = args.profile or resolve_profile_name(
        medium_profile=settings.runtime_flags.medium_profile,
        accurate_profile=settings.runtime_flags.accurate_profile,
        accurate_research_profile=settings.runtime_flags.accurate_research_profile,
    )

    settings = _apply_dataset_recipe_override(settings, args)

    if args.train:
        gate = _restricted_backend_gate(settings, active_profile)
        if gate is not None:
            return gate
        if args.repair:
            from ser_tpu_torch._internal.models.training_repair import run_training_repair

            return run_training_repair(settings=settings, profile=active_profile)
        if args.dry_run or args.prepare_only or args.prepared_plan:
            from ser_tpu_torch._internal.models.training_readiness import run_training_readiness_cli

            return run_training_readiness_cli(
                settings=settings,
                profile=active_profile,
                dry_run=args.dry_run,
                prepare_only=args.prepare_only,
                prepared_plan=args.prepared_plan,
            )
        _, code = run_command(
            lambda: api.train(profile=args.profile, settings=settings),
            label="training",
            workflow="training",
        )
        return code

    if args.file:
        gate = _restricted_backend_gate(settings, active_profile)
        if gate is not None:
            return gate
        gate = _preflight_gate(args, settings)
        if gate is not None:
            return gate
        result, code = run_command(
            lambda: api.infer(
                args.file,
                profile=args.profile,
                language=args.language,
                save_transcript=args.save_transcript,
                include_transcript=not args.no_transcript,
                subtitle_output_path=args.subtitle_path,
                subtitle_format=args.subtitle_format,
                settings=settings,
            ),
            label="inference",
            workflow="inference",
        )
        if result is not None and result.timeline_csv_path:
            print(f"Timeline CSV: {result.timeline_csv_path}")
        if result is not None and result.subtitle_path:
            print(f"Subtitles: {result.subtitle_path}")
        return code

    parser.print_help()
    return EXIT_VALIDATION


if __name__ == "__main__":
    sys.exit(main())
