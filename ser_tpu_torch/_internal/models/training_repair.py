"""Training repair allowlist: safe local repairs + network-gated redownload.

Counterpart of ``ser_tpu/_internal/models/training_repair.py``: the same allowlist and the same records.

Parity surface: reference ``ser/_internal/models/training_readiness.py:1893-2143``
— an explicit allowlist of repairs applied before re-running readiness:
application directories, abandoned staging/probe files, stale prepared/cache
payloads, manifest rebuilds, and (only when ``SER_TRAINING_REPAIR_ALLOW_NETWORK``
opts in) redownload of an explicitly revision-pinned model. Every action emits
a typed ``RepairRecord`` so ``--repair`` output is auditable.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.profiles import ProfileName, get_profile_catalog

logger = get_logger(__name__)

#: Abandoned write-probe / staging temporaries the repair pass may remove.
_STAGING_PATTERNS = (".ser-write-probe-*", ".prepared-training-*", ".training-readiness-*")


@dataclass(frozen=True)
class RepairRecord:
    """One allowlisted repair action's outcome."""

    action: str
    target: str
    succeeded: bool
    detail: str

    def render(self) -> str:
        status = "ok" if self.succeeded else "FAILED"
        return f"repair[{status}] {self.action}: {self.target} — {self.detail}"


def network_repairs_allowed() -> bool:
    """Network-touching repairs require an explicit opt-in env flag."""
    return os.environ.get("SER_TRAINING_REPAIR_ALLOW_NETWORK", "").strip().lower() in {
        "1",
        "true",
        "yes",
    }


def _repair_directories(settings: AppConfig) -> list[RepairRecord]:
    records = []
    owned = {
        settings.tmp_folder,
        settings.models.folder,
        settings.models.huggingface_cache_root,
    }
    for path in sorted(owned, key=str):
        try:
            Path(path).mkdir(parents=True, exist_ok=True)
        except OSError as err:
            records.append(RepairRecord("create_application_directory", str(path), False, str(err)))
        else:
            records.append(
                RepairRecord("create_application_directory", str(path), True, "present")
            )
    return records


def _repair_staging(settings: AppConfig) -> RepairRecord:
    removed, failures = 0, 0
    root = Path(settings.tmp_folder)
    if root.is_dir():
        for pattern in _STAGING_PATTERNS:
            for path in root.rglob(pattern):
                if not path.is_file():
                    continue
                try:
                    path.unlink(missing_ok=True)
                    removed += 1
                except OSError:
                    failures += 1
    return RepairRecord(
        "clean_application_staging",
        str(root),
        failures == 0,
        f"removed {removed} abandoned staging/probe file(s); failures={failures}",
    )


def _repair_caches(settings: AppConfig) -> list[RepairRecord]:
    """Invalidates CORRUPT derived-cache entries only.

    Reference ``training_readiness.py:1956-1981``: every ``.npz`` under the
    derived cache roots is validated by loading it (``allow_pickle=False``)
    and only unreadable entries are removed — valid cached encodes represent
    hours of accelerator work and MUST survive a repair pass.
    """
    import numpy as np

    cache_roots = (
        Path(settings.tmp_folder) / "embedding-cache",
        Path(settings.tmp_folder) / "prepared",
    )
    invalidated = 0
    failures = 0
    for cache_root in cache_roots:
        if not cache_root.is_dir():
            continue
        for cache_path in cache_root.rglob("*.npz"):
            try:
                with np.load(cache_path, allow_pickle=False) as payload:
                    _ = tuple(payload.files)
            except (OSError, ValueError, EOFError):
                try:
                    cache_path.unlink(missing_ok=True)
                except OSError:
                    failures += 1
                else:
                    invalidated += 1
    return [
        RepairRecord(
            "invalidate_derived_cache",
            ",".join(str(path) for path in cache_roots),
            failures == 0,
            f"Invalidated {invalidated} corrupt derived cache entrie(s); "
            f"failures={failures}.",
        )
    ]


def _repair_manifests(settings: AppConfig) -> list[RepairRecord]:
    """Re-validates registered dataset manifests; rebuilds rebuildable ones."""
    from ser_tpu_torch._internal.data.registry import list_registered_datasets

    records: list[RepairRecord] = []
    try:
        entries = list_registered_datasets(settings=settings)
    except Exception as err:  # noqa: BLE001 - a broken registry is itself a record
        return [RepairRecord("rebuild_manifest", "registry", False, str(err))]
    for entry in entries:
        manifest = Path(entry.manifest_path) if entry.manifest_path else None
        if manifest is None:
            continue
        if manifest.is_file():
            records.append(
                RepairRecord("rebuild_manifest", entry.dataset_id, True, "manifest present")
            )
            continue
        root = Path(entry.dataset_root) if entry.dataset_root else None
        if root is None or not root.is_dir():
            records.append(
                RepairRecord(
                    "rebuild_manifest",
                    entry.dataset_id,
                    False,
                    "manifest missing and no local dataset root to rebuild from",
                )
            )
            continue
        try:
            from ser_tpu_torch._internal.data.prepare import prepare_dataset

            prepare_dataset(
                dataset_id=entry.dataset_id,
                dataset_root=root,
                manifest_path=manifest,
                skip_download=True,
                settings=settings,
            )
            records.append(
                RepairRecord("rebuild_manifest", entry.dataset_id, True, "rebuilt from root")
            )
        except Exception as err:  # noqa: BLE001
            records.append(
                RepairRecord("rebuild_manifest", entry.dataset_id, False, str(err)[:500])
            )
    return records


def _git_root(path: Path) -> Path | None:
    """Nearest ancestor (including ``path``) that is a git checkout root."""
    candidate = Path(path).expanduser().resolve()
    for ancestor in (candidate, *candidate.parents):
        if (ancestor / ".git").exists():
            return ancestor
    return None


def _run_repair_command(command: tuple[str, ...], *, timeout: float = 300.0) -> tuple[bool, str]:
    """Runs one repair subprocess; never raises — failures become records."""
    import subprocess

    try:
        completed = subprocess.run(
            command, capture_output=True, text=True, timeout=timeout, check=False
        )
    except FileNotFoundError:
        return False, f"{command[0]} is not installed"
    except subprocess.TimeoutExpired:
        return False, f"timed out after {timeout:.0f}s"
    if completed.returncode == 0:
        return True, "ok"
    detail = (completed.stderr or completed.stdout or "").strip()
    return False, f"exit {completed.returncode}: {detail[:200]}"


def _repair_git_lfs(settings: AppConfig) -> list[RepairRecord]:
    """Hydrates Git-LFS pointer corpora (reference ``:2004-2033``).

    ``git lfs checkout`` is a local object-store materialization and always
    allowed; ``git lfs pull`` touches the network and only runs behind the
    explicit opt-in. Datasets are selected via the registry health audit's
    ``lfs_pointer`` issue so doctor and repair agree on detection.
    """
    from ser_tpu_torch._internal.data.registry import audit_registry_health, list_registered_datasets

    try:
        issues = audit_registry_health(settings=settings)
        entries = list_registered_datasets(settings=settings)
    except Exception as err:  # noqa: BLE001 - registry defects have their own repair
        return [RepairRecord("hydrate_git_lfs", "registry", False, str(err))]
    lfs_ids = {issue.dataset_id for issue in issues if issue.issue_kind == "lfs_pointer"}
    git_roots = sorted(
        {
            root
            for entry in entries
            if entry.dataset_id in lfs_ids
            and (root := _git_root(Path(entry.dataset_root))) is not None
        },
        key=str,
    )
    records = []
    for root in git_roots:
        succeeded, detail = _run_repair_command(("git", "-C", str(root), "lfs", "checkout"))
        if not succeeded and network_repairs_allowed():
            pulled, pull_detail = _run_repair_command(("git", "-C", str(root), "lfs", "pull"))
            if pulled:
                succeeded, detail = _run_repair_command(
                    ("git", "-C", str(root), "lfs", "checkout")
                )
            else:
                detail = pull_detail
        records.append(RepairRecord("hydrate_git_lfs", str(root), succeeded, detail))
    return records


def _repair_pinned_model(settings: AppConfig, profile: ProfileName) -> RepairRecord:
    """Redownloads ONLY an explicitly revision-pinned model, behind the gate.

    Reference ``:2056-2143``: the repair refuses unpinned models (a floating
    revision redownload could silently change training behavior) and refuses
    entirely without the network opt-in.
    """
    spec = get_profile_catalog()[profile]
    model_id = spec.model.default_model_id or ""
    if not network_repairs_allowed():
        return RepairRecord(
            "redownload_pinned_model",
            model_id or "<none>",
            False,
            "Network policy denied repair; set SER_TRAINING_REPAIR_ALLOW_NETWORK=1 explicitly.",
        )
    if not model_id or "@" not in model_id:
        return RepairRecord(
            "redownload_pinned_model",
            model_id or "<none>",
            False,
            "Model pin is invalid: repairs require an explicit model_id@revision pin.",
        )
    repo_id, revision = model_id.rsplit("@", 1)
    try:
        from huggingface_hub import snapshot_download

        path = snapshot_download(
            repo_id=repo_id,
            revision=revision,
            cache_dir=str(settings.models.huggingface_cache_root),
        )
        return RepairRecord("redownload_pinned_model", model_id, True, f"refetched to {path}")
    except Exception as err:  # noqa: BLE001 - zero-egress environments land here
        return RepairRecord(
            "redownload_pinned_model",
            model_id,
            False,
            f"Network downloads are disabled or unreachable in this runtime: {err}"[:500],
        )


def apply_training_repairs(
    *, settings: AppConfig, profile: ProfileName
) -> list[RepairRecord]:
    """Applies every allowlisted repair; network repairs only when opted in."""
    records: list[RepairRecord] = []
    records.extend(_repair_directories(settings))
    records.append(_repair_staging(settings))
    records.extend(_repair_caches(settings))
    records.extend(_repair_manifests(settings))
    records.extend(_repair_git_lfs(settings))
    records.append(_repair_pinned_model(settings, profile))
    return records


def run_training_repair(*, settings: AppConfig, profile: ProfileName) -> int:
    """``--repair`` flow: apply the allowlist, then re-verify readiness.

    The verification includes the backend smoke — a repair prompted by a
    hung/miswired backend must not report success without exercising the
    component it repaired (``ensure_entrypoint_readiness`` always smokes).
    """
    from ser_tpu_torch._internal.models.training_readiness import (
        FindingSeverity,
        run_backend_smoke,
        run_training_readiness,
    )

    for record in apply_training_repairs(settings=settings, profile=profile):
        print(record.render())
    report = run_training_readiness(settings=settings, profile=profile)
    blocking = report.blocking
    if not blocking and report.usable_files:
        smoke = run_backend_smoke(
            settings=settings,
            profile=profile,
            usable_files=report.usable_files,
            usable_records=report.usable_records,
        )
        for finding in smoke:
            print(f"repair: smoke {finding.reason}: {finding.message}")
        blocking = blocking or any(
            finding.severity is FindingSeverity.BLOCKING for finding in smoke
        )
    print(
        f"repair: post-repair readiness usable={len(report.usable_files)} "
        f"quarantined={len(report.quarantined_files)} blocking={blocking}"
    )
    return 2 if blocking else 0


__all__ = [
    "RepairRecord",
    "apply_training_repairs",
    "network_repairs_allowed",
    "run_training_repair",
]
