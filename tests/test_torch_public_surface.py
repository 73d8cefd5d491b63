"""Every public name of ``ser_tpu`` has its counterpart in ``ser_tpu_torch``, or a by-design exclusion.

``ser_tpu/**/*.py`` is parsed with ``ast`` (nothing of JAX is imported):
its public names are the top-level functions, classes and type aliases whose
names do not start with ``_``, the top-level assignments whose names start
with a capital (constants and aliases), and the names of ``__all__``. The
counterpart module, at the same path under ``ser_tpu_torch`` unless it is
renamed below, is imported and must carry each name. An exclusion names the
difference of ``ROADMAP.md``'s Queue 3 that records it; a test checks that
the difference is recorded there and that the exclusion is still needed.
"""

from __future__ import annotations

import ast
import importlib
import re
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO_ROOT / "ser_tpu"

#: Modules with no counterpart, by design: difference number.
EXCLUDED_MODULES: dict[str, int] = {
    "_internal/models/orbax_io.py": 5,  # the port's own train-state checkpoints
    "ops/pallas_kernels.py": 36,  # became K1, ops/log_mel.py with csrc/log_mel.cu
}
#: Modules whose counterpart has another name: (port module, difference number).
RENAMED_MODULES: dict[str, tuple[str, int]] = {
    "_internal/utils/jax_runtime.py": ("_internal/utils/torch_runtime.py", 36),
    "_internal/transcript/jax_whisper_backend.py": ("_internal/transcript/whisper_backend.py", 36),
}
#: Names with no counterpart of the same name, by design: (ser_tpu module, name) →
#: (difference number, the port's counterpart in the same module, or None).
EXCLUDED_NAMES: dict[tuple[str, str], tuple[int, str | None]] = {
    ("_internal/utils/jax_runtime.py", "ensure_compilation_cache"): (36, None),
    ("_internal/transcript/jax_whisper_backend.py", "JaxWhisperTranscriber"): (36, "WhisperTranscriber"),
    ("models/mlp_head.py", "JaxMLPClassifier"): (37, "TorchMLPClassifier"),
    ("models/emotion2vec_convert.py", "load_funasr_emotion2vec_params"): (37, "load_funasr_emotion2vec_state"),
    ("models/wav2vec2.py", "init_wav2vec2_params"): (37, "random_wav2vec2_state"),
    ("models/wav2vec2.py", "load_hf_wav2vec2_params"): (37, "load_hf_wav2vec2_state"),
    ("models/whisper.py", "init_whisper_encoder_params"): (37, "random_whisper_encoder_state"),
    ("models/param_utils.py", "cast_params_bf16"): (37, None),
    ("models/whisper.py", "decoder_logits"): (38, None),
    ("models/whisper.py", "greedy_decode_on_device"): (38, None),
}


def _public_names(path: Path) -> set[str]:
    names: set[str] = set()
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.TypeAlias):
            names.add(node.name.id)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                if isinstance(target, ast.Name) and target.id == "__all__" and node.value is not None:
                    names.update(ast.literal_eval(node.value))
                elif isinstance(target, ast.Name) and target.id[:1].isupper():
                    names.add(target.id)
    return {name for name in names if not name.startswith("_")}


def _modules() -> list[str]:
    return sorted(path.relative_to(JAX_ROOT).as_posix() for path in JAX_ROOT.rglob("*.py"))


def _port_module(relative: str) -> str:
    target = RENAMED_MODULES.get(relative, (relative, 0))[0]
    parts = Path(target).with_suffix("").parts
    return ".".join(("ser_tpu_torch", *(parts[:-1] if parts[-1] == "__init__" else parts)))


@pytest.mark.parametrize("relative", [m for m in _modules() if m not in EXCLUDED_MODULES])
def test_public_names_have_their_counterpart(relative: str) -> None:
    module = importlib.import_module(_port_module(relative))
    missing = []
    for name in sorted(_public_names(JAX_ROOT / relative)):
        excluded = EXCLUDED_NAMES.get((relative, name))
        if excluded is not None:
            counterpart = excluded[1]
            assert counterpart is None or hasattr(module, counterpart), f"{name} → {counterpart}"
            continue
        if not hasattr(module, name):
            missing.append(name)
    assert missing == [], f"ser_tpu/{relative}: {missing} missing from {module.__name__}"


def test_every_exclusion_is_needed_and_recorded() -> None:
    roadmap = (REPO_ROOT / "ROADMAP.md").read_text(encoding="utf-8")
    recorded = {int(n) for n in re.findall(r"^\s*(\d+)\. \*\*", roadmap, flags=re.MULTILINE)}
    cited = set(EXCLUDED_MODULES.values()) | {n for _, n in RENAMED_MODULES.values()} | {
        n for n, _ in EXCLUDED_NAMES.values()}
    assert cited <= recorded, f"differences {sorted(cited - recorded)} are not recorded in ROADMAP.md"
    for relative in EXCLUDED_MODULES:
        assert (JAX_ROOT / relative).is_file()
        assert not (REPO_ROOT / "ser_tpu_torch" / relative).exists()
    for (relative, name) in EXCLUDED_NAMES:
        assert name in _public_names(JAX_ROOT / relative), (relative, name)
        assert not hasattr(importlib.import_module(_port_module(relative)), name), (relative, name)


def test_the_scan_sees_the_surface() -> None:
    """The rule reads functions, classes, capitalized constants and ``__all__``, not private or lowercase names."""
    names = _public_names(JAX_ROOT / "profiles.py")
    assert {"get_profile_catalog", "ProfileSpec", "PROFILE_NAMES", "ProfileName", "ProfileCatalogEntry"} <= names
    assert not {n for n in names if n.startswith("_")}
    assert "logger" not in _public_names(JAX_ROOT / "_internal/runtime/pipeline.py")
    assert len(_modules()) > 140
