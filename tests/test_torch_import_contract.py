"""The PyTorch port imports nothing of JAX, nothing of ser_tpu and no scikit-learn.

Two checks: a fresh interpreter imports every ``ser_tpu_torch`` module and
reports which modules that import added to ``sys.modules`` (a difference, so a
site hook that preloads something cannot fool it); and an AST scan of every
source of the port, plus ``chip_smoke.py``, for import statements naming a
forbidden package.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT_ROOT = REPO_ROOT / "ser_tpu_torch"
_FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax")
#: The card's machine has no scikit-learn: the port draws its split itself (``_internal/data/split.py``).
_FORBIDDEN_PACKAGES = ("sklearn",)


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    if root.startswith(_FORBIDDEN_ROOTS) or root in _FORBIDDEN_PACKAGES:
        return True
    # The port's own name starts with "ser_tpu": compare whole path components.
    return root in ("ser_tpu", "ser")


_PROBE = r"""
import importlib, json, pkgutil, sys
before = set(sys.modules)
import ser_tpu_torch
names = ["ser_tpu_torch"] + [m.name for m in pkgutil.walk_packages(ser_tpu_torch.__path__, "ser_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "added": sorted(set(sys.modules) - before)}))
"""


@pytest.fixture(scope="module")
def fresh_import() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    completed = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO_ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert completed.returncode == 0, completed.stderr[-3000:]
    return json.loads(completed.stdout.strip().splitlines()[-1])


def _module_name(path: Path) -> str:
    parts = path.relative_to(REPO_ROOT).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_fresh_interpreter_imports_every_port_module(fresh_import) -> None:
    expected = {_module_name(path) for path in PORT_ROOT.rglob("*.py")}
    assert set(fresh_import["imported"]) == expected


def test_port_loads_no_jax_and_no_ser_tpu(fresh_import) -> None:
    offenders = [name for name in fresh_import["added"] if _forbidden(name)]
    assert offenders == []
    assert "torch" in fresh_import["added"]


#: The transcript lane's modules: imported in the fresh interpreter like every other.
TRANSCRIPT_LANE_MODULES = (
    "ser_tpu_torch.ops.decode_step_kernels",
    "ser_tpu_torch.models.whisper_decode",
    "ser_tpu_torch.models.word_timing",
    "ser_tpu_torch._internal.utils.source_separation",
    "ser_tpu_torch._internal.utils.denoise",
    "ser_tpu_torch._internal.transcript.base",
    "ser_tpu_torch._internal.transcript.hbm_admission",
    "ser_tpu_torch._internal.transcript.whisper_backend",
    "ser_tpu_torch._internal.transcript.extractor",
)


@pytest.mark.parametrize("module", TRANSCRIPT_LANE_MODULES)
def test_transcript_lane_module_is_imported(fresh_import, module: str) -> None:
    assert module in fresh_import["imported"]


#: The training slice's modules: imported in the fresh interpreter like every other.
TRAINING_MODULES = (
    "ser_tpu_torch.parallel",
    "ser_tpu_torch.parallel.train_step",
    "ser_tpu_torch.parallel.optim",
    "ser_tpu_torch.parallel.checkpoint",
    "ser_tpu_torch.scripts.train_encoder_scaled",
    "ser_tpu_torch._internal.data.ravdess",
)


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_module_is_imported(fresh_import, module: str) -> None:
    assert module in fresh_import["imported"]


#: The medium profile's modules: imported in the fresh interpreter like every other.
MEDIUM_LANE_MODULES = (
    "ser_tpu_torch.models.wav2vec2",
    "ser_tpu_torch.models.param_utils",
    "ser_tpu_torch.models.hf_checkpoint",
    "ser_tpu_torch._internal.repr.wav2vec2_backend",
    "ser_tpu_torch._internal.repr.encode_util",
    "ser_tpu_torch._internal.pool.device_pool",
)


@pytest.mark.parametrize("module", MEDIUM_LANE_MODULES)
def test_medium_lane_module_is_imported(fresh_import, module: str) -> None:
    assert module in fresh_import["imported"]


#: The accurate-research and fast profiles' modules: imported in the fresh interpreter like every other.
RESEARCH_AND_FAST_MODULES = (
    "ser_tpu_torch._internal.runtime.restricted_backends",
    "ser_tpu_torch.models.emotion2vec_convert",
    "ser_tpu_torch._internal.repr.emotion2vec_backend",
    "ser_tpu_torch.ops.dsp",
    "ser_tpu_torch.ops.features",
    "ser_tpu_torch._internal.features",
    "ser_tpu_torch._internal.repr.handcrafted",
    "ser_tpu_torch._internal.models.emotion_model",
    "ser_tpu_torch._internal.runtime.fast_boundary",
)


@pytest.mark.parametrize("module", RESEARCH_AND_FAST_MODULES)
def test_research_and_fast_module_is_imported(fresh_import, module: str) -> None:
    assert module in fresh_import["imported"]


#: The rest of the transcript lane and the int8 lanes: imported in the fresh interpreter like every other.
TRANSCRIPT_REST_AND_INT8_MODULES = (
    "ser_tpu_torch.models.quant",
    "ser_tpu_torch._internal.runtime.oom",
    "ser_tpu_torch._internal.runtime.worker_lifecycle",
    "ser_tpu_torch._internal.transcript.process_isolation",
    "ser_tpu_torch._internal.transcript.profiling",
    "ser_tpu_torch._internal.transcript.calibration",
)


@pytest.mark.parametrize("module", TRANSCRIPT_REST_AND_INT8_MODULES)
def test_transcript_rest_and_int8_module_is_imported(fresh_import, module: str) -> None:
    assert module in fresh_import["imported"]


#: The inference boundary's retry ladder, the data layer and the fast head's trainer.
BOUNDARY_DATA_AND_TRAINING_MODULES = (
    "ser_tpu_torch._internal.utils.logger",
    "ser_tpu_torch._internal.runtime.single_flight",
    "ser_tpu_torch._internal.runtime.policy",
    "ser_tpu_torch._internal.runtime.profile_boundary",
    "ser_tpu_torch._internal.data.ontology",
    "ser_tpu_torch._internal.data.manifest",
    "ser_tpu_torch._internal.data.recipe",
    "ser_tpu_torch._internal.data.dataset_audit",
    "ser_tpu_torch._internal.data.registry",
    "ser_tpu_torch._internal.data.embedding_cache",
    "ser_tpu_torch._internal.data.split",
    "ser_tpu_torch._internal.data.loader",
    "ser_tpu_torch._internal.models.training_readiness",
    "ser_tpu_torch._internal.models.training_orchestration",
    "ser_tpu_torch._internal.train.metrics",
)


@pytest.mark.parametrize("module", BOUNDARY_DATA_AND_TRAINING_MODULES)
def test_boundary_data_and_training_module_is_imported(fresh_import, module: str) -> None:
    assert module in fresh_import["imported"]


def test_port_import_loads_no_tokenizer_library(fresh_import) -> None:
    """``transformers`` is imported only inside ``from_pretrained_dir``."""
    assert not [name for name in fresh_import["added"] if name.split(".")[0] == "transformers"]


def test_forbidden_name_rule() -> None:
    assert _forbidden("ser_tpu") and _forbidden("ser_tpu.models.whisper") and _forbidden("ser.api")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen") and _forbidden("orbax.checkpoint")
    assert _forbidden("sklearn.model_selection") and not _forbidden("sklearnish")
    assert not _forbidden("ser_tpu_torch.models.whisper") and not _forbidden("torch")


def _scanned_sources() -> list[Path]:
    return sorted(PORT_ROOT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    modules = []
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            modules.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            modules.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            modules.extend(
                arg.value for arg in node.args if isinstance(arg, ast.Constant) and isinstance(arg.value, str)
            )
    return modules


@pytest.mark.parametrize(
    "source", _scanned_sources(), ids=lambda path: path.relative_to(REPO_ROOT).as_posix()
)
def test_source_imports_no_forbidden_package(source: Path) -> None:
    offenders = [name for name in _imported_modules(source) if _forbidden(name)]
    assert offenders == [], f"{source.relative_to(REPO_ROOT)} imports {offenders}"


#: The distributed layer and batch inference, with both scripts that drive them.
DISTRIBUTED_MODULES = (
    "ser_tpu_torch.parallel.mesh",
    "ser_tpu_torch.parallel.sharding",
    "ser_tpu_torch.parallel.distributed",
    "ser_tpu_torch.parallel.batch_inference",
    "ser_tpu_torch.models.tensor_parallel",
    "ser_tpu_torch._internal.repr.encoders",
    "ser_tpu_torch.scripts.train_encoder_scaled",
    "ser_tpu_torch.scripts.evaluate_profile",
)


@pytest.mark.parametrize("module", DISTRIBUTED_MODULES)
def test_distributed_module_is_imported(fresh_import, module: str) -> None:
    assert module in fresh_import["imported"]


#: Neural separation (htdemucs and the U-Net) and the timeline's CSV and subtitle export.
SEPARATION_AND_EXPORT_MODULES = (
    "ser_tpu_torch.models.demucs_v4",
    "ser_tpu_torch.models._demucs_synthetic",
    "ser_tpu_torch.models.separation",
    "ser_tpu_torch.models.convert",
    "ser_tpu_torch._internal.utils.source_separation",
    "ser_tpu_torch._internal.utils.subtitles",
    "ser_tpu_torch._internal.utils.timeline",
    "ser_tpu_torch._internal.runtime.pipeline",
)


@pytest.mark.parametrize("module", SEPARATION_AND_EXPORT_MODULES)
def test_separation_and_export_module_is_imported(fresh_import, module: str) -> None:
    assert module in fresh_import["imported"]


#: The settings layer, the profile registry, doctor and preflight, the latency benchmark, the quality gate
#: and the native audio library.
SETTINGS_OPERATOR_AND_NATIVE_MODULES = (
    "ser_tpu_torch._internal.config.schema",
    "ser_tpu_torch._internal.config.settings_inputs",
    "ser_tpu_torch._internal.config.settings_builder",
    "ser_tpu_torch._internal.config.bootstrap",
    "ser_tpu_torch.config",
    "ser_tpu_torch._internal.utils.common",
    "ser_tpu_torch.utils",
    "ser_tpu_torch._internal.runtime.registry",
    "ser_tpu_torch._internal.runtime.environment_plan",
    "ser_tpu_torch._internal.runtime.commands",
    "ser_tpu_torch._internal.api.runtime",
    "ser_tpu_torch.api",
    "ser_tpu_torch._internal.utils.profiling",
    "ser_tpu_torch._internal.runtime.benchmarks",
    "ser_tpu_torch.diagnostics",
    "ser_tpu_torch.diagnostics.domain",
    "ser_tpu_torch._internal.diagnostics.service",
    "ser_tpu_torch._internal.api.diagnostics",
    "ser_tpu_torch._internal.runtime.quality_gate",
    "ser_tpu_torch._internal.runtime.quality_gate_report",
    "ser_tpu_torch._internal.runtime.quality_gate_workflow",
    "ser_tpu_torch._internal.utils.native_audio",
)


@pytest.mark.parametrize("module", SETTINGS_OPERATOR_AND_NATIVE_MODULES)
def test_settings_operator_and_native_module_is_imported(fresh_import, module: str) -> None:
    assert module in fresh_import["imported"]
