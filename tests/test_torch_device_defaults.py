"""Every public constructor of the port runs on the card unless the caller asks for the CPU.

The eight sites that take a ``device`` (``map_location`` for
``restore_train_state``) resolve ``None`` through
``torch_runtime.honor_platform_env``, as the JAX package computes on JAX's
default device:

- with no card and no ``SER_TORCH_DEVICE``, each raises
  ``RuntimeDependencyError`` naming ``SER_TORCH_DEVICE=cpu`` (no silent CPU);
- with ``SER_TORCH_DEVICE=cpu``, every tensor it returns is on the CPU, and
  the three ``random_*_state`` draws equal their ``device="cpu"`` draws bit
  for bit.

One more case walks every function and method of ``ser_tpu_torch/`` and
fails on a ``device`` or ``map_location`` parameter whose default is the CPU,
so that no such default comes back.
"""

from __future__ import annotations

import ast
import pickle
from collections.abc import Callable
from pathlib import Path

import numpy as np
import pytest
import torch

from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError
from ser_tpu_torch.models import multitask_loss, wav2vec2, whisper
from ser_tpu_torch.models.mlp_head import TorchMLPClassifier
from ser_tpu_torch.parallel import checkpoint

PACKAGE = Path(__file__).resolve().parents[1] / "ser_tpu_torch"

#: ``device``/``map_location`` defaults that may name the CPU, each with its reason. None may today.
ALLOWED_CPU_DEFAULTS: dict[str, str] = {}


def _head_state() -> dict:
    rng = np.random.default_rng(0)
    dims = [6, 4, 3]
    return {
        "kind": "ser_tpu_mlp",
        "hidden_layer_sizes": [4],
        "alpha": 0.01,
        "batch_size": 256,
        "epsilon": 1e-8,
        "max_iter": 5,
        "random_state": 42,
        "classes": ["angry", "calm", "happy"],
        "weights": [rng.standard_normal((a, b)).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])],
        "biases": [np.zeros(b, dtype=np.float32) for b in dims[1:]],
        "n_iter": 1,
        "loss": 0.5,
    }


def _constructed_head(tmp_path: Path):
    return TorchMLPClassifier(hidden_layer_sizes=(4,), max_iter=2, batch_size=8).fit(
        np.random.default_rng(1).standard_normal((12, 6)).astype(np.float32), np.arange(12) % 3
    )


def _head_from_state(tmp_path: Path):
    return TorchMLPClassifier.from_state(_head_state())


def _loaded_artifact(tmp_path: Path):
    path = tmp_path / "head.pkl"
    if not path.exists():
        path.write_bytes(pickle.dumps(_head_state()))
    return artifacts.load_model_artifact(path)


def _restored_train_state(tmp_path: Path):
    path = tmp_path / "train_state.pt"
    if not path.exists():
        checkpoint.save_train_state(
            path,
            encoder_params={"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            head_params={"b": torch.ones(3)},
            opt_state={"count": torch.zeros((), dtype=torch.int32), "mu": {"w": torch.zeros(2, 3)}},
            step=3,
        )
    return checkpoint.restore_train_state(path)


#: name -> (call with the default, the same call with ``device="cpu"`` where the draw is seeded).
SITES: dict[str, tuple[Callable, Callable | None]] = {
    "TorchMLPClassifier": (_constructed_head, None),
    "TorchMLPClassifier.from_state": (_head_from_state, None),
    "load_model_artifact": (_loaded_artifact, None),
    "random_whisper_encoder_state": (
        lambda _: whisper.random_whisper_encoder_state(whisper.WhisperConfig.tiny(), seed=0),
        lambda _: whisper.random_whisper_encoder_state(whisper.WhisperConfig.tiny(), seed=0, device="cpu"),
    ),
    "random_whisper_decoder_state": (
        lambda _: whisper.random_whisper_decoder_state(whisper.WhisperConfig.tiny(), seed=0),
        lambda _: whisper.random_whisper_decoder_state(whisper.WhisperConfig.tiny(), seed=0, device="cpu"),
    ),
    "random_wav2vec2_state": (
        lambda _: wav2vec2.random_wav2vec2_state(wav2vec2.Wav2Vec2Config.tiny(), seed=0),
        lambda _: wav2vec2.random_wav2vec2_state(wav2vec2.Wav2Vec2Config.tiny(), seed=0, device="cpu"),
    ),
    "restore_train_state": (_restored_train_state, None),
    "init_multitask_loss_params": (
        lambda _: multitask_loss.init_multitask_loss_params(["primary_emotion", "vad"]),
        None,
    ),
}


def _tensors(value) -> list[torch.Tensor]:
    """Every tensor in a result: nested containers, a loaded artifact's head, a head's layers."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, artifacts.LoadedModel):
        return _tensors(value.model)
    if isinstance(value, TorchMLPClassifier):
        return _tensors(value._layers)
    if isinstance(value, dict):
        return [t for item in value.values() for t in _tensors(item)]
    if isinstance(value, (list, tuple)):
        return [t for item in value for t in _tensors(item)]
    return []


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SER_TORCH_DEVICE", raising=False)
    return monkeypatch


@pytest.mark.parametrize("site", sorted(SITES))
def test_default_device_is_the_card_or_the_requested_cpu(site, no_card, tmp_path) -> None:
    default_call, cpu_call = SITES[site]
    if site in ("load_model_artifact", "restore_train_state"):
        no_card.setenv("SER_TORCH_DEVICE", "cpu")
        default_call(tmp_path)  # writes the file with the CPU requested
        no_card.delenv("SER_TORCH_DEVICE")
    with pytest.raises(RuntimeDependencyError, match="SER_TORCH_DEVICE=cpu"):
        default_call(tmp_path)
    no_card.setenv("SER_TORCH_DEVICE", "cpu")
    result = default_call(tmp_path)
    tensors = _tensors(result)
    assert tensors and all(t.device == torch.device("cpu") for t in tensors)
    if isinstance(result, TorchMLPClassifier):
        assert result.device == torch.device("cpu")
    if cpu_call is not None:
        explicit = cpu_call(tmp_path)
        assert result.keys() == explicit.keys()
        for name in result:
            assert result[name].dtype == explicit[name].dtype
            assert torch.equal(result[name], explicit[name]), name


def _cpu_default(node: ast.expr | None) -> bool:
    """A default of ``"cpu"`` (any case, any index) or ``torch.device("cpu", ...)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.strip().lower().split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and ast.unparse(node.func).split(".")[-1] == "device" and node.args:
        return _cpu_default(node.args[0])
    return False


def _cpu_device_defaults() -> list[str]:
    found = []
    for path in sorted(PACKAGE.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = node.args
            positional = args.posonlyargs + args.args
            pairs = list(zip(positional[len(positional) - len(args.defaults):], args.defaults))
            pairs += [(arg, default) for arg, default in zip(args.kwonlyargs, args.kw_defaults) if default]
            for arg, default in pairs:
                named = arg.arg in ("device", "map_location") or arg.arg.endswith("_device")
                if named and _cpu_default(default):
                    found.append(f"{path.relative_to(PACKAGE.parent)}:{node.lineno} {node.name}({arg.arg})")
    return found


def test_no_function_of_the_port_defaults_to_the_cpu() -> None:
    sites = _cpu_device_defaults()
    assert [site for site in sites if site.split(" ", 1)[1] not in ALLOWED_CPU_DEFAULTS] == []
    # The scan sees such a default: it would have found the eight sites as they were.
    planted = ast.parse('def f(x, *, device: str = "cpu", map_location=torch.device("cpu")): pass')
    defaults = planted.body[0].args.kw_defaults
    assert all(_cpu_default(default) for default in defaults)
