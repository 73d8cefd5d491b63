"""The program under test, ``ser_tpu_torch``, set up through its public settings.

The run's inputs go to the port as a user's would: the head artifact under
``SER_MODELS_FOLDER``, caches under ``SER_CACHE_DIR``, the profile switched on by its
``SER_ENABLE_*_PROFILE``, the encoder's seeded full-size init by
``SER_ALLOW_RANDOM_INIT`` and ``SER_RANDOM_INIT_SIZE``, the pooling and postprocessing
knobs from the configuration file. Nothing of the port is imported before the
environment is set.
"""

from __future__ import annotations

import gc
import os
import pickle
import sys
from pathlib import Path

#: Top-level modules that must not be loaded: JAX, its libraries, the JAX package and the
#: original. Compared by whole top-level name, so ``ser_tpu_torch`` passes.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "ser_tpu", "ser")


def forbidden_loaded() -> list[str]:
    """The forbidden top-level modules in ``sys.modules``."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def settings_env(config: dict, root: Path, device: str) -> dict[str, str]:
    """The port's settings for a run whose files live under ``root``."""
    profile = config["profile"].upper().replace("-", "_")
    env = {
        f"SER_ENABLE_{profile}_PROFILE": "1",
        "SER_MODELS_FOLDER": str(root / "models"),
        "SER_CACHE_DIR": str(root / "cache"),
        "SER_DATA_DIR": str(root / "data"),
        "SER_TMP_FOLDER": str(root / "tmp"),
        "SER_TORCH_DEVICE": device,
        "SER_TORCH_DTYPE": "auto",
    }
    for knob, value in config["runtime"].items():
        env[f"SER_{profile}_{knob.upper()}"] = str(value)
    return env


def prepare(config: dict, root: Path, device: str, head: dict, overrides: dict[str, str] | None = None):
    """Sets the environment, writes the head artifact, and returns the port's settings."""
    env = settings_env(config, root, device) | (overrides or {})
    os.environ.update({"SER_ALLOW_RANDOM_INIT": "1", "SER_RANDOM_INIT_SIZE": config["random_init_size"],
                       "USE_FLAX": "0", "USE_JAX": "0"} | env)
    import ser_tpu_torch
    from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
    from ser_tpu_torch._internal.config.bootstrap import build_settings

    if Path(ser_tpu_torch.__file__).resolve().parents[1] != Path(__file__).resolve().parents[2]:
        raise RuntimeError(f"ser_tpu_torch was imported from {ser_tpu_torch.__file__}, not from this checkout")

    name = profile_artifact_file_name(profile=config["profile"], model_id=config["model_id"])
    write_head_artifact(root / "models" / name, head, config)
    return build_settings(env)


def write_head_artifact(path: Path, head: dict, config: dict) -> None:
    """A ``ser_tpu_mlp`` envelope (artifact version 3) holding ``head``."""
    feature_size = head["weights"][0].shape[0]
    state = {
        "kind": "ser_tpu_mlp", "hidden_layer_sizes": [w.shape[1] for w in head["weights"][:-1]],
        "alpha": 0.01, "batch_size": 256, "epsilon": 1e-8, "max_iter": 500, "random_state": 42,
        "classes": head["labels"], "weights": head["weights"], "biases": head["biases"], "n_iter": 1, "loss": 1.0,
    }
    metadata = {
        "artifact_version": 3, "artifact_schema_version": "v2", "feature_vector_size": feature_size,
        "feature_dim": feature_size, "training_samples": 1, "labels": head["labels"],
        "backend_id": config["backend_id"], "profile": config["profile"], "pooling_strategy": "mean_std",
        "backend_model_id": config["model_id"],
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(pickle.dumps({"artifact_version": 3, "model": state, "metadata": metadata}))


def release() -> None:
    """Frees the port's built encoders (it keeps one per weight provenance) and the card's cache."""
    import torch

    from ser_tpu_torch._internal.repr import encoders

    encoders._BACKEND_CACHE.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
