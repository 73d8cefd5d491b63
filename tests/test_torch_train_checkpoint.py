"""Train-state checkpoints of the port (``ser_tpu_torch.parallel.checkpoint``), on the CPU.

Save → restore → continue gives exactly the parameters, optimizer state and
losses of the uninterrupted run (same code, same float32 arithmetic, so no
tolerance); an interrupted overwrite is recovered from its committed
``.staging`` sibling, as ``ser_tpu/_internal/models/orbax_io.py`` does; the
file loads with ``torch.load(weights_only=True)`` and a pickled object is
refused. The training script ``python -m ser_tpu_torch.scripts.train_encoder_scaled``
trains, checkpoints and resumes across processes.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ser_tpu_torch.models import whisper as torch_whisper
from ser_tpu_torch.parallel import checkpoint, optim
from ser_tpu_torch.parallel import train_step as torch_train

REPO_ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _encoder() -> torch_whisper.WhisperEncoder:
    config = torch_whisper.WhisperConfig.tiny()
    return torch_whisper.build_trainable_whisper_encoder(
        config, torch_whisper.random_whisper_encoder_state(config, seed=0, device="cpu"), device=CPU,
        compute_dtype=torch.float32, remat=True, remat_policy="dots",
    )


def _head(seed: int = 1) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    d = torch_whisper.WhisperConfig.tiny().d_model
    return {
        "w1": torch.from_numpy((rng.standard_normal((2 * d, 16)) * 0.02).astype(np.float32)),
        "b1": torch.zeros(16),
        "w2": torch.from_numpy((rng.standard_normal((16, 8)) * 0.02).astype(np.float32)),
        "b2": torch.zeros(8),
    }


def _batches(steps: int, batch: int = 1):
    rng = np.random.default_rng(2)
    waves = torch.from_numpy((0.1 * rng.standard_normal((steps, batch, torch_whisper.CHUNK_SAMPLES))).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 8, size=(steps, batch)).astype(np.int32))
    return waves, labels


def _start(optimizer: optim.Optimizer):
    encoder = _encoder()
    place, step, optimizer = torch_train.make_sharded_train_step(encoder, CPU, optimizer)
    head, _, _ = place(_head(), torch.zeros(1), torch.zeros(1))
    return encoder, step, head, optimizer.init(torch_train.train_parameters(encoder, head))


@pytest.mark.parametrize("make", [optim.adafactor, optim.adam], ids=["adafactor", "adam"])
def test_save_restore_continue_equals_uninterrupted(tmp_path, make) -> None:
    waves, labels = _batches(4)
    encoder, step, head, state = _start(make(1e-3))
    straight = []
    for i in range(4):
        head, state, loss = step(head, state, waves[i], labels[i])
        straight.append(loss)

    first, step_a, head_a, state_a = _start(make(1e-3))
    resumed = []
    for i in range(2):
        head_a, state_a, loss = step_a(head_a, state_a, waves[i], labels[i])
        resumed.append(loss)
    path = tmp_path / "ck" / "trainstate"
    checkpoint.save_train_state(path, encoder_params=first.state_dict(), head_params=head_a, opt_state=state_a,
                                step=2)
    del first, step_a, head_a, state_a

    second, step_b, head_b, state_b = _start(make(1e-3))
    encoder_params, head_params, opt_state, at = checkpoint.restore_train_state(path, map_location="cpu")
    assert at == 2
    second.load_state_dict(encoder_params, strict=True)
    head_b = {name: tensor.requires_grad_() for name, tensor in head_params.items()}
    for i in range(2, 4):
        head_b, opt_state, loss = step_b(head_b, opt_state, waves[i], labels[i])
        resumed.append(loss)

    assert torch.equal(torch.stack(straight), torch.stack(resumed))
    for name, tensor in encoder.state_dict().items():
        assert torch.equal(second.state_dict()[name], tensor), name
    assert all(torch.equal(head[name], head_b[name]) for name in head)
    assert opt_state["count"] == state["count"] == 4
    for group in ("v_row", "v_col", "v", "mu", "nu"):
        for name, tensor in state.get(group, {}).items():
            assert torch.equal(opt_state[group][name], tensor), (group, name)


def _small_state(value: float) -> dict:
    params = {"w": torch.full((256, 128), value), "b": torch.full((4,), value)}
    return {
        "encoder_params": {"w": params["w"]},
        "head_params": {"b": params["b"]},
        "opt_state": optim.adafactor(1e-3).init(params),
    }


def test_overwrite_swaps_through_staging_and_leaves_nothing_behind(tmp_path) -> None:
    path = tmp_path / "trainstate"
    checkpoint.save_train_state(path, step=1, **_small_state(1.0))
    checkpoint.save_train_state(path, step=2, **_small_state(2.0))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trainstate"]
    encoder_params, head_params, opt_state, step = checkpoint.restore_train_state(path, map_location="cpu")
    assert step == 2 and torch.equal(encoder_params["w"], torch.full((256, 128), 2.0))
    assert set(opt_state["v_row"]) == {"w"} and opt_state["count"] == 0


def test_committed_staging_copy_is_recovered(tmp_path) -> None:
    """A crash between removing the old file and renaming the staging copy leaves only the copy."""
    path = tmp_path / "trainstate"
    checkpoint.save_train_state(path, step=3, **_small_state(3.0))
    path.rename(tmp_path / "trainstate.staging")
    _, head_params, _, step = checkpoint.restore_train_state(path, map_location="cpu")
    assert step == 3 and torch.equal(head_params["b"], torch.full((4,), 3.0))
    assert path.exists() and not (tmp_path / "trainstate.staging").exists()


def test_stale_staging_copy_does_not_block_an_overwrite(tmp_path) -> None:
    path = tmp_path / "trainstate"
    checkpoint.save_train_state(path, step=1, **_small_state(1.0))
    checkpoint.save_train_state(tmp_path / "trainstate.staging", step=9, **_small_state(9.0))
    checkpoint.save_train_state(path, step=4, **_small_state(4.0))
    assert checkpoint.restore_train_state(path, map_location="cpu")[3] == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["trainstate"]


def test_missing_checkpoint_raises(tmp_path) -> None:
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(tmp_path / "absent", map_location="cpu")


def test_file_is_weights_only_and_pickles_are_refused(tmp_path) -> None:
    path = tmp_path / "trainstate"
    checkpoint.save_train_state(path, step=5, **_small_state(5.0))
    state = torch.load(path, weights_only=True)
    assert state["format"] == checkpoint.FORMAT and state["step"] == 5

    class Payload:
        def __reduce__(self):
            return (print, ("unpickled",))

    evil = tmp_path / "evil"
    torch.save({"format": checkpoint.FORMAT, "step": Payload()}, evil)
    with pytest.raises(pickle.UnpicklingError):
        checkpoint.restore_train_state(evil, map_location="cpu")
    other = tmp_path / "other"
    torch.save({"step": 1}, other)
    with pytest.raises(ValueError, match="not a"):
        checkpoint.restore_train_state(other, map_location="cpu")


def _run_script(*args: str) -> str:
    env = dict(os.environ)
    env["SER_TORCH_DEVICE"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(REPO_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    result = subprocess.run(
        [sys.executable, "-m", "ser_tpu_torch.scripts.train_encoder_scaled", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO_ROOT,
    )
    assert result.returncode == 0, result.stdout + result.stderr
    return result.stdout


def test_training_script_trains_then_resumes_across_processes(tmp_path) -> None:
    base = ["--synthetic", "--model", "tiny", "--batch", "2", "--steps-per-dispatch", "2",
            "--checkpoint", str(tmp_path / "ck")]
    first = _run_script(*base, "--steps", "4")
    assert "step     2" in first and "step     4" in first and "done" in first
    assert "audio_s/s" in first and "ms/step" in first
    assert (tmp_path / "ck" / "trainstate").exists()
    resumed = _run_script(*base, "--steps", "6", "--resume", "--optimizer", "adafactor")
    assert "resumed at step 4" in resumed
    assert "step     6" in resumed and "step     4" not in resumed and "done" in resumed
    losses = [float(line.split("loss")[1].split()[0]) for line in (first + resumed).splitlines() if "loss" in line]
    assert len(losses) == 3 and all(np.isfinite(losses))
