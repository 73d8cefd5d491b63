"""The port's data- and tensor-parallel train step against ``ser_tpu``'s GSPMD step, on the CPU.

The port runs one process per rank over gloo (``SER_DIST_*``,
``SER_TORCH_DEVICE=cpu``), in worlds of 4 (dp2×tp2) and 2 (dp2×tp1,
dp1×tp2); ``ser_tpu`` runs ``make_sharded_train_step`` /
``make_sharded_train_loop`` on its virtual CPU mesh at the same (dp, tp).
The weights are ``init_whisper_encoder_params(tiny, seed=0)`` carried across
with ``convert.py``; each rank cuts its shards from that full state dict
(``build_trainable_whisper_encoder(..., mesh=mesh)``). Float32 on both sides,
global batch 4, ``test_torch_train_step.py``'s fixture.

- dp2×tp2: one SGD step, and K = 2 loop steps with adam and with
  ``adafactor(min_dim_size_to_factor=32)`` (at tiny widths the default 128
  factors nothing; at 32 every q/k/v/out and MLP weight is factored, and the
  row and column means cross the shards). dp2×tp1: the adam loop.
  dp1×tp2: the adafactor loop.
- losses rtol 1e-5 (float32 sums in another order); parameters rtol 1e-5
  beside ``test_torch_train_step.py``'s measured one-device limits (atol
  1e-7 sgd, 2e-5 adam, 1e-6 adafactor), which the same arithmetic sets here.
- a checkpoint written at dp2×tp2 after the adafactor loop's first step and
  restored at dp2×tp1 gives the loop's second step;
- a planted fault (the row-parallel all-reduce skipped) must miss the limits;
- in one process, a 1×1 mesh (``build_mesh`` forms a gloo group of one)
  gives the one-device loop's losses and parameters bit for bit, its
  gradients all-reduced over the data axis in one bucket a step.

Every world joins under its own time limit, so a hung collective fails the test.
"""

from __future__ import annotations

import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from ser_tpu._internal.config.schema import MeshConfig
from ser_tpu.models import whisper as jax_whisper
from ser_tpu.parallel import train_step as jax_train
from ser_tpu.parallel.mesh import build_mesh
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import whisper as torch_whisper
from ser_tpu_torch.parallel import distributed, optim, train_step
from ser_tpu_torch.parallel import mesh as mesh_module
from test_torch_distributed_config import run_world

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
PARAM_ATOL = {"sgd": 1e-7, "adam": 2e-5, "adafactor": 1e-6}
BATCH, STEPS = 4, 2

#: (dp, tp) → the cases its port world runs, in order.
WORLDS = {
    (2, 2): ("sgd", "adam", "adafactor", "checkpoint", "fault"),
    (2, 1): ("adam", "restore"),
    (1, 2): ("adafactor",),
}
#: The ``ser_tpu`` references: (dp, tp, optimizer).
REFERENCES = ((2, 2, "sgd"), (2, 2, "adam"), (2, 2, "adafactor"), (2, 1, "adam"), (1, 2, "adafactor"))

_WORKER = textwrap.dedent(
    """
    import sys
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from ser_tpu_torch._internal.config.bootstrap import build_settings
    from ser_tpu_torch.models import whisper
    from ser_tpu_torch.parallel import checkpoint, optim, sharding, train_step
    from ser_tpu_torch.parallel.distributed import initialize_distributed, shutdown_distributed
    from ser_tpu_torch.parallel.mesh import build_mesh

    fixture, out, tag = torch.load(sys.argv[1], weights_only=True), Path(sys.argv[2]), sys.argv[4]
    assert initialize_distributed()
    mesh = build_mesh(build_settings().mesh)
    cpu = torch.device("cpu")
    optimizers = {
        "sgd": lambda: optim.sgd(1e-3),
        "adam": lambda: optim.adam(1e-3),
        "adafactor": lambda: optim.adafactor(1e-3, min_dim_size_to_factor=32),
    }

    def encoder():
        return whisper.build_trainable_whisper_encoder(
            # A copy: build_trainable_whisper_encoder takes a tensor already on the device as the parameter.
            whisper.WhisperConfig.tiny(), {k: v.clone() for k, v in fixture["state"].items()}, device=cpu,
            compute_dtype=torch.float32,
            remat=False, mesh=mesh,
        )

    def record(case, losses, enc, head):
        full = sharding.gather_state_dict(mesh, {k: v.detach() for k, v in enc.state_dict().items()})
        if dist.get_rank() == 0:
            head = {k: v.detach() for k, v in head.items()}
            torch.save({"losses": losses, "encoder": full, "head": head}, out / f"{tag}{case}.pt")

    def loop(name, waves, labels, enc=None, head=None, state=None):
        enc = enc if enc is not None else encoder()
        place, run_steps, optimizer = train_step.make_sharded_train_loop(enc, mesh, optimizers[name]())
        placed_head, waves, labels = place(fixture["head"] if head is None else head, waves, labels)
        if state is None:
            state = optimizer.init(train_step.train_parameters(enc, placed_head))
        state = train_step.place_optimizer_state(mesh, state)
        placed_head, state, losses = run_steps(placed_head, state, waves, labels)
        return enc, placed_head, state, losses

    def sgd_step():
        enc = encoder()
        place, step, optimizer = train_step.make_sharded_train_step(enc, mesh, optimizers["sgd"]())
        head, wave, label = place(fixture["head"], fixture["waves"][0], fixture["labels"][0])
        state = optimizer.init(train_step.train_parameters(enc, head))
        head, _, loss = step(head, state, wave, label)
        return enc, head, loss[None]

    for case in sys.argv[3].split(","):
        if case == "sgd":
            enc, head, losses = sgd_step()
        elif case in ("adam", "adafactor"):
            enc, head, _, losses = loop(case, fixture["waves"], fixture["labels"])
        elif case == "checkpoint":
            enc, head, state, losses = loop("adafactor", fixture["waves"][:1], fixture["labels"][:1])
            checkpoint.save_train_state(
                out / "trainstate", encoder_params=enc.state_dict(), head_params=head, opt_state=state,
                step=1, mesh=mesh,
            )
        elif case == "restore":
            enc = encoder()
            params, head, state, step = checkpoint.restore_train_state(out / "trainstate", mesh=mesh)
            assert step == 1
            enc.load_state_dict(params, strict=True)
            enc, head, _, losses = loop(
                "adafactor", fixture["waves"][1:], fixture["labels"][1:], enc=enc, head=head, state=state
            )
        elif case == "fault":  # the row-parallel products' partial sums never added up
            whisper.reduce_from_model_group = lambda x, group: x
            enc, head, losses = sgd_step()
        record(case, losses, enc, head)
    shutdown_distributed()
    """
)


def _fixture() -> dict:
    """``test_torch_train_step.py``'s fixture at batch 4, K = 2, as numpy."""
    config = jax_whisper.WhisperConfig.tiny()
    rng = np.random.default_rng(7)
    head = {
        "w1": (rng.standard_normal((2 * config.d_model, 16)) * 0.02).astype(np.float32),
        "b1": np.zeros(16, np.float32),
        "w2": (rng.standard_normal((16, 8)) * 0.02).astype(np.float32),
        "b2": np.zeros(8, np.float32),
    }
    waves = (rng.standard_normal((STEPS, BATCH, jax_whisper.CHUNK_SAMPLES)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 8, size=(STEPS, BATCH)).astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, jax_whisper.init_whisper_encoder_params(config, seed=0))
    return {"params": params, "head": head, "waves": waves, "labels": labels}


def _port_worlds(fixture: dict, root: Path) -> dict:
    """Runs the port's worlds (dp2×tp2 first: it writes the checkpoint dp2×tp1 restores)."""
    script = root / "worker.py"
    script.write_text(_WORKER)
    fixture_path = root / "fixture.pt"
    torch.save(
        {
            "state": {k: v.contiguous() for k, v in convert.whisper_encoder_state_dict(fixture["params"]).items()},
            "head": {k: torch.from_numpy(v) for k, v in fixture["head"].items()},
            "waves": torch.from_numpy(fixture["waves"]),
            "labels": torch.from_numpy(fixture["labels"]),
        },
        fixture_path,
    )
    out = root / "out"
    out.mkdir()

    def world(dp: int, tp: int) -> None:
        env = {"SER_MESH_DATA_AXIS_SIZE": str(dp), "SER_MESH_MODEL_AXIS_SIZE": str(tp)}
        tag = "" if (dp, tp) == (2, 2) else f"dp{dp}tp{tp}-"
        run_world(script, [str(fixture_path), str(out), ",".join(WORLDS[dp, tp]), tag], dp * tp, env)

    world(2, 2)
    errors: list[str] = []
    pair = [threading.Thread(target=_capture, args=(world, key, errors)) for key in ((2, 1), (1, 2))]
    for thread in pair:
        thread.start()
    for thread in pair:
        thread.join()
    if errors:
        raise AssertionError("\n".join(errors))
    return {path.stem: torch.load(path, weights_only=True) for path in out.glob("*.pt")}


def _capture(fn, key, sink: list[str]) -> None:
    try:
        fn(*key)
    except Exception as err:  # noqa: BLE001 - reported by the caller
        sink.append(f"{key}: {err}")


def _jax_reference(fixture: dict, dp: int, tp: int, name: str) -> dict:
    make = {"sgd": optax.sgd, "adam": optax.adam}.get(name)
    optimizer = make(1e-3) if make else optax.adafactor(1e-3, min_dim_size_to_factor=32)
    mesh = build_mesh(MeshConfig(data_axis_size=dp, model_axis_size=tp), devices=jax.devices()[: dp * tp])
    encoder = jax_whisper.WhisperEncoder(jax_whisper.WhisperConfig.tiny())
    waves, labels = jnp.asarray(fixture["waves"]), jnp.asarray(fixture["labels"])
    with mesh:
        if name == "sgd":
            place, step, optimizer = jax_train.make_sharded_train_step(encoder, mesh, optimizer)
            params, head, wave, label = place(fixture["params"], fixture["head"], waves[0], labels[0])
            state = jax_train.place_optimizer_state(mesh, optimizer.init((params, head)))
            params, head, _, loss = step(params, head, state, wave, label)
            losses = np.asarray(loss)[None]
        else:
            place, run_steps, optimizer = jax_train.make_sharded_train_loop(encoder, mesh, optimizer)
            params, head, waves, labels = place(fixture["params"], fixture["head"], waves, labels)
            state = jax_train.place_optimizer_state(mesh, optimizer.init((params, head)))
            params, head, _, losses = run_steps(params, head, state, waves, labels)
            losses = np.asarray(losses)
    return {
        "losses": losses,
        "params": jax.tree_util.tree_map(np.asarray, params),
        "head": jax.tree_util.tree_map(np.asarray, head),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> tuple[dict, dict]:
    """(port results by case, ``ser_tpu`` references by (dp, tp, optimizer)); the port's worlds run
    in the background while ``ser_tpu`` compiles its steps."""
    fixture = _fixture()
    root = tmp_path_factory.mktemp("sharded_train")
    port: dict = {}
    errors: list[str] = []
    background = threading.Thread(target=_capture, args=(lambda: port.update(_port_worlds(fixture, root)), (), errors))
    background.start()
    try:
        references = {key: _jax_reference(fixture, *key) for key in REFERENCES}
    finally:
        background.join()
    assert not errors, errors
    return port, references


def _param_mismatches(ours: dict, ref: dict, atol: float) -> list[str]:
    """Every encoder and head tensor of ``ours`` (the port's names) outside the limits against ``ref`` (flax's)."""
    encoder = convert.flax_whisper_encoder_params(ours["encoder"])
    head = convert.flax_head_params(ours["head"])
    bad = []
    for tree, reference in ((encoder, ref["params"]), (head, ref["head"])):
        ours_leaves = jax.tree_util.tree_leaves_with_path(tree)
        ref_leaves = jax.tree_util.tree_leaves_with_path(reference)
        assert [p for p, _ in ours_leaves] == [p for p, _ in ref_leaves]
        for (path, a), (_, b) in zip(ours_leaves, ref_leaves):
            if not np.allclose(np.asarray(a), b, rtol=PARAM_RTOL, atol=atol):
                bad.append(jax.tree_util.keystr(path))
    return bad


@pytest.mark.parametrize(
    "case, key",
    [
        ("sgd", (2, 2, "sgd")),
        ("adam", (2, 2, "adam")),
        ("adafactor", (2, 2, "adafactor")),
        ("dp2tp1-adam", (2, 1, "adam")),
        ("dp1tp2-adafactor", (1, 2, "adafactor")),
    ],
)
def test_sharded_step_matches_jax_at_the_same_mesh(runs, case, key) -> None:
    port, references = runs
    ours, ref = port[case], references[key]
    np.testing.assert_allclose(ours["losses"].numpy(), ref["losses"], rtol=LOSS_RTOL)
    assert _param_mismatches(ours, ref, PARAM_ATOL[key[2]]) == []


def test_checkpoint_moves_from_tp2_to_tp1_on_the_same_trajectory(runs) -> None:
    port, references = runs
    ref = references[2, 2, "adafactor"]
    ours = port["dp2tp1-restore"]
    np.testing.assert_allclose(ours["losses"].numpy(), ref["losses"][1:], rtol=LOSS_RTOL)
    assert _param_mismatches(ours, ref, PARAM_ATOL["adafactor"]) == []


def test_skipping_the_row_parallel_reduce_is_caught(runs) -> None:
    port, references = runs
    ref = references[2, 2, "sgd"]
    faulty = port["fault"]
    loss_off = not np.allclose(faulty["losses"].numpy(), ref["losses"], rtol=LOSS_RTOL)
    assert loss_off or _param_mismatches(faulty, ref, PARAM_ATOL["sgd"])


def test_buckets_keep_order_dtype_and_size() -> None:
    tensors = [torch.zeros(10), torch.zeros(20), torch.zeros(5, dtype=torch.float64), torch.zeros(40), torch.zeros(3)]
    buckets = train_step._buckets(tensors, limit=30 * 4)
    assert [[t.numel() for t in bucket] for bucket in buckets] == [[10, 20], [5], [40], [3]]
    assert [t for bucket in buckets for t in bucket] == tensors


def test_a_one_by_one_mesh_trains_as_one_device(monkeypatch) -> None:
    """The mesh path in one process (``build_mesh`` forms a group of one, gloo): the one-device
    loop's losses and parameters bit for bit, through the data-axis all-reduce."""
    fixture = _fixture()
    monkeypatch.setenv("SER_TORCH_DEVICE", "cpu")
    state = convert.whisper_encoder_state_dict(fixture["params"])
    waves, labels = torch.from_numpy(fixture["waves"][:, :2]), torch.from_numpy(fixture["labels"][:, :2])
    calls = []
    original = dist.all_reduce

    def counting(tensor, *args, **kwargs):
        calls.append(tensor.numel())
        return original(tensor, *args, **kwargs)

    monkeypatch.setattr(dist, "all_reduce", counting)
    results = []
    try:
        for target in (torch.device("cpu"), mesh_module.build_mesh()):
            encoder = torch_whisper.build_trainable_whisper_encoder(
                torch_whisper.WhisperConfig.tiny(), {k: v.clone() for k, v in state.items()},
                device=torch.device("cpu"), compute_dtype=torch.float32, remat=False,
                mesh=None if isinstance(target, torch.device) else target,
            )
            place, run_steps, optimizer = train_step.make_sharded_train_loop(encoder, target, optim.adafactor(1e-3))
            head, w, lab = place(convert.train_head_params(fixture["head"]), waves, labels)
            opt_state = train_step.place_optimizer_state(target, optimizer.init(train_step.train_parameters(encoder, head)))
            head, _, losses = run_steps(head, opt_state, w, lab)
            results.append((losses, train_step.train_parameters(encoder, head)))
    finally:
        distributed.shutdown_distributed()
    (device_losses, device_params), (mesh_losses, mesh_params) = results
    assert torch.equal(device_losses, mesh_losses)
    assert all(torch.equal(device_params[name], mesh_params[name]) for name in device_params)
    n_params = sum(p.numel() for p in device_params.values())
    assert sum(calls) == STEPS * (n_params + 1) and len(calls) == STEPS  # one bucket a step at tiny widths
