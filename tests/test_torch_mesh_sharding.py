"""The port's mesh and sharding rules against ``ser_tpu.parallel.{mesh,sharding}``, on the CPU.

- ``mesh_shape_for`` over a grid of (devices, data, model): the same shapes
  and the same ``ValueError``s;
- every parameter of ``WhisperConfig.tiny()``'s encoder: the port's
  placement against the JAX package's ``encoder_param_sharding`` spec, with
  the transpose (an ``nn.Linear`` weight is a flax kernel transposed, so
  ``Shard(0)`` is ``P(None, "model")`` and ``Shard(1)`` is ``P("model")``);
  the batch placements likewise;
- ``MeshConfig`` from ``SER_MESH_*`` against the JAX package's settings;
- a 1×1 mesh needs no setup (``build_mesh`` forms a world-size-1 group), and
  at model axis 1 the encoder and a CPU-asked medium encode issue no
  collective (``shard_chunk_batch`` passes its batch through).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor.placement_types import Replicate, Shard

from ser_tpu._internal.config.schema import MeshConfig as JaxMeshConfig
from ser_tpu._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu._internal.config.settings_inputs import capture_settings_inputs
from ser_tpu.models import whisper as jax_whisper
from ser_tpu.parallel import mesh as jax_mesh
from ser_tpu.parallel import sharding as jax_sharding
from ser_tpu_torch._internal.config.bootstrap import build_settings
from ser_tpu_torch._internal.config.schema import MeshConfig
from ser_tpu_torch._internal.repr import encoder_backend
from ser_tpu_torch._internal.repr.wav2vec2_backend import XlsrBackend
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import whisper
from ser_tpu_torch.parallel import distributed, mesh, sharding
from ser_tpu_torch.parallel import train_step

_GRID = [(n, d, m) for n in (1, 2, 3, 4, 6, 8) for d in (0, 1, 2, 3, 4) for m in (0, 1, 2, 4)]


@pytest.mark.parametrize("n, data, model", _GRID, ids=[f"n{n}-d{d}-m{m}" for n, d, m in _GRID])
def test_mesh_shape_for_matches_jax(n, data, model) -> None:
    try:
        theirs = jax_mesh.mesh_shape_for(n, JaxMeshConfig(data_axis_size=data, model_axis_size=model))
    except ValueError as err:
        with pytest.raises(ValueError) as ours:
            mesh.mesh_shape_for(n, MeshConfig(data_axis_size=data, model_axis_size=model))
        assert str(ours.value) == str(err)
        return
    assert mesh.mesh_shape_for(n, MeshConfig(data_axis_size=data, model_axis_size=model)) == theirs


def _flax_spec(placement, ndim: int, linear: bool) -> tuple:
    """A port placement as the flax spec of the same tensor, trailing Nones dropped."""
    spec = [None] * ndim
    for axis, part in zip(("data", "model"), placement):
        if isinstance(part, Shard):
            dim = ndim - 1 - part.dim if linear else part.dim
            spec[dim] = axis
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _normalized(spec: P) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_every_encoder_parameter_is_placed_as_jax_places_it() -> None:
    config = jax_whisper.WhisperConfig.tiny()
    params = jax.tree_util.tree_map(np.asarray, jax_whisper.init_whisper_encoder_params(config, seed=0))
    jax_specs = jax_sharding.encoder_param_sharding(
        jax_mesh.build_mesh(JaxMeshConfig(2, 2), devices=jax.devices()[:4]), params
    )
    # Each port tensor filled with its own index, carried across, names where it lands in the flax tree.
    state = convert.whisper_encoder_state_dict(params)
    names = sorted(state)
    tagged = {name: torch.full(tuple(state[name].shape), float(i)) for i, name in enumerate(names)}
    flax_tree = convert.flax_whisper_encoder_params(tagged)
    placements = sharding.encoder_param_sharding(None, state)
    seen = set()
    for (path, leaf), (_, named_sharding) in zip(
        jax.tree_util.tree_leaves_with_path(flax_tree), jax.tree_util.tree_leaves_with_path(jax_specs)
    ):
        name = names[int(np.asarray(leaf).flat[0])]
        seen.add(name)
        linear = state[name].ndim == 2
        ours = _flax_spec(placements[name], state[name].ndim, linear)
        assert ours == _normalized(named_sharding.spec), (name, jax.tree_util.keystr(path))
    assert seen == set(names)
    sharded = {name for name, placement in placements.items() if placement != (Replicate(), Replicate())}
    assert sharded == {
        f"layers.{i}.{part}.weight"
        for i in range(config.encoder_layers)
        for part in ("attn.q", "attn.k", "attn.v", "attn.out", "mlp_in", "mlp_out")
    }


def test_batch_and_replicated_placements_match_jax() -> None:
    jmesh = jax_mesh.build_mesh(JaxMeshConfig(2, 2), devices=jax.devices()[:4])
    cases = [
        (sharding.replicated(None), jax_sharding.replicated(jmesh), 2),
        (sharding.batch_sharding(None, 2), jax_sharding.batch_sharding(jmesh, 2), 2),
        (sharding.batch_sharding(None, 1), jax_sharding.batch_sharding(jmesh, 1), 1),
        (sharding.stacked_batch_sharding(None, 3), jax_sharding.stacked_batch_sharding(jmesh, 3), 3),
    ]
    for ours, theirs, ndim in cases:
        assert _flax_spec(ours, ndim, linear=False) == _normalized(theirs.spec)


def test_local_shard_cuts_equal_pieces_and_refuses_uneven_ones() -> None:
    full = torch.arange(24.0).reshape(4, 6)
    pieces = [sharding.LocalShard(1, 3, i, None).cut(full) for i in range(3)]
    assert torch.equal(torch.cat(pieces, dim=1), full)
    assert sharding.LocalShard(1, 3, 0, None).global_shape((4, 2)) == (4, 6)
    with pytest.raises(ValueError, match="equal shards"):
        sharding.LocalShard(0, 3, 0, None).cut(full)
    assert sharding.model_dim("encoder.layers.3.attn.out.weight", 2) == 1
    assert sharding.model_dim("layers.0.mlp_in.weight", 2) == 0
    assert sharding.model_dim("layers.0.mlp_in.bias", 1) is None
    assert sharding.model_dim("head.w1", 2) is None


_MESH_ENVS = [
    {},
    {"SER_MESH_DATA_AXIS_SIZE": "2", "SER_MESH_MODEL_AXIS_SIZE": "4"},
    {"SER_MESH_MODEL_AXIS_SIZE": "2"},
    {"SER_MESH_DATA_AXIS_SIZE": " 3 "},
    {"SER_MESH_DATA_AXIS_SIZE": "two"},
]


@pytest.mark.parametrize("env", _MESH_ENVS, ids=range(len(_MESH_ENVS)))
def test_mesh_config_from_env_matches_jax_settings(env) -> None:
    try:
        theirs = build_settings_from_inputs(capture_settings_inputs(env)).mesh
    except ValueError:
        with pytest.raises(ValueError, match="SER_MESH_DATA_AXIS_SIZE"):
            build_settings(env)
        return
    ours = build_settings(env).mesh
    assert (ours.data_axis_size, ours.model_axis_size, ours.axis_names) == (
        theirs.data_axis_size,
        theirs.model_axis_size,
        theirs.axis_names,
    )


@pytest.fixture
def no_collectives(monkeypatch):
    """A world-size-1 gloo group from ``build_mesh`` (destroyed afterwards), every collective made to raise."""
    monkeypatch.setenv("SER_TORCH_DEVICE", "cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="does not match device count 1"):
        mesh.build_mesh(MeshConfig(data_axis_size=2, model_axis_size=1))
    one = mesh.build_mesh()
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert one.mesh_dim_names == ("data", "model") and tuple(one.mesh.shape) == (1, 1)

    def refuse(*args, **kwargs):
        raise AssertionError("a collective was issued")

    for name in ("all_reduce", "all_gather", "broadcast", "all_gather_object", "reduce_scatter"):
        monkeypatch.setattr(dist, name, refuse)
    yield one
    monkeypatch.undo()
    distributed.shutdown_distributed()


def test_model_axis_one_issues_no_collective_in_the_encoder(no_collectives) -> None:
    config = whisper.WhisperConfig.tiny()
    state = whisper.random_whisper_encoder_state(config, seed=0, device="cpu")
    encoder = whisper.build_trainable_whisper_encoder(
        config, state, device=torch.device("cpu"), compute_dtype=torch.float32, mesh=no_collectives
    )
    assert all(layer.model_group is None for layer in encoder.layers)
    waves = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal((1, whisper.CHUNK_SAMPLES))).astype(np.float32))
    head = {"w1": torch.zeros(2 * config.d_model, 4, requires_grad=True), "b1": torch.zeros(4, requires_grad=True),
            "w2": torch.zeros(4, 8, requires_grad=True), "b2": torch.zeros(8, requires_grad=True)}
    loss = train_step.encoder_classifier_loss(encoder, head, waves, torch.tensor([3]))
    loss.backward()
    assert torch.isfinite(loss)


def test_cpu_asked_medium_encode_never_touches_a_group(no_collectives, monkeypatch) -> None:
    batch, lengths = np.zeros((3, 160), np.float32), np.full(3, 160, np.int32)
    out, out_lengths, rows = encoder_backend.shard_chunk_batch(batch, lengths)
    assert out is batch and out_lengths is lengths and rows == 3
    monkeypatch.setenv("SER_ALLOW_RANDOM_INIT", "1")
    monkeypatch.setenv("SER_RANDOM_INIT_SIZE", "tiny")
    backend = XlsrBackend(model_id="facebook/wav2vec2-xls-r-300m", cache_root="/nonexistent", device="cpu")
    audio = (0.1 * np.random.default_rng(1).standard_normal(35 * 16000)).astype(np.float32)
    encoded = backend.encode_sequence(audio, 16000)
    assert np.isfinite(encoded.embeddings).all() and encoded.frame_end_seconds[-1] == pytest.approx(35.0)
