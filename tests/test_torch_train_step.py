"""The port's training step against ``ser_tpu.parallel.train_step``, on the CPU.

The fixture is the JAX package's own (``tests/suites/integration/parallel/
test_train_loop.py``: tiny Whisper, seed 7); the encoder's parameters are
JAX's ``init_whisper_encoder_params(seed=0)``, carried across with
``convert.py``, and JAX runs on a 1×1 mesh of one CPU device. Both sides
compute in float32. Tolerances:

- loss, masked and unmasked pool: rtol 1e-5 (float32 sums in another order);
- every gradient leaf: rtol 1e-4, atol 1e-6. JAX differentiates its GELU's
  Chebyshev polynomial, the port the exact erf GELU; their derivatives differ
  by about 1e-6, the atol;
- two optimizer steps through ``make_sharded_train_loop``: losses rtol 1e-5,
  final parameters atol 1e-7 (sgd), 1e-6 (adafactor), 2e-5 (adam); measured
  3.7e-9, 3.0e-8 and 4.2e-6. Adam's first steps move a parameter by about
  lr·g/(|g| + eps), lr = 1e-3, so a gradient element near eps = 1e-8 whose
  last digits differ between the two sides moves its update by a visible
  share of 1e-3;
- the loop against sequential steps: exactly equal (the same code runs);
- remat ``"full"`` and ``"dots"`` against no remat: loss 1e-6, gradients
  1e-5 (the JAX package's own remat tolerances).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ser_tpu._internal.config.schema import MeshConfig
from ser_tpu.models import whisper as jax_whisper
from ser_tpu.parallel import train_step as jax_train
from ser_tpu.parallel.mesh import build_mesh
from ser_tpu_torch.models import convert
from ser_tpu_torch.models import whisper as torch_whisper
from ser_tpu_torch.parallel import optim
from ser_tpu_torch.parallel import train_step as torch_train

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_ATOL = {"sgd": 1e-7, "adam": 2e-5, "adafactor": 1e-6}
REMAT_LOSS_ATOL, REMAT_GRAD_ATOL = 1e-6, 1e-5
CPU = torch.device("cpu")


def _fixture(batch, steps=1):
    """``test_train_loop.py``'s fixture, as numpy: (config, head, waves, labels)."""
    config = jax_whisper.WhisperConfig.tiny()
    rng = np.random.default_rng(7)
    head = {
        "w1": (rng.standard_normal((2 * config.d_model, 16)) * 0.02).astype(np.float32),
        "b1": np.zeros(16, np.float32),
        "w2": (rng.standard_normal((16, 8)) * 0.02).astype(np.float32),
        "b2": np.zeros(8, np.float32),
    }
    shape = (steps, batch, jax_whisper.CHUNK_SAMPLES) if steps else (batch, jax_whisper.CHUNK_SAMPLES)
    waves = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    labels = rng.integers(0, 8, size=shape[:-1]).astype(np.int32)
    return config, head, waves, labels


@pytest.fixture(scope="module")
def jax_params() -> dict:
    params = jax_whisper.init_whisper_encoder_params(jax_whisper.WhisperConfig.tiny(), seed=0)
    return jax.tree_util.tree_map(np.asarray, params)


def _torch_encoder(params, *, remat=False, remat_policy="full") -> torch_whisper.WhisperEncoder:
    return torch_whisper.build_trainable_whisper_encoder(
        torch_whisper.WhisperConfig.tiny(),
        convert.whisper_encoder_state_dict(params),
        device=CPU,
        compute_dtype=torch.float32,
        remat=remat,
        remat_policy=remat_policy,
    )


def _torch_head(head) -> dict[str, torch.Tensor]:
    return {name: tensor.requires_grad_() for name, tensor in convert.train_head_params(head).items()}


def _one_device_mesh():
    return build_mesh(MeshConfig(model_axis_size=1), devices=jax.devices()[:1])


def _valid_samples(batch, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(jax_whisper.CHUNK_SAMPLES // 2, jax_whisper.CHUNK_SAMPLES, size=batch).astype(np.int32)


def _torch_loss_and_grads(encoder, head, waves, labels, valid=None):
    params = torch_train.train_parameters(encoder, head)
    loss = torch_train.encoder_classifier_loss(
        encoder, head, torch.from_numpy(waves), torch.from_numpy(labels),
        None if valid is None else torch.from_numpy(valid),
    )
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return loss.item(), grads


def _flax_grads(grads: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    encoder = {name.removeprefix("encoder."): g for name, g in grads.items() if name.startswith("encoder.")}
    head = {name.removeprefix("head."): g for name, g in grads.items() if name.startswith("head.")}
    return convert.flax_whisper_encoder_params(encoder), convert.flax_head_params(head)


def _assert_trees_close(ours, ref, **tolerances) -> None:
    ours_leaves = jax.tree_util.tree_leaves_with_path(ours)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert [path for path, _ in ours_leaves] == [path for path, _ in ref_leaves]
    for (path, a), (_, b) in zip(ours_leaves, ref_leaves):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=jax.tree_util.keystr(path), **tolerances)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_loss_matches_jax(jax_params, masked) -> None:
    config, head, waves, labels = _fixture(batch=2, steps=0)
    valid = _valid_samples(2) if masked else None
    ref = jax_train.encoder_classifier_loss(
        jax_whisper.WhisperEncoder(config), jax_params, head, jnp.asarray(waves), jnp.asarray(labels),
        None if valid is None else jnp.asarray(valid),
    )
    ours, _ = _torch_loss_and_grads(_torch_encoder(jax_params), _torch_head(head), waves, labels, valid)
    np.testing.assert_allclose(ours, float(ref), rtol=LOSS_RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_every_gradient_leaf_matches_jax_grad(jax_params, masked) -> None:
    config, head, waves, labels = _fixture(batch=2, steps=0)
    valid = _valid_samples(2) if masked else None
    encoder = jax_whisper.WhisperEncoder(config)
    ref_encoder, ref_head = jax.grad(
        lambda p, h: jax_train.encoder_classifier_loss(
            encoder, p, h, jnp.asarray(waves), jnp.asarray(labels), None if valid is None else jnp.asarray(valid)
        ),
        argnums=(0, 1),
    )(jax_params, head)
    _, grads = _torch_loss_and_grads(_torch_encoder(jax_params), _torch_head(head), waves, labels, valid)
    ours_encoder, ours_head = _flax_grads(grads)
    _assert_trees_close(ours_encoder, ref_encoder, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _assert_trees_close(ours_head, ref_head, rtol=GRAD_RTOL, atol=GRAD_ATOL)


_OPTIMIZERS = {
    "sgd": (optim.sgd, optax.sgd),
    "adam": (optim.adam, optax.adam),
    "adafactor": (optim.adafactor, optax.adafactor),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_two_loop_steps_match_jax(jax_params, name) -> None:
    ours_opt, theirs_opt = (make(1e-3) for make in _OPTIMIZERS[name])
    config, head, waves, labels = _fixture(batch=2, steps=2)

    mesh = _one_device_mesh()
    place, run_steps, optimizer = jax_train.make_sharded_train_loop(
        jax_whisper.WhisperEncoder(config), mesh, optimizer=theirs_opt
    )
    with mesh:
        params, j_head, j_waves, j_labels = place(jax_params, head, jnp.asarray(waves), jnp.asarray(labels))
        state = jax_train.place_optimizer_state(mesh, optimizer.init((params, j_head)))
        params, j_head, _, ref_losses = run_steps(params, j_head, state, j_waves, j_labels)
        ref_losses = np.asarray(ref_losses)

    encoder = _torch_encoder(jax_params)
    place, run_steps, optimizer = torch_train.make_sharded_train_loop(encoder, CPU, ours_opt)
    t_head, t_waves, t_labels = place(convert.train_head_params(head), torch.from_numpy(waves),
                                      torch.from_numpy(labels))
    state = torch_train.place_optimizer_state(CPU, optimizer.init(torch_train.train_parameters(encoder, t_head)))
    t_head, state, losses = run_steps(t_head, state, t_waves, t_labels)

    assert losses.shape == (2,) and state["count"] == 2
    np.testing.assert_allclose(losses.numpy(), ref_losses, rtol=LOSS_RTOL)
    _assert_trees_close(convert.flax_whisper_encoder_params(encoder.state_dict()), params, rtol=0,
                        atol=PARAM_ATOL[name])
    _assert_trees_close(convert.flax_head_params(t_head), j_head, rtol=0, atol=PARAM_ATOL[name])


def test_loop_equals_sequential_steps(jax_params) -> None:
    _, head, waves, labels = _fixture(batch=2, steps=2)
    valid = np.stack([_valid_samples(2, seed) for seed in (3, 4)])

    encoder = _torch_encoder(jax_params)
    place, run_steps, optimizer = torch_train.make_sharded_train_loop(encoder, CPU, optim.adam(1e-3))
    loop_head, loop_waves, loop_labels = place(convert.train_head_params(head), torch.from_numpy(waves),
                                               torch.from_numpy(labels))
    state = optimizer.init(torch_train.train_parameters(encoder, loop_head))
    loop_head, _, losses = run_steps(loop_head, state, loop_waves, loop_labels, torch.from_numpy(valid))

    step_encoder = _torch_encoder(jax_params)
    place, step, optimizer = torch_train.make_sharded_train_step(step_encoder, CPU, optim.adam(1e-3))
    step_head, _, _ = place(convert.train_head_params(head), torch.from_numpy(waves[0]), torch.from_numpy(labels[0]))
    state = optimizer.init(torch_train.train_parameters(step_encoder, step_head))
    step_losses = []
    for i in range(2):
        step_head, state, loss = step(step_head, state, torch.from_numpy(waves[i]), torch.from_numpy(labels[i]),
                                      torch.from_numpy(valid[i]))
        step_losses.append(loss)
    assert torch.equal(losses, torch.stack(step_losses))
    for name, tensor in step_encoder.state_dict().items():
        assert torch.equal(encoder.state_dict()[name], tensor), name
    assert all(torch.equal(loop_head[name], step_head[name]) for name in head)


def test_default_optimizer_is_adam_and_valid_samples_default_to_full(jax_params) -> None:
    """No ``valid_samples``: the loop pools over every frame through the masked branch."""
    _, head, waves, labels = _fixture(batch=2, steps=1)
    encoder = _torch_encoder(jax_params)
    place, run_steps, optimizer = torch_train.make_sharded_train_loop(encoder, CPU)
    assert optimizer.name == "adam"
    t_head, t_waves, t_labels = place(convert.train_head_params(head), torch.from_numpy(waves),
                                      torch.from_numpy(labels))
    unmasked, _ = _torch_loss_and_grads(_torch_encoder(jax_params), _torch_head(head), waves[0], labels[0])
    _, _, losses = run_steps(t_head, optimizer.init(torch_train.train_parameters(encoder, t_head)), t_waves,
                             t_labels)
    np.testing.assert_allclose(losses.numpy(), [unmasked], rtol=LOSS_RTOL)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_leaves_loss_and_gradients_unchanged(jax_params, policy) -> None:
    _, head, waves, labels = _fixture(batch=2, steps=0)
    plain_loss, plain_grads = _torch_loss_and_grads(_torch_encoder(jax_params), _torch_head(head), waves, labels)
    remat_loss, remat_grads = _torch_loss_and_grads(
        _torch_encoder(jax_params, remat=True, remat_policy=policy), _torch_head(head), waves, labels
    )
    assert remat_loss == pytest.approx(plain_loss, abs=REMAT_LOSS_ATOL)
    for name, grad in plain_grads.items():
        np.testing.assert_allclose(remat_grads[name].numpy(), grad.numpy(), atol=REMAT_GRAD_ATOL, err_msg=name)


class _CountOps(TorchDispatchMode):
    """Counts aten ops by name, and records the dtypes of the projection products' operands."""

    def __init__(self) -> None:
        super().__init__()
        self.counts: dict[str, int] = {}
        self.product_dtypes: set[torch.dtype] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        if name in ("mm", "addmm"):
            self.product_dtypes.update(a.dtype for a in args if isinstance(a, torch.Tensor))
        return func(*args, **(kwargs or {}))


def _backward_op_counts(encoder, head, waves, labels) -> dict[str, int]:
    params = torch_train.train_parameters(encoder, head)
    loss = torch_train.encoder_classifier_loss(encoder, head, torch.from_numpy(waves), torch.from_numpy(labels))
    with _CountOps() as counter:
        torch.autograd.grad(loss, list(params.values()))
    return counter.counts


def test_dots_policy_keeps_the_projections_and_recomputes_attention(jax_params) -> None:
    """In the backward, "full" reruns each block's projection products and "dots" does not.

    Attention (batched products on the CPU, kernel K2 on the card) is
    recomputed under both, as under ``dots_with_no_batch_dims_saveable``.
    """
    _, head, waves, labels = _fixture(batch=1, steps=0)
    counts = {
        name: _backward_op_counts(_torch_encoder(jax_params, remat=remat, remat_policy=policy),
                                  _torch_head(head), waves[:1], labels[:1])
        for name, remat, policy in (("none", False, "full"), ("full", True, "full"), ("dots", True, "dots"))
    }
    layers = torch_whisper.WhisperConfig.tiny().encoder_layers

    def products(policy):
        return counts[policy].get("mm", 0) + counts[policy].get("addmm", 0)

    # "full" reruns the projections (at least q, k, v, out and mlp_in per block:
    # the recompute stops early once it has every tensor the backward reads,
    # before mlp_out); "dots" reruns none of them.
    assert products("full") - products("none") >= 5 * layers
    assert products("dots") == products("none")
    # Both rerun the attention's two batched products, its softmax and the GELU per block.
    for policy in ("full", "dots"):
        assert counts[policy].get("bmm", 0) - counts["none"].get("bmm", 0) == 2 * layers
        assert counts[policy].get("_softmax", 0) - counts["none"].get("_softmax", 0) == layers
        assert counts[policy].get("gelu", 0) - counts["none"].get("gelu", 0) == layers


def test_trainable_encoder_keeps_float32_masters_and_computes_in_bf16(jax_params) -> None:
    """bf16 compute on float32 masters: the products run in bf16, gradients reach the masters in float32."""
    config, head, waves, labels = _fixture(batch=1, steps=0)
    encoder = torch_whisper.build_trainable_whisper_encoder(
        torch_whisper.WhisperConfig.tiny(), convert.whisper_encoder_state_dict(jax_params), device=CPU,
        compute_dtype=torch.bfloat16, remat=True, remat_policy="dots",
    )
    assert encoder.training and {p.dtype for p in encoder.parameters()} == {torch.float32}
    mel = torch_whisper.log_mel_spectrogram(torch.from_numpy(waves), config.n_mels)
    with _CountOps() as counter:
        states = encoder(mel)
    assert states.dtype == torch.float32  # flax's final_ln promotes bf16 input with float32 parameters
    assert counter.counts.get("mm", 0) + counter.counts.get("addmm", 0) == 6 * config.encoder_layers
    assert counter.product_dtypes == {torch.bfloat16}
    ref = np.asarray(
        jax_whisper.WhisperEncoder(config, compute_dtype=jnp.bfloat16).apply(
            {"params": jax_params}, jnp.asarray(mel.numpy())
        )
    )
    rel = np.linalg.norm(states.detach().numpy() - ref) / np.linalg.norm(ref)
    assert rel < 2e-2  # bf16 activations on both sides, rounded in places that differ
    loss = torch_train.encoder_classifier_loss(encoder, _torch_head(head), torch.from_numpy(waves),
                                               torch.from_numpy(labels))
    loss.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in encoder.parameters())


def test_larger_mesh_raises_and_device_defaults_to_the_card(jax_params, monkeypatch) -> None:
    encoder = _torch_encoder(jax_params)
    for kwargs in ({"data_axis_size": 2}, {"model_axis_size": 4}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            torch_train.make_sharded_train_loop(encoder, CPU, **kwargs)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            torch_train.make_sharded_train_step(encoder, CPU, **kwargs)
    monkeypatch.setenv("SER_TORCH_DEVICE", "cpu")
    place, _, _ = torch_train.make_sharded_train_step(encoder)
    head, waves, _ = place(_fixture(1, 0)[1], torch.zeros(1, 8), torch.zeros(1, dtype=torch.int32))
    assert waves.device.type == "cpu" and all(t.requires_grad for t in head.values())
    if not torch.cuda.is_available():
        monkeypatch.delenv("SER_TORCH_DEVICE")
        with pytest.raises(Exception, match="SER_TORCH_DEVICE=cpu"):
            torch_train.make_sharded_train_step(encoder)


def test_convert_round_trips_encoder_and_head(jax_params) -> None:
    state = convert.whisper_encoder_state_dict(jax_params)
    _assert_trees_close(convert.flax_whisper_encoder_params(state), jax_params, rtol=0, atol=0)
    head = _fixture(1, 0)[1]
    _assert_trees_close(convert.flax_head_params(convert.train_head_params(head)), head, rtol=0, atol=0)
