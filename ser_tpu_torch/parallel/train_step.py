"""End-to-end training step: encoder + classifier head, on a (data, model) mesh.

Counterpart of ``ser_tpu/parallel/train_step.py``. One step computes the
log-mel (kernel K1; the waveform is data and takes no gradient) → encoder
forward (float32 master weights, compute in the encoder's ``compute_dtype``,
kernel K2 in every layer on the card, optional per-block remat) → masked
mean/std pool → ReLU MLP head → cross-entropy → backward (K2-bwd in every
layer on the card) → optimizer update. ``make_sharded_train_loop`` runs K
such steps over a (K, B, S) super-batch in one call, as the JAX package's
``lax.scan`` does, here as a Python loop.

On a mesh (``parallel.mesh.build_mesh``, one process per rank) each rank
takes its data-axis slice of the global batch (dim 0 of (B, S), dim 1 of
(K, B, S); the data axis must divide B), computes its loss and gradients,
and all-reduces every gradient and the loss over the data axis (their mean:
the global batch's mean loss and its gradient, as the JAX package's GSPMD
step computes them). The encoder's blocks run tensor-parallel over the model
axis when it has more than one rank (``build_trainable_whisper_encoder(...,
mesh=mesh)``), each rank holding its shards as plain parameters; the
optimizer reads the shards' layout (``sharding.shard_layout``). GSPMD
inserts these collectives for the JAX package; here they are issued by hand,
the data axis's here and the model axis's in the encoder and the optimizer.
A torch device in place of the mesh is the one-device run without a process
group.

The head is a dict of float32 tensors in flax's layout, ``w1`` (2d, H),
``b1`` (H,), ``w2`` (H, C), ``b2`` (C,), as in the JAX step. The encoder's
parameters live in the module; the optimizer sees both under the names of
:func:`train_parameters`.
"""

from __future__ import annotations

import os
from collections.abc import Callable, Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch.models.whisper import WhisperEncoder, log_mel_spectrogram
from ser_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size
from ser_tpu_torch.parallel.optim import Optimizer, adam
from ser_tpu_torch.parallel.sharding import data_group, data_slice, model_group, shard_layout


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    log_probs = torch.log_softmax(logits, dim=-1)
    return -log_probs.gather(1, labels.long()[:, None])[:, 0].mean()


def encoder_classifier_loss(
    encoder: WhisperEncoder,
    head_params: Mapping[str, torch.Tensor],
    waveform_chunks: torch.Tensor,
    labels: torch.Tensor,
    valid_samples: torch.Tensor | None = None,
) -> torch.Tensor:
    """Forward + loss: whisper-encoder states → masked mean/std pool → head.

    ``valid_samples`` (B,) gives each clip's true sample count; frames past it
    are zero-padding and do not enter the pooled statistics. Without it the
    pool is the plain mean and the population std (ddof 0), as
    ``jnp.std`` gives.
    """
    mel = log_mel_spectrogram(waveform_chunks, encoder.config.n_mels)
    states = encoder(mel)
    if valid_samples is not None:
        # Encoder frames cover 2 hops (320 samples at 16 kHz) each.
        samples_per_frame = waveform_chunks.shape[1] / states.shape[1]
        n_valid = torch.clamp(torch.ceil(valid_samples / samples_per_frame).to(torch.int32), min=1)
        frames = torch.arange(states.shape[1], device=states.device)
        frame_ok = (frames[None, :] < n_valid[:, None])[..., None].to(states.dtype)
        count = torch.clamp(frame_ok.sum(dim=1), min=1.0)
        mean = (states * frame_ok).sum(dim=1) / count
        var = (torch.square(states - mean[:, None, :]) * frame_ok).sum(dim=1) / count
        pooled = torch.cat([mean, torch.sqrt(torch.clamp(var, min=0.0))], dim=-1)
    else:
        pooled = torch.cat([states.mean(dim=1), states.std(dim=1, correction=0)], dim=-1)
    hidden = torch.relu(pooled @ head_params["w1"] + head_params["b1"])
    logits = hidden @ head_params["w2"] + head_params["b2"]
    return cross_entropy_loss(logits, labels)


def train_parameters(encoder: WhisperEncoder, head_params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every trained tensor by name: ``encoder.<state_dict name>`` and ``head.<key>``."""
    params = {f"encoder.{name}": param for name, param in encoder.named_parameters()}
    params.update({f"head.{name}": tensor for name, tensor in head_params.items()})
    return params


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank of ``mesh`` computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place_optimizer_state(mesh: DeviceMesh | torch.device | str, opt_state: dict) -> dict:
    """The optimizer state with every tensor on this rank's device.

    The state of ``optimizer.init`` over this rank's parameters already holds
    each tensor as the placement rules say (a sharded parameter's moments as
    its shards; adafactor's factored moments whole), so placing it is moving
    it; ``checkpoint.restore_train_state(mesh=...)`` cuts a full state.
    """
    device = mesh_device(mesh) if isinstance(mesh, DeviceMesh) else torch.device(mesh)

    def place(value):
        if isinstance(value, torch.Tensor):
            return value.to(device)
        if isinstance(value, Mapping):
            return {key: place(item) for key, item in value.items()}
        return value

    return place(opt_state)


#: Bytes of gradients packed into one all-reduce over the data axis: a few collectives a
#: large-v3 step in place of one per tensor (about 490).
BUCKET_BYTES = 256 * 2**20


def _buckets(tensors, limit: int | None = None) -> list[list[torch.Tensor]]:
    """Consecutive runs of tensors of one dtype and device, each run at most ``limit`` bytes
    (default ``BUCKET_BYTES``; a larger tensor alone)."""
    limit = BUCKET_BYTES if limit is None else limit
    runs: list[list[torch.Tensor]] = []
    size = 0
    for tensor in tensors:
        nbytes = tensor.numel() * tensor.element_size()
        last = runs[-1][-1] if runs else None
        if last is None or size + nbytes > limit or (last.dtype, last.device) != (tensor.dtype, tensor.device):
            runs.append([])
            size = 0
        runs[-1].append(tensor)
        size += nbytes
    return runs


def _data_mean(mesh: DeviceMesh, loss: torch.Tensor, grads) -> torch.Tensor:
    """Every gradient (in place) and the loss averaged over the data axis; returns the loss.

    The gradients go in buckets (``BUCKET_BYTES``), each packed into one
    buffer for one all-reduce and copied back. Issued on a data axis of one
    rank too (an identity), so that a 1x1 mesh runs the collective path it
    would run at scale.
    """
    group, parts = data_group(mesh), axis_size(mesh, DATA_AXIS)
    loss = loss.clone()
    for bucket in _buckets([*grads, loss]):
        flat = torch.cat([tensor.reshape(-1) for tensor in bucket])
        dist.all_reduce(flat, group=group)
        if parts > 1:
            flat.div_(parts)
        pieces = flat.split([tensor.numel() for tensor in bucket])
        torch._foreach_copy_(bucket, [piece.view_as(tensor) for piece, tensor in zip(pieces, bucket)])
    return loss


def _train_update(
    encoder: WhisperEncoder,
    optimizer: Optimizer,
    head_params: Mapping[str, torch.Tensor],
    opt_state: dict,
    waveform: torch.Tensor,
    labels: torch.Tensor,
    valid_samples: torch.Tensor | None,
    mesh: DeviceMesh | None = None,
) -> tuple[dict, torch.Tensor]:
    """One optimizer step: loss and gradients → update, in place. Returns (opt_state, loss).

    Shared by ``make_sharded_train_step`` and ``make_sharded_train_loop`` so
    that their trajectories cannot diverge.
    """
    params = train_parameters(encoder, head_params)
    loss = encoder_classifier_loss(encoder, head_params, waveform, labels, valid_samples)
    grads = torch.autograd.grad(loss, list(params.values()))
    loss = loss.detach()
    if mesh is not None:
        loss = _data_mean(mesh, loss, grads)
    opt_state = optimizer.apply(params, dict(zip(params, grads)), opt_state)
    return opt_state, loss


def _bound_to(optimizer: Optimizer, mesh: DeviceMesh | None) -> Optimizer:
    """``optimizer`` reading the layout of this rank's shards, where the model axis cuts any."""
    if model_group(mesh) is None:
        return optimizer
    return Optimizer(
        optimizer.name,
        lambda params, layout=None: optimizer.init(params, layout or shard_layout(mesh, params)),
        lambda params, grads, state, layout=None: optimizer.apply(
            params, grads, state, layout or shard_layout(mesh, params)
        ),
    )


def _resolve(
    encoder: WhisperEncoder,
    target: DeviceMesh | torch.device | str | None,
    data_axis_size: int,
    model_axis_size: int,
) -> tuple[torch.device, DeviceMesh | None]:
    """(device, mesh) of a mesh, or of one device (mesh None: no process group)."""
    if isinstance(target, DeviceMesh):
        parts = axis_size(target, MODEL_AXIS)
        group = encoder.layers[0].model_group if len(encoder.layers) else None
        held = 1 if group is None else dist.get_world_size(group)
        if held != parts:
            raise ValueError(
                f"The encoder is cut for a model axis of {held}, the mesh has {parts}: build it with "
                "build_trainable_whisper_encoder(..., mesh=mesh)."
            )
        return mesh_device(target), target
    if data_axis_size != 1 or model_axis_size != 1:
        raise NotImplementedError(
            f"A (data={data_axis_size}, model={model_axis_size}) layout is not a single device: pass "
            "parallel.mesh.build_mesh()'s mesh in place of the device (see ROADMAP.md)."
        )
    if target is None:
        return resolve_device(os.environ.get("SER_TORCH_DEVICE", "auto")), None
    return torch.device(target), None


def _placer(encoder: WhisperEncoder, device: torch.device, mesh: DeviceMesh | None, batch_dim: int):
    def place(head_params, waveform, labels):
        """The encoder on the device, a float32 copy of the head, and this rank's slice of the batch."""
        if mesh is not None:
            waveform, labels = data_slice(mesh, waveform, batch_dim), data_slice(mesh, labels, batch_dim)
        encoder.to(device)
        return _place_head(head_params, device), waveform.to(device), labels.to(device)

    return place


def _place_head(head_params: Mapping[str, torch.Tensor], device: torch.device) -> dict[str, torch.Tensor]:
    return {
        name: torch.as_tensor(value).detach().to(device=device, dtype=torch.float32).clone().requires_grad_()
        for name, value in head_params.items()
    }


def make_sharded_train_step(
    encoder: WhisperEncoder,
    mesh: DeviceMesh | torch.device | str | None = None,
    optimizer: Optimizer | None = None,
    *,
    data_axis_size: int = 1,
    model_axis_size: int = 1,
) -> tuple[Callable, Callable, Optimizer]:
    """Builds ``(place, step, optimizer)``; the default optimizer is ``adam(1e-4)``.

    ``mesh`` is a ``DeviceMesh`` of ``parallel.mesh.build_mesh``, or one
    device (None reads ``SER_TORCH_DEVICE``: the card unless it says ``cpu``;
    no card raises); the axis-size keywords belong to the one-device form,
    which holds one rank only. ``place(head, waveform, labels)`` moves the
    encoder, a float32 copy of the head and this rank's slice of the global
    batch (B, S) to the device. ``step(head, opt_state, waveform, labels,
    valid_samples=None)`` returns ``(head, opt_state, loss)``, the
    parameters updated in place and the loss the global batch's mean. On a
    model axis above 1 the returned optimizer reads this rank's shard layout
    in ``init`` and ``apply``: initialize the state with it.
    """
    device, mesh = _resolve(encoder, mesh, data_axis_size, model_axis_size)
    optimizer = _bound_to(optimizer if optimizer is not None else adam(1e-4), mesh)

    def step(head_params, opt_state, waveform, labels, valid_samples=None):
        opt_state, loss = _train_update(
            encoder, optimizer, head_params, opt_state, waveform, labels, valid_samples, mesh
        )
        return head_params, opt_state, loss

    return _placer(encoder, device, mesh, 0), step, optimizer


def make_sharded_train_loop(
    encoder: WhisperEncoder,
    mesh: DeviceMesh | torch.device | str | None = None,
    optimizer: Optimizer | None = None,
    *,
    data_axis_size: int = 1,
    model_axis_size: int = 1,
) -> tuple[Callable, Callable, Optimizer]:
    """Builds ``(place, run_steps, optimizer)``: K steps per call.

    ``mesh`` as for :func:`make_sharded_train_step`; ``place`` takes this
    rank's slice of dim 1 of the (K, B, S) super-batch. ``run_steps(head,
    opt_state, waveforms (K, B, S), labels (K, B), valid_samples (K, B) or
    None)`` returns ``(head, opt_state, losses (K,))``. Without
    ``valid_samples`` every sample counts as valid, and the pool is the
    masked one over all frames, as the JAX loop fills it.
    """
    device, mesh = _resolve(encoder, mesh, data_axis_size, model_axis_size)
    optimizer = _bound_to(optimizer if optimizer is not None else adam(1e-4), mesh)

    def run_steps(head_params, opt_state, waveforms, labels, valid_samples=None):
        if valid_samples is None:
            valid_samples = torch.full(labels.shape, waveforms.shape[-1], dtype=torch.int32, device=labels.device)
        losses = []
        for wave, label, valid in zip(waveforms, labels, valid_samples):
            opt_state, loss = _train_update(encoder, optimizer, head_params, opt_state, wave, label, valid, mesh)
            losses.append(loss)
        return head_params, opt_state, torch.stack(losses)

    return _placer(encoder, device, mesh, 1), run_steps, optimizer


__all__ = [
    "cross_entropy_loss",
    "encoder_classifier_loss",
    "make_sharded_train_loop",
    "make_sharded_train_step",
    "mesh_device",
    "place_optimizer_state",
    "train_parameters",
]
