"""End-to-end training step: encoder + classifier head, on one device.

Counterpart of ``ser_tpu/parallel/train_step.py``. One step computes the
log-mel (kernel K1; the waveform is data and takes no gradient) → encoder
forward (float32 master weights, compute in the encoder's ``compute_dtype``,
kernel K2 in every layer on the card, optional per-block remat) → masked
mean/std pool → ReLU MLP head → cross-entropy → backward (K2-bwd in every
layer on the card) → optimizer update. ``make_sharded_train_loop`` runs K
such steps over a (K, B, S) super-batch in one call, as the JAX package's
``lax.scan`` does, here as a Python loop.

One device only: the JAX step's mesh becomes a torch device, and a mesh with
a data or model axis above 1 raises ``NotImplementedError``. Data- and
tensor-parallel training over NCCL is a later slice (``ROADMAP.md``).

The head is a dict of float32 tensors in flax's layout, ``w1`` (2d, H),
``b1`` (H,), ``w2`` (H, C), ``b2`` (C,), as in the JAX step. The encoder's
parameters live in the module; the optimizer sees both under the names of
:func:`train_parameters`.
"""

from __future__ import annotations

import os
from collections.abc import Callable, Mapping

import torch

from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch.models.whisper import WhisperEncoder, log_mel_spectrogram
from ser_tpu_torch.parallel.optim import Optimizer, adam


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


def place_optimizer_state(device: torch.device | str, opt_state: dict) -> dict:
    """The optimizer state with every tensor on ``device`` (counterpart of the mesh placement)."""
    device = torch.device(device)

    def place(value):
        if isinstance(value, torch.Tensor):
            return value.to(device)
        if isinstance(value, Mapping):
            return {key: place(item) for key, item in value.items()}
        return value

    return place(opt_state)


def _train_update(
    encoder: WhisperEncoder,
    optimizer: Optimizer,
    head_params: Mapping[str, torch.Tensor],
    opt_state: dict,
    waveform: torch.Tensor,
    labels: torch.Tensor,
    valid_samples: torch.Tensor | None,
) -> tuple[dict, torch.Tensor]:
    """One optimizer step: loss and gradients → update, in place. Returns (opt_state, loss).

    Shared by ``make_sharded_train_step`` and ``make_sharded_train_loop`` so
    that their trajectories cannot diverge.
    """
    params = train_parameters(encoder, head_params)
    loss = encoder_classifier_loss(encoder, head_params, waveform, labels, valid_samples)
    grads = torch.autograd.grad(loss, list(params.values()))
    opt_state = optimizer.apply(params, dict(zip(params, grads)), opt_state)
    return opt_state, loss.detach()


def _one_device(device: torch.device | str | None, data_axis_size: int, model_axis_size: int) -> torch.device:
    if data_axis_size != 1 or model_axis_size != 1:
        raise NotImplementedError(
            f"A (data={data_axis_size}, model={model_axis_size}) mesh is not ported to ser_tpu_torch: "
            "training runs on one device (see ROADMAP.md)."
        )
    if device is None:
        return resolve_device(os.environ.get("SER_TORCH_DEVICE", "auto"))
    return torch.device(device)


def _place_head(head_params: Mapping[str, torch.Tensor], device: torch.device) -> dict[str, torch.Tensor]:
    return {
        name: torch.as_tensor(value).detach().to(device=device, dtype=torch.float32).clone().requires_grad_()
        for name, value in head_params.items()
    }


def make_sharded_train_step(
    encoder: WhisperEncoder,
    device: torch.device | str | None = None,
    optimizer: Optimizer | None = None,
    *,
    data_axis_size: int = 1,
    model_axis_size: int = 1,
) -> tuple[Callable, Callable, Optimizer]:
    """Builds ``(place, step, optimizer)``; the default optimizer is ``adam(1e-4)``.

    ``device`` None reads ``SER_TORCH_DEVICE`` (the card unless it says
    ``cpu``; no card raises). ``place(head, waveform, labels)`` moves the
    encoder, a float32 copy of the head and the batch to the device.
    ``step(head, opt_state, waveform, labels, valid_samples=None)`` returns
    ``(head, opt_state, loss)``, the parameters updated in place.
    """
    device = _one_device(device, data_axis_size, model_axis_size)
    optimizer = optimizer if optimizer is not None else adam(1e-4)

    def place(head_params, waveform, labels):
        encoder.to(device)
        return _place_head(head_params, device), waveform.to(device), labels.to(device)

    def step(head_params, opt_state, waveform, labels, valid_samples=None):
        opt_state, loss = _train_update(encoder, optimizer, head_params, opt_state, waveform, labels, valid_samples)
        return head_params, opt_state, loss

    return place, step, optimizer


def make_sharded_train_loop(
    encoder: WhisperEncoder,
    device: torch.device | str | None = None,
    optimizer: Optimizer | None = None,
    *,
    data_axis_size: int = 1,
    model_axis_size: int = 1,
) -> tuple[Callable, Callable, Optimizer]:
    """Builds ``(place, run_steps, optimizer)``: K steps per call.

    ``run_steps(head, opt_state, waveforms (K, B, S), labels (K, B),
    valid_samples (K, B) or None)`` returns ``(head, opt_state, losses (K,))``.
    Without ``valid_samples`` every sample counts as valid, and the pool is
    the masked one over all frames, as the JAX loop fills it.
    """
    device = _one_device(device, data_axis_size, model_axis_size)
    optimizer = optimizer if optimizer is not None else adam(1e-4)

    def place(head_params, waveforms, labels):
        encoder.to(device)
        return _place_head(head_params, device), waveforms.to(device), labels.to(device)

    def run_steps(head_params, opt_state, waveforms, labels, valid_samples=None):
        if valid_samples is None:
            valid_samples = torch.full(labels.shape, waveforms.shape[-1], dtype=torch.int32, device=labels.device)
        losses = []
        for wave, label, valid in zip(waveforms, labels, valid_samples):
            opt_state, loss = _train_update(encoder, optimizer, head_params, opt_state, wave, label, valid)
            losses.append(loss)
        return head_params, opt_state, torch.stack(losses)

    return place, run_steps, optimizer


__all__ = [
    "cross_entropy_loss",
    "encoder_classifier_loss",
    "make_sharded_train_loop",
    "make_sharded_train_step",
    "place_optimizer_state",
    "train_parameters",
]
