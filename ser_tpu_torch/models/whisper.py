"""Whisper encoder-decoder in PyTorch: embeddings and transcription.

Counterpart of ``ser_tpu/models/whisper.py``:

- the log-mel frontend (``log_mel_spectrogram``): the STFT, kernel K1
  (power → mel → log10) and Whisper's normalization;
- the pre-norm encoder (conv ×2 stride-2 stem with exact GELU, sinusoidal
  positions, ``EncoderBlock`` × n, final LayerNorm) as ``nn.Module``s whose
  self-attention runs kernel K2 on the card; with ``quant_int8`` (the opt-in
  ``dtype: int8`` lane) the q/k/v/out and both MLP products are W8A8
  (``models/quant.py``), the conv stem, LayerNorms, residual stream and
  attention unchanged;
- the teacher-forced decoder (``DecoderBlock``, ``WhisperDecoder``), whose
  parameters the KV-cache decode (``whisper_decode.py``) reads;
- the HF checkpoint loaders (``load_hf_whisper_{encoder,decoder}_params``),
  which return the same parameter trees of numpy arrays as the JAX loaders
  and keep their consumed-key audit, the generation-config readers, and
  seeded ``torch.Generator`` random inits;
- ``WhisperForTranscription``: KV-cache transcription of all 30 s windows as
  one batch, greedy or by beam search (then a teacher-forced pass for the
  alignment), optionally on the int8 decode weight stream, with temperature
  retries for degenerate windows, energy VAD and DTW word timing over the
  alignment heads.

The dtype policy is the JAX package's: matmuls and convolutions in the
compute dtype (bf16 on the card, float32 on the CPU), LayerNorms computed in
float32 with flax's fast variance E[x²]−E[x]², block LayerNorm outputs in
``ln_dtype`` (float32), the residual stream in the compute dtype after
``conv2``, the final LayerNorm in the compute dtype and cast to float32, and
every float parameter stored in the compute dtype (LayerNorm affines too).
The training encoder (``build_trainable_whisper_encoder``) keeps the JAX
training encoder's policy instead: float32 parameters, each product casting
its input and weights to the compute dtype, and the final LayerNorm in
float32 (flax promotes bf16 inputs with float32 parameters); its blocks may
be recomputed in the backward (``remat``, policies ``"full"`` and ``"dots"``).

Layouts: flax Conv kernels (k, in, out) are ``nn.Conv1d`` weights (out, in, k);
flax Dense kernels (in, out) are ``nn.Linear`` weights (out, in); ``k`` has no
bias. ``convert.py`` carries a JAX parameter tree across.
"""

from __future__ import annotations

import json
import logging
import math
import os
import warnings
import zlib
from dataclasses import dataclass
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ser_tpu_torch.domain import TranscriptWord
from ser_tpu_torch._internal.repr.runtime_policy import refuse_float32_decode_on_card
from ser_tpu_torch._internal.utils.torch_runtime import honor_platform_env
from ser_tpu_torch.models import whisper_decode
from ser_tpu_torch.models.attention import multi_head_attention
from ser_tpu_torch.models.checkpoint_audit import AuditedState, unconsumed_key_error
from ser_tpu_torch.models.hf_checkpoint import read_hf_tensors
from ser_tpu_torch.models.quant import QuantDense
from ser_tpu_torch.models.tensor_parallel import copy_to_model_group, local_slice, reduce_from_model_group
from ser_tpu_torch.ops.activations import gelu_erf
from ser_tpu_torch.ops.decode_step_kernels import require_fused_decode_shapes
from ser_tpu_torch.ops.log_mel import log_mel_raw, normalize_log_mel, set_strict_float32

logger = logging.getLogger(__name__)

N_FFT = 400
HOP_LENGTH = 160
SAMPLE_RATE = 16000
CHUNK_SECONDS = 30
CHUNK_SAMPLES = CHUNK_SECONDS * SAMPLE_RATE
CHUNK_FRAMES = CHUNK_SAMPLES // HOP_LENGTH  # 3000 mel frames per 30 s window


@dataclass(frozen=True)
class WhisperConfig:
    """Whisper architecture hyperparameters (defaults = large-v3)."""

    n_mels: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 32
    n_heads: int = 20
    vocab_size: int = 51866
    max_target_positions: int = 448
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls) -> "WhisperConfig":
        return cls(
            n_mels=80,
            d_model=64,
            encoder_layers=2,
            decoder_layers=2,
            n_heads=4,
            vocab_size=256,
            max_target_positions=64,
        )


# --------------------------------------------------------------------------- #
# Log-mel frontend
# --------------------------------------------------------------------------- #


def log_mel_spectrogram(waveform: torch.Tensor, n_mels: int) -> torch.Tensor:
    """Whisper's log-mel features. (B, CHUNK_SAMPLES) → (B, CHUNK_FRAMES, n_mels).

    Hann window, 400-FFT/160-hop power, Slaney mel, log10 clamp at 1e-10
    (kernel K1 on the card), dynamic-range floor at max-8, then (x+4)/4.
    """
    raw = log_mel_raw(
        waveform,
        sr=SAMPLE_RATE,
        n_fft=N_FFT,
        hop_length=HOP_LENGTH,
        n_mels=n_mels,
        n_frames_out=CHUNK_FRAMES,
    )
    return normalize_log_mel(raw)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal position table (sin | cos concatenation)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# --------------------------------------------------------------------------- #
# Encoder modules
# --------------------------------------------------------------------------- #


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` numerics: float32 statistics with the fast variance.

    ``out_dtype`` None returns flax's default, the promotion of the input's and
    the parameters' dtypes: bf16 for bf16 inputs and weights (inference), and
    float32 for float32 master weights (training), as flax's ``final_ln``,
    which has no ``dtype``, gives.
    """

    def __init__(self, dim: int, eps: float, out_dtype: torch.dtype | None = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=-1, keepdim=True)
        mean_sq = (x32 * x32).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(torch.float32)
        y = (x32 - mean) * mul + self.bias.to(torch.float32)
        return y.to(self.out_dtype if self.out_dtype is not None else torch.promote_types(x.dtype, self.weight.dtype))


def _dense(
    layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, group: torch.distributed.ProcessGroup | None = None
) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``.

    The casts are no-ops for weights stored in ``dtype`` (inference); for
    float32 master weights the gradient reaches them through the cast. A
    ``QuantDense`` quantizes ``x`` as it comes and returns ``dtype``. With a
    model ``group`` the layer is column-parallel: its weight holds this rank's
    output rows and its bias is whole, of which this rank's slice is added.
    """
    if isinstance(layer, QuantDense):
        return layer(x, dtype)
    bias = layer.bias
    if bias is not None and group is not None:
        bias = local_slice(bias, group)
    bias = None if bias is None else bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _row_parallel(
    layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, group: torch.distributed.ProcessGroup
) -> torch.Tensor:
    """A row-parallel ``nn.Dense``: this rank's input columns, the partial sums added over
    ``group`` (Megatron's ``g``), then the whole bias, once."""
    partial_sum = F.linear(x.to(dtype), layer.weight.to(dtype))
    return reduce_from_model_group(partial_sum, group) + layer.bias.to(dtype)


def _linear_layers(
    d_in: int, d_out: int, quant_int8: bool, parts: int
) -> tuple[nn.Module, nn.Module]:
    """A (column-parallel, row-parallel) pair d_in → d_out → d_in cut into ``parts``.

    The column-parallel layer holds d_out / parts output rows and its whole
    bias, the row-parallel one d_out / parts input columns and its whole
    bias; at one part both are the plain layers.
    """
    if parts == 1:
        linear = QuantDense if quant_int8 else nn.Linear
        return linear(d_in, d_out), linear(d_out, d_in)
    if quant_int8:
        raise ValueError("The W8A8 encoder (inference only) has no tensor-parallel form.")
    column, row = nn.Linear(d_in, d_out // parts), nn.Linear(d_out // parts, d_in)
    column.bias = nn.Parameter(torch.empty(d_out))
    return column, row


def _conv(layer: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=...)``: input, kernel and bias cast to ``dtype``."""
    return F.conv1d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype), layer.stride, layer.padding)


class MultiHeadAttention(nn.Module):
    """Encoder self-attention: q/k/v projections, kernel K2, out projection.

    ``compute_dtype`` None computes in the weights' dtype. ``quant_int8``
    makes the four projections W8A8 (``QuantDense``, the same state dict).
    With a ``model_group`` of P ranks (Megatron tensor parallelism) q, k and v
    are column-parallel and hold this rank's H/P heads, and ``out`` is
    row-parallel; the head count comes from q's local width.
    """

    def __init__(
        self,
        config: WhisperConfig,
        compute_dtype: torch.dtype | None = None,
        quant_int8: bool = False,
        model_group: torch.distributed.ProcessGroup | None = None,
    ) -> None:
        super().__init__()
        d = config.d_model
        parts = 1 if model_group is None else torch.distributed.get_world_size(model_group)
        self.n_heads = config.n_heads
        self.head_dim = d // config.n_heads
        self.compute_dtype = compute_dtype
        self.model_group = model_group
        q, out = _linear_layers(d, d, quant_int8, parts)
        self.q = q
        self.k = (QuantDense if quant_int8 else nn.Linear)(d, d // parts, bias=False)
        self.v = _linear_layers(d, d, quant_int8, parts)[0]
        self.out = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, _ = x.shape
        dtype = self.compute_dtype or self.q.weight.dtype
        group = self.model_group
        if not isinstance(self.q, QuantDense):  # W8A8 quantizes the LayerNorm's output as it comes
            x = x.to(dtype)  # once for the three projections
        if group is not None:
            x = copy_to_model_group(x, group)
        q = _dense(self.q, x, dtype, group)
        heads = (batch, seq, q.shape[-1] // self.head_dim, self.head_dim)
        q = q.view(heads)
        k = _dense(self.k, x, dtype).view(heads)
        v = _dense(self.v, x, dtype, group).view(heads)
        out = multi_head_attention(q, k, v, compute_dtype=dtype).reshape(batch, seq, -1)
        if group is None:
            return _dense(self.out, out, dtype)
        return _row_parallel(self.out, out, dtype, group)


class EncoderBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then x + mlp(LN(x)).

    With a ``model_group``, ``mlp_in`` is column-parallel and ``mlp_out``
    row-parallel, as in the attention: one sum over the group per product pair.
    """

    def __init__(
        self,
        config: WhisperConfig,
        ln_dtype: torch.dtype = torch.float32,
        compute_dtype: torch.dtype | None = None,
        quant_int8: bool = False,
        model_group: torch.distributed.ProcessGroup | None = None,
    ) -> None:
        super().__init__()
        d = config.d_model
        parts = 1 if model_group is None else torch.distributed.get_world_size(model_group)
        self.compute_dtype = compute_dtype
        self.model_group = model_group
        self.attn_ln = LayerNorm(d, config.layer_norm_eps, ln_dtype)
        self.attn = MultiHeadAttention(config, compute_dtype, quant_int8, model_group)
        self.mlp_ln = LayerNorm(d, config.layer_norm_eps, ln_dtype)
        self.mlp_in, self.mlp_out = _linear_layers(d, 4 * d, quant_int8, parts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.mlp_in.weight.dtype
        group = self.model_group
        x = x + self.attn(self.attn_ln(x))
        if group is None:
            h = _dense(self.mlp_in, self.mlp_ln(x), dtype)
            return x + _dense(self.mlp_out, gelu_erf(h), dtype)
        h = _dense(self.mlp_in, copy_to_model_group(self.mlp_ln(x).to(dtype), group), dtype, group)
        return x + _row_parallel(self.mlp_out, gelu_erf(h), dtype, group)


REMAT_POLICIES = ("full", "dots")


def _save_projections(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The ``"dots"`` policy: keep the projection products' outputs, recompute the rest.

    Counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``:
    every ``nn.Dense`` product is a 2-D ``mm``/``addmm`` here; attention
    (kernel K2, or batched einsums on the CPU), LayerNorm, GELU and the casts
    are recomputed.
    """
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class WhisperEncoder(nn.Module):
    """Mel frames → contextual states. (B, CHUNK_FRAMES, n_mels) → (B, T/2, d) float32.

    ``compute_dtype`` None computes in the weights' dtype (inference, weights
    stored in bf16 or float32). Training keeps float32 master weights and
    sets ``compute_dtype`` (bf16 on the card): each product casts its input
    and weights to it, as flax's ``dtype=`` does. ``remat`` recomputes each
    block in the backward (``torch.utils.checkpoint``, non-reentrant), all of
    it (``"full"``) or all but the projection products (``"dots"``); it acts
    only when grad mode is on. ``quant_int8`` (inference only) makes every
    block's projection products W8A8. ``model_group`` (training) makes every
    block tensor-parallel over that group; the stem, the LayerNorms and the
    residual stream stay whole on every rank.
    """

    def __init__(
        self,
        config: WhisperConfig,
        ln_dtype: torch.dtype = torch.float32,
        *,
        compute_dtype: torch.dtype | None = None,
        remat: bool = False,
        remat_policy: str = "full",
        quant_int8: bool = False,
        model_group: torch.distributed.ProcessGroup | None = None,
    ) -> None:
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {remat_policy!r}.")
        d = config.d_model
        self.config = config
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.remat_policy = remat_policy
        self.conv1 = nn.Conv1d(config.n_mels, d, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(d, d, kernel_size=3, stride=2, padding=1)
        self.layers = nn.ModuleList(
            EncoderBlock(config, ln_dtype, compute_dtype, quant_int8, model_group)
            for _ in range(config.encoder_layers)
        )
        self.final_ln = LayerNorm(d, config.layer_norm_eps)
        self._positions: dict[tuple, torch.Tensor] = {}

    def _position_table(self, length: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        key = (length, device, dtype)
        if key not in self._positions:
            table = torch.from_numpy(_sinusoids(length, self.config.d_model))
            self._positions[key] = table.to(device=device, dtype=dtype)
        return self._positions[key]

    def _run_block(self, layer: EncoderBlock, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return layer(x)
        context_fn = noop_context_fn
        if self.remat_policy == "dots":
            context_fn = partial(create_selective_checkpoint_contexts, _save_projections)
        return checkpoint(layer, x, use_reentrant=False, context_fn=context_fn)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or self.conv1.weight.dtype
        x = gelu_erf(_conv(self.conv1, mel.transpose(1, 2), dtype))
        x = gelu_erf(_conv(self.conv2, x, dtype)).transpose(1, 2)
        x = x + self._position_table(x.shape[1], x.device, dtype)[None]
        for layer in self.layers:
            x = self._run_block(layer, x)
        return self.final_ln(x).to(torch.float32)


def build_whisper_encoder(
    config: WhisperConfig,
    state_dict: dict[str, torch.Tensor],
    *,
    device: torch.device,
    dtype: torch.dtype,
    quant_int8: bool = False,
) -> WhisperEncoder:
    """An eval-mode encoder holding ``state_dict`` on ``device``, stored in ``dtype``.

    Built on the meta device and filled by assignment, so the full-size model
    never runs PyTorch's default init or holds a second copy. With
    ``quant_int8`` its projections are quantized here, once.
    """
    with torch.device("meta"):
        encoder = WhisperEncoder(config, quant_int8=quant_int8)
    placed = {name: tensor.to(device=device, dtype=dtype) for name, tensor in state_dict.items()}
    encoder.load_state_dict(placed, strict=True, assign=True)
    for module in encoder.modules():
        if isinstance(module, QuantDense):
            module.quantized()
    return encoder.eval()


def build_trainable_whisper_encoder(
    config: WhisperConfig,
    state_dict: dict[str, torch.Tensor],
    *,
    device: torch.device,
    compute_dtype: torch.dtype,
    remat: bool = True,
    remat_policy: str = "dots",
    mesh=None,
) -> WhisperEncoder:
    """A train-mode encoder with float32 master weights on ``device``, computing in ``compute_dtype``.

    The training counterpart of :func:`build_whisper_encoder`: the JAX
    package's training encoder keeps float32 parameters
    (``init_whisper_encoder_params``) and casts them per op. Built on the meta
    device and filled by assignment, like the inference encoder: a float32
    tensor of ``state_dict`` already on ``device`` becomes the parameter
    itself, and training updates it in place. On a
    ``mesh`` (``ser_tpu_torch.parallel.mesh``) whose model axis has P > 1
    ranks, ``state_dict`` is the full one: this rank keeps its shards of it
    (``parallel.sharding.shard_state_dict``) and its blocks run
    tensor-parallel over the model axis, H/P heads each.
    """
    from ser_tpu_torch.parallel.sharding import model_group, shard_state_dict

    group = model_group(mesh)
    if group is not None:
        parts = torch.distributed.get_world_size(group)
        if config.n_heads % parts:
            raise ValueError(f"A model axis of {parts} does not divide {config.n_heads} heads.")
        state_dict = shard_state_dict(mesh, state_dict)
    with torch.device("meta"):
        encoder = WhisperEncoder(
            config, compute_dtype=compute_dtype, remat=remat, remat_policy=remat_policy, model_group=group
        )
    placed = {name: tensor.to(device=device, dtype=torch.float32) for name, tensor in state_dict.items()}
    encoder.load_state_dict(placed, strict=True, assign=True)
    return encoder.train()


@torch.inference_mode()
def encode_mel_chunks(encoder: WhisperEncoder, chunks: torch.Tensor) -> torch.Tensor:
    """(B, CHUNK_SAMPLES) waveform chunks → (B, 1500, d) float32 encoder states."""
    if chunks.device.type == "cuda":
        set_strict_float32()
    mel = log_mel_spectrogram(chunks, encoder.config.n_mels)
    return encoder(mel)


# --------------------------------------------------------------------------- #
# Decoder modules
# --------------------------------------------------------------------------- #


class DecoderAttention(MultiHeadAttention):
    """Decoder attention: the same projections, the einsum path with an additive bias.

    ``ser_tpu``'s ``MultiHeadAttention`` without its flash route: scores over
    Dh divided by √Dh in the compute dtype, the bias added, softmax in float32
    cast back, then the value sum and the out projection.
    """

    def forward(self, x: torch.Tensor, kv: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
        dtype = self.q.weight.dtype
        x, kv = x.to(dtype), kv.to(dtype)

        def split(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(*t.shape[:-1], self.n_heads, t.shape[-1] // self.n_heads)

        q, k, v = split(self.q(x)), split(self.k(kv)), split(self.v(kv))
        root_d = torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=dtype, device=q.device))
        scores = torch.einsum("...qhd,...khd->...hqk", q, k) / root_d
        if bias is not None:
            scores = scores + bias.to(scores.dtype)
        weights = torch.softmax(scores.to(torch.float32), dim=-1).to(dtype)
        out = torch.einsum("...hqk,...khd->...qhd", weights, v)
        return self.out(out.reshape(*x.shape[:-1], -1))


class DecoderBlock(nn.Module):
    """Pre-norm block: x + self-attn(LN(x)), x + cross-attn(LN(x), states), x + mlp(LN(x))."""

    def __init__(self, config: WhisperConfig) -> None:
        super().__init__()
        d = config.d_model
        self.attn_ln = LayerNorm(d, config.layer_norm_eps)
        self.attn = DecoderAttention(config)
        self.cross_ln = LayerNorm(d, config.layer_norm_eps)
        self.cross = DecoderAttention(config)
        self.mlp_ln = LayerNorm(d, config.layer_norm_eps)
        self.mlp_in = nn.Linear(d, 4 * d)
        self.mlp_out = nn.Linear(4 * d, d)

    def forward(self, x: torch.Tensor, encoder_states: torch.Tensor, *, self_bias: torch.Tensor) -> torch.Tensor:
        h = self.attn_ln(x)
        x = x + self.attn(h, h, bias=self_bias)
        h = self.cross_ln(x)
        x = x + self.cross(h, encoder_states)
        h = self.mlp_ln(x).to(self.mlp_in.weight.dtype)
        return x + self.mlp_out(gelu_erf(self.mlp_in(h)))


class WhisperDecoder(nn.Module):
    """Teacher-forced decoder over full token prefixes. (B, T) ids, (B, S, d) states → (B, T, V) logits.

    The reference numerics for the KV-cache decode, which reads this module's
    parameters directly (``whisper_decode.greedy_decode_kv_cache``). The
    output head is tied to ``tok_embed``.
    """

    def __init__(self, config: WhisperConfig) -> None:
        super().__init__()
        d = config.d_model
        self.config = config
        self.tok_embed = nn.Parameter(torch.zeros(config.vocab_size, d))
        self.pos_embed = nn.Parameter(torch.zeros(config.max_target_positions, d))
        self.layers = nn.ModuleList(DecoderBlock(config) for _ in range(config.decoder_layers))
        self.final_ln = LayerNorm(d, config.layer_norm_eps)

    def forward(self, tokens: torch.Tensor, encoder_states: torch.Tensor) -> torch.Tensor:
        seq_len = tokens.shape[-1]
        x = self.tok_embed[tokens] + self.pos_embed[None, :seq_len]
        causal = torch.ones((seq_len, seq_len), dtype=torch.bool, device=tokens.device).tril()
        self_bias = torch.where(causal, 0.0, -1e30)[None, None]
        for layer in self.layers:
            x = layer(x, encoder_states, self_bias=self_bias)
        x = self.final_ln(x)
        return torch.einsum("btd,vd->btv", x, self.tok_embed)


def build_whisper_decoder(
    config: WhisperConfig,
    state_dict: dict[str, torch.Tensor],
    *,
    device: torch.device,
    dtype: torch.dtype,
) -> WhisperDecoder:
    """An eval-mode decoder holding ``state_dict`` on ``device``, stored in ``dtype``."""
    with torch.device("meta"):
        decoder = WhisperDecoder(config)
    placed = {name: tensor.to(device=device, dtype=dtype) for name, tensor in state_dict.items()}
    decoder.load_state_dict(placed, strict=True, assign=True)
    return decoder.eval()


# --------------------------------------------------------------------------- #
# Random init + HF conversion
# --------------------------------------------------------------------------- #


def random_whisper_encoder_state(
    config: WhisperConfig, *, seed: int, device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """Seeded random float32 weights, drawn by a ``torch.Generator`` on ``device``.

    flax's default init shapes: truncated-normal kernels with std 1/√fan_in,
    zero biases, unit LayerNorm scales. The values differ from
    ``ser_tpu.models.whisper.init_whisper_encoder_params`` for the same seed;
    tests carry JAX's weights across with ``convert.py`` instead.
    """
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        shapes = {name: tensor.shape for name, tensor in WhisperEncoder(config).state_dict().items()}
    state: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name.endswith("bias"):
            state[name] = torch.zeros(shape, device=device)
        elif "_ln." in name:
            state[name] = torch.ones(shape, device=device)
        else:
            fan_in = math.prod(shape[1:])
            std = 1.0 / math.sqrt(fan_in)
            tensor = torch.empty(shape, device=device)
            nn.init.trunc_normal_(tensor, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
            state[name] = tensor
    return state


def random_whisper_decoder_state(
    config: WhisperConfig, *, seed: int, device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """Seeded random float32 decoder weights, drawn by a ``torch.Generator`` on ``device``.

    flax's init shapes and kinds (``WhisperDecoder.init``): truncated-normal
    Dense kernels with std 1/√fan_in, zero biases, unit LayerNorm scales,
    ``tok_embed`` normal with std 0.02 and a zero position table. The values
    differ from JAX's for the same seed.
    """
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        shapes = {name: tensor.shape for name, tensor in WhisperDecoder(config).state_dict().items()}
    state: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name == "tok_embed":
            state[name] = torch.randn(shape, generator=generator, device=device) * 0.02
        elif name == "pos_embed" or name.endswith("bias"):
            state[name] = torch.zeros(shape, device=device)
        elif "_ln." in name:
            state[name] = torch.ones(shape, device=device)
        else:
            std = 1.0 / math.sqrt(shape[1])
            tensor = torch.empty(shape, device=device)
            nn.init.trunc_normal_(tensor, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
            state[name] = tensor
    return state


def whisper_config_from_hf_dir(model_dir) -> WhisperConfig:
    raw = json.loads((Path(model_dir) / "config.json").read_text(encoding="utf-8"))
    return WhisperConfig(
        n_mels=raw.get("num_mel_bins", 80),
        d_model=raw["d_model"],
        encoder_layers=raw["encoder_layers"],
        decoder_layers=raw["decoder_layers"],
        n_heads=raw["encoder_attention_heads"],
        vocab_size=raw["vocab_size"],
        max_target_positions=raw.get("max_target_positions", 448),
    )


def _read_generation_config(model_dir) -> dict:
    """A checkpoint's ``generation_config.json``, or {} when missing or unreadable."""
    path = Path(model_dir) / "generation_config.json"
    if not path.is_file():
        return {}
    try:
        raw = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return {}
    return raw if isinstance(raw, dict) else {}


def alignment_heads_from_hf_dir(model_dir) -> tuple[tuple[int, int], ...] | None:
    """Published (layer, head) cross-attention alignment pairs, or None."""
    pairs = _read_generation_config(model_dir).get("alignment_heads")
    if not pairs:
        return None
    return tuple((int(layer), int(head)) for layer, head in pairs)


def suppress_tokens_from_hf_dir(model_dir) -> tuple[int, ...]:
    """Published ``suppress_tokens``, sorted and deduplicated.

    ``begin_suppress_tokens`` is left out on purpose, as in the JAX package:
    it holds EOT, and timestamp rule 3 already constrains the first token.
    """
    tokens = _read_generation_config(model_dir).get("suppress_tokens") or []
    return tuple(sorted({int(token) for token in tokens}))


def _attention_params(t, base_hf: str) -> dict:
    return {
        "q": {"kernel": t(f"{base_hf}.q_proj.weight").T, "bias": t(f"{base_hf}.q_proj.bias")},
        "k": {"kernel": t(f"{base_hf}.k_proj.weight").T},
        "v": {"kernel": t(f"{base_hf}.v_proj.weight").T, "bias": t(f"{base_hf}.v_proj.bias")},
        "out": {"kernel": t(f"{base_hf}.out_proj.weight").T, "bias": t(f"{base_hf}.out_proj.bias")},
    }


def load_hf_whisper_encoder_params(model_dir, config: WhisperConfig) -> dict:
    """A local HF Whisper checkpoint's encoder weights as the JAX parameter tree.

    Same tree of numpy arrays as ``ser_tpu.models.whisper.
    load_hf_whisper_encoder_params``: missing weights raise by name, and
    encoder tensors the conversion never consumed refuse the load. The fixed
    sinusoidal position table is recomputed, not loaded.
    """
    sd = AuditedState(read_hf_tensors(model_dir))

    def t(name):
        for key in (name, f"model.{name}"):
            if key in sd:
                return sd.take(key)
        raise KeyError(f"Missing weight {name!r}.")

    params: dict = {
        "conv1": {
            "kernel": t("encoder.conv1.weight").transpose(2, 1, 0),
            "bias": t("encoder.conv1.bias"),
        },
        "conv2": {
            "kernel": t("encoder.conv2.weight").transpose(2, 1, 0),
            "bias": t("encoder.conv2.bias"),
        },
        "final_ln": {
            "scale": t("encoder.layer_norm.weight"),
            "bias": t("encoder.layer_norm.bias"),
        },
    }
    for i in range(config.encoder_layers):
        base = f"encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "attn_ln": {
                "scale": t(f"{base}.self_attn_layer_norm.weight"),
                "bias": t(f"{base}.self_attn_layer_norm.bias"),
            },
            "attn": _attention_params(t, f"{base}.self_attn"),
            "mlp_ln": {
                "scale": t(f"{base}.final_layer_norm.weight"),
                "bias": t(f"{base}.final_layer_norm.bias"),
            },
            "mlp_in": {"kernel": t(f"{base}.fc1.weight").T, "bias": t(f"{base}.fc1.bias")},
            "mlp_out": {"kernel": t(f"{base}.fc2.weight").T, "bias": t(f"{base}.fc2.bias")},
        }

    leftovers = sd.unconsumed(
        scope_prefixes=("encoder.", "model.encoder."),
        ignore_exact=(
            "encoder.embed_positions.weight",
            "model.encoder.embed_positions.weight",
        ),
    )
    if leftovers:
        raise unconsumed_key_error(leftovers, model="whisper encoder")
    return params


def load_hf_whisper_decoder_params(model_dir, config: WhisperConfig) -> dict:
    """A local HF Whisper checkpoint's decoder weights as the JAX parameter tree.

    Same tree as ``ser_tpu.models.whisper.load_hf_whisper_decoder_params``,
    with the same consumed-key audit over the decoder's tensors (``proj_out``
    is the tied output head and is never loaded on its own).
    """
    sd = AuditedState(read_hf_tensors(model_dir))

    def t(name):
        for key in (name, f"model.{name}"):
            if key in sd:
                return sd.take(key)
        raise KeyError(f"Missing weight {name!r}.")

    def norm(name):
        return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias")}

    params: dict = {
        "tok_embed": t("decoder.embed_tokens.weight"),
        "pos_embed": t("decoder.embed_positions.weight"),
        "final_ln": norm("decoder.layer_norm"),
    }
    for i in range(config.decoder_layers):
        base = f"decoder.layers.{i}"
        params[f"layer_{i}"] = {
            "attn_ln": norm(f"{base}.self_attn_layer_norm"),
            "attn": _attention_params(t, f"{base}.self_attn"),
            "cross_ln": norm(f"{base}.encoder_attn_layer_norm"),
            "cross": _attention_params(t, f"{base}.encoder_attn"),
            "mlp_ln": norm(f"{base}.final_layer_norm"),
            "mlp_in": {"kernel": t(f"{base}.fc1.weight").T, "bias": t(f"{base}.fc1.bias")},
            "mlp_out": {"kernel": t(f"{base}.fc2.weight").T, "bias": t(f"{base}.fc2.bias")},
        }

    leftovers = sd.unconsumed(scope_prefixes=("decoder.", "model.decoder."))
    if leftovers:
        raise unconsumed_key_error(leftovers, model="whisper decoder")
    return params


# --------------------------------------------------------------------------- #
# Transcription driver
# --------------------------------------------------------------------------- #


class WhisperForTranscription:
    """KV-cache transcription (greedy or beam search) with DTW-aligned word timestamps.

    Counterpart of ``ser_tpu.models.whisper.WhisperForTranscription``.
    ``encoder_state``/``decoder_state`` are the port's state dicts
    (``convert.py`` carries JAX trees across); the models are built on
    ``device`` in ``compute_dtype``. bf16 greedy decodes run through the step
    kernels K3-K5 (``fused=True``), where the JAX package keeps XLA's route
    (``ROADMAP.md``, Queue 3); on CPU tensors the kernels' plain versions run.
    ``decode_strategy="beam"`` decodes at temperature 0 by beam search
    (``beam_size``, GNMT ``length_penalty``) through separate PyTorch ops,
    then times words from a teacher-forced pass over the winners; its
    temperature retries sample through the greedy route. ``decode_int8``
    (default: ``SER_DECODE_INT8=1``) runs every decode on the int8 weight
    stream, quantized once per model, through separate ops (the JAX package
    refuses ``fused`` with int8). On a CUDA device the model is checked
    before any weight is built: float32 raises the runtime policy's
    ``NotImplementedError`` (K3-K5 take bf16 only), and a shape that K3-K5
    refuse raises ``ValueError`` naming the rule. ``device`` None is the
    device ``SER_TORCH_DEVICE`` names (``honor_platform_env``: the card, the
    CPU only when asked for, and raises with neither); ``compute_dtype`` None
    is bf16 on the card and float32 on the CPU, as ``"auto"`` resolves.
    """

    PREFIX_LEN = 3  # <|startoftranscript|> <|lang|> <|transcribe|>

    #: Escalation schedule for degenerate (repetitive) window transcripts.
    RETRY_TEMPERATURES = (0.2, 0.5, 0.8)

    def __init__(
        self,
        config: WhisperConfig,
        encoder_state: dict[str, torch.Tensor],
        decoder_state: dict[str, torch.Tensor],
        tokenizer,
        *,
        device: torch.device | str | None = None,
        compute_dtype: str | None = None,
        alignment_heads: tuple[tuple[int, int], ...] | None = None,
        word_timestamps: str = "align",
        suppress_tokens: tuple[int, ...] = (),
        apply_timestamp_rules: bool = True,
        decode_strategy: str = "greedy",
        beam_size: int = 5,
        length_penalty: float = 1.0,
        decode_int8: bool | None = None,
    ) -> None:
        if decode_strategy not in ("greedy", "beam"):
            raise ValueError(f"Unknown decode strategy {decode_strategy!r}")
        if decode_int8 is None:
            decode_int8 = os.environ.get("SER_DECODE_INT8", "") == "1"
        self.decode_int8 = bool(decode_int8)
        self.device = honor_platform_env() if device is None else torch.device(device)
        if compute_dtype is None:
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unknown compute dtype {compute_dtype!r}")
        if self.device.type == "cuda":
            if compute_dtype == "float32":
                refuse_float32_decode_on_card(self.device)
            require_fused_decode_shapes(
                config.d_model, config.n_heads, CHUNK_FRAMES // 2, config.max_target_positions
            )
        self.config = config
        self.compute_dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
        self.encoder = build_whisper_encoder(config, encoder_state, device=self.device, dtype=self.compute_dtype)
        self.decoder = build_whisper_decoder(config, decoder_state, device=self.device, dtype=self.compute_dtype)
        self.tokenizer = tokenizer
        self.word_timestamps = word_timestamps
        if alignment_heads is None:
            alignment_heads = whisper_decode.default_alignment_spec(config.decoder_layers, config.n_heads)
        # Checkpoint metadata is untrusted: drop pairs this decoder does not
        # have, and fall back to the default spec if none survive.
        valid = tuple(
            (int(layer), int(head))
            for layer, head in alignment_heads
            if 0 <= int(layer) < config.decoder_layers and 0 <= int(head) < config.n_heads
        )
        if len(valid) < len(tuple(alignment_heads)):
            warnings.warn(
                "Dropping out-of-range alignment head(s) from checkpoint metadata "
                f"({len(tuple(alignment_heads)) - len(valid)} of {len(tuple(alignment_heads))}).",
                stacklevel=2,
            )
        if not valid:
            valid = whisper_decode.default_alignment_spec(config.decoder_layers, config.n_heads)
        self.alignment_heads = valid
        self.suppress_tokens = tuple(int(t) for t in suppress_tokens)
        self.apply_timestamp_rules = apply_timestamp_rules
        self.decode_strategy = decode_strategy
        self.beam_size = int(beam_size)
        self.length_penalty = float(length_penalty)
        self._decode_weights: whisper_decode.DecodeWeights | None = None

    def decode_weights(self) -> whisper_decode.DecodeWeights:
        """The decoder's fused QKV kernels with K3-K5's per-head layouts, or its int8
        weight stream, computed once per model."""
        if self._decode_weights is None:
            self._decode_weights = whisper_decode.prepare_decode_weights(
                self.decoder, self.config, fused=not self.decode_int8, quant_int8=self.decode_int8
            )
        return self._decode_weights

    @classmethod
    def from_pretrained_dir(
        cls,
        model_dir,
        *,
        device: torch.device | str | None = None,
        compute_dtype: str | None = None,
        decode_strategy: str = "greedy",
        beam_size: int = 5,
        length_penalty: float = 1.0,
    ):
        """Loads config, weights and tokenizer from a local HF checkpoint directory.

        The tokenizer is the port's own (``whisper_tokenizer.py``); a missing
        ``vocab.json`` or ``merges.txt`` raises ``FileNotFoundError`` naming it
        before any weight is read. ``device`` and ``compute_dtype`` default as
        the constructor's do, resolved before the load.
        """
        from ser_tpu_torch.models.convert import whisper_decoder_state_dict, whisper_encoder_state_dict
        from ser_tpu_torch.models.whisper_tokenizer import WhisperTokenizer

        device = honor_platform_env() if device is None else torch.device(device)
        tokenizer = WhisperTokenizer.from_pretrained(model_dir)
        config = whisper_config_from_hf_dir(model_dir)
        return cls(
            config,
            whisper_encoder_state_dict(load_hf_whisper_encoder_params(model_dir, config)),
            whisper_decoder_state_dict(load_hf_whisper_decoder_params(model_dir, config)),
            tokenizer,
            device=device,
            compute_dtype=compute_dtype,
            alignment_heads=alignment_heads_from_hf_dir(model_dir),
            suppress_tokens=suppress_tokens_from_hf_dir(model_dir),
            decode_strategy=decode_strategy,
            beam_size=beam_size,
            length_penalty=length_penalty,
        )

    def _special(self, token: str) -> int:
        ids = self.tokenizer.convert_tokens_to_ids([token])
        # Whisper tokenizers alias unk to <|endoftext|>, so EOT may resolve to unk_id.
        unk_matches = ids[0] == self.tokenizer.unk_token_id and token != str(
            getattr(self.tokenizer, "unk_token", "")
        )
        if ids[0] is None or unk_matches:
            raise ValueError(f"Tokenizer lacks special token {token}")
        return int(ids[0])

    def _decode_chunk_batch(
        self,
        encoder_states: torch.Tensor,
        language: str,
        num_frames: np.ndarray,
        *,
        temperature: float = 0.0,
        rng_seed: int = 0,
    ) -> tuple[list[list[int]], np.ndarray | None]:
        """KV-cache decode (greedy or beam) of a batch of 30 s windows.

        Returns each window's emitted ids and, with alignment capture on, the
        per-window DTW matrix ``(B, max_len, S)``, reduced on the device so
        only that matrix reaches the host. Beam mode decodes at temperature 0
        only and takes its alignment from :func:`whisper_decode.
        alignment_forward` over the winners; a retry above temperature 0
        samples through the greedy route.
        """
        prefix = [
            self._special("<|startoftranscript|>"),
            self._special(f"<|{language}|>"),
            self._special("<|transcribe|>"),
        ]
        eot = self._special("<|endoftext|>")
        align_spec = self.alignment_heads if self.word_timestamps == "align" else ()
        timestamp_begin = self._special("<|0.00|>") if self.apply_timestamp_rules else None
        common = dict(
            prefix_len=self.PREFIX_LEN,
            compute_dtype=self.compute_dtype,
            suppress_tokens=self.suppress_tokens,
            timestamp_begin=timestamp_begin,
            quant_int8=self.decode_int8,
            weights=self.decode_weights(),
        )
        if self.decode_strategy == "beam" and temperature == 0.0:
            tokens, lengths = whisper_decode.beam_decode_kv_cache(
                self.decoder, self.config, encoder_states, prefix, eot,
                beam_size=self.beam_size, length_penalty=self.length_penalty, **common,
            )
            align = None
            if align_spec:
                align = whisper_decode.alignment_forward(
                    self.decoder, self.config, encoder_states, tokens,
                    align_spec=align_spec, compute_dtype=self.compute_dtype,
                )
        else:
            tokens, lengths, align = whisper_decode.greedy_decode_kv_cache(
                self.decoder, self.config, encoder_states, prefix, eot,
                align_spec=align_spec, temperature=temperature, rng_seed=rng_seed,
                fused=not self.decode_int8, **common,
            )
        matrix = None
        if align_spec:
            matrix = (
                whisper_decode.reduce_alignment_matrix(
                    align,
                    self.PREFIX_LEN + lengths,
                    torch.as_tensor(num_frames, dtype=torch.long, device=align.device),
                    prefix_len=self.PREFIX_LEN,
                )
                .cpu()
                .numpy()
            )
        tokens_np = tokens.cpu().numpy()
        lengths_np = lengths.cpu().numpy()
        emitted = [
            tokens_np[row, self.PREFIX_LEN : self.PREFIX_LEN + int(lengths_np[row])].tolist()
            for row in range(tokens_np.shape[0])
        ]
        return emitted, matrix

    def _segments_from_tokens(
        self, tokens: list[int], timestamp_begin: int, chunk_duration: float
    ) -> list[tuple[float, float, list[int]]]:
        """Groups emitted ids into (start, end, text-token) segments."""
        segments: list[tuple[float, float, list[int]]] = []
        current_start, current_tokens = 0.0, []
        for token in tokens:
            if token >= timestamp_begin:
                stamp = (token - timestamp_begin) * 0.02
                if current_tokens:
                    segments.append((current_start, stamp, current_tokens))
                    current_tokens = []
                current_start = stamp
            else:
                current_tokens.append(token)
        if current_tokens:
            segments.append((current_start, chunk_duration, current_tokens))
        return segments

    def _interpolated_words(self, segments, chunk_offset_s: float, chunk_duration: float) -> list[TranscriptWord]:
        """Even within-segment interpolation (the fallback when alignment is off)."""
        words: list[TranscriptWord] = []
        for seg_start, seg_end, seg_tokens in segments:
            text = self.tokenizer.decode(seg_tokens).strip()
            if not text:
                continue
            parts = text.split()
            seg_start = min(seg_start, chunk_duration)
            seg_end = min(max(seg_end, seg_start + 0.02), chunk_duration)
            step = (seg_end - seg_start) / len(parts)
            for i, word in enumerate(parts):
                words.append(
                    TranscriptWord(
                        word=word,
                        start_seconds=chunk_offset_s + seg_start + i * step,
                        end_seconds=chunk_offset_s + seg_start + (i + 1) * step,
                    )
                )
        return words

    def _aligned_words(
        self,
        tokens: list[int],
        matrix: np.ndarray,
        timestamp_begin: int,
        chunk_offset_s: float,
        chunk_duration: float,
        num_frames: int,
    ) -> list[TranscriptWord]:
        """DTW word timing from the device-reduced matrix of one window."""
        from ser_tpu_torch.models.word_timing import word_timings_from_matrix

        rows = matrix[self.PREFIX_LEN : self.PREFIX_LEN + len(tokens), :num_frames]
        timed = word_timings_from_matrix(rows, tokens, self.tokenizer, timestamp_begin=timestamp_begin)
        return [
            TranscriptWord(
                word=entry.word,
                start_seconds=chunk_offset_s + min(entry.start, chunk_duration),
                end_seconds=chunk_offset_s + min(entry.end, chunk_duration),
            )
            for entry in timed
        ]

    def _chunk_text(self, tokens: list[int], timestamp_begin: int) -> str:
        return self.tokenizer.decode([token for token in tokens if token < timestamp_begin]).strip()

    def _retry_degenerate_chunks(
        self,
        states: torch.Tensor,
        language: str,
        num_frames: np.ndarray,
        emitted: list[list[int]],
        matrices: np.ndarray | None,
    ) -> tuple[list[list[int]], np.ndarray | None]:
        """Re-decodes repetitive windows with rising sampling temperature.

        Keeps each window's least degenerate candidate (lowest gzip ratio) and
        stops once no window looks degenerate or the schedule is spent.
        """
        timestamp_begin = self._special("<|0.00|>")

        def ratio(tokens: list[int]) -> float:
            return transcript_compression_ratio(self._chunk_text(tokens, timestamp_begin))

        bad = [
            index
            for index, tokens in enumerate(emitted)
            if transcript_is_degenerate(self._chunk_text(tokens, timestamp_begin))
        ]
        if not bad:
            return emitted, matrices
        best_ratio = {index: ratio(emitted[index]) for index in bad}
        for retry, temperature in enumerate(self.RETRY_TEMPERATURES):
            retry_states = states[torch.as_tensor(bad, device=states.device)]
            retry_emitted, retry_matrices = self._decode_chunk_batch(
                retry_states, language, num_frames[bad], temperature=temperature, rng_seed=retry + 1
            )
            still_bad = []
            for slot, chunk_index in enumerate(bad):
                candidate_ratio = ratio(retry_emitted[slot])
                if candidate_ratio < best_ratio[chunk_index]:
                    best_ratio[chunk_index] = candidate_ratio
                    emitted[chunk_index] = retry_emitted[slot]
                    if matrices is not None and retry_matrices is not None:
                        matrices[chunk_index] = retry_matrices[slot]
                if transcript_is_degenerate(self._chunk_text(emitted[chunk_index], timestamp_begin)):
                    still_bad.append(chunk_index)
            bad = still_bad
            if not bad:
                break
        return emitted, matrices

    def transcribe_words(
        self, audio16k: np.ndarray, *, language: str = "en", use_vad: bool = True
    ) -> list[TranscriptWord]:
        """Transcribes mono 16 kHz audio into ``TranscriptWord``s.

        All 30 s windows encode and decode as one batch. Word times come from
        DTW over the alignment heads' cross-attention; even interpolation
        within timestamp segments is the fallback when alignment is off or
        yields nothing. With ``use_vad``, leading and trailing silence is
        trimmed first and the times are shifted back to the original audio.
        """
        vad_offset_s = 0.0
        if use_vad:
            audio16k, trimmed_samples = _trim_silence(audio16k)
            vad_offset_s = trimmed_samples / SAMPLE_RATE
        if audio16k.size == 0:
            return []

        timestamp_begin = self._special("<|0.00|>")
        n_chunks = int(np.ceil(audio16k.size / CHUNK_SAMPLES))
        batch = np.zeros((n_chunks, CHUNK_SAMPLES), dtype=np.float32)
        durations = []
        for chunk_index in range(n_chunks):
            chunk = audio16k[chunk_index * CHUNK_SAMPLES : (chunk_index + 1) * CHUNK_SAMPLES]
            batch[chunk_index, : chunk.size] = chunk
            durations.append(chunk.size / SAMPLE_RATE)

        states = encode_mel_chunks(self.encoder, torch.from_numpy(batch).to(self.device))
        num_frames = np.asarray(
            [max(1, int(duration * SAMPLE_RATE) // (HOP_LENGTH * 2)) for duration in durations],
            dtype=np.int32,
        )
        emitted, matrices = self._decode_chunk_batch(states, language, num_frames)
        emitted, matrices = self._retry_degenerate_chunks(states, language, num_frames, emitted, matrices)

        words: list[TranscriptWord] = []
        for chunk_index, tokens in enumerate(emitted):
            chunk_offset_s = chunk_index * CHUNK_SECONDS
            chunk_duration = durations[chunk_index]
            aligned: list[TranscriptWord] = []
            if matrices is not None and tokens:
                aligned = self._aligned_words(
                    tokens,
                    matrices[chunk_index],
                    timestamp_begin,
                    chunk_offset_s,
                    chunk_duration,
                    int(num_frames[chunk_index]),
                )
            if aligned:
                words.extend(aligned)
            else:
                segments = self._segments_from_tokens(tokens, timestamp_begin, chunk_duration)
                words.extend(self._interpolated_words(segments, chunk_offset_s, chunk_duration))
        if vad_offset_s:
            words = [
                word._replace(
                    start_seconds=word.start_seconds + vad_offset_s,
                    end_seconds=word.end_seconds + vad_offset_s,
                )
                for word in words
            ]
        return words


def transcript_compression_ratio(text: str) -> float:
    """gzip compression ratio of the text: the published repetition signal."""
    stripped = text.strip()
    if not stripped:
        return 0.0
    raw = stripped.encode("utf-8")
    return len(raw) / max(1, len(zlib.compress(raw)))


def transcript_is_degenerate(text: str, *, max_compression_ratio: float = 2.4) -> bool:
    """Repetition detector: Whisper's 2.4 gzip-ratio decode-quality gate."""
    if len(text.strip()) < 16:
        return False
    return transcript_compression_ratio(text) > max_compression_ratio


def _trim_silence(audio: np.ndarray, *, frame: int = 512, threshold_db: float = -40.0) -> tuple[np.ndarray, int]:
    """Energy-gate VAD: trims leading and trailing frames 40 dB below the loudest.

    Returns the trimmed audio and the number of leading samples removed, by
    which decoded times shift back to the original audio.
    """
    if audio.size < frame:
        return audio, 0
    n = audio.size // frame
    energy = (audio[: n * frame].reshape(n, frame) ** 2).mean(axis=1)
    ref = float(energy.max())
    if ref <= 0:
        return audio[:0], 0
    active = 10.0 * np.log10(energy / ref + 1e-12) > threshold_db
    if not active.any():
        return audio[:0], 0
    first, last = np.flatnonzero(active)[[0, -1]]
    return audio[first * frame : (last + 1) * frame], int(first * frame)


__all__ = [
    "CHUNK_FRAMES",
    "CHUNK_SAMPLES",
    "CHUNK_SECONDS",
    "DecoderAttention",
    "DecoderBlock",
    "EncoderBlock",
    "HOP_LENGTH",
    "LayerNorm",
    "MultiHeadAttention",
    "N_FFT",
    "REMAT_POLICIES",
    "SAMPLE_RATE",
    "WhisperConfig",
    "WhisperDecoder",
    "WhisperEncoder",
    "WhisperForTranscription",
    "alignment_heads_from_hf_dir",
    "build_trainable_whisper_encoder",
    "build_whisper_decoder",
    "build_whisper_encoder",
    "encode_mel_chunks",
    "load_hf_whisper_decoder_params",
    "load_hf_whisper_encoder_params",
    "log_mel_spectrogram",
    "random_whisper_decoder_state",
    "random_whisper_encoder_state",
    "suppress_tokens_from_hf_dir",
    "transcript_compression_ratio",
    "transcript_is_degenerate",
    "whisper_config_from_hf_dir",
]
