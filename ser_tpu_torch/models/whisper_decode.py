"""KV-cached greedy Whisper decode with cross-attention alignment capture.

Counterpart of ``ser_tpu/models/whisper_decode.py`` for the greedy route, on
the parameters of ``ser_tpu_torch.models.whisper.WhisperDecoder``:
cross-attention K/V are computed once per call in decode-friendly layouts,
and each step runs the decoder for one token over the self-attention cache.

Differences of form from the JAX package, none of numerics:

- The loop is a Python loop, one step per position, in place of
  ``lax.while_loop``. It stops at the same step: when ``position`` reaches
  ``max_len - 1`` or every row has emitted EOT (read back from the card once
  per step).
- The K/V caches are preallocated once per call, ``(rows, H, Dh, Smax)`` for K
  and ``(rows, H, Smax, Dh)`` for V per layer, and each step writes its new
  column in place (the JAX loop carries them as values that XLA aliases).
- ``position`` is a host int.
- The route through the step kernels (``fused=True``: K3, K4 and K5 of
  ``ops/decode_step_kernels``, three calls per layer) keeps the JAX flag and
  its default (False); ``WhisperForTranscription`` passes ``fused=True`` for
  its greedy decodes (``ROADMAP.md``, Queue 3).
- Temperature sampling draws Gumbel noise from a ``torch.Generator`` seeded
  with ``rng_seed``: deterministic per seed, but not ``jax.random``'s bits.

Beam decode, ``alignment_forward`` and the int8 weight stream are not ported
yet: ``beams > 1`` and ``quant_int8`` raise ``NotImplementedError``.

The port updates caches in place where the JAX package returns new arrays;
the step returns the logits and the alignment rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ser_tpu_torch.ops import decode_step_kernels as dsk
from ser_tpu_torch.ops.activations import gelu_erf

_NEG_INF = -1e30


def _dense(linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)`` numerics on an ``nn.Linear``: cast, matmul, then + bias.

    The bias add is its own op, so the product rounds to ``dtype`` before it,
    as in XLA (a fused bias epilogue would round once).
    """
    y = F.linear(x.to(dtype), linear.weight.to(dtype))
    if linear.bias is not None:
        y = y + linear.bias.to(dtype)
    return y


def _dense_kernel(p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``_dense`` over an (in, out) kernel and its bias (the fused QKV projection)."""
    return torch.matmul(x.to(dtype), p["kernel"].to(dtype)) + p["bias"].to(dtype)


def _layer_norm(norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax ``nn.LayerNorm`` numerics (fast-variance form) in float32, with ``norm``'s affine."""
    return dsk.ln_f32(x, norm.weight, norm.bias, eps)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n_heads, x.shape[-1] // n_heads)


def apply_timestamp_rules(
    logits: torch.Tensor,
    *,
    last_token: torch.Tensor,
    penultimate_token: torch.Tensor,
    max_timestamp: torch.Tensor,
    generated_count: torch.Tensor,
    eot: int,
    timestamp_begin: int,
    max_initial_timestamp_index: int = 50,
) -> torch.Tensor:
    """Whisper's timestamp decoding constraints over one step's (B, V) logits.

    The same four rules as ``ser_tpu``'s (the published logits processor):
    timestamps come in pairs (a missing penultimate token counts as a
    timestamp); timestamps never decrease, and strictly increase unless a
    pair is being closed; the first generated token is a timestamp no later
    than ``max_initial_timestamp_index`` and ``<|notimestamps|>`` is always
    masked; when the summed timestamp probability beats the best other token,
    the step must emit a timestamp. Returns masked logits.
    """
    vocab = logits.shape[-1]
    neg = _NEG_INF
    token_ids = torch.arange(vocab, device=logits.device)
    is_ts_col = (token_ids >= timestamp_begin)[None, :]
    is_text_col = (token_ids < eot)[None, :]

    has_last = (generated_count >= 1)[:, None]
    has_penult = (generated_count >= 2)[:, None]
    last_is_ts = has_last & (last_token >= timestamp_begin)[:, None]
    penult_is_ts = ~has_penult | (penultimate_token >= timestamp_begin)[:, None]

    logits = torch.where((token_ids == timestamp_begin - 1)[None, :], neg, logits)
    closing = last_is_ts & ~penult_is_ts
    closed = last_is_ts & penult_is_ts
    logits = torch.where(closed & is_ts_col, neg, logits)
    logits = torch.where(closing & is_text_col, neg, logits)
    cut = max_timestamp[:, None] + torch.where(closing, 0, 1)
    below = is_ts_col & (token_ids[None, :] < cut)
    logits = torch.where(has_last & below, neg, logits)
    first = (generated_count == 0)[:, None]
    too_late = token_ids[None, :] > timestamp_begin + max_initial_timestamp_index
    logits = torch.where(first & (~is_ts_col | too_late), neg, logits)
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ts_logprob = torch.logsumexp(torch.where(is_ts_col, logprobs, -torch.inf), dim=-1)
    max_below_logprob = torch.max(torch.where(~is_ts_col, logprobs, -torch.inf), dim=-1).values
    force_ts = (ts_logprob > max_below_logprob)[:, None]
    return torch.where(force_ts & ~is_ts_col, neg, logits)


def _precompute_cross_kv(params, encoder_states: torch.Tensor, n_layers: int, n_heads: int, cdt):
    """Per-layer cross-attention K ``(B, H, Dh, S)`` and V ``(B, H, S, Dh)``, once per call."""
    cross_k, cross_v = [], []
    for layer in params.layers[:n_layers]:
        k = _split_heads(_dense(layer.cross.k, encoder_states, cdt), n_heads)
        v = _split_heads(_dense(layer.cross.v, encoder_states, cdt), n_heads)
        cross_k.append(k.permute(0, 2, 3, 1).contiguous())
        cross_v.append(v.permute(0, 2, 1, 3).contiguous())
    return cross_k, cross_v


def _fuse_qkv_params(params, n_layers: int, d_model: int) -> list[dict]:
    """Concatenated self-attention Q|K|V projections, one (d, 3d) (in, out) kernel per layer.

    Output columns are independent dot products, so the fused product equals
    the three separate ones. Whisper's ``k`` has no bias: zeros stand in.
    """
    fused = []
    for layer in params.layers[:n_layers]:
        attn = layer.attn
        kernel = torch.cat([attn.q.weight.t(), attn.k.weight.t(), attn.v.weight.t()], dim=1).contiguous()
        zero = torch.zeros((d_model,), dtype=kernel.dtype, device=kernel.device)
        biases = [lin.bias if lin.bias is not None else zero for lin in (attn.q, attn.k, attn.v)]
        fused.append({"kernel": kernel, "bias": torch.cat(biases)})
    return fused


def _zero_bias(linear) -> torch.Tensor:
    if linear.bias is not None:
        return linear.bias
    return torch.zeros(linear.weight.shape[0], dtype=linear.weight.dtype, device=linear.weight.device)


def _fused_layer_weights(params, n_layers: int, n_heads: int) -> list[dict]:
    """Per-layer operands of K3, K4 and K5 in the layouts the kernels read."""
    layers = []
    for layer in params.layers[:n_layers]:
        w_q, b_q = dsk.per_head_q_proj(layer.cross.q.weight.t(), _zero_bias(layer.cross.q), n_heads)
        layers.append(
            {
                "attn_ln": (layer.attn_ln.weight[None, :], layer.attn_ln.bias[None, :]),
                "cross_ln": (layer.cross_ln.weight[None, :], layer.cross_ln.bias[None, :]),
                "w_out_self": dsk.per_head_out_proj(layer.attn.out.weight.t().contiguous(), n_heads),
                "b_out_self": _zero_bias(layer.attn.out)[None, :],
                "w_q_cross": w_q,
                "b_q_cross": b_q,
                "w_out_cross": dsk.per_head_out_proj(layer.cross.out.weight.t().contiguous(), n_heads),
                "b_out_cross": _zero_bias(layer.cross.out)[None, :],
            }
        )
    return layers


@dataclass
class DecodeWeights:
    """What one model's decodes reuse, computed once: the fused QKV kernels,
    the float32 vocabulary projection, and (for ``fused=True``) the kernels'
    per-head weight layouts."""

    qkv: list[dict]
    vocab: torch.Tensor
    fused: list[dict] | None = None


@torch.inference_mode()
def prepare_decode_weights(params, config, *, fused: bool) -> DecodeWeights:
    """The :class:`DecodeWeights` of ``params`` (a ``WhisperDecoder``)."""
    n_layers = config.decoder_layers
    return DecodeWeights(
        qkv=_fuse_qkv_params(params, n_layers, config.d_model),
        # The logits contract the float32 final LayerNorm with tok_embed in
        # float32, as JAX's promotion does.
        vocab=params.tok_embed.to(torch.float32),
        fused=_fused_layer_weights(params, n_layers, config.n_heads) if fused else None,
    )


def _attend_self_step(q, k_t, v_hs, *, bias_row, compute_dtype):
    """Single-query causal self-attention over the (rows, H, Dh, Smax) / (rows, H, Smax, Dh) cache."""
    qh = q[:, 0]
    scores = torch.einsum("bhd,bhds->bhs", qh, k_t) / dsk.root_d(q.shape[-1], compute_dtype)
    scores = scores + bias_row[None, None, :].to(scores.dtype)
    weights = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhs,bhsd->bhd", weights.to(compute_dtype), v_hs)


def _attend_cross_step(q, k_t, v_hs, *, compute_dtype):
    """Single-query cross-attention; returns out (rows, H, Dh) and float32 weights (rows, H, S)."""
    qh = q[:, 0]
    scores = torch.einsum("bhd,bhds->bhs", qh, k_t) / dsk.root_d(q.shape[-1], compute_dtype)
    weights = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhs,bhsd->bhd", weights.to(compute_dtype), v_hs), weights


def _check_align_spec(align_spec, config) -> None:
    for layer_index, head_index in align_spec:
        if not (0 <= layer_index < config.decoder_layers and 0 <= head_index < config.n_heads):
            raise ValueError(
                f"align_spec pair ({layer_index}, {head_index}) is out of range "
                f"for a {config.decoder_layers}-layer, {config.n_heads}-head decoder."
            )


def _decoder_token_step(
    params,
    weights: DecodeWeights,
    cross_k: list[torch.Tensor],
    cross_v: list[torch.Tensor],
    self_k: list[torch.Tensor],
    self_v: list[torch.Tensor],
    token_ids: torch.Tensor,
    position: int,
    *,
    config,
    compute_dtype,
    align_spec: tuple[tuple[int, int], ...] = (),
    beams: int = 1,
    fused: bool = False,
    quant: dict | None = None,
) -> tuple[torch.Tensor, list[torch.Tensor | None]]:
    """One decoder forward for the token at ``position`` over the cached state.

    Writes the new K/V columns into ``self_k``/``self_v`` in place. Returns
    float32 logits ``(rows, V)`` and the alignment rows ``(rows, 1, S)``, one
    per ``align_spec`` pair. ``fused=True`` runs each layer's attention groups
    through K3, K4 and K5 (same op order and rounding points as the route
    through separate PyTorch ops); K3 then writes the K/V columns itself.
    """
    if beams != 1:
        raise NotImplementedError("Beam decode is not ported to ser_tpu_torch yet; see ROADMAP.md.")
    if quant is not None:
        raise NotImplementedError("The int8 decode weight stream is not ported to ser_tpu_torch yet; see ROADMAP.md.")
    cfg = config
    cdt = compute_dtype
    n_heads = cfg.n_heads
    eps = cfg.layer_norm_eps
    d_model = cfg.d_model
    rows = token_ids.shape[0]
    _check_align_spec(align_spec, cfg)
    align_rows: list[torch.Tensor | None] = [None] * len(align_spec)
    layers = params.layers[: cfg.decoder_layers]
    x = params.tok_embed[token_ids] + params.pos_embed[position]  # (rows, d)

    if fused:
        if weights.fused is None:
            raise ValueError("fused=True needs DecodeWeights prepared with fused=True.")
        for i, layer in enumerate(layers):
            fw = weights.fused[i]
            q_heads = dsk.ln_qkv_project_to_cache(
                x, *fw["attn_ln"], weights.qkv[i]["kernel"], weights.qkv[i]["bias"][None, :], self_k[i], self_v[i],
                position, eps=eps,
            ).reshape(rows, n_heads, -1)
            x = dsk.self_attend_and_out(q_heads, self_k[i], self_v[i], fw["w_out_self"], fw["b_out_self"], x, position)
            x, attn_weights = dsk.cross_attention_step(
                x, *fw["cross_ln"], fw["w_q_cross"], fw["b_q_cross"], cross_k[i], cross_v[i],
                fw["w_out_cross"], fw["b_out_cross"], eps=eps,
            )
            for slot, (layer_index, head_index) in enumerate(align_spec):
                if layer_index == i:
                    align_rows[slot] = attn_weights[head_index][:, None, :]  # head-major (H, R, S)
            h = _layer_norm(layer.mlp_ln, x[:, None, :], eps)
            h = gelu_erf(_dense(layer.mlp_in, h, cdt))
            x = x + _dense(layer.mlp_out, h, cdt)[:, 0, :]
        x = _layer_norm(params.final_ln, x, eps)
        return torch.matmul(x, weights.vocab.t()), align_rows

    x = x[:, None, :]  # (rows, 1, d)
    key_visible = torch.arange(cfg.max_target_positions, device=x.device) <= position
    self_bias_row = torch.where(key_visible, 0.0, _NEG_INF)
    for i, layer in enumerate(layers):
        h = _layer_norm(layer.attn_ln, x, eps)
        qkv = _dense_kernel(weights.qkv[i], h, cdt)
        q = _split_heads(qkv[..., :d_model], n_heads)
        self_k[i][:, :, :, position] = _split_heads(qkv[:, 0, d_model : 2 * d_model], n_heads)
        self_v[i][:, :, position, :] = _split_heads(qkv[:, 0, 2 * d_model :], n_heads)
        out = _attend_self_step(q, self_k[i], self_v[i], bias_row=self_bias_row, compute_dtype=cdt)
        x = x + _dense(layer.attn.out, out.reshape(rows, 1, -1), cdt)

        h = _layer_norm(layer.cross_ln, x, eps)
        q = _split_heads(_dense(layer.cross.q, h, cdt), n_heads)
        out, attn_weights = _attend_cross_step(q, cross_k[i], cross_v[i], compute_dtype=cdt)
        for slot, (layer_index, head_index) in enumerate(align_spec):
            if layer_index == i:
                align_rows[slot] = attn_weights[:, head_index][:, None, :]
        x = x + _dense(layer.cross.out, out.reshape(rows, 1, -1), cdt)

        h = _layer_norm(layer.mlp_ln, x, eps)
        h = gelu_erf(_dense(layer.mlp_in, h, cdt))
        x = x + _dense(layer.mlp_out, h, cdt)

    x = _layer_norm(params.final_ln, x, eps)
    return torch.matmul(x[:, 0], weights.vocab.t()), align_rows


@torch.inference_mode()
def greedy_decode_kv_cache(
    params,
    config,
    encoder_states: torch.Tensor,
    prefix,
    eot: int,
    *,
    prefix_len: int,
    align_spec: tuple[tuple[int, int], ...] = (),
    compute_dtype: torch.dtype = torch.float32,
    temperature: float = 0.0,
    rng_seed: int = 0,
    suppress_tokens: tuple[int, ...] = (),
    timestamp_begin: int | None = None,
    fused: bool = False,
    quant_int8: bool = False,
    weights: DecodeWeights | None = None,
):
    """Batched greedy decode over cached attention state.

    Args:
      params: a ``WhisperDecoder`` (its parameters are read, not its forward).
      config: ``WhisperConfig``; ``max_target_positions`` sets the token
        budget and the cache length (it may be below the position table's).
      encoder_states: ``(B, S, d)``; each row decodes with its own done flag.
      prefix: the ``prefix_len`` task-prefix ids, shared by the batch.
      eot: the end-of-text id.
      align_spec: ``((layer, head), ...)`` pairs whose cross-attention
        probabilities are recorded per decoded position.
      temperature: 0 decodes by argmax; above 0 samples from
        ``softmax(logits / temperature)`` with Gumbel noise from a generator
        seeded by ``rng_seed``.
      suppress_tokens: ids masked at every step.
      timestamp_begin: first timestamp id; when given, the timestamp rules
        apply (:func:`apply_timestamp_rules`).
      fused: run the attention groups through kernels K3, K4 and K5.
      weights: :func:`prepare_decode_weights` of ``params``, reused across calls.

    Returns:
      tokens ``(B, max_len)`` (prefix, then generated ids, EOT-padded),
      lengths ``(B,)`` of emitted non-EOT tokens, and align
      ``(B, n_align, max_len, S)`` float32. As in the JAX package, align rows
      past a row's own length hold the attention of repeated EOT inputs while
      the batch drains; ``reduce_alignment_matrix`` masks them.
    """
    if quant_int8:
        raise NotImplementedError("The int8 decode weight stream is not ported to ser_tpu_torch yet; see ROADMAP.md.")
    cfg = config
    device = encoder_states.device
    batch, enc_len = encoder_states.shape[:2]
    max_len = cfg.max_target_positions
    n_heads = cfg.n_heads
    head_dim = cfg.d_model // n_heads
    cdt = compute_dtype
    n_layers = cfg.decoder_layers
    _check_align_spec(align_spec, cfg)
    if weights is None or (fused and weights.fused is None):
        weights = prepare_decode_weights(params, cfg, fused=fused)

    cross_k, cross_v = _precompute_cross_kv(params, encoder_states, n_layers, n_heads, cdt)
    tokens = torch.full((batch, max_len), int(eot), dtype=torch.long, device=device)
    tokens[:, :prefix_len] = torch.as_tensor(prefix, dtype=torch.long, device=device)[:prefix_len]
    self_k = [torch.zeros((batch, n_heads, head_dim, max_len), dtype=cdt, device=device) for _ in range(n_layers)]
    self_v = [torch.zeros((batch, n_heads, max_len, head_dim), dtype=cdt, device=device) for _ in range(n_layers)]
    align = torch.zeros((batch, len(align_spec), max_len, enc_len), dtype=torch.float32, device=device)
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    max_ts = torch.full((batch,), timestamp_begin if timestamp_begin is not None else 0, dtype=torch.long, device=device)
    suppress = torch.as_tensor(suppress_tokens, dtype=torch.long, device=device) if suppress_tokens else None
    generator = torch.Generator(device=device).manual_seed(int(rng_seed)) if temperature > 0.0 else None

    position = 0
    while position < max_len - 1 and not bool(done.all()):
        token_ids = tokens[:, position]
        logits, align_rows = _decoder_token_step(
            params, weights, cross_k, cross_v, self_k, self_v, token_ids, position,
            config=cfg, compute_dtype=cdt, align_spec=align_spec, fused=fused,
        )
        for slot, row in enumerate(align_rows):
            align[:, slot, position] = row[:, 0]
        if suppress is not None:
            logits[:, suppress] = _NEG_INF
        if timestamp_begin is not None:
            logits = apply_timestamp_rules(
                logits,
                last_token=token_ids,
                penultimate_token=tokens[:, max(position - 1, 0)],
                max_timestamp=max_ts,
                generated_count=torch.full((batch,), max(position + 1 - prefix_len, 0), device=device),
                eot=int(eot),
                timestamp_begin=timestamp_begin,
            )
        if generator is not None:
            uniform = torch.rand(logits.shape, generator=generator, device=device).clamp_min(1e-20)
            next_token = torch.argmax(logits / temperature - torch.log(-torch.log(uniform)), dim=-1)
        else:
            next_token = torch.argmax(logits, dim=-1)
        if position + 1 >= prefix_len:
            write = torch.where(done, tokens[:, position + 1], next_token)
            tokens[:, position + 1] = write
            if timestamp_begin is not None:
                wrote_ts = ~done & (write >= timestamp_begin)
                max_ts = torch.where(wrote_ts, torch.maximum(max_ts, write), max_ts)
            done = done | (write == eot)
        position += 1

    generated = tokens[:, prefix_len:]
    is_eot = generated == eot
    lengths = torch.where(is_eot.any(dim=1), torch.argmax(is_eot.to(torch.int32), dim=1), generated.shape[1])
    return tokens, lengths, align


@torch.inference_mode()
def reduce_alignment_matrix(
    align: torch.Tensor,
    token_counts: torch.Tensor,
    num_frames: torch.Tensor,
    *,
    prefix_len: int,
    medfilt_width: int = 7,
) -> torch.Tensor:
    """Per-head attention ``(B, n_heads, max_len, S)`` → one DTW cost matrix ``(B, max_len, S)``, on the device.

    The JAX package's reduction, step for step: mask frames past
    ``num_frames`` and renormalize; standardize over the valid token rows
    (``prefix_len ≤ row < min(token_counts, max_len - 1)``); reflect at each
    row's valid frame boundary; median-filter along frames; mean over heads.
    """
    batch, _, max_len, enc_len = align.shape
    device = align.device
    frame_ok = torch.arange(enc_len, device=device)[None, None, None, :] < num_frames[:, None, None, None]
    weights = torch.where(frame_ok, align, 0.0)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-12)
    rows = torch.arange(max_len, device=device)[None, :]
    row_ok = (rows >= prefix_len) & (rows < torch.clamp(token_counts, max=max_len - 1)[:, None])
    mask = row_ok[:, None, :, None].to(weights.dtype)
    count = torch.clamp(mask.sum(dim=2, keepdim=True), min=1.0)
    mean = (weights * mask).sum(dim=2, keepdim=True) / count
    var = ((weights - mean) ** 2 * mask).sum(dim=2, keepdim=True) / count
    weights = (weights - mean) / (torch.sqrt(var) + 1e-9)
    half = medfilt_width // 2
    col = torch.arange(enc_len, device=device)[None, :]
    boundary = num_frames.to(device)[:, None]
    reflected = torch.where(col >= boundary, torch.clamp(2 * boundary - 2 - col, 0, enc_len - 1), col)
    weights = torch.gather(weights, -1, reflected[:, None, None, :].expand(weights.shape))
    # Reflect padding of ``half`` columns at both ends (numpy's "reflect": the edge is not repeated).
    padded_cols = torch.arange(-half, enc_len + half, device=device).abs()
    padded_cols = torch.where(padded_cols >= enc_len, 2 * (enc_len - 1) - padded_cols, padded_cols)
    padded = weights[..., padded_cols]
    stacked = torch.stack([padded[..., k : k + enc_len] for k in range(medfilt_width)], dim=-1)
    weights = torch.sort(stacked, dim=-1).values[..., half]
    return weights.mean(dim=1)


def default_alignment_spec(decoder_layers: int, n_heads: int, *, max_pairs: int = 32) -> tuple[tuple[int, int], ...]:
    """Fallback alignment heads when a checkpoint publishes none: every head of
    the upper half of the decoder, subsampled evenly to ``max_pairs``."""
    pairs = [(layer, head) for layer in range(decoder_layers // 2, decoder_layers) for head in range(n_heads)]
    if len(pairs) > max_pairs:
        stride = len(pairs) / max_pairs
        pairs = [pairs[int(i * stride)] for i in range(max_pairs)]
    return tuple(pairs)


__all__ = [
    "DecodeWeights",
    "apply_timestamp_rules",
    "default_alignment_spec",
    "greedy_decode_kv_cache",
    "prepare_decode_weights",
    "reduce_alignment_matrix",
]
