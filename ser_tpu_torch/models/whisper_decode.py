"""KV-cached Whisper decode: greedy and beam search, alignment capture, int8 weights.

Counterpart of ``ser_tpu/models/whisper_decode.py``, on the parameters of
``ser_tpu_torch.models.whisper.WhisperDecoder``: cross-attention K/V are
computed once per call in decode-friendly layouts, and each step runs the
decoder for one token over the self-attention cache. Greedy and beam search
share the step (``_decoder_token_step``), so both carry the same numerics;
beam search flattens its beams into rows and keeps the cross-attention K/V at
one row per window (``_attend_cross_step_beamed``). Beam word timing runs a
teacher-forced second pass over the winners (``alignment_forward``). The int8
weight stream (``quantize_decode_weights``, ``SER_DECODE_INT8=1``) quantizes
the step's matmul weights once and runs each product W8A8 (``models/quant.py``).

Differences of form from the JAX package, none of numerics:

- The loops are Python loops, one step per position, in place of
  ``lax.while_loop``. The greedy loop stops at the same step: when
  ``position`` reaches ``max_len - 1`` or every row has emitted EOT (read
  back from the card once per step). The beam loop reads its stop condition
  (every window holds ``beam_size`` finished hypotheses) once every
  ``BEAM_STOP_CHECK_STEPS`` steps: once every window is full no window accepts
  another hypothesis, so the steps it runs past the JAX loop's stop change
  nothing it returns.
- The K/V caches are preallocated once per call, ``(rows, H, Dh, Smax)`` for K
  and ``(rows, H, Smax, Dh)`` for V per layer, and each step writes its new
  column in place (the JAX loop carries them as values that XLA aliases). The
  beam loop reorders them by gathering rows after each generating step, and
  skips the identity reorder of the prefix steps.
- ``position`` is a host int.
- The beam update takes the top ``K`` of the flat ``(B, K·V)`` scores with a
  stable descending sort, so among equal scores the lowest flat index wins, as
  in ``jax.lax.top_k``; ``torch.topk`` promises no order among ties.
- The route through the step kernels (``fused=True``: K3, K4 and K5 of
  ``ops/decode_step_kernels``, three calls per layer) keeps the JAX flag and
  its default (False); ``WhisperForTranscription`` passes ``fused=True`` for
  its bf16 greedy decodes (``ROADMAP.md``, Queue 3). Beam search and the int8
  stream refuse it, as in the JAX package.
- The int8 weights are quantized once per model (``DecodeWeights.quant``),
  where the JAX loops quantize once per dispatch; the bits are the same.
- Temperature sampling draws Gumbel noise from a ``torch.Generator`` seeded
  with ``rng_seed``: deterministic per seed, but not ``jax.random``'s bits.
- The JAX step's stacked-cache form (one ``(L, rows, ...)`` cache), which only
  a beam ablation harness uses, is left out (``ROADMAP.md``, Queue 3).

The port updates caches in place where the JAX package returns new arrays;
the step returns the logits and the alignment rows.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from ser_tpu_torch.models.quant import Int8Weight, dense_int8
from ser_tpu_torch.ops import decode_step_kernels as dsk
from ser_tpu_torch.ops.activations import gelu_erf

_NEG_INF = -1e30
#: The beam loop reads its stop condition from the card once every so many steps.
BEAM_STOP_CHECK_STEPS = 8


def _dense(linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)`` numerics on an ``nn.Linear``: cast, matmul, then + bias.

    The bias add is its own op, so the product rounds to ``dtype`` before it,
    as in XLA (a fused bias epilogue would round once).
    """
    y = F.linear(x.to(dtype), linear.weight.to(dtype))
    if linear.bias is not None:
        y = y + linear.bias.to(dtype)
    return y


def _project(quant_layer: dict | None, name: str, linear, dtype: torch.dtype, x: torch.Tensor) -> torch.Tensor:
    """``linear``'s product, or its int8 entry ``name``'s W8A8 product when the layer is quantized."""
    if quant_layer is not None:
        return dense_int8(quant_layer[name], x, dtype)
    return _dense(linear, x, dtype)


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


def _quant_entry(linear) -> Int8Weight:
    """An ``nn.Linear``'s (in, out) kernel and bias, quantized (``ser_tpu``'s ``_quant_entry``)."""
    return Int8Weight(linear.weight.t(), linear.bias)


@torch.inference_mode()
def quantize_decode_weights(params, qkv_fused: list[dict], n_layers: int) -> dict:
    """The decode step's matmul weights in int8 with per-output-channel scales.

    The JAX package's set: the fused QKV, the self-attention and
    cross-attention out projections, cross Q, both MLP products, and the
    vocabulary projection (``tok_embed`` transposed). LayerNorms, the
    embedding lookups and the attention cores stay in the compute dtype.
    Each entry is a ``quant.Int8Weight`` with the JAX entry's fields
    (``w8`` (K, N) int8, ``scale`` (N,) float32, ``bias``).
    """
    quant: dict = {"layers": []}
    for i, layer in enumerate(params.layers[:n_layers]):
        quant["layers"].append(
            {
                "qkv": Int8Weight(qkv_fused[i]["kernel"], qkv_fused[i]["bias"]),
                "attn_out": _quant_entry(layer.attn.out),
                "cross_q": _quant_entry(layer.cross.q),
                "cross_out": _quant_entry(layer.cross.out),
                "mlp_in": _quant_entry(layer.mlp_in),
                "mlp_out": _quant_entry(layer.mlp_out),
            }
        )
    quant["vocab"] = Int8Weight(params.tok_embed.to(torch.float32).t(), None)
    return quant


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
    the float32 vocabulary projection, (for ``fused=True``) the kernels'
    per-head weight layouts, and (for ``quant_int8``) the int8 weight stream."""

    qkv: list[dict]
    vocab: torch.Tensor
    fused: list[dict] | None = None
    quant: dict | None = None


@torch.inference_mode()
def prepare_decode_weights(params, config, *, fused: bool, quant_int8: bool = False) -> DecodeWeights:
    """The :class:`DecodeWeights` of ``params`` (a ``WhisperDecoder``)."""
    n_layers = config.decoder_layers
    qkv = _fuse_qkv_params(params, n_layers, config.d_model)
    return DecodeWeights(
        qkv=qkv,
        # The logits contract the float32 final LayerNorm with tok_embed in
        # float32, as JAX's promotion does.
        vocab=params.tok_embed.to(torch.float32),
        fused=_fused_layer_weights(params, n_layers, config.n_heads) if fused else None,
        quant=quantize_decode_weights(params, qkv, n_layers) if quant_int8 else None,
    )


def _complete_weights(params, config, weights: DecodeWeights | None, *, fused: bool, quant_int8: bool) -> DecodeWeights:
    """``weights`` with the parts this decode needs added (or prepared when None)."""
    if weights is None:
        return prepare_decode_weights(params, config, fused=fused, quant_int8=quant_int8)
    n_layers = config.decoder_layers
    if fused and weights.fused is None:
        weights = replace(weights, fused=_fused_layer_weights(params, n_layers, config.n_heads))
    if quant_int8 and weights.quant is None:
        weights = replace(weights, quant=quantize_decode_weights(params, weights.qkv, n_layers))
    return weights


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


def _attend_cross_step_beamed(q, k_t, v_hs, *, beams: int, compute_dtype):
    """Cross-attention where each window's K/V serve its ``beams`` query rows.

    ``q``: (B·beams, 1, H, Dh); ``k_t``: (B, H, Dh, S); ``v_hs``: (B, H, S, Dh).
    No per-beam copy of K/V is made (at large-v3 it would multiply the
    decode's largest buffer by ``beams``). Returns out (B·beams, H, Dh) and
    float32 weights (B·beams, H, S).
    """
    b = k_t.shape[0]
    qh = q[:, 0].reshape(b, beams, *q.shape[2:])  # (B, K, H, Dh)
    scores = torch.einsum("bkhd,bhds->bkhs", qh, k_t) / dsk.root_d(q.shape[-1], compute_dtype)
    weights = torch.softmax(scores.to(torch.float32), dim=-1)
    out = torch.einsum("bkhs,bhsd->bkhd", weights.to(compute_dtype), v_hs)
    rows = b * beams
    return out.reshape(rows, *out.shape[2:]), weights.reshape(rows, *weights.shape[2:])


def _attend(q, k, v, *, bias, compute_dtype):
    """Attention over full sequences, as ``whisper.MultiHeadAttention``'s einsum route.

    ``q`` (B, Tq, H, Dh), ``k``/``v`` (B, Tk, H, Dh); ``bias`` additive or
    None. Returns out (B, Tq, H, Dh) and float32 weights (B, H, Tq, Tk).
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / dsk.root_d(q.shape[-1], compute_dtype)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    weights = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(compute_dtype), v), weights


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
    ``beams > 1`` groups the rows by window for cross-attention (the K/V keep
    one row per window); ``quant`` (:func:`quantize_decode_weights`) runs
    every product W8A8. Both take the route through separate ops only.
    """
    if fused and beams != 1:
        raise ValueError("fused decode kernels support greedy (beams == 1) only.")
    if fused and quant is not None:
        raise ValueError("int8 decode weights are XLA-path only (fused=False).")
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
        ql = quant["layers"][i] if quant is not None else None
        h = _layer_norm(layer.attn_ln, x, eps)
        qkv = dense_int8(ql["qkv"], h, cdt) if ql is not None else _dense_kernel(weights.qkv[i], h, cdt)
        q = _split_heads(qkv[..., :d_model], n_heads)
        self_k[i][:, :, :, position] = _split_heads(qkv[:, 0, d_model : 2 * d_model], n_heads)
        self_v[i][:, :, position, :] = _split_heads(qkv[:, 0, 2 * d_model :], n_heads)
        out = _attend_self_step(q, self_k[i], self_v[i], bias_row=self_bias_row, compute_dtype=cdt)
        x = x + _project(ql, "attn_out", layer.attn.out, cdt, out.reshape(rows, 1, -1))

        h = _layer_norm(layer.cross_ln, x, eps)
        q = _split_heads(_project(ql, "cross_q", layer.cross.q, cdt, h), n_heads)
        if beams > 1:
            out, attn_weights = _attend_cross_step_beamed(q, cross_k[i], cross_v[i], beams=beams, compute_dtype=cdt)
        else:
            out, attn_weights = _attend_cross_step(q, cross_k[i], cross_v[i], compute_dtype=cdt)
        for slot, (layer_index, head_index) in enumerate(align_spec):
            if layer_index == i:
                align_rows[slot] = attn_weights[:, head_index][:, None, :]
        x = x + _project(ql, "cross_out", layer.cross.out, cdt, out.reshape(rows, 1, -1))

        h = _layer_norm(layer.mlp_ln, x, eps)
        h = gelu_erf(_project(ql, "mlp_in", layer.mlp_in, cdt, h))
        x = x + _project(ql, "mlp_out", layer.mlp_out, cdt, h)

    x = _layer_norm(params.final_ln, x, eps)
    if quant is not None:
        return dense_int8(quant["vocab"], x, torch.float32)[:, 0], align_rows
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
      quant_int8: run every product of the step W8A8 on int8 weights
        (:func:`quantize_decode_weights`); refuses ``fused``.
      weights: :func:`prepare_decode_weights` of ``params``, reused across calls.

    Returns:
      tokens ``(B, max_len)`` (prefix, then generated ids, EOT-padded),
      lengths ``(B,)`` of emitted non-EOT tokens, and align
      ``(B, n_align, max_len, S)`` float32. As in the JAX package, align rows
      past a row's own length hold the attention of repeated EOT inputs while
      the batch drains; ``reduce_alignment_matrix`` masks them.
    """
    cfg = config
    device = encoder_states.device
    batch, enc_len = encoder_states.shape[:2]
    max_len = cfg.max_target_positions
    n_heads = cfg.n_heads
    head_dim = cfg.d_model // n_heads
    cdt = compute_dtype
    n_layers = cfg.decoder_layers
    _check_align_spec(align_spec, cfg)
    weights = _complete_weights(params, cfg, weights, fused=fused, quant_int8=quant_int8)
    quant = weights.quant if quant_int8 else None

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
            config=cfg, compute_dtype=cdt, align_spec=align_spec, fused=fused, quant=quant,
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


def _reorder_caches(self_k: list[torch.Tensor], self_v: list[torch.Tensor], parent_rows: torch.Tensor) -> None:
    """Each layer's K/V cache rows gathered to follow the surviving parents (lists updated in place)."""
    for i in range(len(self_k)):
        self_k[i] = self_k[i][parent_rows]
        self_v[i] = self_v[i][parent_rows]


@torch.inference_mode()
def beam_decode_kv_cache(
    params,
    config,
    encoder_states: torch.Tensor,
    prefix,
    eot: int,
    *,
    prefix_len: int,
    beam_size: int = 5,
    length_penalty: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
    suppress_tokens: tuple[int, ...] = (),
    timestamp_begin: int | None = None,
    quant_int8: bool = False,
    weights: DecodeWeights | None = None,
):
    """Batched beam search over cached attention state (``ser_tpu``'s beam contract).

    Beams flatten into rows (``rows = B·beam_size``) and share the greedy
    step through separate ops; the cross-attention K/V keep one row per
    window. Only beam 0 starts live, the rest at -1e30 (the first-expansion
    trick). An EOT candidate, scored with its EOT log-prob, enters the
    window's finished-hypothesis pool when it would have made the live top-k;
    it never takes a live slot, so the live beam always holds ``beam_size``
    unfinished rows. A window accepts hypotheses until it holds
    ``beam_size`` of them; the loop stops when every window is full or the
    token budget ends. The winner is the pool's best by
    ``score / max(length, 1) ** length_penalty`` (GNMT), or the best live beam
    for a window that never finished. Among equal scores the lowest flat
    index wins, as in ``jax.lax.top_k``.

    Returns tokens ``(B, max_len)`` (prefix, the winner's ids, EOT-padded) and
    lengths ``(B,)``; no alignment capture (see :func:`alignment_forward`).
    """
    cfg = config
    device = encoder_states.device
    batch = encoder_states.shape[0]
    k_beams = int(beam_size)
    rows = batch * k_beams
    max_len = cfg.max_target_positions
    n_heads = cfg.n_heads
    head_dim = cfg.d_model // n_heads
    cdt = compute_dtype
    n_layers = cfg.decoder_layers
    vocab = cfg.vocab_size
    eot = int(eot)
    weights = _complete_weights(params, cfg, weights, fused=False, quant_int8=quant_int8)
    quant = weights.quant if quant_int8 else None

    cross_k, cross_v = _precompute_cross_kv(params, encoder_states, n_layers, n_heads, cdt)
    prefix_ids = torch.as_tensor(prefix, dtype=torch.long, device=device)[:prefix_len]
    tokens = torch.full((rows, max_len), eot, dtype=torch.long, device=device)
    tokens[:, :prefix_len] = prefix_ids
    self_k = [torch.zeros((rows, n_heads, head_dim, max_len), dtype=cdt, device=device) for _ in range(n_layers)]
    self_v = [torch.zeros((rows, n_heads, max_len, head_dim), dtype=cdt, device=device) for _ in range(n_layers)]
    scores = torch.tensor([0.0] + [_NEG_INF] * (k_beams - 1), dtype=torch.float32, device=device).repeat(batch)
    lengths = torch.zeros((rows,), dtype=torch.long, device=device)  # emitted tokens per live beam
    max_ts = torch.full((rows,), timestamp_begin if timestamp_begin is not None else 0, dtype=torch.long, device=device)
    best_tokens = torch.full((batch, max_len), eot, dtype=torch.long, device=device)
    best_score = torch.full((batch,), _NEG_INF, dtype=torch.float32, device=device)  # length-normalized
    best_length = torch.zeros((batch,), dtype=torch.long, device=device)
    n_finished = torch.zeros((batch,), dtype=torch.long, device=device)
    suppress = torch.as_tensor(suppress_tokens, dtype=torch.long, device=device) if suppress_tokens else None
    window_rows = torch.arange(batch, device=device) * k_beams

    def length_norm(length: torch.Tensor) -> torch.Tensor:
        return torch.clamp(length.to(torch.float32), min=1.0) ** length_penalty

    position = 0
    while position < max_len - 1:
        if position % BEAM_STOP_CHECK_STEPS == 0 and bool((n_finished >= k_beams).all()):
            break
        token_ids = tokens[:, position]
        logits, _ = _decoder_token_step(
            params, weights, cross_k, cross_v, self_k, self_v, token_ids, position,
            config=cfg, compute_dtype=cdt, beams=k_beams, quant=quant,
        )
        if suppress is not None:
            logits[:, suppress] = _NEG_INF
        if timestamp_begin is not None:
            logits = apply_timestamp_rules(
                logits,
                last_token=token_ids,
                penultimate_token=tokens[:, max(position - 1, 0)],
                max_timestamp=max_ts,
                generated_count=torch.full((rows,), max(position + 1 - prefix_len, 0), device=device),
                eot=eot,
                timestamp_begin=timestamp_begin,
            )
        generating = position + 1 >= prefix_len
        if generating:
            logprobs = torch.log_softmax(logits, dim=-1)
            scores3 = scores.view(batch, k_beams)
            lp3 = logprobs.view(batch, k_beams, vocab)
            eot_scores = scores3 + lp3[:, :, eot]  # finished candidates, scored with the EOT log-prob
            live = scores3[:, :, None] + lp3
            live[:, :, eot] = _NEG_INF
            ranked, order = torch.sort(live.view(batch, k_beams * vocab), dim=-1, descending=True, stable=True)
            top_scores, top_idx = ranked[:, :k_beams], order[:, :k_beams]
            # An EOT candidate is a finished hypothesis iff it would have made the live top-k.
            would_select = eot_scores > top_scores[:, k_beams - 1 :]
            lengths3 = lengths.view(batch, k_beams)
            cand_norm = torch.where(would_select, eot_scores / length_norm(lengths3), _NEG_INF)
            best_cand = torch.argmax(cand_norm, dim=1, keepdim=True)
            best_cand_score = cand_norm.gather(1, best_cand)[:, 0]
            # A window stops accepting once it holds beam_size hypotheses, so its
            # transcript does not depend on how long the other windows run.
            accepting = n_finished < k_beams
            improved = (best_cand_score > best_score) & accepting
            cand_tokens = tokens[window_rows + best_cand[:, 0]]
            cand_tokens[:, position + 1] = eot
            best_tokens = torch.where(improved[:, None], cand_tokens, best_tokens)
            best_score = torch.where(improved, best_cand_score, best_score)
            best_length = torch.where(improved, lengths3.gather(1, best_cand)[:, 0], best_length)
            n_finished = n_finished + torch.where(accepting, would_select.sum(dim=1), 0)

            parent_rows = (top_idx // vocab + window_rows[:, None]).reshape(rows)
            next_token = (top_idx % vocab).reshape(rows)
            scores = top_scores.reshape(rows)
            # Every per-beam carry follows its surviving parent.
            tokens = tokens[parent_rows]
            lengths = lengths[parent_rows] + 1  # live beams never carry EOT: every write lengthens
            max_ts = max_ts[parent_rows]
            _reorder_caches(self_k, self_v, parent_rows)
            tokens[:, position + 1] = next_token
            if timestamp_begin is not None:
                max_ts = torch.where(next_token >= timestamp_begin, torch.maximum(max_ts, next_token), max_ts)
        else:
            tokens[:, position + 1] = prefix_ids[min(position + 1, prefix_len - 1)]
        position += 1

    live_best = torch.argmax((scores / length_norm(lengths)).view(batch, k_beams), dim=1)
    live_rows = window_rows + live_best
    has_finished = n_finished > 0
    out_tokens = torch.where(has_finished[:, None], best_tokens, tokens[live_rows])
    out_lengths = torch.where(has_finished, best_length, lengths[live_rows])
    return out_tokens, out_lengths


@torch.inference_mode()
def alignment_forward(
    params,
    config,
    encoder_states: torch.Tensor,
    tokens: torch.Tensor,
    *,
    align_spec: tuple[tuple[int, int], ...],
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Teacher-forced cross-attention capture over decoded tokens, in one pass.

    Beam word timing re-runs the decoder once over the winning rows with
    full causal attention and records the alignment heads' cross-attention
    (the beam loop keeps no per-beam capture). Returns ``(B, n_align, L, S)``
    float32 probabilities over the whole padded token axis; rows past a
    sequence's length attend over padding and ``reduce_alignment_matrix``
    masks them.
    """
    cfg = config
    cdt = compute_dtype
    n_heads = cfg.n_heads
    eps = cfg.layer_norm_eps
    batch, seq_len = tokens.shape
    _check_align_spec(align_spec, cfg)
    x = params.tok_embed[tokens] + params.pos_embed[None, :seq_len]
    causal = torch.ones((seq_len, seq_len), dtype=torch.bool, device=tokens.device).tril()
    self_bias = torch.where(causal, 0.0, _NEG_INF)[None, None]
    captured: list[torch.Tensor | None] = [None] * len(align_spec)
    for i, layer in enumerate(params.layers[: cfg.decoder_layers]):
        h = _layer_norm(layer.attn_ln, x, eps)
        q, k, v = (_split_heads(_dense(lin, h, cdt), n_heads) for lin in (layer.attn.q, layer.attn.k, layer.attn.v))
        out, _ = _attend(q, k, v, bias=self_bias, compute_dtype=cdt)
        x = x + _dense(layer.attn.out, out.reshape(batch, seq_len, -1), cdt)

        h = _layer_norm(layer.cross_ln, x, eps)
        q = _split_heads(_dense(layer.cross.q, h, cdt), n_heads)
        ck = _split_heads(_dense(layer.cross.k, encoder_states, cdt), n_heads)
        cv = _split_heads(_dense(layer.cross.v, encoder_states, cdt), n_heads)
        out, attn_weights = _attend(q, ck, cv, bias=None, compute_dtype=cdt)
        for slot, (layer_index, head_index) in enumerate(align_spec):
            if layer_index == i:
                captured[slot] = attn_weights[:, head_index]
        x = x + _dense(layer.cross.out, out.reshape(batch, seq_len, -1), cdt)

        h = _layer_norm(layer.mlp_ln, x, eps)
        x = x + _dense(layer.mlp_out, gelu_erf(_dense(layer.mlp_in, h, cdt)), cdt)
    return torch.stack(captured, dim=1)


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
    "BEAM_STOP_CHECK_STEPS",
    "DecodeWeights",
    "alignment_forward",
    "apply_timestamp_rules",
    "beam_decode_kv_cache",
    "default_alignment_spec",
    "greedy_decode_kv_cache",
    "prepare_decode_weights",
    "quantize_decode_weights",
    "reduce_alignment_matrix",
]
