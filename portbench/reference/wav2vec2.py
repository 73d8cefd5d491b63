"""Plain reference of the wav2vec2 / XLS-R encoder's path, chunk by chunk.

Follows the published model (fairseq's wav2vec2 with ``layer_norm_first``, Hugging
Face's ``Wav2Vec2`` with ``do_stable_layer_norm`` and ``feat_extract_norm="layer"``):
seven strided convolutions, each followed by a LayerNorm over channels and GELU; a
LayerNorm and a projection to the hidden size; a grouped positional convolution
(kernel 128, padding 64, the last output dropped) whose GELU is added; pre-norm
transformer layers; a final LayerNorm. Float32 with TF32 off.

Each chunk of at most 30 s is encoded alone at its own length, so no frame of it is
padding: that is the result the port's bucketed, masked batches must give on their
valid frames. A chunk's frames cover its duration evenly.

The weights are those of the port's seeded random init: a ``torch.Generator`` on the
device, seeded as in ``whisper.init_seed``, drawing a standard normal over
sqrt(fan in) for each tensor of more than one dimension in the order below, zero
biases and unit LayerNorm scales.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CHUNK_SAMPLES = 30 * 16000


def parameter_shapes(cfg: dict) -> list[tuple[str, tuple[int, ...]]]:
    """The encoder's tensors in the order the port's init draws them."""
    d, ffn, convs = cfg["hidden_size"], cfg["intermediate_size"], cfg["conv_dim"]
    channels = (1, *convs)
    shapes = []
    for i, (dim, kernel) in enumerate(zip(convs, cfg["conv_kernel"])):
        shapes += [(f"feature_encoder.conv.{i}.weight", (dim, channels[i], kernel)), (f"feature_encoder.conv.{i}.bias", (dim,))]
    for i, dim in enumerate(convs):
        shapes += [(f"feature_encoder.conv_ln.{i}.weight", (dim,)), (f"feature_encoder.conv_ln.{i}.bias", (dim,))]
    groups, k = cfg["num_conv_pos_embedding_groups"], cfg["num_conv_pos_embeddings"]
    shapes += [
        ("feature_ln.weight", (convs[-1],)), ("feature_ln.bias", (convs[-1],)),
        ("feature_projection.weight", (d, convs[-1])), ("feature_projection.bias", (d,)),
        ("pos_embed.pos_conv.weight", (d, d // groups, k)), ("pos_embed.pos_conv.bias", (d,)),
        ("encoder_final_ln.weight", (d,)), ("encoder_final_ln.bias", (d,)),
    ]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        shapes += [(p + "attn_ln.weight", (d,)), (p + "attn_ln.bias", (d,))]
        for name in ("q", "k", "v", "attn_out"):
            shapes += [(p + f"{name}.weight", (d, d)), (p + f"{name}.bias", (d,))]
        shapes += [
            (p + "ffn_ln.weight", (d,)), (p + "ffn_ln.bias", (d,)),
            (p + "ffn_in.weight", (ffn, d)), (p + "ffn_in.bias", (ffn,)),
            (p + "ffn_out.weight", (d, ffn)), (p + "ffn_out.bias", (d,)),
        ]
    return shapes


def draw_weights(cfg: dict, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """float32 weights as the port's seeded init draws them on ``device``."""
    generator = torch.Generator(device=device).manual_seed(seed)
    weights = {}
    for name, shape in parameter_shapes(cfg):
        if name.endswith(".bias"):
            weights[name] = torch.zeros(shape, device=device)
        elif len(shape) == 1:
            weights[name] = torch.ones(shape, device=device)
        else:
            weights[name] = torch.randn(shape, generator=generator, device=device) / math.sqrt(math.prod(shape[1:]))
    return weights


def encode_chunk(samples: torch.Tensor, w: dict[str, torch.Tensor], cfg: dict, product=F.linear) -> torch.Tensor:
    """(S,) float32 samples → (T, d) float32 states. ``product(x, weight, bias)`` computes the
    transformer layers' projections (a lower-precision one makes the control)."""
    eps, d, heads = cfg["layer_norm_eps"], cfg["hidden_size"], cfg["num_attention_heads"]
    x = samples[None, None, :].float()
    for i, stride in enumerate(cfg["conv_stride"]):
        x = F.conv1d(x, w[f"feature_encoder.conv.{i}.weight"], w[f"feature_encoder.conv.{i}.bias"], stride=stride)
        x = F.layer_norm(x.transpose(1, 2), (x.shape[1],), w[f"feature_encoder.conv_ln.{i}.weight"],
                         w[f"feature_encoder.conv_ln.{i}.bias"], eps).transpose(1, 2)
        x = F.gelu(x)
    x = x[0].T
    x = F.layer_norm(x, (x.shape[1],), w["feature_ln.weight"], w["feature_ln.bias"], eps)
    x = F.linear(x, w["feature_projection.weight"], w["feature_projection.bias"])
    k = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.T[None], w["pos_embed.pos_conv.weight"], w["pos_embed.pos_conv.bias"], padding=k // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])[0].T
    x = x + F.gelu(pos[: x.shape[0]])
    seq = x.shape[0]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        h = F.layer_norm(x, (d,), w[p + "attn_ln.weight"], w[p + "attn_ln.bias"], eps)
        q, k_, v = (product(h, w[p + f"{n}.weight"], w[p + f"{n}.bias"]).view(seq, heads, -1).transpose(0, 1)
                    for n in ("q", "k", "v"))
        scores = (q @ k_.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        attended = (torch.softmax(scores, dim=-1) @ v).transpose(0, 1).reshape(seq, d)
        x = x + product(attended, w[p + "attn_out.weight"], w[p + "attn_out.bias"])
        h = F.layer_norm(x, (d,), w[p + "ffn_ln.weight"], w[p + "ffn_ln.bias"], eps)
        x = x + product(F.gelu(product(h, w[p + "ffn_in.weight"], w[p + "ffn_in.bias"])),
                        w[p + "ffn_out.weight"], w[p + "ffn_out.bias"])
    return F.layer_norm(x, (d,), w["encoder_final_ln.weight"], w["encoder_final_ln.bias"], eps)


def frame_states(audio16k: np.ndarray, w: dict[str, torch.Tensor], cfg: dict, device: torch.device,
                 product=F.linear) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(states (N, d) float32, frame starts, frame ends) of a clip at 16 kHz, 30 s chunks."""
    kept = []
    for start, length, _ in chunks(audio16k.size, cfg):
        chunk = torch.from_numpy(np.ascontiguousarray(audio16k[start : start + length])).to(device)
        with torch.no_grad():
            kept.append(encode_chunk(chunk, w, cfg, product).cpu().numpy())
    starts, ends = frame_times(audio16k.size, cfg)
    return np.concatenate(kept), starts, ends


def chunks(samples16k: int, cfg: dict) -> list[tuple[int, int, int]]:
    """(start, length, frames) of each chunk of at most 30 s that yields a frame."""
    from portbench.harness.yardstick import wav2vec2_frames

    planned = [(start, min(CHUNK_SAMPLES, samples16k - start)) for start in range(0, samples16k, CHUNK_SAMPLES)]
    return [(start, length, wav2vec2_frames(cfg, length)) for start, length in planned
            if wav2vec2_frames(cfg, length) > 0]


def frame_times(samples16k: int, cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """Start and end seconds of a clip's frames: each chunk's frames cover its duration evenly."""
    starts, ends = [], []
    for start, length, n_valid in chunks(samples16k, cfg):
        step = (length / 16000) / n_valid
        first = start / 16000 + step * np.arange(n_valid)
        starts.append(first)
        ends.append(first + step)
    return np.concatenate(starts), np.concatenate(ends)
