"""Synthetic htdemucs state dicts in the published checkpoint layout.

Copied from ``ser_tpu/models/_demucs_synthetic.py``: the demucs v4 weight-name
and shape contract, used by ``demucs_v4.init_demucs_params`` (seeded random
weights for tests and ``chip_smoke.py``). The dict is keyed exactly like the
released ``htdemucs`` ``state_dict`` (``encoder.0.conv.weight`` …
``crosstransformer.layers_t.4``), so converting it exercises every name and
layout the real checkpoint would. It draws from the same numpy generator in
the same order, so for one seed and config it is bit-equal to the JAX
package's.
"""

from __future__ import annotations

import numpy as np

from ser_tpu_torch.models.demucs_v4 import DemucsV4Config


def _shapes(config: DemucsV4Config) -> dict[str, tuple[int, ...]]:
    cfg = config
    shapes: dict[str, tuple[int, ...]] = {}

    def dconv(base: str, ch: int) -> None:
        hidden = max(1, ch // cfg.dconv_comp)
        for j in range(cfg.dconv_depth):
            shapes[f"{base}.layers.{j}.0.weight"] = (hidden, ch, 3)
            shapes[f"{base}.layers.{j}.0.bias"] = (hidden,)
            shapes[f"{base}.layers.{j}.1.weight"] = (hidden,)
            shapes[f"{base}.layers.{j}.1.bias"] = (hidden,)
            shapes[f"{base}.layers.{j}.3.weight"] = (2 * ch, hidden, 1)
            shapes[f"{base}.layers.{j}.3.bias"] = (2 * ch,)
            shapes[f"{base}.layers.{j}.4.weight"] = (2 * ch,)
            shapes[f"{base}.layers.{j}.4.bias"] = (2 * ch,)
            shapes[f"{base}.layers.{j}.6.scale"] = (ch,)

    cac_channels = 2 * cfg.audio_channels
    for idx in range(cfg.depth):
        chout = cfg.layer_channels(idx)
        chin_f = cac_channels if idx == 0 else cfg.layer_channels(idx - 1)
        chin_t = cfg.audio_channels if idx == 0 else cfg.layer_channels(idx - 1)
        shapes[f"encoder.{idx}.conv.weight"] = (chout, chin_f, cfg.kernel_size, 1)
        shapes[f"encoder.{idx}.conv.bias"] = (chout,)
        shapes[f"encoder.{idx}.rewrite.weight"] = (2 * chout, chout, 1, 1)
        shapes[f"encoder.{idx}.rewrite.bias"] = (2 * chout,)
        dconv(f"encoder.{idx}.dconv", chout)
        shapes[f"tencoder.{idx}.conv.weight"] = (chout, chin_t, cfg.kernel_size)
        shapes[f"tencoder.{idx}.conv.bias"] = (chout,)
        shapes[f"tencoder.{idx}.rewrite.weight"] = (2 * chout, chout, 1)
        shapes[f"tencoder.{idx}.rewrite.bias"] = (2 * chout,)
        dconv(f"tencoder.{idx}.dconv", chout)

        # Decoders run deepest-first: decoder.0 consumes the transformer
        # output, decoder.{depth-1} emits the per-source heads.
        chin = cfg.layer_channels(cfg.depth - 1 - idx)
        last = idx == cfg.depth - 1
        chout_f = (
            len(cfg.sources) * cac_channels
            if last
            else cfg.layer_channels(cfg.depth - 2 - idx)
        )
        chout_t = (
            len(cfg.sources) * cfg.audio_channels
            if last
            else cfg.layer_channels(cfg.depth - 2 - idx)
        )
        shapes[f"decoder.{idx}.rewrite.weight"] = (2 * chin, chin, 3, 3)
        shapes[f"decoder.{idx}.rewrite.bias"] = (2 * chin,)
        shapes[f"decoder.{idx}.conv_tr.weight"] = (chin, chout_f, cfg.kernel_size, 1)
        shapes[f"decoder.{idx}.conv_tr.bias"] = (chout_f,)
        shapes[f"tdecoder.{idx}.rewrite.weight"] = (2 * chin, chin, 3)
        shapes[f"tdecoder.{idx}.rewrite.bias"] = (2 * chin,)
        shapes[f"tdecoder.{idx}.conv_tr.weight"] = (chin, chout_t, cfg.kernel_size)
        shapes[f"tdecoder.{idx}.conv_tr.bias"] = (chout_t,)

    shapes["freq_emb.embedding.weight"] = (
        cfg.freq_bins // cfg.stride,
        cfg.channels,
    )
    bottom_in = cfg.layer_channels(cfg.depth - 1)
    for name in ("channel_upsampler", "channel_upsampler_t"):
        shapes[f"{name}.weight"] = (cfg.bottom_channels, bottom_in, 1)
        shapes[f"{name}.bias"] = (cfg.bottom_channels,)
    for name in ("channel_downsampler", "channel_downsampler_t"):
        shapes[f"{name}.weight"] = (bottom_in, cfg.bottom_channels, 1)
        shapes[f"{name}.bias"] = (bottom_in,)

    d = cfg.bottom_channels
    hidden = int(cfg.t_hidden_scale * d)
    for stream in ("layers", "layers_t"):
        for index in range(cfg.t_layers):
            base = f"crosstransformer.{stream}.{index}"
            cross = index % 2 == 0
            attn = "cross_attn" if cross else "self_attn"
            shapes[f"{base}.{attn}.in_proj_weight"] = (3 * d, d)
            shapes[f"{base}.{attn}.in_proj_bias"] = (3 * d,)
            shapes[f"{base}.{attn}.out_proj.weight"] = (d, d)
            shapes[f"{base}.{attn}.out_proj.bias"] = (d,)
            shapes[f"{base}.linear1.weight"] = (hidden, d)
            shapes[f"{base}.linear1.bias"] = (hidden,)
            shapes[f"{base}.linear2.weight"] = (d, hidden)
            shapes[f"{base}.linear2.bias"] = (d,)
            for norm in ("norm1", "norm2", "norm_out") + (("norm3",) if cross else ()):
                shapes[f"{base}.{norm}.weight"] = (d,)
                shapes[f"{base}.{norm}.bias"] = (d,)
            shapes[f"{base}.gamma_1.scale"] = (d,)
            shapes[f"{base}.gamma_2.scale"] = (d,)
    for name in ("crosstransformer.norm_in", "crosstransformer.norm_in_t"):
        shapes[f"{name}.weight"] = (d,)
        shapes[f"{name}.bias"] = (d,)
    return shapes


def synthetic_state_dict(config: DemucsV4Config, *, seed: int = 0) -> dict:
    """Random state dict in the published layout (norm scales near 1)."""
    rng = np.random.default_rng(seed)
    state: dict[str, np.ndarray] = {}
    for name, shape in _shapes(config).items():
        if name.endswith("scale"):
            value = np.full(shape, 0.1, dtype=np.float32)
        elif ".weight" in name and len(shape) == 1:
            value = (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
        else:
            value = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        state[name] = value
    return state


__all__ = ["synthetic_state_dict"]
