"""Where htdemucs's float32 forward parts from float64, stage by stage (CUDA card).

At the published widths with the port's synthetic weights (seed 0) on one
segment of music-like audio, each line gives the relative L2 error of the
vocals stem against a float64 forward of the same weights on the card:

- ``float32``: the forward as the lane runs it (TF32 off);
- ``float32_dc_imag``: the same with the inverse STFT reading the DC bin's
  imaginary part, as cuFFT's float32 inverse does unless ``_ispec`` zeroes it;
- ``tf32``: TF32 products and convolutions allowed;
- ``float32_cpu``: the forward in float32 on the host's CPU;
- ``input_1e-7``: float64 with the input scaled by 1 + 1e-7 (how far the
  network moves a perturbation of its input).

Then, for each stage (``_spec``, ``_henc_layer``, ``_dconv``, ``_mha``,
``_crosstransformer``, ``_hdec_layer``, ``_ispec``, ...), the worst relative
error of that stage run in float32 on the float64 forward's own inputs.
Run from the root of a checkout:

    python -m ser_tpu_torch.scripts.separation_precision [--seconds 7.8]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from ser_tpu_torch.models import convert
from ser_tpu_torch.models import demucs_v4 as tdm

_STAGES = ("_spec", "_henc_layer", "_dconv", "_mha", "_ff_block", "_channel_groupnorm_last", "_self_layer",
           "_cross_layer", "_crosstransformer", "_hdec_layer", "_ispec")


def music(seconds: float, sample_rate: int, *, seed: int = 1) -> np.ndarray:
    """A chord with a beat, a gliding tone and noise, peak 0.8."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    beat = (np.sin(2 * np.pi * 2.0 * t) > 0).astype(np.float64)
    chord = sum(np.sin(2 * np.pi * f * t) for f in (110.0, 220.0, 277.2, 329.6)) / 4
    voice = np.sin(2 * np.pi * (300 + 60 * np.sin(2 * np.pi * 0.5 * t)) * t)
    audio = 0.4 * chord * (0.6 + 0.4 * beat) + 0.3 * voice + 0.03 * rng.standard_normal(t.size)
    return (0.8 * audio / np.abs(audio).max()).astype(np.float32)


def _ispec_reading_dc_imag(z, cfg, length):
    *lead, freqs, le = z.shape
    pad = cfg.hop // 2 * 3
    total = cfg.hop * -(-length // cfg.hop) + 2 * pad
    z = F.pad(z.reshape(-1, freqs, le), (2, 2, 0, 1))
    x = torch.istft(z, cfg.nfft, cfg.hop, window=tdm._window(cfg.nfft, z), normalized=True, center=True, length=total)
    return x[:, pad : pad + length].reshape(*lead, length)


def _single(value):
    if isinstance(value, torch.Tensor):
        if value.is_complex():
            return value.to(torch.complex64)
        return value.float() if value.is_floating_point() else value
    if isinstance(value, dict):
        return {key: _single(item) for key, item in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_single(item) for item in value)
    return value


def _flat(value) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in value]) if isinstance(value, tuple) else value.reshape(-1)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=7.8)
    args = parser.parse_args()
    cuda = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg = tdm.DemucsV4Config(segment_seconds=args.seconds)
    tree = tdm.init_demucs_params(cfg, seed=0)
    vocals = cfg.sources.index("vocals")
    mix = torch.from_numpy(np.repeat(music(args.seconds, cfg.sample_rate)[None, None], 2, axis=1)[..., : cfg.segment_samples])
    params64 = convert.demucs_params(tree, device=cuda, dtype=torch.float64)
    params32 = convert.demucs_params(tree, device=cuda)

    def vocals64(scale: float = 1.0) -> torch.Tensor:
        with torch.inference_mode():
            return tdm.demucs_forward(params64, mix.to(cuda).double() * scale, cfg)[:, vocals].mean(dim=1)

    reference = vocals64()

    def rel(value: torch.Tensor) -> float:
        return ((value.to(cuda).double() - reference).norm() / reference.norm()).item()

    readings = {"float32": rel(tdm.vocals_forward(params32, mix.to(cuda), cfg, vocals))}
    ispec, tdm._ispec = tdm._ispec, _ispec_reading_dc_imag
    try:
        readings["float32_dc_imag"] = rel(tdm.vocals_forward(params32, mix.to(cuda), cfg, vocals))
    finally:
        tdm._ispec = ispec
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    with torch.inference_mode():
        readings["tf32"] = rel(tdm.demucs_forward(params32, mix.to(cuda), cfg)[:, vocals].mean(dim=1))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    readings["float32_cpu"] = rel(tdm.vocals_forward(convert.demucs_params(tree, device="cpu"), mix, cfg, vocals))
    readings["input_1e-7"] = rel(vocals64(1.0 + 1e-7))
    for name, value in readings.items():
        print(f"[separation-precision] {name}={value:.3e} seconds={args.seconds} card=\"{card}\"", flush=True)

    worst: dict[str, float] = {}
    originals = {name: getattr(tdm, name) for name in _STAGES}

    def checked(name, fn):
        def run(*call_args, **kwargs):
            out = fn(*call_args, **kwargs)
            with tdm.strict_float32(cuda):
                single = fn(*_single(call_args), **_single(kwargs))
            a, b = _flat(single).to(_flat(out).dtype), _flat(out)
            worst[name] = max(worst.get(name, 0.0), ((a - b).abs().norm() / b.abs().norm()).item())
            return out

        return run

    for name, fn in originals.items():
        setattr(tdm, name, checked(name, fn))
    try:
        vocals64()
    finally:
        for name, fn in originals.items():
            setattr(tdm, name, fn)
    print(json.dumps({"stage_worst_rel_l2": {name: float(f"{value:.3e}") for name, value in worst.items()}}))


if __name__ == "__main__":
    main()
