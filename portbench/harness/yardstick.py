"""The benchmark's yardstick: the card's peaks, the model FLOPs the inputs need, and the
kernels' roofline bounds.

The Whisper count is ``bench.py::_encoder_mfu``'s (2 FLOP per multiply-add
over the conv stem and each layer's projections, attention and MLP at 1500
states a 30 s window), the wav2vec2 count ``chip_smoke.py::_wav2vec2_flops``'s,
the K1 and K2 bounds those of ``PERF.md`` section 6. Frozen here so that a
change to the program cannot move them. Every count is of the work the inputs
need, whatever implements it.
"""

from __future__ import annotations

import math

#: Data-sheet peaks of one H100 SXM (dense, at its 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12
PEAK_BYTES_PER_S = 3.35e12

WHISPER_SAMPLE_RATE = 16000
WHISPER_WINDOW_SAMPLES = 30 * WHISPER_SAMPLE_RATE
WHISPER_MEL_FRAMES = 3000
WHISPER_STATES = 1500
#: K1's framing: 400 taps, (re, im) of 201 bins = 402 basis columns.
K1_TAPS, K1_COLUMNS = 400, 402
#: K1's packed basis (7 tiles of 64 columns x 13 chunks of 32 taps, hi and lo, float32)
#: and its filterbank (201 bins x 128 mels, float32), read once a launch.
K1_CONSTANT_BYTES = 2 * 7 * 64 * 13 * 32 * 4 + 201 * 128 * 4


def whisper_windows(samples_16k: int) -> int:
    """30 s windows the accurate profile encodes for a clip of ``samples_16k`` samples."""
    return max(1, math.ceil(samples_16k / WHISPER_WINDOW_SAMPLES))


def whisper_window_flops(config: dict) -> float:
    """FLOP of one 30 s window through the Whisper encoder (2.2738e12 at large-v3's widths)."""
    d, layers, ffn, mels = config["d_model"], config["encoder_layers"], config["encoder_ffn_dim"], config["num_mel_bins"]
    t_mel, t = WHISPER_MEL_FRAMES, WHISPER_STATES
    macs_conv = t_mel * 3 * mels * d + t * 3 * d * d
    macs_layer = 4 * t * d * d + 2 * t * t * d + 2 * t * d * ffn
    return 2.0 * (macs_conv + layers * macs_layer)


def wav2vec2_chunk_flops(config: dict, samples: int) -> float:
    """FLOP of one chunk of ``samples`` valid samples through the wav2vec2 encoder."""
    length, channels, conv = samples, 1, 0.0
    for dim, kernel, stride in zip(config["conv_dim"], config["conv_kernel"], config["conv_stride"]):
        length = (length - kernel) // stride + 1
        conv += 2.0 * length * dim * channels * kernel
        channels = dim
    t, d, ffn = length, config["hidden_size"], config["intermediate_size"]
    projection = 2.0 * t * channels * d
    positional = 2.0 * t * d * (d // config["num_conv_pos_embedding_groups"]) * config["num_conv_pos_embeddings"]
    layers = config["num_hidden_layers"]
    return conv + projection + positional + layers * (2.0 * (4 * t * d * d + 2 * t * d * ffn) + 4.0 * t * t * d)


def wav2vec2_frames(config: dict, samples: int) -> int:
    """Frames the conv front end makes of ``samples`` (0 below its receptive field)."""
    receptive = 1
    for kernel, stride in zip(reversed(config["conv_kernel"]), reversed(config["conv_stride"])):
        receptive = (receptive - 1) * stride + kernel
    return max(0, (samples - receptive) // math.prod(config["conv_stride"]) + 1)


def wav2vec2_chunks(samples_16k: int, chunk_seconds: int) -> list[int]:
    """Valid sample counts of the chunks the medium profile encodes (30 s at most each)."""
    size = chunk_seconds * WHISPER_SAMPLE_RATE
    return [min(size, samples_16k - start) for start in range(0, samples_16k, size)]


def attention_work(batch: int, heads: int, queries: int, keys: int, head_dim: int) -> tuple[float, float]:
    """(FLOP, bytes) of one bf16 attention: 4·B·H·Tq·Tk·D, and q, k, v read and the output
    written once."""
    return 4.0 * batch * heads * queries * keys * head_dim, 2.0 * batch * heads * head_dim * (2 * queries + 2 * keys)


def k1_work(windows: int) -> tuple[float, float]:
    """(FLOP at the TF32 rate, bytes) of one K1 launch over ``windows`` 30 s windows: the DFT
    as three TF32 products of 2·T·402·400 FLOP a window; the waveform read and the log-mel
    written in float32, with the basis and filterbank."""
    flops = 3 * 2.0 * windows * WHISPER_MEL_FRAMES * K1_COLUMNS * K1_TAPS
    moved = windows * (WHISPER_WINDOW_SAMPLES + WHISPER_MEL_FRAMES * 128) * 4 + K1_CONSTANT_BYTES
    return flops, moved


def bound_seconds(flops: float, moved: float, peak_flops: float) -> float:
    """The least time of that work on the card: the slower of its compute and its memory traffic."""
    return max(flops / peak_flops, moved / PEAK_BYTES_PER_S)


def resampled_length(samples: int, sample_rate: int) -> int:
    """Samples at 16 kHz after polyphase resampling (``scipy.signal.resample_poly``'s length)."""
    g = math.gcd(sample_rate, WHISPER_SAMPLE_RATE)
    up, down = WHISPER_SAMPLE_RATE // g, sample_rate // g
    return -(-samples * up // down)
