"""What each part of a fused K1 launch costs, by building copies without it (CUDA card only).

Without a profiler that sees inside a kernel (``ncu``), this builds copies of
``csrc/log_mel.cu`` with one part of ``stft_power_mel_log_kernel`` taken out
and times each at the main path's (8, 480000) → (8, 3000, 128) against the
unchanged source:

- ``no_mel``: no mel pass (each N tile's power is written, never summed);
- ``no_split``: the audio is not split (hi = lo = the raw float32 bits);
- ``hi_only``: one TF32 product per product (hi·hi) instead of three;
- ``no_products``: no ``wgmma`` at all, so the time is that of the loads, the
  split, the chunk sums, the power and the mel pass;
- ``no_basis_loads``: the basis stages are announced without being copied (the
  products read stale stages), so L2 → shared-memory traffic drops out;
- ``no_loads_no_products``: both of the last two;
- ``no_loads_no_products_no_mel``: and no mel pass, so the time is that of the
  span fill, the A-fragment loads and split, the ring's barriers, the chunk
  sums and the power;
- ``one_accumulator``: a right kernel that sums all of an N tile's products in
  one tensor-core accumulator instead of one per K chunk added in float32.

Every copy but ``source`` and ``one_accumulator`` computes wrong results on
purpose. Each line gives the copy's max abs error against the plain version
(TF32 off) on the raw log-mel and on the normalized log-mel. Times are CUDA-event means over 20
launches after 3 warm-ups. Run from the root of a checkout:

    python -m ser_tpu_torch.scripts.log_mel_ablation

It prints one line per copy and, last, a JSON object of the times in ms.
"""

from __future__ import annotations

import json

import torch

from ser_tpu_torch.ops import kernel_build, log_mel
from ser_tpu_torch.scripts import ablation

SHAPE = (8, 30 * 16000)
N_MELS, OUT_FRAMES = 128, 3000
_PRODUCTS = (
    "          for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, a_lo[kk], sw128_desc(tile_hi + 32 * kk), kk);\n",
    "          for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, a_hi[kk], sw128_desc(tile_lo + 32 * kk), 1);\n",
    "          for (int kk = 0; kk < 4; ++kk) wgmma_tf32(part, a_hi[kk], sw128_desc(tile_hi + 32 * kk), 1);\n",
)
# The basis stages arrive without their bytes (the consumers read stale stages).
_NO_LOADS = (
    "mbar_expect_tx(full + 8 * stage, kStageBytes);",
    "mbar_arrive(full + 8 * stage);\n            if (n_items < 0)",
)
_NO_MEL = (
    "for (int k = max(lo, bin0); k < k_end; ++k) {",
    "for (int k = max(lo, bin0); k < k_end && n_mels < 0; ++k) {",
)
#: (name, [(text in the source, text put in its place)]).
COPIES = (
    ("source", []),
    ("no_mel", [_NO_MEL]),
    ("no_split", [
        ("split_tf32_int(v[2 * kk], a_hi[kk][r], a_lo[kk][r]);",
         "a_hi[kk][r] = a_lo[kk][r] = __float_as_uint(v[2 * kk]);"),
        ("split_tf32_int(v[2 * kk + 1], a_hi[kk][2 + r], a_lo[kk][2 + r]);",
         "a_hi[kk][2 + r] = a_lo[kk][2 + r] = __float_as_uint(v[2 * kk + 1]);"),
    ]),
    ("hi_only", [(line, "") for line in _PRODUCTS[:2]]),
    ("no_products", [(line, "") for line in _PRODUCTS]),
    ("no_basis_loads", [_NO_LOADS]),
    ("no_loads_no_products", [_NO_LOADS] + [(line, "") for line in _PRODUCTS]),
    ("no_loads_no_products_no_mel", [_NO_LOADS, _NO_MEL] + [(line, "") for line in _PRODUCTS]),
    ("one_accumulator", [
        (_PRODUCTS[0], _PRODUCTS[0].replace("tile_hi + 32 * kk), kk);", "tile_hi + 32 * kk), chunk == 0 ? kk : 1);")),
        ("for (int i = 0; i < 32; ++i) sum[i] += part[i];", "for (int i = 0; i < 32; ++i) sum[i] = part[i];"),
    ]),
)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("log_mel_ablation: no CUDA device.")
    libraries = ablation.build_copies("log_mel", COPIES)
    torch.manual_seed(0)
    batch, samples = SHAPE
    wave = 0.1 * torch.randn(batch, samples, device="cuda")
    fb = torch.from_numpy(log_mel._mel_fb_t(16000, log_mel.FUSED_N_FFT, N_MELS)).cuda()
    basis = torch.from_numpy(log_mel.packed_fused_basis()).cuda()
    out = torch.empty((batch, OUT_FRAMES, N_MELS), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    log_mel.set_strict_float32()
    reference = log_mel.stft_power_mel_log_reference(wave, fb, OUT_FRAMES)
    normalized = log_mel.normalize_log_mel(reference)
    times = {}
    for name, library in libraries.items():
        function = ablation.entry_point(library, "log_mel", "stft_power_mel_log")

        def call():
            kernel_build.check(
                function(wave.data_ptr(), basis.data_ptr(), fb.data_ptr(), out.data_ptr(), batch, samples,
                         OUT_FRAMES, N_MELS, stream),
                name,
            )

        times[name] = ablation.launch_ms(call)
        call()
        torch.cuda.synchronize()
        raw_err = (out - reference).abs().max().item()
        normalized_err = (log_mel.normalize_log_mel(out) - normalized).abs().max().item()
        print(f"[ablation] copy={name} ms={times[name]} raw_max_abs_err={raw_err:.3g} "
              f"normalized_max_abs_err={normalized_err:.3g}", flush=True)
    print(json.dumps({"ablation_ms": times, "shape": SHAPE, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
