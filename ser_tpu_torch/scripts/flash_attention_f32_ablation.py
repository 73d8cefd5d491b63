"""What each part of a K2-f32 launch costs, by building copies without it (CUDA card only).

Without a profiler that sees inside a kernel (``ncu``), this builds copies of
``csrc/flash_attention_f32.cu`` with one part taken out and times each at the
medium profile's masked (8, 1499, 16, 64) shape against the unchanged source:

- ``no_split``: the split warps skip their work (the consumers read stale
  tiles), so the time is that of TMA, the softmax and the products;
- ``hi_only``: one TF32 product per product (hi·hi) instead of three;
- ``no_products``: no ``wgmma`` at all, so the time is that of the loads, the
  split and the softmax.

The copies compute wrong results on purpose; only the unchanged source's error
is printed. Times are CUDA-event means over 20 launches after 3 warm-ups.
Run from the root of a checkout:

    python -m ser_tpu_torch.scripts.flash_attention_f32_ablation

It prints one line per copy and, last, a JSON object of the times in ms.
"""

from __future__ import annotations

import json
import math

import torch

from ser_tpu_torch.models import attention
from ser_tpu_torch.ops import kernel_build
from ser_tpu_torch.scripts import ablation

SHAPE = (8, 1499, 16, 64)
MASK_STEP = 150  # row b keeps T - 150 b keys, as chip_smoke.py's K2-f32 phase
_S_PRODUCTS = (
    "        for (int kk = 0; kk < 8; ++kk) wgmma_tf32(s, q_lo[kk], tile_desc(k_hi, kk), 1);\n",
    "        for (int kk = 0; kk < 8; ++kk) wgmma_tf32(s, q_hi[kk], tile_desc(k_lo, kk), 1);\n",
    "        for (int kk = 0; kk < 8; ++kk) wgmma_tf32(s, q_hi[kk], tile_desc(k_hi, kk), 1);\n",
)
_PV_PRODUCTS = (
    "        for (int j = 0; j < 8; ++j) wgmma_tf32(pv, p_lo[j], tile_desc(vt_hi, j), 1);\n",
    "        for (int j = 0; j < 8; ++j) wgmma_tf32(pv, p_hi[j], tile_desc(vt_lo, j), 1);\n",
    "        for (int j = 0; j < 8; ++j) wgmma_tf32(pv, p_hi[j], tile_desc(vt_hi, j), 1);\n",
)
_SPLIT_CALL = "          split_tile(smem + kLandK + ls * kTileBytes"
#: (name, [(text in the source, text put in its place)]).
COPIES = (
    ("source", []),
    ("no_split", [(_SPLIT_CALL, "          if (seq < 0) split_tile(smem + kLandK + ls * kTileBytes")]),
    ("hi_only", [(line, "") for line in _S_PRODUCTS[:2] + _PV_PRODUCTS[:2]]),
    ("no_products", [(line, "") for line in _S_PRODUCTS + _PV_PRODUCTS]),
)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_f32_ablation: no CUDA device.")
    libraries = ablation.build_copies("flash_attention_f32", COPIES)
    torch.manual_seed(0)
    batch, seq, heads, dim = SHAPE
    q, k, v = (torch.randn(*SHAPE, device="cuda") for _ in range(3))
    lengths = torch.tensor([seq - MASK_STEP * i for i in range(batch)], device="cuda")
    frame_mask = torch.arange(seq, device="cuda")[None, :] < lengths[:, None]
    padded = attention._padded_len(seq)
    key_mask = torch.zeros((batch, padded), dtype=torch.uint8, device="cuda")
    key_mask[:, :seq] = frame_mask
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for name, library in libraries.items():
        function = ablation.entry_point(library, "flash_attention_f32", "flash_attention_f32")

        def call():
            kernel_build.check(
                function(q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), out.data_ptr(), batch, seq,
                         heads, dim, padded, 1.0 / math.sqrt(dim), stream),
                name,
            )

        times[name] = ablation.launch_ms(call)
        line = f"[ablation] copy={name} ms={times[name]}"
        if name == "source":
            reference = attention.attention_reference(q, k, v, frame_mask=frame_mask)
            line += f" max_abs_err={(out - reference).abs().max().item():.3g}"
            del reference
        print(line, flush=True)
    print(json.dumps({"ablation_ms": times, "shape": SHAPE, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
