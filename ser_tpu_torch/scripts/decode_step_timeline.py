"""Where a K3, K4 or K5 launch spends its time, by stopping the kernel early (CUDA card only).

Without a profiler that sees inside a kernel (``ncu``), this builds copies of
``csrc/decode_step.cu`` that return at successive points of the cluster
kernel (after its first statement, after the loads issued at its start have
landed, after the query, after the softmax statistics, after the head output,
after the out-projection) or of K3's GEMV kernel (after its first statements,
after its weight boxes have landed, after its LayerNorm with the boxes
landed, after its products), and times each at large-v3's decode shapes (R = 2 rows), as
``chip_smoke.py`` times the kernels: CUDA events around 60 launches, the card
held in a sleep while the host enqueues, operands cycled through 160 MB. The
difference between two neighbouring points is what that stretch of the kernel
adds to a launch (the last stretch runs to "end", the unchanged source). Each
build times all three kernels; a stop changes only its own. Run from the
root of a checkout:

    python -m ser_tpu_torch.scripts.decode_step_timeline

It prints one line per point and, last, a JSON object of the times in us.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ser_tpu_torch.ops import decode_step_kernels as dsk
from ser_tpu_torch.ops import kernel_build

# (name, anchor in the source, text put in its place). An always-true test on
# p.rows keeps the compiler from treating the rest of the kernel as dead code.
STOPS = (
    ("start", "  const int c0 = rank * p.chunk;\n", "  if (p.rows > 0) return;\n  const int c0 = rank * p.chunk;\n"),
    (
        "loads",
        "  for (int t = 0; t < kStages; ++t) issue(t);\n",
        "  for (int t = 0; t < kStages; ++t) issue(t);\n  if (p.rows > 0) {\n    cp_async_wait<0>();\n    return;\n  }\n",
    ),
    (
        "query",
        "  __syncthreads();\n\n  // 2. Scores",
        "  __syncthreads();\n  if (p.rows > 0) {\n    cluster.sync();\n    return;\n  }\n\n  // 2. Scores",
    ),
    (
        "stats",
        "    rowml[2 * r + 1] = l;\n  }\n  __syncthreads();\n",
        "    rowml[2 * r + 1] = l;\n  }\n  __syncthreads();\n  if (p.rows > 0) {\n    cluster.sync();\n    return;\n  }\n",
    ),
    ("head", "  cluster_arrive();\n", "  cluster.sync();\n  if (p.rows > 0) return;\n"),
    ("out_proj", "  cluster_wait();\n  __syncthreads();\n", "  cluster_wait();\n  if (p.rows > 0) return;\n  __syncthreads();\n"),
    ("k3_start", "  const int n0 = blockIdx.x * kTileCols;\n", "  const int n0 = blockIdx.x * kTileCols;\n  if (p.rows > 0) return;\n"),
    (
        "k3_loads",
        "      tma_load_2d(base + i * kBoxBytes, w_map, bar, n0, i * kBoxRows);\n    }\n  }\n",
        "      tma_load_2d(base + i * kBoxBytes, w_map, bar, n0, i * kBoxRows);\n    }\n  }\n"
        # The barriers are initialised by thread 0: wait for it before waiting on them.
        "  if (p.rows > 0) {\n    __syncthreads();\n"
        "    for (int i = 0; i < n_boxes; ++i) mbar_wait(smem_addr(&bars_s[i]), 0);\n    return;\n  }\n",
    ),
    (
        "k3_ln",
        "    layer_norm_rows(p, r0, ln_in, a_s, red_s);  // the first group's runs while the weights arrive\n"
        "    __syncthreads();\n",
        "    layer_norm_rows(p, r0, ln_in, a_s, red_s);  // the first group's runs while the weights arrive\n"
        "    __syncthreads();\n"
        "    if (p.rows > 0) {\n      for (int i = 0; i < n_boxes; ++i) mbar_wait(smem_addr(&bars_s[i]), 0);\n      return;\n    }\n",
    ),
    (
        # A test that never holds keeps the products from being dead code.
        "k3_products",
        "    // Rows g < kRows of this warp's partial: columns 8j + 2 t4 and 8j + 2 t4 + 1.\n",
        "    if (p.rows > 0) {\n      if (acc[0][0] == 1.2345f) p.out[0] = __float2bfloat16(acc[1][1]);\n      return;\n    }\n",
    ),
)
ROWS, HEADS, HEAD_DIM, S_MAX, D_MODEL, S_LEN, EPS = 2, 20, 64, 448, 1280, 1500, 1e-5
ROTATION_BYTES = 160e6


def _hold(ms: float, cycles_per_ms: float) -> None:
    torch.cuda._sleep(int(ms * cycles_per_ms))


def _time_us(fn, argument_sets, cycles_per_ms: float, iters: int = 60) -> float:
    for args in argument_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _hold(2.0 * iters * 0.2 + 5.0, cycles_per_ms)  # about 0.2 ms of host time per call at most
    start.record()
    for i in range(iters):
        fn(*argument_sets[i % len(argument_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def _operands(generator):
    def bf16(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=generator, device="cuda") * scale + shift).to(torch.bfloat16)

    d = D_MODEL
    k4 = (bf16(ROWS, HEADS, HEAD_DIM), bf16(ROWS, HEADS, HEAD_DIM, S_MAX), bf16(ROWS, HEADS, S_MAX, HEAD_DIM),
          bf16(HEADS, HEAD_DIM, d, scale=d**-0.5), bf16(1, d, scale=0.1), bf16(ROWS, d, scale=0.1))
    k5 = (bf16(ROWS, d, scale=0.1, shift=0.05), bf16(1, d, scale=0.1, shift=1.0), bf16(1, d, scale=0.1),
          bf16(HEADS, d, HEAD_DIM, scale=d**-0.5), bf16(HEADS, 1, HEAD_DIM, scale=0.1),
          bf16(ROWS, HEADS, HEAD_DIM, S_LEN, scale=2.0), bf16(ROWS, HEADS, S_LEN, HEAD_DIM),
          bf16(HEADS, HEAD_DIM, d, scale=d**-0.5), bf16(1, d, scale=0.1))
    k3 = (bf16(ROWS, d, shift=0.5), bf16(1, d, scale=0.1, shift=1.0), bf16(1, d, scale=0.1),
          bf16(d, 3 * d, scale=d**-0.5), bf16(1, 3 * d, scale=0.1))
    return k4, k5, k3


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("decode_step_timeline: no CUDA device.")
    kernel_build.load("ln_qkv_project")  # builds and binds every source once
    source = (kernel_build.CSRC_DIR / "decode_step.cu").read_text(encoding="utf-8")
    out_dir = kernel_build.BUILD_DIR / "timeline"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernel_build._nvcc()
    builds = {}
    for name, anchor, replacement in STOPS:
        if source.count(anchor) != 1:
            raise SystemExit(f"decode_step_timeline: the anchor of {name!r} is not in decode_step.cu once.")
        variant = out_dir / f"decode_step_{name}.cu"
        variant.write_text(source.replace(anchor, replacement), encoding="utf-8")
        library = out_dir / f"libdecode_step_{name}.so"
        command = [nvcc, *kernel_build.NVCC_FLAGS, "-I", str(kernel_build.CSRC_DIR), "-o", str(library), str(variant)]
        builds[name] = (subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), library)
    libraries = {}
    for name, (proc, library) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"decode_step_timeline: nvcc failed for {name}:\n{log[-3000:]}")
        libraries[name] = library

    generator = torch.Generator(device="cuda").manual_seed(4)
    first = _operands(generator)
    per_set = sum(t.numel() * 2 for t in first[0] + first[1] + first[2])
    sets = [first] + [_operands(generator) for _ in range(max(1, int(ROTATION_BYTES // per_set)))]
    k4_sets, k5_sets, k3_sets = [s[0] for s in sets], [s[1] for s in sets], [s[2] for s in sets]
    cycles = 10_000_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = cycles / start.elapsed_time(end)

    full = dict(kernel_build._ENTRIES)
    times = {}
    for name in [*libraries, "end"]:
        if name == "end":
            kernel_build._ENTRIES.update(full)
        else:
            library = ctypes.CDLL(str(libraries[name]))
            for entry, (symbol, argtypes) in kernel_build.ENTRY_POINTS["decode_step"].items():
                function = getattr(library, symbol)
                function.argtypes, function.restype = argtypes, ctypes.c_int
                kernel_build._ENTRIES[entry] = function
        k4 = _time_us(lambda *a: dsk.self_attend_and_out(*a, S_MAX - 1), k4_sets, cycles_per_ms)
        k5 = _time_us(lambda *a: dsk.cross_attention_step(*a, eps=EPS), k5_sets, cycles_per_ms)
        k3 = _time_us(lambda *a: dsk.ln_qkv_project(*a, eps=EPS), k3_sets, cycles_per_ms)
        times[name] = {"k3_us": round(k3, 3), "k4_us": round(k4, 3), "k5_us": round(k5, 3)}
        print(f"[timeline] stop={name} k3_us={k3:.3f} k4_us={k4:.3f} k5_us={k5:.3f}", flush=True)
    kernel_build._ENTRIES.update(full)
    print(json.dumps({"timeline_us": times, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
