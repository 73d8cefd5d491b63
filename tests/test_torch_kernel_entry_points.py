"""The ctypes bindings of the port's kernels against their C prototypes, on the CPU.

``kernel_build.ENTRY_POINTS`` declares each C entry point's argument types once;
ctypes trusts it. A table that drifts from the source (an argument added to a
kernel's entry point, say) shows up on the card only as a crash or as garbage,
never as a Python error. This test parses every ``extern "C"`` prototype in
``ser_tpu_torch/csrc/*.cu`` and holds the table to it: the same symbols per
source, and per argument ``c_void_p`` for a pointer, ``c_int`` for an ``int``
and ``c_float`` for a ``float``, in order.
"""

from __future__ import annotations

import ctypes
import re

import pytest

from ser_tpu_torch.ops import kernel_build

_PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _ctype(parameter: str):
    text = " ".join(parameter.split())
    if "*" in text:
        return ctypes.c_void_p
    kind = text.replace("const ", "").split(" ")[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


def _prototypes(stem: str) -> dict[str, list]:
    source = (kernel_build.CSRC_DIR / f"{stem}.cu").read_text(encoding="utf-8")
    return {
        symbol: [_ctype(parameter) for parameter in parameters.split(",")]
        for symbol, parameters in _PROTOTYPE.findall(source)
    }


def test_every_source_has_a_table_entry() -> None:
    assert sorted(kernel_build.ENTRY_POINTS) == sorted(path.stem for path in kernel_build.sources())


@pytest.mark.parametrize("stem", sorted(kernel_build.ENTRY_POINTS))
def test_entry_points_match_the_c_prototypes(stem) -> None:
    prototypes = _prototypes(stem)
    assert prototypes, f"no extern \"C\" entry point in {stem}.cu"
    declared = {symbol: list(argtypes) for symbol, argtypes in kernel_build.ENTRY_POINTS[stem].values()}
    assert sorted(declared) == sorted(prototypes)
    for symbol, argtypes in prototypes.items():
        assert declared[symbol] == argtypes, symbol


def test_prototype_parser_reads_pointers_ints_and_floats() -> None:
    assert [_ctype(p) for p in ("const void* q", "void *out", "int seq", "float scale", "const float* spec")] == [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_float,
        ctypes.c_void_p,
    ]
