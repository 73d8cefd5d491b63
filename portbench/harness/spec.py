"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<name>.json`` through the entry's ``file``) and a
traffic mix (``traffic/<traffic>.json``), and has the limits of its check
(``limits/<cell>.json``); the mix names its entry driver
(``drivers/<entry>.py``); every metric is read by ``metrics/<name>.py``. Adding a cell,
a configuration, a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"


@dataclass(frozen=True)
class Cell:
    """One workload: its entry in ``BENCHMARK.json``, its configuration and its traffic mix."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text(encoding="utf-8"))


def load_cell(benchmark: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic files read."""
    entries = {w["name"]: w for w in benchmark["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {', '.join(entries)})")
    entry = entries[name]
    config_entry = next(c for c in benchmark["configs"] if c["name"] == entry["config"])
    config = json.loads((root / config_entry["file"]).read_text(encoding="utf-8"))
    traffic = json.loads((root / "portbench" / "traffic" / f"{entry['traffic']}.json").read_text(encoding="utf-8"))
    limits = json.loads((root / "portbench" / "limits" / f"{name}.json").read_text(encoding="utf-8"))
    return Cell(name, int(entry["chips"]), config, traffic, limits)


def metrics_for(benchmark: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones untraced, its per-layer ones traced.

    An end-to-end metric without ``workloads`` is every cell's. A per-layer metric without
    ``workloads`` is that of every cell that reports the end-to-end metric it moves.
    """
    end_to_end = [m for m in benchmark["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return end_to_end
    reported = {m["name"] for m in end_to_end}
    return [m for m in benchmark["per_layer"] if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (a metric's name may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
