"""``BENCHMARK.json`` against the rules it is held to, and its files found by name."""

from __future__ import annotations

import ast
import json
import re

import pytest

from portbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ser_tpu", "ser"}


def test_top_level_keys_and_paths(benchmark):
    assert set(benchmark) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert benchmark["paths"] == ["portbench"]
    assert benchmark["command"] == ["python3", "portbench/run.py"]
    assert 1 <= benchmark["run_seconds"] <= 51
    cells = len(benchmark["workloads"])
    # A full check of 24 cells at this length fits the driver's 43200 s.
    assert (2 + 14 * 24) * (benchmark["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and len(json.dumps(benchmark)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_keys_names_and_units(benchmark, section):
    names = [entry["name"] for entry in benchmark[section]]
    assert len(names) == len(set(names))
    for entry in benchmark[section]:
        assert set(entry) <= KEYS[section] and NAME.match(entry["name"]), entry
        for key in ("why", "layer", "source"):
            if key in entry:
                assert LINE.match(entry[key]), (entry["name"], key)
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher"), entry
        if section == "end_to_end":
            assert entry["source"] in ("host_clock", "device_trace")
            assert 0.01 <= entry["bound"] <= 0.25
        if section == "per_layer":
            assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_it_must(benchmark):
    cells = {w["name"]: w for w in benchmark["workloads"]}
    configs = {c["name"] for c in benchmark["configs"]}
    for cell in cells.values():
        assert cell["config"] in configs and cell["chips"] in (1, 4) and NAME.match(cell["traffic"])
        end_to_end = {m["name"] for m in spec.metrics_for(benchmark, cell["name"], trace=False)}
        assert "setup_s" in end_to_end and len(end_to_end) >= 2, cell["name"]
        assert spec.metrics_for(benchmark, cell["name"], trace=True), cell["name"]
    for metric in benchmark["end_to_end"] + benchmark["per_layer"]:
        assert set(metric.get("workloads", [])) <= set(cells), metric["name"]
    moved = {m["name"]: set(m.get("workloads", cells)) for m in benchmark["end_to_end"]}
    for metric in benchmark["per_layer"]:
        assert set(metric["workloads"]) <= moved[metric["moves"]], metric["name"]
    assert {c["config"] for c in cells.values()} == configs


def test_every_name_has_its_file(benchmark):
    for config in benchmark["configs"]:
        assert config["file"].startswith("portbench/configs/") and not config["reduced"]
        assert json.loads((spec.ROOT / config["file"]).read_text())["source"].startswith("https://")
    for cell in benchmark["workloads"]:
        loaded = spec.load_cell(benchmark, cell["name"])
        assert (spec.BENCH_DIR / "drivers" / f"{loaded.traffic['entry']}.py").is_file()
        assert (spec.BENCH_DIR / "limits" / f"{cell['name']}.json").is_file()
    for metric in benchmark["end_to_end"] + benchmark["per_layer"]:
        assert callable(spec.load_module("metrics", metric["name"]).read)


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(node.module.split(".")[0])
    return found


def _strings(path) -> list[str]:
    """String constants of a module, docstrings left out."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body
            and isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs]


def test_nothing_imports_jax_or_the_jax_package():
    """By whole top-level name: ``ser_tpu_torch`` begins with ``ser_tpu`` and passes. What the
    benchmark runs neither imports nor names ``bench.py`` or ``chip_smoke.py``."""
    files = sorted(spec.BENCH_DIR.rglob("*.py"))
    assert files
    for path in files:
        assert not _imports(path) & (FORBIDDEN | {"bench", "chip_smoke"}), path
        if "tests" not in path.parts:
            assert not [s for s in _strings(path) if "chip_smoke" in s or "bench.py" in s], path


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((spec.BENCH_DIR / "reference").glob("*.py")):
        assert "ser_tpu_torch" not in _imports(path), path
        assert "ser_tpu_torch" not in path.read_text(encoding="utf-8"), path


def test_the_run_refuses_jax_by_whole_top_level_name(monkeypatch):
    from portbench.harness import program

    monkeypatch.setattr(program.sys, "modules", {"ser_tpu_torch": 1, "ser_tpu_torch.api": 1, "serde": 1})
    assert program.forbidden_loaded() == []
    monkeypatch.setattr(program.sys, "modules", {"ser_tpu.models": 1, "jaxlib": 1, "ser": 1, "flax.linen": 1})
    assert program.forbidden_loaded() == ["flax", "jaxlib", "ser", "ser_tpu"]
