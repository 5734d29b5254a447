"""BENCHMARK.json against the files the harness and its tests find by
name, and the rules the harness keeps: every metric's ``moves`` is an
end-to-end metric that each of its cells reports, every cell reports
set-up, another end-to-end metric and a per-layer one, and no module of
the benchmark imports JAX or the JAX package (top-level names compared
whole)."""

import ast
import re
from pathlib import Path

import pytest

from portbench.core import harness, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    cells = len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_reports(cell):
    c = spec.cell(cell)
    assert (spec.HERE / "drivers" / f"{c.structure}_{c.path}.py").exists()
    assert (spec.HERE / "reference" / f"{c.structure}.py").exists()
    assert (spec.HERE / "tests" / "faults" / f"{c.structure}_{c.path}.py"
            ).exists()
    assert set(spec.module("reference", c.structure).SMALL) <= set(c.config)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (spec.HERE / "metrics" / f"{metric['name']}.py").exists()
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        for cell in metric.get("workloads", CELLS):
            mv = e2e[metric["moves"]]
            assert cell in mv.get("workloads", CELLS)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = spec.load_json(spec.ROOT / cfg["file"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert set(data["reduced"]) == set(cfg["reduced"])
    assert data["assumed"]
    for key in ("structure", "k", "num_hashes", "width_log2", "genome_length",
                "reads", "read_length", "substitution_rate", "n_rate"):
        assert key in data
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def top_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(spec.HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not top_imports(path) & set(harness.FORBIDDEN)


def test_forbidden_modules_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "nthash_tpu_torchx", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nthash_tpu.ops", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["nthash_tpu"]
    with pytest.raises(SystemExit):
        harness.emit({"checks": {}, "correct": True})
