"""A cell of a structure the benchmark does not have joins it by new files
and entries alone.

In a copy of ``portbench/`` and ``BENCHMARK.json``, with ``spec`` pointed
at the copy, a structure ``toy`` is added: count-min's driver, reference
(with its ``SMALL``) and fault plan under the new name, a configuration
that names the structure, a cell, and the cell's name in the ``workloads``
of the metrics whose readers read any resident cell. No file the copy
held changes but ``BENCHMARK.json``, which only gains entries. The cell
then runs through the paths the rest of the suite runs: sound it reads
correct; the control, and each fault in every call and in the window's
calls alone, read not correct; a traced run reads the dispatch metrics."""

import hashlib
import json
import shutil

import pytest

from portbench.core import spec
from portbench.tests.small import FAULTS, break_path, run, small

STRUCTURE = "toy"
CONFIG = "toy_k32"
CELL = "toy_short_resident"
#: The new structure's files, each a copy of count-min's.
COPIES = {
    "drivers/count_min_resident.py": f"drivers/{STRUCTURE}_resident.py",
    "reference/count_min.py": f"reference/{STRUCTURE}.py",
    "tests/faults/count_min_resident.py":
        f"tests/faults/{STRUCTURE}_resident.py",
}
#: The metrics whose readers read any resident cell, whatever its
#: structure.
RESIDENT = ("resident_bases_per_s", "device_idle_share.resident",
            "kmer_hash_roofline.resident", "host_ms_per_batch.resident",
            "idle_in_program_share.resident",
            "span_window_idle_share.resident")


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def grown(old, new) -> bool:
    """Whether ``new`` is ``old`` with entries added: new keys, and items
    at the ends of lists."""
    if isinstance(old, dict):
        return isinstance(new, dict) and all(
            k in new and grown(v, new[k]) for k, v in old.items())
    if isinstance(old, list):
        return isinstance(new, list) and len(new) >= len(old) and all(
            grown(a, b) for a, b in zip(old, new))
    return old == new


def add_structure(root) -> None:
    """The new structure's files and entries, written into the copy."""
    here = root / "portbench"
    for src, dst in COPIES.items():
        assert not (here / dst).exists(), dst
        (here / dst).write_bytes((here / src).read_bytes())
    cfg = spec.load_json(here / "configs" / "ecoli_cms_k32.json")
    cfg.update(name=CONFIG, structure=STRUCTURE)
    (here / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    bench = spec.load_json(root / "BENCHMARK.json")
    base = next(c for c in bench["configs"] if c["name"] == "ecoli_cms_k32")
    bench["configs"].append(dict(base, name=CONFIG,
                                 file=f"portbench/configs/{CONFIG}.json"))
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "short_resident",
        "chips": 1, "why": "count-min's path under a structure of its own"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in RESIDENT:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The copy with the structure added, and what it held before."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root)
    before = digests(root), spec.load_json(root / "BENCHMARK.json")
    add_structure(root)
    monkeypatch.setattr(spec, "HERE", root / "portbench")
    monkeypatch.setattr(spec, "ROOT", root)
    monkeypatch.setattr(spec, "_modules", {})
    return root, before


def test_only_files_and_entries_added(toy):
    root, (files, bench) = toy
    after = digests(root)
    changed = [str(p) for p, d in files.items() if after[p] != d]
    assert changed == ["BENCHMARK.json"]
    assert grown(bench, spec.benchmark())
    added = {str(p) for p in set(after) - set(files)}
    assert added == {f"portbench/{p}" for p in
                     [*COPIES.values(), f"configs/{CONFIG}.json"]}
    assert spec.cell(CELL).structure == STRUCTURE


def test_sound_run_is_correct(toy):
    out = run(CELL)
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["metrics"]["resident_bases_per_s"]["value"] > 0


def test_control_is_not_correct(toy):
    assert not run(CELL, driver="control")["correct"]


@pytest.mark.parametrize("window_only", [False, True],
                         ids=["every_call", "window_only"])
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(toy, monkeypatch, fault, window_only):
    break_path(monkeypatch, small(CELL), fault, window_only)
    assert not run(CELL)["correct"]


def test_traced_run_reads_the_dispatch_metrics(toy):
    out = run(CELL, seed=2**31 + 17, trace=True)
    got = out["metrics"]
    assert out["correct"]
    assert got["host_ms_per_batch.resident"]["value"] > 0
    inside = got["idle_in_program_share.resident"]["value"]
    assert 0 < inside <= got["span_window_idle_share.resident"]["value"] <= 100


def test_missing_plan_is_named(toy, monkeypatch):
    root, _ = toy
    (root / "portbench" / COPIES["tests/faults/count_min_resident.py"]
     ).unlink()
    with pytest.raises(FileNotFoundError, match=f"{STRUCTURE}_resident.py"):
        break_path(monkeypatch, small(CELL), FAULTS[0])


def test_missing_small_is_named(toy):
    root, _ = toy
    path = root / "portbench" / COPIES["reference/count_min.py"]
    text = path.read_text()
    path.write_text(text.replace('SMALL = {"width_log2": 14}', ""))
    with pytest.raises(AssertionError, match=f"reference/{STRUCTURE}.py"):
        small(CELL)
