"""Finding a cell and what it names, by name, in files of their own.

``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
the configurations and the metrics. A cell names a configuration, whose
sizes are ``portbench/configs/<name>.json``, and a traffic mix,
``portbench/traffic/<name>.json``. The configuration's ``structure`` and the
mix's ``path`` name the driver that runs the program
(``portbench/drivers/<structure>_<path>.py``), and the structure names the
plain reference that judges it (``portbench/reference/<structure>.py``).
Every metric is read by ``portbench/metrics/<name>.py``. So a cell, a
configuration, a mix or a metric is added by adding files and entries.

A cell of a new structure brings, each in a file of its own:

- the driver, ``drivers/<structure>_<path>.py``: ``Driver(ctx)`` builds the
  program's object from ``ctx.batches()`` (or ``ctx.fastq``) and the
  configuration; ``one_pass()`` runs one pass over the reads (returning
  the reads it counted, or None); ``state()`` gives the tensor compared;
  ``close()`` drops the program's state;
- the reference, ``reference/<structure>.py``, plain PyTorch from the
  definition, importing nothing of the program: ``zeros(ctx)``,
  ``add_pass(ctx, state, bits=64)`` (``bits=32`` is the control),
  ``expected(ctx)``, ``compare(ctx, state, one_pass, passes)`` (each number
  beside its limit), ``describe(ctx, state)``, ``distinct_touched(ctx)``
  (the cells a pass's batches touch, for a scatter's roofline) and
  ``SMALL``, the configuration's keys at the CPU tests' size;
- the fault plan, ``tests/faults/<structure>_<path>.py``:
  ``plant(monkeypatch, cell, fault)`` breaks the driver's timed path for
  each of ``tests/small.FAULTS`` through ``monkeypatch.setattr``, finding
  the driver's module from ``cell`` and not by a fixed name;
- a roofline reader for each kernel layer it adds,
  ``metrics/<kernel>_roofline.<path>.py``: ``read(ctx)``, and beside it
  ``KERNELS``, the kernels it times, and ``SPAN``, the program's span
  around their launches, which the card test of the spans checks them
  against;
- in ``BENCHMARK.json``, its configuration, its cell, and the cell's name
  in the ``workloads`` of every metric the cell reports (the shared
  resident readers, and its own rooflines).
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # portbench/
ROOT = HERE.parent                               # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]     # the metrics this cell reports, in order
    per_layer: list[dict]

    @property
    def structure(self) -> str:
        return self.config["structure"]

    @property
    def path(self) -> str:
        return self.traffic["path"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def reports(metric: dict, cell: str, e2e_here: set[str]) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists; without a list, every cell for an end-to-end metric, and every
    cell that reports what it ``moves`` for a per-layer one."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_here


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (by default ``BENCHMARK.json``)."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = load_json(ROOT / cfg["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


_modules: dict = {}


def module(kind: str, name: str):
    """Load ``portbench/<kind>/<name>.py`` by its path (a metric's name may
    hold dots), once a process."""
    if (kind, name) in _modules:
        return _modules[kind, name]
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        re.sub(r"[./]", "_", f"portbench_{kind}_{name}"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _modules[kind, name] = mod
    return mod
