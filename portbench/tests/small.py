"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in a second, for
the harness's tests, and the faults a test plants in the timed path.

The sizes come from two places: ``SMALL`` below, which every cell takes,
and the ``SMALL`` of the cell's reference (``portbench/reference/
<structure>.py``), which sets what is the structure's own, such as its
width. A driver's faults are planted by its plan,
``portbench/tests/faults/<driver>.py``, whose ``plant(monkeypatch, cell,
fault)`` breaks the timed path for each of ``FAULTS``."""

from __future__ import annotations

import dataclasses
import time

from portbench.core import harness, spec

#: The sizes a test run holds: the reads are few, so a structure at its
#: reference's test width stays wider than what they fill, and a wrong
#: bucket shows.
SMALL = {"genome_length": 3000, "reads": 600}
BATCH = 128
#: What a driver's fault plan plants: the state left unchanged, half of
#: each batch left out, one bucket altered where the hash kernel makes it.
FAULTS = ("unchanged", "half", "altered")


#: The file path's cell, which ``BENCHMARK.json`` does not hold yet (its
#: rate spreads too widely for a bound): the tests still drive the file
#: driver, ``count_file`` and the launcher through it.
FILE_CELL = {"name": "cms_short_file", "config": "ecoli_cms_k32",
             "traffic": "short_file", "chips": 1}

_full_cell = spec.cell


def bench() -> dict:
    """``BENCHMARK.json`` with ``FILE_CELL`` added."""
    b = spec.benchmark()
    b["workloads"].append(FILE_CELL)
    return b


def small(name: str) -> spec.Cell:
    c = _full_cell(name, bench())
    ref = spec.module("reference", c.structure)
    if not hasattr(ref, "SMALL"):
        raise AssertionError(f"{ref.__file__} declares no SMALL: the "
                             f"configuration's keys at the CPU test size")
    cfg = {**c.config, **SMALL, **ref.SMALL}
    tr = dict(c.traffic, batch_size=BATCH)
    return dataclasses.replace(c, config=cfg, traffic=tr)


def run(cell: str, driver=None, seed=2**31 + 99, trace=False) -> dict:
    """One run of the small ``cell`` on the CPU, its window 0.2 s."""
    return harness.run_cell(small(cell), seed, 0.2, trace, device="cpu",
                            t_start=time.time(), driver=driver)


def altered(fn):
    """The hash kernel's first bucket moved to another bucket."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        first = out[0]
        first[0, 0] = 1 if int(first[0, 0]) == 0 else 0
        return out
    return wrapped


def from_call(planted, sound, first: int):
    """``planted`` from call ``first`` on, ``sound`` before it."""
    calls = [0]

    def fn(*args, **kwargs):
        calls[0] += 1
        return (planted if calls[0] > first else sound)(*args, **kwargs)
    return fn


class Gated:
    """A monkeypatch whose planted functions start after ``first`` calls."""

    def __init__(self, monkeypatch, first: int):
        self.mp, self.first = monkeypatch, first

    def setattr(self, target, name, planted):
        sound = getattr(target, name)
        self.mp.setattr(target, name, from_call(planted, sound, self.first))


def break_path(monkeypatch, cell, fault, window_only=False):
    """Plant ``fault`` in the program's timed path of ``cell`` by its
    driver's plan; with ``window_only``, in the calls after the warm-up
    pass alone (each pass makes one call a batch)."""
    plan = spec.module("tests/faults", f"{cell.structure}_{cell.path}")
    batch = cell.traffic["batch_size"]
    warm = -(-cell.config["reads"] // batch) if window_only else 0
    plan.plant(Gated(monkeypatch, warm), cell, fault)


def use_small_cells() -> None:
    """In a spawned rank: every cell looked up by name is the small one."""
    spec.cell = small


def drop_exchange() -> None:
    """In a spawned rank: the small cells, with the all-reduce of each
    batch's counts left out, so each rank keeps only its block's counts."""
    from nthash_tpu_torch.parallel import dp

    use_small_cells()
    dp.all_reduce_sum = lambda tensor, mesh: tensor
