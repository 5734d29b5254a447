"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in a second, for
the harness's tests, and the faults a test plants in the timed path."""

from __future__ import annotations

import dataclasses

from portbench.core import spec

#: The sizes a test run holds: widths stay above the few buckets the
#: reads fill, so a wrong bucket shows.
SMALL = {"genome_length": 3000, "reads": 600}
WIDTH = {"count_min": 14, "bloom": 18}
BATCH = 128


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
    cfg = dict(c.config, **SMALL, width_log2=WIDTH[c.config["structure"]])
    tr = dict(c.traffic, batch_size=BATCH)
    return dataclasses.replace(c, config=cfg, traffic=tr)


def use_small_cells() -> None:
    """In a spawned rank: every cell looked up by name is the small one."""
    spec.cell = small


def drop_exchange() -> None:
    """In a spawned rank: the small cells, with the all-reduce of each
    batch's counts left out, so each rank keeps only its block's counts."""
    from nthash_tpu_torch.parallel import dp

    use_small_cells()
    dp.all_reduce_sum = lambda tensor, mesh: tensor
