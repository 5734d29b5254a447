"""The check that decides ``correct`` against the faults a cell can have.

Each test skips the harness's look for a card and drives the rest of a run
of a cell cut to a CPU size (``small.py``), on the program's plain CPU
route: sound, it reads correct; with the control in the program's place,
or with the timed path broken underneath (the state left unchanged, half
of each batch left out, one bucket altered where the hash kernel makes it,
the exchange between ranks left out), it must read not correct, also where
the fault spares the warm-up pass and breaks the window's calls alone."""

import time

import pytest
import torch

from nthash_tpu_torch.models import bloom as bloom_mod
from nthash_tpu_torch.models import pipeline
from nthash_tpu_torch.parallel import dp
from portbench.core import harness, spec
from portbench.tests.small import FILE_CELL, small

ONE_CARD = [w["name"] for w in spec.benchmark()["workloads"]
            if w["chips"] == 1] + [FILE_CELL["name"]]


def run(cell, driver=None, seed=2**31 + 99):
    return harness.run_cell(small(cell), seed, 0.2, False, device="cpu",
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


def break_path(monkeypatch, cell, fault, window_only=False):
    """Plant ``fault`` in the program's timed path of ``cell``; with
    ``window_only``, in the calls after the warm-up pass alone (each pass
    makes one call a batch)."""
    name = f"{cell.structure}_{cell.path}"
    drv = spec.module("drivers", name)
    batch = cell.traffic["batch_size"]
    warm = -(-cell.config["reads"] // batch) if window_only else 0
    monkeypatch = Gated(monkeypatch, warm)
    if name == "count_min_file":
        orig = dp.fused_count
        planted = {
            "unchanged": lambda codes, sketch, k, mesh=None: sketch,
            "half": lambda codes, sketch, k, mesh=None: orig(
                codes[:codes.shape[0] // 2], sketch, k, mesh),
        }
        if fault in planted:
            monkeypatch.setattr(dp, "fused_count", planted[fault])
        else:
            monkeypatch.setattr(pipeline, "hash_kmers_tm_auto",
                                altered(pipeline.hash_kmers_tm_auto))
    elif name == "count_min_resident":
        orig = drv.fused_count_step
        planted = {
            "unchanged": lambda tm, sketch, k: sketch,
            "half": lambda tm, sketch, k: orig(
                tm[:, :tm.shape[1] // 2].contiguous(), sketch, k),
        }
        if fault in planted:
            monkeypatch.setattr(drv, "fused_count_step", planted[fault])
        else:
            monkeypatch.setattr(pipeline, "hash_kmers_tm_auto",
                                altered(pipeline.hash_kmers_tm_auto))
    elif name == "bloom_resident":
        orig = bloom_mod.insert_from_buckets
        planted = {
            "unchanged": lambda bf, buckets, **kw: bf,
            "half": lambda bf, buckets, **kw: orig(
                bf, [b[:, :b.shape[1] // 2] for b in buckets], **kw),
        }
        if fault in planted:
            monkeypatch.setattr(bloom_mod, "insert_from_buckets",
                                planted[fault])
        else:
            monkeypatch.setattr(drv, "hash_kmers_tm_auto",
                                altered(drv.hash_kmers_tm_auto))
    else:
        raise AssertionError(f"no fault plan for driver {name}")


class Gated:
    """A monkeypatch whose planted functions start after ``first`` calls."""

    def __init__(self, monkeypatch, first: int):
        self.mp, self.first = monkeypatch, first

    def setattr(self, target, name, planted):
        sound = getattr(target, name)
        self.mp.setattr(target, name, from_call(planted, sound, self.first))


@pytest.mark.parametrize("cell", ONE_CARD)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_is_not_correct(cell):
    out = run(cell, driver="control")
    assert not out["correct"]


@pytest.mark.parametrize("window_only", [False, True],
                         ids=["every_call", "window_only"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ONE_CARD)
def test_fault_is_not_correct(monkeypatch, cell, fault, window_only):
    """The fault in every call, and in the window's calls alone: a fault
    that spares the warm-up must still show in the state compared."""
    break_path(monkeypatch, small(cell), fault, window_only)
    assert not run(cell)["correct"]


def test_same_seed_same_state():
    a, b = run(ONE_CARD[0]), run(ONE_CARD[0])
    assert a["checks"] == b["checks"]


def launch_two(capfd, hook):
    rc = harness.launch(FILE_CELL["name"], 2**31 + 7, 0.2, False, 2,
                        time.time(), device_type="cpu", hook=hook)
    out = capfd.readouterr().out.strip().splitlines()[-1]
    return rc, out


def test_ranks_sound_and_without_exchange(capfd):
    """Two gloo ranks on the CPU: the merged sketch is right on every rank;
    without the all-reduce each rank keeps its own block's counts."""
    import json

    rc, line = launch_two(capfd, "portbench.tests.small:use_small_cells")
    assert rc == 0 and json.loads(line)["correct"]
    rc, line = launch_two(capfd, "portbench.tests.small:drop_exchange")
    assert rc == 0 and not json.loads(line)["correct"]


@pytest.mark.cuda
def test_small_cells_on_the_card(cuda):
    for cell in ONE_CARD:
        out = harness.run_cell(small(cell), 11, 0.2, True, device="cuda:0",
                               t_start=time.time())
        assert out["correct"] and out["device"]["busy_s"] > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
