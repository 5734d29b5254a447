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

from portbench.core import harness, spec
from portbench.tests.small import FAULTS, FILE_CELL, break_path, run, small

ONE_CARD = [w["name"] for w in spec.benchmark()["workloads"]
            if w["chips"] == 1] + [FILE_CELL["name"]]


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
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ONE_CARD)
def test_fault_is_not_correct(monkeypatch, cell, fault, window_only):
    """The fault in every call, and in the window's calls alone: a fault
    that spares the warm-up must still show in the state compared. Each
    driver's plan is ``portbench/tests/faults/<driver>.py``: a driver
    without one fails here."""
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
