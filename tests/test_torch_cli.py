"""CLI (`python -m nthash_tpu_torch count`) smoke tests on the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest

from nthash_tpu_torch.__main__ import main

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def toy(tmp_path):
    fa = tmp_path / "toy.fa"
    fa.write_text(">r1\nACGTACGTACGTACGT\n>r2\nACGTNNACGTACGTAC\n")
    return fa


def test_count_fused(toy, capsys):
    assert main(["count", str(toy), "-k", "4", "--batch-size", "8",
                 "--width-log2", "12", "--fused", "--device", "cpu"]) == 0
    # r1: 13 windows; r2: 13 windows - 5 overlapping the NN island = 8
    assert capsys.readouterr().out.startswith("2 reads, 21 valid 4-mers")


def test_count_full_hashes(toy, capsys):
    assert main(["count", str(toy), "-k", "4", "-n", "2", "--batch-size", "8",
                 "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("21 valid 4-mers")


@pytest.mark.parametrize("args", [
    ["count", "/nonexistent.fa", "--device", "cpu"],
    ["count", "{toy}", "--width-log2", "31", "--device", "cpu"],
    ["count", "{toy}", "-k", "0", "--fused", "--device", "cpu"],
])
def test_count_errors_exit_1(toy, capsys, args):
    assert main([a.format(toy=toy) for a in args]) == 1
    assert capsys.readouterr().err


def test_default_width_is_2_20(toy, monkeypatch):
    """The CLI's default sketch width is the JAX CLI's, 2**20."""
    from nthash_tpu_torch.models import pipeline

    widths = []
    real = pipeline.ReadHashingPipeline.__init__

    def spy(self, config, device="cuda"):
        widths.append(config.sketch_width_log2)
        real(self, config, device)

    monkeypatch.setattr(pipeline.ReadHashingPipeline, "__init__", spy)
    assert main(["count", str(toy), "-k", "4", "--fused", "--device",
                 "cpu"]) == 0
    assert widths == [20]


def test_python_dash_m(toy):
    proc = subprocess.run(
        [sys.executable, "-m", "nthash_tpu_torch", "count", str(toy), "-k",
         "4", "--fused", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("2 reads, 21 valid 4-mers")



def test_count_threads_option(toy, capsys):
    """``count --threads`` is the JAX CLI's option (default 1): at one
    thread and at four (byte-range shards), with and without ``--fused``,
    the port prints the JAX CLI's total."""
    from nthash_tpu.__main__ import main as jmain

    for threads in ("1", "4"):
        args = ["count", str(toy), "-k", "4", "-n", "2", "--batch-size", "8",
                "--width-log2", "12", "--threads", threads]
        assert jmain(args) == 0
        want = capsys.readouterr().out.split(" in ")[0]
        assert main([*args, "--device", "cpu"]) == 0
        assert capsys.readouterr().out.split(" in ")[0] == want \
            == "21 valid 4-mers"
        assert main([*args, "--fused", "--device", "cpu"]) == 0
        assert capsys.readouterr().out.startswith(f"2 reads, {want}")


def test_hash_golden_first_line(capsys):
    assert main(["hash", "-k", "5", "-n", "3", "TGACTGATCGAGTCGTACTAG",
                 "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 17
    assert lines[0].split()[:2] == ["TGACT", "606f60c2a6fd7d2d"]


@pytest.mark.parametrize("args", [
    ["-k", "5", "-n", "1", "TGACTGATCGAGTCGTACTAG"],
    ["-k", "5", "-s", "10101", "-s", "11011", "-n", "3",
     "TGACTGATCGAGTCGTACTAG", "ACGTNACGTACGTAGTCAGT"],
    ["-k", "7", "-n", "2", "ACGTNNACGTACGTAGTCAGTACCA", "GGGGCCCCAAAATTTT"],
    ["-k", "0", "ACGT"],
    ["-k", "9", "ACGT"],
    ["-k", "5", "-s", "111", "ACGTACGT"],
])
def test_hash_output_equals_jax_cli(capsys, args):
    """The port's ``hash`` prints what the JAX CLI prints, to stdout and
    stderr, with the same exit code."""
    from nthash_tpu.__main__ import main as jmain

    want_rc = jmain(["hash", *args])
    want = capsys.readouterr()
    assert main(["hash", *args, "--device", "cpu"]) == want_rc
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    assert want.out or want.err


def test_hash_stdin_equals_jax_cli(capsys, monkeypatch):
    import io

    from nthash_tpu.__main__ import main as jmain

    text = "ACGTACGTTGCA\n\nTTGCANNNACGTAGCTAGC\n"
    outs = []
    for fn, extra in ((jmain, []), (main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.StringIO(text))
        assert fn(["hash", "-k", "6", "-n", "2", *extra]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 7 + 6


def test_hash_python_dash_m():
    proc = subprocess.run(
        [sys.executable, "-m", "nthash_tpu_torch", "hash", "-k", "5",
         "TGACTGATCGAGTCGTACTAG", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("TGACT 606f60c2a6fd7d2d\n")


def test_public_names_are_the_jax_ones_less_u64():
    import nthash_tpu
    import nthash_tpu_torch

    assert nthash_tpu_torch.__all__ == \
        [n for n in nthash_tpu.__all__ if n != "U64"]
    for name in nthash_tpu_torch.__all__:
        assert getattr(nthash_tpu_torch, name) is not None
    assert nthash_tpu_torch.NTHASH_FN_NAME == nthash_tpu.NTHASH_FN_NAME
