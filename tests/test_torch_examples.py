"""The port's examples (``examples/*_torch.py``) run on the CPU
(``--device cpu``) and print what their JAX counterparts print."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("name", ["kmer_hashing", "spaced_seed_hashing",
                                  "dbg_traversal"])
def test_example_runs_on_cpu(name):
    out = _run(f"{name}_torch.py", "--device", "cpu")
    if name == "kmer_hashing":
        want = _run("kmer_hashing.py")
        auto, kernel = out.split("== engine=kernel ==\n")
        assert auto.split("\n", 1)[1] == kernel == want
    elif name == "spaced_seed_hashing":
        want = _run("spaced_seed_hashing.py")
        assert out.split("\n== batched")[0] == want.split("\n== batched")[0]
        assert out.splitlines()[-2:] == want.splitlines()[-2:]
    else:
        want = _run("dbg_traversal.py")
        assert out.splitlines()[0] == want.splitlines()[0]
        assert out.splitlines()[1] == \
            "roll_many over the genome: 81920/81920 windows found in the sketch"


@pytest.mark.parametrize("name", ["streaming_count", "bloom_filter",
                                  "long_sequence"])
def test_multi_device_example_matches_jax(tmp_path, name):
    """The examples of the distributed paths print, on the CPU at world
    size 1, what their JAX counterparts print on one device."""
    if name == "streaming_count":
        path = tmp_path / "reads.fq"
        path.write_text("@a\nACGTACGTNACGTACGTACGTAC\n+\n" + "I" * 23 + "\n"
                        "@b\nTTGACCATGACCAGTAGGACCATGACA\n+\n" + "I" * 27
                        + "\n")
        args = [str(path), "8", "2"]
    else:
        args = ["4096"] if name == "long_sequence" else []
    want = _run(f"{name}.py", *args)
    assert _run(f"{name}_torch.py", *args, "--device", "cpu") == want
