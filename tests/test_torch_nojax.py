"""nthash_tpu_torch imports and runs with JAX absent, and names no JAX."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "nthash_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py")
)


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nthash_tpu'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(n == 'jax' or n.startswith(('jax.', 'jaxlib'))\n"
        "               for n, v in sys.modules.items() if v is not None)\n"
        f"print(len({MODULES!r}))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) == len(MODULES) > 15


def test_main_path_runs_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['nthash_tpu'] = None\n"
        "import numpy as np, torch\n"
        "from nthash_tpu_torch.models.pipeline import fused_count_step\n"
        "from nthash_tpu_torch.models.sketch import CountMinSketch\n"
        "from nthash_tpu_torch.ops.kmer_kernel import prepare_codes\n"
        "codes = torch.from_numpy(np.random.default_rng(0)"
        ".integers(0, 4, size=(16, 40), dtype=np.uint8))\n"
        "sk = fused_count_step(prepare_codes(codes), "
        "CountMinSketch.zeros(2, 10, 'cpu'), 8)\n"
        "print(int(sk.rows[0].sum()))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) == 16 * (40 - 8 + 1)


IMPORT_RE = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|nthash_tpu)\b", re.M)


#: A path lookup of the JAX package's directory: ``"nthash_tpu"`` as a string.
PATH_RE = re.compile(r'["\']nthash_tpu["\']')


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_nthash_tpu_import(path):
    text = path.read_text()
    assert not IMPORT_RE.search(text), f"{path} imports jax or nthash_tpu"
    assert not PATH_RE.search(text), f"{path} names the nthash_tpu directory"


def test_chip_smoke_imports_no_jax():
    text = (ROOT / "chip_smoke.py").read_text()
    assert not IMPORT_RE.search(text)
    assert not PATH_RE.search(text)


def test_parser_source_is_the_ports_own_copy():
    from nthash_tpu_torch.io import native_loader

    assert native_loader.SRC == PKG / "io" / "native" / "fastx.cpp"
    # drift guard: the copy stays byte-identical to the JAX package's source
    jax_src = ROOT / "nthash_tpu" / "io" / "native" / "fastx.cpp"
    assert native_loader.SRC.read_bytes() == jax_src.read_bytes()
