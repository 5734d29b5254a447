"""The benchmark of nthash_tpu_torch on NVIDIA cards: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json``
(``portbench/core/spec.py``). Standard output's last line is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with the reference beside its limit. Everything else goes to standard
error. Exits non-zero, printing no result, where the checkout holds no
``nthash_tpu_torch``, without enough CUDA cards, or with JAX or the JAX
package loaded once the window has closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# every cache a library might keep goes to a fixed directory of the checkout
CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench.core import harness, spec

    cell = spec.cell(args.workload)
    import nthash_tpu_torch

    if ROOT not in Path(nthash_tpu_torch.__file__).resolve().parents:
        harness.log(f"[error] nthash_tpu_torch loads from "
                    f"{nthash_tpu_torch.__file__}, not from this checkout")
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        harness.log(f"[error] {cell.name} needs {cell.chips} CUDA card(s), "
                    f"found {have}")
        return 2
    if cell.chips == 1:
        out = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), device="cuda:0",
                               t_start=T_START)
        harness.emit(out)
        return 0
    return harness.launch(cell.name, args.seed, args.seconds,
                          bool(args.trace), cell.chips, T_START)


if __name__ == "__main__":
    sys.exit(main())
