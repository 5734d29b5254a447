"""The control of a cell: the plain reference put in the program's place,
in 32-bit words instead of ntHash2's 64 (``drivers/control.py``), driven
through the rest of a run at the cell's own size, once a seed. The check
must read it not correct; the numbers it prints are the upper readings the
limits are set below. Not run by the benchmark's own runs.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--seconds 1]
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    from portbench.core import harness, spec

    cell = spec.cell(args.workload)
    for seed in args.seeds:
        out = harness.run_cell(cell, seed, args.seconds, False,
                               device="cuda:0", t_start=time.time(),
                               driver="control")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
