"""One run of one cell: set-up, warm-up, the measured window, the trace,
the readers, and the check against the plain reference.

Set-up makes the reads from the seed on the device (and, for a file cell,
writes them as FASTQ under ``TMPDIR``), builds the program's object through
the cell's driver and warms it with one whole pass over the reads, which
builds every kernel and touches every shape the window uses. The window
then runs whole passes until ``seconds`` have gone by, each ending in a
device sync; rates are the reads' bases over the window's whole time.
After the window the peak memory is read, the per-layer readers run (in a
traced run), the program's other state is freed and the reference works
the expected state out again from the same reads, in blocks. The program's
state after ``p`` passes must equal the reference's, exactly: ``p`` times
one pass's counts, or one pass's filter words.

A cell on several cards runs one process a card (``launch``), joined in a
process group over ``tcp://127.0.0.1``; rank 0 writes the file, decides
when the window ends, gathers the others' readings and prints the result.
"""

from __future__ import annotations

import importlib
import json
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import reads as reads_mod
from . import spec as spec_mod
from .trace import Trace, summarize

#: Top-level module names that must not be loaded once the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "nthash_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules() -> list[str]:
    """The forbidden top-level names loaded in this process, compared
    whole (``nthash_tpu_torch`` is not ``nthash_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def power_limit(dev: torch.device) -> str:
    """The card's power limit as nvidia-smi reads it; asked after the
    window, so that the call's time is not in the set-up."""
    if dev.type != "cuda":
        return "none"
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(dev.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        limit = out.stdout.strip() or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return limit


@dataclass
class Context:
    """What the drivers, the references and the readers see of a run."""

    cell: spec_mod.Cell
    seed: int
    device: torch.device
    rank: int = 0
    world: int = 1
    codes: torch.Tensor | None = None      # uint8 [reads, length]
    fastq: Path | None = None
    card: str = "cpu"
    setup_s: float = 0.0
    window_s: float = 0.0
    passes: int = 0                        # passes in the window
    trace: Trace | None = None
    busy_s: float = 0.0                    # mean over the ranks
    setup_parts: dict = field(default_factory=dict)   # seconds by step

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def bases(self) -> int:
        """Bases of every read of the window's passes, N included."""
        return self.passes * self.config["reads"] * self.config["read_length"]

    @property
    def reference(self):
        return spec_mod.module("reference", self.cell.structure)

    def batches(self) -> list[torch.Tensor]:
        """The reads as the resident drivers hand them to the program, in
        order: row blocks of ``batch_size``."""
        b = self.traffic["batch_size"]
        return [self.codes[s:s + b] for s in range(0, self.codes.shape[0], b)]

    def distinct_touched(self) -> int:
        """Cells (counters or words) each of one pass's batches touches,
        summed over the batches: the reference's count."""
        return self.reference.distinct_touched(self)


def _agree(go: bool, ctx: Context) -> bool:
    """Rank 0's decision, on every rank."""
    if ctx.world == 1:
        return go
    import torch.distributed as dist

    flag = torch.tensor([1 if go else 0], dtype=torch.int32,
                        device=ctx.device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _reduce(values: list[float], ctx: Context, op: str) -> list[float]:
    """Sum or max of each value over the ranks."""
    if ctx.world == 1:
        return values
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=ctx.device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX)
    return t.tolist()


def _barrier(ctx: Context) -> None:
    if ctx.world > 1:
        import torch.distributed as dist

        dist.barrier()


def run_cell(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool, *,
             device, t_start: float, rank: int = 0, world: int = 1,
             fastq_dir: Path | None = None,
             driver: str | None = None) -> dict | None:
    """One run; returns the result line's object on rank 0 (None on the
    others). ``driver`` names another driver than the cell's (the control
    uses ``control``)."""
    dev = torch.device(device)
    ctx = Context(cell, seed, dev, rank, world)
    ctx.card = card_name(dev)
    if rank == 0:
        log(f"[card] {ctx.card}, {world} card(s); cell {cell.name}, "
            f"seed {seed}")
    t0 = time.time()
    ctx.codes = reads_mod.make_reads(ctx.config, seed, dev)
    sync(dev)
    ctx.setup_parts["reads"] = time.time() - t0
    own_dir = None
    if cell.path == "file":
        if fastq_dir is None:
            fastq_dir = own_dir = Path(tempfile.mkdtemp(prefix="portbench."))
        ctx.fastq = Path(fastq_dir) / "reads.fastq"
        if rank == 0:
            nbytes = reads_mod.write_fastq(ctx.codes, ctx.fastq)
            log(f"[data] {ctx.config['reads']} reads of "
                f"{ctx.config['read_length']} bp, {nbytes} bytes of FASTQ")
        _barrier(ctx)
        ctx.setup_parts["fastq"] = time.time() - t0 - ctx.setup_parts["reads"]
    try:
        return _run(ctx, seconds, trace, t_start, driver)
    finally:
        if own_dir is not None:
            ctx.fastq.unlink(missing_ok=True)
            own_dir.rmdir()


def _run(ctx: Context, seconds, trace, t_start, driver) -> dict | None:
    cell, dev = ctx.cell, ctx.device
    name = driver or f"{cell.structure}_{cell.path}"
    t0 = time.time()
    drv = spec_mod.module("drivers", name).Driver(ctx)
    sync(dev)
    t1 = time.time()
    counted = [drv.one_pass()]          # the warm-up pass
    sync(dev)
    _barrier(ctx)
    ctx.setup_s = time.time() - t_start
    ctx.setup_parts.update(driver=t1 - t0, warm_up=time.time() - t1)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    ends = []
    while True:
        counted.append(drv.one_pass())
        sync(dev)
        ctx.passes += 1
        ends.append(time.perf_counter() - t0)
        if not _agree(ends[-1] < seconds, ctx):
            break
    ctx.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        ctx.trace = summarize(prof, ctx.window_s)
        del prof
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    (peak,) = _reduce([float(peak)], ctx, "max")
    if ctx.trace is not None:
        (busy,) = _reduce([ctx.trace.busy_s], ctx, "sum")
        ctx.busy_s = busy / ctx.world
    metric_of = {}
    if ctx.rank == 0:
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = spec_mod.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metric_of[m["name"]] = {"value": value, "unit": m["unit"]}
    state = drv.state()
    drv.close()
    del drv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _check(ctx, state, counted)
    del state
    names = list(checks)
    totals = _reduce([float(checks[n]["value"]) for n in names], ctx, "sum")
    for n, v in zip(names, totals):
        checks[n]["value"] = int(v)
    if ctx.rank != 0:
        return None
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = sum(1 for c in counted[1:]
                 if c is not None and c != ctx.config["reads"])
    log(f"[card] {ctx.card}, power limit {power_limit(dev)}")
    log(f"[window] {ctx.passes} passes in {ctx.window_s:.6f} s, "
        f"{ctx.bases} bases; set-up {ctx.setup_s:.6f} s ("
        + ", ".join(f"{k} {v:.3f} s" for k, v in ctx.setup_parts.items())
        + ")")
    laps = sorted(b - a for a, b in zip([0.0] + ends, ends))
    log(f"[window] a pass: least {laps[0]:.6f} s, median "
        f"{laps[len(laps) // 2]:.6f} s, most {laps[-1]:.6f} s")
    out = {
        "correct": correct,
        "attempted": ctx.passes,
        "failed": failed,
        "metrics": metric_of,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": ctx.card,
            "count": ctx.world,
            "memory_peak_bytes": int(peak),
        },
    }
    if ctx.trace is not None:
        out["device"]["busy_s"] = ctx.busy_s
        out["device"]["window_s"] = ctx.window_s
        out["breakdown"] = {
            "device_ops": ctx.trace.top_ops(10),
            "idle_gaps": [[n, s] for n, s in ctx.trace.gaps[:10]],
        }
    out["checks"] = checks
    return out


def _check(ctx: Context, state, counted) -> dict:
    """The numbers compared, each with its limit: the reference's state
    against the program's, and, where the driver reports reads, every read
    counted once a pass."""
    ref = ctx.reference
    t0 = time.perf_counter()
    expected = ref.expected(ctx)
    checks = ref.compare(ctx, state, expected, len(counted))
    del expected
    sync(ctx.device)
    log(f"[reference] {time.perf_counter() - t0:.3f} s")
    if counted[0] is not None:
        want = ctx.config["reads"]
        checks["reads_off"] = {
            "value": sum(abs(int(c) - want) for c in counted), "limit": 0}
    log(f"[state] {ref.describe(ctx, state)}")
    return checks


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(cell_name: str, seed: int, seconds: float, trace: bool,
              rank: int, world: int, port: int, t_start: float,
              fastq_dir: str, device_type: str, hook: str | None) -> None:
    """One rank of a cell on several cards (a spawned process)."""
    if rank:
        sys.stdout = sys.stderr     # only rank 0 writes the result line
    from nthash_tpu_torch.parallel.mesh import initialize_distributed

    if hook:
        mod, fn = hook.split(":")
        getattr(importlib.import_module(mod), fn)()
    device = torch.device("cuda", rank) if device_type == "cuda" else \
        torch.device("cpu")
    initialize_distributed(device_type, init_method=f"tcp://127.0.0.1:{port}",
                           rank=rank, world_size=world)
    import torch.distributed as dist

    try:
        out = run_cell(spec_mod.cell(cell_name), seed, seconds, trace,
                       device=device, t_start=t_start, rank=rank, world=world,
                       fastq_dir=Path(fastq_dir))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        emit(out)


def launch(cell_name: str, seed: int, seconds: float, trace: bool,
           world: int, t_start: float, device_type: str = "cuda",
           hook: str | None = None) -> int:
    """Run one rank a card in spawned processes and wait for all of them;
    returns the worst exit code."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="portbench.") as d:
        procs = [ctx.Process(target=rank_main, args=(
            cell_name, seed, seconds, trace, r, world, port, t_start, d,
            device_type, hook)) for r in range(world)]
        for p in procs:
            p.start()
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode for p in procs):
                # a rank failed: the others would wait in a collective
                for p in procs:
                    if p.exitcode is None:
                        p.terminate()
            time.sleep(0.2)
        for p in procs:
            p.join()
    codes = [p.exitcode for p in procs]
    return next((c for c in codes if c), 0)


def emit(out: dict) -> None:
    """Print the checks on standard error, then the result line last on
    standard output; refuse to print when a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        log(f"[error] loaded after the window: {', '.join(found)}")
        raise SystemExit(3)
    for name, c in out["checks"].items():
        log(f"[check] {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
