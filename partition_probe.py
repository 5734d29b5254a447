"""Probe of the partition kernels on one GPU, beside an earlier build of them.

    python3 partition_probe.py [--parent CSRC] [--rounds N]

On ``chip_smoke.py``'s inputs (the 1M reads, ``--seed 0``): the 2**20 plan
(the reads' buckets, four batches of [4, 480, 512, 128]) and the 2**30 plan
(the Bloom path's buckets, four batches of [1, 64, 16384, 128]). Prints,
per 1M reads (the sum over the four batches of each batch's timing), with
the card's name and power limit on every line:

1. ``merge_phase`` over all of a plan's rounds and ``partition_bounds``,
   the package's kernels beside those of ``--parent`` (a ``csrc/`` of an
   earlier tree, whose ``partition.cu`` is built here under another name
   and called through its own C entries and host code), in turns, each
   output checked equal to the package's; ``torch.searchsorted`` over the
   prepared row maxima beside the table;
2. the partitioned functions whole (``partitioned_histogram_rows`` at
   2**20, ``partitioned_bloom_words`` at 2**30), with the package's kernels
   and with the parent's swapped in, in turns;
3. every merge round of both plans by each split of its strides of a
   tile and more: the last c of them across a thread-block cluster of 2**c
   tiles (c = 0 .. 3), the rest in grouped passes through device memory,
   then the span pass (``merge_plan`` picks one split a round);
4. where a ``partition_bounds`` call's time goes: the host clock of a
   ctypes call, ``cudaSetDevice`` and empty launches from C (a small
   source built here) and of two stream lookups; the table kernel at 256
   to 2,048 rows a block (copies of ``partition.cu`` with its constants
   edited, built here, checked equal); the wrapper, its C entry
   alone, the flags launch alone, the host's allocation and stream lookup,
   and device time by kernel beside ``torch.searchsorted`` (maxima hot in
   L2, and after a 64 MB write);
5. one grouped pass by the strides it runs (1 to 6), on 16 chunks of 2**23
   ints, at the top strides of their last round.

Needs one CUDA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from nthash_tpu_torch.ops import cuda_build
from nthash_tpu_torch.ops import part_kernel as pk
from nthash_tpu_torch.utils.profiling import timeit, trace_device


def build_parent(csrc: Path, tmp: Path) -> ctypes.CDLL:
    """``csrc/partition.cu`` built as ``libpartition_parent.so`` in tmp,
    with the argument types of its C entries (the parent's ABI)."""
    src = tmp / "partition_parent.cu"
    src.write_text((csrc / "partition.cu").read_text())
    out = tmp / "libpartition_parent.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the parent's partition.cu:\n"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    for fn, args in ((lib.nthash_merge_phase, [i, vp, ll, ll, i, ll, vp]),
                     (lib.nthash_partition_bounds,
                      [i, vp, ll, i, i, i, i, vp, vp, vp])):
        fn.restype = ctypes.c_int
        fn.argtypes = args
    lib.nthash_cuda_error_string.restype = ctypes.c_char_p
    lib.nthash_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def parent_kernels(lib: ctypes.CDLL):
    """(merge_phase, partition_bounds) with the parent's C entries and the
    parent's host code around them."""

    def merge_phase(x, tile, k):
        dev = x.device
        cuda_build.check(lib, lib.nthash_merge_phase(
            dev.index, x.data_ptr(), x.numel(), x.shape[2] * pk.LANES, tile,
            k, pk._stream(dev)), "parent merge_phase")

    def partition_bounds(srt, sub_log2, p_log2, cap):
        r, g, rows = pk._check_chunks(srt)
        dev = srt.device
        p = 1 << p_log2
        fb = torch.empty((r, g, p), dtype=torch.int32, device=dev)
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
        flags[1] = 1
        if r * g:
            cuda_build.check(lib, lib.nthash_partition_bounds(
                dev.index, srt.data_ptr(), r * g, rows, sub_log2, p, cap,
                fb.data_ptr(), flags.data_ptr(), pk._stream(dev)),
                "parent partition_bounds")
        return fb, flags

    return merge_phase, partition_bounds


@contextlib.contextmanager
def swapped(merge_phase, partition_bounds):
    """The package's functions route through the given kernels meanwhile."""
    saved = pk.merge_phase, pk.partition_bounds
    pk.merge_phase, pk.partition_bounds = merge_phase, partition_bounds
    try:
        yield
    finally:
        pk.merge_phase, pk.partition_bounds = saved


def turns(fns: dict, run, rounds: int) -> dict:
    """{name: [seconds per 1M reads, one a round]}: ``run(fn)`` gives one
    function's seconds over the four batches; rounds alternate the order."""
    names = list(fns)
    got = {name: [] for name in names}
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
            got[name].append(run(fns[name]))
            torch.cuda.empty_cache()
    return got


def show(label: str, got: dict, card: str, bound: float | None = None) -> None:
    extra = "" if bound is None else f"; bound {bound * 1e3:.4f} ms"
    parts = ", ".join(f"{name} {' / '.join(f'{v * 1e3:.4f}' for v in vals)}"
                      for name, vals in got.items())
    print(f"[time] {label} per {cs.N_READS} reads, ms by round: {parts}"
          f"{extra} [{card}]")


def merge_all(merge, tile):
    """All merge rounds of a tile-sorted tensor, in place, by ``merge``."""
    def run(x):
        for k in cs.merge_rounds(x.shape[2] * pk.LANES, tile):
            merge(x, tile, k)
    return run


def compare_plan(wl: int, batches: list, parent, card: str,
                 rounds: int) -> None:
    """Section 1 at the plan for 2**wl."""
    p_log2, sub_log2, rows, cap = pk.plan(wl)
    p_merge, p_bounds = parent
    tiles = [pk.sort_tiles(b) for b in batches]
    tile = tiles[0][1]
    for (x, _), chunks in zip(tiles, batches):   # same outputs
        a, b = x.clone(), x.clone()
        merge_all(pk.merge_phase, tile)(a)
        merge_all(p_merge, tile)(b)
        cs.require(torch.equal(a, b) and torch.equal(a, pk._sort_plain(chunks)),
                   f"merge at the 2**{wl} plan: package != parent or sort")
        fa, ga = pk.partition_bounds(a, sub_log2, p_log2, cap)
        fb, gb = p_bounds(a, sub_log2, p_log2, cap)
        cs.require(torch.equal(fa, fb) and torch.equal(ga, gb),
                   f"partition_bounds at the 2**{wl} plan: package != parent")
        del a, b
    nbytes = sum(b.numel() for b in batches) * 4
    nround = len(cs.merge_rounds(rows * pk.LANES, tile))
    show(f"merge_phase ({nround} rounds) at the 2**{wl} plan",
         turns({"package": pk.merge_phase, "parent": p_merge},
               lambda m: sum(cs.time_prepared(x.clone, merge_all(m, tile))
                             for x, _ in tiles), rounds),
         card, cs.bound_ms(2 * nbytes * nround) / 1e3)
    srts = [pk._sorted(b) for b in batches]
    del tiles
    inputs = [cs.searchsorted_inputs(s, sub_log2, p_log2) for s in srts]
    fns = {"package": pk.partition_bounds, "parent": p_bounds}

    def table(fn):
        if fn == "searchsorted":
            return sum(timeit(lambda a, q: torch.searchsorted(a, q, side="left"),
                              a, q).seconds_per_call for a, q in inputs)
        return sum(timeit(lambda x: fn(x, sub_log2, p_log2, cap),
                          s).seconds_per_call for s in srts)

    fns["torch.searchsorted"] = "searchsorted"
    chunks = sum(s.shape[0] * s.shape[1] for s in srts)
    show(f"partition_bounds at the 2**{wl} plan", turns(fns, table, rounds),
         card, cs.bound_ms((chunks * (rows + (1 << p_log2)) + 2) * 4) / 1e3)
    print(f"[time] partition_bounds at the 2**{wl} plan: sector floor "
          f"{cs.bound_ms(chunks * (rows * 32 + (1 << p_log2) * 4)):.4f} ms "
          f"[{card}]")
    del srts, inputs
    torch.cuda.empty_cache()


def compare_whole(codes, dev, parent, card: str, rounds: int) -> None:
    """Section 2: the partitioned functions whole, package against parent."""
    sketch_in = cs.path_buckets(codes, cs.WIDE, dev)
    words_in = [torch.stack([x.reshape(-1) for x in cs.hash_kmers_tm(
        tm, cs.K, cs.H, emit_buckets=30)]).reshape(1, -1)
        for tm in cs.bloom_tms(codes, dev)]
    for label, inputs, fn in (
            ("partitioned_histogram_rows at 2**20", sketch_in,
             lambda x: pk.partitioned_histogram_rows(x, cs.WIDE)),
            ("partitioned_bloom_words at 2**30", words_in,
             lambda x: pk.partitioned_bloom_words(x, 30))):
        want = [fn(x) for x in inputs]
        with swapped(*parent):
            cs.require(all(torch.equal(fn(x), w) for x, w in zip(inputs, want)),
                       f"{label}: parent kernels != package kernels")
        del want

        def run(kernels, inputs=inputs, fn=fn):
            with swapped(*kernels) if kernels else contextlib.nullcontext():
                return sum(timeit(fn, x).seconds_per_call for x in inputs)

        show(label, turns({"package": None, "parent": parent}, run, rounds),
             card)
        torch.cuda.empty_cache()
    del sketch_in, words_in


def cluster_options(chunk: int, k: int) -> dict:
    """Round k's launches with the last c strides of a tile and more in a
    cluster of 2**c tiles (c = 0: no cluster) and the strides above in
    grouped passes of at most four, split evenly: {c: (passes, c)}."""
    tile = pk.MERGE_MAX_SPAN
    s = (k // tile).bit_length() - 1
    out = {}
    for c in range(min(s, 3) + 1):
        strides = [(k // 2) >> i for i in range(s - c)]
        passes, i = [], 0
        left = -(-len(strides) // pk.MERGE_MAX_GROUP)
        while left:
            g = -(-(len(strides) - i) // left)
            passes.append((strides[i], g))
            i += g
            left -= 1
        out[c] = tuple(passes)
    return out


def merge_designs(batches30: list, batches20: list, card: str,
                  rounds: int) -> None:
    """Section 3: every round of both plans by each split of its strides of
    a tile and more between a cluster of 2**c tiles and grouped passes, c =
    0 .. 3, each checked against plain on batch 0 and timed in turns."""
    lib = pk._lib()
    tile = pk.MERGE_MAX_SPAN
    for wl, batches in ((cs.WIDE, batches20), (30, batches30)):
        chunk = batches[0].shape[2] * pk.LANES
        state = [pk.sort_tiles(b)[0] for b in batches]
        for k in cs.merge_rounds(chunk, tile):
            opts = cluster_options(chunk, k)

            def run(c, x, k=k, opts=opts):
                for j, g in opts[c]:
                    cuda_build.check(lib, lib.nthash_merge_strides(
                        x.device.index, x.data_ptr(), x.numel(), chunk, k,
                        j >> (g - 1), g, pk._stream(x.device)), "probe")
                cuda_build.check(lib, lib.nthash_merge_span(
                    x.device.index, x.data_ptr(), x.numel(), chunk, k, tile,
                    1 << c, pk._stream(x.device)), "probe")

            want = pk.merge_phase_plain(state[0], k)
            for c in opts:
                got = state[0].clone()
                run(c, got)
                cs.require(torch.equal(got, want),
                           f"2**{wl} plan round {k}: cluster of {1 << c} "
                           "!= plain")
            del got, want
            plan = pk.merge_plan(chunk, k)
            got = turns({c: c for c in opts}, lambda c: sum(
                cs.time_prepared(x.clone, lambda y, c=c: run(c, y))
                for x in state), rounds)
            show(f"merge round {k} at the 2**{wl} plan by cluster of 2**c "
                 f"tiles (c: grouped passes {dict(opts)}; the plan: "
                 f"{plan[0]}, cluster {plan[2]})",
                 {f"c={c}": v for c, v in got.items()}, card,
                 cs.bound_ms(2 * sum(x.numel() for x in state) * 4) / 1e3)
            for x in state:
                pk.merge_phase(x, tile, k)
            torch.cuda.empty_cache()
        del state
        torch.cuda.empty_cache()


HOST_PROBE = r"""
#include <cuda_runtime.h>
__global__ void probe_empty_kernel(int* p) { if (p) p[0] = 0; }
extern "C" {
int probe_nothing(int, void*, long long, int, int, int, int, void*, void*,
                  void*) { return 0; }
int probe_set_device(int device) { return cudaSetDevice(device); }
int probe_launches(int device, int n, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    probe_empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(nullptr);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
}
"""


def host_costs(tmp: Path, dev, card: str) -> None:
    """Host clock a call: a ctypes call of the table entry's signature to
    an empty C function, cudaSetDevice, one and two empty launches from C,
    and the two ways to read the current stream."""
    src = tmp / "host_probe.cu"
    src.write_text(HOST_PROBE)
    out = tmp / "libhost_probe.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(out), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.probe_nothing.argtypes = [i, vp, ll, i, i, i, i, vp, vp, vp]
    lib.probe_set_device.argtypes = [i]
    lib.probe_launches.argtypes = [i, i, vp]
    stream = pk._stream(dev)
    costs = {}
    for name, fn in (
            ("ctypes, 10 arguments", lambda: lib.probe_nothing(
                0, 1 << 40, 3, 4, 5, 6, 7, 1 << 41, 1 << 42, stream)),
            ("cudaSetDevice", lambda: lib.probe_set_device(dev.index)),
            ("one empty launch", lambda: lib.probe_launches(dev.index, 1,
                                                            stream)),
            ("two empty launches", lambda: lib.probe_launches(dev.index, 2,
                                                              stream)),
            ("torch.cuda.current_stream(dev).cuda_stream",
             lambda: torch.cuda.current_stream(dev).cuda_stream),
            ("torch._C._cuda_getCurrentRawStream",
             lambda: torch._C._cuda_getCurrentRawStream(dev.index))):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        costs[name] = (time.perf_counter() - t0) / 2000
        torch.cuda.synchronize()
    print("[time] host clock a call: " + ", ".join(
        f"{k} {v * 1e6:.2f} us" for k, v in costs.items()) + f" [{card}]")


BOUNDS_SHAPE = ("constexpr int kBoundsPerThread = 1;",
                "constexpr int kBoundsHalo = kBoundsThreads / 8;")


def bounds_variants(tmp: Path, plans: dict, card: str) -> None:
    """partition_bounds_kernel with 1, 2, 4 or 8 rows a thread (256, 512,
    1,024 or 2,048 rows a block) and 32 to 128 rows staged past a block:
    copies of partition.cu with the two constants edited, built here at
    once, each table and flag checked equal to the package's and timed by
    device time (torch.profiler) over the batches of each plan."""
    src = (cuda_build.CSRC_DIR / "partition.cu").read_text()
    cs.require(all(line in src for line in BOUNDS_SHAPE),
               "partition.cu no longer holds the table kernel's constants")
    procs = {}
    for per, halo in ((1, 32), (2, 64), (4, 128), (8, 128)):
        text = src.replace(BOUNDS_SHAPE[0],
                           f"constexpr int kBoundsPerThread = {per};")
        text = text.replace(BOUNDS_SHAPE[1],
                            f"constexpr int kBoundsHalo = {halo};")
        path = tmp / f"bounds_{per}.cu"
        path.write_text(text)
        out = tmp / f"libbounds_{per}.so"
        procs[f"{per * 256} rows a block, {halo} staged past it"] = (
            out, subprocess.Popen([cuda_build.nvcc_path(),
                                   *cuda_build.NVCC_FLAGS, "-o", str(out),
                                   str(path)], stderr=subprocess.PIPE))
    libs = {}
    for label, (out, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed for {label}: "
                               f"{proc.stderr.read().decode()}")
        lib = ctypes.CDLL(str(out))
        lib.nthash_partition_bounds.argtypes = \
            pk._lib().nthash_partition_bounds.argtypes
        lib.nthash_cuda_error_string.restype = ctypes.c_char_p
        libs[label] = lib
    for wl, batches in plans.items():
        p_log2, sub_log2, rows, cap = pk.plan(wl)
        srts = [pk._sorted(b) for b in batches]
        dev = srts[0].device
        for label, lib in libs.items():
            def call(x, lib=lib):
                r, g = x.shape[:2]
                n = (r * g) << p_log2
                out = torch.empty(n + 2, dtype=torch.int32, device=dev)
                cuda_build.check(lib, lib.nthash_partition_bounds(
                    dev.index, x.data_ptr(), r * g, rows, sub_log2,
                    1 << p_log2, cap, out.data_ptr(), out.data_ptr() + 4 * n,
                    pk._stream(dev)), "variant")
                return out[:n].view(r, g, -1), out[n:]

            for x in srts:
                got = call(x)
                want = pk.partition_bounds(x, sub_log2, p_log2, cap)
                cs.require(torch.equal(got[0], want[0])
                           and torch.equal(got[1], want[1]),
                           f"table variant {label} != the package's")

            def calls(call=call):
                for x in srts:
                    call(x)

            calls()
            tr = trace_device(calls, device=dev)
            t = sum(v for name, (v, _) in tr.by_name.items()
                    if "partition_bounds_kernel" in name)
            print(f"[time] partition_bounds_kernel at the 2**{wl} plan, "
                  f"{label}: device {t * 1e3:.4f} ms over the four batches "
                  f"[{card}]")
        del srts
        torch.cuda.empty_cache()


def bounds_costs(batches: list, wl: int, card: str) -> None:
    """Where a partition_bounds call's time goes at the plan for 2**wl: the
    wrapper, its C entry alone on buffers made once, the entry with no
    chunk (the flags launch alone), torch.empty and the stream lookup on
    the host clock, and device time by kernel under torch.profiler with
    the maxima hot in L2 and after a 64 MB write between calls."""
    p_log2, sub_log2, rows, cap = pk.plan(wl)
    lib = pk._lib()
    srts = [pk._sorted(b) for b in batches]
    n = max(x.shape[0] * x.shape[1] for x in srts) << p_log2
    dev = srts[0].device
    out = torch.empty(n + 2, dtype=torch.int32, device=dev)

    def entry(x, chunks=None):
        chunks = x.shape[0] * x.shape[1] if chunks is None else chunks
        cuda_build.check(lib, lib.nthash_partition_bounds(
            dev.index, x.data_ptr(), chunks, rows, sub_log2, 1 << p_log2, cap,
            out.data_ptr(), out.data_ptr() + 4 * n, pk._stream(dev)), "probe")

    wrap = sum(timeit(lambda x: pk.partition_bounds(x, sub_log2, p_log2, cap),
                      x).seconds_per_call for x in srts)
    raw = sum(timeit(entry, x).seconds_per_call for x in srts)
    flags_only = sum(timeit(lambda x: entry(x, 0), x).seconds_per_call
                     for x in srts)
    host = {}
    for name, fn in (("torch.empty", lambda: torch.empty(
                         n + 2, dtype=torch.int32, device=dev)),
                     ("stream lookup", lambda: pk._stream(dev)),
                     ("C entry", lambda: entry(srts[0])),
                     ("wrapper", lambda: pk.partition_bounds(
                         srts[0], sub_log2, p_log2, cap))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host[name] = (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
    print(f"[time] partition_bounds at the 2**{wl} plan per {cs.N_READS} "
          f"reads: wrapper {wrap * 1e3:.4f} ms, C entry on buffers made once "
          f"{raw * 1e3:.4f} ms, C entry with no chunk (the flags launch) "
          f"{flags_only * 1e3:.4f} ms (CUDA events); host clock a call: "
          + ", ".join(f"{k} {v * 1e6:.2f} us" for k, v in host.items())
          + f" [{card}]")
    flush = torch.empty(1 << 24, dtype=torch.int32, device=dev)
    for label, cold in (("maxima hot in L2", False),
                        ("after a 64 MB write", True)):
        def calls():
            for x in srts:
                if cold:
                    flush.fill_(1)
                pk.partition_bounds(x, sub_log2, p_log2, cap)
                lastq, queries = cs.searchsorted_inputs(x, sub_log2, p_log2)
                if cold:
                    flush.fill_(1)
                torch.searchsorted(lastq, queries, side="left")

        calls()
        tr = trace_device(calls, device=dev)
        print(f"[trace] partition_bounds and torch.searchsorted at the "
              f"2**{wl} plan, {label}, device ms over the four batches: "
              + ", ".join(f"{name[:60]} {t * 1e3:.4f} (x{c})"
                          for name, (t, c) in sorted(
                              tr.by_name.items(), key=lambda kv: -kv[1][0])
                          if "fill" not in name.lower())
              + f" [{card}]")
    del srts, flush
    torch.cuda.empty_cache()


def group_sweep(dev, gen, card: str) -> None:
    """Section 5: one grouped pass of g strides, g = 1..6."""
    lib = pk._lib()
    chunk = 1 << 23
    x = torch.randint(0, 1 << 30, (1, 16, chunk // pk.LANES, pk.LANES),
                      device=dev, generator=gen, dtype=torch.int32)
    nbytes = x.numel() * 4
    for g in range(1, pk.MERGE_MAX_GROUP + 1):
        j = (chunk // 2) >> (g - 1)

        def one(y, g=g, j=j):
            cuda_build.check(lib, lib.nthash_merge_strides(
                dev.index, y.data_ptr(), y.numel(), chunk, chunk, j, g,
                pk._stream(dev)), "probe launch")

        t = timeit(one, x).seconds_per_call
        print(f"[time] grouped pass of {g} strides ({chunk // 2} down to "
              f"{j}) over {tuple(x.shape)}: {t * 1e3:.4f} ms, "
              f"{t * 1e3 / g:.4f} ms a stride; bound "
              f"{cs.bound_ms(2 * nbytes):.4f} ms [{card}]")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, metavar="CSRC",
                    help="a csrc/ whose partition.cu to time beside the "
                    "package's (sections 1 and 2)")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    codes = cs.make_codes(np.random.default_rng(0), cs.N_READS)
    batches20 = cs.wide_batches(codes, dev)
    batches30 = cs.plan_batches(codes, dev)
    with tempfile.TemporaryDirectory() as tmp:
        if args.parent:
            parent = parent_kernels(build_parent(args.parent, Path(tmp)))
            compare_plan(cs.WIDE, batches20, parent, card, args.rounds)
            compare_plan(30, batches30, parent, card, args.rounds)
            compare_whole(codes, dev, parent, card, args.rounds)
    merge_designs(batches30, batches20, card, args.rounds)
    with tempfile.TemporaryDirectory() as tmp:
        host_costs(Path(tmp), dev, card)
        bounds_variants(Path(tmp), {cs.WIDE: batches20, 30: batches30}, card)
    bounds_costs(batches20, cs.WIDE, card)
    bounds_costs(batches30, 30, card)
    del batches20, batches30
    torch.cuda.empty_cache()
    group_sweep(dev, gen, card)
    print("[probe] done")


if __name__ == "__main__":
    main()
