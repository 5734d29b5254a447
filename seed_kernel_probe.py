"""Probe of the spaced-seed kernels and the one-sequence entries on one GPU.

    python3 seed_kernel_probe.py

Answers what ``chip_smoke.py`` does not time: (1) what the global seed
kernel's register bound costs, by building ``csrc/seed_hash.cu`` with
``seed_hash_kernel``'s launch bound left to ptxas and at 1..6 resident
blocks, and timing each at B3's [10000, 16384] (BASELINE seeds, h=1) and
B1's 1M x 150 bp (h=3) shapes beside the staged kernel, in turns; (2) the
resident threads a multiprocessor of each seed kernel, from its registers
and shared memory; (3) where the old pseudo-read route of
``sp.hash_long_sequence`` spends its time (traced by row) beside the
one-pass entry; (4) the one-pass entry at 1-8 warps a block and spans of
256-1024 windows a thread. Every output is checked against the one the
package's own route gives. Needs one CUDA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from nthash_tpu_torch.ops import cuda_build
from nthash_tpu_torch.ops import kmer_kernel as kk
from nthash_tpu_torch.ops import seed_kernel as sk
from nthash_tpu_torch.ops.kmer_torch import window_valid
from nthash_tpu_torch.parallel import sp
from nthash_tpu_torch.utils.profiling import timeit, trace_device

SEEDS = ("10101", "11011")
BOUND = "__launch_bounds__(kThreads, kGlobalMinBlocks)"
SHAPES = (("B3 [10000, 16384] h=1", 10_000, 16_384, 1, 255),
          ("B1 [150, 1000000] h=3", 150, 1_000_000, 3, 146))


def ptxas_lines(log: str) -> list[tuple[str, str]]:
    """(kernel, report) for each register or spill line of a ptxas log."""
    out, kernel = [], "?"
    for ln in log.splitlines():
        m = re.search(r"([a-z][a-z_]*_kernel)(I\w*?E)?E", ln)
        if "Compiling entry" in ln and m:
            kernel = m.group(1) + ("<true>" if "ILb1E" in ln else
                                   "<false>" if "ILb0E" in ln else "")
        elif "spill" in ln or "registers" in ln:
            out.append((kernel, ln.split(":", 1)[-1].strip()))
    return out


def build_variants(tmp: Path) -> tuple[dict, dict]:
    """seed_hash.cu with seed_hash_kernel's bound left to ptxas ("none")
    and at 1..6 resident blocks, each built into ``tmp`` and loaded; and
    the registers of every kernel of the source as committed (bound 6)."""
    src = (cuda_build.CSRC_DIR / "seed_hash.cu").read_text()
    assert BOUND in src
    bounds = {"none": "__launch_bounds__(kThreads)",
              **{str(b): f"__launch_bounds__(kThreads, {b})" for b in range(1, 7)}}
    procs = {}
    for name, bound in bounds.items():
        path = tmp / f"seed_{name}.cu"
        path.write_text(src.replace(BOUND, bound))
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
             f"-I{cuda_build.CSRC_DIR}", "-o", str(tmp / f"lib{name}.so"),
             str(path)], stderr=subprocess.PIPE, text=True)
    libs, regs = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for bound {name}:\n{log}")
        for kernel, report in ptxas_lines(log):
            if kernel.startswith("seed_hash_kernel"):
                print(f"[bound {name}] {kernel}: {report}")
            m = re.search(r"Used (\d+) registers", report)
            if name == "6" and m:
                regs[kernel] = int(m.group(1))
        lib = ctypes.CDLL(str(tmp / f"lib{name}.so"))
        lib.nthash_seed_hash.restype = ctypes.c_int
        lib.nthash_seed_hash.argtypes = sk._lib().nthash_seed_hash.argtypes
        libs[name] = lib
    return libs, regs


def global_kernel(lib, tm, h, seg, dev):
    """One launch of the global seed kernel of ``lib``."""
    length, reads = tm.shape
    tables, meta = sk._kernel_tables(SEEDS, h, dev)
    out = torch.empty((len(SEEDS) * h, length - 4, reads), dtype=torch.int64,
                      device=dev)
    status = lib.nthash_seed_hash(
        dev.index, tm.data_ptr(), length, reads, 5, len(SEEDS), 5, seg, h, 0,
        0, tables.data_ptr(), meta.data_ptr(), 0, 0, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, status, "seed_hash launch")
    return out


def in_turns(fns: dict, arg, rounds: int = 2) -> dict:
    got = {name: [] for name in fns}
    names = list(fns)
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
            got[name].append(timeit(fns[name], arg).seconds_per_call * 1e3)
            torch.cuda.empty_cache()
    return got


def resident_threads(regs: int, threads: int, smem: int) -> int:
    """Threads a multiprocessor holds at once: 65,536 registers, 2,048
    threads, 228 KB of shared memory (1 KB reserved a block)."""
    blocks = min(65536 // (regs * threads), 2048 // threads,
                 233472 // (smem + 1024))
    return blocks * threads


def old_route(seq, k):
    """The pseudo-read route the one-pass entry replaced."""
    t = sp.pick_tile(seq.shape[0], k)
    pseudo = sp.pseudo_reads(torch.nn.functional.pad(seq, (0, k - 1), value=4),
                             k, t)
    planes = kk.hash_kmers_tm(kk.prepare_codes(pseudo), k, 1)
    return ([p.T.reshape(-1) for p in planes],
            window_valid(pseudo.to(torch.int32), k).reshape(-1))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cuda_build.load("seed_hash")
    cuda_build.load("kmer_hash")
    with tempfile.TemporaryDirectory() as tmp:
        libs, regs = build_variants(Path(tmp))
        for label, length, reads, h, seg in SHAPES:
            tm = torch.randint(0, 4, (length, reads), dtype=torch.int32,
                               device=dev, generator=gen)
            want = torch.stack(sk._launch(tm, SEEDS, 5, h, False, None, seg,
                                          "staged"))
            for lib in libs.values():
                if not torch.equal(global_kernel(lib, tm, h, seg, dev), want):
                    raise AssertionError(f"{label}: a bound changed the output")
            del want
            torch.cuda.empty_cache()
            fns = {"staged": lambda c: sk._launch(c, SEEDS, 5, h, False, None,
                                                  seg, "staged")}
            for name, lib in libs.items():
                fns[f"global, bound {name}"] = \
                    lambda c, lib=lib: global_kernel(lib, c, h, seg, dev)
            for name, v in in_turns(fns, tm).items():
                print(f"[time] {label} {name}: "
                      f"{' / '.join(f'{x:.4f}' for x in v)} ms [{card}]")
            del tm
            torch.cuda.empty_cache()
    warps, ring = sk.seed_grid(5, 2, 5, 3)
    smem = sk.tables_bytes(2, 5, 3) + warps * (ring * 32 + 2 * 512)
    for kernel, threads, shared in (
            ("seed_staged_kernel<false>", warps * 32, smem),
            ("seed_hash_kernel<false>", 256, (20 * 5 + 2) * 8 + 13 * 4)):
        if kernel in regs:
            print(f"[occupancy] {kernel} (BASELINE, h=3): {regs[kernel]} "
                  f"registers, {threads} threads and {shared} bytes of shared "
                  f"memory a block: {resident_threads(regs[kernel], threads, shared)} "
                  "resident threads a multiprocessor (of 2,048)")

    n, k = 1 << 27, 32
    seq = torch.randint(0, 5, (n,), dtype=torch.uint8, device=dev, generator=gen)
    got, valid = kk.hash_sequence(seq, k, 1)
    old, ovalid = old_route(seq, k)
    if not (torch.equal(got[0], old[0]) and torch.equal(valid, ovalid)):
        raise AssertionError("the one-pass entry != the pseudo-read route")
    del got, valid, old, ovalid
    for label, fn in (("old pseudo-read route", lambda: old_route(seq, k)),
                      ("one-pass entry", lambda: kk.hash_sequence(seq, k, 1))):
        tr = trace_device(fn, device=dev)
        print(f"[trace] hash_long_sequence {n} bases, k={k}, h=1, {label}: "
              f"device busy {tr.busy_seconds * 1e3:.3f} ms [{card}]")
        for name, (t, calls) in sorted(tr.by_name.items(),
                                       key=lambda kv: -kv[1][0])[:10]:
            print(f"[trace]   {t * 1e3:9.3f} ms x{calls:<3d} {name[:100]}")
    lib = kk._lib()
    tables, meta = kk._sequence_tables(k, 1, dev)
    want = kk.hash_sequence(seq, k, 1)

    def entry(x, warps, span):
        out = torch.empty((1, n), dtype=torch.int64, device=dev)
        ok = torch.empty(n, dtype=torch.bool, device=dev)
        status = lib.nthash_kmer_sequence(
            dev.index, x.data_ptr(), n, k, span, 1, 0, tables.data_ptr(),
            meta.data_ptr(), warps, kk.ring_rows(k), out.data_ptr(),
            ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(lib, status, "kmer_hash sequence launch")
        return out, ok

    for warps in (1, 2, 4, 8):
        for span in (256, 512, 1024):
            out, ok = entry(seq, warps, span)
            if not (torch.equal(out[0], want[0][0]) and torch.equal(ok, want[1])):
                raise AssertionError(f"warps {warps}, span {span}: outputs differ")
            t = timeit(lambda x: entry(x, warps, span), seq).seconds_per_call
            print(f"[time] one-pass entry {n} bases, k={k}: {warps} warps a "
                  f"block, {span} windows a thread: {t * 1e3:.4f} ms "
                  f"(the rule: {kk.sequence_grid(k)[0]} warps, "
                  f"{kk.sequence_span(k)} windows) [{card}]")
    print("[probe] done")


if __name__ == "__main__":
    main()
