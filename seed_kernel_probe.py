"""Probe of the spaced-seed kernels and the one-sequence entries on one GPU.

    python3 seed_kernel_probe.py [--only-sequence] [--ablate CSRC [--only-ablate]]

Answers what ``chip_smoke.py`` does not time: (1) what the global seed
kernel's register bound costs, by building ``csrc/seed_hash.cu`` with
``seed_hash_kernel``'s launch bound left to ptxas and at 1..6 resident
blocks, and timing each at B3's [10000, 16384] (BASELINE seeds, h=1) and
B1's 1M x 150 bp (h=3) shapes beside the staged kernel, in turns; (2) the
resident threads a multiprocessor of each seed kernel, from its registers
and shared memory; (3) where the old pseudo-read route of
``sp.hash_long_sequence`` spends its time (traced by row) beside the
one-pass entry; (4) the one-pass entries' four instances: registers,
spills, shared bytes a block, resident warps
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and their SASS
(``cuobjdump -sass``: instructions, opcodes, and each loop's instructions,
16-byte shared loads and global stores); (5) the k-mer entry at 2**27
bases by warps a block and span, the seed entry at 2**25 (BASELINE) by
span, the numbers behind ``kmer_kernel.sequence_span``. ``--only-sequence``
runs (4) and (5) alone. ``--ablate CSRC`` first takes the per-step one-pass
kernel (before its redesign into unrolled chunks: a ``csrc/`` from a
``git archive`` of a tree that holds it) and times its ablations, each a temporary copy built
beside the copy as it is and timed against it in turns at 2**27 bases, k=32,
h=1: (a) the roll with no output writes, (b) the staging and writes with no
roll, (c) the staging loads issued one chunk ahead, (d8, d16) an output
stage of 8 or 16 windows a lane, and (c+d8); with the registers, resident
warps and SASS of each. Every output is checked against the one the
package's own route gives. Needs one CUDA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from nthash_tpu_torch import u64
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
    """Median ms of each of ``fns`` on ``arg``, a list a function, over
    ``rounds`` rounds that alternate their order."""
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


# ------------------------------------------------------------------------
# The per-step one-pass kernel (before the redesign), ablated. ``--ablate DIR`` names a csrc/ that
# holds it (roll.cuh's roll_sequence with its per-step roll, its 32-window
# output stage and kmer_hash.cu's launcher taking warps and ring rows, as
# in the parent of the redesign); each ablation is a set of text edits to a
# temporary copy, built beside the copy as it is and timed against it in
# turns at 2**27 bases, k=32, h=1.

OLD_K, OLD_N = 32, 1 << 27
#: Anchors of the flush block of that kernel's roll_sequence: from the first
#: store into the stage to the end of the function.
FLUSH_FROM = "      if (kFwdRev) {\n        stage[lane * kStagePitch + (u & 31)] = fwd;"
FLUSH_TO = "      vbits = 0;\n    }\n  }\n}\n"
STAGE_CALL = """      if ((dt & (kRows - 1)) == 0) {
        __syncwarp();
        stage_flat(ring, rmask, seq, C, base, dt, lane, vec);
        __syncwarp();
      }
"""
PREFETCH = """      if ((dt & (kRows - 1)) == 0) {
        __syncwarp();
        const long long p = base + dt;
        if (vec && p + kRows <= C) {
          if (dt == 0) {
            const uint4* s0 = reinterpret_cast<const uint4*>(seq + p);
            pa = s0[0];
            pb = s0[1];
          }
          const unsigned w[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
          if (p + 2 * kRows <= C) {
            const uint4* s1 = reinterpret_cast<const uint4*>(seq + p + kRows);
            pa = s1[0];
            pb = s1[1];
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const unsigned v = __vminu4(w[i], 0x04040404u);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              ring_row(ring, dt + 4 * i + j, rmask)[lane] =
                  static_cast<unsigned char>(v >> (8 * j));
            }
          }
        } else {
          stage_flat(ring, rmask, seq, C, base, dt, lane, vec);
        }
        __syncwarp();
      }
"""
STATE_DECL = "  unsigned long long* stage_rev = stage + 32 * kStagePitch;\n"
ROLL_CALL = ("      roll_step(ring, rmask, lane, dt, offs, pairs, q0, q1, fwd, rev);\n"
             "      if (si == 0) roll_invalid(ring, rmask, lane, dt, k, inv);\n")
OCCUPANCY = """
extern "C" int probe_occupancy(int fwd_rev, int threads, long long smem,
                               int* blocks) {
  auto kernel = fwd_rev ? &%s<true> : &%s<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, (size_t)smem);
}
"""


def edited(text: str, edits) -> str:
    """``text`` with each (old, new) edit made everywhere; an old text that
    is not there raises (the source is not the kernel the edit is for)."""
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"anchor not in the source: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def cut_span(text: str, start: str, end: str, new: str) -> str:
    """``text`` with [start, end] (end inclusive, the first after start)
    replaced by ``new``."""
    i = text.index(start)
    j = text.index(end, i) + len(end)
    return text[:i] + new + text[j:]


def ablate_roll(roll: str, name: str, pitch: int) -> str:
    """roll.cuh of ablation ``name``: "none", "a" (the roll with no output
    writes: one checksum a lane), "b" (the staging and writes with no roll),
    "c" (the staging loads issued one chunk ahead), "d8" / "d16" (a stage of
    8 or 16 windows a lane), "c+d8"."""
    if name == "none":
        return roll
    if name == "a":
        roll = edited(roll, [(STATE_DECL, STATE_DECL
                              + "  unsigned long long acc = 0;\n")])
        return cut_span(roll, FLUSH_FROM, FLUSH_TO,
                        "      acc ^= (fwd + rev) ^ "
                        "static_cast<unsigned long long>(inv == 0);\n"
                        "    }\n  }\n  out[j0 + lane] = acc;\n}\n")
    if name == "b":
        return edited(roll, [(ROLL_CALL, "      fwd += dt;\n"
                                         "      rev ^= base + dt;\n")])
    if name == "c":
        return edited(roll, [(STATE_DECL, STATE_DECL + "  uint4 pa, pb;\n"),
                             (STAGE_CALL, PREFETCH)])
    if name == "c+d8":
        return ablate_roll(ablate_roll(roll, "c", pitch), "d8", pitch)
    w = int(name[1:])
    return edited(roll, [
        ("constexpr int kStagePitch = 33;",
         f"constexpr int kStagePitch = {pitch};"),
        ("stage[lane * kStagePitch + (u & 31)]",
         f"stage[lane * kStagePitch + (u & {w - 1})]"),
        ("stage_rev[lane * kStagePitch + (u & 31)]",
         f"stage_rev[lane * kStagePitch + (u & {w - 1})]"),
        ("vbits |= static_cast<unsigned>(inv == 0) << (u & 31);",
         f"vbits |= static_cast<unsigned>(inv == 0) << (u & {w - 1});"),
        ("if ((u & 31) != 31) continue;",
         f"if ((u & {w - 1}) != {w - 1}) continue;"),
        ("      for (int i = 0; i < 32; ++i) {\n"
         "        const unsigned vb = __shfl_sync(0xffffffffu, vbits, i);\n"
         "        const long long w = (j0 + i) * s + (u - 31) + lane;",
         f"      for (int g = 0; g < {w}; ++g) {{\n"
         f"        const int i = g * {32 // w} + lane / {w};\n"
         "        const unsigned vb = __shfl_sync(0xffffffffu, vbits, i);\n"
         f"        const long long w = (j0 + i) * s + (u - {w - 1}) + lane % {w};"),
        ("stage[i * kStagePitch + lane]", f"stage[i * kStagePitch + lane % {w}]"),
        ("stage_rev[i * kStagePitch + lane]",
         f"stage_rev[i * kStagePitch + lane % {w}]"),
        ("valid[w] = (vb >> lane) & 1;", f"valid[w] = (vb >> (lane % {w})) & 1;"),
    ])


ABLATIONS = {"none": 33, "a": 33, "b": 33, "c": 33, "d8": 9, "d16": 17,
             "c+d8": 9}


def build_dir(tmp: Path, src: Path, roll: str, name: str) -> Path:
    """kmer_hash.cu and seed_hash.cu of ``src`` beside ``roll`` as roll.cuh,
    each with ``probe_occupancy`` appended, built into ``tmp/name``; returns
    the directory (ptxas logs in ``*.log``)."""
    out = tmp / name
    out.mkdir()
    (out / "roll.cuh").write_text(roll)
    for cuh in src.glob("*.cuh"):
        if cuh.name != "roll.cuh":
            (out / cuh.name).write_text(cuh.read_text())
    procs = {}
    for stem, kernel in (("kmer_hash", "kmer_sequence_kernel"),
                         ("seed_hash", "seed_sequence_kernel")):
        (out / f"{stem}.cu").write_text((src / f"{stem}.cu").read_text()
                                        + OCCUPANCY % (kernel, kernel))
        procs[stem] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, f"-I{out}",
             "-o", str(out / f"lib{stem}.so"), str(out / f"{stem}.cu")],
            stderr=subprocess.PIPE, text=True)
    for stem, proc in procs.items():
        log = proc.communicate()[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{stem}:\n{log}")
        (out / f"{stem}.log").write_text(log)
    return out


def sequence_instances(log: str) -> dict:
    """{instance: "N registers, S bytes spill"} of the one-sequence kernels
    in a ptxas log."""
    regs, spill = {}, {}
    for kernel, report in ptxas_lines(log):
        if "sequence_kernel" not in kernel:
            continue
        m = re.search(r"Used (\d+) registers", report)
        if m:
            regs[kernel] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", report)
        if m:
            spill[kernel] = int(m.group(1))
    return {k: (regs[k], spill.get(k, 0)) for k in regs}


def occupancy(lib, fwd_rev: bool, warps: int, smem: int) -> int:
    """Resident warps a multiprocessor at ``warps`` a block and ``smem``
    bytes (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks = ctypes.c_int(0)
    lib.probe_occupancy.restype = ctypes.c_int
    lib.probe_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_void_p]
    err = lib.probe_occupancy(int(fwd_rev), warps * 32, smem,
                              ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"occupancy query: CUDA error {err}")
    return blocks.value * warps


def sass(lib: Path, needle: str) -> dict:
    """{instance: (instructions, opcode counts, loops)} of the kernels of
    ``lib`` whose name holds ``needle``, from ``cuobjdump -sass``; a loop
    is a backward branch: (instructions in it, its 16-byte shared loads,
    its global stores)."""
    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        if needle not in name:
            continue
        inst = "<true>" if "ILb1E" in name else "<false>"
        ops = []
        for ln in block.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", ln)
            if m:
                ops.append((int(m.group(1), 16), m.group(3), m.group(4)))
        counts: dict = {}
        for _, op, _ in ops:
            key = op.split(".")[0]
            counts[key] = counts.get(key, 0) + 1
        loops = []
        for i, (addr, op, rest) in enumerate(ops):
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
                body = [o for a, o, _ in ops if int(m.group(1), 16) <= a <= addr]
                loops.append((len(body),
                              sum(o.startswith("LDS.128") for o in body),
                              sum(o.startswith("STG") for o in body)))
        out[needle + inst] = (len(ops), counts, sorted(set(loops), reverse=True))
    return out


def old_tables(k: int, dev):
    """That entry's tables (the 25 (fwd, rev) pairs of the one care run)
    and meta {0, k, 0, 1}."""
    tabs = kk.plane_tables(k)
    vals = []
    for ci in range(5):
        for co in range(5):
            vals += [tabs.fwd_in[ci] ^ tabs.fwd_out[co],
                     tabs.rev_in[ci] ^ tabs.rev_out_r[co]]
    return (u64.tensor(vals, dev),
            torch.tensor([0, k, 0, 1], dtype=torch.int32, device=dev))


def ablations(src: Path, card: str, dev, gen) -> None:
    """The per-step kernel of ``src`` and its ablations: registers, spills,
    resident warps and SASS of every instance, then each ablation timed in
    turns with the kernel as it is at 2**27 bases, k=32, h=1."""
    k, n = OLD_K, OLD_N
    ring = 1 << (k + 31).bit_length()
    warps, span = 4, 256
    tables_b = 25 * 16 + 8 + 2 * 4       # roll.cuh sequence_tables_bytes
    shapes = {"kmer_hash": (tables_b, ring),   # k=32, one care run
              "seed_hash": (5 * 408 + 3 * 4 + 12, 64)}  # BASELINE, k=5
    roll = (src / "roll.cuh").read_text()
    with tempfile.TemporaryDirectory() as tmpd:
        tmp = Path(tmpd)
        dirs = {name: build_dir(tmp, src, ablate_roll(roll, name, pitch), name)
                for name, pitch in ABLATIONS.items()}
        libs = {}
        for name, d in dirs.items():
            lib = ctypes.CDLL(str(d / "libkmer_hash.so"))
            lib.nthash_kmer_sequence.restype = ctypes.c_int
            lib.nthash_kmer_sequence.argtypes = (
                [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
            lib.nthash_cuda_error_string.restype = ctypes.c_char_p
            lib.nthash_cuda_error_string.argtypes = [ctypes.c_int]
            libs[name] = lib
        base = dirs["none"]
        for stem in ("kmer_hash", "seed_hash"):
            found = sequence_instances((base / f"{stem}.log").read_text())
            slib = ctypes.CDLL(str(base / f"lib{stem}.so"))
            tb, rows = shapes[stem]
            for inst, (regs, spill) in sorted(found.items()):
                fr = inst.endswith("<true>")
                smem = tb + warps * (rows * 32 + (2 if fr else 1) * 32 * 33 * 8)
                print(f"[ablate] per-step {inst}: {regs} registers, {spill} bytes "
                      f"spill, {smem} bytes of shared memory a block of "
                      f"{warps} warps (ring {rows} rows): "
                      f"{occupancy(slib, fr, warps, smem)} resident warps a "
                      f"multiprocessor [{card}]")
            for inst, (total, counts, loops) in sass(
                    base / f"lib{stem}.so", stem.split("_")[0] + "_sequence_kernel").items():
                top = ", ".join(f"{o} {c}" for o, c in sorted(
                    counts.items(), key=lambda kv: -kv[1])[:14])
                print(f"[sass] per-step {inst}: {total} instructions ({top}); "
                      f"loops (instructions, LDS.128, STG): {loops[:6]}")
        tables, meta = old_tables(k, dev)
        seq = torch.randint(0, 4, (n,), dtype=torch.uint8, device=dev,
                            generator=gen)
        seq[torch.randint(0, n, (n // 100,), device=dev, generator=gen)] = 4

        def entry(lib, x, pitch):
            out = torch.empty((1, n), dtype=torch.int64, device=dev)
            ok = torch.empty(n, dtype=torch.bool, device=dev)
            status = lib.nthash_kmer_sequence(
                dev.index, x.data_ptr(), n, k, span, 1, 0, tables.data_ptr(),
                meta.data_ptr(), warps, ring, out.data_ptr(), ok.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            if status:
                raise RuntimeError(f"launch: CUDA error {status}")
            return out, ok

        want = entry(libs["none"], seq, 33)
        for name, pitch in ABLATIONS.items():
            if name in ("a", "b"):
                continue
            got = entry(libs[name], seq, pitch)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"ablation {name} changed the output")
        del want
        for name, pitch in ABLATIONS.items():
            if name == "none":
                continue
            dlib = ctypes.CDLL(str(dirs[name] / "libkmer_hash.so"))
            smem = tables_b + warps * (ring * 32 + 32 * pitch * 8)
            t = in_turns({"as it is": lambda x: entry(libs["none"], x, 33),
                          name: lambda x, name=name, pitch=pitch:
                          entry(libs[name], x, pitch)}, seq, rounds=4)
            regs = sequence_instances((dirs[name] / "kmer_hash.log").read_text())
            print(f"[ablate] ({name}) {n} bases, k={k}, h=1: "
                  f"{' / '.join(f'{v:.4f}' for v in t[name])} ms against the "
                  f"kernel as it is {' / '.join(f'{v:.4f}' for v in t['as it is'])} "
                  f"ms, in turns; {regs.get('kmer_sequence_kernel<false>')} "
                  f"(registers, spill), {occupancy(dlib, False, warps, smem)} "
                  f"resident warps [{card}]")


def sequence_resources(card: str) -> None:
    """Registers, spills, shared bytes a block and resident warps of the
    four one-sequence instances as the package builds them, at k=32 (k-mer)
    and the BASELINE seeds, h=1; their SASS: instructions, opcodes, loops."""
    for name in ("kmer_hash", "seed_hash"):  # build anew for ptxas's report
        (cuda_build.BUILD_DIR / f"lib{name}.so").unlink(missing_ok=True)
        cuda_build.build(name)  # a library already loaded stays in use
    k = 32
    for stem in ("kmer_hash", "seed_hash"):
        found = sequence_instances(cuda_build.BUILD_LOGS[stem])
        for inst, (regs, spill) in sorted(found.items()):
            fr = inst.endswith("<true>")
            if stem == "kmer_hash":
                warps, _ = kk.sequence_grid(k, 1, 1, 1, fr)
                smem = (kk.sequence_tables_bytes(1, 1, 1)
                        + warps * kk.sequence_warp_bytes(k, fr))
                resident = kk.sequence_resident_warps(k, 1, fr)
                shape = f"k={k}"
            else:
                warps, _ = kk.sequence_grid(5, 2, 5, 1, fr, seeds=True)
                smem = (kk.sequence_tables_bytes(2, 5, 1) + warps
                        * kk.sequence_warp_bytes(5, fr, 2))
                resident = sk.sequence_resident_warps(SEEDS, 1, fr)
                shape = "BASELINE"
            print(f"[resources] {inst} ({shape}, h=1): {regs} registers, "
                  f"{spill} bytes spill, {smem} bytes of shared memory a "
                  f"block of {warps} warps: {resident} resident warps a "
                  f"multiprocessor [{card}]")
        for inst, (total, counts, loops) in sass(
                cuda_build.BUILD_DIR / f"lib{stem}.so",
                stem.split("_")[0] + "_sequence_kernel").items():
            top = ", ".join(f"{o} {c}" for o, c in sorted(
                counts.items(), key=lambda kv: -kv[1])[:14])
            print(f"[sass] {inst}: {total} instructions ({top}); loops "
                  f"(instructions, LDS.128, STG): {loops[:6]}")


SPANS = (32, 64, 128, 256, 512, 1024)


def sequence_sweep(card: str, dev, gen) -> None:
    """The four one-sequence instances by span (windows a lane) at the
    rule's warps a block, at 2**27 bases (k=32, h=1) and 2**25 (BASELINE
    seeds, h=1), and the k-mer entry by warps a block at the rule's span;
    each launch checked against the rule's: the numbers behind
    ``sequence_span`` and ``sequence_warps``."""
    n, k = 1 << 27, 32
    seq = torch.randint(0, 5, (n,), dtype=torch.uint8, device=dev,
                        generator=gen)
    klib, slib = kk._lib(), sk._lib()
    ktables = kk._sequence_tables(k, 1, dev)
    stables, _ = sk._pair_kernel_tables(SEEDS, 1, dev)
    meta = sk._sequence_meta(SEEDS, dev)

    def kmer(x, fr, warps, span):
        out, ok = kk.sequence_outputs(3 if fr else 1, n, dev)
        status = klib.nthash_kmer_sequence(
            dev.index, x.data_ptr(), n, k, span, 1, int(fr),
            ktables.data_ptr(), warps, out.data_ptr(), out.shape[1],
            ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(klib, status, "kmer_hash sequence launch")
        return list(out[:, :n].unbind(0)), ok[:n]

    def seeds(x, fr, warps, span):
        m = x.shape[0]
        out, ok = kk.sequence_outputs(6 if fr else 2, m, dev)
        status = slib.nthash_seed_sequence(
            dev.index, x.data_ptr(), m, 5, span, 2, 5, 1, int(fr),
            stables.data_ptr(), meta.data_ptr(), warps, out.data_ptr(),
            out.shape[1], ok.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(slib, status, "seed_hash sequence launch")
        return list(out[:, :m].unbind(0)), ok[:m]

    cases = []
    for fr in (False, True):
        cases.append((f"kmer_sequence{'_fwd_rev' if fr else ''} {n} bases, "
                      f"k={k}", kmer, seq, fr,
                      kk.sequence_grid(k, 1, 1, 1, fr)[0],
                      lambda x, fr=fr: kk.hash_sequence(x, k, 1,
                                                        emit_fwd_rev=fr)))
        cases.append((f"seed_sequence{'_fwd_rev' if fr else ''} {1 << 25} "
                       "bases, BASELINE", seeds, seq[:1 << 25], fr,
                       kk.sequence_grid(5, 2, 5, 1, fr, seeds=True)[0],
                       lambda x, fr=fr: sk.hash_seeds_sequence(
                           x, SEEDS, 1, emit_fwd_rev=fr)))
    for label, launch, x, fr, warps, rule in cases:
        want = rule(x)
        for span in SPANS:
            got = launch(x, fr, warps, span)
            if not (all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{label}, span {span}: outputs differ")
            del got
            t = timeit(lambda y: launch(y, fr, warps, span), x).seconds_per_call
            print(f"[sweep] {label}: {warps} warps a block, {span} windows a "
                  f"lane: {t * 1e3:.4f} ms (the rule: "
                  f"{kk.sequence_span(k) if launch is kmer else kk.sequence_span(5, seeds=True, emit_fwd_rev=fr)}) [{card}]")
        del want
        torch.cuda.empty_cache()
    for warps in (1, 2, 4, 8):
        t = timeit(lambda y: kmer(y, False, warps, kk.sequence_span(k)),
                   seq).seconds_per_call
        print(f"[sweep] kmer_sequence {n} bases, k={k}: {warps} warps a "
              f"block, {kk.sequence_span(k)} windows a lane: {t * 1e3:.4f} ms "
              f"(the rule: {kk.sequence_grid(k)[0]} warps) [{card}]")


#: Where each source sets its output runs (windows a lane), and the edit
#: that makes every instance of it write runs of RUN windows.
RUN_EDITS = {"kmer_hash": ("constexpr int kRun = 32;",
                           "constexpr int kRun = RUN;"),
             "seed_hash": ("return fwd_rev ? 32 : 16;", "return RUN;")}


def swapped(name: str, lib, fn, *args):
    """``fn(*args)`` with the package's loaded ``lib<name>.so`` replaced by
    ``lib`` (the wrappers then launch its kernels)."""
    saved = cuda_build._libs[name]
    cuda_build._libs[name] = lib
    try:
        return fn(*args)
    finally:
        cuda_build._libs[name] = saved


def stage_sweep(card: str, dev, gen) -> None:
    """The four one-sequence instances built with output runs of 8, 16
    and 32 windows a lane (temporary copies of ``csrc/`` with the run
    constant edited; the package builds runs of 32, and 16 for the seed
    entry without fwd/rev), each held to the package's outputs and timed in
    turns, with its resident warps: k=32 over 2**27 bases and BASELINE
    over 2**25 (h=1, with and without fwd/rev), and a facade tile (2**22
    windows, h=4, fwd/rev)."""
    with tempfile.TemporaryDirectory() as tmpd:
        procs, libs = {}, {}
        for run in (8, 16, 32):
            d = Path(tmpd) / f"run{run}"
            d.mkdir()
            for cuh in cuda_build.CSRC_DIR.glob("*.cuh"):
                (d / cuh.name).write_text(cuh.read_text())
            for stem, (old, new) in RUN_EDITS.items():
                # the source beside its headers: "roll.cuh" resolves there
                src = (cuda_build.CSRC_DIR / f"{stem}.cu").read_text()
                (d / f"{stem}.cu").write_text(
                    edited(src, [(old, new.replace("RUN", str(run)))]))
                procs[run, stem] = subprocess.Popen(
                    [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                     "-o", str(d / f"lib{stem}.so"), str(d / f"{stem}.cu")],
                    stderr=subprocess.PIPE, text=True)
        for (run, stem), proc in procs.items():
            log = proc.communicate()[1]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed, runs of {run}:\n{log}")
            lib = ctypes.CDLL(str(Path(tmpd) / f"run{run}" / f"lib{stem}.so"))
            lib.nthash_cuda_error_string.restype = ctypes.c_char_p
            lib.nthash_cuda_error_string.argtypes = [ctypes.c_int]
            libs[run, stem] = lib
            print(f"[stage] runs of {run} windows, {stem}: "
                  f"{sequence_instances(log)}")
        seq = torch.randint(0, 5, (1 << 27,), dtype=torch.uint8, device=dev,
                            generator=gen)
        cases = (
            ("kmer_sequence 2**27, k=32, h=1", "kmer_hash", seq,
             lambda x: kk.hash_sequence(x, 32, 1),
             lambda: kk.sequence_resident_warps(32, 1, False)),
            ("kmer_sequence_fwd_rev 2**27", "kmer_hash", seq,
             lambda x: kk.hash_sequence(x, 32, 1, emit_fwd_rev=True),
             lambda: kk.sequence_resident_warps(32, 1, True)),
            ("seed_sequence 2**25, BASELINE, h=1", "seed_hash", seq[:1 << 25],
             lambda x: sk.hash_seeds_sequence(x, SEEDS, 1),
             lambda: sk.sequence_resident_warps(SEEDS, 1, False)),
            ("seed_sequence_fwd_rev 2**25", "seed_hash", seq[:1 << 25],
             lambda x: sk.hash_seeds_sequence(x, SEEDS, 1, emit_fwd_rev=True),
             lambda: sk.sequence_resident_warps(SEEDS, 1, True)),
            ("facade tile 2**22 windows, h=4, fwd/rev", "kmer_hash",
             seq[:(1 << 22) + 31],
             lambda x: kk.hash_sequence(x, 32, 4, emit_fwd_rev=True),
             lambda: kk.sequence_resident_warps(32, 4, True)))
        for label, stem, x, fn, occ in cases:
            want = fn(x)
            fns, warps = {}, {}
            for run in (8, 16, 32):
                lib = libs[run, stem]
                got = swapped(stem, lib, fn, x)
                if not (all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{label}: runs of {run} differ")
                fns[f"{run} windows"] = \
                    lambda y, lib=lib: swapped(stem, lib, fn, y)
                warps[f"{run} windows"] = swapped(stem, lib, occ)
            del want, got
            for name, v in in_turns(fns, x, rounds=2).items():
                print(f"[stage] {label}, runs of {name}: "
                      f"{' / '.join(f'{t:.4f}' for t in v)} ms, "
                      f"{warps[name]} resident warps [{card}]")
        del seq
        torch.cuda.empty_cache()


def sequence_sections(card: str, dev, gen) -> None:
    sequence_resources(card)
    stage_sweep(card, dev, gen)
    sequence_sweep(card, dev, gen)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", type=Path, metavar="CSRC",
                    help="a csrc/ holding the per-step one-pass kernel: time its "
                    "ablations")
    ap.add_argument("--only-ablate", action="store_true",
                    help="run the --ablate section alone")
    ap.add_argument("--only-sequence", action="store_true",
                    help="run the one-pass entries' sections alone "
                    "(resources, SASS, the sweep)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this probe needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.ablate:
        ablations(args.ablate, card, dev, gen)
        if args.only_ablate:
            print("[probe] done")
            return
    if args.only_sequence:
        sequence_sections(card, dev, gen)
        print("[probe] done")
        return
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
    del seq
    torch.cuda.empty_cache()
    sequence_sections(card, dev, gen)
    print("[probe] done")


if __name__ == "__main__":
    main()
