"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py [--seed N]

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and nvcc; it
imports nothing of JAX. Phases, each printing its own lines:

1. environment: card name and power limit, torch / CUDA / nvcc versions;
2. build both CUDA kernels from ``nthash_tpu_torch/csrc`` and time it;
3. golden ntHash2 vectors through the rolling-hash kernel;
4. each kernel against its plain PyTorch version on the card, exact (the
   hash kernel also on one full main-path batch of 2**18 reads);
5. the main path: ``ReadHashingPipeline.count_file`` over a 1M-read,
   150-bp FASTQ at k=32, 4 hashes, sketch width 2**14, checked against the
   plain hash->count on the same codes, with both kernels' launch counts;
6. timings (median of 5 CUDA-event timings after warm-up) of each kernel
   and its plain version at the main path's shapes, the fused step and
   ``count_file``;
7. one warm ``count_file`` under ``torch.profiler``: device busy time, the
   device's idle share, and device time per kernel and copy.

A failed check raises, so the exit code is not 0. The line before the last
is the kernels' JSON record; the last line is ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from nthash_tpu_torch.io import native_loader
from nthash_tpu_torch.io.stream import Prefetcher, stream_code_batches
from nthash_tpu_torch.constants import encode_ascii, extend_hashes
from nthash_tpu_torch.models import sketch as cms
from nthash_tpu_torch.models.pipeline import (
    PipelineConfig,
    ReadHashingPipeline,
    fused_count_step,
)
from nthash_tpu_torch.ops import cuda_build, hist_kernel, kmer_kernel
from nthash_tpu_torch.ops.hist_kernel import histogram_rows, histogram_rows_plain
from nthash_tpu_torch.ops.kmer_kernel import (
    hash_kmers_tm,
    hash_kmers_tm_plain,
    prepare_codes,
)
from nthash_tpu_torch.u64 import to_numpy_u64
from nthash_tpu_torch.utils.profiling import timeit, trace_device

K, H, WLOG, L = 32, 4, 14, 150
N_READS = 1_000_000
BATCH = 1 << 18
N_RATE = 0.01

# NtHash("TGACTGATCGAGTCGTACTAG", k=5): (pos, fwd, rev, canonical), captured
# from a build of the reference library (tests/test_golden.py README_K5).
GOLDEN_SEQ = "TGACTGATCGAGTCGTACTAG"
GOLDEN_K5 = [
    (0, 0x2C984DF375275F54, 0x33D712CF31D61DD9, 0x606F60C2A6FD7D2D),
    (1, 0x53AB9BBF14511759, 0x1E926CF9780AB81D, 0x723E08B88C5BCF76),
    (2, 0x9D9B16C7F7804E4F, 0x82D449FBB3710CC2, 0x206F60C3AAF15B11),
    (3, 0x831C12341C225650, 0x1D7F3B212029E306, 0xA09B4D553C4C3956),
    (4, 0x05D3D5630EE1EE7A, 0x1D856FFCF44D5255, 0x23594560032F40CF),
    (5, 0x013CAA9FE3DC7505, 0x89BB52619AC71FDB, 0x8AF7FD017EA394E0),
    (6, 0x38B57486189A8AF7, 0xC940D6B7C217DF21, 0x01F64B3DDAB26A18),
    (7, 0xC027A1920BA2B853, 0xE936D7E76EF87970, 0xA95E79797A9B31C3),
    (8, 0x83B3345820EFBE24, 0xA2612D0D21FF79CE, 0x2614616542EF37F2),
    (9, 0x048D99BB777A3E92, 0x420A64EAF4A61F31, 0x4697FEA66C205DC3),
    (10, 0x2F6ED7AC26473A89, 0xA0F0CAF1E101AEF5, 0xD05FA29E0748E97E),
    (11, 0xE6F790E3BFACBFDD, 0x8C6D7AA40911B21D, 0x73650B87C8BE71FA),
    (12, 0xF723007CA07B1F47, 0xCBABC2D50BFC89C2, 0xC2CEC351AC77A909),
    (13, 0xF57CFFF55E1E9F16, 0xF8B3F1B66A6F749F, 0xEE30F1ABC88E13B5),
    (14, 0xF1D48693A3DA13ED, 0x24FF5C94287C6C91, 0x16D3E327CC56807E),
    (15, 0xD9652C9C98964727, 0x9FE2D1CD1B4A6684, 0x7947FE69B3E0ADAB),
    (16, 0xB8515960CF3327BE, 0xC8888D786D4485B3, 0x80D9E6D93C77AD71),
]
# NtHash("ACATGCATGCA", h=3, k=5) windows 1..2 (reference tests.cpp:54-57).
GOLDEN_ACATG = [
    (1, (0x38CC00F940AEBDAE, 0xAB7E1B110E086FC6, 0x011A1818BCFDD553)),
    (2, (0x603A48C5A11C794A, 0xE66016E61816B9C4, 0xC5B13CB146996FFE)),
]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; int64 tensors are compared as the uint64 they hold."""
    if a.dtype == torch.int64:
        x, y = to_numpy_u64(a), to_numpy_u64(b)
        return float(np.where(x > y, x - y, y - x).max(initial=0))
    return float((a.long() - b.long()).abs().max())


def phase_env() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    release = next((ln.split("release")[1].split(",")[0].strip()
                    for ln in nvcc.splitlines() if "release" in ln), "?")
    print(smi)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {release} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi, torch.cuda.get_device_name(0)


def phase_build() -> None:
    t0 = time.perf_counter()
    for name in ("kmer_hash", "histogram"):
        cuda_build.build(name)
        cuda_build.load(name)
    print(f"[build] both kernels built and loaded in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, log in cuda_build.BUILD_LOGS.items():
        regs = [ln.replace("ptxas info    :", "").strip()
                for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: {'; '.join(regs)}")


def phase_golden(dev) -> None:
    reps = 3  # several identical reads: every thread must agree
    tm = prepare_codes(torch.from_numpy(
        np.tile(encode_ascii(GOLDEN_SEQ), (reps, 1))).to(dev))
    outs = hash_kmers_tm(tm, 5, 3, emit_fwd_rev=True)
    canon, e1, e2, fwd, rev = (to_numpy_u64(o) for o in outs)
    for pos, f, r, c in GOLDEN_K5:
        want = extend_hashes(f, r, 5, 3)
        require(want[0] == c, "host extend_hashes disagrees with the golden")
        for got, exp in ((fwd, f), (rev, r), (canon, c), (e1, want[1]),
                         (e2, want[2])):
            require(bool((got[pos] == np.uint64(exp)).all()),
                    f"golden mismatch at window {pos}")
    tm2 = prepare_codes(torch.from_numpy(encode_ascii("ACATGCATGCA")[None]).to(dev))
    h3 = [to_numpy_u64(o) for o in hash_kmers_tm(tm2, 5, 3)]
    for pos, vals in GOLDEN_ACATG:
        require(tuple(int(h[pos, 0]) for h in h3) == vals,
                f"ACATGCATGCA golden mismatch at window {pos}")
    print(f"[golden] {len(GOLDEN_K5)} windows of {GOLDEN_SEQ} (k=5, h=3, fwd/rev) "
          f"and {len(GOLDEN_ACATG)} of ACATGCATGCA match through the kernel")


def make_codes(rng, n: int) -> np.ndarray:
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    codes[rng.random((n, L)) < N_RATE] = 4
    return codes


def phase_kernels_vs_plain(rng, codes: np.ndarray, dev) -> tuple[float, float]:
    k_err = 0.0
    for n, k, h, kw in ((1024, K, H, {"emit_fwd_rev": True}),
                        (1024, K, H, {"emit_buckets": WLOG}),
                        (1024, 65, 2, {}),
                        (BATCH, K, H, {"emit_buckets": WLOG})):  # main path's
        tm = prepare_codes(torch.from_numpy(codes[:n]).to(dev))
        got = hash_kmers_tm(tm, k, h, **kw)
        want = hash_kmers_tm_plain(tm, k, h, **kw)
        torch.cuda.synchronize()
        require(len(got) == len(want), "output count differs")
        for g, w in zip(got, want):
            require(g.shape == w.shape and g.dtype == w.dtype, "shape/dtype")
            k_err = max(k_err, max_abs_err(g, w))
            require(torch.equal(g, w), f"kmer_hash != plain at k={k} {kw}")
        print(f"[check] kmer_hash == plain on {n} reads x {L} bp, k={k} "
              f"h={h} {kw or ''}: {len(got)} x {tuple(got[0].shape)} "
              f"{got[0].dtype}")
        del tm, got, want
    h_err = 0.0
    n = 1 << 20
    for wl in (10, 14, 18, 26):
        width = 1 << wl
        idx = rng.integers(0, width, size=(4, n)).astype(np.int32)
        idx[:, rng.random(n) < 0.01] = -1
        idx[:, rng.random(n) < 0.01] = width
        w = rng.integers(-(2**31), 2**31, size=(4, n), dtype=np.int64)
        idx_d = torch.from_numpy(idx).to(dev)
        w_d = torch.from_numpy(w.astype(np.int32)).to(dev)
        for weight, label in ((w_d, "per-row"), (w_d[0], "shared"),
                              (None, "none")):
            got = histogram_rows(idx_d, weight, wl)
            want = histogram_rows_plain(idx_d, weight, wl)
            torch.cuda.synchronize()
            h_err = max(h_err, max_abs_err(got, want))
            require(torch.equal(got, want),
                    f"histogram != plain at width 2**{wl}, {label} weights")
        print(f"[check] histogram == plain at width 2**{wl}, 4 rows x 2**20, "
              "full-range int32 weights (per-row, shared, none), "
              "indices -1 and width dropped")
    return k_err, h_err


def write_fastq(path: Path, codes: np.ndarray) -> None:
    n = codes.shape[0]
    rec = np.empty((n, 3 + L + 3 + L + 1), dtype=np.uint8)
    rec[:, 0:3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + L] = np.frombuffer(b"ACGTN", np.uint8)[codes]
    rec[:, 3 + L:6 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + L:6 + 2 * L] = ord("I")
    rec[:, -1] = ord("\n")
    path.write_bytes(rec.tobytes())


def valid_windows(codes: np.ndarray, k: int) -> int:
    bad = np.cumsum(codes >= 4, axis=1, dtype=np.int32)
    bad = np.concatenate([np.zeros((codes.shape[0], 1), np.int32), bad], axis=1)
    return int(((bad[:, k:] - bad[:, :-k]) == 0).sum())


def plain_count(codes: np.ndarray, dev) -> torch.Tensor:
    """The plain hash->count (plain hash, plain histogram) over the same
    batches as count_file."""
    rows = torch.zeros((H, 1 << WLOG), dtype=torch.int32, device=dev)
    for s in range(0, codes.shape[0], BATCH):
        tm = prepare_codes(torch.from_numpy(codes[s:s + BATCH]).to(dev))
        for r, b in enumerate(hash_kmers_tm_plain(tm, K, H, emit_buckets=WLOG)):
            rows[r] += histogram_rows_plain(b.reshape(1, -1), None, WLOG)[0]
    return rows


def phase_main_path(codes: np.ndarray, path: Path, dev):
    cfg = PipelineConfig(k=K, num_hashes=H, sketch_width_log2=WLOG)
    pipe = ReadHashingPipeline(cfg, device=dev)
    kmer_kernel.LAUNCHES = 0
    hist_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    reads = pipe.count_file(path, batch_size=BATCH)
    seconds = time.perf_counter() - t0
    launches = {"kmer_hash": kmer_kernel.LAUNCHES,
                "histogram": hist_kernel.LAUNCHES}
    require(reads == N_READS, f"count_file streamed {reads} reads")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    nvalid = valid_windows(codes, K)
    sums = pipe.sketch.rows.sum(dim=1, dtype=torch.int64).tolist()
    require(all(s == nvalid for s in sums),
            f"row sums {sums} != {nvalid} valid windows")
    want = plain_count(codes, dev)
    require(torch.equal(pipe.sketch.rows, want),
            "count_file sketch != plain hash->count")
    print(f"[main] count_file: {reads} reads in {-(-N_READS // BATCH)} batches "
          f"of {BATCH}, {nvalid} valid {K}-mers per row, sketch == plain "
          f"hash->count; launches {launches}; native parser "
          f"{native_loader.available()}; first run {seconds:.3f} s")
    return pipe, launches


def phase_timings(codes: np.ndarray, path: Path, pipe, dev, card: str):
    tag = f"[{card}]"
    tm = prepare_codes(torch.from_numpy(codes).to(dev))
    reads, w = tm.shape[1], L - K + 1
    times = {}

    def both(label, items, unit, kernel_fn, plain_fn, *args):
        t_k = timeit(kernel_fn, *args).seconds_per_call
        t_p = timeit(plain_fn, *args).seconds_per_call
        torch.cuda.empty_cache()
        times[label] = (t_k, t_p)
        print(f"[time] {label}: kernel {t_k * 1e3:.4f} ms, plain "
              f"{t_p * 1e3:.4f} ms ({items / t_k:.6g} vs "
              f"{items / t_p:.6g} {unit}/s) {tag}")

    for h in (1, H):
        both(f"kmer_hash k={K} h={h} hashes {reads}x{L}", reads * w, "windows",
             lambda x, h=h: hash_kmers_tm(x, K, h),
             lambda x, h=h: hash_kmers_tm_plain(x, K, h), tm)
    both(f"kmer_hash k={K} h={H} buckets 2**{WLOG} {reads}x{L}", reads * w,
         "windows", lambda x: hash_kmers_tm(x, K, H, emit_buckets=WLOG),
         lambda x: hash_kmers_tm_plain(x, K, H, emit_buckets=WLOG), tm)
    idx = torch.stack(hash_kmers_tm(tm, K, H, emit_buckets=WLOG)).reshape(H, -1)
    both(f"histogram {H} rows x {idx.shape[1]} at 2**{WLOG}", idx.numel(),
         "updates", lambda x: histogram_rows(x, None, WLOG),
         lambda x: histogram_rows_plain(x, None, WLOG), idx)
    del idx
    torch.cuda.empty_cache()

    sk = cms.CountMinSketch.zeros(H, WLOG, dev)
    t_step = timeit(lambda x: fused_count_step(x, sk, K), tm).seconds_per_call
    print(f"[time] fused_count_step k={K} h={H} 2**{WLOG} {reads}x{L}: "
          f"{t_step * 1e3:.4f} ms, {reads * w / t_step:.6g} k-mers/s "
          f"(all windows) {tag}")
    del tm
    torch.cuda.empty_cache()

    def host_median(fn):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            runs.append(time.perf_counter() - t0)
        return statistics.median(runs)

    def count():
        pipe.sketch.rows.zero_()
        pipe.count_file(path, batch_size=BATCH)

    def parse_only():
        with Prefetcher(stream_code_batches(path, BATCH)) as pf:
            for _ in pf:
                pass

    t_file = host_median(count)
    print(f"[time] count_file {N_READS} reads x {L} bp, k={K} h={H} "
          f"2**{WLOG}, batch {BATCH}: median of 3 {t_file:.4f} s, "
          f"{N_READS / t_file:.6g} reads/s (host clock, parse included) {tag}")
    t_parse = host_median(parse_only)
    print(f"[time] parse only (same file, batches, prefetch thread): median "
          f"of 3 {t_parse:.4f} s, {N_READS / t_parse:.6g} reads/s {tag}")
    return times


def phase_trace(path: Path, pipe, dev, card: str) -> None:
    """One warm count_file under torch.profiler: the device's idle share."""

    def count():
        pipe.sketch.rows.zero_()
        pipe.count_file(path, batch_size=BATCH)

    tr = trace_device(count, device=dev)
    require(tr.busy_seconds > 0, "the trace recorded no device activity")
    print(f"[trace] count_file {N_READS} reads under torch.profiler: wall "
          f"{tr.wall_seconds * 1e3:.3f} ms, device busy "
          f"{tr.busy_seconds * 1e3:.3f} ms (union of device rows), idle share "
          f"{tr.idle_share:.4f} [{card}]")
    for name, (t, n) in sorted(tr.by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"[trace]   {t * 1e3:9.3f} ms  x{n:<3d} {name[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)

    smi, card = phase_env()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_golden(dev)
    codes = make_codes(rng, N_READS)
    k_err, h_err = phase_kernels_vs_plain(rng, codes, dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "reads.fq"
        write_fastq(path, codes)
        pipe, launches = phase_main_path(codes, path, dev)
        times = phase_timings(codes, path, pipe, dev, smi)
        phase_trace(path, pipe, dev, smi)

    t_kmer = times[f"kmer_hash k={K} h={H} buckets 2**{WLOG} {N_READS}x{L}"]
    t_hist = next(v for key, v in times.items() if key.startswith("histogram"))
    print(json.dumps({"kernels": [
        {"name": "kmer_hash", "route": "cuda",
         "source": "nthash_tpu_torch/csrc/kmer_hash.cu",
         "replaces": "nthash_tpu/ops/kmer_pallas.py:72",
         "launches": launches["kmer_hash"], "max_abs_err": k_err,
         "ms": t_kmer[0] * 1e3, "plain_ms": t_kmer[1] * 1e3},
        {"name": "histogram", "route": "cuda",
         "source": "nthash_tpu_torch/csrc/histogram.cu",
         "replaces": "nthash_tpu/ops/hist_pallas.py:133",
         "launches": launches["histogram"], "max_abs_err": h_err,
         "ms": t_hist[0] * 1e3, "plain_ms": t_hist[1] * 1e3},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
