"""The port's long-read route (B2, ``hash_kmers_tm_long``) against the JAX
package, exactly.

``hash_kmers_tm_long`` on a CPU tensor runs its segmented plain version:
each segment of ``time_tile`` windows rolled from zero state as a read of
its own, as the CUDA kernel does. It is held against ``kmer_jnp.hash_kmers``
at L = 10,000, against the Pallas ``hash_kmers_tm_long`` in interpret mode
at the JAX tests' own sizes, and against the whole-read plain roll, which
checks the segments' warm-up argument on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nthash_tpu.models import pipeline as jpipe
from nthash_tpu.ops import kmer_jnp, kmer_pallas
from nthash_tpu_torch.models.pipeline import PipelineConfig, ReadHashingPipeline
from nthash_tpu_torch.ops import kmer_kernel
from nthash_tpu_torch.ops.kmer_kernel import (
    hash_kmers_tm_long,
    hash_kmers_tm_long_plain,
    hash_kmers_tm_plain,
    pick_time_tile,
    prepare_codes,
)
from nthash_tpu_torch.ops.kmer_torch import segment_codes, unsegment
from nthash_tpu_torch.u64 import to_numpy_u64

MODES = [{}, {"emit_fwd_rev": True}, {"emit_buckets": 10}]


def _tm(codes):
    return prepare_codes(torch.from_numpy(codes))


def _jax_outputs(codes, k, h, mode):
    """kmer_jnp's hashes in the wrappers' per-plane [W, R] layout."""
    ref = kmer_jnp.hash_kmers(jnp.asarray(codes), k, h)
    hashes = ref.hashes.to_np()
    if "emit_buckets" in mode:
        wl = mode["emit_buckets"]
        valid = np.asarray(ref.valid)
        return [np.where(valid, hashes[..., i] & np.uint64((1 << wl) - 1),
                         1 << wl).astype(np.int32).T for i in range(h)]
    planes = [hashes[..., i].T for i in range(h)]
    if mode.get("emit_fwd_rev"):
        planes += [ref.fwd.to_np().T, ref.rev.to_np().T]
    return planes


def _as_numpy(outs):
    return [to_numpy_u64(o) if o.dtype == torch.int64 else o.numpy()
            for o in outs]


@pytest.mark.parametrize("mode", MODES, ids=["hashes", "fwd_rev", "buckets"])
def test_long_read_10000_vs_jnp(rng, mode):
    """4 reads of 10,000 bp, k=32, the default time tile (256): the
    ``_long`` contract at nanopore length."""
    codes = rng.integers(0, 6, size=(4, 10_000), dtype=np.uint8)
    got = hash_kmers_tm_long(_tm(codes), 32, 2, **mode)
    want = _jax_outputs(codes, 32, 2, mode)
    assert len(got) == len(want)
    for g, w in zip(_as_numpy(got), want):
        assert g.shape == (10_000 - 31, 4) and np.array_equal(g, w)


def test_long_vs_pallas_interpret_hashes(rng):
    """Hashes + fwd/rev across several time tiles with k not dividing L
    (tests/test_pallas.py's long-kernel size), against the Pallas kernel
    itself in interpret mode."""
    k, length, b = 7, 90, 4
    codes = rng.integers(0, 6, size=(b, length), dtype=np.uint8)
    with jax.disable_jit():
        tm = kmer_pallas.prepare_codes(jnp.asarray(codes), 1)
        want = [o.to_np()[:, :b] for o in kmer_pallas.hash_kmers_tm_long(
            tm, k, 2, time_tile=2 * k, emit_fwd_rev=True, interpret=True)]
    got = hash_kmers_tm_long(_tm(codes), k, 2, time_tile=2 * k,
                             emit_fwd_rev=True)
    for g, w in zip(_as_numpy(got), want):
        assert np.array_equal(g, w)


def test_long_vs_pallas_interpret_buckets(rng):
    k, length, b, wl = 5, 40, 2, 10
    codes = rng.integers(0, 6, size=(b, length), dtype=np.uint8)
    with jax.disable_jit():
        tm = kmer_pallas.prepare_codes(jnp.asarray(codes), 1)
        want = [np.asarray(o)[:, :b] for o in kmer_pallas.hash_kmers_tm_long(
            tm, k, 2, time_tile=2 * k, emit_buckets=wl, interpret=True)]
    got = hash_kmers_tm_long(_tm(codes), k, 2, time_tile=2 * k,
                             emit_buckets=wl)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", MODES, ids=["hashes", "fwd_rev", "buckets"])
@pytest.mark.parametrize("k,length,tile", [
    (1, 50, 1), (1, 50, 7), (5, 5, 5), (5, 41, 10), (5, 200, 15),
    (7, 90, 14), (9, 300, 900), (32, 32, 32), (32, 600, 64), (33, 400, 66),
    (64, 300, 128), (65, 1000, 65)])
def test_segmented_plain_equals_whole_read_plain(rng, k, length, tile, mode):
    """Segments rolled from zero state give every window exactly: time tiles
    k, 2k, 3k and >= W, tiles that do not divide W, L = k, k = 1."""
    codes = rng.integers(0, 6, size=(5, length), dtype=np.uint8)
    tm = _tm(codes)
    long = hash_kmers_tm_long_plain(tm, k, 3, time_tile=tile, **mode)
    whole = hash_kmers_tm_plain(tm, k, 3, **mode)
    assert all(torch.equal(a, b) for a, b in zip(long, whole))
    assert all(torch.equal(a, b) for a, b in zip(
        hash_kmers_tm_long(tm, k, 3, time_tile=tile, **mode), whole))


@pytest.mark.parametrize("reads", [1, 3, 32, 33])
def test_long_any_read_count(rng, reads):
    codes = rng.integers(0, 6, size=(reads, 300), dtype=np.uint8)
    tm = _tm(codes)
    for a, b in zip(hash_kmers_tm_long(tm, 9, 2, time_tile=18),
                    _jax_outputs(codes, 9, 2, {})):
        assert np.array_equal(to_numpy_u64(a), b)


def test_segment_codes_layout():
    """Column j * R + r holds read r's bases [j*seg, (j+1)*seg + k - 1),
    the tail padded with the invalid code; unsegment inverts it."""
    length, reads, k, seg = 23, 3, 4, 6
    tm = torch.arange(length * reads, dtype=torch.int32).reshape(length, reads)
    segs = segment_codes(tm, k, seg)
    nseg = -(-(length - k + 1) // seg)
    assert segs.shape == (seg + k - 1, nseg * reads)
    for j in range(nseg):
        for r in range(reads):
            col = segs[:, j * reads + r].tolist()
            want = [int(tm[t, r]) if t < length else 4
                    for t in range(j * seg, (j + 1) * seg + k - 1)]
            assert col == want
    windows = torch.arange(seg * nseg * reads).reshape(seg, nseg * reads)
    back = unsegment(windows, length - k + 1, reads)
    assert back.shape == (length - k + 1, reads)
    assert int(back[seg + 1, 2]) == int(windows[1, reads + 2])


@pytest.mark.parametrize("k", [1, 2, 5, 7, 21, 31, 32, 33, 63, 64, 100, 255,
                               256, 300])
def test_pick_time_tile_vs_jax(k):
    assert pick_time_tile(k) == kmer_pallas.pick_time_tile(k)
    assert pick_time_tile(k, 64) == kmer_pallas.pick_time_tile(k, 64)


def test_time_tile_must_be_multiple_of_k(rng):
    tm = _tm(rng.integers(0, 4, size=(2, 40), dtype=np.uint8))
    for fn in (hash_kmers_tm_long, hash_kmers_tm_long_plain):
        with pytest.raises(ValueError, match="multiple of k"):
            fn(tm, 5, 1, time_tile=12)
    with pytest.raises(ValueError, match="smaller than k"):
        hash_kmers_tm_long(tm, 41, 1)
    with pytest.raises(ValueError, match="exclusive"):
        hash_kmers_tm_long(tm, 5, 1, emit_fwd_rev=True, emit_buckets=10)
    for fn in (hash_kmers_tm_long, kmer_kernel.hash_kmers_tm_auto):
        with pytest.raises(ValueError, match="greater than 0"):
            fn(tm, 0, 1)


def test_cpu_long_route_launches_no_kernel(rng):
    before = (kmer_kernel.LAUNCHES, kmer_kernel.LONG_LAUNCHES)
    hash_kmers_tm_long(_tm(rng.integers(0, 4, size=(2, 40), dtype=np.uint8)),
                       5, 2, time_tile=10)
    assert (kmer_kernel.LAUNCHES, kmer_kernel.LONG_LAUNCHES) == before


@pytest.fixture
def long_fastq(tmp_path, rng):
    """8 reads of 2,000 bp with ~1/5 N."""
    path = tmp_path / "long.fq"
    n, length = 8, 2000
    seqs = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, size=(n, length))]
    with open(path, "wb") as f:
        for i in range(n):
            f.write(b"@r%d\n" % i + seqs[i].tobytes() + b"\n+\n"
                    + b"I" * length + b"\n")
    return path, n, length


def test_long_read_count_file_vs_jax(long_fastq):
    """The port's count_file on long reads, through the segmented route,
    builds the JAX package's sketch. JAX's own count_file would run its
    Pallas kernels in interpret mode over 2,000 unrolled steps (many
    minutes on the CPU), so the JAX side is run_file, the jnp engine with
    scatter counting, which builds the same sketch."""
    path, n, length = long_fastq
    k, h, wl = 32, 4, 12
    cfg = dict(k=k, num_hashes=h, sketch_width_log2=wl)
    assert kmer_kernel.long_read_threshold(length, k, 4)
    assert kmer_pallas.long_read_threshold(length, length - k + 1, h, 1024)
    pipe = ReadHashingPipeline(PipelineConfig(**cfg), device="cpu")
    assert pipe.count_file(path, batch_size=4, read_length=length) == n
    jp = jpipe.ReadHashingPipeline(jpipe.PipelineConfig(**cfg, n_devices=1))
    jtotal = jp.run_file(path, batch_size=4, read_length=length)
    assert np.array_equal(pipe.sketch.to_numpy(), np.asarray(jp.sketch.rows))
    assert int(pipe.sketch.rows[0].sum()) == jtotal
