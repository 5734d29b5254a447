"""Stateful iterator facade: API parity with the reference's public classes.

Counterpart of ``nthash_tpu/api.py``. Mirrors the reference header
(include/nthash/nthash.hpp:62-646): ``NtHash``, ``BlindNtHash``,
``SeedNtHash``, ``BlindSeedNtHash``, and ``parse_seeds``, with the same
roll/roll_back/peek/peek_back/hashes/get_* surface and the same position and
N-skip semantics (including the SeedNtHash init quirk, reference
src/seed.cpp:151). Fatal constructor errors raise :class:`ValueError` with
the reference's messages instead of calling ``exit(1)``; the non-palindrome
seed check emits a :class:`UserWarning` (reference src/seed.cpp:85-104).
Results are numpy arrays and Python ints, as the JAX facade returns them.

Design: the stored-sequence classes are a thin stateful view over the
one-sequence entries of the hash kernels. Window hashes are computed one
``FACADE_TILE_WINDOWS`` tile at a time with at most two tiles resident, so
iteration is pointer movement at the reference's O(k)-memory envelope up to
tile granularity (a 3-Gbp sequence never materializes a whole-genome table).
A tile is one flat chunk of the sequence (its windows plus k - 1 bases),
hashed by ``ops.kmer_kernel.hash_sequence`` or
``ops.seed_kernel.hash_seeds_sequence`` with ``emit_fwd_rev=True`` on
``device`` (engine "kernel": the CUDA kernels on the card, their plain
versions for ``device="cpu"``), or by the host oracle (engine "oracle").
"auto" takes the oracle below :data:`AUTO_DEVICE_THRESHOLD` bases and the
kernel from there. A CUDA device with no GPU raises when the first kernel
tile is hashed; nothing falls back to the oracle or the CPU. The Blind
classes keep O(1) host-side carried state exactly like the reference's
deque design, since they exist to be fed one caller-chosen base at a time
(de Bruijn graph probing); for bulk caller-fed streams use
``ops.blind_scan`` / ``ops.blind_seed_scan``.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from . import oracle
from .constants import (
    CODE_N,
    M64,
    MASK31,
    MASK33,
    encode_ascii,
    extend_hashes,
    srol1,
    sror1,
)

__all__ = [
    "NtHash",
    "BlindNtHash",
    "SeedNtHash",
    "BlindSeedNtHash",
    "parse_seeds",
    "NTHASH_FN_NAME",
]

from .constants import NTHASH_FN_NAME

#: The facade's engines: "oracle" (host NumPy, no device), "kernel" (the
#: one-sequence entries on ``device``), "auto" (the oracle below the
#: threshold, the kernel from it), as ``parallel/sp.py``'s engines.
ENGINES = ("auto", "oracle", "kernel")

#: Sequence length (bases) from which "auto" hashes a tile with the kernel
#: on a CUDA device; below it the host oracle avoids a launch and two copies
#: for tiny inputs. Measured on an NVIDIA H100 80GB HBM3 at 700 W (one
#: tile through the oracle and through the kernel, the copies included, at
#: 2**4..2**16 windows, k=32, h=1): the kernel wins from 64 windows on,
#: 0.1813 against 0.2209 ms (CHANGES.md, readings behind the
#: comments; ``examples/facade_threshold_torch.py --device cuda`` measures
#: it).
AUTO_DEVICE_THRESHOLD = 64
#: The same for ``device="cpu"``, where the "kernel" engine is the kernels'
#: plain PyTorch versions: a CPU number, measured on an 8-core CPU by
#: ``examples/facade_threshold_torch.py --device cpu`` (the plain version
#: won from 8,192 windows in one run and from 16,384 in another, within 5%
#: of the oracle at 8,192; PERF.md section 6).
AUTO_DEVICE_THRESHOLD_CPU = 8192


def _auto_device_threshold(device: torch.device) -> int:
    return (AUTO_DEVICE_THRESHOLD_CPU if device.type == "cpu"
            else AUTO_DEVICE_THRESHOLD)


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: one of {ENGINES}")


#: Windows per lazily-hashed facade tile. The stored-sequence classes hash
#: one tile on demand and keep at most two resident (the second avoids
#: thrash when rolling across a tile boundary), restoring the reference's
#: O(k)-memory iteration envelope (reference src/kmer.cpp:246-264) up to
#: tile granularity: a 3-Gbp NtHash peaks at ~2 tiles x ~26 B/window
#: instead of a ~78 GB whole-sequence table.
FACADE_TILE_WINDOWS = 1 << 22


def _host(planes: list, windows: int) -> np.ndarray:
    """Device planes [C] -> one host uint64 array [windows, len(planes)]:
    stacked on their device, trimmed, then one copy to the host."""
    return (torch.stack(planes, 1)[:windows].cpu().numpy()
            .view(np.uint64))


def _kernel_tile(chunk: np.ndarray, k: int, num_hashes: int, device):
    """(fwd, rev, hashes, valid) of the windows of ``chunk`` through
    ``hash_sequence(..., emit_fwd_rev=True)`` on ``device``, or, on a CUDA
    device where k does not fit the one-sequence entry (decided from the
    shapes), through the read kernel over pseudo-reads
    (``hash_sequence_rows``)."""
    from .ops import kmer_kernel

    w = len(chunk) - k + 1
    codes = torch.from_numpy(chunk).to(device)
    entry = kmer_kernel.hash_sequence
    if codes.is_cuda and not kmer_kernel.sequence_fits(k, num_hashes, True):
        entry = kmer_kernel.hash_sequence_rows
    outs, valid = entry(codes, k, num_hashes, emit_fwd_rev=True)
    planes = _host(outs, w)
    return (planes[:, num_hashes], planes[:, num_hashes + 1],
            planes[:, :num_hashes], valid[:w].cpu().numpy())


def _seed_kernel_tile(chunk: np.ndarray, seeds: tuple[str, ...],
                      num_hashes: int, device):
    """(fwd [W, S], rev [W, S], hashes [W, S * num_hashes]) of the windows of
    ``chunk`` through ``hash_seeds_sequence(..., emit_fwd_rev=True)`` on
    ``device``, or, on a CUDA device where the seeds do not fit the
    one-sequence entry (decided from the shapes), through B1 over
    pseudo-reads (``hash_seeds_sequence_rows``). A seed with no care
    position hashes to 0 (``seed_kernel.with_empty_seeds``)."""
    from .ops import seed_kernel

    k = len(seeds[0])
    w = len(chunk) - k + 1
    codes = torch.from_numpy(chunk).to(device)

    def hash_care(x, care):
        entry = seed_kernel.hash_seeds_sequence
        if x.is_cuda and not seed_kernel.sequence_fits(care, num_hashes,
                                                       True):
            entry = seed_kernel.hash_seeds_sequence_rows
        return entry(x, care, num_hashes, emit_fwd_rev=True)

    outs, _ = seed_kernel.with_empty_seeds(hash_care, codes, seeds,
                                           num_hashes, emit_fwd_rev=True)
    g, s = num_hashes + 2, len(seeds)
    order = ([si * g + i for si in range(s) for i in range(num_hashes)]
             + [si * g + num_hashes for si in range(s)]
             + [si * g + num_hashes + 1 for si in range(s)])
    planes = _host([outs[i] for i in order], w)
    sh = s * num_hashes
    return planes[:, sh:sh + s], planes[:, sh + s:], planes[:, :sh]


class _TileCache:
    """On-demand per-tile window tables with a 2-tile LRU.

    ``compute(start, stop)`` returns a tuple of arrays for windows
    [start, stop); ``get(pos)`` returns that tuple plus the offset of
    ``pos`` within its tile.
    """

    def __init__(self, compute, n_windows: int, tile: int):
        self._compute = compute
        self._n = n_windows
        self._tile = tile
        self._tiles: dict[int, tuple] = {}  # insertion-ordered LRU

    def get(self, pos: int) -> tuple[tuple, int]:
        ti = pos // self._tile
        arrs = self._tiles.get(ti)
        if arrs is None:
            start = ti * self._tile
            stop = min(start + self._tile, self._n)
            arrs = self._compute(start, stop)
            self._tiles[ti] = arrs
            while len(self._tiles) > 2:
                self._tiles.pop(next(iter(self._tiles)))
        return arrs, pos - ti * self._tile

    def resident_windows(self) -> int:
        """Windows currently materialized (tests pin the O(tile) bound)."""
        return sum(a[0].shape[0] for a in self._tiles.values())


def _next_valid_pos(codes: np.ndarray, k: int, pos: int) -> int:
    """First valid window at/after ``pos`` with the reference's jump
    semantics (rightmost invalid base + 1, reference kmer.cpp:25-35,
    228-244); returns the reference's overshot position when exhausted.
    Pure index arithmetic on the stored codes — no hashing, so N-rich
    regions are skipped without materializing any tile."""
    last = len(codes) - k
    while pos <= last:
        bad = np.nonzero(codes[pos : pos + k] == CODE_N)[0]
        if bad.size == 0:
            return pos
        pos += int(bad[-1]) + 1
    return pos


def parse_seeds(seed_strings: Sequence[str]) -> list[list[int]]:
    """Pattern strings -> per-seed don't-care position lists
    (reference src/seed.cpp:431-447, legacy btllib interface)."""
    return oracle.parse_seeds(seed_strings)


def _as_codes(seq) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return np.minimum(seq.astype(np.uint8), CODE_N)
    return encode_ascii(seq)


class NtHash:
    """Rolling k-mer hasher over a stored sequence (reference nthash.hpp:62-211).

    >>> h = NtHash("TGACTGATCGAGTCGTACTAG", 1, 5)
    >>> while h.roll():
    ...     _ = h.hashes()
    """

    _CLASS = "NtHash"

    def __init__(self, seq, num_hashes: int, k: int, pos: int = 0, *,
                 engine: str = "auto", tile_windows: int | None = None,
                 device="cuda"):
        _check_engine(engine)
        self._device = torch.device(device)
        self._codes = _as_codes(seq)
        self._num_hashes = int(num_hashes)
        self._k = int(k)
        self._pos = int(pos)
        self._initialized = False
        self._engine = engine
        self._tile_windows = tile_windows or FACADE_TILE_WINDOWS
        self._table = None
        # resident-tile fast path for roll()/__iter__: the current tile's
        # arrays and its window range, so the steady-state roll is plain
        # numpy indexing with no cache lookup
        self._cur: tuple | None = None
        self._cur_base = 0
        self._cur_stop = 0
        # during bulk __iter__ only _pos advances per step; fwd/rev/
        # hash_arr refresh lazily from the resident tile on access
        self._stale = False
        self._fwd = 0
        self._rev = 0
        self._hash_arr = np.zeros(self._num_hashes, dtype=np.uint64)
        n = len(self._codes)
        if self._k == 0:
            raise ValueError(f"[ntHash::{self._CLASS}] k must be greater than 0")
        if n < self._k:
            raise ValueError(
                f"[ntHash::{self._CLASS}] sequence length ({n}) is smaller "
                f"than k ({self._k})"
            )
        if self._pos > n - self._k:
            raise ValueError(
                f"[ntHash::{self._CLASS}] passed position ({self._pos}) is "
                f"larger than sequence length ({n})"
            )

    # -- internals ---------------------------------------------------------

    def _ensure_table(self):
        """Build the lazy tile cache: (fwd, rev, hashes, valid) per window,
        hashed one ``tile_windows`` tile at a time with at most two tiles
        resident — O(tile), not O(L), host memory (the reference rolls any
        length in O(k), kmer.cpp:246-264)."""
        if self._table is not None:
            return
        k, h = self._k, self._num_hashes
        use_device = self._use_kernel()

        def compute(start: int, stop: int):
            chunk = self._codes[start : stop + k - 1]
            if use_device:
                arrs = _kernel_tile(chunk, k, h, self._device)
            else:
                arrs = oracle.hash_all_windows(chunk, k, h)
            # hashes() returns read-only views into these tables (the
            # reference returns a const pointer, nthash.hpp:139-146);
            # freezing catches accidental caller mutation
            for a in arrs:
                a.flags.writeable = False
            return arrs

        self._table = _TileCache(
            compute, len(self._codes) - k + 1, self._tile_windows
        )

    def _use_kernel(self) -> bool:
        """Whether tiles go through the kernel engine: "kernel", or "auto"
        from the device's threshold on."""
        return self._engine == "kernel" or (
            self._engine == "auto"
            and min(len(self._codes), self._tile_windows)
            >= _auto_device_threshold(self._device)
        )

    def _load(self, pos: int):
        base = self._cur_base
        if self._cur is None or not base <= pos < self._cur_stop:
            self._ensure_table()
            arrs, off = self._table.get(pos)
            self._cur = arrs
            base = pos - off
            self._cur_base = base
            self._cur_stop = base + len(arrs[0])
        fwd, rev, hashes, _ = self._cur
        off = pos - base
        # numpy uint64 scalars (not int()-converted: the conversion cost
        # dominated the hot roll); accessors convert on demand
        self._fwd = fwd[off]
        self._rev = rev[off]
        self._hash_arr = hashes[off]

    def _init(self) -> bool:
        """Find the first valid window at/after pos (reference kmer.cpp:228-244)."""
        last = len(self._codes) - self._k
        p = _next_valid_pos(self._codes, self._k, self._pos)
        self._pos = p
        if p > last:
            return False
        self._load(p)
        self._stale = False
        self._initialized = True
        return True

    def _refresh(self):
        """Refresh fwd/rev/hash_arr from the resident tile after bulk
        __iter__ advanced only _pos (lazy state sync)."""
        if self._stale:
            self._load(self._pos)

    # -- public API --------------------------------------------------------

    def roll(self) -> bool:
        """Advance to the next valid k-mer (reference kmer.cpp:246-264)."""
        if not self._initialized:
            return self._init()
        last = len(self._codes) - self._k
        if self._pos >= last:
            return False
        if self._codes[self._pos + self._k] == CODE_N:
            self._pos += self._k
            return self._init()
        self._pos += 1
        self._load(self._pos)
        self._stale = False
        return True

    def roll_back(self) -> bool:
        """Roll one k-mer backwards (reference kmer.cpp:266-289)."""
        if not self._initialized:
            return self._init()
        if self._pos == 0:
            return False
        prev_invalid = self._codes[self._pos - 1] == CODE_N
        if prev_invalid and self._pos >= self._k:
            self._pos -= self._k
            return self._init()
        if prev_invalid:
            return False
        self._pos -= 1
        self._load(self._pos)
        self._stale = False
        return True

    def peek(self, char_in: str | None = None) -> bool:
        """Hash the next k-mer into hashes() without advancing
        (reference kmer.cpp:291-313)."""
        if char_in is None:
            if self._pos >= len(self._codes) - self._k:
                return False
            return self.peek(self._codes[self._pos + self._k])
        if not self._initialized:
            return self._init()
        code_in = int(_as_codes(char_in)[0]) if isinstance(char_in, str) else int(char_in)
        if code_in == CODE_N:
            return False
        self._refresh()
        code_out = int(self._codes[self._pos])
        fwd = oracle.next_forward_hash(
            int(self._fwd), self._k, code_out, code_in)
        rev = oracle.next_reverse_hash(
            int(self._rev), self._k, code_out, code_in)
        self._hash_arr = np.array(
            extend_hashes(fwd, rev, self._k, self._num_hashes), dtype=np.uint64
        )
        return True

    def peek_back(self, char_in: str | None = None) -> bool:
        """Hash the previous k-mer into hashes() without moving
        (reference kmer.cpp:315-336)."""
        if char_in is None:
            if self._pos == 0:
                return False
            return self.peek_back(self._codes[self._pos - 1])
        if not self._initialized:
            return self._init()
        code_in = int(_as_codes(char_in)[0]) if isinstance(char_in, str) else int(char_in)
        if code_in == CODE_N:
            return False
        self._refresh()
        code_out = int(self._codes[self._pos + self._k - 1])
        fwd = oracle.prev_forward_hash(
            int(self._fwd), self._k, code_out, code_in)
        rev = oracle.prev_reverse_hash(
            int(self._rev), self._k, code_out, code_in)
        self._hash_arr = np.array(
            extend_hashes(fwd, rev, self._k, self._num_hashes), dtype=np.uint64
        )
        return True

    def hashes(self) -> np.ndarray:
        """Current hash values (length get_hash_num())."""
        self._refresh()
        return self._hash_arr

    def get_pos(self) -> int:
        return self._pos

    def get_hash_num(self) -> int:
        return self._num_hashes

    def get_k(self) -> int:
        return self._k

    def get_forward_hash(self) -> int:
        self._refresh()
        return int(self._fwd)

    def get_reverse_hash(self) -> int:
        self._refresh()
        return int(self._rev)

    def copy(self) -> "NtHash":
        """Deep copy (parity with the reference copy ctor, nthash.hpp:95-107)."""
        self._refresh()
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._hash_arr = self._hash_arr.copy()
        return new

    def __iter__(self):
        """Bulk-stream every remaining valid window in roll() order.

        Yields the hashes row (a uint64 [num_hashes] view per window): the
        windows and hashes of ``while h.roll(): yield h.hashes()``. Object
        state tracks every yielded window, including after an early
        ``break``: get_pos() is exact per step, and fwd/rev/hashes refresh
        lazily from the resident tile on access (the per-step work is one
        position store and a yield). Two deliberate divergences from the
        ``while roll()`` loop: the positions of a tile are listed when the
        walk enters it, so roll()/roll_back() calls made on the object
        mid-iteration are ignored until the next tile; and after
        exhaustion get_pos() is the last valid window, not the position a
        failed roll() overshoots to."""
        if not self._initialized:
            if not self._init():
                return
            yield self._hash_arr
        last = len(self._codes) - self._k
        self._ensure_table()
        lastp = self._pos
        while self._pos < last:
            # bulk-slice the remainder of the tile holding pos + 1
            arrs, off = self._table.get(self._pos + 1)
            fwd, rev, hashes, valid = arrs
            base = self._pos + 1 - off
            self._cur, self._cur_base = arrs, base
            self._cur_stop = base + len(fwd)
            offs = np.nonzero(valid[off:])[0] + off
            # roll() visits exactly the valid windows in order: an N at
            # the incoming base invalidates every window crossing it, so
            # the jump-past-N re-init lands on the next valid window
            positions = (offs + base).tolist()
            self._stale = True
            for p, row in zip(positions, hashes[offs]):
                self._pos = p
                yield row
            if positions:
                lastp = positions[-1]
            if self._pos < self._cur_stop - 1 or not positions:
                # no valid window in the rest of this tile: skip it
                self._pos = min(self._cur_stop - 1, last)
        # exhausted: state reflects the last valid window yielded (the
        # reference's failed roll() leaves hashes untouched)
        self._pos = lastp


class BlindNtHash:
    """Caller-fed k-mer hasher for de Bruijn graph traversal
    (reference nthash.hpp:213-311, src/kmer.cpp:338-393).

    Holds only a k-base window; the caller supplies each next/previous base.
    No N handling — the caller guarantees valid bases (an invalid base hashes
    with the zero seed, exactly like the reference).
    """

    _CLASS = "BlindNtHash"

    def __init__(self, seq, num_hashes: int, k: int, pos: int = 0):
        if k == 0:
            raise ValueError(f"[ntHash::{self._CLASS}] k must be greater than 0")
        from collections import deque

        codes = _as_codes(seq)
        self._window = deque(int(c) for c in codes[pos : pos + k])
        self._num_hashes = int(num_hashes)
        self._k = k
        self._pos = int(pos)
        win = np.array(self._window, np.uint8)
        self._fwd = oracle.forward_hash(win, k)
        self._rev = oracle.reverse_hash(win, k)
        # per-k tap tables (Python ints) so the per-call roll is a handful
        # of int ops instead of oracle calls: the
        # rolling updates (reference kmer.cpp:84-94, 164-194) only ever
        # need SEED[c], srol^k(SEED[c]) and their complements
        from .constants import COMP_CODE, MULTISEED, SEEDS, srol

        self._seed = [SEEDS[c] for c in range(5)]
        self._seed_k = [srol(SEEDS[c], k) for c in range(5)]
        self._rseed = [SEEDS[COMP_CODE[c]] for c in range(5)]
        self._rseed_k = [srol(SEEDS[COMP_CODE[c]], k) for c in range(5)]
        self._mults = [
            (i ^ (k * MULTISEED)) & M64 for i in range(self._num_hashes)
        ]
        self._hash_arr = np.empty(self._num_hashes, dtype=np.uint64)
        self._extend()

    def _extend(self):
        """nte64 extension into the preallocated hash array (reference
        internal.hpp:104-118)."""
        self._write_hashes(self._fwd, self._rev)

    @staticmethod
    def _code(ch) -> int:
        return int(_as_codes(ch)[0]) if isinstance(ch, str) else int(ch)

    def roll(self, char_in) -> None:
        """Slide right by the caller-supplied base (reference kmer.cpp:355-364)."""
        code_in = char_in if type(char_in) is int else self._code(char_in)
        w = self._window
        code_out = w[0]
        # next_forward_hash: srol1(fwd) ^ SEED[in] ^ srol^k(SEED[out])
        f = self._fwd
        lo = f & MASK33
        hi = f >> 33
        f = ((((hi << 1) | (hi >> 30)) & MASK31) << 33) \
            | (((lo << 1) | (lo >> 32)) & MASK33)
        self._fwd = f ^ self._seed[code_in] ^ self._seed_k[code_out]
        # next_reverse_hash: sror1(rev ^ srol^k(SEED[comp in]) ^ SEED[comp out])
        r = self._rev ^ self._rseed_k[code_in] ^ self._rseed[code_out]
        lo = r & MASK33
        hi = r >> 33
        self._rev = ((((hi >> 1) | (hi << 30)) & MASK31) << 33) \
            | (((lo >> 1) | (lo << 32)) & MASK33)
        self._extend()
        w.popleft()
        w.append(code_in)
        self._pos += 1

    def roll_back(self, char_in) -> None:
        """Slide left by the caller-supplied base (reference kmer.cpp:366-375)."""
        code_in = char_in if type(char_in) is int else self._code(char_in)
        w = self._window
        code_out = w[-1]
        # prev_forward_hash: sror1(fwd ^ srol^k(SEED[in]) ^ SEED[out])
        f = self._fwd ^ self._seed_k[code_in] ^ self._seed[code_out]
        lo = f & MASK33
        hi = f >> 33
        self._fwd = ((((hi >> 1) | (hi << 30)) & MASK31) << 33) \
            | (((lo >> 1) | (lo << 32)) & MASK33)
        # prev_reverse_hash: srol1(rev) ^ SEED[comp in] ^ srol^k(SEED[comp out])
        r = self._rev
        lo = r & MASK33
        hi = r >> 33
        r = ((((hi << 1) | (hi >> 30)) & MASK31) << 33) \
            | (((lo << 1) | (lo >> 32)) & MASK33)
        self._rev = r ^ self._rseed[code_in] ^ self._rseed_k[code_out]
        self._extend()
        w.pop()
        w.appendleft(code_in)
        self._pos -= 1

    def _write_hashes(self, f: int, r: int):
        h0 = (f + r) & M64
        ha = self._hash_arr
        ha[0] = h0
        for i in range(1, self._num_hashes):
            t = (h0 * self._mults[i]) & M64
            ha[i] = t ^ (t >> 27)

    def peek(self, char_in) -> None:
        """Hash of the window rolled right, without committing
        (reference kmer.cpp:377-384). Same tap-table fast path as roll()
        — peek is the hot de Bruijn probe (4 calls per node)."""
        code_in = char_in if type(char_in) is int else self._code(char_in)
        code_out = self._window[0]
        f = self._fwd
        lo = f & MASK33
        hi = f >> 33
        f = ((((hi << 1) | (hi >> 30)) & MASK31) << 33) \
            | (((lo << 1) | (lo >> 32)) & MASK33)
        f ^= self._seed[code_in] ^ self._seed_k[code_out]
        r = self._rev ^ self._rseed_k[code_in] ^ self._rseed[code_out]
        lo = r & MASK33
        hi = r >> 33
        r = ((((hi >> 1) | (hi << 30)) & MASK31) << 33) \
            | (((lo >> 1) | (lo << 32)) & MASK33)
        self._write_hashes(f, r)

    def peek_back(self, char_in) -> None:
        """Hash of the window rolled left, without committing
        (reference kmer.cpp:386-393)."""
        code_in = char_in if type(char_in) is int else self._code(char_in)
        code_out = self._window[-1]
        f = self._fwd ^ self._seed_k[code_in] ^ self._seed[code_out]
        lo = f & MASK33
        hi = f >> 33
        f = ((((hi >> 1) | (hi << 30)) & MASK31) << 33) \
            | (((lo >> 1) | (lo << 32)) & MASK33)
        r = self._rev
        lo = r & MASK33
        hi = r >> 33
        r = ((((hi << 1) | (hi >> 30)) & MASK31) << 33) \
            | (((lo << 1) | (lo >> 32)) & MASK33)
        r ^= self._rseed[code_in] ^ self._rseed_k[code_out]
        self._write_hashes(f, r)

    def hashes(self) -> np.ndarray:
        return self._hash_arr

    def get_pos(self) -> int:
        return self._pos

    def get_hash_num(self) -> int:
        return self._num_hashes

    def get_k(self) -> int:
        return len(self._window)

    def get_forward_hash(self) -> int:
        return self._fwd

    def get_reverse_hash(self) -> int:
        return self._rev

    def copy(self) -> "BlindNtHash":
        from collections import deque

        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._window = deque(self._window)
        new._hash_arr = self._hash_arr.copy()
        return new


def _check_seeds(seeds: Sequence[str], k: int, cls: str):
    """Reference src/seed.cpp:85-104: length mismatch fatal, asymmetry warns."""
    for seed in seeds:
        if len(seed) != k:
            raise ValueError(
                f"[ntHash::{cls}] Spaced seed string length ({len(seed)}) "
                f"not equal to k={k} in {seed}"
            )
        if seed != seed[::-1]:
            warnings.warn(
                f"[ntHash::{cls}] Seed {seed} is not symmetric, "
                "reverse-complement hashing will be inconsistent",
                UserWarning,
                stacklevel=3,
            )


def _seeds_from_parsed(parsed: Sequence[Sequence[int]], k: int) -> tuple[str, ...]:
    """Don't-care position lists -> pattern strings (reference seed.cpp:68-83)."""
    out = []
    for dont_care in parsed:
        pattern = ["1"] * k
        for i in dont_care:
            pattern[i] = "0"
        out.append("".join(pattern))
    return tuple(out)


class SeedNtHash:
    """Rolling spaced-seed hasher over a stored sequence
    (reference nthash.hpp:313-521, src/seed.cpp:449-667).

    ``seeds`` may be pattern strings ("10101") or parsed don't-care position
    lists (the legacy btllib interface, reference seed.cpp:473-491).

    Faithfully replicates the reference's N-handling by default: the init
    scan never fails on N (it hashes with the zero seed, reference
    src/seed.cpp:151); only an N *entering* during a roll triggers the
    skip. Pass ``strict_n_init=True`` to fix the quirk: (re-)init then
    skips to the first window free of invalid bases, matching NtHash's
    semantics (non-default because hash *positions* are part of the
    reference's observable behavior).
    """

    _CLASS = "SeedNtHash"

    def __init__(self, seq, seeds, num_hashes_per_seed: int, k: int,
                 pos: int = 0, *, engine: str = "auto",
                 strict_n_init: bool = False,
                 tile_windows: int | None = None, device="cuda"):
        _check_engine(engine)
        self._device = torch.device(device)
        self._strict_n_init = strict_n_init
        self._tile_windows = tile_windows or FACADE_TILE_WINDOWS
        self._taps = None  # built on first peek/peek_back
        self._codes = _as_codes(seq)
        if seeds and not isinstance(seeds[0], str):
            self._seeds = _seeds_from_parsed(seeds, k)
        else:
            self._seeds = tuple(seeds)
            _check_seeds(self._seeds, k, self._CLASS)
            if len(self._seeds[0]) != k:
                raise ValueError(
                    f"[ntHash::{self._CLASS}] k should be equal to seed "
                    "string lengths"
                )
        self._num_hashes_per_seed = int(num_hashes_per_seed)
        self._k = int(k)
        self._pos = int(pos)
        self._initialized = False
        self._engine = engine
        self._table = None
        # resident-tile fast path + lazy bulk-iter state, as in NtHash
        self._cur: tuple | None = None
        self._cur_base = 0
        self._cur_stop = 0
        self._stale = False
        s = len(self._seeds)
        self._fwd = np.zeros(s, dtype=np.uint64)
        self._rev = np.zeros(s, dtype=np.uint64)
        self._hash_arr = np.zeros(s * self._num_hashes_per_seed, np.uint64)

    def _ensure_table(self):
        """Lazy per-tile (fwd, rev, hashes) tables, 2-tile LRU — same
        O(tile) memory envelope as :meth:`NtHash._ensure_table`."""
        if self._table is not None:
            return
        k, h = self._k, self._num_hashes_per_seed
        seeds = self._seeds
        use_device = self._use_kernel()

        def compute(start: int, stop: int):
            chunk = self._codes[start : stop + k - 1]
            if use_device:
                arrs = _seed_kernel_tile(chunk, seeds, h, self._device)
            else:
                arrs = oracle.hash_all_windows_seeds(chunk, seeds, h)
            for a in arrs:  # rows are served as read-only views
                a.flags.writeable = False
            return arrs

        self._table = _TileCache(
            compute, len(self._codes) - k + 1, self._tile_windows
        )

    _use_kernel = NtHash._use_kernel

    def _load(self, pos: int):
        base = self._cur_base
        if self._cur is None or not base <= pos < self._cur_stop:
            self._ensure_table()
            arrs, off = self._table.get(pos)
            self._cur = arrs
            base = pos - off
            self._cur_base = base
            self._cur_stop = base + len(arrs[0])
        fwd, rev, hashes = self._cur
        off = pos - base
        self._fwd = fwd[off]
        self._rev = rev[off]
        self._hash_arr = hashes[off]

    def _init(self) -> bool:
        """Reference seed.cpp:493-516 — with the quirk, the scan accepts the
        first in-range position unconditionally (unless strict_n_init)."""
        last = len(self._codes) - self._k
        if self._strict_n_init:
            self._pos = _next_valid_pos(self._codes, self._k, self._pos)
        if self._pos > last:
            return False
        self._load(self._pos)
        self._stale = False
        self._initialized = True
        return True

    def _refresh(self):
        """Refresh fwd/rev/hash_arr from the resident tile after bulk
        __iter__ advanced only _pos (lazy state sync)."""
        if self._stale:
            self._load(self._pos)

    def roll(self) -> bool:
        """Reference seed.cpp:518-544."""
        if not self._initialized:
            return self._init()
        last = len(self._codes) - self._k
        if self._pos >= last:
            return False
        if self._codes[self._pos + self._k] == CODE_N:
            self._pos += self._k
            return self._init()
        self._pos += 1
        self._load(self._pos)
        self._stale = False
        return True

    def roll_back(self) -> bool:
        """Reference seed.cpp:546-575."""
        if not self._initialized:
            return self._init()
        if self._pos == 0:
            return False
        prev_invalid = self._codes[self._pos - 1] == CODE_N
        if prev_invalid and self._pos >= self._k:
            self._pos -= self._k
            return self._init()
        if prev_invalid:
            return False
        self._pos -= 1
        self._load(self._pos)
        self._stale = False
        return True

    def _ensure_taps(self):
        """Two-tap rolling tables per maximal care run per seed — the
        O(#care-runs) state-rolling machinery shared with
        :class:`BlindSeedNtHash` (derivation in ops/seed_kernel.py)."""
        if self._taps is None:
            from .ops.seed_kernel import seed_taps

            self._taps = [seed_taps(p) for p in self._seeds]

    def _peeked(self, fwds, revs) -> np.ndarray:
        m2 = self._num_hashes_per_seed
        out = np.zeros(len(self._seeds) * m2, np.uint64)
        for si, (f, r) in enumerate(zip(fwds, revs)):
            out[si * m2 : (si + 1) * m2] = extend_hashes(f, r, self._k, m2)
        return out

    def peek(self, char_in: str | None = None) -> bool:
        """Reference seed.cpp:577-623: hash of the next window into hashes()
        without advancing. Rolls from the carried per-seed state in
        O(#care-runs) per seed — matching the reference's O(#blocks) peek
        (seed.cpp:577-667), not an O(k*S) window rehash."""
        if char_in is None:
            if self._pos >= len(self._codes) - self._k:
                return False
            return self.peek(self._codes[self._pos + self._k])
        if not self._initialized:
            return self._init()
        code_in = int(_as_codes(char_in)[0]) if isinstance(char_in, str) else int(char_in)
        self._refresh()
        self._ensure_taps()
        k = self._k
        w = self._codes[self._pos : self._pos + k]
        fwds, revs = [], []
        for si, taps in enumerate(self._taps):
            f = srol1(int(self._fwd[si]))
            r = sror1(int(self._rev[si]))
            for blk in taps:
                s, e = k - blk.off_out, k - blk.off_in
                c_enter = code_in if e == k else int(w[e])
                c_leave = int(w[s])
                f ^= blk.fwd_in[c_enter] ^ blk.fwd_out[c_leave]
                r ^= blk.rev_in[c_enter] ^ blk.rev_out[c_leave]
            fwds.append(f)
            revs.append(r)
        self._hash_arr = self._peeked(fwds, revs)
        return True

    def peek_back(self, char_in: str | None = None) -> bool:
        """Reference seed.cpp:625-667 — O(#care-runs) back-roll from the
        carried state, like :meth:`peek`."""
        if char_in is None:
            if self._pos == 0:
                return False
            return self.peek_back(self._codes[self._pos - 1])
        if not self._initialized:
            return self._init()
        code_in = int(_as_codes(char_in)[0]) if isinstance(char_in, str) else int(char_in)
        self._refresh()
        self._ensure_taps()
        k = self._k
        w = self._codes[self._pos : self._pos + k]
        fwds, revs = [], []
        for si, taps in enumerate(self._taps):
            f = int(self._fwd[si])
            r = int(self._rev[si])
            for blk in taps:
                s, e = k - blk.off_out, k - blk.off_in
                c_enter = int(w[e - 1])
                c_leave = code_in if s == 0 else int(w[s - 1])
                f ^= blk.fwd_in[c_enter] ^ blk.fwd_out[c_leave]
                r ^= blk.rev_in[c_enter] ^ blk.rev_out[c_leave]
            fwds.append(sror1(f))
            revs.append(srol1(r))
        self._hash_arr = self._peeked(fwds, revs)
        return True

    def hashes(self) -> np.ndarray:
        self._refresh()
        return self._hash_arr

    def get_pos(self) -> int:
        return self._pos

    def get_hash_num(self) -> int:
        return self._num_hashes_per_seed * len(self._seeds)

    def get_hash_num_per_seed(self) -> int:
        return self._num_hashes_per_seed

    def get_k(self) -> int:
        return self._k

    def get_forward_hash(self) -> np.ndarray:
        self._refresh()
        return self._fwd

    def get_reverse_hash(self) -> np.ndarray:
        self._refresh()
        return self._rev

    def copy(self) -> "SeedNtHash":
        self._refresh()
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._fwd = self._fwd.copy()
        new._rev = self._rev.copy()
        new._hash_arr = self._hash_arr.copy()
        return new

    def _walk_positions(self, start: int, tile_last: int, last: int):
        """Positions visited by successive roll() calls from ``start``
        (inclusive) while they stay <= tile_last, following the
        reference's quirk semantics (seed.cpp:518-544 + the init quirk):
        from p the next position is p+1, except when the *incoming* base
        codes[p+k] is N — then the walk jumps to p+k, which init accepts
        unconditionally (strict_n_init=False). With strict_n_init=True
        the jump lands on the next N-free window instead, i.e. exactly
        the valid-window sequence. Returns a Python list."""
        k = self._k
        codes = self._codes
        if self._strict_n_init:
            # identical argument to NtHash: the visited set is all valid
            # windows in order
            valid = oracle.window_valid(codes[start : tile_last + k], k)
            return (np.nonzero(valid)[0] + start).tolist()
        out = []
        cur = start
        npos = np.nonzero(codes[start + k : tile_last + k + 1] == CODE_N)[0]
        npos = (npos + start + k).tolist()  # absolute N positions
        ni = 0
        while cur <= tile_last:
            # first N at/after cur + k bounds the contiguous run
            while ni < len(npos) and npos[ni] < cur + k:
                ni += 1
            qn = npos[ni] if ni < len(npos) else None
            if qn is None:
                out.extend(range(cur, tile_last + 1))
                break
            # positions cur .. qn-k step normally; from qn-k the incoming
            # base is the N at qn -> jump to qn
            seg_end = min(qn - k, tile_last)
            out.extend(range(cur, seg_end + 1))
            if qn > last or qn > tile_last:
                break
            cur = qn
        return out

    def __iter__(self):
        """Bulk-stream every remaining window in roll() order (including
        the reference's N quirk jumps). Same lazy-state design, and the
        same two divergences from a ``while roll()`` loop, as
        :meth:`NtHash.__iter__`: one position store per yield; get_pos is
        exact per step and fwd/rev/hashes refresh lazily on access; rolls
        made mid-iteration are ignored until the next tile, and after
        exhaustion get_pos() is the last window visited."""
        if not self._initialized:
            if not self._init():
                return
            yield self._hash_arr
        k = self._k
        codes = self._codes
        last = len(codes) - k
        self._ensure_table()
        while self._pos < last:
            # one quirk step from the current position locates the next
            # visited window (it may be k away, in a later tile)
            if codes[self._pos + k] == CODE_N:
                nxt = self._pos + k
                if self._strict_n_init:
                    nxt = _next_valid_pos(codes, k, nxt)
                if nxt > last:
                    return
            else:
                nxt = self._pos + 1
            arrs, off = self._table.get(nxt)
            hashes = arrs[2]
            base = nxt - off
            self._cur, self._cur_base = arrs, base
            self._cur_stop = base + len(arrs[0])
            tile_last = min(self._cur_stop - 1, last)
            positions = self._walk_positions(nxt, tile_last, last)
            offs = np.asarray(positions, dtype=np.int64) - base
            self._stale = True
            for p, row in zip(positions, hashes[offs]):
                self._pos = p
                yield row
            if not positions:
                return


class BlindSeedNtHash:
    """Caller-fed spaced-seed hasher (reference nthash.hpp:523-646,
    src/seed.cpp:669-737)."""

    _CLASS = "BlindSeedNtHash"

    def __init__(self, seq, seeds: Sequence[str], num_hashes_per_seed: int,
                 k: int, pos: int = 0):
        _check_seeds(seeds, k, self._CLASS)
        self._seeds = tuple(seeds)
        self._k = int(k)
        self._num_hashes_per_seed = int(num_hashes_per_seed)
        self._pos = int(pos)
        codes = _as_codes(seq)
        self._window = list(int(c) for c in codes[pos : pos + k])
        self._care = [
            oracle.seed_positions_of(b, m)
            for b, m in zip(*oracle.get_blocks(self._seeds))
        ]
        # Two-tap rolling tables, one per maximal care run per seed: rolling
        # is O(#care-runs) per fed base like the reference's O(#blocks)
        # NTMSM64 roll (reference src/seed.cpp:701-718, 177-207), NOT an
        # O(k*S) window rehash. Same math as ops/blind_seed_scan._roll.
        from .ops.seed_kernel import seed_taps

        self._taps = [seed_taps(p) for p in self._seeds]
        s = len(self._seeds)
        self._fwd = np.zeros(s, dtype=np.uint64)
        self._rev = np.zeros(s, dtype=np.uint64)
        self._hash_arr = np.zeros(s * num_hashes_per_seed, np.uint64)
        self._rehash()

    def _rehash(self):
        window = np.array(self._window, dtype=np.uint8)
        m2 = self._num_hashes_per_seed
        for si, positions in enumerate(self._care):
            fh = oracle.seed_forward_hash(window, self._k, positions)
            rh = oracle.seed_reverse_hash(window, self._k, positions)
            self._fwd[si] = fh
            self._rev[si] = rh
            self._hash_arr[si * m2 : (si + 1) * m2] = extend_hashes(
                fh, rh, self._k, m2
            )

    @staticmethod
    def _code(ch) -> int:
        return int(_as_codes(ch)[0]) if isinstance(ch, str) else int(ch)

    def _extend(self) -> None:
        m2 = self._num_hashes_per_seed
        for si in range(len(self._seeds)):
            self._hash_arr[si * m2 : (si + 1) * m2] = extend_hashes(
                int(self._fwd[si]), int(self._rev[si]), self._k, m2
            )

    def roll(self, char_in) -> None:
        """O(#care-runs) two-tap roll (reference NTMSM64 roll,
        src/seed.cpp:701-718): per care run [s, e), XOR in the entering
        edge and XOR out the leaving edge — per-roll work is independent
        of k (see ops/seed_kernel.py for the derivation)."""
        c_in = self._code(char_in)
        k, w = self._k, self._window
        for si, taps in enumerate(self._taps):
            f = srol1(int(self._fwd[si]))
            r = sror1(int(self._rev[si]))
            for blk in taps:
                s, e = k - blk.off_out, k - blk.off_in
                c_enter = c_in if e == k else w[e]
                c_leave = w[s]
                f ^= blk.fwd_in[c_enter] ^ blk.fwd_out[c_leave]
                r ^= blk.rev_in[c_enter] ^ blk.rev_out[c_leave]
            self._fwd[si] = f
            self._rev[si] = r
        w.pop(0)
        w.append(c_in)
        self._pos += 1
        self._extend()

    def roll_back(self, char_in) -> None:
        """Exact algebraic inverse of :meth:`roll` (reference
        src/seed.cpp:720-737), also O(#care-runs) per fed base."""
        c_in = self._code(char_in)
        k, w = self._k, self._window
        for si, taps in enumerate(self._taps):
            f = int(self._fwd[si])
            r = int(self._rev[si])
            for blk in taps:
                s, e = k - blk.off_out, k - blk.off_in
                c_enter = w[e - 1]
                c_leave = c_in if s == 0 else w[s - 1]
                f ^= blk.fwd_in[c_enter] ^ blk.fwd_out[c_leave]
                r ^= blk.rev_in[c_enter] ^ blk.rev_out[c_leave]
            self._fwd[si] = sror1(f)
            self._rev[si] = srol1(r)
        w.pop()
        w.insert(0, c_in)
        self._pos -= 1
        self._extend()

    def hashes(self) -> np.ndarray:
        return self._hash_arr

    def get_pos(self) -> int:
        return self._pos

    def get_hash_num(self) -> int:
        return self._num_hashes_per_seed * len(self._seeds)

    def get_hash_num_per_seed(self) -> int:
        return self._num_hashes_per_seed

    def get_k(self) -> int:
        return self._k

    def get_forward_hash(self) -> np.ndarray:
        return self._fwd

    def get_reverse_hash(self) -> np.ndarray:
        return self._rev

    def copy(self) -> "BlindSeedNtHash":
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new._window = list(self._window)
        new._fwd = self._fwd.copy()
        new._rev = self._rev.copy()
        new._hash_arr = self._hash_arr.copy()
        return new
