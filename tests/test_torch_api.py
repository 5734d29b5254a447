"""The port's facade (``nthash_tpu_torch.api``) against the JAX package's.

The reference's 17 test blocks (reference tests/tests.cpp:43-466, as
``tests/test_api_parity.py`` ports them) run once on the port's classes,
with ``engine`` "oracle" and "kernel" on ``device="cpu"`` (the kernels'
plain versions), and once on the JAX classes with ``engine="oracle"``; each
block records a trace of every call's return value, position and hashes, and
the two traces must be equal, bit for bit. Then the tiled walks, ``__iter__``
in lockstep with ``roll()``, the seed quirk and ``strict_n_init``, ``copy()``,
errors and warnings, and the resident-tile bound, each against the JAX
facade on the same input (made from a seed with numpy).
"""

import warnings

import numpy as np
import pytest

from nthash_tpu import api as japi
from nthash_tpu.ops import seed_pallas
from nthash_tpu_torch import api
from nthash_tpu_torch.ops import seed_kernel

ENGINES = ["oracle", "kernel"]


def _norm(x):
    if isinstance(x, np.ndarray):
        return tuple(int(v) for v in x.reshape(-1))
    if isinstance(x, (np.integer, np.bool_)):
        return int(x)
    return x


class Tracer:
    """One facade module plus the keywords its stored-sequence classes take;
    ``t(x)`` appends x (normalized) to the trace and returns it."""

    def __init__(self, mod, **kw):
        self.mod, self.kw, self.trace = mod, kw, []

    def nt(self, *a, **kw):
        return self.mod.NtHash(*a, **self.kw, **kw)

    def snt(self, *a, **kw):
        return self.mod.SeedNtHash(*a, **self.kw, **kw)

    def t(self, x):
        self.trace.append(_norm(x))
        return x


def _both(block, engine):
    """Run ``block`` on the port (``engine``, CPU) and on the JAX facade
    (oracle); the traces must be equal and non-empty."""
    port = Tracer(api, engine=engine, device="cpu")
    ref = Tracer(japi, engine="oracle")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        block(port)
        block(ref)
    assert port.trace == ref.trace
    assert port.trace


# -- the reference's 17 blocks ---------------------------------------------

def _kmer_hash_values(x):
    seq, k, h = "ACATGCATGCA", 5, 3
    nth = x.nt(seq, h, k)
    x.t(nth.roll())
    blind = x.mod.BlindNtHash(seq, h, k)
    for _ in range(2):
        x.t(nth.roll())
        x.t(nth.hashes())
        blind.roll(seq[blind.get_pos() + k])
        x.t(blind.hashes())
    assert x.trace[2] == (0x38CC00F940AEBDAE, 0xAB7E1B110E086FC6,
                          0x011A1818BCFDD553)


def _kmer_rolling(x):
    nth = x.nt("AGTCAGTC", 3, 4)
    while x.t(nth.roll()):
        x.t(nth.hashes())
    assert x.trace[-2] == x.trace[1]


def _rolling_vs_base(x):
    seq = "ACGTACACTGGACTGAGTCT"
    k = len(seq) - 2
    nth = x.nt(seq, 3, k)
    subs = [x.nt(seq[i:i + k], nth.get_hash_num(), k) for i in range(3)]
    i = 0
    while nth.roll() and subs[i].roll():
        assert np.array_equal(x.t(nth.hashes()), subs[i].hashes())
        i += 1
    assert i == 3


def _canonical_hashing(x):
    f = x.nt("ACGTACACTGGACTGAGTCT", 3, 20)
    r = x.nt("AGACTCAGTCCAGTGTACGT", 3, 20)
    assert x.t(f.roll()) and x.t(r.roll())
    assert np.array_equal(x.t(f.hashes()), x.t(r.hashes()))


def _kmer_back_rolling(x):
    nth = x.nt("ACTAGCTG", 3, 5)
    stack = []
    while x.t(nth.roll()):
        stack.append(nth.hashes().copy())
    while True:
        assert np.array_equal(x.t(nth.hashes()), stack.pop())
        if not x.t(nth.roll_back()):
            break
    assert not stack


def _kmer_peeking(x):
    seq, k = "ACTGATCAG", 6
    nth = x.nt(seq, 3, k)
    x.t(nth.roll())
    for _ in range(3):
        x.t(nth.peek())
        h_peek = x.t(nth.hashes().copy())
        x.t(nth.peek(seq[nth.get_pos() + k]))
        assert np.array_equal(nth.hashes(), h_peek)
        x.t(nth.roll())
        assert np.array_equal(x.t(nth.hashes()), h_peek)


def _skipping_ns(x):
    seq = list("ACGTACACTGGACTGAGTCT")
    half = len(seq) // 2
    seq[half] = seq[half + 1] = "N"
    seq = "".join(seq)
    k = (len(seq) - 2) // 2 - 1
    nth = x.nt(seq, 3, k)
    while x.t(nth.roll()):
        x.t(nth.get_pos())
    assert [p for p in x.trace if not isinstance(p, bool)] == \
        list(range(half - k + 1)) + list(range(half + 2, len(seq) - k + 1))


def _rna(x):
    dna = x.nt("ACGTACACTGGACTGAGTCTACGG", 3, 20)
    rna = x.nt("ACGUACACUGGACUGAGUCUACGG", 3, 20)
    can_roll = True
    while can_roll:
        can_roll = x.t(dna.roll()) & x.t(rna.roll())
        assert np.array_equal(x.t(dna.hashes()), rna.hashes())


def _spaced_seed_hash_values(x):
    nth = x.snt("ACATGCATGCA", ["11100111"], 3, 8)
    for _ in range(3):
        x.t(nth.roll())
        x.t(nth.hashes())
    assert x.trace[1] == (0x010BE4904AD8DE5D, 0x3E29E4F4C991628C,
                          0x3F35C984B13FEB20)


def _spaced_seeds(x):
    seq = "ACGTACACTGGACTGAGTCT"
    seeds = ["111110000000011111", "111111100001111111"]
    mutants = ["ACGTACACTTGACTGAGTCT", "ACGTACACTGTACTGAGTCT",
               "ACGTACACTGCACTGAGTCT"]
    k = len(seq) - 2
    nth = x.snt(seq, seeds, 2, k)
    nth_m = [x.snt(m, seeds, 2, k) for m in mutants]
    history, steps = [], 0
    while x.t(nth.roll()):
        for m in nth_m:
            assert m.roll()
        base = x.snt(seq[steps:steps + k], seeds, 2, k)
        assert base.roll()
        for m in nth_m:
            assert np.array_equal(m.hashes(), nth.hashes())
        assert np.array_equal(base.hashes(), x.t(nth.hashes()))
        history.append(nth.hashes().copy())
        if nth.get_pos() > 0:
            x.t(nth.peek_back())
            assert np.array_equal(x.t(nth.hashes()), history[-2])
            x.t(nth.peek_back(seq[nth.get_pos() - 1]))
            assert np.array_equal(nth.hashes(), history[-2])
            nth._load(nth.get_pos())  # restore hash_arr like C++ state
        steps += 1
    for m in nth_m:
        assert not m.roll()
    assert steps == len(seq) - k + 1


def _spaced_seed_back_roll(x):
    seq, seed = "ACTAGCTG", "110011"
    nth = x.snt(seq, [seed], 3, len(seed))
    stack = []
    while x.t(nth.roll()):
        stack.append(nth.hashes().copy())
    while True:
        assert np.array_equal(x.t(nth.hashes()), stack.pop())
        if not x.t(nth.roll_back()):
            break


def _canonical_spaced_seeds(x):
    seq_fwd = "CACTCGGCCACACACACACACACACACCCTCACACACACAAAACGCACAC"
    seq_rev = "GTGTGCGTTTTGTGTGTGTGAGGGTGTGTGTGTGTGTGTGTGGCCGAGTG"
    seeds = [
        "11011000001100101101011000011010110100110000011011",
        "01010000101001110100111011011100101110010100001010",
        "11100000100111010111000100100011101011100100000111",
        "01111000011000111101000011000010111100011000011110",
        "00111000011000111101000011000010111100011000011100",
        "00000000000000000000000011000000000000000000000000",
        "11111111111111111111111100111111111111111111111111",
        "11111111111111111111111111111111111111111111111111",
    ]
    h1 = x.snt(seq_fwd, seeds, 4, len(seeds[0]))
    h2 = x.snt(seq_rev, seeds, 4, len(seeds[0]))
    can_roll = True
    while can_roll:
        can_roll = x.t(h1.roll()) & x.t(h2.roll())
        assert np.array_equal(x.t(h1.hashes()), h2.hashes())


def _copying_seed_nthash(x):
    seq = "AACGTGACTACTGACTAGCTAGCTAGCTGATCGT"
    seeds = ["111111111101111111111", "110111010010010111011"]
    h1 = x.snt(seq, seeds, 4, len(seeds[0]))
    h2 = h1.copy()
    can_roll = True
    while can_roll:
        can_roll = x.t(h1.roll()) & x.t(h2.roll())
        assert np.array_equal(x.t(h1.hashes()), h2.hashes())


def _blind_seed_nthash(x):
    seq, seeds = "ATGCTAGTAGCTGAC", ["110011", "101101"]
    h1 = x.snt(seq, seeds, 3, len(seeds[0]))
    x.t(h1.roll())
    h2 = x.mod.BlindSeedNtHash(seq, seeds, 3, len(seeds[0]))
    while x.t(h1.roll()):
        h2.roll(seq[h2.get_pos() + len(seeds[0])])
        assert np.array_equal(x.t(h1.hashes()), h2.hashes())


def _blind_seed_nthash_roll_back(x):
    seeds = ["110011", "101101"]
    h = x.mod.BlindSeedNtHash("ACCAGT", seeds, 3, len(seeds[0]))
    first = x.t(h.hashes().copy())
    h.roll("A")
    x.t(h.hashes())
    h.roll_back("A")
    assert np.array_equal(x.t(h.hashes()), first)
    x.t(h.get_forward_hash())
    x.t(h.get_reverse_hash())


def _blind_seed_nthash_copy(x):
    seeds = ["110011", "101101"]
    h1 = x.mod.BlindSeedNtHash("ATGCTAGTAGCTGAC", seeds, 1, len(seeds[0]))
    h1.roll("A")
    h1.roll("C")
    h2 = h1.copy()
    assert np.array_equal(x.t(h1.hashes()), h2.hashes())
    for ch in "GT":
        h1.roll(ch)
        h2.roll(ch)
        assert np.array_equal(x.t(h1.hashes()), h2.hashes())
        x.t(h2.get_pos())


def _kmer_vs_full_care_seed(x):
    seq, k, h = "ATGCTAGTAGCTGAC", 5, 3
    kmer = x.nt(seq, h, k)
    seed = x.snt(seq, ["11111"], h, k)
    can_roll = True
    while can_roll:
        can_roll = x.t(kmer.roll()) | x.t(seed.roll())
        assert np.array_equal(x.t(kmer.hashes()), seed.hashes())


BLOCKS = [_kmer_hash_values, _kmer_rolling, _rolling_vs_base,
          _canonical_hashing, _kmer_back_rolling, _kmer_peeking, _skipping_ns,
          _rna, _spaced_seed_hash_values, _spaced_seeds, _spaced_seed_back_roll,
          _canonical_spaced_seeds, _copying_seed_nthash, _blind_seed_nthash,
          _blind_seed_nthash_roll_back, _blind_seed_nthash_copy,
          _kmer_vs_full_care_seed]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("block", BLOCKS, ids=lambda b: b.__name__[1:])
def test_reference_block(block, engine):
    _both(block, engine)


def test_all_17_blocks():
    assert len(BLOCKS) == 17


# -- tiles, iteration, quirks ------------------------------------------------

def _random_seq(rng, n, n_rate):
    bases = np.array(list("ACGTN"))
    return "".join(bases[rng.choice(
        5, size=n, p=[(1 - n_rate) / 4] * 4 + [n_rate])])


def _walk(h, ops):
    """Apply ``ops`` (method names) to h; trace every result and state."""
    out = []
    for op in ops:
        r = getattr(h, op)()
        out.append((op, r, h.get_pos(), _norm(h.hashes()),
                    _norm(h.get_forward_hash()), _norm(h.get_reverse_hash())))
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_tiles_of_64_across_boundaries(rng, engine):
    """Rolls, roll_back and peeks over tiles of 64 windows, with N islands
    at and across tile edges (the N-skip crossing one), in lockstep with
    the JAX facade; at most two tiles resident."""
    seq = list(_random_seq(rng, 700, 0.0))
    for i in (63, 64, 130, 131, 132, 255, 256, 400):
        seq[i] = "N"
    seq = "".join(seq)
    k, tile = 7, 64
    a = api.NtHash(seq, 3, k, engine=engine, device="cpu", tile_windows=tile)
    b = japi.NtHash(seq, 3, k, engine="oracle", tile_windows=tile)
    ops = ["roll"] * 300 + ["peek", "peek_back"] + ["roll_back"] * 80 + \
        ["roll"] * 700
    got, want = _walk(a, ops), _walk(b, ops)
    assert got == want
    assert a._table.resident_windows() <= 2 * tile
    # the oracle over the whole sequence agrees at every visited window
    from nthash_tpu_torch import oracle
    _, _, hashes, valid = oracle.hash_all_windows(seq, k, 3)
    for op, r, p, h, _, _ in got:
        if r and op in ("roll", "roll_back"):
            assert valid[p] and h == _norm(hashes[p])


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_seed_tiles_quirk_and_strict(rng, engine, strict):
    """SeedNtHash over tiles of 64 windows with N: the quirk windows (an N
    inside the window, hashed as the zero seed) or, strict, the N-free
    ones; every entry of every visited window equals the JAX facade's."""
    seq = list(_random_seq(rng, 600, 0.03))
    seq[0] = seq[64] = seq[65] = "N"
    seq = "".join(seq)
    seeds = ("1101011", "1110111")
    kw = dict(strict_n_init=strict, tile_windows=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = api.SeedNtHash(seq, seeds, 2, 7, engine=engine, device="cpu", **kw)
        b = japi.SeedNtHash(seq, seeds, 2, 7, engine="oracle", **kw)
    ops = ["roll"] * 200 + ["peek", "peek_back", "roll_back"] * 5 + \
        ["roll"] * 600
    got, want = _walk(a, ops), _walk(b, ops)
    assert got == want
    assert a._table.resident_windows() <= 2 * 64
    if not strict:  # the quirk: the first window holds an N
        assert got[0][2] == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_iter_matches_roll_lockstep(rng, engine):
    """__iter__ against roll() in lockstep (positions, hashes, fwd/rev),
    against the JAX __iter__, and the state after an early break and after
    exhaustion, for both classes, both seed modes."""
    seq = _random_seq(rng, 900, 0.02)
    mk = [
        lambda m, **kw: m.NtHash(seq, 2, 9, tile_windows=64, **kw),
        lambda m, **kw: m.SeedNtHash(seq, ("110111011",), 2, 9,
                                     tile_windows=64, **kw),
        lambda m, **kw: m.SeedNtHash(seq, ("110111011",), 2, 9,
                                     strict_n_init=True, tile_windows=64,
                                     **kw),
    ]
    for make in mk:
        port = lambda: make(api, engine=engine, device="cpu")  # noqa: E731
        ref = []
        a = port()
        while a.roll():
            ref.append((a.get_pos(), _norm(a.hashes()),
                        _norm(a.get_forward_hash())))
        b = port()
        got = [(b.get_pos(), _norm(r), _norm(b.get_forward_hash()))
               for r in b]
        assert got == ref
        j = make(japi, engine="oracle")
        assert [(j.get_pos(), _norm(r)) for r in j] == \
            [(p, h) for p, h, _ in ref]
        assert b.get_pos() == j.get_pos() == ref[-1][0]
        for stop_at in (1, 64, 65, 300):
            c = port()
            for n, _ in enumerate(c, 1):
                if n == stop_at:
                    break
            assert c.get_pos() == ref[stop_at - 1][0]
            assert _norm(c.hashes()) == ref[stop_at - 1][1]
            assert c.roll() and c.get_pos() == ref[stop_at][0]


@pytest.mark.parametrize("engine", ENGINES)
def test_copy_and_read_only_hashes(engine):
    seq = "ACGTACGTTGCANNACGTAGCTAGCATCGATCAGT"
    for make in (lambda m, **kw: m.NtHash(seq, 3, 5, **kw),
                 lambda m, **kw: m.SeedNtHash(seq, ("11011",), 2, 5, **kw)):
        a = make(api, engine=engine, device="cpu")
        b = make(japi, engine="oracle")
        for _ in range(4):
            assert a.roll() == b.roll()
        ca, cb = a.copy(), b.copy()
        for _ in range(30):
            assert ca.roll() == cb.roll() and a.roll() == b.roll()
            assert _norm(ca.hashes()) == _norm(cb.hashes()) == \
                _norm(a.hashes())
        assert not a.hashes().flags.writeable
    bl = api.BlindNtHash("ACCAGTGCATA", 2, 6)
    bc = bl.copy()
    bl.roll("G")
    assert _norm(bc.hashes()) == (0xCAD4A7762B580A62, 0x074FEA558D43E636)
    assert _norm(bl.hashes()) == (0xF0A68649810CDA6C, 0x3AF339FADE1F0C8C)


def _raised(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("args,kw", [
    (("ACGT", 1, 0), {}), (("ACGT", 1, 5), {}),
    (("ACGTACGT", 1, 4), {"pos": 5}),
])
def test_errors_as_jax(args, kw):
    assert _raised(lambda: api.NtHash(*args, **kw)) == \
        _raised(lambda: japi.NtHash(*args, **kw))
    with pytest.raises(ValueError, match="k must be greater than 0"):
        api.BlindNtHash("ACGT", 1, 0)


def test_seed_errors_and_warnings_as_jax():
    assert _raised(lambda: api.SeedNtHash("ACGTACGT", ["111"], 1, 4)) == \
        _raised(lambda: japi.SeedNtHash("ACGTACGT", ["111"], 1, 4))
    assert _raised(lambda: api.BlindSeedNtHash("ACGTACGT", ["111"], 1, 4)) \
        == _raised(lambda: japi.BlindSeedNtHash("ACGTACGT", ["111"], 1, 4))
    msgs = []
    for mod in (api, japi):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mod.SeedNtHash("ACGTACGT", ["1101"], 1, 4)
            mod.BlindSeedNtHash("ACGTACGT", ["1101"], 1, 4)
        msgs.append([(w.category, str(w.message)) for w in caught])
    assert msgs[0] == msgs[1] and len(msgs[0]) == 2
    with pytest.raises(ValueError, match="unknown engine"):
        api.NtHash("ACGTACGT", 1, 4, engine="jnp")


def test_parse_seeds_and_parsed_ctor():
    assert api.parse_seeds(["110011", "101101"]) == \
        japi.parse_seeds(["110011", "101101"]) == [[2, 3], [1, 4]]
    seq = "ACGTACACTGGACTGAGTCT"
    a = api.SeedNtHash(seq, [[2, 3], [1, 4]], 2, 6, device="cpu")
    b = japi.SeedNtHash(seq, [[2, 3], [1, 4]], 2, 6)
    while a.roll():
        assert b.roll() and _norm(a.hashes()) == _norm(b.hashes())
    assert not b.roll()


def test_seed_taps_are_the_jax_ones():
    """The Blind and peek machinery's two-tap tables equal seed_pallas's."""
    for seed in ("110011", "101101", "11010011", "1", "1" * 33,
                 "111110000000011111"):
        assert [tuple(t) for t in seed_kernel.seed_taps(seed)] == \
            [tuple(t) for t in seed_pallas.seed_taps(seed)]


def test_blind_walks_vs_jax(rng):
    """BlindNtHash and BlindSeedNtHash over random roll / roll_back / peek /
    peek_back walks, every state equal to the JAX classes'."""
    for k in (1, 5, 33):
        w0 = rng.integers(0, 4, size=k, dtype=np.uint8)
        a, b = api.BlindNtHash(w0, 3, k), japi.BlindNtHash(w0, 3, k)
        for _ in range(150):
            op = ("roll", "roll_back", "peek", "peek_back")[rng.integers(4)]
            c = int(rng.integers(0, 4))
            getattr(a, op)(c)
            getattr(b, op)(c)
            assert (_norm(a.hashes()), a.get_pos(), a.get_forward_hash(),
                    a.get_reverse_hash(), a.get_k()) == \
                (_norm(b.hashes()), b.get_pos(), b.get_forward_hash(),
                 b.get_reverse_hash(), b.get_k())
    seeds = ("1101011", "1111111")
    w0 = rng.integers(0, 4, size=7, dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = api.BlindSeedNtHash(w0, seeds, 2, 7)
        b = japi.BlindSeedNtHash(w0, seeds, 2, 7)
    for _ in range(150):
        op = ("roll", "roll_back")[rng.integers(2)]
        c = "ACGT"[rng.integers(4)]
        getattr(a, op)(c)
        getattr(b, op)(c)
        assert (_norm(a.hashes()), a.get_pos(), _norm(a.get_forward_hash()),
                _norm(a.get_reverse_hash())) == \
            (_norm(b.hashes()), b.get_pos(), _norm(b.get_forward_hash()),
             _norm(b.get_reverse_hash()))


def test_auto_engine_threshold(monkeypatch):
    """"auto" takes the oracle below the device's threshold and the kernel
    engine from it; "oracle" never hashes through a kernel; a CUDA device
    with no GPU raises at the first kernel tile instead of falling back."""
    calls = []
    real = api._kernel_tile

    def spy(*a):
        calls.append(a[-1])
        return real(*a)

    monkeypatch.setattr(api, "_kernel_tile", spy)
    n = api.AUTO_DEVICE_THRESHOLD_CPU
    short, long_ = "ACGT" * ((n - 1) // 4), "ACGT" * (n // 4 + 1)
    assert api.NtHash(short, 1, 5, device="cpu").roll() and not calls
    assert api.NtHash(long_, 1, 5, device="cpu").roll() and len(calls) == 1
    assert api.NtHash(long_, 1, 5, device="cpu", engine="oracle").roll()
    assert len(calls) == 1
    import torch
    if not torch.cuda.is_available():
        h = api.NtHash(long_, 1, 5, engine="kernel", device="cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            h.roll()


@pytest.mark.parametrize("engine", ["kernel", "auto"])
@pytest.mark.parametrize("seeds", [("0000",), ("0000", "1001"),
                                   ("1001", "0000")])
def test_seeds_without_care_positions_vs_jax(rng, monkeypatch, engine, seeds):
    """A seed with no care position: the port's kernel engine (and "auto"
    past its threshold) against the JAX facade's jnp and oracle engines,
    by roll() and by __iter__, over tiles of 64 windows with N; such a seed
    hashes to 0 (fwd, rev and every extension)."""
    monkeypatch.setattr(api, "AUTO_DEVICE_THRESHOLD_CPU", 16)
    assert api.SeedNtHash("ACGTACGTAC", ["0000"], 2, 4, engine=engine,
                          device="cpu").roll()
    seq = _random_seq(rng, 300, 0.03)

    def walk(h):
        out = []
        while h.roll():
            out.append((h.get_pos(), _norm(h.hashes()),
                        _norm(h.get_forward_hash()),
                        _norm(h.get_reverse_hash())))
        return out

    def port():
        return api.SeedNtHash(seq, seeds, 2, 4, engine=engine, device="cpu",
                              tile_windows=64)

    got = walk(port())
    assert got and [(p, h) for p, h, _, _ in got] == \
        [(p, _norm(r)) for p, r in ((h.get_pos(), r)
                                    for h in [port()] for r in h)]
    for jeng in ("jnp", "oracle"):
        want = walk(japi.SeedNtHash(seq, seeds, 2, 4, engine=jeng,
                                    tile_windows=64))
        assert got == want
    zero = [i for i, s in enumerate(seeds) if "1" not in s]
    for _, h, f, r in got:
        for i in zero:
            assert h[2 * i:2 * i + 2] == (0, 0) and f[i] == r[i] == 0
