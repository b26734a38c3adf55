"""Container frame round-trip tests (format: FORMAT.md)."""

import numpy as np
import pytest

from entropy_coders_tpu import frame as F

from conftest import gen_sequence


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("size", [1 << 15, (1 << 15) + 777, 100, 1])
def test_roundtrip(shared, size):
    data = gen_sequence(0.2, size)
    comp = F.compress(data, block_size=1 << 12, k=32, shared_table=shared)
    out = F.decompress(comp)
    np.testing.assert_array_equal(np.frombuffer(out, np.uint8), data)


def test_roundtrip_empty():
    assert F.decompress(F.compress(b"")) == b""


def test_compresses(rng):
    data = gen_sequence(0.2, 1 << 16)
    comp = F.compress(data, block_size=1 << 13, k=64)
    assert len(comp) < len(data)
    out = F.decompress(comp)
    np.testing.assert_array_equal(np.frombuffer(out, np.uint8), data)


def test_rle_blocks():
    data = np.zeros(1 << 14, np.uint8)  # reference panics on this input
    comp = F.compress(data, block_size=1 << 12, k=32)
    assert len(comp) < 200
    out = F.decompress(comp)
    np.testing.assert_array_equal(np.frombuffer(out, np.uint8), data)


def test_raw_blocks(rng):
    data = rng.integers(0, 256, 1 << 13, dtype=np.uint8)  # incompressible-ish
    comp = F.compress(data, block_size=1 << 12, k=32)
    out = F.decompress(comp)
    np.testing.assert_array_equal(np.frombuffer(out, np.uint8), data)


def test_mixed_entropy_blocks(rng):
    parts = [
        gen_sequence(0.1, 1 << 12),
        rng.integers(0, 256, 1 << 12, dtype=np.uint8),
        np.full(1 << 12, 42, np.uint8),
        gen_sequence(0.9, 3000),
    ]
    data = np.concatenate(parts)
    for shared in (False, True):
        comp = F.compress(data, block_size=1 << 12, k=16, shared_table=shared)
        out = F.decompress(comp)
        np.testing.assert_array_equal(np.frombuffer(out, np.uint8), data)


def test_corrupt_frame_rejected():
    data = gen_sequence(0.2, 1 << 13)
    comp = bytearray(F.compress(data, block_size=1 << 12, k=32))
    comp[len(comp) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        # either framing/length mismatch or header parse error
        F.decompress(bytes(comp))


def test_bad_magic():
    with pytest.raises(ValueError):
        F.decompress(b"NOPE" + b"\x00" * 30)


def test_k_exceeding_block_size_rejected():
    data = gen_sequence(0.2, 700)
    with pytest.raises(ValueError, match="block_size"):
        F.compress(data, block_size=256, k=512)
    with pytest.raises(ValueError, match="block_size"):
        F.compress(data, block_size=256, k=0)


def test_k_equals_block_size():
    # degenerate but legal: every byte of a full block is a stream's
    # init symbol (m = 0 emission rounds)
    data = gen_sequence(0.3, 3 * 64 + 17)
    comp = F.compress(data, block_size=64, k=64)
    assert F.decompress(comp) == data.tobytes()


def test_shared_table_is_smaller_for_many_blocks():
    data = gen_sequence(0.2, 1 << 16)
    per_block = F.compress(data, block_size=1 << 12, k=32, shared_table=False)
    shared = F.compress(data, block_size=1 << 12, k=32, shared_table=True)
    assert len(shared) < len(per_block)


def test_random_access_and_checksum(rng):
    """Range decode (every block independently decodable) + per-block
    crc32 verification — container features beyond the reference."""
    from tests.conftest import gen_sequence
    import entropy_coders_tpu.frame as F

    data = gen_sequence(0.3, 5 * 4096 + 321, seed=42)
    comp = F.compress(data, block_size=4096, k=64, lanes=False,
                      checksum=True)
    full = F.decompress(comp)
    assert full == data.tobytes()
    for (s, ln) in [(0, 100), (4000, 200), (4096, 4096), (9000, 8000),
                    (len(data) - 10, 10), (0, len(data))]:
        assert F.decompress(comp, start=s, length=ln) == data[s:s + ln].tobytes()
    # corrupt one payload byte inside block 2 -> crc catches it
    pf = F._parse_frame(comp)
    target = pf.section(2)
    pos = comp.rfind(target)
    bad = bytearray(comp)
    bad[pos + len(target) // 2] ^= 0x40
    import pytest as _pytest
    with _pytest.raises(ValueError):
        F.decompress(bytes(bad))
    # but a range that avoids block 2 still decodes
    assert F.decompress(bytes(bad), start=0, length=4096) == data[:4096].tobytes()


def test_range_outside_frame_raises(rng):
    from tests.conftest import gen_sequence
    import entropy_coders_tpu.frame as F
    import pytest as _pytest

    data = gen_sequence(0.3, 4096, seed=1)
    comp = F.compress(data, block_size=4096, k=64, lanes=False)
    with _pytest.raises(ValueError):
        F.decompress(comp, start=5000, length=10)
    with _pytest.raises(ValueError):
        F.decompress(comp, start=0, length=99999)


def test_auto_table_log_mixed_corpus(rng):
    """table_log="auto" (the reference's per-block optimal_log2 policy,
    src/histogram.rs:264-277) round-trips heterogeneous logs in one frame
    and beats a FIXED log-10 ratio on mixed-entropy data. (Compared
    against an explicit 10, not the library default: the default is the
    ("fast", 0.0025) policy, which is allowed to beat auto — smaller logs
    shrink headers at small block sizes.)"""
    parts = [
        rng.integers(0, 4, 1 << 12).astype(np.uint8),
        rng.integers(0, 256, 1 << 12, dtype=np.uint8),
        np.repeat(rng.integers(0, 256, 64).astype(np.uint8), 64),
        gen_sequence(0.5, 1 << 12),
        gen_sequence(0.05, 123),  # ragged tail
    ]
    data = np.concatenate(parts)
    for lanes in (False, True):
        auto = F.compress(data, block_size=1 << 12, k=16, lanes=lanes,
                          table_log="auto", interpret=True)
        fixed = F.compress(data, block_size=1 << 12, k=16, lanes=lanes,
                           table_log=10, interpret=True)
        default = F.compress(data, block_size=1 << 12, k=16, lanes=lanes,
                             interpret=True)
        out = F.decompress(auto, interpret=True)
        np.testing.assert_array_equal(np.frombuffer(out, np.uint8), data)
        assert len(auto) <= len(fixed)
        # the default policy's budget bounds its size vs auto: within
        # 0.25% estimated, so comfortably within 1% actual here
        out = F.decompress(default, interpret=True)
        np.testing.assert_array_equal(np.frombuffer(out, np.uint8), data)
        assert len(default) <= len(auto) * 1.01


def test_default_policy_is_fast_p25(rng):
    """The lanes-path default table_log is the ("fast", 0.0025) policy —
    pinned so a future default change is deliberate, not drift."""
    assert F.PL_TABLE_LOG == ("fast", 0.0025)
    data = np.concatenate([
        gen_sequence(0.3, 1 << 14),
        rng.integers(0, 64, 1 << 14).astype(np.uint8),
    ])
    default = F.compress(data, block_size=1 << 13, k=64, lanes=True,
                         interpret=True)
    explicit = F.compress(data, block_size=1 << 13, k=64, lanes=True,
                          table_log=("fast", 0.0025), interpret=True)
    assert default == explicit
    assert F.decompress(default, interpret=True) == data.tobytes()


def test_auto_table_log_matches_spec_choice(rng):
    """Every FSE block in an auto frame carries exactly the log the
    reference's Histogram::optimal_log2 would pick for that block."""
    from entropy_coders_tpu.spec.histogram import Histogram, NormHistogram
    data = np.concatenate([
        rng.integers(0, 7, 1 << 12).astype(np.uint8),
        gen_sequence(0.3, 1 << 12),
    ])
    comp = F.compress(data, block_size=1 << 12, k=16, lanes=False,
                      table_log="auto")
    pf = F._parse_frame(comp)
    for i in range(pf.n_blocks):
        if int(pf.modes[i]) != F.MODE_FSE:
            continue
        hist, _ = NormHistogram.read(pf.section(i))
        block = data[i << 12 : (i + 1) << 12]
        assert hist.log2 == Histogram(block).optimal_log2()


def test_packed_size_table_degenerate_falls_back_raw():
    """All-equal lane sizes make the size-table bytes single-symbol per
    stream; the FSE compressor now rejects that (degenerate table), and
    _pack_size_table must fall back to the raw (cs_len == 0) form.
    Previously the compressed degenerate table was stored and could not
    be decoded back (latent FLAG_PACKED corruption, found via
    tests/fuzz_diff.py's single-symbol discovery)."""
    from entropy_coders_tpu.frame import _pack_size_table, _unpack_size_table

    import struct

    k = 128
    st = np.full(k, 257, "<u2").tobytes()  # every byte 0x01: one symbol
    sec = _pack_size_table(st)
    assert struct.unpack_from("<H", sec)[0] == 0  # raw fallback taken
    sizes, rest = _unpack_size_table(sec + b"tail", k)
    assert rest == b"tail"
    assert (sizes == 257).all()


def test_fast_table_log_policy(rng):
    """table_log="fast" picks per-block logs <= the auto (ratio-optimal)
    choice, costs at most ~the policy's eps in ratio, and round-trips.
    On the bench distribution the estimate must actually drop the log
    (L=9 costs about +0.24% vs 10 — well inside the 0.5% budget)."""
    from entropy_coders_tpu.normalize import fast_log2s, optimal_log2s

    data = gen_sequence(0.2, 1 << 16)
    counts = np.stack([np.bincount(b, minlength=256)
                       for b in data.reshape(4, 1 << 14)]).astype(np.uint64)
    fast = fast_log2s(counts, 1 << 14)
    auto = optimal_log2s(counts, 1 << 14)
    # on the bench distribution at 16 KiB blocks the estimate drops
    # 11 -> 9
    assert (fast < auto).all()

    for lanes in (False, True):
        f = F.compress(data, block_size=1 << 14, k=16, lanes=lanes,
                       table_log="fast", interpret=True)
        a = F.compress(data, block_size=1 << 14, k=16, lanes=lanes,
                       table_log="auto", interpret=True)
        assert F.decompress(f, interpret=True) == data.tobytes()
        assert len(f) <= len(a) * 1.01  # eps=0.5% on estimates + slack


def test_fast_table_log_budget_knob(rng):
    """("fast", eps): an explicit size budget widens/narrows the fast
    policy. A wide budget must pick logs <= the default 0.5% budget's
    (reaching the L=8 throughput-max point on the bench distribution),
    eps=0 must collapse to the auto choice, and frames round-trip."""
    from entropy_coders_tpu.normalize import fast_log2s, optimal_log2s

    data = gen_sequence(0.2, 1 << 16)
    counts = np.stack([np.bincount(b, minlength=256)
                       for b in data.reshape(4, 1 << 14)]).astype(np.uint64)
    wide = fast_log2s(counts, 1 << 14, eps=0.02)
    dflt = fast_log2s(counts, 1 << 14)
    auto = optimal_log2s(counts, 1 << 14)
    assert (wide <= dflt).all() and (wide < dflt).any()
    assert (fast_log2s(counts, 1 << 14, eps=0.0) == auto).all()

    f = F.compress(data, block_size=1 << 14, k=16, lanes=True,
                   table_log=("fast", 0.02), interpret=True)
    assert F.decompress(f, interpret=True) == data.tobytes()
    with pytest.raises(ValueError):
        F.compress(data, block_size=1 << 14, k=16,
                   table_log=("slow", 0.02), interpret=True)


def test_tiny_input_shared_table_policy_degrades():
    """< 9 bytes cannot be normalized (optimal_log2 precondition); the
    shared-table + policy-log combination must degrade to RAW/RLE like
    the per-block path instead of raising (found by fuzz_diff wide)."""
    for n in (1, 2, 5, 8):
        data = (np.arange(n) % 5).astype(np.uint8)
        for tl in ("auto", "fast", None):
            comp = F.compress(data, block_size=1 << 12, k=16,
                              shared_table=True, table_log=tl,
                              interpret=True)
            assert F.decompress(comp, interpret=True) == data.tobytes()


def test_decompress_into_out_buffer(rng):
    """out= decodes into a caller buffer: full frame (zero-copy aligned
    path), aligned and unaligned ranges (staging-copy path), and the
    error contract (too small / read-only)."""
    data = gen_sequence(0.2, (1 << 14) + 123)
    comp = F.compress(data, block_size=1 << 12, k=32, checksum=True)

    buf = bytearray(len(data))
    n = F.decompress(comp, out=buf)
    assert n == len(data)
    np.testing.assert_array_equal(np.frombuffer(buf, np.uint8), data)

    # numpy target, aligned sub-range (zero-copy eligible)
    bs = 1 << 12
    arr = np.full(2 * bs, 0xAB, np.uint8)
    n = F.decompress(comp, start=bs, length=2 * bs, out=arr)
    assert n == 2 * bs
    np.testing.assert_array_equal(arr, data[bs: 3 * bs])

    # unaligned range lands via the staging copy; oversized out is fine
    buf2 = bytearray(5000)
    n = F.decompress(comp, start=17, length=4321, out=buf2)
    assert n == 4321
    np.testing.assert_array_equal(np.frombuffer(buf2, np.uint8, count=n),
                                  data[17: 17 + 4321])

    with pytest.raises(ValueError, match="too small"):
        F.decompress(comp, out=bytearray(len(data) - 1))
    with pytest.raises(ValueError, match="read-only"):
        F.decompress(comp, out=bytes(len(data)))

    # empty frame, empty buffer
    assert F.decompress(F.compress(b""), out=bytearray()) == 0
