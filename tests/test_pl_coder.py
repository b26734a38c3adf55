"""Exactness tests for the per-lane-stream coder (ops.pl_coder).

Both drivers of the round step run here on the CPU backend: the Pallas
kernel in interpret mode, and the plain-JAX version (the CPU path). The
compiled kernel runs on the card in tests/test_gpu.py. The oracle is
``spec``: each lane's bit stream must be bit-identical to the reference
encoder run on that lane's strided subsequence (reference semantics:
src/lib.rs:112-143 per lane)."""

import functools

import jax
import numpy as np
import pytest

from entropy_coders_tpu.ops import pl_coder as PL
from entropy_coders_tpu.spec.bitstream import BitStackWriter
from entropy_coders_tpu.spec.fse import DecodeTable, EncodeTable, Encoder
from entropy_coders_tpu.spec.histogram import Histogram, NormHistogram


def oracle_lane_stream(seq, enc: EncodeTable):
    """Reference-format single-stream payload for one lane (no header, no
    marker bit): reversed consume, init folds the last byte, finish appends
    the final state in table_log bits."""
    out = bytearray()
    w = BitStackWriter(out)
    e = Encoder.new_first_symbol(enc, int(seq[-1]))
    for b in seq[-2::-1]:
        e.encode(w, int(b))
    e.finish(w)
    bits = w.finish()
    return bytes(out), bits


def _mk(seed, B, k, Q, gen):
    rng = np.random.default_rng(seed)
    n = k * Q
    datas = [gen(rng, n) for _ in range(B)]
    hists = [NormHistogram.new(d) for d in datas]
    return datas, hists


def _oracle_blocks(datas, hists, k):
    """Spec oracle for equal-log blocks: (L, encode tables (tt_bits,
    tt_fs, next-state) stacked over blocks, packed decode tables, lane
    words (B, W, k), lane bit sizes (B, k))."""
    Ls = [h.log2 for h in hists]
    L = Ls[0]
    assert all(x == L for x in Ls)
    encs, packs, words_list, sizes_list = [], [], [], []
    for data, hist in zip(datas, hists):
        enc, dec = EncodeTable(hist), DecodeTable(hist)
        encs.append((enc.tt_bits, enc.tt_find_state, enc.table))
        packs.append(dec.packed)
        lane_payloads, lane_bits = [], []
        for i in range(k):
            p, bits = oracle_lane_stream(data[i::k], enc)
            lane_payloads.append(p)
            lane_bits.append(bits)
        w, W = PL.lane_split(b"".join(lane_payloads), np.array(lane_bits), k)
        words_list.append(w)
        sizes_list.append(np.array(lane_bits, np.int32))
    W = max(w.shape[0] for w in words_list)
    words = np.zeros((len(datas), W, k), np.uint32)
    for b, w in enumerate(words_list):
        words[b, : w.shape[0]] = w
    tables = tuple(np.stack([np.asarray(e[j]) for e in encs])
                   for j in range(3))
    return L, tables, np.stack(packs), words, np.stack(sizes_list)


def geo(rng, n):
    return (rng.integers(0, 40, n, dtype=np.uint16) ** 2 % 251).astype(np.uint8)


def narrow(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def _check_decode(datas, words, sizes, packs, *, k, L, R, **kw):
    out = PL.decode_lanes(words, sizes, packs, k=k, L=L, R=R, **kw)
    assert out.shape == (len(datas), (R + 1) * k)
    np.testing.assert_array_equal(out, np.stack(datas))


def _check_encode(datas, tables, words, sizes, *, k, L, **kw):
    R = len(datas[0]) // k - 1
    We = PL.encode_w_bound(R, L)
    kw_, ks = PL.encode_lanes(np.stack(datas), tables, k=k, L=L, W=We, **kw)
    np.testing.assert_array_equal(ks, sizes)
    for b in range(len(datas)):
        assert PL.lane_merge(kw_[b], ks[b]) == PL.lane_merge(words[b],
                                                            sizes[b])


@functools.lru_cache(maxsize=None)
def _oracle_at_log(L):
    """Two 128-lane x 2 blocks of 9 rounds at table log L (alphabet sized
    so normalize keeps L), with their spec oracle."""
    k, Q = 256, 9
    rng = np.random.default_rng(500 + L)
    nsym = min(1 << (L - 3), 256)
    datas = [rng.integers(0, nsym, k * Q).astype(np.uint8) for _ in range(2)]
    hists = [Histogram(d).normalize(L) for d in datas]
    assert all(h.log2 == L for h in hists)
    return (datas,) + _oracle_blocks(datas, hists, k)


TABLE_LOGS = range(5, 16)


@pytest.mark.parametrize("L", TABLE_LOGS)
def test_kernel_decode_bit_exact_per_log(L):
    """The Pallas kernel (interpret mode) decodes the spec's lane streams
    at every table log of the reference's 5..15 range."""
    datas, L2, tables, packs, words, sizes = _oracle_at_log(L)
    _check_decode(datas, words, sizes, packs, k=256, L=L, R=8,
                  interpret=True)


@pytest.mark.parametrize("L", TABLE_LOGS)
def test_kernel_encode_bit_exact_per_log(L):
    """The Pallas kernel (interpret mode) writes the spec's lane streams
    bit for bit at every table log 5..15."""
    datas, L2, tables, packs, words, sizes = _oracle_at_log(L)
    _check_encode(datas, tables, words, sizes, k=256, L=L, interpret=True)


@pytest.mark.parametrize("L", TABLE_LOGS)
def test_plain_jax_bit_exact_per_log(L):
    """The plain-JAX version (the CPU path) encodes and decodes the spec's
    lane streams bit for bit at every table log 5..15."""
    datas, L2, tables, packs, words, sizes = _oracle_at_log(L)
    assert PL._impl(False) == "xla"
    _check_decode(datas, words, sizes, packs, k=256, L=L, R=8)
    _check_encode(datas, tables, words, sizes, k=256, L=L)


@pytest.mark.parametrize("backend,kernel,lanes", [
    ("gpu", "kernel", True), ("cpu", "xla", False)])
def test_platform_choice(monkeypatch, backend, kernel, lanes):
    """gpu runs the compiled kernel (the interpreter only when asked) and
    defaults compress to the per-lane mode; cpu runs the plain-JAX
    version and keeps the shared-stream default."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert PL._impl(False) == kernel
    assert PL._impl(True) == "interpret"
    assert PL.lanes_default() is lanes


def test_platform_choice_unknown_backend_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError, match="unsupported backend"):
        PL._impl(False)
    with pytest.raises(ValueError, match="unsupported backend"):
        PL.lanes_default()
    from entropy_coders_tpu import frame as F
    with pytest.raises(ValueError, match="unsupported backend"):
        F.compress(b"ab" * 4096)


def test_kernel_grid_and_padding():
    """The kernel's grid is (blocks, k / LANES) and a mesh pads the block
    batch with copies of block 0 whose results are dropped: 3 blocks of
    384 lanes over a 2-device mesh decode to exactly the 3 inputs."""
    from jax.sharding import Mesh

    datas, hists = _mk(71, 3, 384, 5, geo)
    L, tables, packs, words, sizes = _oracle_blocks(datas, hists, 384)
    mesh = Mesh(np.array(jax.devices()[:2]), ("blocks",))
    _check_decode(datas, words, sizes, packs, k=384, L=L, R=4,
                  interpret=True, mesh=mesh)
    _check_encode(datas, tables, words, sizes, k=384, L=L, interpret=True,
                  mesh=mesh)
    with pytest.raises(ValueError, match="multiple of 128"):
        PL.decode_lanes(words[:, :, :192], sizes[:, :192], packs, k=192,
                        L=L, R=4)


@pytest.mark.parametrize("gen,Q", [(geo, 16), (narrow, 9)])
def test_decode_lanes_bit_exact(gen, Q):
    B, k = 2, 256
    datas, hists = _mk(7, B, k, Q, gen)
    L, tables, packs, words, sizes = _oracle_blocks(datas, hists, k)
    _check_decode(datas, words, sizes, packs, k=k, L=L, R=Q - 1,
                  interpret=True)


@pytest.mark.parametrize("gen,Q", [(geo, 16), (narrow, 9)])
def test_encode_lanes_bit_exact(gen, Q):
    B, k = 2, 256
    datas, hists = _mk(11, B, k, Q, gen)
    L, tables, packs, words, sizes = _oracle_blocks(datas, hists, k)
    _check_encode(datas, tables, words, sizes, k=k, L=L, interpret=True)


@pytest.mark.parametrize("L", [5, 6, 8])
def test_pl_small_table_log_bit_exact(L):
    """Tiny table logs with a 3-symbol alphabet stay bit-exact vs the
    spec oracle in both directions."""
    k, Q = 128, 6
    rng = np.random.default_rng(L)
    data = rng.integers(0, 3, k * Q).astype(np.uint8)  # tiny alphabet
    hist = Histogram(data).normalize(L)
    assert hist.log2 == L
    L2, tables, packs, words, sizes = _oracle_blocks([data], [hist], k)
    _check_decode([data], words, sizes, packs, k=k, L=L, R=Q - 1,
                  interpret=True)
    _check_encode([data], tables, words, sizes, k=k, L=L, interpret=True)


@pytest.mark.parametrize("L", [13, 15])
def test_pl_high_table_log_bit_exact(L):
    """table_log 13-15 on the flagship path with a full 256-symbol
    alphabet (reference supports the full 5..15 range in every code path,
    src/fse.rs:103-106)."""
    k, Q = 128, 5
    rng = np.random.default_rng(L)
    data = rng.integers(0, 256, k * Q, dtype=np.uint8)
    hist = Histogram(data).normalize(L)
    assert hist.log2 == L
    L2, tables, packs, words, sizes = _oracle_blocks([data], [hist], k)
    assert L2 == L
    _check_decode([data], words, sizes, packs, k=k, L=L, R=Q - 1,
                  interpret=True)
    _check_encode([data], tables, words, sizes, k=k, L=L, interpret=True)


def test_norm_entry_points_match_host_tables():
    """encode_lanes_norm / decode_lanes_norm (tables built from the
    normalized histograms) produce byte-identical streams to the
    prebuilt-table entry points / spec oracle."""
    B, k, Q = 2, 256, 9
    datas, hists = _mk(21, B, k, Q, geo)
    L, tables, packs, words, sizes = _oracle_blocks(datas, hists, k)
    R = Q - 1
    blocks = np.stack(datas)
    norm_tables = np.stack([np.asarray(h.table, np.int32) for h in hists])
    We = PL.encode_w_bound(R, L)
    w1, s1 = PL.encode_lanes_norm(blocks, norm_tables, k=k, L=L, W=We,
                                  interpret=True)
    np.testing.assert_array_equal(s1, sizes)
    for b in range(B):
        assert PL.lane_merge(w1[b], s1[b]) == PL.lane_merge(words[b],
                                                            sizes[b])
    out = PL.decode_lanes_norm(words, sizes, norm_tables, k=k, L=L, R=R,
                               interpret=True)
    np.testing.assert_array_equal(out, blocks)


def test_small_alphabet_fast_path_bit_exact():
    """Small-alphabet inputs (every symbol < 128) through both the
    prebuilt-table entry and the norm entry stay bit-identical to the
    spec oracle."""
    B, k, Q = 2, 256, 9
    datas, hists = _mk(33, B, k, Q, narrow)
    L, tables, packs, words, sizes = _oracle_blocks(datas, hists, k)
    _check_encode(datas, tables, words, sizes, k=k, L=L, interpret=True)
    blocks = np.stack(datas)
    norm_tables = np.stack([np.asarray(h.table, np.int32) for h in hists])
    assert (norm_tables[:, 128:] == 0).all()
    We = PL.encode_w_bound(Q - 1, L)
    w1, s1 = PL.encode_lanes_norm(blocks, norm_tables, k=k, L=L, W=We,
                                  interpret=True)
    np.testing.assert_array_equal(s1, sizes)
    for b in range(B):
        assert PL.lane_merge(w1[b], s1[b]) == PL.lane_merge(words[b],
                                                            sizes[b])


@pytest.mark.parametrize("L", [11, 13])
def test_small_alphabet_fast_path_high_logs(L):
    """A small alphabet at the mid and high table logs stays bit-exact vs
    the spec oracle."""
    k, Q = 128, 6
    rng = np.random.default_rng(100 + L)
    data = (rng.integers(0, 10, k * Q, dtype=np.uint16) ** 2 % 97).astype(
        np.uint8)  # alphabet well under 128
    hist = Histogram(data).normalize(L)
    assert hist.log2 == L
    _, tables, packs, words, sizes = _oracle_blocks([data], [hist], k)
    _check_encode([data], tables, words, sizes, k=k, L=L, interpret=True)


def test_norm_entry_table_routes_identical():
    """The two table-build routes of encode_lanes_norm/decode_lanes_norm
    (host C++ build vs the on-device XLA build) must produce
    byte-identical streams and decodes."""
    from entropy_coders_tpu import native

    if not native.available():
        pytest.skip("native codec unavailable")
    B, k, Q = 2, 256, 9
    datas, hists = _mk(55, B, k, Q, geo)
    L, tables, packs, words, sizes = _oracle_blocks(datas, hists, k)
    R = Q - 1
    blocks = np.stack(datas)
    norm_tables = np.stack([np.asarray(h.table, np.int32) for h in hists])
    We = PL.encode_w_bound(R, L)
    wh, sh = PL.encode_lanes_norm(blocks, norm_tables, k=k, L=L, W=We,
                                  interpret=True, host_tables=True)
    wd, sd = PL.encode_lanes_norm(blocks, norm_tables, k=k, L=L, W=We,
                                  interpret=True, host_tables=False)
    np.testing.assert_array_equal(sh, sd)
    np.testing.assert_array_equal(sh, sizes)  # and == oracle
    for b in range(B):
        assert PL.lane_merge(wh[b], sh[b]) == PL.lane_merge(wd[b], sd[b])
    for ht in (True, False):
        out = PL.decode_lanes_norm(words, sizes, norm_tables, k=k, L=L,
                                   R=R, interpret=True, host_tables=ht)
        np.testing.assert_array_equal(out, blocks)


def test_native_encode_lanes_matches_spec():
    """The host C++ per-lane encoder (the reference the device kernels
    are checked against on the card) writes the spec's lane streams."""
    from entropy_coders_tpu import native

    if not native.available():
        pytest.skip("native codec unavailable")
    B, k, Q = 2, 256, 9
    datas, hists = _mk(5, B, k, Q, geo)
    L, tables, packs, words, sizes = _oracle_blocks(datas, hists, k)
    nt = np.stack([np.asarray(h.table, np.int32) for h in hists])
    w, s = native.encode_lanes(np.stack(datas), nt, L, k,
                               PL.encode_w_bound(Q - 1, L))
    np.testing.assert_array_equal(s, sizes)
    for b in range(B):
        assert PL.lane_merge(w[b], s[b]) == PL.lane_merge(words[b],
                                                          sizes[b])


def test_pl_lane_is_reference_stream_native_decodable():
    """Each PL lane's wire bytes are a reference-format single-stream
    payload (module contract). Cross-implementation proof: wrap a lane
    in a reference frame (native header + the lane bytes + the terminal
    marker bit, reference src/lib.rs:112-143) and the independent C++
    serial decoder must reproduce that lane's strided subsequence."""
    from entropy_coders_tpu import native

    if not native.available():
        pytest.skip("native codec unavailable")
    B, k, Q = 1, 256, 9
    datas, hists = _mk(91, B, k, Q, geo)
    L = hists[0].log2
    data = datas[0]
    nt = np.asarray(hists[0].table, np.int32)
    blocks = data[None]
    We = PL.encode_w_bound(Q - 1, L)
    words, sizes = PL.encode_lanes_norm(blocks, nt[None], k=k, L=L, W=We,
                                        interpret=True)
    payload = PL.lane_merge(words[0], sizes[0])
    header = native.write_header(nt, L, int(np.flatnonzero(nt)[-1]) + 1)
    nbytes = (sizes[0] + 7) // 8
    offs = np.concatenate([[0], np.cumsum(nbytes)])
    for i in (0, 1, k // 2, k - 1):
        sz = int(sizes[0, i])
        lane = bytearray(payload[int(offs[i]): int(offs[i + 1])])
        if sz % 8:  # terminal marker bit at position sz
            lane[-1] |= 1 << (sz % 8)
        else:
            lane.append(1)
        out = native.decompress(header + bytes(lane), k=1,
                                max_out=len(data))
        assert out == data[i::k].tobytes()


def test_frame_pl_high_log_roundtrip():
    from entropy_coders_tpu import frame as F
    rng = np.random.default_rng(13)
    data = geo(rng, 2 * 4096)
    comp = F.compress(data, block_size=4096, k=256, lanes=True,
                      table_log=13, interpret=True)
    pf = F._parse_frame(comp)
    assert (pf.modes == F.MODE_FSE_PL).all()
    out = F.decompress(comp, interpret=True)
    assert out == data.tobytes()


@pytest.mark.parametrize("interpret", [True, False])
def test_corrupt_stream_raises(interpret):
    """A lane whose cursor does not drain to exactly 0 raises, through
    the kernel's cursor output and the plain-JAX version's alike."""
    B, k, Q = 1, 256, 16
    datas, hists = _mk(3, B, k, Q, geo)
    L, tables, packs, words, sizes = _oracle_blocks(datas, hists, k)
    words = words.copy()
    words[0, 0, :] ^= 0xFFFF  # clobber low words -> cursors misalign
    with pytest.raises(ValueError, match="not drained"):
        # some lane must fail to drain exactly
        PL.decode_lanes(words, sizes + 3, packs, k=k, L=L, R=Q - 1,
                        interpret=interpret)


def test_divergent_lanes_wide_fallback():
    """Lanes with wildly different compressibility: the lanes of one
    kernel program read and write words hundreds of rows apart, each
    through its own cursor and window — both directions stay exact."""
    k, Q = 128, 480
    rng = np.random.default_rng(99)
    n = k * Q
    data = np.empty(n, np.uint8)
    # even lanes: near-constant (~1 bit/sym); odd lanes: uniform (8 bits)
    per_lane = data.reshape(Q, k)
    per_lane[:, 0::2] = rng.choice(
        np.array([0, 1], np.uint8), (Q, k // 2), p=[0.95, 0.05])
    per_lane[:, 1::2] = rng.integers(0, 256, (Q, k // 2), dtype=np.uint8)
    hist = Histogram(data).normalize(10)
    L, tables, packs, words, sizes = _oracle_blocks([data], [hist], k)
    # sanity: the cursors really spread over > 32 word rows
    assert (sizes.max() - sizes.min()) > 32 * 32 * 3
    _check_decode([data], words, sizes, packs, k=k, L=L, R=Q - 1,
                  interpret=True)
    _check_encode([data], tables, words, sizes, k=k, L=L, interpret=True)


def test_lane_bits_split_merge_roundtrip():
    """Bit-packed repack (FLAG_PACKED wire): native C++ and the Python
    fallback agree and invert each other; packed payload is exactly
    ceil(sum(bits)/8) bytes."""
    from entropy_coders_tpu import native
    rng = np.random.default_rng(2)
    k = 256
    sizes = rng.integers(9, 200, k).astype(np.int64)
    W = int((int(sizes.max()) + 31) // 32) + 2
    words = rng.integers(0, 1 << 32, (W, k), dtype=np.uint64).astype(np.uint32)
    # zero dead bits above each lane's size (kernel invariant)
    lane_mask = np.zeros((W, k), np.uint64)
    for w in range(W):
        rem = np.clip(sizes - w * 32, 0, 32)
        lane_mask[w] = (np.uint64(1) << rem.astype(np.uint64)) - np.uint64(1)
    words &= lane_mask.astype(np.uint32)
    packed = PL.lane_merge_bits(words, sizes)
    assert len(packed) == (int(sizes.sum()) + 7) // 8
    back, Wb = PL.lane_split_bits(packed, sizes, k)
    assert (back[:W] == words).all() and not back[W:].any()
    # pure-Python fallback must agree with whatever produced `packed`
    import unittest.mock as mock
    with mock.patch.object(native, "available", lambda: False):
        assert PL.lane_merge_bits(words, sizes) == packed
        back2, _ = PL.lane_split_bits(packed, sizes, k)
        assert (back2[:W] == words).all()


def test_frame_bit_packed_roundtrip():
    """FLAG_PACKED frames round-trip and are strictly smaller than the
    byte-aligned wire (k dead-bit bytes recovered per block)."""
    from entropy_coders_tpu import frame as F
    rng = np.random.default_rng(17)
    data = geo(rng, 3 * 4096 + 777)
    plain = F.compress(data, block_size=4096, k=256, lanes=True,
                       interpret=True)
    packed = F.compress(data, block_size=4096, k=256, lanes=True,
                        interpret=True, bit_pack=True)
    assert F._parse_frame(packed).packed
    assert F.decompress(packed, interpret=True) == data.tobytes()
    assert len(packed) < len(plain)
    # recovers most of the <= 7 dead bits per lane: ~3.5 avg * k per block
    assert len(plain) - len(packed) > 3 * 256 * 3 // 8


def test_lane_split_merge_roundtrip():
    rng = np.random.default_rng(0)
    k = 256
    sizes = rng.integers(9, 200, k).astype(np.int64)
    payload = rng.integers(0, 255, int(((sizes + 7) // 8).sum()),
                           dtype=np.uint8)
    # zero any dead bits above each lane's size so merge == split input
    words, W = PL.lane_split(payload.tobytes(), sizes, k)
    back = PL.lane_merge(words, sizes)
    assert back == payload.tobytes()


def test_frame_pl_roundtrip():
    from entropy_coders_tpu import frame as F
    rng = np.random.default_rng(5)
    data = geo(rng, 3 * 4096 + 777)  # 3 full blocks + ragged tail
    comp = F.compress(data, block_size=4096, k=256, lanes=True,
                      interpret=True)
    out = F.decompress(comp, interpret=True)
    assert out == data.tobytes()
    # PL mode actually used on the full blocks
    pf = F._parse_frame(comp)
    assert (pf.modes[:3] == F.MODE_FSE_PL).all()


def test_frame_pl_shared_table_roundtrip():
    from entropy_coders_tpu import frame as F
    rng = np.random.default_rng(6)
    data = geo(rng, 2 * 4096)
    comp = F.compress(data, block_size=4096, k=256, lanes=True,
                      shared_table=True, interpret=True)
    out = F.decompress(comp, interpret=True)
    assert out == data.tobytes()


def test_frame_pl_sharded_roundtrip():
    """Flagship PL mode data-parallel over an 8-device mesh (shard_map +
    interpreter-mode Pallas kernels)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from entropy_coders_tpu import frame as F

    mesh = Mesh(np.array(jax.devices()[:8]), ("blocks",))
    sh = NamedSharding(mesh, PartitionSpec("blocks"))
    rng = np.random.default_rng(9)
    data = geo(rng, 10 * 4096)  # 10 blocks over 8 devices (pads to 16)
    comp = F.compress(data, block_size=4096, k=256, lanes=True,
                      interpret=True, sharding=sh)
    pf = F._parse_frame(comp)
    assert (pf.modes == F.MODE_FSE_PL).all()
    out = F.decompress(comp, interpret=True, sharding=sh)
    assert out == data.tobytes()


def test_bits_fallbacks_match_native_fuzz():
    """The numpy lane_merge_bits/lane_split_bits fallbacks (the silent
    path wherever g++ is unavailable) must agree byte-for-byte with the
    native implementations across randomized lane-size patterns — they
    are vectorized by bit-shift class, a different algorithm."""
    import unittest.mock as mock

    from entropy_coders_tpu import native
    if not native.available():
        pytest.skip("native codec unavailable")
    rng = np.random.default_rng(7)
    for trial in range(15):
        k = int(rng.choice([128, 256, 384]))
        sizes = rng.integers(10, int(rng.integers(20, 300)) + 20,
                             k).astype(np.int64)
        W = int((sizes.max() + 31) // 32) + 2
        words = rng.integers(0, 1 << 32, (W, k),
                             dtype=np.uint64).astype(np.uint32)
        nb32 = (sizes + 31) // 32
        words[np.arange(W)[:, None] >= nb32[None, :]] = 0
        top = sizes % 32
        lastm = np.where(top, (1 << np.maximum(top, 1)) - 1,
                         0xFFFFFFFF).astype(np.uint64).astype(np.uint32)
        words[np.maximum(nb32 - 1, 0), np.arange(k)] &= lastm
        ref_m = native.lane_merge_bits(words, sizes)
        ref_s = native.lane_split_bits(ref_m, sizes, k, W)
        with mock.patch.object(native, "available", lambda: False):
            assert PL.lane_merge_bits(words, sizes) == ref_m
            got_s, _ = PL.lane_split_bits(ref_m, sizes, k)
            assert np.array_equal(got_s[:W], ref_s)
            assert PL.lane_merge_bits(got_s, sizes) == ref_m


def test_bits_all_zero_sizes_fallback():
    """Degenerate all-zero lane sizes: the vectorized numpy fallbacks
    must return an empty payload / zero words like the native path
    (regression: the shift-class rewrite indexed column 0 of a 0-wide
    array and raised IndexError)."""
    import unittest.mock as mock

    from entropy_coders_tpu import native

    k, W = 128, 8
    words = np.zeros((W, k), np.uint32)
    sizes = np.zeros(k, np.int64)
    with mock.patch.object(native, "available", lambda: False):
        assert PL.lane_merge_bits(words, sizes) == b""
        back, Wb = PL.lane_split_bits(b"", sizes, k)
        assert back.shape == (Wb, k) and not back.any()
    if native.available():
        assert native.lane_merge_bits(words, sizes) == b""


