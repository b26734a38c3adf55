"""Block-container codec (format: FORMAT.md).

Splits data into fixed-size blocks; each block is a reference-format FSE
frame internally (k-way interleave) so the container embeds the
reference's primitives per block while adding parallel decode entry,
RAW/RLE escapes, and multi-chip shardability.

Pipeline per frame:
  host split -> device histogram (batched) -> host normalize (vectorized,
  exact) + header write -> device table build (batched vmap) -> device
  encode (batched vmap scan) -> host assembly. Decode mirrors it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .constants import TABLE_LOG_DEFAULT, TABLE_LOG_MAX, TABLE_LOG_MIN
from .normalize import normalize_batch
from .ops import pl_coder as PL
from .ops.coder import _cdiv, _decode_core, _encode_core
from .ops.histogram import histogram_blocks
from .ops.tables import build_decode_table, build_encode_table
from .spec.histogram import NormHistogram

MAGIC = b"FSET"
# v2: FLAG_CRC table + MODE_FSE_PL sections (v1 readers would misparse
# them, so the additions bumped the version; readers also reject unknown
# flag bits — the format is unstable until 1.0).
VERSION = 2
FLAG_SHARED = 1
FLAG_CRC = 2  # per-block crc32 table present (integrity checking)
FLAG_PACKED = 4  # MODE_FSE_PL lane streams bit-packed (no dead bits)

MODE_FSE = 0
MODE_RAW = 1
MODE_RLE = 2
MODE_FSE_PL = 3  # per-lane streams (ops.pl_coder)

DEFAULT_BLOCK_SIZE = 1 << 17
DEFAULT_K = 1024


# --- batched jit wrappers ---------------------------------------------------

from functools import partial


@partial(jax.jit, static_argnames=("k", "L", "W"))
def _encode_blocks(syms, valid, init_syms, finish_slots, tt_bits, tt_fs,
                   table, *, k, L, W):
    fn = lambda s, i, b, f, t: _encode_core(
        s, valid, i, finish_slots, b, f, t, k=k, L=L, W=W
    )
    return jax.vmap(fn)(syms, init_syms, tt_bits, tt_fs, table)


@partial(jax.jit, static_argnames=("k", "L", "R"))
def _decode_blocks(words, total_bits, packed, *, k, L, R):
    fn = lambda w, t, p: _decode_core(w, t, p, k=k, L=L, R=R)
    return jax.vmap(fn)(words, total_bits, packed)


@partial(jax.jit, static_argnames=("log2",))
def _build_enc_blocks(norm_tables, *, log2):
    return jax.vmap(lambda t: build_encode_table(t, log2=log2))(norm_tables)


@partial(jax.jit, static_argnames=("log2",))
def _build_dec_blocks(norm_tables, *, log2):
    return jax.vmap(lambda t: build_decode_table(t, log2=log2))(norm_tables)


def _encode_layout(n: int, k: int):
    """Static emission layout for blocks of raw length n (see ops.coder)."""
    m = n - k
    R = max(_cdiv(m, k), 1)
    valid = (np.arange(R * k) < m).reshape(R, k)
    finish_slots = np.array([(n - 1 - s) % k for s in range(k - 1, -1, -1)], np.int32)
    W = _cdiv((R * k + k) * 16 + 32, 32) + 2
    return m, R, valid, finish_slots, W


def _blocks_to_syms(blocks: np.ndarray, m: int, R: int, k: int):
    """(B, n) raw blocks -> (B, R, k) symbols in emission order + (B, k)
    init symbols (slot t holds byte n-1-t)."""
    B, n = blocks.shape
    rev = blocks[:, :m][:, ::-1]
    pad = R * k - m
    if pad:
        rev = np.concatenate([rev, np.zeros((B, pad), np.uint8)], axis=1)
    syms = rev.reshape(B, R, k)
    init_syms = blocks[:, n - k :][:, ::-1].copy()
    return syms, init_syms


# --- compress ----------------------------------------------------------------


def _pl_eligible(block_size: int, k: int, log2: int) -> bool:
    """Whether a full block can take the per-lane-stream path
    (MODE_FSE_PL): k a multiple of 128 (the kernel's lane group), block
    divisible into >= 2 bytes per lane, and worst-case lane bit count
    fits the u16 size field. The full reference table-log range 5..15 is
    supported (reference: src/fse.rs:103-106)."""
    if k % 128 != 0 or block_size % k != 0:
        return False
    q = block_size // k
    if q < 2 or (q - 1) * log2 + log2 >= (1 << 16):
        return False
    return 5 <= log2 <= 15


# Default table-log policy of the per-lane path: per block, start from
# the reference's ratio-optimal ``optimal_log2`` (src/histogram.rs:
# 264-277) and take the smallest table log whose estimated coded size
# stays within 0.25% (normalize.fast_log2s). Its speed side — whether a
# smaller log decodes faster on the GPU — is not measured yet (ROADMAP
# queue 1 item 6). The shared-stream path keeps the reference's fixed
# default.
PL_TABLE_LOG = ("fast", 0.0025)


def resolve_shared_table(counts_all, total_len: int, table_log, lanes):
    """Resolve the shared-table decision from EXACT global counts.

    Returns ``(norm_table (256,) int32, log2)`` — or ``None`` when the
    input degrades to per-block RAW/RLE modes (degenerate <=1-symbol
    data, or an un-normalizable total such as < 9 bytes under a policy
    log). ``table_log``/``lanes`` of ``None`` resolve to the same
    defaults ``compress`` uses.

    This is the single normative copy of the policy: ``compress``
    (single process) and ``parallel.multihost.compress`` (DCN
    all-reduced counts) both call it, which is what keeps multi-host
    shared frames byte-identical to single-process ones. Counts stay
    int64/uint64-exact throughout — aggregated multi-host histograms
    legitimately exceed u32 per-symbol counts past 4 GiB of input."""
    if lanes is None:
        lanes = PL.lanes_default()
    if table_log is None:
        table_log = PL_TABLE_LOG if lanes else TABLE_LOG_DEFAULT
    counts_all = np.asarray(counts_all)
    if np.count_nonzero(counts_all) <= 1:
        return None
    try:
        tables, log2s = normalize_batch(counts_all[None], total_len,
                                        table_log)
    except ValueError:
        return None
    return tables[0], int(log2s[0])


def compress(
    data,
    *,
    block_size: int = DEFAULT_BLOCK_SIZE,
    k: int = DEFAULT_K,
    shared_table: bool = False,
    shared_hist=None,
    table_log: int | str | tuple | None = None,
    sharding=None,
    lanes: bool | None = None,
    interpret: bool = False,
    checksum: bool = False,
    bit_pack: bool = False,
) -> bytes:
    """Compress ``data`` into a container frame (FORMAT.md).

    ``lanes`` selects the per-lane-stream block mode (MODE_FSE_PL,
    ops.pl_coder): None = auto (on the GPU when eligible; the
    shared-stream mode on the CPU), True/False to force. ``table_log``
    defaults to PL_TABLE_LOG, the ``("fast", 0.0025)`` policy, on the
    lanes path and TABLE_LOG_DEFAULT otherwise; ``"auto"`` applies the
    reference's per-block ``optimal_log2`` policy (src/histogram.rs:
    264-277) — each block gets its own log, and blocks group by (len,
    log) for the batched coders. ``"fast"`` takes per block the smallest
    log whose estimated coded size stays within 0.5% of the auto
    choice's (normalize.fast_log2s); ``("fast", eps)`` sets that size
    budget explicitly. ``interpret`` runs the per-lane Pallas kernels in
    interpreter mode (for CPU testing). ``checksum`` appends a per-block
    crc32 table, verified on decompress (the reference format has no
    integrity checking — corruption decodes to garbage silently).
    ``bit_pack`` (FLAG_PACKED) packs MODE_FSE_PL lane streams at bit
    granularity like the reference's single stream (reference:
    src/bitstream/writer.rs:177-222), recovering the <= 7 dead bits each
    byte-aligned lane otherwise carries, at the cost of a slower host
    repack. ``shared_hist`` (with ``shared_table=True``) supplies a
    precomputed ``(norm_table, log2)`` pair to use as the shared table
    instead of histogramming ``data`` — the multi-host path passes the
    globally all-reduced histogram so every host's sub-frame carries the
    identical header (parallel/multihost.py)."""
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if lanes is None:
        lanes = PL.lanes_default()
    if table_log is None:
        table_log = PL_TABLE_LOG if lanes else TABLE_LOG_DEFAULT
    data = np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray) else np.asarray(data, np.uint8)
    if block_size < 16:
        raise ValueError("block_size must be >= 16")
    if k < 1 or k > min(block_size, 0xFFFF):
        # every interleaved stream needs at least one byte of a full
        # block (the tail clamps separately, _encode_tail), and the
        # frame header stores k in a u16
        raise ValueError(f"k={k} must be in [1, min(block_size="
                         f"{block_size}, 65535)]")
    total_len = len(data)
    if total_len == 0:
        return _frame_header(0, k, block_size, 0, False, checksum,
                             bit_pack) + b""
    n_blocks = _cdiv(total_len, block_size)

    full = total_len // block_size
    sections: list[bytes] = [b""] * n_blocks
    modes = np.full(n_blocks, MODE_FSE, np.int32)

    shared_hdr = b""
    s_shared = None
    if shared_table:
        if shared_hist is not None:
            # precomputed global histogram (multi-host: every process
            # normalizes the allgathered counts identically and passes
            # the result here, so all sub-frames share one table even
            # though no process saw the whole input)
            s_shared = (np.asarray(shared_hist[0], np.int32),
                        int(shared_hist[1]))
        else:
            # one histogram over everything, one table for every block
            # (int64 counts: stay exact past u32 for > 4 GiB inputs)
            s_shared = resolve_shared_table(
                np.bincount(data, minlength=256), total_len, table_log,
                lanes)
        if s_shared is None:
            shared_table = False  # degenerate / un-normalizable input:
        else:                     # blocks degrade to RAW/RLE
            shared_hdr = _write_header(*s_shared)

    nsym = None
    if full:
        blocks = data[: full * block_size].reshape(full, block_size)
        # one h2d for the whole input (sharded over the mesh when given):
        # the device copy feeds both the batched histogram and (when
        # eligible) the lane encode kernels
        blocks_dev = (_put(blocks, sharding) if sharding is None
                      or full % sharding.mesh.size == 0 else None)
        counts = np.asarray(histogram_blocks(
            blocks_dev if blocks_dev is not None
            else jnp.asarray(blocks)))
        # single-symbol blocks can't be FSE-coded (the reference's
        # normalization rejects table_len == 1, src/histogram.rs:98);
        # they take the RLE escape below.
        nsym = (counts != 0).sum(axis=1)
        codable = np.flatnonzero(nsym > 1)
        if codable.size:
            if shared_table:
                norm_tables = np.repeat(s_shared[0][None], codable.size,
                                        axis=0)
                log2_arr = np.full(codable.size, s_shared[1], np.int64)
            else:
                norm_tables, log2_arr = normalize_batch(
                    counts[codable], block_size, table_log
                )
            all_rows = codable.size == full
            _encode_group(
                blocks if all_rows else blocks[codable],
                norm_tables, log2_arr, k,
                shared_table, sections, modes, codable,
                sharding=sharding, lanes=lanes, interpret=interpret,
                bit_pack=bit_pack,
                blocks_dev=(blocks_dev if all_rows or blocks_dev is None
                            else blocks_dev[codable]),
            )

    if full * block_size < total_len:  # ragged tail block
        tail = data[full * block_size :]
        _encode_tail(tail, k, table_log, shared_table, s_shared,
                     sections, modes, n_blocks - 1,
                     lanes=lanes, interpret=interpret, bit_pack=bit_pack)

    # RAW/RLE escapes where FSE did not win. Constant-block detection for
    # full blocks comes free from the device histogram (nsym == 1).
    raw_lens = [min(block_size, total_len - i * block_size) for i in range(n_blocks)]
    for i in range(n_blocks):
        rl = raw_lens[i]
        o = i * block_size
        if modes[i] in (MODE_FSE, MODE_FSE_PL) and len(sections[i]) >= rl:
            modes[i] = MODE_RAW
            sections[i] = data[o : o + rl].tobytes()
        if nsym is not None and i < len(nsym):
            is_const = bool(nsym[i] == 1)
        else:
            is_const = rl > 1 and bool((data[o : o + rl] == data[o]).all())
        if modes[i] != MODE_RLE and rl > 1 and is_const:
            modes[i] = MODE_RLE
            sections[i] = bytes([int(data[o])])

    parts = [_frame_header(total_len, k, block_size, n_blocks,
                           shared_table, checksum, bit_pack)]
    if shared_table:
        parts.append(struct.pack("<H", len(shared_hdr)) + shared_hdr)
    entries = (modes.astype(np.uint32) << 30) | np.array(
        [len(s) for s in sections], np.uint32)
    parts.append(entries.astype("<u4").tobytes())
    if checksum:
        import zlib
        crcs = np.array(
            [zlib.crc32(data[i * block_size : i * block_size + raw_lens[i]])
             & 0xFFFFFFFF for i in range(n_blocks)], np.uint32)
        parts.append(crcs.astype("<u4").tobytes())
    parts.extend(sections)
    return b"".join(parts)


def _put(arr, sharding):
    """Place a host array on the mesh, sharded over the leading (block)
    axis; plain transfer when unsharded."""
    if sharding is None:
        return jnp.asarray(arr)
    return jax.device_put(arr, sharding)


def _tl(table) -> int:
    nz = np.flatnonzero(table)
    return int(nz[-1]) + 1 if nz.size else 1


def _write_header(table, log2: int) -> bytes:
    """Zstd-format histogram header bytes (native C++ when available —
    the Python spec writer is bigint bit I/O, ~1000x slower)."""
    from . import native

    if native.available():
        return native.write_header(np.asarray(table, np.int32), int(log2),
                                   _tl(table))
    hdr = bytearray()
    NormHistogram(np.asarray(table), int(log2), _tl(table)).write(hdr)
    return bytes(hdr)


def _read_block_header(sec: bytes):
    """Parse a histogram header off the front of a block section.
    Returns (table (256,) int32, log2, payload) — native C++ when
    available, spec fallback otherwise. Raises ValueError on malformed
    headers (HistError is a ValueError subclass)."""
    from . import native

    try:
        if native.available():
            table, log2, _tl_, n = native.read_header(sec)
            return table, log2, sec[n:]
        norm, rest = NormHistogram.read(sec)
        return np.asarray(norm.table, np.int32), norm.log2, rest
    except ValueError:
        raise
    except Exception as e:  # the spec reader is not fuzz-hardened;
        # normalize anything it throws on garbage to the frame contract
        raise ValueError(f"malformed histogram header: {e!r}") from e


def _pack_size_table(st: bytes) -> bytes:
    """FLAG_PACKED lane-size table: ``u16 cs_len`` + either the
    FSE-compressed table (cs_len > 0; reference k=2 frame over the raw
    u16 LE bytes) or the raw table (cs_len == 0, incompressible or
    degenerate fallback)."""
    from . import native

    try:
        if native.available():
            cs = native.compress(st, k=2)
        else:
            from .spec.codec import fse_compress
            buf = bytearray()
            fse_compress(np.frombuffer(st, np.uint8), buf, k=2)
            cs = bytes(buf)
        if 0 < len(cs) < min(len(st), 1 << 16):
            return struct.pack("<H", len(cs)) + cs
    except ValueError:
        pass  # degenerate distribution: fall through to raw
    return struct.pack("<H", 0) + st


def _unpack_size_table(sec: bytes, k: int) -> tuple[np.ndarray, bytes]:
    """Inverse of _pack_size_table: returns (sizes (k,) int32, rest)."""
    from . import native

    if len(sec) < 2:
        raise ValueError("truncated lane size table")
    (cs_len,) = struct.unpack_from("<H", sec)
    if cs_len == 0:
        if len(sec) < 2 + 2 * k:
            raise ValueError("truncated lane size table")
        st = sec[2: 2 + 2 * k]
        return (np.frombuffer(st, "<u2").astype(np.int32),
                sec[2 + 2 * k:])
    if len(sec) < 2 + cs_len:
        raise ValueError("truncated lane size table")
    comp = sec[2: 2 + cs_len]
    try:
        if native.available():
            st = native.decompress(comp, k=2, max_out=2 * k + 8)
        else:
            from .spec.codec import fse_decompress
            buf = bytearray()
            # max_out bounds a crafted low-entropy stream (the expected
            # output is exactly 2k bytes; anything bigger is corrupt)
            if fse_decompress(comp, buf, k=2, max_out=2 * k + 8) is None:
                raise ValueError("bad size table framing")
            st = bytes(buf)
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"malformed size table: {e!r}") from e
    if len(st) != 2 * k:
        raise ValueError("size table length mismatch")
    return np.frombuffer(st, "<u2").astype(np.int32), sec[2 + cs_len:]


def _frame_header(total_len, k, block_size, n_blocks, shared,
                  crc=False, packed=False) -> bytes:
    flags = ((FLAG_SHARED if shared else 0) | (FLAG_CRC if crc else 0)
             | (FLAG_PACKED if packed else 0))
    return (
        MAGIC
        + struct.pack("<BBHIQI", VERSION, flags,
                      k, block_size, total_len, n_blocks)
    )


def _encode_group_pl(blocks_src, norm_tables, l2, k, shared_table,
                     sections, modes, block_ids, interpret=False,
                     sharding=None, bit_pack=False):
    """Per-lane-stream (MODE_FSE_PL) batched encode of equal-size blocks
    sharing one table log2 (ops.pl_coder). ``blocks_src`` may be a host
    or device (B, n) uint8 array (PL.encode_lanes_norm). With
    ``sharding`` the block batch shards over the mesh (padded
    internally; pad results are discarded)."""
    B, n = blocks_src.shape
    mesh = sharding.mesh if sharding is not None else None
    R = n // k - 1
    W = PL.encode_w_bound(R, int(l2))

    def _drain(j0, words, szs):
        # host side of the pipeline: threaded native merge + section
        # assembly for one chunk, overlapping the device encode of the
        # chunks dispatched after it
        payloads = PL.lane_merge_batch(words, szs, pack_bits=bit_pack)
        for jj in range(words.shape[0]):
            j = j0 + jj
            st = szs[jj].astype("<u2").tobytes()
            if bit_pack:
                # FLAG_PACKED also FSE-compresses the lane-size table:
                # the u16 lo/hi byte planes map exactly onto the
                # reference's 2-stream interleave (even index = lo, odd
                # = hi), and the near-constant hi plane compresses to
                # almost nothing. The table is 2 bytes/lane — up to 12%
                # of small-k blocks.
                sec = _pack_size_table(st) + payloads[jj]
            else:
                sec = st + payloads[jj]
            if not shared_table:
                sec = _write_header(norm_tables[j], int(l2)) + sec
            sections[block_ids[j]] = sec
            modes[block_ids[j]] = MODE_FSE_PL

    # chunked pipeline (~64 MiB raw per chunk): every chunk's kernel is
    # DISPATCHED up front (async), then chunks drain in order — the host
    # merge of chunk i overlaps the device encode of chunks i+1... With
    # a mesh the batch stays one call (its padding owns the batch shape).
    chunk = B if mesh is not None else max(1, _cdiv(64 << 20, n))
    handles = [(j0, PL.encode_lanes_norm(blocks_src[j0 : j0 + chunk],
                                         norm_tables[j0 : j0 + chunk], k=k,
                                         L=int(l2), W=W, interpret=interpret,
                                         mesh=mesh, lazy=True))
               for j0 in range(0, B, chunk)]
    for j0, collect in handles:
        _drain(j0, *collect())


def _encode_group(blocks, norm_tables, log2_arr, k, shared_table,
                  sections, modes, block_ids, sharding=None, lanes=False,
                  interpret=False, blocks_dev=None, bit_pack=False):
    """Batched encode of equal-size blocks, grouped by effective log2.

    With ``sharding`` (a NamedSharding over the block axis), inputs are
    placed across the mesh and XLA partitions the whole batched
    encode — each chip encodes its blocks independently (data parallel
    over blocks, no cross-chip communication in the encode itself).
    With ``lanes``, eligible groups take the per-lane-stream path
    (reading from ``blocks_dev``, the already-device-resident copy of
    ``blocks``, when the caller provides one)."""
    B, n = blocks.shape
    layout = None  # shared-stream emission layout, built on first use

    for l2 in np.unique(log2_arr):
        rows = np.flatnonzero(log2_arr == l2)
        if lanes and _pl_eligible(n, k, int(l2)):
            src = blocks_dev if blocks_dev is not None else blocks
            if len(rows) != B:
                src = src[rows]
            _encode_group_pl(src, norm_tables[rows], int(l2), k,
                             shared_table, sections, modes, block_ids[rows],
                             interpret=interpret, sharding=sharding,
                             bit_pack=bit_pack)
            continue
        if layout is None:
            m, R, valid, finish_slots, W = _encode_layout(n, k)
            syms, init_syms = _blocks_to_syms(blocks, m, R, k)
            layout = True
        nrows = len(rows)
        pad_rows = 0
        if sharding is not None:
            nshards = sharding.mesh.size
            pad_rows = (-nrows) % nshards
        idx = np.concatenate([rows, rows[:1].repeat(pad_rows)])
        nt = _put(norm_tables[idx], sharding)
        table, tt_bits, tt_fs = _build_enc_blocks(nt, log2=int(l2))
        words, total_bits = _encode_blocks(
            _put(syms[idx], sharding),
            jnp.asarray(valid),
            _put(init_syms[idx], sharding),
            jnp.asarray(finish_slots),
            tt_bits, tt_fs, table,
            k=k, L=int(l2), W=W,
        )
        words = np.ascontiguousarray(np.asarray(words)[:nrows])
        total_bits = np.asarray(total_bits)[:nrows]
        for j, r in enumerate(rows):
            nbytes = (int(total_bits[j]) + 7) // 8
            payload = words[j].tobytes()[:nbytes]
            if shared_table:
                sections[block_ids[r]] = payload
            else:
                sections[block_ids[r]] = (
                    _write_header(norm_tables[r], int(l2)) + payload)


def _encode_tail(tail, k, table_log, shared_table, s_shared, sections,
                 modes, idx, lanes=False, interpret=False, bit_pack=False):
    """Encode the ragged last block. Takes the per-lane path when
    the tail happens to be lane-divisible (same eligibility as full
    blocks), the shared-stream path otherwise. ``s_shared`` is the
    (table, log2) pair of the frame's shared histogram, if any."""
    n = len(tail)
    k_t = min(k, n)  # every stream needs at least one byte
    if n < 8 or k_t < 1:
        modes[idx] = MODE_RAW
        sections[idx] = tail.tobytes()
        return
    try:
        if shared_table:
            norm_tables = np.asarray(s_shared[0])[None]
            log2_arr = np.array([s_shared[1]])
        else:
            counts = np.bincount(tail, minlength=256).astype(np.uint32)[None]
            norm_tables, log2_arr = normalize_batch(counts, n, table_log)
        tmp_sections = [b""]
        tmp_modes = np.full(1, MODE_FSE, np.int32)
        _encode_group(tail[None, :], norm_tables, log2_arr, k_t,
                      shared_table, tmp_sections, tmp_modes, np.array([0]),
                      lanes=lanes, interpret=interpret, bit_pack=bit_pack)
        sections[idx] = tmp_sections[0]
        modes[idx] = tmp_modes[0]
    except ValueError:
        modes[idx] = MODE_RAW
        sections[idx] = tail.tobytes()


# --- decompress ---------------------------------------------------------------


@dataclass
class _ParsedFrame:
    k: int
    block_size: int
    total_len: int
    n_blocks: int
    shared: bool
    shared_hdr: bytes
    modes: np.ndarray
    lens: np.ndarray
    offs: np.ndarray  # absolute offset of each block section in the frame
    frame: bytes
    crcs: np.ndarray | None = None
    packed: bool = False

    def section(self, i: int) -> bytes:
        """Materialize block i's section bytes (lazy — a range decode of a
        huge frame touches only the sections it needs)."""
        o = int(self.offs[i])
        return self.frame[o : o + int(self.lens[i])]


def _parse_frame(frame: bytes) -> _ParsedFrame:
    hdr_len = 4 + struct.calcsize("<BBHIQI")
    if len(frame) < hdr_len:
        raise ValueError("truncated frame: header")
    if frame[:4] != MAGIC:
        raise ValueError("bad magic")
    version, flags, k, block_size, total_len, n_blocks = struct.unpack_from(
        "<BBHIQI", frame, 4
    )
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    if flags & ~(FLAG_SHARED | FLAG_CRC | FLAG_PACKED):
        raise ValueError(f"unknown frame flags 0x{flags:02x}")
    if k < 1 or block_size < 1:
        raise ValueError("corrupt frame: zero k or block_size")
    if n_blocks != (total_len + block_size - 1) // block_size:
        raise ValueError("corrupt frame: block count mismatch")
    off = hdr_len
    shared = bool(flags & FLAG_SHARED)
    shared_hdr = b""
    if shared:
        if len(frame) < off + 2:
            raise ValueError("truncated frame: shared header length")
        (hlen,) = struct.unpack_from("<H", frame, off)
        off += 2
        if len(frame) < off + hlen:
            raise ValueError("truncated frame: shared header")
        shared_hdr = frame[off : off + hlen]
        off += hlen
    if len(frame) < off + 4 * n_blocks:
        raise ValueError("truncated frame: block table")
    entries = np.frombuffer(frame, np.uint32, count=n_blocks, offset=off)
    off += 4 * n_blocks
    modes = (entries >> 30).astype(np.int32)
    lens = (entries & ((1 << 30) - 1)).astype(np.int64)
    crcs = None
    if flags & FLAG_CRC:
        if len(frame) < off + 4 * n_blocks:
            raise ValueError("truncated frame: crc table")
        crcs = np.frombuffer(frame, np.uint32, count=n_blocks,
                             offset=off).copy()
        off += 4 * n_blocks
    offs = off + np.concatenate([[0], np.cumsum(lens)[:-1]]) if n_blocks \
        else np.zeros(0, np.int64)
    if n_blocks and len(frame) < off + int(lens.sum()):
        raise ValueError("truncated frame: sections")
    return _ParsedFrame(k, block_size, total_len, n_blocks, shared,
                        shared_hdr, modes, lens, offs, frame, crcs,
                        bool(flags & FLAG_PACKED))


def _subframe_parts(pf: "_ParsedFrame"):
    """(entries u32, crcs | None, payload bytes) of a parsed frame — the
    pieces a larger frame assembles from sub-frames (ordered multi-host
    merge, file streaming)."""
    entries = ((pf.modes.astype(np.uint32) << 30)
               | pf.lens.astype(np.uint32))
    payload = (pf.frame[int(pf.offs[0]): int(pf.offs[-1] + pf.lens[-1])]
               if pf.n_blocks else b"")
    return entries, pf.crcs, payload


def decompress(frame: bytes, *, sharding=None, interpret: bool = False,
               start: int = 0, length: int | None = None, out=None):
    """Decompress a container frame back to bytes.

    ``start``/``length`` decode only the blocks overlapping that byte
    range (random access — every block is independently decodable) and
    return exactly that slice. When the frame carries per-block crc32s
    (``compress(checksum=True)``), each decoded block is verified.

    ``out``: optional writable buffer (bytearray, writable memoryview,
    uint8 numpy array, mmap) the decoded range is written into instead
    of allocating fresh ``bytes`` — the container-level analog of the
    reference's decompress-into-caller-buffer API (reference:
    src/lib.rs:187-211). Block-aligned ranges (``start`` a multiple of
    the block size and the range ending on a block boundary or at the
    frame end — every full-frame call qualifies) decode directly into
    ``out`` with no intermediate copy. Returns the byte count written
    when ``out`` is given, the decoded ``bytes`` otherwise. On a
    ValueError (corrupt frame / crc mismatch) ``out``'s contents are
    unspecified."""
    return _decompress_parsed(_parse_frame(frame), sharding=sharding,
                              interpret=interpret, start=start,
                              length=length, out=out)


def _decompress_parsed(pf: "_ParsedFrame", *, sharding=None,
                       interpret: bool = False, start: int = 0,
                       length: int | None = None, out=None):
    """Range-decode an already-parsed frame (callers that decode many
    ranges of one frame — file streaming — parse once)."""
    from .utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if length is None:
        length = pf.total_len - start
    if not (0 <= start <= pf.total_len and 0 <= length <= pf.total_len - start):
        raise ValueError("range outside frame")
    if pf.block_size:
        b_lo = start // pf.block_size
        b_hi = _cdiv(start + length, pf.block_size) if length else b_lo
    else:
        b_lo, b_hi = 0, 0
    wanted = range(b_lo, min(max(b_hi, b_lo), pf.n_blocks))
    # the output buffer spans only the wanted blocks — a small range read
    # of a huge frame allocates O(blocks touched), not O(total_len)
    base = b_lo * pf.block_size
    span = min(wanted.stop * pf.block_size, pf.total_len) - base \
        if len(wanted) else 0
    cb_direct = cb_view = None
    if out is not None:
        cb_view = memoryview(out).cast("B")
        if cb_view.readonly:
            raise ValueError("out buffer is read-only")
        if cb_view.nbytes < length:
            raise ValueError(
                f"out buffer too small: {cb_view.nbytes} < {length}")
        if start == base and span == length:
            # block-aligned range: decode straight into the caller's
            # buffer (every block's bytes land inside [base, base+span),
            # which all wanted blocks jointly cover — no staging copy)
            cb_direct = np.frombuffer(cb_view, np.uint8, count=span)
    out = cb_direct if cb_direct is not None \
        else np.zeros(max(span, 0), np.uint8)

    shared_tbl = shared_l2 = None
    if pf.shared:
        shared_tbl, shared_l2, rest = _read_block_header(pf.shared_hdr)
        if rest:
            raise ValueError("trailing bytes after shared histogram header")

    # group FSE blocks by (raw_len, log2) for batched decode
    groups: dict[tuple[int, int], list[tuple[int, bytes, np.ndarray]]] = {}
    pl_groups: dict[tuple[int, int], list[tuple[int, bytes, np.ndarray]]] = {}
    for i in wanted:
        mode, sec = int(pf.modes[i]), pf.section(i)
        rl = min(pf.block_size, pf.total_len - i * pf.block_size)
        o = i * pf.block_size - base
        if mode == MODE_RAW:
            if len(sec) != rl:
                raise ValueError(f"raw block {i} length mismatch")
            out[o : o + rl] = np.frombuffer(sec, np.uint8)
        elif mode == MODE_RLE:
            if len(sec) != 1:
                raise ValueError(f"rle block {i} length mismatch")
            out[o : o + rl] = sec[0]
        elif mode in (MODE_FSE, MODE_FSE_PL):
            if pf.shared:
                tbl, l2, payload = shared_tbl, shared_l2, sec
            else:
                tbl, l2, payload = _read_block_header(sec)
            dst = pl_groups if mode == MODE_FSE_PL else groups
            dst.setdefault((rl, l2), []).append((i, payload, tbl))
        else:
            raise ValueError(f"bad block mode {mode}")

    for (rl, log2), items in groups.items():
        _decode_group(items, rl, log2, pf, out, base, sharding=sharding)
    for (rl, log2), items in pl_groups.items():
        _decode_group_pl(items, rl, log2, pf, out, base,
                         interpret=interpret, sharding=sharding)
    if pf.crcs is not None:
        import zlib
        for i in wanted:
            o = i * pf.block_size - base
            rl = min(pf.block_size, pf.total_len - i * pf.block_size)
            got = zlib.crc32(out[o : o + rl]) & 0xFFFFFFFF
            if got != int(pf.crcs[i]):
                raise ValueError(f"block {i}: crc mismatch (corrupt frame)")
    if cb_view is not None:
        if cb_direct is None:  # unaligned range: one staging copy
            np.frombuffer(cb_view, np.uint8, count=length)[:] = \
                out[start - base : start - base + length]
        return length
    return out[start - base : start - base + length].tobytes()


def _decode_group_pl(items, raw_len, log2, pf, out, out_base,
                     interpret=False, sharding=None):
    """Batched decode of MODE_FSE_PL blocks (per-lane streams) sharing one
    (raw_len, log2) (PL.decode_lanes_norm). With ``sharding``
    the batch shards over the mesh (padded internally)."""
    k = pf.k
    if not (TABLE_LOG_MIN <= log2 <= TABLE_LOG_MAX):
        raise ValueError(f"corrupt frame: table log {log2} out of range")
    if k % 128 != 0 or raw_len % k != 0 or raw_len // k < 2:
        raise ValueError("corrupt frame: FSE_PL block not lane-divisible")
    R = raw_len // k - 1
    mesh = sharding.mesh if sharding is not None else None
    B = len(items)
    sizes = np.zeros((B, k), np.int32)
    payloads = []
    norm_tables = np.zeros((B, 256), np.int32)
    for j, (i, sec, nt) in enumerate(items):
        if pf.packed:
            # bit-packed wire (FLAG_PACKED): compressed size table, then
            # bit-granularity lane streams (total bits, last dead bits 0)
            sz, lanes_sec = _unpack_size_table(sec, k)
            if (sz < log2).any() or (sz > (R + 1) * log2).any():
                # the encoder never emits more than (R+1)*log2 bits per lane
                # (_pl_eligible invariant); an oversized claim would make the
                # words array allocation below scale with the claim, not the
                # payload (memory-amplification guard)
                raise ValueError(f"block {i}: bad lane sizes")
            total = int(sz.astype(np.int64).sum())
            if (total + 7) // 8 != len(lanes_sec):
                raise ValueError(f"block {i}: bad lane sizes")
            if total & 7 and lanes_sec[-1] >> (total & 7):
                raise ValueError(f"block {i}: lane framing error")
            sizes[j] = sz
            payloads.append(lanes_sec)
            norm_tables[j] = nt
            continue
        if len(sec) < 2 * k:
            raise ValueError(f"block {i}: truncated lane sizes")
        sz = np.frombuffer(sec[: 2 * k], "<u2").astype(np.int32)
        if (sz < log2).any() or (sz > (R + 1) * log2).any():
            # see packed-branch comment: bounds the words allocation by the
            # encoder invariant, not the attacker-controlled claim
            raise ValueError(f"block {i}: bad lane sizes")
        if int(((sz + 7) >> 3).sum()) != len(sec) - 2 * k:
            raise ValueError(f"block {i}: bad lane sizes")
        # framing check (the marker-bit rule's per-lane analog, reference
        # src/bitstream/stack_reader.rs:81-83): the dead bits above each
        # lane's top bit must be zero
        buf = np.frombuffer(sec, np.uint8, offset=2 * k)
        last = buf[np.cumsum((sz + 7) >> 3) - 1].astype(np.int32)
        if (last >> (((sz - 1) & 7) + 1)).any():
            raise ValueError(f"block {i}: lane framing error")
        sizes[j] = sz
        payloads.append(sec[2 * k:])
        norm_tables[j] = nt
    # common padded width for the whole group (bucketed to bound compile
    # shapes); the split itself is one batched native call per chunk
    # (OpenMP-threaded over blocks)
    W = -(-(int(sizes.max()) // 32 + 3) // 16) * 16

    def _drain(j0, collect):
        blocks = collect()
        for jj in range(blocks.shape[0]):
            o = items[j0 + jj][0] * pf.block_size - out_base
            out[o : o + raw_len] = blocks[jj]

    # chunked pipeline (~64 MiB raw per chunk): the host splits + H2Ds
    # every chunk and dispatches its decode kernel asynchronously, then
    # drains in order — writeback of chunk i overlaps the device decode
    # of chunks i+1... One call with a mesh (its padding owns B).
    chunk = B if mesh is not None else max(1, _cdiv(64 << 20, raw_len))
    handles = []
    for j0 in range(0, B, chunk):
        words = PL.lane_split_batch(payloads[j0 : j0 + chunk],
                                    sizes[j0 : j0 + chunk], k, W,
                                    pack_bits=bool(pf.packed))
        handles.append((j0, PL.decode_lanes_norm(
            words, sizes[j0 : j0 + chunk], norm_tables[j0 : j0 + chunk],
            k=k, L=log2, R=R, interpret=interpret, mesh=mesh, lazy=True)))
    for j0, collect in handles:
        _drain(j0, collect)


def _decode_group(items, raw_len, log2, pf, out, out_base, sharding=None):
    k = min(pf.k, raw_len)
    if sharding is not None:
        # pad the batch to the mesh size by replicating the first block
        # (decoded results of the pad rows are discarded)
        pad = (-len(items)) % sharding.mesh.size
        items = items + items[:1] * pad
    B = len(items)
    # payload words, padded to the group max (+ guard words)
    max_bytes = max(len(p) for _, p, _ in items)
    Wd = _cdiv(max_bytes, 4) + 2
    words = np.zeros((B, Wd), np.uint32)
    total_bits = np.zeros(B, np.int32)
    norm_tables = np.zeros((B, 256), np.int32)
    for j, (i, payload, nt) in enumerate(items):
        buf = np.frombuffer(payload, np.uint8)
        nz = np.flatnonzero(buf)
        if nz.size == 0:
            raise ValueError(f"block {i}: missing marker bit")
        last = int(nz[-1])
        marker = last * 8 + int(buf[last]).bit_length() - 1
        if len(buf) * 8 - marker > 8:
            raise ValueError(f"block {i}: framing error")
        total_bits[j] = marker
        pb = np.zeros(Wd * 4, np.uint8)
        pb[: len(buf)] = buf
        words[j] = pb.view(np.uint32)
        norm_tables[j] = nt

    packed = _build_dec_blocks(_put(norm_tables, sharding), log2=log2)
    m = raw_len - k
    R = max(_cdiv(m, k), 1) + 1
    syms, emit_count, finals, done, _c = _decode_blocks(
        _put(words, sharding), _put(total_bits, sharding), packed,
        k=k, L=log2, R=R,
    )
    syms = np.asarray(syms).reshape(B, -1)
    emit_count = np.asarray(emit_count)
    finals = np.asarray(finals)
    if not np.asarray(done).all():
        raise ValueError("decode did not terminate: corrupt frame")
    if not (emit_count == m).all():
        raise ValueError("decoded length mismatch: corrupt frame")
    for j, (i, _, _) in enumerate(items):
        o = i * pf.block_size - out_base
        out[o : o + m] = syms[j, :m]
        out[o + m : o + raw_len] = finals[j]
