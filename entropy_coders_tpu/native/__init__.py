"""C++ host codec bindings (ctypes).

Serial k-way FSE codec with the exact reference wire format — the fast
host oracle / CPU fallback, and the stand-in for the Rust baseline
(BASELINE.md: the reference's own numbers are unpublished).

Builds from ``fse_native.cpp`` with g++ on first use; ``available()`` reports whether the
native library could be built/loaded.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np

_lib = None
_load_error: str | None = None


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        from .build import build

        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            # a prebuilt .so from another machine (-march=native) can
            # fail to load — rebuild for this host and retry once
            path = build(force=True)
            lib = ctypes.CDLL(str(path))
        lib.ect_compress.restype = ctypes.c_int
        lib.ect_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.ect_decompress.restype = ctypes.c_int
        lib.ect_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.ect_read_header.restype = ctypes.c_size_t
        lib.ect_read_header.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ect_write_header.restype = ctypes.c_size_t
        lib.ect_write_header.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ect_normalize.restype = ctypes.c_int
        lib.ect_normalize.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.ect_encode_lanes.restype = ctypes.c_int
        lib.ect_encode_lanes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ect_lane_split.restype = ctypes.c_int64
        lib.ect_lane_split.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.ect_lane_merge.restype = ctypes.c_int64
        lib.ect_lane_merge.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ect_lane_merge_bits.restype = ctypes.c_int64
        lib.ect_lane_merge_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ect_lane_split_bits.restype = ctypes.c_int64
        lib.ect_lane_split_bits.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.ect_lane_merge_batch.restype = ctypes.c_int
        lib.ect_lane_merge_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.ect_lane_split_batch.restype = ctypes.c_int
        lib.ect_lane_split_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.ect_build_encode_tables.restype = ctypes.c_int
        lib.ect_build_encode_tables.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ect_build_decode_tables.restype = ctypes.c_int
        lib.ect_build_decode_tables.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ]
        _lib = lib
    except Exception as e:  # toolchain missing etc. — soft-fail
        _load_error = str(e)
        warnings.warn(f"native codec unavailable: {e}")
    return _lib


def available() -> bool:
    return _load() is not None


def compress(data, k: int = 1, table_log: int | None = None) -> bytes:
    """Reference-format compress (header + k-way payload).
    ``table_log=None`` picks the reference's ``optimal_log2``."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    data = bytes(data)
    cap = 1024 + len(data) + (len(data) >> 6)
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t()
    rc = lib.ect_compress(data, len(data), k,
                          -1 if table_log is None else table_log,
                          out, cap, ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"native compress failed (rc={rc})")
    return out.raw[: out_len.value]


def decompress(frame, k: int = 1, max_out: int | None = None) -> bytes:
    """Reference-format decompress; ``max_out`` caps the output buffer."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    frame = bytes(frame)
    cap = max_out if max_out is not None else max(len(frame) * 64, 1 << 20)
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t()
    rc = lib.ect_decompress(frame, len(frame), k, out, cap, ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"native decompress failed (rc={rc})")
    return out.raw[: out_len.value]


def read_header(data) -> tuple[np.ndarray, int, int, int]:
    """Parse a histogram header: (table, log2, table_len, header_bytes)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    data = bytes(data)
    table = np.zeros(256, np.int32)
    log2 = ctypes.c_int32()
    tl = ctypes.c_int32()
    n = lib.ect_read_header(data, len(data), table.ctypes.data_as(ctypes.c_void_p),
                            ctypes.byref(log2), ctypes.byref(tl))
    if n == 0:
        raise ValueError("bad histogram header")
    return table, int(log2.value), int(tl.value), int(n)


def write_header(table, log2: int, table_len: int) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    table = np.ascontiguousarray(table, np.int32)
    cap = 1024
    out = ctypes.create_string_buffer(cap)
    n = lib.ect_write_header(table.ctypes.data_as(ctypes.c_void_p), log2,
                             table_len, out, cap)
    if n == 0:
        raise ValueError("header write failed")
    return out.raw[:n]


def normalize(counts, size: int, log2: int = -1) -> tuple[np.ndarray, int]:
    """Exact reference normalization; log2=-1 means optimal_log2."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    counts = np.ascontiguousarray(counts, np.uint32)
    table = np.zeros(256, np.int32)
    l2 = lib.ect_normalize(counts.ctypes.data_as(ctypes.c_void_p), size, log2,
                           table.ctypes.data_as(ctypes.c_void_p))
    if l2 < 0:
        raise ValueError("normalization failed (degenerate input)")
    return table, int(l2)


def build_encode_tables(norm_tables: np.ndarray, log2: int):
    """Batched encode-table build from (B, 256) normalized histograms
    sharing ``log2``: returns ``(table (B, 2^log2) u16, tt_bits (B, 256)
    u32, tt_fs (B, 256) i32)`` — bit-identical to spec.fse.EncodeTable /
    ops.tables.build_encode_table, at host-C++ speed (the frame path
    builds tables here and ships them to the device instead of running
    the on-device build chain per call)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    nt = np.ascontiguousarray(norm_tables, np.int32)
    B = nt.shape[0]
    assert nt.shape == (B, 256)
    table = np.zeros((B, 1 << log2), np.uint16)
    tt_bits = np.zeros((B, 256), np.uint32)
    tt_fs = np.zeros((B, 256), np.int32)
    rc = lib.ect_build_encode_tables(
        nt.ctypes.data_as(ctypes.c_void_p), B, log2,
        table.ctypes.data_as(ctypes.c_void_p),
        tt_bits.ctypes.data_as(ctypes.c_void_p),
        tt_fs.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"encode table build failed (rc={rc})")
    return table, tt_bits, tt_fs


def build_decode_tables(norm_tables: np.ndarray, log2: int) -> np.ndarray:
    """Batched decode-table build: (B, 256) normalized histograms ->
    (B, 2^log2) u32 packed entries (sym<<24 | nb<<16 | base), identical
    to spec.fse.DecodeTable.packed / ops.tables.build_decode_table."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    nt = np.ascontiguousarray(norm_tables, np.int32)
    B = nt.shape[0]
    assert nt.shape == (B, 256)
    packed = np.zeros((B, 1 << log2), np.uint32)
    rc = lib.ect_build_decode_tables(
        nt.ctypes.data_as(ctypes.c_void_p), B, log2,
        packed.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"decode table build failed (rc={rc})")
    return packed


def encode_lanes(blocks: np.ndarray, norm_tables: np.ndarray, log2: int,
                 k: int, W: int):
    """Host per-lane encode (MODE_FSE_PL semantics): ``blocks`` (B, n)
    uint8 with n = (R+1)*k, one (B, 256) normalized table per block, all
    at ``log2``. Returns ``(words (B, W, k) u32, sizes (B, k) i32)`` in
    the layout of ops.pl_coder.encode_lanes — the independent reference
    its device kernels are checked against."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    src = np.ascontiguousarray(blocks, np.uint8)
    nt = np.ascontiguousarray(norm_tables, np.int32)
    B, n = src.shape
    assert nt.shape == (B, 256)
    words = np.zeros((B, W, k), np.uint32)
    sizes = np.zeros((B, k), np.int32)
    rc = lib.ect_encode_lanes(
        src.ctypes.data_as(ctypes.c_void_p), B, n, k,
        nt.ctypes.data_as(ctypes.c_void_p), log2, W,
        words.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"per-lane encode failed (rc={rc})")
    return words, sizes


def lane_merge_batch(words: np.ndarray, sizes_bits: np.ndarray,
                     pack_bits: bool = False) -> list[bytes]:
    """Batched lane merge of a whole block group: ``words (B, W, k)``,
    ``sizes_bits (B, k)`` -> one payload per block, in ONE native call,
    OpenMP-parallel over blocks (the per-block loop was the host-side
    e2e compress bottleneck)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    words = np.ascontiguousarray(words, np.uint32)
    B, W, k = words.shape
    sizes = np.ascontiguousarray(sizes_bits, np.int32).reshape(B, k)
    if pack_bits:
        totals = (sizes.astype(np.int64).sum(axis=1) + 7) // 8
        caps = totals + 8  # bit-RMW slack per block
    else:
        totals = ((sizes.astype(np.int64) + 7) // 8).sum(axis=1)
        caps = totals
    offs = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    out = np.zeros(int(offs[-1]), np.uint8)
    rc = lib.ect_lane_merge_batch(
        words.ctypes.data_as(ctypes.c_void_p), B, W, k,
        sizes.ctypes.data_as(ctypes.c_void_p),
        offs.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), 1 if pack_bits else 0)
    if rc != 0:
        raise ValueError(f"lane merge failed for block {-rc - 1}")
    return [out[int(offs[b]): int(offs[b] + totals[b])].tobytes()
            for b in range(B)]


def lane_split_batch(payloads: list[bytes], sizes_bits: np.ndarray,
                     k: int, W: int, pack_bits: bool = False) -> np.ndarray:
    """Batched inverse of lane_merge_batch: one native call fills the
    whole group's ``(B, W, k)`` uint32 kernel layout, OpenMP-parallel
    over blocks."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    B = len(payloads)
    sizes = np.ascontiguousarray(sizes_bits, np.int32).reshape(B, k)
    if pack_bits:  # the bit extractor reads 8 bytes past each payload
        payloads = [bytes(p) + b"\0" * 8 for p in payloads]
        plens = np.array([len(p) - 8 for p in payloads], np.int64)
    else:
        payloads = [bytes(p) for p in payloads]
        plens = np.array([len(p) for p in payloads], np.int64)
    ptrs = (ctypes.c_char_p * B)(*payloads)
    out = np.zeros((B, W, k), np.uint32)
    rc = lib.ect_lane_split_batch(
        ptrs, plens.ctypes.data_as(ctypes.c_void_p), B,
        sizes.ctypes.data_as(ctypes.c_void_p), k, W,
        out.ctypes.data_as(ctypes.c_void_p), 1 if pack_bits else 0)
    if rc != 0:
        raise ValueError(f"lane payload too short (block {-rc - 1})")
    return out


def lane_split(payload: bytes, sizes_bits: np.ndarray, k: int, W: int) -> np.ndarray:
    """Split concatenated byte-aligned lane streams into the padded (W, k)
    uint32 kernel layout (cache-blocked C++ transpose)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    sizes = np.ascontiguousarray(sizes_bits, np.int32)
    assert sizes.shape == (k,)
    out = np.zeros((W, k), np.uint32)
    n = lib.ect_lane_split(payload, len(payload),
                           sizes.ctypes.data_as(ctypes.c_void_p), k, W,
                           out.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        raise ValueError("lane payload too short")
    return out


def lane_merge(words: np.ndarray, sizes_bits: np.ndarray) -> bytes:
    """Inverse of lane_split: compact (W, k) uint32 into the wire payload."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    words = np.ascontiguousarray(words, np.uint32)
    W, k = words.shape
    sizes = np.ascontiguousarray(sizes_bits, np.int32)
    total = int(((sizes.astype(np.int64) + 7) // 8).sum())
    out = ctypes.create_string_buffer(total)
    n = lib.ect_lane_merge(words.ctypes.data_as(ctypes.c_void_p), W, k,
                           sizes.ctypes.data_as(ctypes.c_void_p), out)
    assert n == total
    return out.raw


def lane_merge_bits(words: np.ndarray, sizes_bits: np.ndarray) -> bytes:
    """Bit-packed lane merge (frame FLAG_PACKED): concatenates the lane
    streams at bit granularity — total ceil(sum(bits)/8) bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    words = np.ascontiguousarray(words, np.uint32)
    W, k = words.shape
    sizes = np.ascontiguousarray(sizes_bits, np.int32)
    total = int((int(sizes.astype(np.int64).sum()) + 7) // 8)
    out = ctypes.create_string_buffer(total + 8)  # RMW slack
    n = lib.ect_lane_merge_bits(words.ctypes.data_as(ctypes.c_void_p), W, k,
                                sizes.ctypes.data_as(ctypes.c_void_p), out)
    assert n == total
    return out.raw[:total]


def lane_split_bits(payload: bytes, sizes_bits: np.ndarray, k: int,
                    W: int) -> np.ndarray:
    """Inverse of lane_merge_bits into the padded (W, k) uint32 layout."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_load_error}")
    sizes = np.ascontiguousarray(sizes_bits, np.int32)
    assert sizes.shape == (k,)
    out = np.zeros((W, k), np.uint32)
    buf = payload + b"\0" * 8  # read slack
    n = lib.ect_lane_split_bits(buf, len(payload),
                                sizes.ctypes.data_as(ctypes.c_void_p), k, W,
                                out.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        raise ValueError("packed lane payload too short")
    return out
