"""Executable specification of the k-way interleaved FSE frame codec.

Frame layout (identical to the reference for k=1 and k=2):

    [zstd-format histogram header (byte-aligned)]
    [reversed LSB-first bit stack: payload + k final states + marker bit]

The reference ships ``fse_compress``/``fse_decompress`` (k=1, reference:
src/lib.rs:112-143,187-211) and ``fse_compress2``/``fse_decompress2``
(k=2, reference: src/lib.rs:146-183,215-248). This module implements the
k-way generalization those two instantiate, derived from the reference's
interleave/order contract:

* symbol ``i`` belongs to stream ``i mod k``;
* each stream's highest-index symbol initializes its encoder state for
  free (``new_first_symbol``, reference: src/fse.rs:210-218);
* encode emits in strictly *descending* symbol order ``n-k-1 .. 0``
  (one shared bitstream — matches the reference's per-chunk
  ``encode1 then encode0`` order, src/lib.rs:167-176);
* encoders finish in order ``k-1 .. 0`` then a 1-marker bit
  (src/lib.rs:178-182), so decoders initialize ``0 .. k-1``;
* decode emits in *ascending* order; when stream ``j``'s bit read fails,
  the k pending final-state symbols flush in cyclic order
  ``j, j+1, .., k-1, 0, .., j-1`` (generalizes the two exit paths of
  ``fse_decompress2``, src/lib.rs:228-243).

This shared-bitstream interleave is the key to the data-parallel design: per decode
round all k lane states are known simultaneously, so per-lane bit counts
are known, and an exclusive prefix sum yields every lane's read offset —
one serial step per *round* (n/k symbols), fully parallel across lanes.
The production kernels (``entropy_coders_tpu.ops``) implement exactly this
with k in the thousands; this module is their bit-exactness oracle.
"""

from __future__ import annotations

import numpy as np

from .bitstream import BitStackReader, BitStackWriter
from .fse import DecodeTable, Decoder, EncodeTable, Encoder
from .histogram import NormHistogram


def fse_compress(src, dst: bytearray, k: int = 1,
                 hist: NormHistogram | None = None) -> tuple[NormHistogram, int]:
    """Compress ``src`` with ``k`` interleaved tANS streams sharing one
    table and one bitstream. Returns ``(hist, payload_bits)`` like the
    reference's ``fse_compress`` (src/lib.rs:112-143).

    ``k=1`` and ``k=2`` are byte-identical to the reference's
    ``fse_compress`` / ``fse_compress2``.
    """
    src = np.frombuffer(bytes(src), dtype=np.uint8) if not isinstance(src, np.ndarray) else src
    n = len(src)
    if n < max(k, 2):
        raise ValueError(f"need at least {max(k, 2)} bytes for k={k}")

    if hist is None:
        hist = NormHistogram.new(src)
    if int(hist.table.max()) == 1 << hist.log2:
        # Single-symbol input: the whole table normalizes to one symbol
        # (src/histogram.rs:113-120) and every decode step then reads 0
        # bits, so the reference's read-until-failure decoder NEVER
        # terminates on the frame its own compressor emits (lib.rs:199-207
        # + stack_reader.rs:176-183, where peek(0) succeeds on an empty
        # reader; its tests never hit this, and a symbol-0-only input
        # panics earlier in `(table_len - 1).ilog2()`). Divergence, like
        # the documented L=15 underflow: we refuse to emit the
        # undecodable frame. Use RLE (frame.py does, automatically).
        raise ValueError("single-symbol input cannot be FSE-coded "
                         "(degenerate table; the reference's decoder "
                         "would never terminate)")
    hist.write(dst)

    writer = BitStackWriter(dst)
    table = EncodeTable(hist)

    # The top k symbols initialize the encoders: byte n-k+j belongs to
    # stream (n-k+j) mod k.
    encoders: list[Encoder | None] = [None] * k
    for j in range(k):
        idx = n - k + j
        encoders[idx % k] = Encoder.new_first_symbol(table, int(src[idx]))

    for i in range(n - k - 1, -1, -1):
        encoders[i % k].encode(writer, int(src[i]))

    for s in range(k - 1, -1, -1):
        encoders[s].finish(writer)
    writer.write_bits(1, 1)  # terminal marker (src/lib.rs:140-141)
    return hist, writer.finish()


def fse_decompress(src, dst: bytearray, k: int = 1,
                   max_out: int | None = None) -> int | None:
    """Decompress a k-way frame; appends to ``dst`` and returns the byte
    count, or ``None`` on a framing error, like the reference's
    ``fse_decompress``/``fse_decompress2`` (src/lib.rs:187-248).

    ``max_out`` (an extension the reference lacks) aborts with ``None``
    once the output would exceed it — callers decoding untrusted frames
    with a known output size must pass it, or a crafted low-entropy
    stream can force unbounded output (decompression-bomb DoS)."""
    try:
        hist, payload = NormHistogram.read(bytes(src))
    except ValueError:
        return None
    if int(hist.table.max()) == 1 << hist.log2:
        # degenerate single-symbol table: every state decodes the same
        # symbol with a 0-bit read, so the read-until-failure loop below
        # would never fail — the reference hangs here (see fse_compress);
        # treat it as a framing error
        return None
    reader = BitStackReader.new(payload)
    if reader is None:
        return None

    table = DecodeTable(hist)
    decoders = [Decoder(table, reader) for _ in range(k)]

    start = len(dst)
    i = 0
    while True:
        s = i % k
        sym = decoders[s].decode_symbol(reader)
        if sym is None:
            # flush pending final states cyclically starting at the
            # failed stream (src/lib.rs:233-243).
            for j in range(k):
                dst.append(decoders[(s + j) % k].finish())
            break
        dst.append(sym)
        i += 1
        if max_out is not None and i > max_out:
            del dst[start:]
            return None
    return len(dst) - start


def fse_compress2(src, dst: bytearray,
                  hist: "NormHistogram | None" = None):
    """Two-stream compression, byte-identical to the reference's
    ``fse_compress2`` (reference: src/lib.rs:146-183). Returns the
    payload bit count (the reference returns only ``usize``)."""
    _, bits = fse_compress(src, dst, k=2, hist=hist)
    return bits


def fse_decompress2(src, dst: bytearray) -> int | None:
    """Two-stream decompression, the reference's ``fse_decompress2``
    (reference: src/lib.rs:215-248)."""
    return fse_decompress(src, dst, k=2)
