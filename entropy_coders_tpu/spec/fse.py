"""Executable specification of the tANS (FSE) encode/decode tables and
state machines.

Semantics follow the reference exactly (reference: src/fse.rs) so that the
device kernels in ``entropy_coders_tpu.ops`` can be tested against these for
bit-exactness:

* table spread rule ``step = size*5//8 + 3`` with low-probability symbols
  pre-placed from the top of the table (src/fse.rs:67-70,101-151);
* ``SymbolTransform { bits, find_state }`` derivation incl. the count
  0 / ±1 special cases (src/fse.rs:164-189);
* encode step: ``bits_out = (tt.bits + value) >> 16`` in u32, emit the low
  ``bits_out`` bits of ``value``, ``value = table[(value >> bits_out) +
  tt.find_state]`` (src/fse.rs:227-239);
* decode step: ``dt = table[state]; state = dt.new_state +
  read(dt.num_bits)`` (src/fse.rs:363-373).

Only table construction is vectorized here (numpy); the per-symbol state
machines are plain Python because this module is the correctness oracle,
not the compute path.
"""

from __future__ import annotations

import numpy as np

from ..constants import ALPHABET, TABLE_LOG_MAX, TABLE_LOG_MIN, ilog2
from .bitstream import BitStackReader, BitStackWriter
from .histogram import NormHistogram

U32 = 0xFFFF_FFFF


def table_step(size: int) -> int:
    """Spread step; the ``+3`` makes it coprime with the power-of-two table
    size, guaranteeing a full cycle (reference: src/fse.rs:67-70)."""
    return size * 5 // 8 + 3


def spread_symbols(hist: NormHistogram) -> tuple[np.ndarray, int]:
    """Assign a symbol to every table slot.

    Returns ``(symbols, high_threshold)`` where ``symbols`` is the
    ``(size,)`` uint8 slot->symbol map and slots above ``high_threshold``
    hold the low-probability symbols, placed walking down from the top in
    symbol order (reference: src/fse.rs:119-151 == src/fse.rs:294-326).

    Vectorized equivalent of the reference's serial position-chasing loop:
    the visited positions are ``(j*step) mod size`` for ``j = 0..size-1``
    (all distinct since step is odd); the "skip the low-probability area"
    rule just filters that fixed sequence to positions ``<= high_threshold``
    while keeping ``j`` order.
    """
    size = 1 << hist.log2
    counts = hist.table[: hist.table_len].astype(np.int64)
    low = counts == -1
    n_low = int(low.sum())
    high_threshold = size - 1 - n_low

    symbols = np.zeros(size, dtype=np.uint8)
    if n_low:
        # walking high_threshold down in symbol order
        symbols[size - 1 : high_threshold : -1] = np.flatnonzero(low)

    spread_counts = np.where(low, 0, np.maximum(counts, 0))
    n_spread = int(spread_counts.sum())
    assert n_spread == high_threshold + 1, "spread slots must fill the low region exactly"

    # run-length decode symbol ids in symbol order
    sym_seq = np.repeat(
        np.arange(hist.table_len, dtype=np.int64), spread_counts
    ).astype(np.uint8)
    step = table_step(size)
    positions = (np.arange(size, dtype=np.int64) * step) & (size - 1)
    kept = positions[positions <= high_threshold]
    assert kept.size == n_spread
    symbols[kept] = sym_seq
    return symbols, high_threshold


class EncodeTable:
    """tANS encoding table (reference: src/fse.rs:72-194)."""

    def __init__(self, hist: NormHistogram):
        if not (TABLE_LOG_MIN <= hist.log2 <= TABLE_LOG_MAX):
            raise ValueError("FSE table log2 out of range")
        self.table_log = hist.log2
        size = 1 << self.table_log
        self.size = size

        symbols, _ = spread_symbols(hist)

        # next-state table: iterate slots in order, each symbol's slots get
        # consecutive entries starting at its cumulative offset
        # (src/fse.rs:157-162). Equivalent: stable argsort of slot symbols.
        # table[cumul[sym] + rank_within_sym(slot)] = size + slot, in slot
        # order — which is exactly a stable sort of slots by symbol.
        order = np.argsort(symbols, kind="stable")
        self.table = (size + order).astype(np.uint16)

        # Symbol transforms (src/fse.rs:164-189).
        counts = hist.table.astype(np.int64)
        self.tt_bits = np.zeros(ALPHABET, dtype=np.uint32)
        self.tt_find_state = np.zeros(ALPHABET, dtype=np.int32)
        total = 0
        L = self.table_log
        for s in range(hist.table_len):
            x = int(counts[s])
            if x == 0:
                self.tt_bits[s] = (((L + 1) << 16) - (1 << L)) & U32
            elif x == -1 or x == 1:
                self.tt_bits[s] = ((L << 16) - (1 << L)) & U32
                self.tt_find_state[s] = total - 1
                total += 1
            else:
                max_bits_out = L - ilog2(x - 1)
                min_state_plus = x << max_bits_out
                self.tt_bits[s] = ((max_bits_out << 16) - min_state_plus) & U32
                self.tt_find_state[s] = total - x
                total += x

    def update(self, hist: NormHistogram) -> None:
        """Rebuild this table for a new histogram (the reference reuses
        the allocation, reference: src/fse.rs:101-189; here a re-init)."""
        self.__init__(hist)

    @staticmethod
    def compress_bound(size: int) -> int:
        """Worst-case compressed size (reference: src/fse.rs:191-193)."""
        return 512 + size + (size >> 7) + 4 + 8


class Encoder:
    """Single tANS encode state machine over a shared table
    (reference: src/fse.rs:196-251)."""

    def __init__(self, table: EncodeTable):
        self.value = 0
        self.table = table

    @classmethod
    def new_first_symbol(cls, table: EncodeTable, first_symbol: int) -> "Encoder":
        """Start at the cheapest state so the first symbol costs no bits
        (reference: src/fse.rs:210-218)."""
        self = cls(table)
        bits = int(table.tt_bits[first_symbol])
        # The reference computes bits_out = (bits + 2^15) >> 16
        # (src/fse.rs:213), which is floor(bits/2^16)+1 for every
        # min_state_plus in [1, 2^15] — i.e. all of table_log <= 14 — but
        # underflows u32 at table_log 15 (min_state_plus > 2^15 makes
        # (bits_out<<16) - bits negative, a panic in Rust). floor+1 is the
        # intent-true form, identical through L=14 and well-defined at 15.
        bits_out = (bits >> 16) + 1
        self.value = ((bits_out << 16) - bits) & U32
        idx = (self.value >> bits_out) + int(table.tt_find_state[first_symbol])
        self.value = int(table.table[idx])
        return self

    def encode(self, writer: BitStackWriter, sym: int) -> None:
        """Emit one symbol (reference: src/fse.rs:227-239)."""
        bits = int(self.table.tt_bits[sym])
        bits_out = ((bits + self.value) & U32) >> 16
        writer.write_bits(self.value, bits_out)
        idx = (self.value >> bits_out) + int(self.table.tt_find_state[sym])
        self.value = int(self.table.table[idx])

    def encode_raw(self, writer: BitStackWriter, sym: int) -> None:
        """The reference's unchecked-flush variant (src/fse.rs:227-239);
        the Python writer flushes internally, so this equals encode."""
        self.encode(writer, sym)

    def finish(self, writer: BitStackWriter) -> None:
        """Append the final state in ``table_log`` bits
        (reference: src/fse.rs:248-250)."""
        writer.write_bits(self.value, self.table.table_log)


class DecodeTable:
    """tANS decoding table (reference: src/fse.rs:253-339).

    Stored as three parallel arrays (symbol, num_bits, new_state) plus a
    packed uint32 form ``packed = symbol<<24 | num_bits<<16 | new_state``
    used by the device kernels so each decode step is a single gather.
    """

    def __init__(self, hist: NormHistogram):
        if not (TABLE_LOG_MIN <= hist.log2 <= TABLE_LOG_MAX):
            raise ValueError("FSE table log2 out of range")
        self.table_log = hist.log2
        size = 1 << self.table_log
        self.size = size

        symbols, _ = spread_symbols(hist)
        counts = hist.table[: hist.table_len].astype(np.int64)

        # fast_mode bookkeeping (unused by the decoder proper but part of
        # the reference's public surface, src/fse.rs:296-309).
        large_limit = 1 << (self.table_log - 1)
        self.fast_mode = not bool((counts >= large_limit).any())

        # symbol_next starts at 1 for low-probability symbols, else count
        # (src/fse.rs:298-310); each slot in order bumps its symbol's
        # counter (src/fse.rs:329-337). Vectorized via stable ranks.
        start = np.where(counts == -1, 1, counts).astype(np.int64)
        start_of = np.zeros(ALPHABET, dtype=np.int64)
        start_of[: hist.table_len] = start

        order = np.argsort(symbols, kind="stable")
        rank = np.empty(size, dtype=np.int64)
        rank[order] = np.arange(size)
        # rank within symbol group = global stable rank - group start
        group_sizes = np.bincount(symbols, minlength=ALPHABET).astype(np.int64)
        group_starts = np.concatenate(([0], np.cumsum(group_sizes)[:-1]))
        within = rank - group_starts[symbols]

        next_state = start_of[symbols] + within
        nb = self.table_log - _ilog2_arr(next_state)
        self.num_bits = nb.astype(np.uint8)
        self.new_state = ((next_state << nb) - size).astype(np.uint16)
        self.symbol = symbols

        self.packed = (
            self.symbol.astype(np.uint32) << 24
            | self.num_bits.astype(np.uint32) << 16
            | self.new_state.astype(np.uint32)
        )


    def update(self, hist: NormHistogram) -> None:
        """Rebuild for a new histogram (reference: src/fse.rs:280)."""
        self.__init__(hist)


def _ilog2_arr(x: np.ndarray) -> np.ndarray:
    """Elementwise floor(log2(x)) for int64 arrays with values in
    [1, 2**16], exactly (integer bit tests, no float rounding)."""
    out = np.zeros_like(x)
    for k in range(1, 17):
        out += x >= (1 << k)
    return out


class Decoder:
    """Single tANS decode state machine (reference: src/fse.rs:341-386)."""

    def __init__(self, table: DecodeTable, reader: BitStackReader):
        state = reader.read(table.table_log)
        if state is None:
            raise ValueError("not enough bits to initialize decoder")
        self.state = state
        self.table = table

    def decode_symbol(self, reader: BitStackReader) -> int | None:
        nb = int(self.table.num_bits[self.state])
        low_bits = reader.read(nb)
        if low_bits is None:
            return None
        sym = int(self.table.symbol[self.state])
        self.state = int(self.table.new_state[self.state]) + low_bits
        return sym

    def decode_symbol_no_reload(self, reader: BitStackReader) -> int | None:
        """The reference's no-reload variant (src/fse.rs:363-373); the
        Python reader has no reload distinction, so this equals
        decode_symbol."""
        return self.decode_symbol(reader)

    def finish(self) -> int:
        """Final symbol held in the terminal state
        (reference: src/fse.rs:383-385)."""
        return int(self.table.symbol[self.state])
