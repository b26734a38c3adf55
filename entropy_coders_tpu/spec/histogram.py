"""Executable specification of histogram building, normalization, and the
zstd-format table-description header.

Semantics follow the reference exactly (reference: src/histogram.rs) so
that compressed frames are byte-identical:

* :class:`Histogram` — raw byte counts (src/histogram.rs:10-91).
* :meth:`Histogram.normalize` — fixed-point rescale to ``2**log2`` with the
  ``RTB_TABLE`` rounding correction, the ``-1`` low-probability sentinel,
  remainder dumped on the largest symbol, and the multi-round
  ``normalize_slow`` fallback (src/histogram.rs:93-261).
* :class:`NormHistogram` — the normalized table plus the variable-bit-width
  zstd header writer/reader (src/histogram.rs:290-505).

Normalization is O(256) integer work per block — metadata, not a hot path —
so it runs on the host with exact Python/numpy integer arithmetic. The hot
counting loop has a device form in ``entropy_coders_tpu.ops.histogram``; this
module's count is the numpy oracle for it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    ALPHABET,
    TABLE_LOG_DEFAULT,
    TABLE_LOG_MAX,
    TABLE_LOG_MIN,
    ilog2,
)
from .bitstream import BitStackWriter, BitStreamReader

# Rounding-correction thresholds for probabilities < 8
# (reference: src/histogram.rs:100).
RTB_TABLE = (0, 473195, 504333, 520860, 550000, 700000, 750000, 830000)


class HistError(ValueError):
    """Malformed histogram header (reference: src/histogram.rs:538-546)."""


class TableLogTooLarge(HistError):
    """``HistError::TableLogTooLarge`` (reference: src/histogram.rs:540)."""


class TooManySymbols(HistError):
    """``HistError::TooManySymbols`` (reference: src/histogram.rs:542)."""


class HeaderIo(HistError):
    """``HistError::Io`` — the header bit reader ran out of input
    (reference: src/histogram.rs:544-545)."""


def _table_len_of(table) -> int:
    """1 + index of the last nonzero entry; 1 if all zero
    (reference: src/histogram.rs:52-59)."""
    nz = np.flatnonzero(np.asarray(table))
    return int(nz[-1]) + 1 if nz.size else 1


class Histogram:
    """Byte-frequency counts over a buffer of < 4 GiB
    (reference: src/histogram.rs:10-91)."""

    def __init__(self, data) -> None:
        data = np.asarray(bytearray(data) if isinstance(data, (bytes, bytearray)) else data)
        data = data.astype(np.uint8, copy=False)
        if data.size > 0xFFFF_FFFF:
            raise ValueError("Data vector is too long")
        self.table = np.bincount(data, minlength=ALPHABET).astype(np.uint32)
        self.size = int(data.size)
        self.table_len = _table_len_of(self.table)

    @classmethod
    def from_counts(cls, counts, size: int | None = None) -> "Histogram":
        # uint64: normalize() itself computes in Python ints, and
        # aggregated histograms (multi-host shared tables over > 4 GiB
        # total input) legitimately exceed u32 per-symbol counts even
        # though a single in-memory buffer never does
        self = cls.__new__(cls)
        self.table = np.asarray(counts, dtype=np.uint64).copy()
        assert self.table.shape == (ALPHABET,)
        self.size = int(self.table.sum()) if size is None else size
        self.table_len = _table_len_of(self.table)
        return self

    def table_iter(self):
        """Iterate the counts up to ``table_len``
        (reference: src/histogram.rs:37-43)."""
        return iter(self.table[: self.table_len])

    def symbol_count(self) -> int:
        """Number of distinct symbols present. NOTE: the reference's
        ``symbol_count`` counts symbols with count == 0 despite its doc
        (an apparent bug, never called in the crate —
        reference: src/histogram.rs:79-81); this returns the documented
        semantics instead."""
        return int(np.count_nonzero(self.table))

    def optimal_log2(self) -> int:
        """Best table log2 for this distribution
        (reference: src/histogram.rs:264-277)."""
        min_bits_src = ilog2(self.size) + 1
        min_bits_symbols = ilog2(self.table_len - 1) + 2
        min_bits = min(min_bits_src, min_bits_symbols)
        max_bits = ilog2(self.size - 1) - 2
        if max_bits < 0:
            raise ValueError("input too small to normalize")
        v = min(TABLE_LOG_DEFAULT, max_bits)
        v = max(v, min_bits)
        return min(max(v, TABLE_LOG_MIN), TABLE_LOG_MAX)

    def normalize(self, log2: int) -> "NormHistogram":
        """Rescale counts to sum exactly to ``2**log2``
        (reference: src/histogram.rs:93-155)."""
        log2 = min(max(log2, TABLE_LOG_MIN), TABLE_LOG_MAX)
        log2 = max(log2, ilog2(self.table_len - 1) + 2)

        scale = 62 - log2
        step = (1 << 62) // self.size
        v_step = 1 << (scale - 20)
        low_threshold = self.size >> log2
        to_distribute = 1 << log2
        largest = 0
        largest_prob = 0

        table = [0] * ALPHABET
        for i in range(self.table_len):
            t = int(self.table[i])
            if t == self.size:
                # Single-symbol degenerate distribution takes the whole
                # table and returns early (src/histogram.rs:113-120).
                table[i] = to_distribute
                return NormHistogram(np.array(table, np.int32), log2, self.table_len)
            if t == 0:
                continue
            if t <= low_threshold:
                table[i] = -1
                to_distribute -= 1
                continue
            prob = (t * step) >> scale
            if prob < 8:
                rest_to_beat = v_step * RTB_TABLE[prob]
                prob += int(t * step - (prob << scale) > rest_to_beat)
            if prob > largest_prob:
                largest_prob = prob
                largest = i
            table[i] = prob
            to_distribute -= prob

        if to_distribute != 0 and -to_distribute >= (largest_prob >> 1):
            return self._normalize_slow(log2)
        table[largest] += to_distribute
        return NormHistogram(np.array(table, np.int32), log2, self.table_len)

    def _normalize_slow(self, log2: int) -> "NormHistogram":
        """Fallback for skewed distributions
        (reference: src/histogram.rs:157-261)."""
        UNASSIGNED = -2
        low_threshold = self.size >> log2
        low_one = (self.size * 3) >> (log2 + 1)
        table = [0] * ALPHABET
        to_distribute = 1 << log2
        total = self.size

        for i in range(self.table_len):
            t = int(self.table[i])
            if t == 0:
                continue
            elif t <= low_threshold:
                table[i] = -1
                to_distribute -= 1
                total -= t
            elif t <= low_one:
                table[i] = 1
                to_distribute -= 1
                total -= t
            else:
                table[i] = UNASSIGNED

        if to_distribute == 0:
            return NormHistogram(np.array(table, np.int32), log2, self.table_len)

        if total // to_distribute > low_one:
            low = (total * 3) // (to_distribute * 2)
            for i in range(self.table_len):
                t = int(self.table[i])
                if table[i] == UNASSIGNED and t <= low:
                    table[i] = 1
                    to_distribute -= 1
                    total -= t

        if (1 << log2) - to_distribute == self.table_len:
            # Functionally incompressible: hand the remainder to the most
            # frequent symbol (src/histogram.rs:203-220).
            i_max = int(np.argmax(self.table))
            table[i_max] += to_distribute
            return NormHistogram(np.array(table, np.int32), log2, self.table_len)
        elif total == 0:
            # Spread the remainder evenly over already-assigned symbols
            # (src/histogram.rs:221-235).
            while to_distribute != 0:
                for i in range(self.table_len):
                    if table[i] > 0:
                        table[i] += 1
                        to_distribute -= 1
                        if to_distribute == 0:
                            break
        else:
            # Fixed-point weighted spread (src/histogram.rs:236-254).
            v_step_log = 62 - log2
            mid = (1 << (v_step_log - 1)) - 1
            r_step = ((1 << v_step_log) * to_distribute + mid) // total
            tmp_total = mid
            for i in range(self.table_len):
                t = int(self.table[i])
                if table[i] == UNASSIGNED:
                    end = tmp_total + t * r_step
                    weight = (end >> v_step_log) - (tmp_total >> v_step_log)
                    if weight < 1:
                        raise ValueError("distribution too skewed to normalize")
                    table[i] = weight
                    tmp_total = end

        return NormHistogram(np.array(table, np.int32), log2, self.table_len)

    def normalize_optimal(self) -> "NormHistogram":
        return self.normalize(self.optimal_log2())


@dataclass
class NormHistogram:
    """Normalized counts summing to ``2**log2``; ``-1`` marks a
    low-probability symbol costing one table slot
    (reference: src/histogram.rs:290-294)."""

    table: np.ndarray  # (256,) int32
    log2: int
    table_len: int

    def __post_init__(self):
        self.table = np.asarray(self.table, dtype=np.int32)
        assert self.table.shape == (ALPHABET,)

    @classmethod
    def new(cls, data) -> "NormHistogram":
        hist = Histogram(data)
        return hist.normalize(hist.optimal_log2())

    @classmethod
    def try_from(cls, table) -> "NormHistogram":
        """Validate a raw table: |entries| must sum to a power of two
        (reference: src/histogram.rs:508-536)."""
        table = np.asarray(table, dtype=np.int32)
        s = int(np.abs(table.astype(np.int64)).sum())
        if s <= 0 or (1 << ilog2(s)) != s:
            raise ValueError("table does not sum to a power of two")
        return cls(table, ilog2(s), _table_len_of(table))

    def table_iter(self):
        """Iterate the normalized counts up to ``table_len``
        (reference: src/histogram.rs:311-317)."""
        return iter(self.table[: self.table_len])

    def symbol_count(self) -> int:
        """Distinct symbols present (documented semantics; the
        reference's copy has the same ==0 bug as Histogram's —
        reference: src/histogram.rs:321-323)."""
        return int(np.count_nonzero(self.table))

    def log2_sum(self) -> int:
        return self.log2

    def write_bound(self) -> int:
        """Max header size in bytes (reference: src/histogram.rs:330-337)."""
        max_header_size = ((self.table_len * self.log2) >> 3) + 3
        return max_header_size if self.table_len > 1 else 512

    def write(self, out: bytearray) -> int:
        """Append the zstd FSE table-description header; returns bits
        written (format documented at reference src/histogram.rs:342-375,
        loop at 376-431)."""
        writer = BitStackWriter(out)
        writer.write_bits(self.log2 - TABLE_LOG_MIN, 4)

        threshold = 1 << self.log2
        remaining = threshold + 1
        zero_count = 0
        num_bits = self.log2 + 1
        for idx in range(self.table_len):
            if remaining <= 1:
                break
            s = int(self.table[idx])
            if zero_count != 0:
                if s == 0:
                    zero_count += 1
                    continue
                # 2-bit repeat markers for a run of zeros
                # (src/histogram.rs:399-408).
                zero_count -= 1
                while zero_count >= 24:
                    writer.write_bits(0xFFFF, 16)
                    zero_count -= 24
                while zero_count >= 3:
                    writer.write_bits(0x3, 2)
                    zero_count -= 3
                writer.write_bits(zero_count, 2)
            max_ = (2 * threshold - 1) - remaining
            remaining -= -s if s < 0 else s
            count = s + 1
            if count >= threshold:
                count += max_
            bits_to_write = num_bits - (1 if count < max_ else 0)
            writer.write_bits(count, bits_to_write)
            zero_count = 1 if count == 1 else 0
            if remaining < 1:
                raise AssertionError("Normalized histogram was incorrect somehow")
            while remaining < threshold:
                num_bits -= 1
                threshold >>= 1

        return writer.finish()

    @classmethod
    def read(cls, data: bytes) -> tuple["NormHistogram", bytes]:
        """Parse a header written by :meth:`write`; returns the histogram and
        the remaining byte-aligned slice (reference: src/histogram.rs:436-505)."""
        if len(data) == 0:
            raise HeaderIo("empty histogram header")
        reader = BitStreamReader(data, len(data) * 8)
        try:
            log2 = reader.read(4) + TABLE_LOG_MIN
            if log2 > TABLE_LOG_MAX:
                raise TableLogTooLarge(f"table log2 {log2} above maximum")
            table = np.zeros(ALPHABET, dtype=np.int32)
            symbol = 0
            threshold = 1 << log2
            remaining = threshold + 1
            read_bit_count = log2 + 1
            previous0 = False

            while remaining > 1 and symbol < ALPHABET:
                if previous0:
                    while _peek_or_zero(reader, 16) == 0xFFFF:
                        reader.advance_by(16)
                        symbol += 24
                    while _peek_or_zero(reader, 2) == 3:
                        reader.advance_by(2)
                        symbol += 3
                    symbol += reader.read(2)
                if symbol >= ALPHABET:
                    break

                max_ = (2 * threshold - 1) - remaining
                try:
                    raw_value = reader.peek(read_bit_count)
                except EOFError:
                    raw_value = reader.peek(read_bit_count - 1)
                if (raw_value & (threshold - 1)) < max_:
                    reader.advance_by(read_bit_count - 1)
                    value = raw_value & (threshold - 1)
                else:
                    reader.advance_by(read_bit_count)
                    value = raw_value & (2 * threshold - 1)
                    if value >= threshold:
                        value -= max_
                value -= 1
                remaining -= -value if value < 0 else value
                table[symbol] = value
                symbol += 1
                previous0 = value == 0
                while remaining < threshold:
                    read_bit_count -= 1
                    threshold >>= 1
        except EOFError as e:
            raise HeaderIo("truncated histogram header") from e

        if remaining != 1:
            raise TooManySymbols(
                    "histogram counts spread across more than 256 symbols")

        return cls(table, log2, symbol), reader.finish_byte()


def _peek_or_zero(reader: BitStreamReader, bits: int) -> int:
    """Reference's ``peek(..).unwrap_or(0)`` (src/histogram.rs:456-461)."""
    try:
        return reader.peek(bits)
    except EOFError:
        return 0
