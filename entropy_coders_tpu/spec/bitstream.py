"""Executable specification of the three bit-I/O primitives.

These are *semantic* re-implementations of the reference's bitstream layer
(reference: src/bitstream/{writer.rs,stack_reader.rs,stream_reader.rs}),
used as the host-side oracle and for the (tiny) histogram-header
serialization path. The reference's pointer arithmetic, half-word flushes
and alignment tricks are CPU micro-optimizations of one simple model:

* ``BitStackWriter``  — append fields LSB-first into one growing bit
  accumulator; serialize little-endian; ``finish`` pads to a whole byte
  (reference: src/bitstream/writer.rs:177-178,201-222).
* ``BitStackReader``  — read that accumulator *backwards* (LIFO), entering
  at a terminal marker bit that must sit in the final byte
  (reference: src/bitstream/stack_reader.rs:74-90,176-197).
* ``BitStreamReader`` — read it *forwards* (FIFO) with exact framing
  (reference: src/bitstream/stream_reader.rs:16-114).

The device compute path does not use these classes; it uses the vectorized
pack/unpack kernels in ``entropy_coders_tpu.ops``. Equality between the two
is enforced by the property tests in ``tests/test_bitstream.py``.
"""

from __future__ import annotations

from ..constants import mask


class BitStackWriter:
    """LIFO bit writer appending to a ``bytearray``.

    Sequential LSB-first appends; ``finish`` emits ``ceil(bits/8)`` bytes
    little-endian and returns the number of bits written by this writer
    (reference: src/bitstream/writer.rs:201-222 returns
    ``total_bits - initial_len*8``, which is the same quantity).
    """

    def __init__(self, out: bytearray):
        self.out = out
        self.acc = 0
        self.bits = 0
        self._finished = False

    def write_bits(self, val: int, bits: int) -> None:
        """Append the low ``bits`` of ``val`` (masked, like
        ``write_bits_raw_unmasked``; reference: src/bitstream/writer.rs:140-149).
        At most 16 bits per call in the reference; the spec accepts any width
        but the codec only ever writes <=16 (or table_log<=15) at a time."""
        self.acc |= (val & mask(bits)) << self.bits
        self.bits += bits

    def write_bits_unmasked(self, val: int, bits: int) -> None:
        """The reference's variant whose caller guarantees val < 2^bits
        (src/bitstream/writer.rs:151-160); Python masks anyway."""
        self.write_bits(val, bits)

    def write_bits_raw(self, val: int, bits: int) -> None:
        """The reference's unsafe no-flush-check variant
        (src/bitstream/writer.rs:162-180); the spec accumulator is an
        unbounded int, so there is no flush contract to violate."""
        self.write_bits(val, bits)

    def write_bits_raw_unmasked(self, val: int, bits: int) -> None:
        """(src/bitstream/writer.rs:140-149)."""
        self.write_bits(val, bits)

    def flush(self) -> None:
        """The reference's explicit accumulator flush
        (src/bitstream/writer.rs:43-110); a no-op here — the unbounded
        accumulator is materialized once in :meth:`finish`."""

    def finish(self) -> int:
        assert not self._finished
        self._finished = True
        nbytes = (self.bits + 7) // 8
        if nbytes:
            self.out += self.acc.to_bytes(nbytes, "little")
        return self.bits


class BitStackReader:
    """Reads a bit stack backwards from the end of ``data``.

    ``new`` locates the terminal marker bit (highest set bit of the buffer)
    and fails — returns ``None`` from :meth:`new` — if the buffer is all
    zero or if more than 7 dead bits follow the marker, i.e. the marker is
    not in the final byte (reference: src/bitstream/stack_reader.rs:74-90).
    """

    def __init__(self, data: bytes, _marker_bits: int):
        self._buf = int.from_bytes(data, "little")
        self.bits = _marker_bits  # readable bits below the marker

    @classmethod
    def new(cls, data: bytes) -> "BitStackReader | None":
        if len(data) == 0:
            return None
        buf = int.from_bytes(data, "little")
        if buf == 0:
            return None
        highbit = buf.bit_length() - 1
        # Reference condition: loaded_bits - highbit > 8 → framing error
        # (src/bitstream/stack_reader.rs:81-83).
        if len(data) * 8 - highbit > 8:
            return None
        return cls(data, highbit)

    def peek(self, bits: int) -> int | None:
        if bits > self.bits:
            return None
        return (self._buf >> (self.bits - bits)) & mask(bits)

    def read(self, bits: int) -> int | None:
        """Pop the top ``bits`` bits (reference:
        src/bitstream/stack_reader.rs:193-215). A 0-bit read succeeds even on
        an empty stack, matching the reference's ``peek(0)`` behavior."""
        val = self.peek(bits)
        if val is None:
            return None
        self.bits -= bits
        return val

    def read_no_reload(self, bits: int) -> int | None:
        """The reference's unsafe no-reload variant
        (src/bitstream/stack_reader.rs:186-203); the spec buffer holds the
        whole stack, so there is no reload distinction."""
        return self.read(bits)

    def advance_no_reload(self, bits: int) -> None:
        """(src/bitstream/stack_reader.rs:205-215)."""
        assert bits <= self.bits
        self.bits -= bits

    def reload(self) -> None:
        """(src/bitstream/stack_reader.rs:97-172); a no-op here."""

    def available(self) -> int:
        return self.bits

    def finish(self) -> bool:
        """True iff the stack was fully drained
        (reference: src/bitstream/stack_reader.rs:224-226)."""
        return self.bits == 0


class BitStreamReader:
    """Forward (FIFO) LSB-first reader with exact bit framing.

    Used only to parse the histogram header (reference:
    src/histogram.rs:437). ``total_bits`` must match ``len(data)`` exactly
    as in the reference's constructor assertion
    (src/bitstream/stream_reader.rs:17-21).
    """

    def __init__(self, data: bytes, total_bits: int):
        if len(data) == 0:
            raise ValueError("No bytes provided to read from")
        if (total_bits + 7) // 8 != len(data):
            raise ValueError("total_bits does not match the slice length")
        self._data = data
        self._buf = int.from_bytes(data, "little")
        self.total_bits = total_bits
        self.bits_read = 0

    def peek(self, bits: int) -> int:
        """Raises ``EOFError`` past the end, mirroring the reference's
        ``UnexpectedEof`` (src/bitstream/stream_reader.rs:82-86)."""
        if self.bits_read + bits > self.total_bits:
            raise EOFError("bitstream exhausted")
        return (self._buf >> self.bits_read) & mask(bits)

    def advance_by(self, bits: int) -> None:
        if self.bits_read + bits > self.total_bits:
            raise EOFError("bitstream exhausted")
        self.bits_read += bits

    def read(self, bits: int) -> int:
        val = self.peek(bits)
        self.advance_by(bits)
        return val

    def available(self) -> int:
        return self.total_bits - self.bits_read

    def finish(self) -> bool:
        """True iff every framed bit was consumed
        (reference: src/bitstream/stream_reader.rs:124-130)."""
        return self.bits_read == self.total_bits

    def finish_byte(self) -> bytes:
        """Round up to the next byte boundary and return the rest of the
        slice (reference: src/bitstream/stream_reader.rs:132-135)."""
        byte = (self.bits_read + 7) // 8
        return self._data[byte:]
