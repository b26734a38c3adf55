"""Shared-stream path: k-way interleaved tANS encode/decode in XLA.

The reference's hot loops are serial state machines (reference:
src/lib.rs:127-138,198-207). The data-parallel inversion: k interleaved streams share
one bitstream (the reference's own k=2 scheme, src/lib.rs:146-248,
generalized — see ``spec.codec``), and because all k lane states are known
simultaneously at every round, per-lane bit counts are known and an
exclusive prefix sum yields every lane's bit offset. One ``lax.scan`` step
per *round* (k symbols), fully vectorized across lanes:

* encode round: ``bits_out = (tt.bits + state) >> 16`` per lane (u32),
  emit ``state & mask(bits_out)``, gather next state — then one
  prefix-sum + scatter-add packs all emissions into u32 words
  (reference per-symbol semantics: src/fse.rs:227-239).
* decode round: gather packed transforms for all lanes, prefix-sum the
  ``num_bits``, extract each lane's bits from the shared word array,
  update states (reference per-symbol semantics: src/fse.rs:363-373).

Bit-exactness against ``entropy_coders_tpu.spec`` (and hence the reference
wire format for k=1,2) is enforced by tests/test_ops_coder.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

U32_ONE = np.uint32(1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _exclusive_cumsum(x):
    return jnp.cumsum(x) - x


def _extract_bits(words, start, width):
    """Extract ``width`` (<=16) bits starting at bit ``start`` from a
    little-endian u32 word array. Vectorized over ``start``/``width``.
    ``words`` must have >= 2 guard words of zero padding at the end."""
    start = jnp.maximum(start, 0)
    w = start >> 5
    b = (start & 31).astype(jnp.uint32)
    lo = words[w] >> b
    # (x << 1) << (31 - b) == x << (32 - b), but well-defined at b == 0.
    hi = (words[w + 1] << 1) << (np.uint32(31) - b)
    m = (U32_ONE << width.astype(jnp.uint32)) - U32_ONE
    return (lo | hi) & m


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "L", "W"))
def _encode_core(
    syms_rk,      # (R, k) uint8 symbols in emission order (descending index)
    valid_rk,     # (R, k) bool
    init_syms,    # (k,) uint8 — slot t holds byte n-1-t (its lane's first symbol)
    finish_slots, # (k,) int32 — slot order for the final-state writes (lane k-1..0)
    tt_bits,      # (256,) uint32 symbol-transform bits
    tt_fs,        # (256,) int32 symbol-transform find_state
    table,        # (size,) uint16 next-state table
    *,
    k: int,
    L: int,
    W: int,
):
    table_u32 = table.astype(jnp.uint32)

    # new_first_symbol for every lane (reference: src/fse.rs:210-218).
    # floor+1 instead of the reference's (b0 + 2^15) >> 16: identical for
    # table_log <= 14, and well-defined at 15 where the reference's form
    # underflows u32 (see spec.fse.Encoder.new_first_symbol).
    b0 = tt_bits[init_syms]
    bits_out0 = (b0 >> 16) + np.uint32(1)
    value0 = (bits_out0 << 16) - b0
    idx0 = (value0 >> bits_out0).astype(jnp.int32) + tt_fs[init_syms]
    states = table_u32[idx0]

    def round_fn(states, xs):
        syms, valid = xs
        tb = tt_bits[syms]
        bits_out = (tb + states) >> 16
        emit_bits = jnp.where(valid, bits_out, np.uint32(0))
        # padding slots must contribute zero VALUE too, not just zero width —
        # a nonzero value at a 0-bit offset would corrupt the scatter-add pack.
        emit_vals = jnp.where(valid, states & ((U32_ONE << bits_out) - U32_ONE),
                              np.uint32(0))
        idx = (states >> bits_out).astype(jnp.int32) + tt_fs[syms]
        new_states = table_u32[idx]
        states = jnp.where(valid, new_states, states)
        return states, (emit_vals, emit_bits)

    states, (vals, bits) = lax.scan(round_fn, states, (syms_rk, valid_rk))

    # Stream close: final states of lanes k-1..0, then the marker bit
    # (reference: src/lib.rs:178-182).
    mask_L = np.uint32((1 << L) - 1)
    fin_vals = states[finish_slots] & mask_L
    fin_bits = jnp.full((k,), L, dtype=jnp.uint32)

    all_vals = jnp.concatenate([vals.reshape(-1), fin_vals, jnp.array([1], jnp.uint32)])
    all_bits = jnp.concatenate([bits.reshape(-1), fin_bits, jnp.array([1], jnp.uint32)])

    offs = _exclusive_cumsum(all_bits)
    total_bits = offs[-1] + all_bits[-1]
    w = (offs >> 5).astype(jnp.int32)
    b = (offs & 31).astype(jnp.uint32)
    lo = all_vals << b
    hi = (all_vals >> 1) >> (np.uint32(31) - b)
    words = jnp.zeros((W,), jnp.uint32).at[w].add(lo).at[w + 1].add(hi)
    return words, total_bits


def encode_interleaved(data: np.ndarray, k: int, enc_table, table_log: int,
                       core=None):
    """Encode ``data`` (uint8 array, len >= max(k,2)) with ``k`` interleaved
    streams. Returns ``(payload_bytes, payload_bits)`` — byte-identical to
    ``spec.codec.fse_compress``'s payload (header excluded). ``core``
    substitutes the jitted compute core (utils.checked sanitizer mode)."""
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    m = n - k
    R = max(_cdiv(m, k), 1)
    L = int(table_log)

    rev = data[:m][::-1]
    pad = R * k - m
    syms = np.concatenate([rev, np.zeros(pad, np.uint8)]).reshape(R, k)
    valid = (np.arange(R * k) < m).reshape(R, k)
    init_syms = data[n - k :][::-1].copy()  # slot t = byte n-1-t
    finish_slots = np.array([(n - 1 - s) % k for s in range(k - 1, -1, -1)], np.int32)

    W = _cdiv((R * k + k) * 16 + 32, 32) + 2
    words, total_bits = (core or _encode_core)(
        jnp.asarray(syms),
        jnp.asarray(valid),
        jnp.asarray(init_syms),
        jnp.asarray(finish_slots),
        jnp.asarray(enc_table.tt_bits),
        jnp.asarray(enc_table.tt_find_state),
        jnp.asarray(enc_table.table),
        k=k,
        L=L,
        W=W,
    )
    total_bits = int(total_bits)
    nbytes = (total_bits + 7) // 8
    payload = np.asarray(words).view(np.uint8)[:nbytes].tobytes()
    return payload, total_bits


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "L", "R"))
def _decode_core(words, total_bits, packed, *, k: int, L: int, R: int):
    lanes = jnp.arange(k, dtype=jnp.int32)

    # Decoder init, lane 0 first (reference: src/lib.rs:224-225 via
    # src/fse.rs:349-352): lane s reads L bits at [c - (s+1)L, c - sL).
    starts = total_bits - (lanes + 1) * L
    states = _extract_bits(words, starts, jnp.full((k,), L, jnp.int32)).astype(jnp.int32)
    c0 = total_bits - k * L

    def round_fn(carry, _):
        states, c, done, fail_lane, emit_count = carry
        pk = packed[states]
        sym = (pk >> 24).astype(jnp.uint8)
        nb = ((pk >> 16) & np.uint32(0xFF)).astype(jnp.int32)
        base = (pk & np.uint32(0xFFFF)).astype(jnp.int32)

        nb_eff = jnp.where(done, 0, nb)
        ex = _exclusive_cumsum(nb_eff)
        alive = jnp.logical_and(jnp.logical_not(done), ex + nb_eff <= c)
        start = c - ex - nb_eff
        low = _extract_bits(words, start, nb_eff).astype(jnp.int32)
        states = jnp.where(alive, base + low, states)
        c = c - jnp.sum(jnp.where(alive, nb_eff, 0))

        any_fail = jnp.logical_not(alive.all())
        first_fail = jnp.argmin(alive).astype(jnp.int32)
        fail_lane = jnp.where(jnp.logical_or(done, jnp.logical_not(any_fail)),
                              fail_lane, first_fail)
        emit_count = emit_count + jnp.sum(alive)
        done = jnp.logical_or(done, any_fail)
        return (states, c, done, fail_lane, emit_count), (sym, alive)

    init = (states, c0, jnp.array(False), jnp.int32(-1), jnp.int32(0))
    (states, c, done, fail_lane, emit_count), (syms, alive) = lax.scan(
        round_fn, init, None, length=R
    )

    # Pending final-state symbols flush cyclically from the failed lane
    # (reference: src/lib.rs:233-243).
    fin_lanes = (fail_lane + lanes) % k
    finals = (packed[states[fin_lanes]] >> 24).astype(jnp.uint8)
    return syms, emit_count, finals, done, c


def decode_interleaved(payload: bytes, k: int, dec_table, table_log: int,
                       max_out: int, core=None):
    """Decode one k-way interleaved payload (the reversed bit stack after
    the histogram header). Returns the decoded bytes or ``None`` on a
    framing error. ``max_out`` bounds the output (capacity, not exact).
    ``core`` substitutes the jitted compute core (utils.checked)."""
    buf = np.frombuffer(payload, dtype=np.uint8)
    if buf.size == 0:
        return None
    nz = np.flatnonzero(buf)
    if nz.size == 0:
        return None
    last = int(nz[-1])
    marker = last * 8 + int(buf[last]).bit_length() - 1
    if len(buf) * 8 - marker > 8:
        return None  # framing error (src/bitstream/stack_reader.rs:81-83)
    total_bits = marker
    if total_bits < k * table_log:
        return None

    padded = np.zeros(_cdiv(len(buf), 4) * 4 + 8, np.uint8)
    padded[: len(buf)] = buf
    words = jnp.asarray(padded.view(np.uint32))

    L = int(table_log)
    R = max(_cdiv(max_out, k), 1) + 1
    syms, emit_count, finals, done, c = (core or _decode_core)(
        words, jnp.int32(total_bits), jnp.asarray(dec_table.packed),
        k=k, L=L, R=R,
    )
    if not bool(done):
        raise ValueError("decode capacity too small: increase max_out")
    emit_count = int(emit_count)
    flat = np.asarray(syms).reshape(-1)
    return np.concatenate([flat[:emit_count], np.asarray(finals)]).tobytes()
