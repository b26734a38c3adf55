"""Device-side tANS table construction.

The reference builds tables with a serial position-chasing loop
(reference: src/fse.rs:101-189, 280-338). The device formulation is fully
vectorized, no scan:

* the spread's visited positions are the fixed sequence
  ``(j*step) mod size`` (step odd => full cycle); the "skip the
  low-probability area" rule is a filter on that sequence, so the slot
  assignment is a masked scatter;
* the reference's per-slot ``cumul[sym]++`` / ``symbol_next[sym]++``
  counters are stable ranks — one stable argsort over slot symbols
  replaces both;
* symbol transforms are 256-wide elementwise integer ops.

Everything is batchable with ``jax.vmap`` over blocks that share a
``log2`` (the table size is the array dimension, hence static per jit).
Bit-exactness vs ``spec.fse`` is enforced by tests/test_ops_tables.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import ALPHABET


def _ilog2_u32(x):
    """Elementwise floor(log2(x)) for values in [1, 2**16]."""
    out = jnp.zeros_like(x)
    for k in range(1, 17):
        out = out + (x >= (1 << k)).astype(x.dtype)
    return out


def _exclusive_cumsum(x):
    return jnp.cumsum(x) - x


@partial(jax.jit, static_argnames=("log2",))
def spread_symbols_dev(norm_table, *, log2: int):
    """Slot -> symbol map, the common core of both tables
    (reference: src/fse.rs:119-151)."""
    size = 1 << log2
    counts = norm_table.astype(jnp.int32)  # (256,)
    low = counts == -1
    n_low = jnp.sum(low.astype(jnp.int32))
    high_threshold = size - 1 - n_low

    symbols = jnp.zeros((size,), jnp.int32)
    # low-probability symbols walk down from the table top in symbol order
    low_rank = _exclusive_cumsum(low.astype(jnp.int32))
    low_slot = jnp.where(low, size - 1 - low_rank, size)  # size => dropped
    symbols = symbols.at[low_slot].set(
        jnp.arange(ALPHABET, dtype=jnp.int32), mode="drop"
    )

    # run-length decode the spread symbol sequence
    spread_counts = jnp.where(low, 0, jnp.maximum(counts, 0))
    cum = jnp.cumsum(spread_counts)
    ranks = jnp.arange(size, dtype=jnp.int32)
    sym_seq = jnp.searchsorted(cum, ranks, side="right").astype(jnp.int32)

    step = size * 5 // 8 + 3
    positions = (ranks * step) & (size - 1)
    valid = positions <= high_threshold
    rank = _exclusive_cumsum(valid.astype(jnp.int32))
    symbols = symbols.at[jnp.where(valid, positions, size)].set(
        sym_seq[rank], mode="drop"
    )
    return symbols, high_threshold


@partial(jax.jit, static_argnames=("log2",))
def build_encode_table(norm_table, *, log2: int):
    """Returns ``(table u16, tt_bits u32, tt_find_state i32)``
    (reference: src/fse.rs:88-189)."""
    size = 1 << log2
    L = log2
    symbols, _ = spread_symbols_dev(norm_table, log2=log2)

    # next-state table: stable sort of slots by symbol == the reference's
    # cumul[] fill (src/fse.rs:157-162).
    order = jnp.argsort(symbols, stable=True)
    table = (size + order).astype(jnp.uint16)

    counts = norm_table.astype(jnp.int32)
    is_pm1 = jnp.logical_or(counts == -1, counts == 1)
    is_big = counts > 1
    contrib = jnp.where(is_pm1, 1, jnp.where(is_big, counts, 0))
    total_before = _exclusive_cumsum(contrib)

    # count > 1 case (src/fse.rs:178-186)
    mbo = L - _ilog2_u32(jnp.maximum(counts - 1, 1))
    msp = (counts << mbo).astype(jnp.uint32)
    bits_big = ((mbo.astype(jnp.uint32) << 16) - msp).astype(jnp.uint32)
    fs_big = total_before - counts
    # count == ±1 case (src/fse.rs:171-177)
    bits_pm1 = np.uint32((L << 16) - (1 << L))
    fs_pm1 = total_before - 1
    # count == 0 case (src/fse.rs:170)
    bits_zero = np.uint32(((L + 1) << 16) - (1 << L))

    tt_bits = jnp.where(is_big, bits_big,
                        jnp.where(is_pm1, bits_pm1, bits_zero)).astype(jnp.uint32)
    tt_fs = jnp.where(is_big, fs_big,
                      jnp.where(is_pm1, fs_pm1, 0)).astype(jnp.int32)
    # The reference only fills transforms for symbols < table_len
    # (table_iter, src/fse.rs:167); later symbols keep the default (0).
    sym_ids = jnp.arange(ALPHABET, dtype=jnp.int32)
    table_len = jnp.max(jnp.where(counts != 0, sym_ids, -1)) + 1
    in_range = sym_ids < table_len
    tt_bits = jnp.where(in_range, tt_bits, np.uint32(0))
    tt_fs = jnp.where(in_range, tt_fs, 0)
    return table, tt_bits, tt_fs


@partial(jax.jit, static_argnames=("log2",))
def build_decode_table(norm_table, *, log2: int):
    """Returns the packed decode table
    ``symbol<<24 | num_bits<<16 | new_state`` as (size,) u32
    (reference: src/fse.rs:267-338)."""
    size = 1 << log2
    L = log2
    symbols, _ = spread_symbols_dev(norm_table, log2=log2)

    counts = norm_table.astype(jnp.int32)
    start_of = jnp.where(counts == -1, 1, counts)  # (256,)

    order = jnp.argsort(symbols, stable=True)
    inv_rank = jnp.zeros((size,), jnp.int32).at[order].set(
        jnp.arange(size, dtype=jnp.int32)
    )
    group_sizes = jnp.zeros((ALPHABET,), jnp.int32).at[symbols].add(1)
    group_starts = _exclusive_cumsum(group_sizes)
    within = inv_rank - group_starts[symbols]

    next_state = start_of[symbols] + within
    nb = (L - _ilog2_u32(next_state)).astype(jnp.uint32)
    new_state = ((next_state.astype(jnp.uint32) << nb) - size) & np.uint32(0xFFFF)
    packed = (symbols.astype(jnp.uint32) << 24) | (nb << 16) | new_state
    return packed
