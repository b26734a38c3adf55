"""Device table build and histogram kernels vs the spec oracle."""

import numpy as np
import pytest

from entropy_coders_tpu.ops.histogram import (
    histogram_blocks,
)
from entropy_coders_tpu.ops.tables import (
    build_decode_table,
    build_encode_table,
    spread_symbols_dev,
)
from entropy_coders_tpu.spec.fse import DecodeTable, EncodeTable, spread_symbols
from entropy_coders_tpu.spec.histogram import Histogram, NormHistogram

from conftest import gen_sequence


def norm_of(prob, size, log2=None):
    data = gen_sequence(prob, size)
    h = Histogram(data)
    return h.normalize(log2 if log2 is not None else h.optimal_log2())


@pytest.mark.parametrize("prob", [0.05, 0.2, 0.5, 0.9])
def test_spread_matches_spec(prob):
    norm = norm_of(prob, 1 << 14)
    ref_syms, ref_ht = spread_symbols(norm)
    dev_syms, dev_ht = spread_symbols_dev(norm.table, log2=norm.log2)
    assert int(dev_ht) == ref_ht
    np.testing.assert_array_equal(np.asarray(dev_syms), ref_syms.astype(np.int32))


@pytest.mark.parametrize("prob", [0.05, 0.2, 0.5, 0.9])
@pytest.mark.parametrize("log2", [None, 5, 9, 15])
def test_encode_table_matches_spec(prob, log2):
    norm = norm_of(prob, 1 << 14, log2)
    ref = EncodeTable(norm)
    table, tt_bits, tt_fs = build_encode_table(norm.table, log2=norm.log2)
    np.testing.assert_array_equal(np.asarray(table), ref.table)
    np.testing.assert_array_equal(np.asarray(tt_bits), ref.tt_bits)
    np.testing.assert_array_equal(np.asarray(tt_fs), ref.tt_find_state)


@pytest.mark.parametrize("prob", [0.05, 0.2, 0.5, 0.9])
@pytest.mark.parametrize("log2", [None, 5, 9, 15])
def test_decode_table_matches_spec(prob, log2):
    norm = norm_of(prob, 1 << 14, log2)
    ref = DecodeTable(norm)
    packed = build_decode_table(norm.table, log2=norm.log2)
    np.testing.assert_array_equal(np.asarray(packed), ref.packed)


def test_tables_skewed(rng):
    src = np.where(rng.random(1 << 14) < 0.99, np.uint8(7),
                   rng.integers(0, 256, 1 << 14, dtype=np.uint8)).astype(np.uint8)
    norm = NormHistogram.new(src)
    ref_e, ref_d = EncodeTable(norm), DecodeTable(norm)
    table, tt_bits, tt_fs = build_encode_table(norm.table, log2=norm.log2)
    packed = build_decode_table(norm.table, log2=norm.log2)
    np.testing.assert_array_equal(np.asarray(table), ref_e.table)
    np.testing.assert_array_equal(np.asarray(tt_bits), ref_e.tt_bits)
    np.testing.assert_array_equal(np.asarray(tt_fs), ref_e.tt_find_state)
    np.testing.assert_array_equal(np.asarray(packed), ref_d.packed)


def test_histogram_kernels(rng):
    """The scatter-add histogram agrees with numpy on data whose length
    is and isn't a multiple of 128, and on blocks that split into
    several sub-block histograms."""
    from entropy_coders_tpu.ops.histogram import SUB, histogram_u8

    for n in (1 << 16, 12345, 3 * SUB):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        expected = np.bincount(data, minlength=256).astype(np.uint32)
        np.testing.assert_array_equal(
            np.asarray(histogram_blocks(data[None]))[0], expected)
        np.testing.assert_array_equal(np.asarray(histogram_u8(data)),
                                      expected)


def test_histogram_blocks(rng):
    blocks = rng.integers(0, 256, (8, 4096), dtype=np.uint8)
    expected = np.stack([np.bincount(b, minlength=256) for b in blocks]).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(histogram_blocks(blocks)), expected)
