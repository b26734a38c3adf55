"""Device-side lane repack (ops.device_repack) — byte-exactness vs the
host merge/split (the device-side alternative, not on the frame
path)."""

import numpy as np
import pytest

from entropy_coders_tpu.ops import device_repack as DR
from entropy_coders_tpu.ops.pl_coder import lane_merge_bits, lane_split_bits


def _rand_lanes(rng, k, lo, hi):
    sizes = rng.integers(lo, hi, k).astype(np.int32)
    W = int((sizes.max() + 31) // 32) + 2
    words = np.zeros((W, k), np.uint32)
    for i in range(k):
        nw = (int(sizes[i]) + 31) // 32
        words[:nw, i] = rng.integers(0, 1 << 32, nw, dtype=np.uint32)
        top = int(sizes[i]) & 31
        if top:
            words[nw - 1, i] &= (1 << top) - 1
    return words, sizes, W


@pytest.mark.parametrize("k,lo,hi", [(128, 8, 200), (256, 9, 3000),
                                     (512, 33, 64)])
def test_merge_split_device_matches_host(rng, k, lo, hi):
    words, sizes, W = _rand_lanes(rng, k, lo, hi)
    ref = lane_merge_bits(words, sizes)
    total = int(sizes.sum())
    OW = (total + 31) // 32 + 1
    got = np.asarray(DR.merge_bits_device(words, sizes, W=W, OW=OW))
    assert got.tobytes()[: (total + 7) // 8] == ref
    back = np.asarray(DR.split_bits_device(got, sizes, W=W))
    assert np.array_equal(back, words)
    # and the packed wire splits back through the host path identically
    w2, W2 = lane_split_bits(ref, sizes, k)
    assert np.array_equal(w2, words[:W2])


def test_zero_size_lanes(rng):
    # lanes of exactly L bits next to much longer ones (min real lane is
    # L bits: the final-state emission)
    words, sizes, W = _rand_lanes(rng, 128, 5, 6)
    ref = lane_merge_bits(words, sizes)
    OW = (int(sizes.sum()) + 31) // 32 + 1
    got = np.asarray(DR.merge_bits_device(words, sizes, W=W, OW=OW))
    assert got.tobytes()[: (int(sizes.sum()) + 7) // 8] == ref
