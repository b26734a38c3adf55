"""Device-side lane-stream repack (measured alternative to the host merge).

The wire format concatenates k per-lane bit streams (byte- or
bit-aligned); the kernels want the padded ``(W, k)`` word-column layout.
That repack ships on the HOST (C++ OpenMP ``lane_merge_batch`` /
``lane_split_batch``). The encoder of the shared-stream path already
does variable-length bit packing as a prefix-sum scatter-add
(ops/coder.py:110-120), so the same formulation applied to whole lane
WORDS is the device-side candidate:

* merge: every lane word ``words[j, i]`` (32 bits, last word masked)
  lands at bit offset ``lane_off[i] + 32*j`` of the packed stream — two
  32-bit scatter-adds (lo/hi spill) at exact prefix-sum offsets, so
  adds never carry (disjoint bit ranges);
* split: the inverse is two gathers at the same offsets plus a
  shift-combine.

Both are word-granular (32-bit pieces), not byte-granular. The frame
path does not use this module: its speed on the GPU is not measured,
and the host repack stays until it is (ROADMAP, reach item 3). Its
byte-exactness is pinned on the CPU by tests/test_device_repack.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _masked_words(words, sizes, W):
    """(W, k) words with each lane's bits above ``sizes`` zeroed (the
    padded layout guarantees whole words above the last are zero, but
    the last partial word may carry kernel guard bits)."""
    j = jnp.arange(W, dtype=jnp.int32)[:, None]
    rem = sizes[None, :] - (j << 5)  # bits of this word still in-stream
    full = rem >= 32
    mask = jnp.where(full, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << jnp.clip(rem, 0, 31).astype(
                         jnp.uint32)) - jnp.uint32(1))
    return words & mask, rem


@functools.partial(jax.jit, static_argnames=("W", "OW"))
def merge_bits_device(words, sizes, *, W, OW):
    """Bit-pack k lane streams on device: ``words (W, k) uint32`` +
    ``sizes (k,) int32`` -> ``(OW,) uint32`` packed stream (lane i at bit
    offset ``cumsum(sizes)[:i]``, LSB-first — byte-identical to
    ``pl_coder.lane_merge_bits``). ``OW`` >= total_words + 1."""
    k = sizes.shape[0]
    v, rem = _masked_words(words, sizes, W)
    off_lane = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(sizes)[:-1]])
    j = jnp.arange(W, dtype=jnp.int32)[:, None]
    off = off_lane[None, :] + (j << 5)
    valid = rem > 0
    d = jnp.where(valid, off >> 5, OW + 1)  # OOB -> dropped
    b = (off & 31).astype(jnp.uint32)
    lo = v << b
    hi = (v >> 1) >> (jnp.uint32(31) - b)
    out = jnp.zeros((OW,), jnp.uint32)
    out = out.at[d.ravel()].add(lo.ravel(), mode="drop")
    out = out.at[(d + 1).ravel()].add(hi.ravel(), mode="drop")
    return out


@functools.partial(jax.jit, static_argnames=("W",))
def split_bits_device(packed, sizes, *, W):
    """Inverse of ``merge_bits_device``: gather each lane's words out of
    the packed stream into the padded ``(W, k)`` layout."""
    off_lane = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(sizes)[:-1]])
    j = jnp.arange(W, dtype=jnp.int32)[:, None]
    off = off_lane[None, :] + (j << 5)
    d = off >> 5
    b = (off & 31).astype(jnp.uint32)
    pad = jnp.concatenate([packed, jnp.zeros(2, jnp.uint32)])
    lo = pad[d] >> b
    hi = (pad[d + 1] << 1) << (jnp.uint32(31) - b)
    w = lo | hi
    wm, _ = _masked_words(w, sizes, W)
    return wm


def merge_bits_np(words: np.ndarray, sizes: np.ndarray) -> bytes:
    """Host-run reference wrapper used by the tests (same bytes as
    pl_coder.lane_merge_bits)."""
    from .pl_coder import lane_merge_bits

    return lane_merge_bits(words, sizes)
