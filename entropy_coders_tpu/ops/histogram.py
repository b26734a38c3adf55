"""Device-side byte histogram.

The reference's hot counting loop uses 4 ILP sub-tables
(reference: src/histogram.rs:18-66). Here it is one XLA scatter-add per
block, ``zeros(256).at[data].add(1)``, which XLA lowers to atomic adds on
the GPU. Atomics contend when many updates share a block's 256 bins:
128 MiB took 30.4 ms in 16 MiB blocks against 6.9 ms in 128 KiB blocks
(H100 80GB HBM3, 700 W). So a block is counted as sub-blocks of at most
``SUB`` bytes whose counts are summed, which puts every block size on
the fast shape. PERF.md holds the measurement against the 256-pass
masked-sum form this replaced.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import ALPHABET

SUB = 1 << 17  # bytes per sub-block histogram


@jax.jit
def histogram_blocks(data_blocks):
    """(B, n) uint8 -> (B, 256) uint32 per-block counts."""
    data_blocks = jnp.asarray(data_blocks)
    B, n = data_blocks.shape
    m = n // SUB if n % SUB == 0 else 1
    sub = data_blocks.reshape(B * m, n // m).astype(jnp.int32)
    counts = jax.vmap(
        lambda d: jnp.zeros((ALPHABET,), jnp.int32).at[d].add(1))(sub)
    return counts.reshape(B, m, ALPHABET).sum(axis=1).astype(jnp.uint32)


def histogram_u8(data):
    """(n,) uint8 -> (256,) uint32."""
    return histogram_blocks(jnp.asarray(data)[None])[0]
