"""Multi-chip block-parallel compression over a ``jax.sharding.Mesh``.

The reference is single-threaded (SURVEY.md §2: no DP/TP/collectives);
the scaling story is data parallelism over independent blocks:

* blocks shard over the mesh's ``blocks`` axis; histogram, table build,
  encode and decode are per-block, so XLA partitions the batched kernels
  with zero cross-chip communication in the coding itself;
* shared-table mode reduces per-block histograms with one ``psum``-style
  all-reduce over the block axis (NCCL on GPUs) and broadcasts one
  table.

Host gather of the variable-length compressed sections is the ordered
all-gather: device results come back as padded (B, W) words + lengths and
the host assembles the frame in block order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import frame as F


def default_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices, axis ``blocks``."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("blocks",))


def block_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("blocks"))


def compress(data, mesh: Mesh | None = None, **kwargs) -> bytes:
    """Frame-compress ``data`` with blocks sharded over ``mesh``."""
    mesh = mesh or default_mesh()
    return F.compress(data, sharding=block_sharding(mesh), **kwargs)


def decompress(frame: bytes, mesh: Mesh | None = None, **kwargs) -> bytes:
    """Decompress with blocks sharded over ``mesh``. Accepts every
    single-chip keyword (``interpret``, ``start``/``length`` range
    decode, ...) and passes it through."""
    mesh = mesh or default_mesh()
    return F.decompress(frame, sharding=block_sharding(mesh), **kwargs)


def sharded_histogram(blocks, mesh: Mesh):
    """All-device histogram with an all-reduce over the block axis:
    per-block counts then a cross-block sum (XLA inserts the collective).
    Returns (256,) uint32 counts replicated on every device."""
    from ..ops.histogram import histogram_blocks

    sh = block_sharding(mesh)
    blocks = jax.device_put(np.asarray(blocks, np.uint8), sh)

    @jax.jit
    def hist_allreduce(b):
        per_block = histogram_blocks(b).astype(jnp.uint32)
        return jnp.sum(per_block, axis=0)  # all-reduce over sharded axis

    return hist_allreduce(blocks)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, **kwargs) -> None:
    """Initialize the multi-host runtime — see ``parallel.multihost``
    for the full per-host compress/assemble/decompress pipeline (tested
    with two real JAX processes in tests/test_multihost.py)."""
    from .multihost import init_distributed as _init

    _init(coordinator_address, num_processes, process_id, **kwargs)
