"""Multi-chip / multi-host parallelism (jax.sharding over device meshes)."""

from . import multihost
from .sharding import (block_sharding, compress, decompress, default_mesh,
                       init_distributed, sharded_histogram)

__all__ = [
    "block_sharding",
    "compress",
    "decompress",
    "default_mesh",
    "init_distributed",
    "multihost",
    "sharded_histogram",
]
