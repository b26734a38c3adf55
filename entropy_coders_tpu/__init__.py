"""entropy_coders_tpu — an FSE (tANS) entropy codec for GPUs in JAX.

A from-scratch JAX/Pallas framework with the capabilities and on-the-wire
format of the reference Rust crate ``entropy_coders`` (FSE/tANS replicating
zstd's encoding scheme), laid out for data-parallel devices:

* ``spec``     — exact host-side executable specification (oracle + header
  serialization).
* ``ops``      — the device compute path: vectorized/jitted histogram,
  table build, and the interleaved and per-lane encode/decode coders.
* ``frame``    — block container for large buffers (multi-block frames).
* ``parallel`` — multi-device sharding over a ``jax.sharding.Mesh``.
* ``native``   — C++ host codec (fast CPU oracle / fallback).
* ``stream``   — bounded-memory file compression (atomic writes).
* ``checkpoint`` — compressed pytree checkpoints with per-tensor
  random-access loads.
"""

from .constants import TABLE_LOG_DEFAULT, TABLE_LOG_MAX, TABLE_LOG_MIN
from .spec import Histogram, NormHistogram
from .spec.codec import (fse_compress, fse_compress2, fse_decompress,
                         fse_decompress2)
from .spec.fse import DecodeTable, Decoder, EncodeTable, Encoder
from .spec.histogram import HeaderIo, HistError, TableLogTooLarge, TooManySymbols

__version__ = "0.1.0"

__all__ = [
    "TABLE_LOG_DEFAULT",
    "TABLE_LOG_MAX",
    "TABLE_LOG_MIN",
    "Histogram",
    "NormHistogram",
    "EncodeTable",
    "Encoder",
    "DecodeTable",
    "Decoder",
    "HistError",
    "TableLogTooLarge",
    "TooManySymbols",
    "HeaderIo",
    "fse_compress",
    "fse_compress2",
    "fse_decompress",
    "fse_decompress2",
    "__version__",
]
