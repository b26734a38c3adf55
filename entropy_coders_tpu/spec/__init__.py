"""Host-side executable specification (correctness oracle) of the codec.

Every module here is an exact-semantics re-implementation of the reference
(reference: the crate's src/); the device compute path in
``entropy_coders_tpu.ops`` is tested for bit-exactness against it.
"""

from .bitstream import BitStackReader, BitStackWriter, BitStreamReader
from .codec import fse_compress, fse_decompress
from .fse import DecodeTable, Decoder, EncodeTable, Encoder, spread_symbols, table_step
from .histogram import HistError, Histogram, NormHistogram

__all__ = [
    "BitStackReader",
    "BitStackWriter",
    "BitStreamReader",
    "DecodeTable",
    "Decoder",
    "EncodeTable",
    "Encoder",
    "HistError",
    "Histogram",
    "NormHistogram",
    "fse_compress",
    "fse_decompress",
    "spread_symbols",
    "table_step",
]
