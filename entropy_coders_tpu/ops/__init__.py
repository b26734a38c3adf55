"""Device compute path (JAX/XLA, with Pallas kernels for the hot paths).

- ``coder`` — shared-bitstream k-way interleave (XLA; the reference-format
  interop path, bit-exact at k=1,2).
- ``pl_coder`` — per-lane-stream coder (a Pallas kernel on the GPU, plain
  JAX on the CPU; the flagship throughput path, MODE_FSE_PL).
- ``tables`` / ``histogram`` — device table build and histograms.
"""

from .coder import decode_interleaved, encode_interleaved
from .pl_coder import decode_lanes, encode_lanes, encode_w_bound

__all__ = [
    "decode_interleaved",
    "encode_interleaved",
    "decode_lanes",
    "encode_lanes",
    "encode_w_bound",
]
