"""Global constants shared by every layer of the codec.

Mirrors the crate-level constants of the reference implementation
(reference: src/lib.rs:9-12): FSE table sizes are ``2**log2`` with
``log2`` restricted to ``[TABLE_LOG_MIN, TABLE_LOG_MAX]`` and a default
of ``TABLE_LOG_DEFAULT`` used by :func:`optimal_log2`.
"""

TABLE_LOG_MIN = 5
TABLE_LOG_MAX = 15
TABLE_LOG_DEFAULT = 11

# Number of distinct byte symbols; histograms and tables are always this wide.
ALPHABET = 256


def mask(bits: int) -> int:
    """All-ones mask of width ``bits`` (reference: src/lib.rs:15-57).

    The reference uses a 33-entry LUT for speed; on the host side a shift
    is fine, and the vectorized device kernels compute masks with shifts.
    """
    return (1 << bits) - 1


def ilog2(x: int) -> int:
    """Floor of log2 for a positive integer (Rust ``u32::ilog2``).

    Raises ``ValueError`` for ``x <= 0`` exactly where the reference's
    ``ilog2`` would panic, so degenerate inputs surface the same way.
    """
    if x <= 0:
        raise ValueError(f"ilog2 of non-positive value {x}")
    return x.bit_length() - 1
