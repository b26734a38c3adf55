"""Test configuration.

The session runs on the CPU with 8 virtual devices, so the multi-device
sharding paths run without a GPU and the per-lane Pallas kernels run in
interpret mode. Tests marked ``gpu`` need the card and skip here (their
fixture finds no GPU); chip_smoke.py imports them and runs them on the
card in its own process, where this file is never loaded.
"""

import os

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compile cache (utils/cache.py): the suite compiles many
# (shape, k, log2) variants of the coders; cache them across runs.
from entropy_coders_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache(min_compile_secs=0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0xF5E)


def gen_sequence(prob: float, size: int, seed: int = 0xF5E) -> np.ndarray:
    """Synthetic approximately-geometric byte sequence, replicating the
    reference's test-data generator (reference: src/lib.rs:255-278) but
    seeded for determinism."""
    LUT_SIZE = 4096
    lut = np.zeros(LUT_SIZE, dtype=np.uint8)
    prob = min(max(prob, 0.005), 0.995)
    remaining = LUT_SIZE
    idx = 0
    s = 0
    while remaining > 0:
        n = max(int(remaining * prob), 1)
        lut[idx : idx + n] = s
        idx += n
        s = (s + 1) & 0xFF
        remaining -= n
    r = np.random.default_rng(seed)
    i = r.integers(0, 1 << 16, size=size, dtype=np.uint16)
    return lut[i & (LUT_SIZE - 1)]
