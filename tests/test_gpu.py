"""Checks that need the card: the compiled per-lane kernels against the
golden frames, the plain-JAX version and the host C++ reference.

Under pytest the session is pinned to the CPU (tests/conftest.py), so
the ``gpu`` fixture skips these. chip_smoke.py runs them on the card: it
imports this module and calls each test with the device.
"""

import importlib.util
import json
import os
import tempfile

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

_HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(_HERE, "data", "golden")


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: chip_smoke.py runs this on the "
                    "card")
    return jax.devices()[0]


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "generate_golden", os.path.join(_HERE, "data", "generate_golden.py"))
    gg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gg)
    return gg


def test_golden_frames_compiled(gpu):
    """Every golden container frame (per-lane wire, FLAG_PACKED, the
    checkpoint container) is re-encoded byte-identically by the compiled
    kernels and decodes back to its pinned input."""
    from entropy_coders_tpu import checkpoint as CK
    from entropy_coders_tpu import frame as F

    gg = _golden_module()
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        files = {e["name"]: e["file"] for e in json.load(f)}
    cases = [c for c in gg.CASES if c["codec"] in ("frame", "checkpoint")]
    assert len(cases) == 6
    for case in cases:
        with open(os.path.join(GOLDEN, files[case["name"]]), "rb") as f:
            golden = f.read()
        assert gg.build_case(case, interpret=False) == golden, case["name"]
        spec = case["input"]
        if case["codec"] == "checkpoint":
            with tempfile.TemporaryDirectory() as td:
                p = os.path.join(td, "g.fsck")
                with open(p, "wb") as f:
                    f.write(golden)
                got = CK.load_pytree(p)
            want = gg.make_ckpt_tree(spec["seed"])
            for a, b in zip(_leaves(got), _leaves(want)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            continue
        data = (gg.make_mixed(spec["size"], spec["seed"])
                if spec["kind"] == "mixed_rle_raw" else gg.make_input(spec))
        assert F.decompress(golden) == data.tobytes(), case["name"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("L", range(5, 16))
def test_kernel_matches_plain_and_host(gpu, L):
    """At every table log, the compiled kernels, the plain-JAX version
    (both on the card) and the host C++ per-lane encoder agree byte for
    byte on 4 blocks of 256 KiB (k=2048), and decode restores them."""
    import jax.numpy as jnp

    from entropy_coders_tpu import native
    from entropy_coders_tpu.ops import pl_coder as PL

    B, k, n = 4, 2048, 256 << 10
    R = n // k - 1
    rng = np.random.default_rng(L)
    nsym = min(1 << (L - 3), 256)
    blocks = rng.zipf(1.5, (B, n)).astype(np.int64) % nsym
    blocks = blocks.astype(np.uint8)
    nt = np.stack([native.normalize(np.bincount(b, minlength=256)
                                    .astype(np.uint32), n, L)[0]
                   for b in blocks]).astype(np.int32)
    W = PL.encode_w_bound(R, L)
    hw, hs = native.encode_lanes(blocks, nt, L, k, W)
    table, ttb, ttf = native.build_encode_tables(nt, L)
    dtbl = jnp.asarray(native.build_decode_tables(nt, L).view(np.int32))
    enc = [jnp.asarray(x) for x in (blocks, ttb.view(np.int32), ttf,
                                    table.astype(np.int32))]
    for impl in ("kernel", "xla"):
        w, s = PL._encode_call(*enc, k=k, W=W, L=L, R=R, impl=impl)
        s = np.asarray(s)
        np.testing.assert_array_equal(s, hs, err_msg=impl)
        w = np.asarray(w).reshape(B, W, k).view(np.uint32)
        assert (PL.lane_merge_batch(w, s, pack_bits=True)
                == PL.lane_merge_batch(hw, hs, pack_bits=True)), impl
        out, cur = PL._decode_call(jnp.asarray(hw.view(np.int32)),
                                   jnp.asarray(hs), dtbl, k=k, L=L, R=R,
                                   impl=impl)
        assert not np.asarray(cur).any(), impl
        np.testing.assert_array_equal(np.asarray(out), blocks,
                                      err_msg=impl)
