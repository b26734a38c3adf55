"""Generate the checked-in golden vectors (tests/data/golden/).

Run ONCE from the repo root and commit the output:

    python tests/data/generate_golden.py

The frames pin the verified on-the-wire format (reference:
src/lib.rs:112-183 for the k-way streams, FORMAT.md for the container)
against silent regression: a future semantic drift in any ONE
implementation (spec, native, device ops) fails tests/test_golden.py even
if the other oracles drifted with it. Do NOT regenerate casually — only
after an intentional, documented format change.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

OUT = os.path.join(os.path.dirname(__file__), "golden")


def gen_sequence(prob: float, size: int, seed: int) -> np.ndarray:
    """The reference benchmark's geometric-ish byte generator
    (reference: benches/fse_benchmark.rs:5-28), seeded."""
    LUT_SIZE = 4096
    lut = np.zeros(LUT_SIZE, dtype=np.uint8)
    prob = min(max(prob, 0.005), 0.995)
    remaining, idx, s = LUT_SIZE, 0, 0
    while remaining > 0:
        n = max(int(remaining * prob), 1)
        lut[idx: idx + n] = s
        idx += n
        s = (s + 1) & 0xFF
        remaining -= n
    r = np.random.default_rng(seed)
    i = r.integers(0, 1 << 16, size=size, dtype=np.uint16)
    return lut[i & (LUT_SIZE - 1)]


def make_input(spec: dict) -> np.ndarray:
    kind = spec["kind"]
    rng = np.random.default_rng(spec["seed"])
    n = spec["size"]
    if kind == "geometric":
        return gen_sequence(spec["prob"], n, spec["seed"])
    if kind == "uniform":  # full alphabet -> slow-path normalization
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "sparse":  # two far-apart symbols -> zero-run headers
        return rng.choice(np.array(spec["symbols"], np.uint8), n)
    if kind == "narrow":
        return rng.integers(0, spec["hi"], n).astype(np.uint8)
    raise ValueError(kind)


CASES = [
    # reference-format k-way stream frames (header + reversed bit stack)
    {"name": "k1_geo", "codec": "stream", "k": 1,
     "input": {"kind": "geometric", "prob": 0.2, "size": 4096, "seed": 1}},
    {"name": "k2_geo", "codec": "stream", "k": 2,
     "input": {"kind": "geometric", "prob": 0.2, "size": 4096, "seed": 1}},
    {"name": "k2_geo_odd", "codec": "stream", "k": 2,
     "input": {"kind": "geometric", "prob": 0.2, "size": 4095, "seed": 2}},
    {"name": "k2_uniform_slow_norm", "codec": "stream", "k": 2,
     "input": {"kind": "uniform", "size": 4096, "seed": 3}},
    {"name": "k1_sparse_zero_runs", "codec": "stream", "k": 1,
     "input": {"kind": "sparse", "symbols": [0, 250], "size": 2048,
               "seed": 4}},
    {"name": "k2_narrow_L9", "codec": "stream", "k": 2, "table_log": 9,
     "input": {"kind": "narrow", "hi": 4, "size": 3000, "seed": 5}},
    {"name": "k4_geo_L13", "codec": "stream", "k": 4, "table_log": 13,
     "input": {"kind": "geometric", "prob": 0.1, "size": 16384, "seed": 6}},
    # container frames (FORMAT.md, VERSION 2)
    {"name": "frame_pl_crc", "codec": "frame", "k": 256,
     "block_size": 4096, "lanes": True, "checksum": True,
     "input": {"kind": "geometric", "prob": 0.2, "size": 3 * 4096 + 777,
               "seed": 7}},
    {"name": "frame_shared_pl", "codec": "frame", "k": 256,
     "block_size": 4096, "lanes": True, "shared_table": True,
     "input": {"kind": "geometric", "prob": 0.3, "size": 2 * 4096,
               "seed": 8}},
    {"name": "frame_mixed_rle_raw", "codec": "frame", "k": 128,
     "block_size": 1024, "lanes": True,
     # block 0 constant (RLE), block 1 uniform (RAW), block 2 geometric
     "input": {"kind": "mixed_rle_raw", "size": 3 * 1024, "seed": 9}},
    # FLAG_PACKED wire: bit-granularity lanes + FSE-compressed size table
    {"name": "frame_packed", "codec": "frame", "k": 256,
     "block_size": 4096, "lanes": True, "bit_pack": True,
     "input": {"kind": "geometric", "prob": 0.2, "size": 2 * 4096 + 512,
               "seed": 10}},
    {"name": "frame_packed_crc", "codec": "frame", "k": 128,
     "block_size": 2048, "lanes": True, "bit_pack": True, "checksum": True,
     "input": {"kind": "narrow", "hi": 8, "size": 4 * 2048, "seed": 11}},
    # checkpoint container (checkpoint.py: FSCK header | manifest | frame)
    {"name": "ckpt_small", "codec": "checkpoint", "k": 128,
     "block_size": 2048, "lanes": True, "checksum": True,
     "input": {"kind": "ckpt_tree", "seed": 12}},
]


def make_ckpt_tree(seed: int):
    """Small deterministic pytree covering the manifest's node/dtype
    space: nested dict/list/tuple/None, f32/f64/bf16/int8/bool leaves,
    and a 0-d scalar (checkpoint.py supports exactly these shapes)."""
    import ml_dtypes

    r = np.random.default_rng(seed)
    return {
        "params": {
            "w": r.standard_normal((24, 16)).astype(np.float32),
            "b": np.zeros(16, np.float32),
            "emb": r.standard_normal((32, 8)).astype(ml_dtypes.bfloat16),
        },
        "opt": [r.integers(-128, 128, 500).astype(np.int8),
                (r.standard_normal(7), None)],
        "step": np.asarray(12345, np.int64),
        "flags": np.array([True, False, True]),
    }


def make_mixed(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = n // 3
    return np.concatenate([
        np.full(b, 7, np.uint8),
        rng.integers(0, 256, b, dtype=np.uint8),
        gen_sequence(0.2, n - 2 * b, seed),
    ])


def build_case(case: dict, interpret: bool = True) -> bytes:
    """The case's bytes; ``interpret=False`` runs the per-lane coder as
    compiled for the default backend instead of the Pallas interpreter."""
    import entropy_coders_tpu as ect
    from entropy_coders_tpu import frame as F

    spec = case["input"]
    if case["codec"] == "checkpoint":
        import tempfile

        from entropy_coders_tpu import checkpoint as CK

        kwargs = {kk: case[kk] for kk in
                  ("block_size", "k", "lanes", "checksum", "bit_pack")
                  if kk in case}
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "g.fsck")
            CK.save_pytree(p, make_ckpt_tree(spec["seed"]),
                           interpret=interpret, **kwargs)
            with open(p, "rb") as f:
                return f.read()
    data = (make_mixed(spec["size"], spec["seed"])
            if spec["kind"] == "mixed_rle_raw" else make_input(spec))
    if case["codec"] == "stream":
        dst = bytearray()
        hist = None
        if "table_log" in case:
            hist = ect.Histogram(data).normalize(case["table_log"])
            assert hist.log2 == case["table_log"]
        ect.fse_compress(data, dst, k=case["k"], hist=hist)
        return bytes(dst)
    kwargs = {kk: case[kk] for kk in
              ("block_size", "k", "lanes", "shared_table", "checksum",
               "table_log", "bit_pack") if kk in case}
    return F.compress(data, interpret=interpret, **kwargs)


def main():
    os.makedirs(OUT, exist_ok=True)
    manifest = []
    for case in CASES:
        frame = build_case(case)
        fn = case["name"] + ".bin"
        with open(os.path.join(OUT, fn), "wb") as f:
            f.write(frame)
        entry = dict(case)
        entry["file"] = fn
        entry["sha256"] = hashlib.sha256(frame).hexdigest()
        entry["compressed_bytes"] = len(frame)
        manifest.append(entry)
        print(f"{case['name']}: {len(frame)} bytes "
              f"{entry['sha256'][:16]}")
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


if __name__ == "__main__":
    main()
