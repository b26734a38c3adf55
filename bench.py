"""Benchmark: per-lane (MODE_FSE_PL) encode and decode on one GPU.

Workload: synthetic geometric-ish bytes (the reference's own benchmark
distribution, prob=0.2 — reference: benches/fse_benchmark.rs:30-35),
128 MiB in 16 MiB blocks. Two operating points, one JSON line:

* the throughput point — k=16384 per-lane streams, table_log 8;
* the parity point — k=8192, table_log 11, bit-packed lanes
  (FLAG_PACKED): its compressed size is at or under the reference's
  single-table frame on this corpus (REFERENCE_RATIO).

Per point: the device-resident kernel time of each direction (input and
output in device memory, median over repeats, each ending in
``block_until_ready``) and the end-to-end ``frame.compress`` /
``decompress`` time (second call, compiles excluded), round trips
asserted. Every line names the device; without a GPU the bench exits
non-zero.

    python bench.py
"""

import json
import subprocess
import sys
import time

import numpy as np

from entropy_coders_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

# the reference's monolithic single-table frame (k=2, optimal_log2=11,
# reference src/lib.rs:112-183) measures 0.4530 on this corpus
# (BASELINE.md); the parity point must land at or under it
REFERENCE_RATIO = 0.4530

SIZE = 128 << 20
BLOCK = 16 << 20
POINTS = {"throughput": dict(k=16384, table_log=8, bit_pack=False),
          "parity": dict(k=8192, table_log=11, bit_pack=True)}


def gen_sequence(prob: float, size: int, seed: int = 0xF5E) -> np.ndarray:
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


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them, and the
    card's name and power limit as nvidia-smi reports them. Exits
    non-zero when JAX finds no GPU: a measurement never falls back to
    the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {devs[0].platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card.strip()}


def time_call(call, reps=5) -> float:
    """Median wall time of ``call()`` through ``block_until_ready``,
    after one warm-up call (which compiles)."""
    import jax

    jax.block_until_ready(call())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(call())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def coder_inputs(data, comp, block_size):
    """Device-resident inputs of both coder directions for the full
    MODE_FSE_PL blocks of frame ``comp`` (of ``data``) at its most common
    table log: the blocks and encode tables, the lane words, sizes and
    decode tables. ``n`` counts the blocks taken."""
    import jax.numpy as jnp

    from entropy_coders_tpu import frame as F
    from entropy_coders_tpu import native
    from entropy_coders_tpu.ops import pl_coder as PL

    pf = F._parse_frame(comp)
    k = pf.k
    shared = F._read_block_header(pf.shared_hdr) if pf.shared else None
    blocks = []
    for j in range(pf.total_len // block_size):
        if int(pf.modes[j]) != F.MODE_FSE_PL:
            continue
        tbl, l2, sec = (shared[:2] + (pf.section(j),) if shared
                        else F._read_block_header(pf.section(j)))
        if pf.packed:
            sz, sec = F._unpack_size_table(sec, k)
        else:
            sz, sec = np.frombuffer(sec[: 2 * k], "<u2"), sec[2 * k:]
        blocks.append((j, l2, tbl, sz, sec))
    logs = [b[1] for b in blocks]
    L = max(set(logs), key=logs.count)
    blocks = [b for b in blocks if b[1] == L]
    B = len(blocks)
    sizes = np.stack([b[3] for b in blocks]).astype(np.int32)
    payloads = [b[4] for b in blocks]
    norm_tables = np.stack([b[2] for b in blocks]).astype(np.int32)
    raw = np.stack([data[j * block_size: (j + 1) * block_size]
                    for j, *_ in blocks])
    R = block_size // k - 1
    W = -(-(int(sizes.max()) // 32 + 3) // 16) * 16
    words = PL.lane_split_batch(payloads, sizes, k, W, pack_bits=pf.packed)
    table, tt_bits, tt_fs = native.build_encode_tables(norm_tables, L)
    dec_tbl = native.build_decode_tables(norm_tables, L)
    return dict(
        k=k, L=L, R=R, We=PL.encode_w_bound(R, L), n=B,
        enc=[jnp.asarray(x) for x in (
            raw, tt_bits.view(np.int32), tt_fs,
            table.astype(np.int32))],
        dec=[jnp.asarray(x) for x in (
            words.view(np.int32), sizes, dec_tbl.view(np.int32))])


def time_coders(inp, impl="kernel", reps=5) -> dict:
    """Device-resident seconds per call of each direction, with ``impl``
    the compiled kernel or the plain-JAX version (ops.pl_coder)."""
    from entropy_coders_tpu.ops import pl_coder as PL

    k, L, R = inp["k"], inp["L"], inp["R"]
    enc = lambda: PL._encode_call(*inp["enc"], k=k, W=inp["We"], L=L,  # noqa: E731
                                  R=R, impl=impl)
    dec = lambda: PL._decode_call(*inp["dec"], k=k, L=L, R=R, impl=impl)  # noqa: E731
    out, cur = dec()
    assert not np.asarray(cur).any(), "bench decode did not drain"
    return {"encode_s": time_call(enc, reps), "decode_s": time_call(dec, reps)}


def roundtrip(data, *, k, table_log, bit_pack):
    """frame.compress -> decompress in BLOCK-byte blocks (cold, then
    steady), round trips asserted. Returns (frame, seconds dict)."""
    from entropy_coders_tpu import frame as F

    kw = dict(block_size=BLOCK, k=k, lanes=True, table_log=table_log,
              bit_pack=bit_pack)
    t = {}
    for run in ("cold", "steady"):
        t0 = time.perf_counter()
        comp = F.compress(data, **kw)
        t[f"compress_s_{run}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = F.decompress(comp)
        t[f"decompress_s_{run}"] = time.perf_counter() - t0
        assert out == data.tobytes(), "bench round trip failed"
    return comp, t


def main():
    dev = device_info()
    data = gen_sequence(0.2, SIZE)
    res = {"device": dev, "input_bytes": SIZE, "block_size": BLOCK}
    for name, cfg in POINTS.items():
        comp, t = roundtrip(data, **cfg)
        coders = time_coders(coder_inputs(data, comp, BLOCK))
        res[name] = {**cfg, "ratio": len(comp) / SIZE, **t, **coders,
                     "encode_bytes_per_s": SIZE / coders["encode_s"],
                     "decode_bytes_per_s": SIZE / coders["decode_s"]}
    assert res["parity"]["ratio"] <= REFERENCE_RATIO, (
        f"parity point regressed: {res['parity']['ratio']:.4f} > "
        f"{REFERENCE_RATIO}")
    print(json.dumps(res))


if __name__ == "__main__":
    sys.exit(main())
