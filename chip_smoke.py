"""Prove that the codec runs compiled on NVIDIA GPUs, end to end.

    python chip_smoke.py              # one card: phases i-vi
    python chip_smoke.py --four-gpus  # four cards: the sharded path only

One process drives the card(s). Phases (any failure exits non-zero):

  i    device: JAX must find a GPU; print its name and power limit;
  ii   the gpu-marked tests (tests/test_gpu.py) on the card: every golden
       frame re-encodes byte-identically through the compiled kernels
       and decodes to its pinned input; kernel, plain-JAX version and the
       host C++ reference agree at every table log;
  iii  the default path: 256 MiB (bench generator + mixed corpus) through
       frame.compress/decompress at the library defaults (per-lane mode
       on the GPU); the output equals the input, and every per-lane
       block section equals the host C++ reference's bytes;
  iv   bench.py's two points at 128 MiB, round trips asserted;
  v    a shared-stream (lanes=False) round trip;
  vi   timings: per-lane kernel vs the plain-JAX version per direction at
       bench.py's two points, and the histogram at two block shapes (the
       default path's end-to-end times are phase iii's).

``--four-gpus`` runs parallel.compress/decompress over a 1-D mesh of 4
cards on 512 MiB, per-block and shared-table (sharded_histogram), and
checks the frames are byte-identical to the one-card frames.

Every timing line carries the card's name and power limit; results also
go to chiprun_out/chip_smoke*.json. The last line of standard output is
one JSON object naming the device.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

DEFAULT_PATH_BYTES = 256 << 20  # phase iii
FOUR_GPU_BYTES = 512 << 20  # --four-gpus
SHARED_STREAM_BYTES = 32 << 20  # phase v


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def phase_device(n_cards):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found "
                         f"{len(devs)}")
    card = _card().strip()
    print(card, flush=True)
    return devs[:n_cards], card


class Log:
    """Prints each result line tagged with the card, keeps them for the
    JSON record."""

    def __init__(self, card):
        self.card, self.rows = card, []

    def __call__(self, name, **fields):
        row = {"phase": name, "card": self.card, **fields}
        self.rows.append(row)
        print(json.dumps(row), flush=True)

    def save(self, fname):
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", fname), "w") as f:
            json.dump(self.rows, f, indent=1)


def default_corpus(size):
    """Half the bench generator's bytes, half the mixed corpus (text,
    bf16 tensors, JSON logs), from fixed seeds."""
    import bench
    import bench_configs

    half = size // 2
    return np.concatenate([
        bench.gen_sequence(0.2, half),
        np.frombuffer(bench_configs.mixed_corpus(size - half), np.uint8)])


def check_against_host(data, comp):
    """Every MODE_FSE_PL block section of ``comp`` equals the section the
    host C++ per-lane encoder (native.encode_lanes) gives for the same
    block and table. Returns the number of blocks checked."""
    from entropy_coders_tpu import frame as F
    from entropy_coders_tpu import native
    from entropy_coders_tpu.ops import pl_coder as PL

    pf = F._parse_frame(comp)
    bs, k = pf.block_size, pf.k
    groups = {}
    for i in range(pf.n_blocks):
        if int(pf.modes[i]) == F.MODE_FSE_PL:
            tbl, l2, _ = F._read_block_header(pf.section(i))
            rl = min(bs, pf.total_len - i * bs)
            groups.setdefault((rl, l2), []).append((i, tbl))
    for (rl, L), items in groups.items():
        R = rl // k - 1
        for c in range(0, len(items), 256):  # bounds host memory
            part = items[c: c + 256]
            nt = np.stack([t for _, t in part]).astype(np.int32)
            blocks = np.stack([data[i * bs: i * bs + rl] for i, _ in part])
            words, sizes = native.encode_lanes(blocks, nt, L, k,
                                               PL.encode_w_bound(R, L))
            payloads = PL.lane_merge_batch(words, sizes,
                                           pack_bits=pf.packed)
            for j, (i, _) in enumerate(part):
                st = sizes[j].astype("<u2").tobytes()
                sec = F._write_header(nt[j], L) + (
                    F._pack_size_table(st) if pf.packed else st) + \
                    payloads[j]
                assert sec == pf.section(i), f"block {i} != host reference"
    return sum(len(v) for v in groups.values())


def hist_timings(log, data):
    """ops.histogram on 128 MiB at the default and the bench block
    shapes, checked against numpy."""
    import jax.numpy as jnp

    import bench
    from entropy_coders_tpu.ops.histogram import histogram_blocks

    x = data[: 128 << 20]
    for bs in (128 << 10, 16 << 20):
        blocks = jnp.asarray(x.reshape(-1, bs))
        want = np.stack([np.bincount(b, minlength=256)
                         for b in x.reshape(-1, bs)[:4]])
        assert (np.asarray(histogram_blocks(blocks))[:4] == want).all()
        log("vi.histogram", input_bytes=x.size, block_size=bs,
            seconds=bench.time_call(lambda: histogram_blocks(blocks)))


def one_card(log):
    import jax

    import importlib.util

    import bench
    from entropy_coders_tpu import frame as F
    from entropy_coders_tpu.ops import pl_coder as PL

    dev = jax.devices()[0]
    assert PL._impl(False) == "kernel" and PL.lanes_default()
    # by path: an installed package named ``tests`` may shadow the repo's
    spec = importlib.util.spec_from_file_location(
        "test_gpu", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "test_gpu.py"))
    TG = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(TG)

    t0 = time.perf_counter()
    TG.test_golden_frames_compiled(dev)
    for L in range(5, 16):
        TG.test_kernel_matches_plain_and_host(dev, L)
    log("ii.gpu_tests", ok=True, seconds=time.perf_counter() - t0)

    size = DEFAULT_PATH_BYTES
    data = default_corpus(size)
    times = {}
    for run in ("cold", "steady"):
        t0 = time.perf_counter()
        comp = F.compress(data)
        times[f"compress_s_{run}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = F.decompress(comp)
        times[f"decompress_s_{run}"] = time.perf_counter() - t0
        assert out == data.tobytes(), "default-path round trip failed"
    pf = F._parse_frame(comp)
    n_pl = int((pf.modes == F.MODE_FSE_PL).sum())
    assert n_pl > 0, "the default path took no per-lane block"
    n_checked = check_against_host(data, comp)
    assert n_checked == n_pl
    log("iii.default_path", input_bytes=size, ratio=len(comp) / size,
        block_size=F.DEFAULT_BLOCK_SIZE, k=F.DEFAULT_K, pl_blocks=n_pl,
        blocks=pf.n_blocks, host_reference_blocks=n_checked, **times,
        compress_bytes_per_s=size / times["compress_s_steady"],
        decompress_bytes_per_s=size / times["decompress_s_steady"])

    x = bench.gen_sequence(0.2, bench.SIZE)
    inputs = {}
    for name, cfg in bench.POINTS.items():
        comp, t = bench.roundtrip(x, **cfg)
        ratio = len(comp) / bench.SIZE
        if name == "parity":
            assert ratio <= bench.REFERENCE_RATIO, ratio
        inputs[name] = bench.coder_inputs(x, comp, bench.BLOCK)
        log("iv.bench_point", point=name, **cfg, input_bytes=bench.SIZE,
            ratio=ratio, **t)

    small = data[:SHARED_STREAM_BYTES]
    t0 = time.perf_counter()
    comp = F.compress(small, lanes=False)
    t_c = time.perf_counter() - t0
    assert (F._parse_frame(comp).modes != F.MODE_FSE_PL).all()
    t0 = time.perf_counter()
    assert F.decompress(comp) == small.tobytes(), "shared-stream failed"
    log("v.shared_stream", input_bytes=small.size, ratio=len(comp) / small.size,
        compress_s_cold=t_c, decompress_s_cold=time.perf_counter() - t0)

    for name, inp in inputs.items():
        for impl in ("kernel", "xla"):
            t = bench.time_coders(inp, impl=impl)
            log("vi.coder", point=name, impl=impl, k=inp["k"], L=inp["L"],
                input_bytes=bench.SIZE, **t,
                encode_bytes_per_s=bench.SIZE / t["encode_s"],
                decode_bytes_per_s=bench.SIZE / t["decode_s"])
    hist_timings(log, data)


def four_cards(log, devs):
    """Sharded compress/decompress over a 1-D mesh of 4 cards, per-block
    and shared-table, against the one-card frames."""
    from jax.sharding import Mesh

    from entropy_coders_tpu import frame as F
    from entropy_coders_tpu import parallel

    size = FOUR_GPU_BYTES
    data = default_corpus(size)
    mesh = Mesh(np.array(devs), ("blocks",))
    bs = F.DEFAULT_BLOCK_SIZE
    frames, times = {}, {}
    t0 = time.perf_counter()
    frames["per_block"] = parallel.compress(data, mesh)
    times["per_block_compress_s"] = time.perf_counter() - t0
    counts = np.asarray(parallel.sharded_histogram(
        data.reshape(-1, bs), mesh)).astype(np.int64)
    assert (counts == np.bincount(data, minlength=256)).all()
    shared = F.resolve_shared_table(counts, size, None, True)
    t0 = time.perf_counter()
    frames["shared"] = parallel.compress(data, mesh, shared_table=True,
                                         shared_hist=shared)
    times["shared_compress_s"] = time.perf_counter() - t0
    for name, comp in frames.items():
        t0 = time.perf_counter()
        assert parallel.decompress(comp, mesh) == data.tobytes(), name
        times[f"{name}_decompress_s"] = time.perf_counter() - t0
    # every card worked: each one's peak is a real share of the input
    # (read before the one-card runs below load device 0)
    peaks = [d.memory_stats() for d in devs]
    one = {"per_block": F.compress(data),
           "shared": F.compress(data, shared_table=True)}
    for name in frames:
        assert frames[name] == one[name], f"{name}: 4-card != 1-card frame"
        assert (F._parse_frame(frames[name]).modes == F.MODE_FSE_PL).any()
    peaks = [p["peak_bytes_in_use"] for p in peaks]
    assert min(peaks) > size // 16, peaks
    log("four_gpus", input_bytes=size, devices=len(devs),
        peak_bytes_in_use=peaks, identical_to_one_card=True,
        ratio_per_block=len(frames["per_block"]) / size,
        ratio_shared=len(frames["shared"]) / size, **times)


def main(argv):
    four = "--four-gpus" in argv
    devs, card = phase_device(4 if four else 1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from entropy_coders_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    log = Log(card)
    if four:
        four_cards(log, devs)
        log.save("chip_smoke_four_gpus.json")
    else:
        one_card(log)
        log.save("chip_smoke.json")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
