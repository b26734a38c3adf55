"""Randomized differential fuzzer over the valid-input space.

The fixed test suite pins chosen points; this samples the configuration
space at random and cross-checks every implementation of the same
contract against the others:

  * spec ``fse_compress`` vs native ``ect_compress`` — byte-identical
    frames for any (data, k) (the native codec is an independent C++
    implementation of the same wire format, reference src/lib.rs:112-143);
  * spec and native decompress both invert both frames exactly;
  * the container (``frame.compress``/``decompress``) round-trips
    under random (block_size, k, lanes, bit_pack, table_log, checksum,
    shared_table) combinations, including the per-block "auto" log
    policy (reference src/histogram.rs:264-277).

Runs as a pytest (small fixed budget, deterministic seed) and as a
standalone soak: ``python tests/fuzz_diff.py --iters 2000 [--seed S]``.
Any failure prints the reproducing (seed, iteration) pair.
"""

from __future__ import annotations

import os
import sys

# script mode (`python tests/fuzz_diff.py`) puts tests/ on sys.path, not
# the repo root that holds the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from entropy_coders_tpu import frame as F
from entropy_coders_tpu import native
from entropy_coders_tpu.spec.codec import fse_compress, fse_decompress


def _gen_data(rng: np.random.Generator) -> np.ndarray:
    """Sample one input from a family of adversarial-ish distributions."""
    kind = rng.integers(0, 6)
    n = int(rng.integers(2, 1 << rng.integers(4, 16)) + 2)
    if kind == 0:  # uniform bytes (incompressible)
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == 1:  # geometric-ish (the reference's bench distribution)
        p = float(rng.uniform(0.05, 0.9))
        g = rng.geometric(p, n) - 1
        return np.minimum(g, 255).astype(np.uint8)
    if kind == 2:  # sparse alphabet (2..8 symbols, skewed)
        a = int(rng.integers(2, 9))
        syms = rng.choice(256, a, replace=False).astype(np.uint8)
        w = rng.dirichlet(np.full(a, 0.3))
        return rng.choice(syms, n, p=w)
    if kind == 3:  # long runs
        out = []
        while sum(len(r) for r in out) < n:
            out.append(np.full(int(rng.integers(1, 200)),
                               rng.integers(0, 256), np.uint8))
        return np.concatenate(out)[:n]
    if kind == 4:  # near-degenerate: one dominant symbol + rare others
        d = rng.integers(0, 256)
        x = np.full(n, d, np.uint8)
        m = rng.random(n) < 0.01
        x[m] = rng.integers(0, 256, int(m.sum()))
        if (x == x[0]).all():  # single-symbol inputs raise (as the
            x[-1] ^= 1        # reference panics) — keep 2 symbols
        return x
    # text-like: recycle this repo's own docs
    src = _TEXT
    off = int(rng.integers(0, max(1, len(src) - n)))
    return np.frombuffer(src[off : off + n], np.uint8).copy()


with open(__file__, "rb") as _f:
    _TEXT = _f.read() * 8


def _check_reference_format(data: np.ndarray, rng: np.random.Generator,
                            msg: str) -> None:
    k = int(rng.choice([1, 2, 3, 5]))
    if len(data) < max(k, 2) + k:  # spec/native contract minimum
        return
    try:
        frame = bytearray()
        fse_compress(data, frame, k=k)
    except ValueError:
        return  # degenerate (single-symbol) inputs raise — in contract
    nat = native.compress(data.tobytes(), k=k) if native.available() else None
    assert nat is None or nat == bytes(frame), f"spec != native frame {msg} k={k}"
    out = bytearray()
    cnt = fse_decompress(bytes(frame), out, k=k)
    assert cnt == len(data) and bytes(out) == data.tobytes(), \
        f"spec round trip {msg} k={k}"
    if nat is not None:
        back = native.decompress(nat, k=k, max_out=len(data) + 64)
        assert back == data.tobytes(), f"native round trip {msg} k={k}"


def _check_container(data: np.ndarray, rng: np.random.Generator,
                     msg: str, wide: bool) -> None:
    # every distinct (block_size, k, L, R) is a fresh jit trace (and the
    # interpret-mode Pallas kernels are slow on CPU), so the quick/pytest
    # palette stays narrow enough for the in-process jit cache to do its
    # job; --wide soak mode samples the full space
    if wide:
        bs = int(rng.choice([256, 1024, 4096, 16384, 65536]))
        lanes = bool(rng.integers(0, 2))
        k = (int(rng.choice([128, 256, 512])) if lanes
             else int(rng.choice([1, 2, 8, 64])))
        k = min(k, bs)  # compress rejects k > block_size by contract
        tl = rng.choice(["auto", "fast", None, 7, 9, 11])
        shared = bool(rng.integers(0, 4) == 0)
    else:
        bs, lanes = 2048, bool(rng.integers(0, 2))
        k = 128 if lanes else int(rng.choice([1, 8]))
        tl = rng.choice(["auto", None])
        shared = False
    tl = None if tl is None else (tl if tl in ("auto", "fast") else int(tl))
    kw = dict(
        block_size=bs, k=k, lanes=lanes, interpret=True,
        table_log=tl,
        bit_pack=lanes and bool(rng.integers(0, 2)),
        checksum=bool(rng.integers(0, 2)),
        shared_table=shared,
    )
    if _VERBOSE:
        print(f"  container {msg} n={len(data)} {kw}", flush=True)
    comp = F.compress(data, **kw)
    assert F.decompress(comp, interpret=True) == data.tobytes(), \
        f"container round trip {msg} {kw}"
    if len(data):  # random-access range decode agrees with the slice
        s = int(rng.integers(0, len(data)))
        ln = int(rng.integers(0, len(data) - s + 1))
        assert (F.decompress(comp, interpret=True, start=s, length=ln)
                == data[s : s + ln].tobytes()), f"range decode {msg} {kw}"


_VERBOSE = False


def _check_corruption(data: np.ndarray, rng: np.random.Generator,
                      msg: str) -> None:
    """Flip random bits/bytes in a valid container frame: decompress
    must either raise ValueError (the untrusted-decode contract) or
    return bytes — never crash, hang, or leak another exception type."""
    comp = bytearray(F.compress(data, block_size=2048, k=128, lanes=True,
                                interpret=True,
                                checksum=bool(rng.integers(0, 2))))
    for _ in range(int(rng.integers(1, 4))):
        comp[int(rng.integers(0, len(comp)))] ^= int(rng.integers(1, 256))
    try:
        F.decompress(bytes(comp), interpret=True)
    except ValueError:
        pass


def run_fuzz(iters: int, seed: int, container_every: int = 4,
             verbose: bool = False, wide: bool = False,
             max_container_bytes: int = 1 << 13) -> None:
    rng = np.random.default_rng(seed)
    for i in range(iters):
        msg = f"(seed={seed} iter={i})"
        data = _gen_data(rng)
        _check_reference_format(data, rng, msg)
        # the container path is ~10x slower (jit'd interpret kernels);
        # sample it every few iterations on a truncated input
        if i % container_every == 0:
            _check_container(data[:max_container_bytes], rng, msg, wide)
        if i % (2 * container_every) == 1:
            _check_corruption(data[:max_container_bytes], rng, msg)
        if verbose:
            print(f"iter {i}/{iters} n={len(data)}", flush=True)
        if i and i % 200 == 0:
            # nearly every container config (and every distinct tail
            # length, even on the narrow palette) compiles a fresh jit
            # program; the in-process compile caches grow without bound
            # and a long soak eventually dies in LLVM with ENOMEM
            # (observed at ~1900 wide / ~3000 narrow iterations)
            import jax

            jax.clear_caches()


def test_fuzz_quick():
    run_fuzz(iters=20, seed=0xD1FF, container_every=5)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--seed", type=int, default=np.random.SeedSequence().entropy % (1 << 31))
    ap.add_argument("--wide", action="store_true",
                    help="sample the full container config space "
                         "(slow: every distinct shape is a jit compile)")
    args = ap.parse_args()
    globals()["_VERBOSE"] = True
    print(f"fuzzing: iters={args.iters} seed={args.seed} wide={args.wide}",
          flush=True)
    run_fuzz(args.iters, args.seed, verbose=True, wide=args.wide)
    print("OK")
