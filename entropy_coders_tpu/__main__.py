"""Command-line interface: file compression with the container format.

Usage:
    python -m entropy_coders_tpu compress   <in> <out> [--block-size N]
        [--k N] [--table-log N|auto] [--shared-table] [--no-lanes]
    python -m entropy_coders_tpu decompress <in> <out>
    python -m entropy_coders_tpu stat       <in>

The reference is a library only; this CLI is the framework's end-to-end
driver for real files, on the GPU or (through the plain-JAX coders) the
CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def _parse_table_log(v: str):
    """'auto' | 'fast' | 'fast:EPS' | int — the frame.compress forms."""
    if v in ("auto", "fast"):
        return v
    if v.startswith("fast:"):
        return ("fast", float(v[5:]))
    return int(v)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="entropy_coders_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress")
    c.add_argument("infile")
    c.add_argument("outfile")
    c.add_argument("--block-size", type=int, default=None)
    c.add_argument("--k", type=int, default=None)
    c.add_argument("--table-log", default=None, type=_parse_table_log,
               help="5..15, 'auto' (per-block ratio-optimal), 'fast' "
                    "(smallest log within 0.5%% of auto's estimated "
                    "size — ~2x decode speed per -1), or 'fast:EPS' "
                    "for an explicit size budget (e.g. fast:0.015)")
    c.add_argument("--shared-table", action="store_true")
    c.add_argument("--no-lanes", action="store_true")
    c.add_argument("--checksum", action="store_true")
    c.add_argument("--bit-pack", action="store_true",
                   help="bit-pack lane streams (FLAG_PACKED; smaller, "
                        "slower host repack)")

    d = sub.add_parser("decompress")
    d.add_argument("infile")
    d.add_argument("outfile")

    s = sub.add_parser("stat")
    s.add_argument("infile")

    args = p.parse_args(argv)

    from . import frame as F

    if args.cmd == "compress":
        from .stream import compress_file

        kw = {}
        if args.block_size:
            kw["block_size"] = args.block_size
        if args.k:
            kw["k"] = args.k
        if args.table_log:
            kw["table_log"] = args.table_log
        if args.no_lanes:
            kw["lanes"] = False
        if args.checksum:
            kw["checksum"] = True
        if args.bit_pack:
            kw["bit_pack"] = True
        t0 = time.perf_counter()
        import os
        if args.shared_table:
            # a shared table needs the whole-file histogram: non-streaming
            data = open(args.infile, "rb").read()
            comp = F.compress(data, shared_table=True, **kw)
            open(args.outfile, "wb").write(comp)
            n_in, n_out = len(data), len(comp)
        else:
            n_out = compress_file(args.infile, args.outfile, **kw)
            n_in = os.path.getsize(args.infile)
        dt = time.perf_counter() - t0
        print(f"{n_in} -> {n_out} bytes "
              f"(ratio {n_out/max(n_in,1):.4f}) in {dt:.2f}s",
              file=sys.stderr)
    elif args.cmd == "decompress":
        from .stream import decompress_file

        import os
        t0 = time.perf_counter()
        n_out = decompress_file(args.infile, args.outfile)
        dt = time.perf_counter() - t0
        print(f"{os.path.getsize(args.infile)} -> {n_out} bytes in {dt:.2f}s",
              file=sys.stderr)
    else:
        from .utils import frame_stats

        st = frame_stats(open(args.infile, "rb").read())
        print(f"blocks={st.n_blocks} block_size={st.block_size} k={st.k} "
              f"shared={st.shared_table} modes={st.mode_counts} "
              f"table_logs={st.table_log_counts}")
        print(f"ratio={st.ratio:.4f} header_bytes={st.header_bytes} "
              f"lane_tables={st.lane_size_table_bytes} "
              f"overhead={st.overhead:.4%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
