"""Worker for tests/test_multihost.py — one real JAX process per "host".

Usage: python multihost_worker.py <port> <num_processes> <process_id> \
           [n_blocks]
Prints `OK <sha256-of-global-frame>` on success. With an explicit
``n_blocks`` the worker runs the QUICK leg set (global + shared-table
frames only) — used by the 4-process test where one process owns ZERO
blocks and block ownership is uneven."""

import hashlib
import sys

import jax
import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from entropy_coders_tpu import frame as F  # noqa: E402
from entropy_coders_tpu.parallel import multihost as MH  # noqa: E402
from tests.conftest import gen_sequence  # noqa: E402


def main():
    port, num, pid = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    quick = len(sys.argv) > 4
    n_blocks = int(sys.argv[4]) if quick else 6
    MH.init_distributed(f"127.0.0.1:{port}", num_processes=num,
                        process_id=pid, cpu_collectives="gloo")
    assert jax.process_count() == num

    data = gen_sequence(0.2, (n_blocks - 1) * 4096 + 321)
    kwargs = dict(block_size=4096, k=128, lanes=True, interpret=True,
                  checksum=True)

    global_frame = MH.compress(data, **kwargs)
    # every host must hold the byte-identical frame a single process makes
    single = F.compress(data, **kwargs)
    assert global_frame == single, "multihost frame != single-process frame"

    # assembled decompress on every host
    out = MH.decompress(global_frame, interpret=True)
    assert out == data.tobytes()

    # host-sharded decompress (no assembly): exactly the owned byte range
    # (b"" for a process that owns zero blocks)
    start, local = MH.decompress(global_frame, assemble=False,
                                 interpret=True)
    lo, hi = MH.owned_blocks(n_blocks)
    assert start == lo * 4096
    assert local == data.tobytes()[start:max(min(hi * 4096, len(data)),
                                             start)]

    # shared-table mode: per-process histograms all-reduce into ONE
    # global table; the merged frame must be byte-identical to the
    # single-process shared frame (FLAG_SHARED, one header)
    shared_frame = MH.compress(data, shared_table=True, **kwargs)
    single_shared = F.compress(data, shared_table=True, **kwargs)
    assert shared_frame == single_shared, \
        "multihost shared-table frame != single-process shared frame"
    pf = F._parse_frame(shared_frame)
    assert pf.shared and len(pf.shared_hdr) > 0
    assert MH.decompress(shared_frame, interpret=True) == data.tobytes()

    if quick:
        digest = hashlib.sha256(global_frame + shared_frame).hexdigest()
        print("OK", digest, flush=True)
        return

    # per-block optimal_log2 policy across hosts: each host's sub-frame
    # carries heterogeneous per-block logs; the ordered merge must still
    # be byte-identical to the single-process auto frame
    auto_frame = MH.compress(data, table_log="auto", **kwargs)
    assert auto_frame == F.compress(data, table_log="auto", **kwargs), \
        "multihost auto-table_log frame != single-process frame"
    assert MH.decompress(auto_frame, interpret=True) == data.tobytes()

    # the throughput-biased policy is deterministic per block, so the
    # merged multi-host frame must also match single-process bytes
    fast_frame = MH.compress(data, table_log="fast", **kwargs)
    assert fast_frame == F.compress(data, table_log="fast", **kwargs), \
        "multihost fast-table_log frame != single-process frame"
    assert MH.decompress(fast_frame, interpret=True) == data.tobytes()

    digest = hashlib.sha256(global_frame + shared_frame
                            + auto_frame + fast_frame).hexdigest()
    print("OK", digest, flush=True)


if __name__ == "__main__":
    main()
