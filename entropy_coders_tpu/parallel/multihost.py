"""Multi-host frame pipeline (one JAX process per host).

The reference is single-process (SURVEY.md §2: no distributed backend);
the scale-out story for hosts is the same block data
parallelism as the single-host mesh, plus a DCN exchange of the
variable-length results:

* each process compresses the contiguous range of blocks it owns —
  pure local work on its own chips, zero cross-host traffic in the
  coding itself;
* the ordered gather of variable-length sections is two
  ``multihost_utils.process_allgather`` rounds over DCN (lengths, then
  max-padded bytes), after which every host assembles the identical
  global frame;
* decompression is the mirror: each host range-decodes only its owned
  blocks (the container's random-access property), optionally followed
  by the same allgather to materialize the full buffer everywhere.

Runnable without a pod: tests/test_multihost.py drives two real JAX
processes on CPU (gloo collectives) through compress -> assemble ->
decompress and asserts the frame is byte-identical to a single-process
``frame.compress``.
"""

from __future__ import annotations

import jax
import numpy as np

from .. import frame as F

__all__ = [
    "init_distributed",
    "owned_blocks",
    "compress",
    "decompress",
]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     cpu_collectives: str | None = None) -> None:
    """Initialize the multi-host runtime (one JAX process per host).

    On GPUs the runtime carries the collectives (NCCL); on CPU (tests)
    pass ``cpu_collectives="gloo"`` so cross-process transfers work. No-op when already initialized."""
    if cpu_collectives is not None:
        jax.config.update("jax_cpu_collectives_implementation",
                          cpu_collectives)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized / single-process environments


def owned_blocks(n_blocks: int, num_processes: int | None = None,
                 process_id: int | None = None) -> tuple[int, int]:
    """Contiguous balanced block range [lo, hi) owned by this process."""
    p = num_processes if num_processes is not None else jax.process_count()
    i = process_id if process_id is not None else jax.process_index()
    return i * n_blocks // p, (i + 1) * n_blocks // p


def _allgather_bytes(buf: bytes) -> list[bytes]:
    """Ordered allgather of one variable-length byte string per process
    (two DCN rounds: lengths, then max-padded payloads)."""
    from jax.experimental import multihost_utils

    lens = multihost_utils.process_allgather(
        np.array([len(buf)], np.int64))
    lens = np.asarray(lens).reshape(-1)
    m = max(int(lens.max()), 1)
    padded = np.zeros(m, np.uint8)
    padded[: len(buf)] = np.frombuffer(buf, np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    return [gathered[i, : int(lens[i])].tobytes()
            for i in range(gathered.shape[0])]


def compress(data, *, block_size: int = F.DEFAULT_BLOCK_SIZE,
             k: int = F.DEFAULT_K, checksum: bool = False,
             sharding=None, **kwargs) -> bytes:
    """Multi-host frame compression of ``data`` (replicated on every
    host, e.g. a shared filesystem): each process compresses only the
    blocks it owns, the section tables are allgathered, and every host
    returns the identical global frame.

    ``sharding`` optionally spreads each host's own blocks over its
    local-chip mesh as in ``parallel.compress``.

    ``shared_table=True`` builds ONE table for the whole input across
    all hosts (the multi-host analog of the reference's single-table
    frame, reference src/lib.rs:112-143): each process histograms only
    its owned bytes, the 256-counter tables are summed via one DCN
    allgather, every process normalizes the identical global counts,
    and the merged frame carries the single shared header."""
    data = np.frombuffer(bytes(data), np.uint8) \
        if not isinstance(data, np.ndarray) else np.asarray(data, np.uint8)
    total_len = len(data)
    n_blocks = -(-total_len // block_size) if total_len else 0
    lo, hi = owned_blocks(n_blocks)
    local = data[lo * block_size: min(hi * block_size, total_len)]

    shared_table = bool(kwargs.pop("shared_table", False))
    shared_hdr = b""
    if shared_table:
        from jax.experimental import multihost_utils

        # 256-counter histogram all-reduce over DCN: local count ->
        # allgather -> identical elementwise sum everywhere. Local counts
        # can reach 2^32 (a 4 GiB single-symbol slice) but
        # process_allgather truncates to int32 without jax_enable_x64,
        # so ship each counter as (hi16, lo16) int32 halves and
        # recombine in int64 — exact for any per-host slice < 4 GiB.
        counts_local = np.bincount(local, minlength=256).astype(np.int64)
        halves = np.stack([counts_local >> 16,
                           counts_local & 0xFFFF]).astype(np.int32)
        gathered = np.asarray(
            multihost_utils.process_allgather(halves)).astype(np.int64)
        gathered = gathered.reshape(-1, 2, 256)
        counts_all = ((gathered[:, 0] << 16) + gathered[:, 1]).sum(axis=0)
        # the ONE normative policy copy (frame.resolve_shared_table)
        # decides degenerate/un-normalizable fallbacks and default logs,
        # so every process — and the single-process path — agrees
        s = F.resolve_shared_table(counts_all, total_len,
                                   kwargs.get("table_log"),
                                   kwargs.get("lanes"))
        if s is None:
            shared_table = False  # deterministic per-block RAW/RLE
        else:
            kwargs["shared_hist"] = s
            shared_hdr = F._write_header(*s)

    local_frame = F.compress(local, block_size=block_size, k=k,
                             shared_table=shared_table,
                             checksum=checksum, sharding=sharding, **kwargs)
    frames = _allgather_bytes(local_frame)
    return _merge_frames(frames, total_len, block_size, k, checksum,
                         bool(kwargs.get("bit_pack", False)),
                         shared_hdr=shared_hdr if shared_table else None)


def _merge_frames(frames: list[bytes], total_len: int, block_size: int,
                  k: int, checksum: bool, packed: bool = False,
                  shared_hdr: bytes | None = None) -> bytes:
    """Concatenate per-host sub-frames (contiguous block ranges, same
    block_size/k) into one global frame. Every host runs this on the
    same gathered inputs, so every host holds the identical frame.
    ``shared_hdr`` (FLAG_SHARED mode) is the single global histogram
    header every sub-frame must carry verbatim."""
    import struct

    entries, crcs, payloads = [], [], []
    n_blocks = 0
    for sub in frames:
        pf = F._parse_frame(sub)
        if pf.n_blocks == 0:
            continue
        if (pf.block_size != block_size or pf.k != k
                or pf.shared != (shared_hdr is not None)
                or pf.packed != packed):
            raise ValueError("multihost merge: sub-frame layout mismatch")
        if shared_hdr is not None and pf.shared_hdr != shared_hdr:
            raise ValueError("multihost merge: shared table mismatch")
        ent, sub_crcs, payload = F._subframe_parts(pf)
        entries.append(ent)
        if checksum:
            if sub_crcs is None:
                raise ValueError("multihost merge: missing crc table")
            crcs.append(sub_crcs)
        payloads.append(payload)
        n_blocks += pf.n_blocks
    if n_blocks != (total_len + block_size - 1) // block_size:
        raise ValueError("multihost merge: block count mismatch")
    parts = [F._frame_header(total_len, k, block_size, n_blocks,
                             shared_hdr is not None, checksum, packed)]
    if shared_hdr is not None:
        parts.append(struct.pack("<H", len(shared_hdr)) + shared_hdr)
    if entries:
        parts.append(np.concatenate(entries).astype("<u4").tobytes())
    if checksum and crcs:
        parts.append(np.concatenate(crcs).astype("<u4").tobytes())
    parts.extend(payloads)
    return b"".join(parts)


def decompress(frame: bytes, *, assemble: bool = True, sharding=None,
               **kwargs):
    """Multi-host decompression: each process decodes only the blocks it
    owns (random-access range decode — no host touches another host's
    sections).

    With ``assemble`` (default) the decoded ranges are allgathered and
    every host returns the full buffer. With ``assemble=False`` returns
    ``(byte_offset, local_bytes)`` — the scalable form when the output
    stays host-sharded."""
    pf = F._parse_frame(frame)
    lo, hi = owned_blocks(pf.n_blocks)
    start = lo * pf.block_size
    length = min(hi * pf.block_size, pf.total_len) - start
    local = F.decompress(frame, start=start, length=max(length, 0),
                         sharding=sharding, **kwargs) if length > 0 else b""
    if not assemble:
        return start, local
    return b"".join(_allgather_bytes(local))
