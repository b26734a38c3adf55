"""Per-lane-stream tANS encode/decode (MODE_FSE_PL, the flagship path).

Each of k lanes (k a multiple of 128) owns its own bit stream: lane i
codes the byte subsequence {i, i+k, i+2k, ...} of its block as exactly a
reference-format single-stream FSE payload (reversed LSB-first bit
stack, initial state folding the lane's last byte, final state in
table_log bits — reference: src/lib.rs:112-143 semantics per lane). All
lanes advance one symbol per round; a block of n = (R+1)*k bytes takes R
rounds plus the folded last byte.

One round step (``_dec_round`` / ``_enc_round``) has two drivers,
chosen by platform (``_impl``):

* a Pallas kernel on the Triton route — one program per (block, group
  of ``LANES`` lanes), one lane per thread. The round loop runs inside
  the kernel, so each lane's state, bit cursor and 64-bit bit window
  (two i32 registers) stay in registers for all R rounds. The flat
  2^L-entry tables and the lane-interleaved (W, k) word array are read
  with per-lane indexed loads; encode flushes each full 32-bit word to
  its lane's own column, so no two lanes share a word and no store
  needs an atomic;
* the plain-JAX version — the same step over every lane at once in a
  ``lax.fori_loop``, with ``jnp.take_along_axis`` gathers. It is the
  CPU path and the reference the kernel is tested against.

Exact-semantics contract: each lane's bit stream is bit-identical to the
reference encoder run on that lane's subsequence (enforced by
tests/test_pl_coder.py against ``spec``).

Word/bit addressing: bit j of a lane's stream lives in word j>>5 at
position j&31 (LSB-first, same as the reference's BitStackWriter byte
layout, reference: src/bitstream/writer.rs:177-178); word w of lane i
of a block sits at flat index w*k + i.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .tables import build_decode_table, build_encode_table

__all__ = [
    "decode_lanes",
    "decode_lanes_norm",
    "encode_lanes",
    "encode_lanes_norm",
    "encode_w_bound",
    "lane_split",
    "lane_merge",
    "lane_split_bits",
    "lane_merge_bits",
]

LANES = 128  # lanes per kernel program: one per thread of 4 warps
_TRITON = plt.CompilerParams(num_warps=LANES // 32)


def _cdiv(a, b):
    return -(-a // b)


def _shr_u(x, n):
    return lax.shift_right_logical(x, n)


# ---------------------------------------------------------------------------
# The round step, shared by the kernel and the plain-JAX version. Lane
# state is a tuple (state, c, wb, blo, bhi): the tANS state, the bit
# cursor, and a 64-bit window over words wb (blo) and wb+1 (bhi) of the
# lane's column, kept so that c - 32*wb lies in [0, 32). ``word(row,
# mask)`` reads row ``row`` of each lane's column (0 where masked or out
# of range); ``entry``/``sym_tt``/``nxt`` are per-lane table lookups.
# ---------------------------------------------------------------------------


def _extract(lo, hi, off, nb):
    """Bits [off, off+nb) of the 64-bit pair (hi:lo); off in [0, 32),
    nb in [0, 16]. (hi<<1)<<(31-off) == hi<<(32-off) but is defined at
    off == 0 (no shift reaches 32)."""
    x = _shr_u(lo, off) | lax.shift_left(lax.shift_left(hi, 1), 31 - off)
    return x & (lax.shift_left(jnp.int32(1), nb) - 1)


def _dec_init(sizes, L, word):
    """Open each lane at its top: the cursor starts L bits below the end
    and the first state is those L bits (reference src/fse.rs:363-373)."""
    c = sizes - L
    wb = c >> 5  # floor: a corrupt size < L still keeps c - 32*wb >= 0
    blo, bhi = word(wb), word(wb + 1)
    return _extract(blo, bhi, c - wb * 32, L), c, wb, blo, bhi


def _dec_round(lane, entry, word):
    """Emit each lane's symbol and step its state: read nb bits below
    the cursor. Packed entries are sym<<24 | nb<<16 | base. nb < 32, so
    one window slide per round keeps the invariant."""
    state, c, wb, blo, bhi = lane
    e = entry(state)
    nb = _shr_u(e, 16) & 0xFF
    c = c - nb
    slide = c < wb * 32
    wb = jnp.where(slide, wb - 1, wb)
    nv = word(wb, slide)
    bhi = jnp.where(slide, blo, bhi)
    blo = jnp.where(slide, nv, blo)
    state = (e & 0xFFFF) + _extract(blo, bhi, c - wb * 32, nb)
    return _shr_u(e, 24), (state, c, wb, blo, bhi)


def _enc_init(sym, sym_tt, nxt):
    """new_first_symbol (reference: src/fse.rs:210-218); floor+1 form:
    identical to the reference for table_log <= 14, well-defined at 15
    where the reference underflows (spec.fse Encoder docstring)."""
    tb, fs = sym_tt(sym)
    b0 = _shr_u(tb, 16) + 1
    state = nxt(_shr_u(lax.shift_left(b0, 16) - tb, b0) + fs)
    z = jnp.zeros_like(state)
    return state, z, z, z, z


def _put(lane, val, nbits):
    """Append ``nbits`` bits of ``val`` at the cursor (c - 32*wb < 32,
    nbits <= 16, so they land in the window)."""
    state, c, wb, blo, bhi = lane
    off = c - wb * 32
    blo = blo | lax.shift_left(val, off)
    bhi = bhi | _shr_u(_shr_u(val, 1), 31 - off)
    return state, c + nbits, wb, blo, bhi


def _enc_round(lane, sym, sym_tt, nxt):
    """Encode one symbol (reference src/fse.rs:226-246). Returns the new
    lane state and (row, word, flush): when the window's low word filled,
    the caller stores ``word`` at row ``row`` of the lane's column."""
    state = lane[0]
    tb, fs = sym_tt(sym)
    nbits = _shr_u(tb + state, 16)
    val = state & (lax.shift_left(jnp.int32(1), nbits) - 1)
    lane = _put((nxt(_shr_u(state, nbits) + fs),) + lane[1:], val, nbits)
    state, c, wb, blo, bhi = lane
    flush = c - wb * 32 >= 32
    new = (state, c, jnp.where(flush, wb + 1, wb),
           jnp.where(flush, bhi, blo), jnp.where(flush, 0, bhi))
    return new, (wb, blo, flush)


def _enc_finish(lane, L):
    """Append the final state's low L bits (reference src/fse.rs:248-250).
    Returns (wb, blo, bhi, size): both window words go to rows wb, wb+1."""
    lane = _put(lane, lane[0] & ((1 << L) - 1), L)
    _, c, wb, blo, bhi = lane
    return wb, blo, bhi, c


# ---------------------------------------------------------------------------
# Pallas kernels (Triton route)
# ---------------------------------------------------------------------------


def _lane_ids():
    return pl.program_id(1) * LANES + lax.iota(jnp.int32, LANES)


def _decode_kernel(words_ref, sizes_ref, tbl_ref, out_ref, cur_ref, *,
                   k, W, L, R):
    b, lane = pl.program_id(0), _lane_ids()

    def word(row, mask=True):
        ok = (row >= 0) & (row < W) & mask
        return plt.load(words_ref.at[b, jnp.clip(row, 0, W - 1) * k + lane],
                        mask=ok, other=0)

    def entry(s):
        return tbl_ref[b, s]

    def body(t, st):
        sym, st = _dec_round(st, entry, word)
        out_ref[b, t * k + lane] = sym.astype(jnp.uint8)
        return st

    st = lax.fori_loop(0, R, body, _dec_init(sizes_ref[b, lane], L, word))
    out_ref[b, R * k + lane] = _shr_u(entry(st[0]), 24).astype(jnp.uint8)
    cur_ref[b, lane] = st[1]


def _encode_kernel(blocks_ref, ttb_ref, ttf_ref, stt_ref, words_ref,
                   sizes_ref, *, k, W, L, R):
    b, lane = pl.program_id(0), _lane_ids()

    def sym_at(t):
        return blocks_ref[b, t * k + lane].astype(jnp.int32)

    def sym_tt(s):
        return ttb_ref[b, s], ttf_ref[b, s]

    def nxt(i):
        return stt_ref[b, i]

    def store(row, val, mask=True):
        plt.store(words_ref.at[b, jnp.clip(row, 0, W - 1) * k + lane], val,
                  mask=(row < W) & mask)

    def body(j, st):
        # rounds are consumed in reverse raw order (reference
        # src/lib.rs:120)
        st, (row, val, flush) = _enc_round(st, sym_at(R - 1 - j), sym_tt,
                                           nxt)
        store(row, val, flush)
        return st

    st = lax.fori_loop(0, R, body, _enc_init(sym_at(R), sym_tt, nxt))
    wb, blo, bhi, size = _enc_finish(st, L)
    store(wb, blo)
    store(wb + 1, bhi)
    sizes_ref[b, lane] = size


def _grid_call(kernel, out_shape, args, *, k, interpret, **kw):
    B = args[0].shape[0]
    return pl.pallas_call(
        functools.partial(kernel, k=k, **kw),
        grid=(B, k // LANES),
        out_shape=out_shape,
        compiler_params=_TRITON,
        backend="triton",
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*args)


# ---------------------------------------------------------------------------
# Plain-JAX version: the same round step over all lanes at once
# ---------------------------------------------------------------------------


def _take(tbl, idx):
    return jnp.take_along_axis(tbl, idx, axis=1)


def _decode_xla(words, sizes, tbl, *, k, W, L, R):
    B = words.shape[0]
    lane = jnp.arange(k, dtype=jnp.int32)[None]

    def word(row, mask=True):
        ok = (row >= 0) & (row < W) & mask
        return jnp.where(ok, _take(words, jnp.clip(row, 0, W - 1) * k + lane),
                         0)

    def entry(s):
        return _take(tbl, s)

    def body(t, carry):
        st, out = carry
        sym, st = _dec_round(st, entry, word)
        out = lax.dynamic_update_slice_in_dim(
            out, sym.astype(jnp.uint8)[:, None], t, axis=1)
        return st, out

    out = jnp.zeros((B, R + 1, k), jnp.uint8)
    st, out = lax.fori_loop(0, R, body,
                            (_dec_init(sizes, L, word), out))
    out = out.at[:, R].set(_shr_u(entry(st[0]), 24).astype(jnp.uint8))
    return out.reshape(B, -1), st[1]


def _encode_xla(blocks, ttb, ttf, stt, *, k, W, L, R):
    B = blocks.shape[0]
    lane = jnp.arange(k, dtype=jnp.int32)[None]
    bidx = jnp.arange(B)[:, None]
    syms = blocks.reshape(B, R + 1, k).astype(jnp.int32)

    def sym_tt(s):
        return _take(ttb, s), _take(ttf, s)

    def nxt(i):
        return _take(stt, i)

    def store(words, row, val, mask=True):
        # masked lanes scatter out of range, which mode="drop" discards
        idx = jnp.where((row < W) & mask, row * k + lane, W * k)
        return words.at[bidx, idx].set(val, mode="drop")

    def body(j, carry):
        st, words = carry
        st, (row, val, flush) = _enc_round(st, syms[:, R - 1 - j], sym_tt,
                                           nxt)
        return st, store(words, row, val, flush)

    words = jnp.zeros((B, W * k), jnp.int32)
    st, words = lax.fori_loop(0, R, body,
                              (_enc_init(syms[:, R], sym_tt, nxt), words))
    wb, blo, bhi, size = _enc_finish(st, L)
    words = store(store(words, wb, blo), wb + 1, bhi)
    return words, size


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _platform() -> str:
    platform = jax.default_backend()
    if platform not in ("gpu", "cpu"):
        raise ValueError(f"per-lane coder: unsupported backend {platform!r}"
                         " (gpu or cpu)")
    return platform


def lanes_default() -> bool:
    """``frame.compress``'s ``lanes=None``: the per-lane mode on the GPU,
    the shared-stream mode (ops.coder) on the CPU."""
    return _platform() == "gpu"


def _impl(interpret: bool = False) -> str:
    """Which driver runs the round loop on the default backend: the
    compiled kernel on ``gpu``; the plain-JAX version on ``cpu``; the
    kernel in Pallas interpret mode on either when ``interpret`` is
    asked. Any other backend has no per-lane coder."""
    platform = _platform()
    if interpret:
        return "interpret"
    return "kernel" if platform == "gpu" else "xla"


@functools.partial(jax.jit, static_argnames=("k", "L", "R", "impl"))
def _decode_call(words, sizes, tbl, *, k, L, R, impl):
    """(B, W, k) i32 words, (B, k) sizes, (B, 2^L) packed tables ->
    ((B, (R+1)*k) u8 decoded blocks, (B, k) i32 final cursors: all zero
    for a well-formed stream)."""
    B, W = words.shape[:2]
    args = (words.reshape(B, W * k), sizes, tbl)
    if impl == "xla":
        return _decode_xla(*args, k=k, W=W, L=L, R=R)
    return _grid_call(
        _decode_kernel,
        (jax.ShapeDtypeStruct((B, (R + 1) * k), jnp.uint8),
         jax.ShapeDtypeStruct((B, k), jnp.int32)),
        args, k=k, W=W, L=L, R=R, interpret=impl == "interpret")


@functools.partial(jax.jit, static_argnames=("k", "W", "L", "R", "impl"))
def _encode_call(blocks, ttb, ttf, stt, *, k, W, L, R, impl):
    """(B, (R+1)*k) u8 blocks + per-block tables -> ((B, W*k) i32 lane
    words, (B, k) i32 bit sizes). Rows above a lane's last word are
    unspecified (the lane merge reads only ``sizes`` bits)."""
    B = blocks.shape[0]
    args = (blocks, ttb, ttf, stt)
    if impl == "xla":
        return _encode_xla(*args, k=k, W=W, L=L, R=R)
    return _grid_call(
        _encode_kernel,
        (jax.ShapeDtypeStruct((B, W * k), jnp.int32),
         jax.ShapeDtypeStruct((B, k), jnp.int32)),
        args, k=k, W=W, L=L, R=R, interpret=impl == "interpret")


def _over_mesh(call, args, mesh):
    """Run ``call(*args)`` with every argument's leading (block) axis
    sharded over the mesh's first axis: each device codes its own block
    shard (data parallel, no collectives), and each argument goes
    straight to the devices that own it."""
    if mesh is None:
        return call(*map(jnp.asarray, args))
    from jax.sharding import NamedSharding, PartitionSpec

    spec = PartitionSpec(mesh.axis_names[0])
    args = [jax.device_put(a, NamedSharding(mesh, spec)) for a in args]
    return jax.shard_map(call, mesh=mesh, in_specs=(spec,) * len(args),
                         out_specs=(spec, spec), check_vma=False)(*args)


def _pad_batch(arrays, B, mesh):
    """Pad every array's leading (block) axis from B to a multiple of
    the mesh size with copies of block 0; the padded results are
    discarded."""
    pad = (-B) % mesh.size if mesh is not None else 0
    if not pad:
        return arrays
    return [jnp.concatenate([a, jnp.repeat(a[:1], pad, 0)])
            if isinstance(a, jax.Array)
            else np.concatenate([a, np.repeat(a[:1], pad, 0)])
            for a in arrays]


# ---------------------------------------------------------------------------
# Table builds: host C++ (default when available — microseconds per
# table) or on device (ops.tables, one jit). Identical tables either way.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("L",))
def _dec_tables_dev(norm_tables, *, L):
    packed = jax.vmap(functools.partial(build_decode_table, log2=L))(
        norm_tables)
    return lax.bitcast_convert_type(packed, jnp.int32)


@functools.partial(jax.jit, static_argnames=("L",))
def _enc_tables_dev(norm_tables, *, L):
    tbl, tt_bits, tt_fs = jax.vmap(
        functools.partial(build_encode_table, log2=L))(norm_tables)
    return (tt_bits.astype(jnp.int32), tt_fs.astype(jnp.int32),
            tbl.astype(jnp.int32))


def _host_tables(host_tables):
    from .. import native

    return native.available() if host_tables is None else host_tables


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def decode_lanes(words, sizes, tables, *, k, L, R, interpret=False,
                 mesh=None, lazy=False):
    """Decode B blocks of k per-lane streams.

    words: (B, W, k) uint32 — words[b, w, i] is word w of lane i of block
      b (rows at or past W read as zero; bits above a lane's size are
      never read).
    sizes: (B, k) int32 — per-lane total bit counts.
    tables: (B, 2^L) packed decode tables (sym<<24|nb<<16|base,
      ops.tables / spec.fse / native layout).
    mesh: optional jax.sharding.Mesh — blocks shard over its first axis
      and decode data-parallel.
    Returns the decoded blocks (B, (R+1)*k) uint8 (host numpy). Raises
    ValueError on a corrupt stream (any lane cursor not exactly
    drained). ``lazy=True`` returns a zero-arg collect closure instead:
    the decode is dispatched asynchronously and the sync and error check
    happen when the closure runs (callers pipeline chunks)."""
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
    B, W, kk = words.shape
    if kk != k or k % LANES:
        raise ValueError(f"k must be a multiple of {LANES} and match words")
    impl = _impl(interpret)
    if isinstance(words, np.ndarray):
        words = np.ascontiguousarray(words).view(np.int32)
    else:
        words = lax.bitcast_convert_type(words, jnp.int32)
    if isinstance(tables, np.ndarray):
        tables = np.ascontiguousarray(tables).view(np.int32)
    sizes = np.asarray(sizes, np.int32) if not isinstance(
        sizes, jax.Array) else sizes
    out, cur = _over_mesh(
        functools.partial(_decode_call, k=k, L=L, R=R, impl=impl),
        _pad_batch([words, sizes, tables], B, mesh), mesh)

    def collect():
        if bool(jnp.any(cur != 0)):
            raise ValueError("corrupt stream: lane cursor not drained")
        return np.asarray(out if out.shape[0] == B else out[:B])

    return collect if lazy else collect()


def decode_lanes_norm(words, sizes, norm_tables, *, k, L, R,
                      interpret=False, mesh=None, lazy=False,
                      host_tables=None):
    """``decode_lanes`` from the (B, 256) int32 normalized histograms
    (all sharing table log ``L``). ``host_tables`` picks the table build:
    None = host C++ when available, True/False to force host/device."""
    nt = np.ascontiguousarray(np.asarray(norm_tables), np.int32)
    if _host_tables(host_tables):
        from .. import native

        tables = native.build_decode_tables(nt, L)
    else:
        tables = _dec_tables_dev(jnp.asarray(nt), L=L)
    return decode_lanes(words, sizes, tables, k=k, L=L, R=R,
                        interpret=interpret, mesh=mesh, lazy=lazy)


@functools.partial(jax.jit, static_argnames=("w_act",))
def _head_rows(words, *, w_act):
    return words[:, :w_act]


def encode_lanes(blocks, tables, *, k, L, W, interpret=False, mesh=None,
                 lazy=False):
    """Encode B blocks of k per-lane streams.

    blocks: (B, n) uint8 with n = (R+1)*k, host or device — round r,
      lane i is byte r*k + i; each lane's last byte folds into its
      initial state (reference src/fse.rs:210-218).
    tables: (tt_bits (B, 256), tt_fs (B, 256), next-state table
      (B, 2^L)) — the spec.fse / ops.tables / native encode layout.
    W: word rows to allocate (encode_w_bound).
    Returns (words (B, w_act, k) uint32, sizes (B, k) int32 bit counts),
    host numpy, with w_act the populated rows (bucketed to 16).
    ``lazy=True`` returns a collect closure (see decode_lanes)."""
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
    B, n = blocks.shape
    if n % k or k % LANES:
        raise ValueError(f"k must be a multiple of {LANES} and divide n")
    R = n // k - 1
    impl = _impl(interpret)
    tables = [np.asarray(t, np.uint32).view(np.int32)
              if isinstance(t, np.ndarray) else t.astype(jnp.int32)
              for t in tables]
    words, sizes = _over_mesh(
        functools.partial(_encode_call, k=k, W=W, L=L, R=R, impl=impl),
        _pad_batch([blocks, *tables], B, mesh), mesh)

    def collect():
        # pull the (small) sizes first, then transfer only the word rows
        # that are populated — W is the worst-case bound, typically ~2x
        # the real maximum. w_act is bucketed to multiples of 16 to
        # bound the number of _head_rows compiles.
        s = np.asarray(sizes)[:B]
        w_act = min(_cdiv(int(s.max()) // 32 + 2, 16) * 16, W)
        w = _head_rows(words.reshape(-1, W, k), w_act=w_act)
        return np.asarray(w)[:B].view(np.uint32), s

    return collect if lazy else collect()


def encode_lanes_norm(blocks, norm_tables, *, k, L, W, interpret=False,
                      mesh=None, lazy=False, host_tables=None):
    """``encode_lanes`` from the (B, 256) int32 normalized histograms
    (all sharing table log ``L``); ``host_tables`` as in
    decode_lanes_norm."""
    nt = np.ascontiguousarray(np.asarray(norm_tables), np.int32)
    if _host_tables(host_tables):
        from .. import native

        table, tt_bits, tt_fs = native.build_encode_tables(nt, L)
        tables = (tt_bits, tt_fs, table.astype(np.int32))
    else:
        tables = _enc_tables_dev(jnp.asarray(nt), L=L)
    return encode_lanes(blocks, tables, k=k, L=L, W=W, interpret=interpret,
                        mesh=mesh, lazy=lazy)


def encode_w_bound(R: int, L: int) -> int:
    """Worst-case word rows per lane: R rounds of <= L bits each plus the
    final L-bit state (new_first_symbol emits no bits), plus the window's
    2 rows."""
    return _cdiv(R * L + L, 32) + 2


# ---------------------------------------------------------------------------
# Host-side lane split/merge (wire <-> padded (W, k) layout)
# ---------------------------------------------------------------------------


def lane_split(payload: bytes, sizes_bits: np.ndarray, k: int):
    """Split a wire payload of byte-aligned concatenated lane streams into
    the padded (W, k) uint32 array the decode kernel wants. Returns
    (words (W, k) uint32, W). Uses the C++ native repack when available
    (cache-blocked transpose), else vectorized numpy."""
    sizes_bits = np.asarray(sizes_bits, np.int64)
    assert sizes_bits.shape == (k,)
    nbytes = (sizes_bits + 7) // 8
    W = int((int(sizes_bits.max()) + 31) // 32) + 2
    if int(nbytes.sum()) > len(payload):
        raise ValueError("lane payload too short")
    from .. import native
    if native.available():
        return native.lane_split(bytes(payload), sizes_bits, k, W), W
    offs = np.concatenate([[0], np.cumsum(nbytes)])
    buf = np.frombuffer(payload, np.uint8)
    lane_bytes = np.zeros((k, W * 4), np.uint8)
    idx = offs[:-1, None] + np.arange(W * 4)[None, :]
    mask = np.arange(W * 4)[None, :] < nbytes[:, None]
    np.copyto(lane_bytes, buf[np.minimum(idx, len(buf) - 1)], where=mask)
    words = lane_bytes.view(np.uint32).reshape(k, W).T  # (W, k)
    return np.ascontiguousarray(words), W


def lane_merge(words: np.ndarray, sizes_bits: np.ndarray) -> bytes:
    """Inverse of lane_split: compact padded (W, k) words into byte-aligned
    concatenated lane streams."""
    W, k = words.shape
    sizes_bits = np.asarray(sizes_bits, np.int64)
    from .. import native
    if native.available():
        return native.lane_merge(words, sizes_bits)
    nbytes = (sizes_bits + 7) // 8
    lane_bytes = np.ascontiguousarray(words.T).view(np.uint8).reshape(k, W * 4)
    mask = np.arange(W * 4)[None, :] < nbytes[:, None]
    return lane_bytes[mask].tobytes()


def lane_merge_bits(words: np.ndarray, sizes_bits: np.ndarray) -> bytes:
    """Bit-packed lane merge (frame FLAG_PACKED): lane streams concatenate
    at BIT granularity, recovering the <= 7 dead bits per lane the
    byte-aligned wire carries (the reference's payloads are bit-packed end
    to end, reference: src/bitstream/writer.rs:177-222). C++ native when
    available; Python-int fallback otherwise (tests)."""
    W, k = words.shape
    sizes_bits = np.asarray(sizes_bits, np.int64)
    from .. import native
    if native.available():
        return native.lane_merge_bits(words, sizes_bits)
    # numpy fallback, fully vectorized over lanes: every lane's bytes
    # shift by (bit_offset & 7), so lanes group into at most 8 shift
    # classes; each class is one masked scatter-add of all its lanes'
    # (shifted) bytes at once. O(payload) work, O(8) python iterations.
    cols = np.ascontiguousarray(np.asarray(words, np.uint32).T)  # (k, W)
    cbytes = cols.view(np.uint8).reshape(k, W * 4)
    offs = np.concatenate([[0], np.cumsum(sizes_bits)])
    total = int(offs[-1])
    nb = ((sizes_bits + 7) // 8).astype(np.int64)
    maxnb = int(nb.max()) if k else 0
    lanes = cbytes[:, :maxnb].copy()
    col = np.arange(maxnb)[None, :]
    lanes[col >= nb[:, None]] = 0  # zero bytes past each lane's size
    top = (sizes_bits & 7).astype(np.int64)
    last_mask = np.where(top, (1 << np.maximum(top, 1)) - 1, 0xFF)
    if k and maxnb:  # all-zero sizes: nothing to mask (empty payload)
        lanes[np.arange(k), np.maximum(nb - 1, 0)] &= last_mask.astype(np.uint8)
    out = np.zeros((total + 7) // 8 + 1, np.uint8)
    shift = (offs[:-1] & 7).astype(np.int64)
    for s in range(8):
        rows = np.flatnonzero(shift == s)
        if rows.size == 0:
            continue
        w16 = lanes[rows].astype(np.uint16) << s
        j = (offs[rows] >> 3)[:, None] + col
        valid = col < nb[rows][:, None]
        np.bitwise_or.at(out, j[valid], (w16 & 0xFF).astype(np.uint8)[valid])
        if s:
            np.bitwise_or.at(out, (j + 1)[valid],
                             (w16 >> 8).astype(np.uint8)[valid])
    return out[: (total + 7) // 8].tobytes()


def lane_split_bits(payload: bytes, sizes_bits: np.ndarray, k: int):
    """Inverse of lane_merge_bits into the padded (W, k) uint32 kernel
    layout. Returns (words (W, k) uint32, W)."""
    sizes_bits = np.asarray(sizes_bits, np.int64)
    assert sizes_bits.shape == (k,)
    W = int((int(sizes_bits.max()) + 31) // 32) + 2
    if (int(sizes_bits.sum()) + 7) // 8 > len(payload):
        raise ValueError("packed lane payload too short")
    from .. import native
    if native.available():
        return native.lane_split_bits(bytes(payload), sizes_bits, k, W), W
    # numpy fallback, fully vectorized over lanes (mirror of the merge
    # fallback): lanes group into at most 8 bit-shift classes; each
    # class extracts all its lanes' bytes in one gather + shift pass.
    # O(payload) work, O(8) python iterations.
    buf = np.frombuffer(bytes(payload) + b"\0\0", np.uint8)
    offs = np.concatenate([[0], np.cumsum(sizes_bits)])
    nb = ((sizes_bits + 7) // 8).astype(np.int64)
    maxnb = int(nb.max()) if k else 0
    col = np.arange(maxnb)[None, :]
    cols = np.zeros((k, W * 4), np.uint8)
    shift = (offs[:-1] & 7).astype(np.int64)
    lanes = np.zeros((k, maxnb), np.uint8)
    for s in range(8):
        rows = np.flatnonzero(shift == s)
        if rows.size == 0:
            continue
        j = np.minimum((offs[rows] >> 3)[:, None] + col, len(buf) - 2)
        lo = buf[j]
        if s:
            lo = ((lo >> s)
                  | (buf[j + 1].astype(np.uint16) << (8 - s)).astype(np.uint8))
        lanes[rows] = lo
    lanes[col >= nb[:, None]] = 0
    top = (sizes_bits & 7).astype(np.int64)
    last_mask = np.where(top, (1 << np.maximum(top, 1)) - 1, 0xFF)
    if k and maxnb:  # all-zero sizes: nothing to mask (empty payload)
        lanes[np.arange(k), np.maximum(nb - 1, 0)] &= last_mask.astype(np.uint8)
    cols[:, :maxnb] = lanes
    return np.ascontiguousarray(cols.view(np.uint32).reshape(k, W).T), W


def lane_merge_batch(words, sizes_bits, pack_bits: bool = False):
    """Batched lane merge of a whole block group: ``words (B, W, k)``,
    ``sizes_bits (B, k)`` -> list of per-block wire payloads. One native
    call, OpenMP-parallel over blocks (the per-block merge loop was the
    host-side compress bottleneck — VERDICT r2 item 3); per-block
    fallback otherwise (tests without g++)."""
    words = np.asarray(words)
    sizes_bits = np.asarray(sizes_bits)
    from .. import native
    if native.available():
        return native.lane_merge_batch(words, sizes_bits, pack_bits)
    merge = lane_merge_bits if pack_bits else lane_merge
    return [merge(words[b], sizes_bits[b]) for b in range(words.shape[0])]


def lane_split_batch(payloads, sizes_bits, k: int, W: int,
                     pack_bits: bool = False) -> np.ndarray:
    """Batched inverse of lane_merge_batch: fills the whole group's
    ``(B, W, k)`` uint32 kernel layout in one native call (OpenMP over
    blocks); per-block fallback otherwise."""
    sizes_bits = np.asarray(sizes_bits)
    from .. import native
    if native.available():
        return native.lane_split_batch(payloads, sizes_bits, k, W, pack_bits)
    B = len(payloads)
    out = np.zeros((B, W, k), np.uint32)
    for b in range(B):
        if pack_bits:
            w, _ = lane_split_bits(payloads[b], sizes_bits[b], k)
        else:
            w, _ = lane_split(payloads[b], sizes_bits[b], k)
        out[b, : w.shape[0]] = w
    return out
