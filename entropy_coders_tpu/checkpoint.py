"""Compressed pytree checkpoints over the container format.

A natural deployment of this codec is squeezing model state:
``save_pytree`` flattens a pytree of (jax or numpy) arrays, concatenates
the leaf bytes, and FSE-compresses them into one container frame behind
a small JSON manifest; ``load_pytree`` restores the identical tree. The
reference's "checkpoint" is its frame (SURVEY.md §5 — the histogram
header fully reconstructs the decode state, reference:
src/histogram.rs:436-505); this module is the framework-level
generalization: the artifact IS a frame, so everything the container
gives — device encode/decode, per-block CRCs, bit packing, range
decode — applies to checkpoints for free.

Random access rides the container's independently-decodable blocks: a
``Checkpoint`` handle parses the frame once and ``load_leaf`` decodes
only the blocks overlapping one tensor's byte range, so restoring a
single layer from a multi-GiB checkpoint costs O(layer), not O(model).

File layout (little-endian hosts):

    b"FSCK" | u8 version | u8 reserved | u16 reserved
    | u32 manifest_len | manifest (UTF-8 JSON) | container frame

Manifest: ``{"skel": <structure skeleton>, "leaves": [{"path", "dtype",
"shape", "offset", "nbytes"}, ...]}`` — offsets into the decompressed
byte stream. Supported pytree nodes: dict (str keys), list, tuple,
None; leaves are arrays or scalars convertible by ``np.asarray`` (bf16
et al. via ml_dtypes). Exotic custom nodes raise — no pickle is ever
used, so a checkpoint file cannot execute code on load.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np

from . import frame as F
from .stream import _mkstemp_for

__all__ = ["save_pytree", "load_pytree", "Checkpoint"]

_MAGIC = b"FSCK"
_VERSION = 1

# bf16/f8 dtypes resolve through numpy only after ml_dtypes registers
# them; jax depends on ml_dtypes so this import is always available.
try:  # pragma: no cover - present in every supported environment
    import ml_dtypes  # noqa: F401
except ImportError:
    pass


# --- pytree structure (no jax dependency: plain recursion) -----------------


def _flatten(tree, path, leaves):
    """Structure skeleton of ``tree`` with leaves replaced by indices
    into ``leaves`` (appended in deterministic traversal order)."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str):
                raise TypeError(
                    f"checkpoint dict keys must be str, got {type(k).__name__}"
                    f" at {'/'.join(path) or '<root>'}")
        keys = sorted(tree)  # deterministic bytes for identical trees
        return {"t": "dict", "k": keys,
                "v": [_flatten(tree[k], path + [k], leaves) for k in keys]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "v": [_flatten(v, path + [str(i)], leaves)
                      for i, v in enumerate(tree)]}
    arr = np.asarray(tree)
    if arr.dtype == object:
        raise TypeError(f"unsupported leaf type {type(tree).__name__} at "
                        f"{'/'.join(path) or '<root>'}")
    leaves.append(("/".join(path), arr))
    return {"t": "leaf", "i": len(leaves) - 1}


def _unflatten(skel, leaves):
    t = skel["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _unflatten(v, leaves)
                for k, v in zip(skel["k"], skel["v"])}
    if t in ("list", "tuple"):
        seq = [_unflatten(v, leaves) for v in skel["v"]]
        return seq if t == "list" else tuple(seq)
    if t == "leaf":
        return leaves[skel["i"]]
    raise ValueError(f"corrupt manifest: unknown node type {t!r}")


def _leaf_bytes(arr: np.ndarray) -> bytes:
    a = np.ascontiguousarray(arr)
    if a.dtype.byteorder == ">":  # store little-endian on the wire
        a = a.astype(a.dtype.newbyteorder("<"))
    return a.tobytes()


def _restore_leaf(buf, meta) -> np.ndarray:
    # corruption contract (mirrors the frame's, tests/test_golden.py
    # manifest fuzz): a malformed manifest raises ValueError, never a
    # raw TypeError/IndexError from numpy internals
    try:
        dt = np.dtype(meta["dtype"])
        arr = np.frombuffer(buf, dt.newbyteorder("<") if dt.itemsize > 1
                            else dt)
        return arr.reshape(meta["shape"]).astype(dt, copy=False)
    except (TypeError, KeyError, IndexError) as e:
        raise ValueError(f"corrupt checkpoint manifest: {e!r}") from e


# --- save -------------------------------------------------------------------


def save_pytree(path, tree, *, align: int = 64, **compress_kw) -> int:
    """Compress ``tree`` into checkpoint file ``path``; returns the file
    size in bytes. ``compress_kw`` pass through to ``frame.compress``
    (``block_size``, ``k``, ``table_log``, ``checksum``, ``bit_pack``,
    ``lanes``, ``interpret``...). Leaves are packed at ``align``-byte
    offsets (aligned zero padding compresses to ~nothing and keeps
    ``load_leaf`` reads word-aligned). The write is atomic: a
    same-directory temp file renamed over ``path`` only on success."""
    leaves: list[tuple[str, np.ndarray]] = []
    skel = _flatten(tree, [], leaves)
    metas, parts, off = [], [], 0
    for name, arr in leaves:
        b = _leaf_bytes(arr)
        pad = (-off) % align
        if pad:
            parts.append(b"\0" * pad)
            off += pad
        metas.append({"path": name, "dtype": arr.dtype.name,
                      "shape": list(arr.shape), "offset": off,
                      "nbytes": len(b)})
        parts.append(b)
        off += len(b)
    manifest = json.dumps({"skel": skel, "leaves": metas},
                          separators=(",", ":")).encode()
    payload = b"".join(parts)
    comp = F.compress(np.frombuffer(payload, np.uint8), **compress_kw) \
        if payload else F.compress(b"", **compress_kw)
    fout, tmp_path = _mkstemp_for(path)
    try:
        with fout:
            fout.write(_MAGIC + struct.pack("<BBHI", _VERSION, 0, 0,
                                            len(manifest)))
            fout.write(manifest)
            fout.write(comp)
            total = fout.tell()
        os.replace(tmp_path, path)
    except BaseException:
        try:
            fout.close()
        except OSError:
            pass
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
    return total


# --- load -------------------------------------------------------------------


class Checkpoint:
    """Open checkpoint handle: manifest parsed, frame parsed ONCE, file
    memory-mapped — ``load_leaf`` range-decodes only the blocks under
    one tensor. Usable as a context manager (closes the mmap)."""

    def __init__(self, path):
        self._f = open(path, "rb")
        try:
            try:
                self._mm = mmap.mmap(self._f.fileno(), 0,
                                     access=mmap.ACCESS_READ)
            except ValueError:
                raise ValueError("truncated checkpoint: empty file")
            head = bytes(self._mm[:12])
            if len(head) < 12 or head[:4] != _MAGIC:
                raise ValueError("not an FSCK checkpoint")
            ver, _, _, mlen = struct.unpack_from("<BBHI", head, 4)
            if ver != _VERSION:
                raise ValueError(f"unsupported checkpoint version {ver}")
            if len(self._mm) < 12 + mlen:
                raise ValueError("truncated checkpoint: manifest")
            try:
                man = json.loads(bytes(self._mm[12: 12 + mlen]))
                self._skel = man["skel"]
                self._leaves = man["leaves"]
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(f"corrupt checkpoint manifest: {e!r}") from e
            self._by_path = {m["path"]: m for m in self._leaves}
            self._pf = F._parse_frame(memoryview(self._mm)[12 + mlen:])
        except BaseException:
            self.close()
            raise

    # -- introspection --
    @property
    def leaf_paths(self) -> list[str]:
        return [m["path"] for m in self._leaves]

    def leaf_meta(self, path: str) -> dict:
        """{"path", "dtype", "shape", "offset", "nbytes"} for one leaf."""
        if path not in self._by_path:
            raise KeyError(f"no leaf {path!r} in checkpoint")
        return dict(self._by_path[path])

    # -- decode --
    def load_leaf(self, path: str) -> np.ndarray:
        """Decode ONE tensor: touches only the frame blocks overlapping
        its byte range (O(tensor), not O(checkpoint))."""
        m = self.leaf_meta(path)
        try:
            buf = F._decompress_parsed(self._pf, start=m["offset"],
                                       length=m["nbytes"])
        except (TypeError, KeyError) as e:  # non-int offset/nbytes etc.
            raise ValueError(f"corrupt checkpoint manifest: {e!r}") from e
        return _restore_leaf(buf, m)

    def load(self):
        """Decode the full tree (one whole-frame decompress: batched
        device kernels, not per-leaf ranges)."""
        out = bytearray(self._pf.total_len)
        if self._pf.total_len:
            F._decompress_parsed(self._pf, out=out)
        view = memoryview(out)
        try:
            arrs = [
                _restore_leaf(view[m["offset"]: m["offset"] + m["nbytes"]],
                              m)
                for m in self._leaves
            ]
            return _unflatten(self._skel, arrs)
        except (TypeError, KeyError, IndexError) as e:  # corruption
            raise ValueError(f"corrupt checkpoint manifest: {e!r}") from e

    def close(self):
        if getattr(self, "_mm", None) is not None:
            try:
                self._mm.close()
            except BufferError:  # live numpy views of lazily-kept ranges
                pass
            self._mm = None
        if getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_pytree(path, *, leaves=None):
    """Restore a checkpoint written by ``save_pytree``.

    ``leaves=None``: the full tree. ``leaves=[names...]``: a dict
    ``{name: array}`` decoded via per-leaf range access (restoring a few
    layers of a huge checkpoint never decompresses the rest)."""
    with Checkpoint(path) as ck:
        if leaves is None:
            return ck.load()
        return {name: ck.load_leaf(name) for name in leaves}
