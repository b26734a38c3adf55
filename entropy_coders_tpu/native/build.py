"""Build the native host codec shared library with g++.

Usage: ``python -m entropy_coders_tpu.native.build`` (or it builds lazily
on first import of ``entropy_coders_tpu.native``).

Two artifacts:

* ``libfse_native.so`` — the PORTABLE binary (no ``-march``), built
  from ``fse_native.cpp`` at first use (never committed) and shipped in
  wheels. A binary that dlopen
  accepts but that uses unsupported vector instructions dies with an
  uncatchable SIGILL at the first call, so anything that can travel
  between machines must be portable.
* ``libfse_native.local.so`` — an optional ``-march=native``-tuned build
  for THIS machine only (gitignored, never shipped). Opt in with env
  ``ECT_NATIVE_TUNED=1``; it is preferred at load time when present and
  fresh.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

SRC = Path(__file__).parent / "fse_native.cpp"
LIB = Path(__file__).parent / "libfse_native.so"
LOCAL = Path(__file__).parent / "libfse_native.local.so"


def _compile(out: Path, arch: list[str]) -> None:
    # build beside the target and rename into place: processes that
    # build concurrently (parallel test workers) never load a partly
    # written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", *arch, "-std=c++17", "-shared", "-fPIC",
        "-fopenmp", "-o", str(tmp), str(SRC),
    ]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError:
            # toolchains without libgomp: the pragmas degrade to serial
            cmd.remove("-fopenmp")
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _fresh(p: Path) -> bool:
    return p.exists() and p.stat().st_mtime >= SRC.stat().st_mtime


def build(force: bool = False) -> Path:
    """Return the shared library to load, building as needed.

    Preference order: a fresh machine-tuned ``.local.so`` (only ever
    produced on this machine, so it is safe to execute here), else the
    portable ``.so`` (shipped in wheels — safe everywhere), built if
    stale or missing. ``ECT_NATIVE_TUNED=1`` builds the tuned local
    binary; ``ECT_NATIVE_PORTABLE=1`` (wheel builds) forces the portable
    target even when a tuned build was requested."""
    portable_only = bool(os.environ.get("ECT_NATIVE_PORTABLE"))
    want_tuned = bool(os.environ.get("ECT_NATIVE_TUNED")) and not portable_only
    if want_tuned:
        if force or not _fresh(LOCAL):
            _compile(LOCAL, ["-march=native"])
        return LOCAL
    if not force and _fresh(LOCAL) and not portable_only:
        return LOCAL
    if force or not _fresh(LIB):
        _compile(LIB, [])
    return LIB


if __name__ == "__main__":
    print(build(force=True))
