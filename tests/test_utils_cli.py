"""Utils (metrics/profiling) and CLI smoke tests on real file data."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from entropy_coders_tpu import frame as F
from entropy_coders_tpu.utils import frame_stats, timed


def _real_data(n=32 << 10) -> bytes:
    """Real text from the repo (SURVEY.md + README.md), cycled to n."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    buf = b""
    for f in ("SURVEY.md", "README.md", "FORMAT.md"):
        buf += open(os.path.join(root, f), "rb").read()
    return (buf * (n // len(buf) + 1))[:n]


def test_frame_stats_real_text():
    data = _real_data()
    comp = F.compress(data, block_size=16 << 10, k=128, lanes=True,
                      interpret=True)
    st = frame_stats(comp)
    assert st.total_len == len(data)
    assert st.compressed_len == len(comp)
    assert st.ratio < 0.75  # markdown text compresses well
    assert st.mode_counts.get("fse_pl", 0) >= 2
    assert 0 < st.overhead < 0.2
    # every FSE-coded block contributes its table log to the breakdown
    assert sum(st.table_log_counts.values()) == sum(
        st.mode_counts.get(m, 0) for m in ("fse", "fse_pl"))
    assert F.decompress(comp, interpret=True) == data


def test_ratio_close_to_reference_format():
    """The container (per-lane mode) must not cost more than a few percent
    vs the reference's own single-frame format on real text."""
    import entropy_coders_tpu as ect

    data = _real_data(32 << 10)
    ref = bytearray()
    ect.fse_compress(data, ref, k=2)  # reference-identical frame
    comp = F.compress(data, block_size=32 << 10, k=128, lanes=True,
                      interpret=True)
    assert len(comp) < len(ref) * 1.06, (len(comp), len(ref))


def test_timed_helper():
    results = []
    with timed("x", nbytes=1000, results=results) as r:
        pass
    assert results and results[0].seconds >= 0
    assert "x:" in str(results[0])


def test_cli_roundtrip(tmp_path):
    data = _real_data(16 << 10)
    fin = tmp_path / "in.bin"
    fc = tmp_path / "c.fset"
    fout = tmp_path / "out.bin"
    fin.write_bytes(data)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "entropy_coders_tpu", "compress", str(fin),
         str(fc), "--block-size", "8192", "--k", "64", "--no-lanes",
         "--bit-pack"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    r = subprocess.run(
        [sys.executable, "-m", "entropy_coders_tpu", "decompress", str(fc),
         str(fout)], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    assert fout.read_bytes() == data
    r = subprocess.run(
        [sys.executable, "-m", "entropy_coders_tpu", "stat", str(fc)],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ratio=" in r.stdout


def test_cli_fast_budget_table_log(tmp_path):
    """--table-log fast:EPS parses to the ("fast", eps) policy form and
    round-trips through the file CLI."""
    data = _real_data(16 << 10)
    fin = tmp_path / "in.bin"
    fc = tmp_path / "c.fset"
    fout = tmp_path / "out.bin"
    fin.write_bytes(data)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "entropy_coders_tpu", "compress", str(fin),
         str(fc), "--block-size", "8192", "--k", "64", "--no-lanes",
         "--table-log", "fast:0.02"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    r = subprocess.run(
        [sys.executable, "-m", "entropy_coders_tpu", "decompress", str(fc),
         str(fout)], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    assert fout.read_bytes() == data
