"""The GPU smoke script's own checks, on the CPU: its byte-compare and
report helpers, and that it refuses to run (no result line) without a
GPU or outside a checkout."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _pair(tmp_path, a: bytes, b: bytes):
    pa, pb = tmp_path / "a", tmp_path / "b"
    pa.write_bytes(a)
    pb.write_bytes(b)
    return str(pa), str(pb)


@pytest.mark.parametrize("pos", [0, 4096, "last", "length"])
def test_first_difference_catches_one_byte(tmp_path, pos):
    base = bytes(range(256)) * 64
    other = bytearray(base)
    if pos == "length":
        other = other[:-1]
        want = len(base) - 1
    else:
        want = len(base) - 1 if pos == "last" else pos
        other[want] ^= 1
    a, b = _pair(tmp_path, base, bytes(other))
    assert chip_smoke.first_difference(a, a) is None
    assert chip_smoke.first_difference(a, b) == want


def test_compare_outputs_names_the_file(tmp_path):
    for run in ("x", "y"):
        for ext in chip_smoke.OUTPUTS:
            (tmp_path / f"{run}{ext}").write_bytes(b"same\n" * 10)
    assert chip_smoke.compare_outputs(str(tmp_path / "x"),
                                      str(tmp_path / "y")) == []
    (tmp_path / "y.long_repeats.bed").write_bytes(b"same\n" * 9 + b"Same\n")
    bad = chip_smoke.compare_outputs(str(tmp_path / "x"),
                                     str(tmp_path / "y"))
    assert bad == [".long_repeats.bed: first difference at byte 45"]
    os.remove(tmp_path / "x.coverage.txt")
    assert ".coverage.txt: missing" in chip_smoke.compare_outputs(
        str(tmp_path / "x"), str(tmp_path / "y"))


def test_report_lines_drop_only_volatile_lines():
    out = ("INFO, printParams(), reso = 50\nReal Reads 0 \n"
           "INFO, main(), program completed after 1.5 seconds\n"
           "INFO, main(), CMD: raft -e 30 x y\nPROFILE, emit: 0.1 s\n"
           "fraction_of_repeat_length 0.1 \n")
    assert chip_smoke.report_lines(out) == [
        "INFO, printParams(), reso = 50", "Real Reads 0 ",
        "fraction_of_repeat_length 0.1 "]


@pytest.mark.parametrize("alone", [False, True])
def test_smoke_fails_without_gpu(tmp_path, alone):
    """Held to the CPU — or copied into a directory without the repo —
    the script exits non-zero and prints no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "FAILED" in res.stderr
    assert not (tmp_path / ".smoke").exists()
