"""--auto-e self-estimated coverage.

The estimator reads est_cov off the per-window pileup distribution
(median of nonzero coverage, fixed-point tail exclusion, x1.15 upward
safety bias — raft_tpu/auto_e.py documents the measurements behind each
step). These tests pin: the estimator math, native/numpy histogram
equality, path-independence of the estimate (whole-file vs chunked vs
spill), and that an --auto-e run is byte-identical to ``-e <estimate>``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import datagen
from raft_tpu import auto_e


def test_estimator_recovers_poisson_center():
    """A Poisson(30)-shaped histogram must estimate ceil(30*1.15)=35."""
    rng = np.random.default_rng(0)
    cov = rng.poisson(30, size=200_000)
    hist = np.bincount(cov, minlength=auto_e.HIST_LEN).astype(np.int64)
    info = auto_e.estimate_from_hist(hist, cov_mul=1.5)
    assert info["refined_median"] in (29, 30)
    assert info["est_cov"] == int(np.ceil(info["refined_median"] * 1.15))


def test_estimator_ignores_repeat_tail():
    """A bimodal histogram (base coverage 20 + a 25% repeat tail at 60)
    must estimate from the base peak, not the mixture mean (~30)."""
    rng = np.random.default_rng(1)
    cov = np.concatenate([rng.poisson(20, 150_000),
                          rng.poisson(60, 50_000)])
    hist = np.bincount(cov, minlength=auto_e.HIST_LEN).astype(np.int64)
    info = auto_e.estimate_from_hist(hist, cov_mul=1.5)
    assert 19 <= info["refined_median"] <= 21


def test_estimator_no_signal():
    hist = np.zeros(100, dtype=np.int64)
    assert auto_e.estimate_from_hist(hist, 1.5)["est_cov"] == 0
    hist[0] = 10_000  # only zero-coverage windows: still no signal
    assert auto_e.estimate_from_hist(hist, 1.5)["est_cov"] == 0


def test_native_hist_equals_numpy():
    rng = np.random.default_rng(7)
    n = 300
    reso = 50
    lens = rng.integers(reso, 5000, n).astype(np.int64)
    nw = -(-lens // reso)
    counts = rng.integers(0, 30, n)
    ev_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    m = int(ev_off[-1])
    rid = np.repeat(np.arange(n), counts)
    w0 = np.array([rng.integers(-2, nw[r] + 2) for r in rid],
                  dtype=np.int32)
    span = rng.integers(0, 40, m)
    w1 = (w0 + span - 1).astype(np.int32)  # includes empty + oob spans
    from raft_tpu.io import native
    h_nat = native.cov_hist(w0, w1, ev_off, lens, reso, auto_e.HIST_LEN)
    if h_nat is None:
        pytest.skip("native library unavailable")
    h_np = auto_e._cov_histogram_numpy(ev_off, w0, w1, lens, reso)
    np.testing.assert_array_equal(h_nat, h_np)


def _run_cli(args, cwd):
    from raft_tpu import cli
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return cli.main(args)
    finally:
        os.chdir(old)


FLAGS = ["-p", "2000", "-l", "4000", "-f", "300", "-v", "200"]


def _read_est(capsys):
    err = capsys.readouterr().err
    for line in err.splitlines():
        if "--auto-e estimated est_cov = " in line:
            return int(line.split("est_cov = ")[1].split()[0])
    raise AssertionError(f"no auto-e estimate on stderr:\n{err}")


def test_auto_e_matches_explicit_e(tmp_path, capsys):
    """--auto-e output must be byte-identical to -e <estimate>, and the
    info line shows est_cov = auto instead of 0."""
    tmp = str(tmp_path)
    datagen.standard_case(seed=31, tmpdir=tmp, n_reads=41)
    reads, paf = f"{tmp}/reads.fasta", f"{tmp}/overlaps.paf"
    assert _run_cli(["--auto-e", *FLAGS, "-o", "ae", reads, paf], tmp) == 0
    cap = capsys.readouterr()
    assert "est_cov = auto" in cap.out
    est = None
    for line in cap.err.splitlines():
        if "--auto-e estimated est_cov = " in line:
            est = int(line.split("est_cov = ")[1].split()[0])
    assert est and est > 0
    assert "HINT" not in cap.err  # advisory suppressed in auto mode
    assert _run_cli(["-e", str(est), *FLAGS, "-o", "ex", reads, paf],
                    tmp) == 0
    capsys.readouterr()
    for ext in (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
                ".long_repeats.bed"):
        a = open(f"{tmp}/ae{ext}", "rb").read()
        b = open(f"{tmp}/ex{ext}", "rb").read()
        assert a == b, ext


def test_auto_e_supplied_e_is_ignored_with_notice(tmp_path, capsys):
    tmp = str(tmp_path)
    datagen.standard_case(seed=32, tmpdir=tmp, n_reads=41)
    reads, paf = f"{tmp}/reads.fasta", f"{tmp}/overlaps.paf"
    assert _run_cli(["--auto-e", "-e", "999", *FLAGS, "-o", "ai",
                     reads, paf], tmp) == 0
    cap = capsys.readouterr()
    assert "ignoring supplied -e 999" in cap.err
    assert "est_cov = 999" in cap.out  # supplied value still echoes


@pytest.mark.parametrize("mode", [["--chunk-reads", "7"],
                                  ["--chunk-reads", "7", "--spill-paf"]])
def test_auto_e_streaming_paths_same_estimate(tmp_path, capsys, mode):
    """Chunked and spill paths must derive the SAME estimate and the
    same bytes as the whole-file path."""
    tmp = str(tmp_path)
    datagen.standard_case(seed=33, tmpdir=tmp, n_reads=41)
    reads, paf = f"{tmp}/reads.fasta", f"{tmp}/overlaps.paf"
    assert _run_cli(["--auto-e", *FLAGS, "-o", "wf", reads, paf], tmp) == 0
    est_wf = _read_est(capsys)
    assert _run_cli(["--auto-e", *FLAGS, *mode, "-o", "ck",
                     reads, paf], tmp) == 0
    est_ck = _read_est(capsys)
    assert est_ck == est_wf
    for ext in (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
                ".long_repeats.bed"):
        a = open(f"{tmp}/wf{ext}", "rb").read()
        b = open(f"{tmp}/ck{ext}", "rb").read()
        assert a == b, ext


def test_auto_e_oracle_engine(tmp_path, capsys):
    """The oracle engine (pure-numpy events path) estimates too."""
    tmp = str(tmp_path)
    datagen.standard_case(seed=34, tmpdir=tmp, n_reads=21)
    reads, paf = f"{tmp}/reads.fasta", f"{tmp}/overlaps.paf"
    assert _run_cli(["--auto-e", "--engine", "oracle", *FLAGS, "-o", "oe",
                     reads, paf], tmp) == 0
    assert _read_est(capsys) > 0


def test_auto_e_missing_e_without_flag_still_errors(tmp_path, capsys):
    tmp = str(tmp_path)
    datagen.standard_case(seed=35, tmpdir=tmp, n_reads=5)
    with pytest.raises(SystemExit):
        _run_cli([*FLAGS, "-o", "x", f"{tmp}/reads.fasta",
                  f"{tmp}/overlaps.paf"], tmp)
    cap = capsys.readouterr()
    assert "estimated coverage must be set properly" in cap.out


def test_auto_e_no_signal_is_friendly_error(tmp_path, capsys):
    """A PAF whose every interval is empty leaves no covered window:
    --auto-e must present an actionable ERROR (rc 1), not a traceback
    (r5 self-review finding 6)."""
    tmp = str(tmp_path)
    datagen.standard_case(seed=36, tmpdir=tmp, n_reads=5)
    # rewrite the PAF with end=0 matches only: hi = end-1 = -1 is an
    # invalid (empty) event on every path, so NO window is covered
    # (end=5 would not work: [5,4] still bins to window 0, which the
    # reference also counts)
    paf = f"{tmp}/overlaps.paf"
    rows = [ln.split("\t") for ln in open(paf).read().splitlines() if ln]
    with open(paf, "w") as f:
        for c in rows[:4]:
            c[2], c[3], c[7], c[8] = "0", "0", "0", "0"
            f.write("\t".join(c) + "\n")
    rc = _run_cli(["--auto-e", *FLAGS, "-o", "ns",
                   f"{tmp}/reads.fasta", paf], tmp)
    assert rc == 1
    cap = capsys.readouterr()
    assert "ERROR, --auto-e: no covered window" in cap.err
    assert "Traceback" not in cap.err
