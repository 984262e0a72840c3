"""Fault-injection audit of EVERY native emitter.

Round 4's real disk-full event exposed an rc-decided-before-final-flush
bug in ONE writer path; this matrix pins the whole surface: all five
native writers x serial/sharded x plain/BGZF x append, against
/dev/full (ENOSPC on every write). The contract: the wrapper returns
False — never a partial-success rc=0 lie. A second test injects a
mid-emit failure into the CHUNKED pipeline and asserts the run raises,
the worker pools are torn down (the run returns promptly instead of
hanging on queued emits), and the partial outputs are named on stderr.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import datagen
from raft_tpu.io import native


pytestmark = pytest.mark.skipif(
    not os.path.exists("/dev/full"), reason="no /dev/full")


@pytest.fixture(scope="module")
def computed():
    """One small simulated-mode compute: store + ComputeResult params
    for the writers that need real data (fragments, bed)."""
    import tempfile
    if native._get_lib() is None:
        pytest.skip("native lib unavailable")
    with tempfile.TemporaryDirectory() as tmp:
        datagen.standard_case(seed=51, tmpdir=tmp, n_reads=21,
                              simulated=True)
        from raft_tpu.engine_jax import compute_jax
        from raft_tpu.io.fasta import load_reads
        from raft_tpu.io.paf import load_paf
        from raft_tpu.params import AlgoParams
        store = load_reads(f"{tmp}/reads.fasta")
        table = load_paf(f"{tmp}/overlaps.paf", store)
        params = AlgoParams(est_cov=5, repeat_length=2000,
                            interval_length=2000, read_length=4000,
                            overlap_length=200, flanking_length=300)
        params = params.replace(real_reads=store.real_reads,
                                symmetric_overlaps=table.symmetric)
        res = compute_jax(store, table, params)
        assert res.n_frags > 0  # the writers must have bytes to write
        assert int(res.rep_off[-1]) > 0
        yield store, res, params


WRITERS = ["frags", "coverage", "coverage_events", "repeats", "bed"]


def _call_writer(writer, computed, append, gz):
    if writer == "frags":
        store, res, params = computed
        return native.emit_frags_full("/dev/full", store, res,
                                      first_read_num=1, append=append,
                                      gz=gz)
    if writer == "bed":
        store, res, params = computed
        assert not store.real_reads  # sim mode: bed has content
        return native.emit_bed("/dev/full", store, res, append=append,
                               gz=gz)
    if writer == "coverage":
        cov = np.arange(300, dtype=np.int32)
        off = np.asarray([0, 150, 300], dtype=np.int64)
        return native.emit_coverage("/dev/full", cov, off, 2, 50,
                                    append=append, gz=gz)
    if writer == "coverage_events":
        w0 = np.asarray([0, 3, 1, 0], dtype=np.int32)
        w1 = np.asarray([5, 9, 2, 0], dtype=np.int32)
        ev_off = np.asarray([0, 2, 4], dtype=np.int64)
        cov_off = np.asarray([0, 150, 300], dtype=np.int64)
        return native.emit_coverage_events("/dev/full", w0, w1, ev_off,
                                           cov_off, 2, 50, append=append,
                                           gz=gz)
    if writer == "repeats":
        rep_s = np.arange(64, dtype=np.int32)
        rep_e = rep_s + 10
        rep_off = np.asarray([0, 32, 64], dtype=np.int64)
        return native.emit_repeats("/dev/full", rep_s, rep_e, rep_off, 2,
                                   append=append, gz=gz)
    raise AssertionError(writer)


@pytest.mark.parametrize("append", [False, True], ids=["trunc", "append"])
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "bgzf"])
@pytest.mark.parametrize("shards", ["1", "4"], ids=["serial", "sharded"])
@pytest.mark.parametrize("writer", WRITERS)
def test_enospc_reports_failure(computed, monkeypatch, writer, shards,
                                gz, append):
    monkeypatch.setenv("RAFT_EMIT_SHARDS", shards)
    assert _call_writer(writer, computed, append, gz) is False, (
        f"{writer} shards={shards} gz={gz} append={append}: rc=0 on a "
        "full disk — partial-success lie")


def test_real_file_unharmed_after_sharded_failure(computed, monkeypatch,
                                                  tmp_path):
    """Append-mode failure recovery on a REAL file: make the sharded
    writer fail via a count/render divergence... not injectable — so
    instead assert the documented restore contract on /dev/full append
    (base length 0 is preserved trivially) AND that a successful
    append to a real file extends rather than truncates."""
    monkeypatch.setenv("RAFT_EMIT_SHARDS", "4")
    p = str(tmp_path / "out.txt")
    rep_s = np.arange(8, dtype=np.int32)
    rep_e = rep_s + 10
    rep_off = np.asarray([0, 8], dtype=np.int64)
    assert native.emit_repeats(p, rep_s, rep_e, rep_off, 1) is True
    size1 = os.path.getsize(p)
    assert size1 > 0
    assert native.emit_repeats(p, rep_s, rep_e, rep_off, 1,
                               first_read_index=1, append=True) is True
    assert os.path.getsize(p) == 2 * size1


def test_chunked_mid_emit_failure_tears_down(tmp_path, monkeypatch,
                                             capsys):
    """A mid-run emit failure in the streaming pipeline must raise,
    shut the worker pools down promptly, and name the partial outputs
    on stderr."""
    import time

    from raft_tpu import emit
    from raft_tpu.params import AlgoParams
    from raft_tpu.pipeline import run_pipeline

    tmp = str(tmp_path)
    datagen.standard_case(seed=52, tmpdir=tmp, n_reads=41)
    params = AlgoParams(est_cov=5, repeat_length=2000,
                        interval_length=2000, read_length=4000,
                        overlap_length=200, flanking_length=300,
                        outputfilename=os.path.join(tmp, "out"))

    calls = {"n": 0}
    real = emit.write_long_repeats

    def boom(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 2:  # second chunk: simulate an I/O failure
            raise OSError(28, "No space left on device")
        return real(*a, **k)

    monkeypatch.setattr(emit, "write_long_repeats", boom)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        run_pipeline(f"{tmp}/reads.fasta", f"{tmp}/overlaps.paf", params,
                     chunk_reads=7, verbose=False)
    assert time.monotonic() - t0 < 60  # pools drained, no hang
    err = capsys.readouterr().err
    assert "PARTIAL" in err
    assert "out.long_repeats.txt" in err
