"""Native I/O equivalence: the C++ parsers (streaming AND multi-threaded
mmap paths) must produce exactly what the pure-Python parsers produce."""

from __future__ import annotations

import os

import numpy as np
import pytest

import datagen
from raft_tpu.io.fasta import _load_reads_py, load_reads
from raft_tpu.io.paf import _load_paf_py, load_paf


def _assert_stores_equal(a, b):
    """Content equality. seq_off layouts may legitimately differ: the
    native single-line fast path is ZERO-COPY (absolute offsets into the
    source buffer) while the python store is contiguous — per-read bytes
    are the contract."""
    assert a.names == b.names
    assert a.real_reads == b.real_reads
    np.testing.assert_array_equal(np.asarray(a.lens), np.asarray(b.lens))
    for i in range(a.n_reads):
        sa, sb = a.seq(i), b.seq(i)
        sa = bytes(sa) if not isinstance(sa, bytes) else sa
        sb = bytes(sb) if not isinstance(sb, bytes) else sb
        assert sa == sb, f"read {i} sequence differs"


def _assert_tables_equal(a, b):
    assert a.symmetric == b.symmetric
    for col in ("a_id", "b_id", "a_start", "a_end", "b_start", "b_end"):
        np.testing.assert_array_equal(np.asarray(getattr(a, col)),
                                      np.asarray(getattr(b, col)),
                                      err_msg=col)


@pytest.mark.parametrize("mode", [
    dict(), dict(simulated=True), dict(symmetric=True), dict(gz=True),
    dict(fastq=True), dict(multiline=True),
])
def test_native_equals_python(tmp_path, mode):
    reads_path, paf_path = datagen.standard_case(
        seed=55, tmpdir=str(tmp_path), n_reads=25, **mode)
    ns = load_reads(reads_path, use_native=True)
    ps = _load_reads_py(reads_path)
    _assert_stores_equal(ns, ps)
    nt = load_paf(paf_path, ns, use_native=True)
    pt = _load_paf_py(paf_path, ps)
    _assert_tables_equal(nt, pt)


@pytest.mark.parametrize("mode", [
    dict(), dict(simulated=True), dict(symmetric=True), dict(multiline=True),
])
def test_threaded_equals_python(tmp_path, mode, monkeypatch):
    """Force the multi-threaded mmap path (threshold 0) on plain files."""
    monkeypatch.setenv("RAFT_IO_MT_THRESHOLD", "1")
    monkeypatch.setenv("RAFT_IO_THREADS", "5")
    reads_path, paf_path = datagen.standard_case(
        seed=56, tmpdir=str(tmp_path), n_reads=40, **mode)
    ns = load_reads(reads_path, use_native=True)
    ps = _load_reads_py(reads_path)
    _assert_stores_equal(ns, ps)
    nt = load_paf(paf_path, ns, use_native=True)
    pt = _load_paf_py(paf_path, ps)
    _assert_tables_equal(nt, pt)


def test_threaded_final_line_no_newline(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_IO_MT_THRESHOLD", "1")
    monkeypatch.setenv("RAFT_IO_THREADS", "3")
    rp = str(tmp_path / "r.fasta")
    with open(rp, "w") as f:
        f.write(">a\nACGT\nTTTT\n>b x y\nGGGG")  # no trailing newline
    ns = load_reads(rp, use_native=True)
    assert ns.names == ["a", "b"]
    assert bytes(ns.seq_blob) == b"ACGTTTTTGGGG"
    pp = str(tmp_path / "o.paf")
    with open(pp, "w") as f:
        f.write("a\t8\t0\t4\t+\tb\t4\t0\t4\t4\t4\t60")  # no newline
    nt = load_paf(pp, ns, use_native=True)
    assert nt.n_rows == 1
    assert nt.a_id[0] == 0 and nt.b_id[0] == 1


def test_threaded_unknown_name_falls_back(tmp_path, monkeypatch):
    """PAF naming a read absent from the FASTA: the threaded path defers
    to the streaming interner (reference semantics: new id assigned)."""
    monkeypatch.setenv("RAFT_IO_MT_THRESHOLD", "1")
    rp = str(tmp_path / "r.fasta")
    with open(rp, "w") as f:
        f.write(">a\nACGTACGT\n")
    pp = str(tmp_path / "o.paf")
    with open(pp, "w") as f:
        f.write("a\t8\t0\t4\t+\tGHOST\t4\t0\t4\t4\t4\t60\n")
    ns = load_reads(rp, use_native=True)
    nt = load_paf(pp, ns, use_native=True)
    assert nt.a_id[0] == 0
    assert nt.b_id[0] == 1  # interned past the FASTA ids


def test_preparse_resolve_equals_load_paf(tmp_path):
    """The two-phase PAF load (preparse concurrent-capable + resolve)
    must produce exactly what load_paf produces — including unknown
    names interned in file first-seen order (the reference's
    create_pileup behavior, chop.hpp:160-163) and the symmetric flag."""
    from raft_tpu.io import native

    rp = str(tmp_path / "r.fasta")
    with open(rp, "w") as f:
        f.write(">a\nACGTACGT\n>b\nGGGGCCCC\n")
    pp = str(tmp_path / "o.paf")
    with open(pp, "w") as f:
        # known-known, known-unknown, unknown-unknown (new ids 2, 3, 4
        # in encounter order), plus the mirror of row 0 → symmetric
        f.write("a\t8\t0\t4\t+\tb\t8\t2\t6\t4\t4\t60\n"
                "a\t8\t1\t5\t+\tGHOST1\t9\t0\t4\t4\t4\t60\n"
                "GHOST2\t7\t0\t3\t+\tGHOST3\t7\t1\t4\t3\t3\t60\n"
                "b\t8\t2\t6\t+\ta\t8\t0\t4\t4\t4\t60\n")
    s1 = native.load_reads(rp)
    t1 = native.load_paf(pp, s1)
    s2 = native.load_reads(rp)
    pre = native.preparse_paf(pp)
    assert pre is not None
    t2 = native.resolve_paf(pre, s2)
    assert t2 is not None
    assert t2.symmetric == t1.symmetric is True
    assert t2.n_names == t1.n_names == 5
    for col in ("a_id", "b_id", "a_start", "a_end", "b_start", "b_end"):
        np.testing.assert_array_equal(
            np.asarray(getattr(t1, col)), np.asarray(getattr(t2, col)),
            err_msg=col)


def test_sim_meta_degenerate_names_fall_back(tmp_path):
    """Simulated-mode stores whose non-first names lack the expected
    delimiters must fall back to the per-name python parse (native
    sim_meta returns NULL) and still match the python loader."""
    from raft_tpu.io.fasta import _load_reads_py

    rp = str(tmp_path / "r.fasta")
    with open(rp, "w") as f:
        f.write(">read=1,forward,position=10-20,length=10,chr1\n"
                "ACGTACGTAC\n"
                ">weird_name_no_commas\nGGGG\n")
    ns = load_reads(rp, use_native=True)
    ps = _load_reads_py(rp)
    assert not ns.real_reads and not ps.real_reads
    np.testing.assert_array_equal(np.asarray(ns.start_pos),
                                  np.asarray(ps.start_pos))
    np.testing.assert_array_equal(np.asarray(ns.end_pos),
                                  np.asarray(ps.end_pos))
    ns.ensure_sim_lists()
    assert ns.align == ps.align
    assert ns.chrom == ps.chrom


@pytest.mark.parametrize("fmt", ["bgzf", "gz"])
def test_gz_threaded_parse_equals_python(tmp_path, monkeypatch, fmt):
    """gz inputs now reach the threaded parsers (BGZF block-parallel,
    plain gz via a one-shot inflate to memory): results must equal the
    pure-Python parse of the same data."""
    monkeypatch.setenv("RAFT_IO_MT_THRESHOLD", "0")
    monkeypatch.setenv("RAFT_IO_THREADS", "3")
    import gzip as _gzip
    reads_plain, paf_plain = datagen.standard_case(
        seed=77, tmpdir=str(tmp_path), n_reads=30)
    rp = str(tmp_path / f"reads.{fmt}.fasta.gz")
    pp = str(tmp_path / f"overlaps.{fmt}.paf.gz")
    for src, dst in ((reads_plain, rp), (paf_plain, pp)):
        data = open(src, "rb").read()
        if fmt == "bgzf":
            datagen.write_bgzf(dst, data, block=4096)
        else:
            with _gzip.open(dst, "wb") as f:
                f.write(data)
    ns = load_reads(rp, use_native=True)
    ps = _load_reads_py(reads_plain)
    _assert_stores_equal(ns, ps)
    nt = load_paf(pp, ns, use_native=True)
    pt = _load_paf_py(paf_plain, ps)
    _assert_tables_equal(nt, pt)


def test_bgzf_pipeline_parity_with_plain(tmp_path, monkeypatch):
    """End-to-end run on BGZF inputs is byte-identical to the plain run."""
    monkeypatch.setenv("RAFT_IO_MT_THRESHOLD", "0")
    from raft_tpu.params import AlgoParams
    from raft_tpu.pipeline import run_pipeline
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=78, tmpdir=tmp, n_reads=24)
    datagen.write_bgzf(f"{tmp}/r.fa.gz", open(reads, "rb").read(),
                       block=2048)
    datagen.write_bgzf(f"{tmp}/o.paf.gz", open(paf, "rb").read(),
                       block=2048)
    P = lambda nm: AlgoParams(est_cov=10, cov_mul=1.3, repeat_length=2000,
                              interval_length=2000, read_length=4000,
                              flanking_length=300, overlap_length=200,
                              outputfilename=f"{tmp}/{nm}")
    run_pipeline(reads, paf, P("plain"), engine="jax", verbose=False)
    run_pipeline(f"{tmp}/r.fa.gz", f"{tmp}/o.paf.gz", P("bg"),
                 engine="jax", verbose=False)
    for ext in (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
                ".long_repeats.bed"):
        assert (tmp_path / f"plain{ext}").read_bytes() == \
            (tmp_path / f"bg{ext}").read_bytes(), ext


def test_emit_reports_write_failure_enospc():
    """A full filesystem (ENOSPC) must surface as a failed emit, not a
    silently truncated output with rc=0 (found by an actual disk-full
    event during the r4 512k runs: the serial BufWriter fast path
    decided its return code before the final flush). /dev/full yields
    ENOSPC on every write."""
    import numpy as np
    from raft_tpu.io import native
    if native._get_lib() is None:
        pytest.skip("native lib unavailable")
    if not os.path.exists("/dev/full"):
        pytest.skip("no /dev/full on this platform")
    rep_s = np.asarray([1, 2], dtype=np.int32)
    rep_e = np.asarray([3, 4], dtype=np.int32)
    rep_off = np.asarray([0, 2], dtype=np.int64)
    assert native.emit_repeats("/dev/full", rep_s, rep_e, rep_off,
                               n_reads=1) is False


def test_index_lens_match_parsed_lens(tmp_path):
    """The index scan's per-read lens (new in r4, feeds the chunked
    path's whole-input event grouping) must equal the full parser's
    lens on every input mode — multiline, CRLF, gz, FASTQ."""
    import numpy as np
    import datagen
    from raft_tpu.io import native
    from raft_tpu.io.fasta import load_reads
    if native._get_lib() is None:
        pytest.skip("native lib unavailable")
    for i, mode in enumerate([
            dict(multiline=True),
            dict(multiline=True, gz=True),
            dict(fastq=True),
            dict(fastq=True, gz=True),
            dict(simulated=True)]):
        d = tmp_path / f"m{i}"
        d.mkdir()
        reads, _ = datagen.standard_case(seed=77 + i, tmpdir=str(d),
                                         n_reads=17, **mode)
        idx = native.index_reads(reads)
        assert idx is not None
        store = load_reads(reads)
        np.testing.assert_array_equal(
            np.asarray(idx["lens"]), np.asarray(store.lens, dtype=np.int64),
            err_msg=str(mode))


def test_index_lens_crlf(tmp_path):
    """CRLF line endings must not count toward the indexed lens."""
    import numpy as np
    from raft_tpu.io import native
    from raft_tpu.io.fasta import load_reads
    if native._get_lib() is None:
        pytest.skip("native lib unavailable")
    p = tmp_path / "crlf.fa"
    p.write_bytes(b">a x\r\nACGT\r\nGG\r\n>b\r\nTTTT\r\n")
    idx = native.index_reads(str(p))
    assert idx is not None
    np.testing.assert_array_equal(np.asarray(idx["lens"]), [6, 4])
    store = load_reads(str(p))
    np.testing.assert_array_equal(np.asarray(store.lens), [6, 4])


def test_negative_interval_binning_matches_python():
    """--no-strict garbage intervals (a_end <= 0 so hi = a_end-1 < 0,
    negative starts) must bin IDENTICALLY in the native group_events
    pass and the python convention (w0 = floor(lo/reso);
    w1 = -1 when hi < 0 else hi/reso — oracle.py:58, engine_jax.py:657,
    bucketing.py). This pins them bit-identical."""
    from raft_tpu.io import native
    from raft_tpu.io.paf import OverlapTable

    a_id = np.array([0, 1, 2, 0], dtype=np.int32)
    b_id = np.array([1, 0, 2, 2], dtype=np.int32)
    a_s = np.array([-150, -1, 0, 37], dtype=np.int32)
    a_e = np.array([-149, 0, -300, 120], dtype=np.int32)
    b_s = np.array([0, -75, 0, -10], dtype=np.int32)
    b_e = np.array([50, -20, 0, -9], dtype=np.int32)
    tab = OverlapTable(a_id, b_id, a_s, a_e, b_s, b_e,
                       symmetric=False, n_names=3)
    lens = np.array([500, 500, 500], dtype=np.int64)
    reso = 100
    g = native.group_events(tab, 3, lens, reso)
    if g is None:
        pytest.skip("native library unavailable")
    off, w0, w1, n_unknown, n_oob = g

    # python-convention reference for the same event stream
    ev_read, ev_lo, ev_hi = tab.events(3, strict=False)
    order = np.argsort(ev_read, kind="stable")
    ev_read, ev_lo, ev_hi = ev_read[order], ev_lo[order], ev_hi[order]
    py_w0 = (ev_lo.astype(np.int64) // reso).astype(np.int32)
    py_w1 = np.where(ev_hi < 0, -1,
                     ev_hi.astype(np.int64) // reso).astype(np.int32)

    assert off[-1] == len(ev_read)
    # native groups by read with A-side-then-B-side file order per read;
    # compare as per-read multisets of (w0, w1) pairs
    bounds = np.searchsorted(ev_read, np.arange(4))
    for r in range(3):
        nat = sorted(zip(w0[off[r]:off[r + 1]], w1[off[r]:off[r + 1]]))
        ref = sorted(zip(py_w0[bounds[r]:bounds[r + 1]],
                         py_w1[bounds[r]:bounds[r + 1]]))
        assert nat == ref, f"read {r}: native {nat} != python {ref}"
