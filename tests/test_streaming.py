"""Streaming (chunked) pipeline: outputs must be byte-identical to the
whole-file run for any chunk size, in real and simulated modes."""

from __future__ import annotations

import pytest

import datagen
from raft_tpu.params import AlgoParams
from raft_tpu.pipeline import run_pipeline

OUTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
        ".long_repeats.bed"]


def _params(tmp, name):
    return AlgoParams(est_cov=10, cov_mul=1.3, repeat_length=2000,
                      interval_length=2000, read_length=4000,
                      flanking_length=300, overlap_length=200,
                      outputfilename=f"{tmp}/{name}")


@pytest.mark.parametrize("chunk", [1, 7, 29, 1000])
@pytest.mark.parametrize("simulated", [False, True])
def test_chunked_equals_whole(tmp_path, chunk, simulated):
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=888, tmpdir=tmp, n_reads=29,
                                       simulated=simulated)
    run_pipeline(reads, paf, _params(tmp, "whole"), engine="jax",
                 verbose=False)
    st = run_pipeline(reads, paf, _params(tmp, "chunked"), engine="jax",
                      verbose=False, chunk_reads=chunk)
    assert st.n_reads == 29
    for ext in OUTS:
        a = (tmp_path / f"whole{ext}").read_bytes()
        b = (tmp_path / f"chunked{ext}").read_bytes()
        assert a == b, f"{ext} differs at chunk={chunk}"


@pytest.mark.parametrize("chunk", [1, 7, 1000])
@pytest.mark.parametrize("mode", ["real", "simulated", "symmetric"])
def test_spill_paf_equals_whole(tmp_path, chunk, mode):
    """--spill-paf streaming (native binned event spill) is byte-exact."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=890, tmpdir=tmp, n_reads=29,
                                       simulated=mode == "simulated",
                                       symmetric=mode == "symmetric")
    run_pipeline(reads, paf, _params(tmp, "whole"), engine="jax",
                 verbose=False)
    st = run_pipeline(reads, paf, _params(tmp, "spill"), engine="jax",
                      verbose=False, chunk_reads=chunk, spill_paf=True)
    assert st.n_reads == 29
    for ext in OUTS:
        a = (tmp_path / f"whole{ext}").read_bytes()
        b = (tmp_path / f"spill{ext}").read_bytes()
        assert a == b, f"{ext} differs at chunk={chunk} mode={mode}"


def test_bin_events_match_table_events(tmp_path):
    """Native binned spill produces the same event multiset per chunk as
    the resident OverlapTable.events() grouping."""
    import numpy as np
    from raft_tpu.io import native
    from raft_tpu.io.fasta import load_reads
    from raft_tpu.io.paf import load_paf

    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=891, tmpdir=tmp, n_reads=23)
    store = load_reads(reads)
    table = load_paf(paf, store)
    n = store.n_reads
    chunk = 5
    bins = native.bin_paf_events(paf, store, n, chunk, spill_dir=tmp)
    assert bins is not None
    assert bins.symmetric == table.symmetric
    assert bins.n_rows == table.n_rows
    assert bins.n_unknown == 0

    ev_read, ev_lo, ev_hi = table.events(n)
    for k in range(bins.n_bins):
        lo, hi = k * chunk, min((k + 1) * chunk, n)
        m = (ev_read >= lo) & (ev_read < hi)
        want = np.stack([ev_read[m], ev_lo[m], ev_hi[m]], axis=1)
        er, el, eh = bins.events_for_bin(k)
        got = np.stack([er, el, eh], axis=1)
        want = want[np.lexsort(want.T[::-1])]
        got = got[np.lexsort(got.T[::-1])]
        assert np.array_equal(want, got), f"bin {k} events differ"
    bins.close()
    import os
    assert not os.path.exists(bins.a_path)


def test_spill_strict_unknown_name_errors(tmp_path):
    """A PAF row naming a read absent from the FASTA raises in strict
    mode (the reference overruns its pileup array: chop.hpp:165 vs
    sizing at 361-364) and is dropped with strict=False."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=892, tmpdir=tmp, n_reads=6)
    with open(paf, "a") as f:
        f.write("ghost\t900\t10\t200\t+\tghost2\t900\t10\t200\t190\n")
    with pytest.raises(ValueError):
        run_pipeline(reads, paf, _params(tmp, "strictfail"), engine="jax",
                     verbose=False, chunk_reads=3, spill_paf=True)
    st = run_pipeline(reads, paf, _params(tmp, "lax"), engine="jax",
                      verbose=False, chunk_reads=3, spill_paf=True,
                      strict=False)
    assert st.n_reads == 6


@pytest.mark.parametrize("chunk", [3, 1000])
@pytest.mark.parametrize("kind", ["gz", "fastq", "fastq_gz"])
def test_chunked_streams_gz_and_fastq(tmp_path, chunk, kind):
    """gz/FASTQ inputs STREAM (no whole-file fallback): chunked outputs
    are byte-identical to the whole-file run. gz inputs decompress once
    to an index-owned temp file; FASTQ ranges use the sequential fastx
    parser."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=889, tmpdir=tmp, n_reads=17,
                                       gz=kind.endswith("gz"),
                                       fastq=kind.startswith("fastq"))
    run_pipeline(reads, paf, _params(tmp, "whole"), engine="jax",
                 verbose=False)
    st = run_pipeline(reads, paf, _params(tmp, "chunked"), engine="jax",
                      verbose=False, chunk_reads=chunk)
    assert st.n_reads == 17
    for ext in OUTS:
        a = (tmp_path / f"whole{ext}").read_bytes()
        b = (tmp_path / f"chunked{ext}").read_bytes()
        assert a == b, f"{ext} differs at chunk={chunk} kind={kind}"


def test_index_reads_gz_temp_cleanup(tmp_path):
    """The gz index spills decompressed bytes to a temp file and unlinks
    it when the handle is freed."""
    import os
    from raft_tpu.io import native
    tmp = str(tmp_path)
    reads, _ = datagen.standard_case(seed=893, tmpdir=tmp, n_reads=5,
                                     gz=True)
    idx = native.index_reads(reads)
    assert idx is not None and idx["n"] == 5
    assert idx["data_path"] != reads
    assert os.path.exists(idx["data_path"])
    data_path = idx["data_path"]
    del idx
    import gc
    gc.collect()
    assert not os.path.exists(data_path)


def test_auto_chunk_at_scale(tmp_path, monkeypatch):
    """chunk_reads=None auto-streams when inputs exceed
    RAFT_AUTO_CHUNK_BYTES, with outputs byte-identical to the forced
    whole-file run; chunk_reads=0 opts out."""
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=901, tmpdir=tmp, n_reads=29)
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "1")  # everything is big
    st = run_pipeline(reads, paf, _params(tmp, "auto"), engine="jax",
                      verbose=False)  # chunk_reads=None -> auto
    assert st.n_reads == 29
    st0 = run_pipeline(reads, paf, _params(tmp, "forced"), engine="jax",
                       verbose=False, chunk_reads=0)  # explicit whole-file
    assert st0.n_reads == 29
    for ext in OUTS:
        a = (tmp_path / f"auto{ext}").read_bytes()
        b = (tmp_path / f"forced{ext}").read_bytes()
        assert a == b, f"{ext} differs auto-chunk vs whole-file"


def test_auto_chunk_gate_thresholds(tmp_path, monkeypatch):
    """The size gate itself: small inputs stay whole-file, oversize
    inputs pick the default chunk size, 0 disables."""
    from raft_tpu.pipeline import DEFAULT_CHUNK_READS, _auto_chunk_reads
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=902, tmpdir=tmp, n_reads=5)
    monkeypatch.delenv("RAFT_AUTO_CHUNK_BYTES", raising=False)
    assert _auto_chunk_reads(reads, paf) == 0  # tiny vs 2 GB default
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "1")
    assert _auto_chunk_reads(reads, paf) == DEFAULT_CHUNK_READS
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "0")
    assert _auto_chunk_reads(reads, paf) == 0  # explicit disable
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "1")
    assert _auto_chunk_reads(reads + ".missing", paf) == 0  # stat fails


def test_auto_chunk_respects_engine_and_io_choice(tmp_path, monkeypatch):
    """Explicit --engine oracle / --pure-python-io runs must never be
    silently rerouted through the chunked schedule (which always uses
    the jax engine + native I/O) by the size gate."""
    from raft_tpu import pipeline as pl
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=903, tmpdir=tmp, n_reads=17)
    monkeypatch.setenv("RAFT_AUTO_CHUNK_BYTES", "1")
    called = []
    orig = pl._run_pipeline_chunked

    def spy(*a, **kw):
        called.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "_run_pipeline_chunked", spy)
    pl.run_pipeline(reads, paf, _params(tmp, "orc"), engine="oracle",
                    verbose=False)
    assert not called, "oracle engine was rerouted through chunked"
    pl.run_pipeline(reads, paf, _params(tmp, "pp"), engine="jax",
                    use_native=False, verbose=False)
    assert not called, "pure-python-io was rerouted through chunked"
    pl.run_pipeline(reads, paf, _params(tmp, "jx"), engine="jax",
                    verbose=False)
    assert called, "jax+native run should auto-chunk under the tiny gate"


def test_chunked_streams_bgzf_input(tmp_path):
    """A BGZF-compressed FASTA input routes through the streaming
    index's BLOCK-PARALLEL windowed inflate-to-temp (r5: bounded-memory
    decomp with the disk write overlapped) and produces bytes identical
    to the plain-input run. The BGZF input is made by our own
    bgzip-equivalent (native.bgzf_compress_file)."""
    import shutil

    from raft_tpu.io import native
    if native._get_lib() is None:
        pytest.skip("native lib unavailable")
    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=894, tmpdir=tmp, n_reads=17)
    bg = reads + ".bgzf.gz"
    assert native.bgzf_compress_file(reads, bg)
    run_pipeline(reads, paf, _params(tmp, "plain"), engine="jax",
                 verbose=False, chunk_reads=5)
    st = run_pipeline(bg, paf, _params(tmp, "bgzf"), engine="jax",
                      verbose=False, chunk_reads=5)
    assert st.n_reads == 17
    for ext in OUTS:
        a = (tmp_path / f"plain{ext}").read_bytes()
        b = (tmp_path / f"bgzf{ext}").read_bytes()
        assert a == b, ext


def test_chunked_streams_multimember_gz(tmp_path):
    """Concatenated gzip members (cat a.gz b.gz — legal gzip, what
    parallel compressors and chunked uploaders produce) must stream
    through the gz index path byte-identically: gzread handles member
    boundaries, and the BGZF sniffer's fallback must not truncate at
    the first member."""
    import gzip

    tmp = str(tmp_path)
    reads, paf = datagen.standard_case(seed=895, tmpdir=tmp, n_reads=17)
    data = open(reads, "rb").read()
    half = data.find(b">", len(data) // 2)  # split at a record boundary
    mm = reads + ".mm.gz"
    with open(mm, "wb") as f:
        f.write(gzip.compress(data[:half]))
        f.write(gzip.compress(data[half:]))
    run_pipeline(reads, paf, _params(tmp, "plainm"), engine="jax",
                 verbose=False, chunk_reads=5)
    st = run_pipeline(mm, paf, _params(tmp, "multi"), engine="jax",
                      verbose=False, chunk_reads=5)
    assert st.n_reads == 17
    for ext in OUTS:
        a = (tmp_path / f"plainm{ext}").read_bytes()
        b = (tmp_path / f"multi{ext}").read_bytes()
        assert a == b, ext
