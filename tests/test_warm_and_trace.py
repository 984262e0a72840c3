"""Unit tests for the chunk tracer: ``RAFT_CHUNK_TRACE`` — the per-chunk
JSONL schema that ``tools/bench_chunk.py`` consumes (guards the
producer/consumer contract so the decomposition tool cannot silently
rot).
"""

from __future__ import annotations

import json
import os


def test_chunk_trace_schema(tmp_path, monkeypatch):
    """A chunked run with RAFT_CHUNK_TRACE must emit one record per
    chunk plus a summary line, with the fields bench_chunk.analyze
    consumes — and the traced run's outputs must equal an untraced one."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    import datagen
    from raft_tpu import cli

    reads, paf = datagen.standard_case(seed=5, tmpdir=str(tmp_path),
                                       n_reads=23)
    args = ["-e", "10", "-m", "1.3", "-p", "2000", "-l", "4000",
            "-f", "300", "-v", "200"]
    trace = str(tmp_path / "trace.jsonl")
    monkeypatch.setenv("RAFT_CHUNK_TRACE", trace)
    assert cli.main(args + ["-o", str(tmp_path / "tr"),
                            "--chunk-reads", "7", reads, paf]) == 0
    monkeypatch.delenv("RAFT_CHUNK_TRACE")
    assert cli.main(args + ["-o", str(tmp_path / "un"),
                            "--chunk-reads", "7", reads, paf]) == 0
    for ext in (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
                ".long_repeats.bed"):
        a = open(str(tmp_path / "tr") + ext, "rb").read()
        b = open(str(tmp_path / "un") + ext, "rb").read()
        assert a == b, ext

    recs = [json.loads(line) for line in open(trace)]
    tail = recs.pop()
    assert tail["n_chunks"] == len(recs) == 4  # ceil(23/7)
    assert tail["chunk_reads"] == 7
    assert "total_wall_s" in tail and "stage_seconds" in tail
    for r in recs:
        for k in ("ci", "lo", "hi", "wait_load_s", "drain_s",
                  "compute_s", "compute_span", "engine", "n_events",
                  "load_read_s", "load_events_s", "load_span",
                  "emit_fasta_s", "emit_lr_s", "emit_bed_s"):
            assert k in r, (k, r)
        assert set(r["engine"]) >= {"bucket_prep", "fetch"}

    # the analyzer must accept the producer's output
    from raft_tpu.tools.bench_chunk import analyze
    stats = {"stage_seconds": tail["stage_seconds"], "peak_rss_mb": 1,
             "n_fragments": 0}
    out = analyze(trace, wall=1.0, stats=stats)
    assert out["n_chunks"] == 4
    assert "engine_substages_s" in out["main_thread"]
