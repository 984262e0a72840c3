"""End-to-end pipeline orchestrator (reference: ``break_long_reads``,
``/root/reference/chop.hpp:331-373``).

Stages: load reads → load overlaps → coverage pileup → repeat annotation →
chop → emit. The compute stages run on one of two engines:

* ``jax``   — the device pipeline (bucketed ``[B, W]`` tensors,
              see ``raft_tpu/engine_jax.py``); the default.
* ``oracle``— per-read numpy with reference-exact scalar semantics
              (``raft_tpu/ops/oracle.py``); used for testing. There is
              deliberately NO spill path: the device slot counts (K
              repeat slots, M markers, F fragments) are closed-form
              bounds derived from W and the params (engine_jax.derive_cfg)
              that no input can exceed — asserted by
              tests/test_kernels.py::test_closed_form_slot_bounds.

Both produce identical results; the test suite enforces byte parity of all
four output files against the compiled reference binary.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import time

import numpy as np

from raft_tpu import emit
from raft_tpu.io.fasta import ReadStore, load_reads
from raft_tpu.io.paf import OverlapTable, load_paf
from raft_tpu.ops import oracle
from raft_tpu.params import AlgoParams


@dataclasses.dataclass
class RunStats:
    n_reads: int = 0
    n_paf_rows: int = 0
    n_fragments: int = 0
    total_coverage: int = 0
    total_windows: int = 0
    total_repeat_length: int = 0
    total_read_length: int = 0
    symmetric: bool = False
    stage_seconds: dict = dataclasses.field(default_factory=dict)
    emit_bytes: int = 0  # total bytes of the four output files

    @property
    def coverage_per_window(self) -> float:
        return self.total_coverage / self.total_windows if self.total_windows else 0.0

    @property
    def fraction_repeat(self) -> float:
        return (self.total_repeat_length / self.total_read_length
                if self.total_read_length else 0.0)

    def to_json(self) -> dict:
        return {
            "n_reads": self.n_reads,
            "n_paf_rows": self.n_paf_rows,
            "n_fragments": self.n_fragments,
            "total_coverage": self.total_coverage,
            "total_windows": self.total_windows,
            "total_repeat_length": self.total_repeat_length,
            "total_read_length": self.total_read_length,
            "coverage_per_window": self.coverage_per_window,
            "fraction_repeat": self.fraction_repeat,
            "symmetric_overlaps": self.symmetric,
            "stage_seconds": dict(self.stage_seconds),
            "peak_rss_mb": self.peak_rss_mb,
            # emit throughput telemetry: tells an emit-policy regression
            # from host CPU contention
            "emit_bytes": self.emit_bytes,
            "emit_mb_per_s": round(
                self.emit_bytes / 1e6 / self.stage_seconds["emit"], 1)
            if self.stage_seconds.get("emit") else 0.0,
        }

    @property
    def peak_rss_mb(self) -> float:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class _Timer:
    def __init__(self, stats: RunStats, name: str):
        self.stats, self.name = stats, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *a):
        self.stats.stage_seconds[self.name] = (
            self.stats.stage_seconds.get(self.name, 0.0)
            + time.perf_counter() - self.t0)


def _apply_auto_e(params: AlgoParams, info: dict) -> AlgoParams:
    """Fold an --auto-e estimate into the params; stderr reporting.

    The estimate replaces any supplied ``-e`` (reported when they
    disagree). A no-signal input (no covered window) is an error: the
    estimator cannot invent a threshold, and silently running with a
    default would produce garbage fragmentation."""
    est = info["est_cov"]
    if est <= 0:
        raise ValueError(
            "--auto-e: no covered window in the input (every overlap "
            "interval empty or out of range) — est_cov cannot be "
            "estimated; supply -e explicitly")
    from raft_tpu.auto_e import SAFETY_MUL
    msg = (f"INFO, --auto-e estimated est_cov = {est} (median per-window "
           f"coverage {info['refined_median']}, x{SAFETY_MUL:g} safety "
           f"bias, {info['nonzero_windows']} covered windows)")
    if params.est_cov > 0 and params.est_cov != est:
        msg += f"; ignoring supplied -e {params.est_cov}"
    print(msg, file=sys.stderr)
    return params.replace(est_cov=est)


def _est_cov_hint(stats: "RunStats", params: AlgoParams) -> None:
    """stderr advisory when ``-e`` looks mis-specified.

    est_cov is the one knob users must compute themselves
    (total_bases/genome_size, reference README:22-26) and the r4
    sensitivity sweep (EVAL.md) showed the failure mode is severe and
    asymmetric: under-estimates collapse repeat precision ~10x and
    suppress fragmentation, over-estimates >~2x cost recall. The
    reference prints the observed/supplied ratio but never interprets
    it; we add the interpretation on STDERR (stdout stays line-identical
    to the reference). RAFT_NO_HINTS=1 disables."""
    if os.environ.get("RAFT_NO_HINTS"):
        return
    if not stats.total_windows or params.est_cov <= 0:
        return
    ratio = stats.coverage_per_window / params.est_cov
    # Thresholds calibrated to the r4 sweep (EVAL.md): a 0.75x
    # under-estimate (observed/supplied ~= 1.33) ALREADY halves
    # flank-tolerant precision (0.995 -> 0.40 at 2 Mbp, 0.11 at 10 Mbp),
    # so the under-estimate hint must fire before 1.33, not at the old
    # 1.5. Over-estimates are harmless at 1.5x (ratio 0.67) and
    # cost recall at 2x (ratio 0.5, recall 0.82-0.98), so warn from
    # ratio < 0.6 — between the last-known-safe and first-damaged
    # points.
    if ratio > 1.25:
        print(f"HINT: observed coverage per window ({ratio:.2f}x the "
              f"supplied -e {params.est_cov}) suggests est_cov is "
              "UNDER-estimated; a 0.75x under-estimate already halves "
              "repeat precision and suppresses fragmentation (EVAL.md "
              "sweep). Consider -e nearer "
              f"{stats.coverage_per_window:.0f}, or --auto-e.",
              file=sys.stderr)
    elif ratio < 0.6:
        print(f"HINT: observed coverage per window is only {ratio:.2f}x "
              f"the supplied -e {params.est_cov}; a 2x over-estimate "
              "makes true repeats miss the high-coverage threshold "
              "(recall 1.0 -> 0.82-0.98, EVAL.md sweep). Consider -e "
              f"nearer {stats.coverage_per_window:.0f}, or --auto-e.",
              file=sys.stderr)


def _sum_output_bytes(prefix: str, sfx: str) -> int:
    tot = 0
    for name in (".coverage.txt", ".long_repeats.txt",
                 ".long_repeats.bed", ".reads.fasta"):
        try:
            tot += os.path.getsize(prefix + name + sfx)
        except OSError:
            pass
    return tot


def _validate_inputs(read_path: str, paf_path: str) -> None:
    """Reference check: exists + non-empty or exit (chop.hpp:336-349)."""
    for p in (read_path, paf_path):
        if not os.path.exists(p) or os.path.getsize(p) == 0:
            print(f"ERROR, break_long_reads(), {p} input file either does "
                  "not exist or is empty")
            raise SystemExit(1)


def compute_oracle(store: ReadStore, table: OverlapTable,
                   params: AlgoParams, strict: bool = True):
    """Reference-exact per-read compute (numpy oracle engine).

    Returns (coverages, repeats_per_read, frags_per_read, stats_partial).
    """
    n = store.n_reads
    ev_read, ev_lo, ev_hi = table.events(n, strict=strict)
    order = np.argsort(ev_read, kind="stable")
    ev_read = ev_read[order]
    ev_lo = ev_lo[order]
    ev_hi = ev_hi[order]
    bounds = np.searchsorted(ev_read, np.arange(n + 1))

    coverages = []
    repeats_per_read = []
    frags_per_read = []
    stats = RunStats()
    hc = params.high_cov
    for i in range(n):
        length = int(store.lens[i])
        lo = ev_lo[bounds[i]:bounds[i + 1]]
        hi = ev_hi[bounds[i]:bounds[i + 1]]
        cov = oracle.coverage_one_read(length, params.reso, lo, hi,
                                       strict=strict)
        rep = oracle.repeats_one_read(cov, length, params.reso, hc,
                                      params.repeat_length,
                                      params.flanking_length)
        stars = oracle.markers_one_read(length, params.interval_length)
        finals = oracle.surviving_markers(stars, rep.intervals)
        frags = oracle.chop_one_read(length, finals, params.read_length,
                                     params.interval_length,
                                     params.overlap_length)
        coverages.append(cov)
        repeats_per_read.append(rep.intervals)
        frags_per_read.append(frags)
        stats.total_coverage += int(cov.sum())
        stats.total_windows += len(cov)
        stats.total_repeat_length += rep.repeat_length_sum
        stats.total_read_length += length
    return coverages, repeats_per_read, frags_per_read, stats


DEFAULT_CHUNK_READS = 32768  # chunk size auto-streaming picks


def _auto_chunk_reads(read_path: str, paf_path: str) -> int:
    """Auto-streaming gate for whole-file invocations (0 = stay
    whole-file). Size-based: the decision must happen before any parse,
    and input bytes are the resource the chunked schedule manages. The
    2 GB default keeps small runs (where smaller batches can cost more
    than the overlap saves) on the whole-file path."""
    try:
        thr = float(os.environ.get("RAFT_AUTO_CHUNK_BYTES", 2e9))
    except ValueError:
        print("raft: ignoring malformed RAFT_AUTO_CHUNK_BYTES "
              f"({os.environ['RAFT_AUTO_CHUNK_BYTES']!r}); using 2e9",
              file=sys.stderr)
        thr = 2e9
    if thr <= 0:
        return 0
    try:
        if (os.path.getsize(read_path) > thr
                or os.path.getsize(paf_path) > thr):
            return DEFAULT_CHUNK_READS
    except OSError:
        pass
    return 0


def run_pipeline(read_path: str, paf_path: str, params: AlgoParams,
                 engine: str = "jax", strict: bool = True,
                 verbose: bool = True, use_native: bool | None = None,
                 mesh=None,
                 chunk_reads: int | None = None,
                 spill_paf: bool | None = None,
                 gz_out: bool = False,
                 cov_out: str | None = None,
                 auto_e: bool = False,
                 ) -> RunStats:
    """Full RAFT run: parse, compute, emit the four output files.

    ``chunk_reads``: streaming mode — process the reads in chunks of that
    many so sequence bytes never fully reside in memory (the reference
    holds ~3.4x the input resident, SURVEY.md §2; this bounds the blob at
    one chunk). Works for FASTA, FASTQ, and gz of either (gz inputs
    decompress once to a temp file the index owns, so chunk loads remain
    byte-range reads); falls back to the whole-file path only when the
    native library is unavailable.

    ``gz_out``: write all four outputs BGZF-compressed (``.gz`` suffix;
    block-parallel deflate, decompressed bytes identical to the plain
    outputs and readable by zcat/bgzip/htslib).

    ``spill_paf``: in streaming mode, additionally bound *overlap* memory:
    a native two-pass PAF parse spills per-chunk coverage events to disk
    instead of keeping the row columns resident (~24 B/row). ``None``
    auto-enables for PAF files over max(2 GiB, 15% of host RAM) — the
    spill costs a second disk pass, so it only fires when keeping the
    columns resident would actually pressure memory.

    ``chunk_reads=None`` (the default) auto-streams at scale: inputs over
    ``RAFT_AUTO_CHUNK_BYTES`` (default 2 GB, 0 disables) switch to the
    chunked schedule with the default chunk size (byte-identical outputs):
    the whole-file schedule serializes bucket routing, H2D, exec+D2H and
    emit into barriers, while the chunked schedule overlaps them across
    chunks and bounds memory. Pass ``chunk_reads=0`` (CLI
    ``--chunk-reads 0``) to force whole-file.
    """
    if chunk_reads is None and engine == "jax" and use_native is not False:
        # the chunked schedule always runs the jax engine + native I/O;
        # explicit oracle-engine or pure-python-I/O runs must not be
        # silently rerouted through the code paths they exist to bypass
        chunk_reads = _auto_chunk_reads(read_path, paf_path)
        if chunk_reads and verbose:
            import sys as _sys
            print(f"INFO, large input: auto-streaming in chunks of "
                  f"{chunk_reads} reads (--chunk-reads 0 forces "
                  f"whole-file)", file=_sys.stderr)
    if chunk_reads:
        st = _run_pipeline_chunked(read_path, paf_path, params,
                                   chunk_reads, strict=strict,
                                   verbose=verbose,
                                   mesh=mesh, spill_paf=spill_paf,
                                   gz_out=gz_out, cov_out=cov_out,
                                   auto_e=auto_e)
        if st is not None:
            return st
        if verbose:
            # stderr: stdout must stay line-identical to the reference,
            # and the auto-chunk gate can reach this without the user
            # ever asking for streaming
            import sys as _sys
            print("INFO, streaming mode unavailable for this input; "
                  "running whole-file", file=_sys.stderr)
    # --auto-e: est_cov is estimated from the data once the overlap
    # events are loaded; validate everything else now with a stand-in
    (params.replace(est_cov=1) if auto_e else params).validate()
    _validate_inputs(read_path, paf_path)
    stats = RunStats()

    import concurrent.futures as cf

    # the PAF tokenize/intern phase has no dependency on the FASTA parse
    # (two-phase load: preparse ∥ load_reads, then a cheap resolve) — both
    # native calls release the GIL, so they genuinely run concurrently
    pre_fut = None
    if use_native is not False:
        from raft_tpu.io import native as _native
        _pre_pool = cf.ThreadPoolExecutor(max_workers=1)
        pre_fut = _pre_pool.submit(_native.preparse_paf, paf_path)
        _pre_pool.shutdown(wait=False)

    def _drain_preparse():
        # same guard as the chunked path: an exception before resolve
        # must not leave the non-daemon preparse worker running or leak
        # its C handle
        nonlocal pre_fut
        if pre_fut is None:
            return
        fut, pre_fut = pre_fut, None
        try:
            pre = fut.result()
            if pre is not None:
                pre.close()
        except Exception:
            pass

    try:
        with _Timer(stats, "load_reads"):
            store = load_reads(read_path, use_native=use_native)
        if verbose:
            print(f"Real Reads {int(store.real_reads)} ")
        with _Timer(stats, "load_paf"):
            table = None
            if pre_fut is not None:
                fut, pre_fut = pre_fut, None
                pre = fut.result()
                if pre is not None:
                    table = _native.resolve_paf(pre, store)
            if table is None:
                table = load_paf(paf_path, store, use_native=use_native)
    finally:
        _drain_preparse()
    if verbose:
        print(f"INFO, Symmetric overlaps {int(table.symmetric)} ")
        print(f"INFO, length of alignments  {table.n_rows}()")

    params = params.replace(real_reads=store.real_reads,
                            symmetric_overlaps=table.symmetric)
    grouped_for_engine = None
    if auto_e:
        from raft_tpu import auto_e as _auto_e
        with _Timer(stats, "auto_e"):
            info, grouped_for_engine = _auto_e.estimate_for_table(
                table, store.lens.astype(np.int64), store.n_reads,
                params.reso, params.cov_mul, strict=strict)
        params = _apply_auto_e(params, info)
    if verbose:
        print(f"high_cov {params.high_cov}")

    import concurrent.futures as cf
    prefix = params.outputfilename
    un = use_native is not False
    sfx = ".gz" if gz_out else ""
    # in cov_out="host" mode .coverage.txt depends only on the (sorted)
    # events — the engine hands them over before any device work, and the
    # emitter runs concurrently with the device stage (it releases the
    # GIL; the device stage is transfer-bound)
    cov_pool = cf.ThreadPoolExecutor(max_workers=1)
    cov_fut: list = []

    def _on_cov(early_res):
        cov_fut.append(cov_pool.submit(
            emit.write_coverage, prefix + ".coverage.txt" + sfx,
            params.reso, early_res, un, gz=gz_out))

    with _Timer(stats, "compute"):
        if engine == "oracle":
            from raft_tpu.result import from_per_read_lists
            coverages, repeats, frags, cstats = compute_oracle(
                store, table, params, strict=strict)
            res = from_per_read_lists(store.n_reads, coverages, repeats,
                                      frags, cstats)
        elif engine == "jax":
            from raft_tpu.engine_jax import compute_jax
            res = compute_jax(store, table, params, strict=strict,
                              mesh=mesh,
                              cov_out=cov_out, on_cov_events=_on_cov,
                              grouped=grouped_for_engine)
        else:
            raise ValueError(f"unknown engine {engine!r}")

    stats.n_reads = store.n_reads
    stats.n_paf_rows = table.n_rows
    stats.symmetric = table.symmetric
    stats.total_coverage = res.total_coverage
    stats.total_windows = res.total_windows
    stats.total_repeat_length = res.total_repeat_length
    stats.total_read_length = res.total_read_length

    if verbose:
        print(f"coverage per window is {stats.coverage_per_window:f} ")
        print("coverage per window/average coverage is "
              f"{stats.coverage_per_window / params.est_cov:f} ")
        print(f"fraction_of_repeat_length {stats.fraction_repeat:f} ")
        if not auto_e:
            # in auto mode the threshold came FROM the data; the
            # mis-specification advisory would only confuse
            _est_cov_hint(stats, params)

    with _Timer(stats, "emit"):
        # the four writers touch disjoint files and release the GIL in
        # the native emitters — run them concurrently
        with cf.ThreadPoolExecutor(max_workers=4) as ex:
            futs = [
                cov_fut[0] if cov_fut else
                ex.submit(emit.write_coverage,
                          prefix + ".coverage.txt" + sfx,
                          params.reso, res, un, gz=gz_out),
                ex.submit(emit.write_long_repeats,
                          prefix + ".long_repeats.txt" + sfx, res, un,
                          gz=gz_out),
                ex.submit(emit.write_long_repeats_bed,
                          prefix + ".long_repeats.bed" + sfx, store, res,
                          un, gz=gz_out),
                ex.submit(emit.write_fragments_fasta,
                          prefix + ".reads.fasta" + sfx, store, params,
                          res, un, gz=gz_out),
            ]
            for f in futs[:-1]:
                f.result()
            stats.n_fragments = futs[-1].result()
    cov_pool.shutdown()
    stats.emit_bytes = _sum_output_bytes(prefix, sfx)
    return stats


def _run_pipeline_chunked(read_path: str, paf_path: str, params: AlgoParams,
                          chunk_reads: int, strict: bool = True,
                          verbose: bool = True, mesh=None,
                          spill_paf: bool | None = None,
                          gz_out: bool = False,
                          cov_out: str | None = None,
                          auto_e: bool = False) -> RunStats | None:
    """Streaming pipeline: index pass → full PAF → per-chunk byte-range
    parse, compute, and append-emit with global numbering offsets.

    Exactness: coverage/repeats/chop depend only on a read's own events,
    so chunk boundaries cannot change any output byte (enforced by
    tests/test_streaming.py). Returns None when the input cannot be
    indexed (native library unavailable) so the caller falls back.

    With ``spill_paf`` (default: auto for PAF > max(2 GiB, 15% of RAM))
    the overlap table
    is never resident either: a native two-pass parse writes per-chunk
    coverage events to spill files read back one chunk at a time.
    """
    from raft_tpu.io import native
    from raft_tpu.io.fasta import (parse_sim_align, parse_sim_chr,
                                   parse_sim_end_pos, parse_sim_start_pos)
    from raft_tpu.engine_jax import compute_jax
    from raft_tpu.io.paf import OverlapTable

    (params.replace(est_cov=1) if auto_e else params).validate()
    _validate_inputs(read_path, paf_path)
    stats = RunStats()

    if spill_paf is None:
        # Auto policy, RAM-aware: spilling exists to bound overlap-column
        # memory (~24 B/row resident without it), but it costs a second
        # disk pass when it fires needlessly. Spill only when the PAF is
        # both large in absolute terms (> 2 GiB) AND large relative to
        # this host's RAM (> 15% — columns resident are ~1/4 of the text
        # size, so 15% of RAM in text is ~4% in columns: comfortably safe
        # to keep resident below that). --spill-paf / --no-spill-paf
        # always win.
        paf_bytes = os.path.getsize(paf_path)
        try:
            ram = (os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
        except (ValueError, OSError):
            ram = 0
        spill_paf = paf_bytes > max(2 << 30, int(ram * 0.15))

    # The PAF tokenize/intern phase has no FASTA dependency (same
    # two-phase split the whole-file path uses): preparse runs
    # CONCURRENTLY with the FASTA index scan — both native calls release
    # the GIL — then a cheap resolve against the index's global name map.
    # This overlap takes the serial PAF parse off the critical path.
    # The spill path can't use it (the native binner does its own
    # two-pass read), so preparse is gated.
    import concurrent.futures as cf
    pre_fut = None
    if not spill_paf:
        _pre_pool = cf.ThreadPoolExecutor(max_workers=1)
        pre_fut = _pre_pool.submit(native.preparse_paf, paf_path)
        _pre_pool.shutdown(wait=False)

    def _drain_preparse():
        # join + free the preparse worker on EVERY exit that did not
        # consume it: otherwise an index/resolve error leaves the
        # non-daemon worker tokenizing on after the exception, and leaks
        # the C handle.
        nonlocal pre_fut
        if pre_fut is None:
            return
        fut, pre_fut = pre_fut, None
        try:
            pre = fut.result()
            if pre is not None:
                pre.close()
        except Exception:
            pass

    try:
        with _Timer(stats, "index"):
            idx = native.index_reads(read_path)
        if idx is None or idx["n"] == 0:
            _drain_preparse()
            return None
        n = idx["n"]
        if verbose:
            print(f"Real Reads {int(idx['real_reads'])} ")

        bins = None
        table = None
        if spill_paf:
            with _Timer(stats, "load_paf"):
                bins = native.bin_paf_events(paf_path, idx, n, chunk_reads)
            if bins is not None and strict and bins.n_unknown:
                bins.close()
                raise ValueError(
                    f"PAF names {bins.n_unknown} read(s) absent from the "
                    "input FASTA (undefined behavior in reference RAFT); "
                    "pass strict=False to drop them")
        if bins is None:
            with _Timer(stats, "load_paf"):
                # PAF interns against the index handle's global name map
                class _IdxStore:
                    pass
                shim = _IdxStore()
                shim._native_handle = idx["handle"]
                if pre_fut is not None:
                    fut, pre_fut = pre_fut, None
                    pre = fut.result()
                    if pre is not None:
                        table = native.resolve_paf(pre, shim)
                if table is None:
                    table = native.load_paf(paf_path, shim)
                if table is None:
                    return None
    finally:
        _drain_preparse()

    symmetric = bins.symmetric if bins is not None else table.symmetric
    n_paf_rows = bins.n_rows if bins is not None else table.n_rows
    if verbose:
        print(f"INFO, Symmetric overlaps {int(symmetric)} ")
        print(f"INFO, length of alignments  {n_paf_rows}()")

    params = params.replace(real_reads=idx["real_reads"],
                            symmetric_overlaps=symmetric)

    g_off = g_w0 = g_w1 = None
    if bins is None:
        # Whole-input grouped events in ONE native counting-sort pass
        # (window-binned, read-grouped) using the lens the index scan
        # recorded: replaces events() + argsort + per-chunk searchsorted.
        # Runs before the high_cov print because --auto-e derives
        # est_cov (hence high_cov) from these events; stdout line ORDER
        # is unchanged either way.
        idx_lens = idx.get("lens")
        with _Timer(stats, "group_events"):
            if idx_lens is not None and len(idx_lens) == n:
                eg = getattr(table, "events_grouped", None)
                g = eg(n, idx_lens, params.reso, strict=strict) \
                    if eg is not None else None
                if g is not None:
                    g_off, g_w0, g_w1 = g
            if g_off is None:
                # fallback: all events once (columnar) sorted by read id
                ev_read, ev_lo, ev_hi = table.events(n, strict=strict)
                order = np.argsort(ev_read, kind="stable")
                ev_read = ev_read[order]
                ev_lo = ev_lo[order]
                ev_hi = ev_hi[order]

    if auto_e:
        from raft_tpu import auto_e as _auto_e
        with _Timer(stats, "auto_e"):
            idx_lens = idx.get("lens")
            if bins is not None:
                if idx_lens is None or len(idx_lens) != n:
                    raise ValueError(
                        "--auto-e with --spill-paf needs the native "
                        "index's read lengths; rerun without --spill-paf "
                        "or supply -e explicitly")
                info = _auto_e.estimate_for_bins(
                    bins, idx_lens, params.reso, params.cov_mul,
                    chunk_reads)
            elif g_off is not None:
                info = _auto_e.estimate_from_hist(
                    _auto_e.cov_histogram_grouped(
                        g_off, g_w0, g_w1,
                        np.asarray(idx_lens, dtype=np.int64),
                        params.reso),
                    params.cov_mul)
            else:
                if idx_lens is None or len(idx_lens) != n:
                    raise ValueError(
                        "--auto-e in streaming mode needs the native "
                        "index's read lengths; run whole-file "
                        "(--chunk-reads 0) or supply -e explicitly")
                info = _auto_e.estimate_from_hist(
                    _auto_e.cov_histogram_events(
                        ev_read, ev_lo, ev_hi,
                        np.asarray(idx_lens, dtype=np.int64),
                        params.reso),
                    params.cov_mul)
        params = _apply_auto_e(params, info)
    if verbose:
        print(f"high_cov {params.high_cov}")

    # Software pipeline across chunks: chunk k+1's LOAD prefetches while
    # chunk k computes, and chunk k's EMIT runs while k+1 computes. Four
    # single-worker pools (one per output file) keep cross-chunk append
    # order per file (FIFO) while the four files write concurrently.
    # Global fragment numbering needs only the per-chunk counts, which
    # compute delivers before emit — so emit never gates the next chunk.
    # Residency stays bounded: at most ~3 chunk stores alive (current,
    # prefetched, and the oldest still-emitting one).
    import concurrent.futures as cf
    from collections import deque
    cov_pool = cf.ThreadPoolExecutor(max_workers=1)
    emit_pools = [cf.ThreadPoolExecutor(max_workers=1) for _ in range(3)]
    load_pool = cf.ThreadPoolExecutor(max_workers=1)
    prefix = params.outputfilename
    sfx = ".gz" if gz_out else ""
    rec_off = idx["rec_off"]
    names = idx["names"]

    # Per-chunk stage attribution: RAFT_CHUNK_TRACE=<path> writes one
    # JSON line per chunk with thread-level busy times and wall spans, so
    # tools/bench_chunk.py can account the schedule (what blocked the
    # main loop, what each worker thread actually did, and where the
    # wall went). Off by default: the only
    # per-chunk cost when enabled is a few perf_counter() calls.
    trace_path = os.environ.get("RAFT_CHUNK_TRACE")
    trace: list | None = [] if trace_path else None
    T0 = time.perf_counter()

    def _load_chunk(lo, hi, rec=None):
        t0 = time.perf_counter()
        store = native.load_reads_range(
            idx["data_path"], int(rec_off[lo]), int(rec_off[hi]),
            fastq=idx["fastq"])
        t1 = time.perf_counter()
        store.real_reads = params.real_reads
        if not params.real_reads and not native.attach_sim_meta(store):
            # degenerate names: per-name python parse (exact contract)
            cn = names[lo:hi]
            store.start_pos = np.asarray(
                [parse_sim_start_pos(nm) for nm in cn], dtype=np.int64)
            store.end_pos = np.asarray(
                [parse_sim_end_pos(nm) for nm in cn], dtype=np.int64)
            store.align = [parse_sim_align(nm) for nm in cn]
            store.chrom = [parse_sim_chr(nm) for nm in cn]
        if bins is not None:
            er, el, eh = bins.events_for_bin(lo // chunk_reads)
            sub_table = _EventTable(er - lo, el, eh, symmetric)
        elif g_off is not None:
            o = g_off[lo:hi + 1]
            sub_table = _GroupedEventTable(o - o[0],
                                           g_w0[int(o[0]):int(o[-1])],
                                           g_w1[int(o[0]):int(o[-1])],
                                           symmetric)
        else:
            a, b = np.searchsorted(ev_read, [lo, hi])
            sub_table = _EventTable(ev_read[a:b] - lo, ev_lo[a:b],
                                    ev_hi[a:b], symmetric)
        if rec is not None:
            t2 = time.perf_counter()
            rec["load_span"] = [round(t0 - T0, 3), round(t2 - T0, 3)]
            rec["load_read_s"] = round(t1 - t0, 3)
            rec["load_events_s"] = round(t2 - t1, 3)
        return store, sub_table

    def _timed_emit(fn, rec, key, *a, **k):
        t0 = time.perf_counter()
        r = fn(*a, **k)
        t1 = time.perf_counter()
        rec[key] = round(t1 - t0, 3)
        rec[key.replace("_s", "_span")] = [round(t0 - T0, 3),
                                           round(t1 - T0, 3)]
        return r

    chunks = [(lo, min(lo + chunk_reads, n))
              for lo in range(0, n, chunk_reads)]
    recs = [dict(ci=ci, lo=lo, hi=hi) if trace is not None else None
            for ci, (lo, hi) in enumerate(chunks)]

    def _chunk_loop() -> int:
        # the full software-pipelined schedule; every emit
        # future is drained here so any I/O error surfaces
        # inside the guard below
        next_fut = load_pool.submit(_load_chunk, *chunks[0], rec=recs[0])
        pending: deque = deque()
        frag_num = 1
        for ci, (lo, hi) in enumerate(chunks):
            first = ci == 0
            rec = recs[ci]
            t_wait = time.perf_counter()
            with _Timer(stats, "load_reads"):
                store, sub_table = next_fut.result()
            if rec is not None:
                rec["wait_load_s"] = round(time.perf_counter() - t_wait, 3)
            if ci + 1 < len(chunks):
                next_fut = load_pool.submit(_load_chunk, *chunks[ci + 1],
                                            rec=recs[ci + 1])
            t_drain = time.perf_counter()
            # bound resident chunks: current + prefetched + RAFT_CHUNK_PENDING
            # still-emitting (default 2 ≈ one extra chunk store resident, so
            # a transient emit lag does not block the main loop)
            max_pending = max(1, int(os.environ.get("RAFT_CHUNK_PENDING", "2")))
            while len(pending) > max_pending:
                for f in pending.popleft():
                    f.result()
            if rec is not None:
                rec["drain_s"] = round(time.perf_counter() - t_drain, 3)

            # coverage emission overlaps this chunk's device stage (its only
            # input — the chunk's binned events — exists before any device
            # work); the FIFO cov pool preserves append order across chunks
            cov_fut: list = []

            def _on_cov(early_res, _lo=lo, _app=not first, _rec=rec):
                if _rec is not None:
                    cov_fut.append(cov_pool.submit(
                        _timed_emit, emit.write_coverage, _rec, "emit_cov_s",
                        prefix + ".coverage.txt" + sfx, params.reso, early_res,
                        first_read_index=_lo, append=_app, gz=gz_out))
                else:
                    cov_fut.append(cov_pool.submit(
                        emit.write_coverage, prefix + ".coverage.txt" + sfx,
                        params.reso, early_res, first_read_index=_lo,
                        append=_app, gz=gz_out))

            eng_timers: dict = {}
            t_comp = time.perf_counter()
            with _Timer(stats, "compute"):
                res = compute_jax(store, sub_table, params, strict=strict,
                                  mesh=mesh,
                                  cov_out=cov_out, on_cov_events=_on_cov,
                                  timers_out=eng_timers if rec is not None
                                  else None)
            if rec is not None:
                t1 = time.perf_counter()
                rec["compute_s"] = round(t1 - t_comp, 3)
                rec["compute_span"] = [round(t_comp - T0, 3), round(t1 - T0, 3)]
                rec["engine"] = {k: round(v, 3) for k, v in eng_timers.items()}
                rec["n_events"] = int(sub_table.n_rows)

            frag_base = frag_num
            frag_num += res.n_frags
            stats.total_coverage += res.total_coverage
            stats.total_windows += res.total_windows
            stats.total_repeat_length += res.total_repeat_length
            stats.total_read_length += res.total_read_length

            if not cov_fut:  # diff8/cov modes: coverage rendered from res
                cov_fut = [cov_pool.submit(
                    emit.write_coverage, prefix + ".coverage.txt" + sfx,
                    params.reso, res, first_read_index=lo, append=not first,
                    gz=gz_out)]
            if rec is not None:
                futs = [
                    emit_pools[0].submit(
                        _timed_emit, emit.write_fragments_fasta, rec,
                        "emit_fasta_s", prefix + ".reads.fasta" + sfx,
                        store, params, res, first_read_num=frag_base,
                        append=not first, gz=gz_out),
                    emit_pools[1].submit(
                        _timed_emit, emit.write_long_repeats, rec,
                        "emit_lr_s", prefix + ".long_repeats.txt" + sfx,
                        res, first_read_index=lo, append=not first, gz=gz_out),
                    emit_pools[2].submit(
                        _timed_emit, emit.write_long_repeats_bed, rec,
                        "emit_bed_s", prefix + ".long_repeats.bed" + sfx,
                        store, res, append=not first, gz=gz_out),
                ]
            else:
                futs = [
                    emit_pools[0].submit(
                        emit.write_fragments_fasta, prefix + ".reads.fasta" + sfx,
                        store, params, res, first_read_num=frag_base,
                        append=not first, gz=gz_out),
                    emit_pools[1].submit(
                        emit.write_long_repeats, prefix + ".long_repeats.txt" + sfx,
                        res, first_read_index=lo, append=not first, gz=gz_out),
                    emit_pools[2].submit(
                        emit.write_long_repeats_bed,
                        prefix + ".long_repeats.bed" + sfx, store, res,
                        append=not first, gz=gz_out),
                ]
            pending.append(futs + cov_fut)

        with _Timer(stats, "emit"):
            while pending:
                for f in pending.popleft():
                    f.result()
        return frag_num

    try:
        frag_num = _chunk_loop()
    except BaseException:
        # mid-run failure (emit I/O error, compute error, load error):
        # tear the worker pools down WITHOUT waiting on queued work,
        # release the spill files, and name the partial outputs — a
        # crashed streaming run must not leave the user guessing which
        # append-mode files hold truncated data.
        for p in emit_pools + [cov_pool, load_pool]:
            p.shutdown(wait=False, cancel_futures=True)
        if bins is not None:
            bins.close()
        partial = [prefix + nm + sfx
                   for nm in (".reads.fasta", ".coverage.txt",
                              ".long_repeats.txt", ".long_repeats.bed")
                   if os.path.exists(prefix + nm + sfx)]
        if partial:
            print("ERROR, streaming run aborted mid-emit; these outputs "
                  "are PARTIAL and must be discarded: "
                  + " ".join(partial), file=sys.stderr)
        raise

    if trace is not None:
        import json as _json
        with open(trace_path, "w") as tf:
            for rec in recs:
                tf.write(_json.dumps(rec) + "\n")
            tf.write(_json.dumps(
                {"total_wall_s": round(time.perf_counter() - T0, 3),
                 "stage_seconds": {k: round(v, 3)
                                   for k, v in stats.stage_seconds.items()},
                 "chunk_reads": chunk_reads, "n_chunks": len(chunks),
                 "spill_paf": bool(bins is not None)}) + "\n")

    stats.n_reads = n
    stats.n_paf_rows = n_paf_rows
    stats.symmetric = symmetric
    stats.n_fragments = frag_num - 1
    stats.emit_bytes = _sum_output_bytes(prefix, sfx)
    for p in emit_pools + [cov_pool, load_pool]:
        p.shutdown()
    if bins is not None:
        bins.close()
    if verbose:
        print(f"coverage per window is {stats.coverage_per_window:f} ")
        print("coverage per window/average coverage is "
              f"{stats.coverage_per_window / params.est_cov:f} ")
        print(f"fraction_of_repeat_length {stats.fraction_repeat:f} ")
        if not auto_e:
            # in auto mode the threshold came FROM the data; the
            # mis-specification advisory would only confuse
            _est_cov_hint(stats, params)
    return stats


class _GroupedEventTable:
    """Pre-grouped window-binned event slab with the
    OverlapTable.events_grouped() contract (chunk slice of the
    whole-input native counting-sort result; strictness was enforced
    once at the global grouping)."""

    def __init__(self, off, w0, w1, symmetric):
        self._g = (np.ascontiguousarray(off, dtype=np.int64),
                   np.ascontiguousarray(w0, dtype=np.int32),
                   np.ascontiguousarray(w1, dtype=np.int32))
        self.symmetric = symmetric
        self.n_rows = len(self._g[1])

    def events_grouped(self, n_reads, lens, reso, strict=True):
        return self._g


class _EventTable:
    """Pre-built event view with the OverlapTable.events() contract."""

    def __init__(self, ev_read, ev_lo, ev_hi, symmetric):
        self._ev = (np.ascontiguousarray(ev_read, dtype=np.int32),
                    np.ascontiguousarray(ev_lo, dtype=np.int32),
                    np.ascontiguousarray(ev_hi, dtype=np.int32))
        self.symmetric = symmetric
        self.n_rows = len(ev_read)

    def events(self, n_reads, strict=True):
        return self._ev
