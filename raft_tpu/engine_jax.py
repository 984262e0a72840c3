"""Device engine: the three RAFT compute stages as one fused, jitted
function over dense ``[B, W]`` batches.

Stage mapping (reference → device formulation):

* ``profileCoverage`` (repeat.hpp:28-79, per-read event sort + window
  increments) → **diff-array scatter-add + row cumsum**: an overlap
  interval becomes +1 at window ``floor(s/reso)`` and -1 after window
  ``floor((e-1)/reso)``; per-read coverage is a cumulative sum along the
  window axis. No sort, no data-dependent loops — one scatter and one
  cumsum over the whole batch.
* ``repeat_annotate``'s run scan (repeat.hpp:111-168) → **vectorized
  run-length detection**: run starts via ``high & ~high[-1]``, run ids via
  ``cummax`` of start positions, qualifying run-ends compacted into fixed
  ``[B, K]`` interval slots with a bounded-K scatter (K is a closed-form
  safe bound, so no spill path is ever needed).
* ``break_reads``'s marker deletion + fragment arithmetic
  (chop.hpp:209-321) → **vectorized marker selection**: candidate markers
  are an iota; deletion is an interval-stabbing test against the [B, K]
  repeat slots; surviving markers compact via cumsum-rank scatter; fragment
  spans gather from the compacted marker table.

Everything is int32, static-shaped, and batched; the only outputs that
return to the host are the coverage matrix (for ``.coverage.txt``), the
repeat slots, and the per-fragment span table the emitter consumes.
"""

from __future__ import annotations

import dataclasses
import os
import functools

import numpy as np

import jax
import jax.numpy as jnp

# Persistent compilation cache: bucket shapes recur across runs, so every
# compiled executable is cached on disk. JAX_COMPILATION_CACHE_DIR, when
# set, is used as is (JAX reads it itself); otherwise the cache lives in
# one fixed directory inside the checkout — the path is part of the cache
# key, so it must not move between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

from raft_tpu import bucketing
from raft_tpu.io.fasta import ReadStore
from raft_tpu.io.paf import OverlapTable
from raft_tpu.params import AlgoParams


@dataclasses.dataclass(frozen=True)
class StaticCfg:
    """Static (hashable) kernel configuration → part of the jit cache key."""
    B: int
    W: int
    E: int
    M: int          # marker slots
    K: int          # repeat-interval slots (closed-form safe bound)
    F: int          # fragment slots
    reso: int
    high_cov: int
    repeat_length: int
    flank: int
    interval_length: int
    div: int
    overlap_length: int
    cov_out: str = "host"
    ev_pack: int = 32  # event wire format: 16/24/32-bit packed, 0 = pairs


def default_cov_out() -> str:
    """Coverage return mode (RAFT_COV_OUT): ``host`` (default) keeps the
    coverage matrix on device and the host recomputes the emission copy
    from the bucket's own events — D2H shrinks to the small packed array;
    ``diff8`` ships the int8 per-window diff (one byte per window) and
    cumsums on host; ``cov`` ships the full int32 matrix."""
    return os.environ.get("RAFT_COV_OUT", "host")


def derive_cfg(B: int, W: int, E: int, params: AlgoParams,
               cov_out: str | None = None) -> StaticCfg:
    reso = params.reso
    il = params.interval_length
    rl = params.repeat_length
    # markers: 0..parts plus optional read-end; maxlen <= W*reso
    M = (W * reso) // il + 2
    # a qualifying run needs ceil(rl/reso) windows; runs separated by >= 1
    # low window → closed-form cap on runs per read (no spill path needed)
    min_run = max(1, -(-rl // reso))
    K = (W + 1) // (min_run + 1) + 1
    F = M // max(params.div, 1) + 2
    return StaticCfg(B=B, W=W, E=E, M=M, K=K, F=F, reso=reso,
                     high_cov=params.high_cov, repeat_length=rl,
                     flank=params.flanking_length, interval_length=il,
                     div=params.div, overlap_length=params.overlap_length,
                     cov_out=cov_out or default_cov_out(),
                     ev_pack=event_pack_mode(W, E))


def _ev_bits_w0(W: int) -> int:
    """Bits for a window index in [0, W): k = log2(W) (W is a power of
    two in every bucket tier)."""
    return max(int(W - 1).bit_length(), 1)


def event_pack_mode(W: int, E: int) -> int:
    """Event wire format: each event is (w0, span) in 2k+1 bits where
    k = log2(W) — w0 in k bits, span = w1-w0+1 in k+1 bits (span 0 =
    invalid/padding). Narrow wire format: fewer H2D bytes — events ship
    in the narrowest byte-aligned layout the tier allows:

    * 16 → uint16 per event (W <= 128)
    * 24 → three bytes per event, 4 events per 3 uint32 words
           (W <= 2048; needs E % 4 == 0, which every tier ladder gives)
    * 32 → one uint32 per event (W <= 32768)
    *  0 → (w0, span) int32 pairs (ultralong tiers beyond 32768 windows)
    """
    bits = 2 * _ev_bits_w0(W) + 1
    if bits <= 16:
        return 16
    if bits <= 24 and E % 4 == 0:
        return 24
    if bits <= 32:
        return 32
    return 0


def pack_events(ev_w0, ev_w1, cfg: StaticCfg) -> np.ndarray:
    """Host side of the event wire format (see event_pack_mode).

    Sanitizes exactly like the host coverage renderer
    (raftio_emit_coverage_events): an event is valid iff
    ``w1 >= w0 and 0 <= w0 < W``; w1 clamps to W-1 (only reachable on
    non-strict malformed input — strict mode guarantees in-bounds).

    Packs the FULL array it is given (sharded buckets pass all shards'
    slabs concatenated while cfg.E is per-shard; slabs are multiples of
    4 events so the 24-bit groups never straddle a shard boundary)."""
    W = cfg.W
    k = _ev_bits_w0(W)
    # all-int32 arithmetic: this runs per event on the host critical path
    w0 = np.asarray(ev_w0, dtype=np.int32)
    w1 = np.asarray(ev_w1, dtype=np.int32)
    valid = (w1 >= w0) & (w0 >= 0) & (w0 < W)
    span = np.where(valid, np.minimum(w1, W - 1) - w0 + 1, 0)
    w0c = np.where(valid, w0, 0)
    if cfg.ev_pack == 0:
        return np.stack([w0c, span], axis=1)
    v = w0c.view(np.uint32) | (span.view(np.uint32) << np.uint32(k))
    if cfg.ev_pack == 16:
        return v.astype(np.uint16)
    if cfg.ev_pack == 32:
        return v
    q = v.reshape(len(v) // 4, 4)  # uint32 shifts truncate mod 2^32
    a = q[:, 0] | (q[:, 1] << np.uint32(24))
    b = (q[:, 1] >> np.uint32(8)) | (q[:, 2] << np.uint32(16))
    c = (q[:, 2] >> np.uint32(16)) | (q[:, 3] << np.uint32(8))
    return np.stack([a, b, c], axis=1).reshape(-1)


def unpack_events(ev_pk, cfg: StaticCfg):
    """Device side of the event wire format → (ev_w0, ev_w1) int32 [E].
    Invalid/padding events decode to w1 = w0 - 1, which the pileup's
    ``w1 >= w0`` validity test drops — no separate mask travels."""
    W, E = cfg.W, cfg.E
    k = _ev_bits_w0(W)
    if cfg.ev_pack == 0:
        w0 = ev_pk[:, 0]
        return w0, w0 + ev_pk[:, 1] - 1
    if cfg.ev_pack == 24:
        g = ev_pk.reshape(E // 4, 3)
        a, b, c = g[:, 0], g[:, 1], g[:, 2]
        v0 = a & 0xFFFFFF
        v1 = (a >> 24) | ((b & 0xFFFF) << 8)
        v2 = (b >> 16) | ((c & 0xFF) << 16)
        v3 = c >> 8
        v = jnp.stack([v0, v1, v2, v3], axis=1).reshape(E)
    else:
        v = ev_pk.astype(jnp.uint32)
    w0 = (v & ((1 << k) - 1)).astype(jnp.int32)
    span = (v >> k).astype(jnp.int32)
    return w0, w0 + span - 1


# ---------------------------------------------------------------------------
# Stage 1: coverage pileup
# ---------------------------------------------------------------------------

def rows_from_offsets(ev_off, cfg: StaticCfg):
    """[B+1] exclusive per-row event offsets → [E] int32 row ids (B for
    padding slots).

    Events are laid out row-major (``bucketing.make_buckets``), so the
    per-event row id is fully determined by the B+1 slab offsets. Instead
    of uploading E int16 row ids, the host ships the offsets (~0 bytes
    per event) and the device rebuilds rows with one scatter-max and a
    cummax: fewer H2D bytes. Ties (empty rows sharing an offset) resolve
    to the largest row id, which is exactly the row whose slab begins
    there; the final offset (= total events) scatters B so the padded
    tail drops."""
    B, E = cfg.B, cfg.E
    iota_b = jnp.arange(B + 1, dtype=jnp.int32)
    marks = jnp.full(E + 1, -1, jnp.int32).at[
        ev_off.astype(jnp.int32)].max(iota_b, mode="drop")
    return jax.lax.cummax(marks)[:E]


def pileup_diff_scatter(ev_row, ev_w0, ev_w1, cfg: StaticCfg):
    """[E] window-binned events → (cov [B,W] int32, diff [B,W] int32).

    diff is the per-window increment array whose row cumsum is cov; it is
    what gets shipped back to the host (as int8 when it fits) in the
    ``diff8`` coverage mode.
    """
    B, W = cfg.B, cfg.W
    w0 = ev_w0.astype(jnp.int32)
    w1 = ev_w1.astype(jnp.int32)
    row = ev_row.astype(jnp.int32)
    valid = (w1 >= w0) & (row < B)
    one = valid.astype(jnp.int32)
    stride = W + 1
    base = row * stride
    flat0 = jnp.where(valid, base + w0, B * stride)
    flat1 = jnp.where(valid, base + w1 + 1, B * stride)
    diff = jnp.zeros(B * stride, dtype=jnp.int32)
    diff = diff.at[flat0].add(one, mode="drop")
    diff = diff.at[flat1].add(-one, mode="drop")
    diff = diff.reshape(B, stride)
    cov = jnp.cumsum(diff, axis=1)[:, :W]
    return cov, diff[:, :W]


# ---------------------------------------------------------------------------
# Stage 2: repeat run-length scan
# ---------------------------------------------------------------------------

def repeat_scan(cov, lens, cfg: StaticCfg):
    """[B, W] coverage → fixed-slot repeat intervals.

    Returns (rep_s, rep_e) [B, K] clamped+flanked intervals (empty slots
    hold s=1 > e=0 so they never match a stabbing test), rep_n [B], and
    rep_len_sum [B] (unclamped lengths, for the global stats).
    """
    B, W, K, reso = cfg.B, cfg.W, cfg.K, cfg.reso
    n_win = -(-lens // reso)  # ceil
    wi = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1)
    valid_w = wi < n_win[:, None]
    high = (cov >= cfg.high_cov) & valid_w

    prev_high = jnp.pad(high[:, :-1], ((0, 0), (1, 0)))
    next_high = jnp.pad(high[:, 1:], ((0, 0), (0, 1)))
    run_start_mark = high & ~prev_high
    run_end_mark = high & ~next_high

    run_start = jax.lax.cummax(
        jnp.where(run_start_mark, wi, -1), axis=1)
    run_nwin = wi - run_start + 1
    qualify = run_end_mark & (run_nwin * reso >= cfg.repeat_length)

    # per-row (not global) sum: stays within int32 since it is bounded by
    # the read length; the host accumulates into a Python int
    rep_len_sum = jnp.sum(jnp.where(qualify, run_nwin * reso, 0), axis=1)

    s = jnp.maximum(run_start * reso - cfg.flank, 0)
    e_unc = (wi + 1) * reso + cfg.flank
    e = jnp.minimum(e_unc, lens[:, None])

    rank = jnp.cumsum(qualify.astype(jnp.int32), axis=1) - 1
    row = jax.lax.broadcasted_iota(jnp.int32, (B, W), 0)
    flat = jnp.where(qualify & (rank < K), row * K + rank, B * K)
    rep_s = jnp.full(B * K, 1, dtype=jnp.int32).at[flat.ravel()].set(
        s.ravel().astype(jnp.int32), mode="drop").reshape(B, K)
    rep_e = jnp.zeros(B * K, dtype=jnp.int32).at[flat.ravel()].set(
        e.ravel().astype(jnp.int32), mode="drop").reshape(B, K)
    rep_n = jnp.sum(qualify, axis=1).astype(jnp.int32)
    return rep_s, rep_e, rep_n, rep_len_sum


# ---------------------------------------------------------------------------
# Stage 3: marker selection + fragment spans
# ---------------------------------------------------------------------------

def chop_markers(lens, rep_s, rep_e, cfg: StaticCfg):
    """Candidate markers → surviving markers → fragment span table.

    Returns dict of [B] / [B, F] arrays the host emitter consumes.
    """
    B, M, K, F = cfg.B, cfg.M, cfg.K, cfg.F
    il, div, ov = cfg.interval_length, cfg.div, cfg.overlap_length

    parts = lens // il
    has_rem = (lens % il) != 0
    n_stars = parts + 1 + has_rem.astype(jnp.int32)

    j = jax.lax.broadcasted_iota(jnp.int32, (B, M), 1)
    star_val = jnp.where(j <= parts[:, None], j * il, lens[:, None])
    valid_star = j < n_stars[:, None]

    # interval-stabbing deletion test against the [B, K] repeat slots
    inside = jnp.any(
        (rep_s[:, None, :] <= star_val[:, :, None])
        & (star_val[:, :, None] <= rep_e[:, None, :]), axis=2)
    keep = valid_star & (
        (j == 0) | (j == (n_stars - 1)[:, None]) | ~inside)

    S = jnp.sum(keep, axis=1).astype(jnp.int32)
    rank = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    row = jax.lax.broadcasted_iota(jnp.int32, (B, M), 0)
    flat = jnp.where(keep, row * M + rank, B * M)
    stars_c = jnp.zeros(B * M, dtype=jnp.int32).at[flat.ravel()].set(
        star_val.ravel(), mode="drop").reshape(B, M)

    whole = S <= (div + 1)
    extra = S - (div + 1)
    n_frag = jnp.where(
        whole, 1, 1 + extra // div + ((extra % div) != 0).astype(jnp.int32))

    fi = jax.lax.broadcasted_iota(jnp.int32, (B, F), 1)
    pos = fi * div
    gather = lambda idx: jnp.take_along_axis(
        stars_c, jnp.clip(idx, 0, M - 1), axis=1)
    star_f = gather(pos)
    last_star = jnp.take_along_axis(
        stars_c, jnp.clip(S - 1, 0, M - 1)[:, None], axis=1)  # [B, 1]
    is_last = fi == (n_frag - 1)[:, None]
    last_f = jnp.where(is_last, last_star, gather(pos + div))
    ov_f = jnp.where(fi == 0, 0, ov)

    whole_b = whole[:, None]
    char_start = jnp.where(whole_b, 0, star_f - ov_f)
    char_len = jnp.where(whole_b, lens[:, None], last_f - star_f + ov_f)

    return dict(n_frag=n_frag, whole=whole, char_start=char_start,
                char_len=char_len)


# ---------------------------------------------------------------------------
# Fused device step
# ---------------------------------------------------------------------------

# Packed-output column layout: every small per-read result travels in
# ONE int32 [B, 2K+2F+5] array — each fetched leaf is a separate D2H
# copy, so a bucket's results are one or two transfers (packed + the
# optional coverage array) instead of ten.
PACKED_SCALARS = 5  # rep_n, rep_len_sum, n_frag, whole, ok8


def packed_width(cfg: StaticCfg) -> int:
    return 2 * cfg.K + 2 * cfg.F + PACKED_SCALARS


def unpack_out(packed: np.ndarray, cfg: StaticCfg) -> dict:
    """Host-side view split of the packed [B, …] int32 array."""
    K, F = cfg.K, cfg.F
    base = 2 * K + 2 * F
    return dict(
        rep_s=packed[:, :K], rep_e=packed[:, K:2 * K],
        char_start=packed[:, 2 * K:2 * K + F],
        char_len=packed[:, 2 * K + F:base],
        rep_n=packed[:, base], rep_len_sum=packed[:, base + 1],
        n_frag=packed[:, base + 2],
        whole=packed[:, base + 3] != 0,
        ok8=packed[:, base + 4] != 0)


def device_step_impl(lens, ev_off, ev_pk, cfg: StaticCfg):
    """Full per-batch pipeline: pileup → repeat scan → chop (unjitted).

    ``ev_off`` is the [B+1] exclusive per-row event offset table; row ids
    are reconstructed on device (see ``rows_from_offsets``). ``ev_pk`` is
    the packed event array (see ``event_pack_mode``); (w0, w1) decode on
    device — H2D ships the narrowest wire format the tier allows."""
    ev_row = rows_from_offsets(ev_off, cfg)
    ev_w0, ev_w1 = unpack_events(ev_pk, cfg)
    cov, diff = pileup_diff_scatter(ev_row, ev_w0, ev_w1, cfg)
    rep_s, rep_e, rep_n, rep_len_sum = repeat_scan(cov, lens, cfg)
    frags = chop_markers(lens, rep_s, rep_e, cfg)

    out = {}
    if cfg.cov_out == "diff8":
        # int8 transfer with per-row overflow flag; the host rebuilds
        # rows where a window gains/loses more than 127 intervals
        # (vanishingly rare pileups) from the bucket's own events
        ok8 = (jnp.max(diff, axis=1) <= 127) & (jnp.min(diff, axis=1) >= -128)
        out["diff8"] = diff.astype(jnp.int8)
    elif cfg.cov_out == "cov":
        ok8 = jnp.ones(cfg.B, dtype=jnp.bool_)
        out["cov"] = cov
    else:
        # "host": the coverage matrix never leaves the device — the host
        # rebuilds the emission copy from the bucket's own events
        # (bincount + cumsum), so D2H is just the packed per-read array
        ok8 = jnp.ones(cfg.B, dtype=jnp.bool_)
    out["packed"] = jnp.concatenate(
        [rep_s, rep_e, frags["char_start"], frags["char_len"],
         rep_n[:, None], rep_len_sum[:, None],
         frags["n_frag"][:, None],
         frags["whole"][:, None].astype(jnp.int32),
         ok8[:, None].astype(jnp.int32)], axis=1)
    return out


@functools.partial(jax.jit, static_argnames=("cfg",))
def device_step(lens, ev_off, ev_pk, *, cfg: StaticCfg):
    return device_step_impl(lens, ev_off, ev_pk, cfg)


# ---------------------------------------------------------------------------
# Host driver: buckets in, per-read results out
# ---------------------------------------------------------------------------

def _cumsum0(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x) + 1, dtype=np.int64)
    np.cumsum(x, out=out[1:])
    return out


def _slab_copy_idx(cnt: np.ndarray, src_start: np.ndarray,
                   dst_start: np.ndarray):
    """Vectorized variable-length slab copy index arrays: returns
    (src_idx, dst_idx) such that dst[dst_idx] = src[src_idx] copies
    cnt[i] consecutive items from src_start[i] to dst_start[i]."""
    tot = int(cnt.sum())
    if tot == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z
    off = _cumsum0(cnt)
    within = np.arange(tot, dtype=np.int64) - np.repeat(off[:-1], cnt)
    return (np.repeat(np.asarray(src_start, np.int64), cnt) + within,
            np.repeat(np.asarray(dst_start, np.int64), cnt) + within)


def compute_jax(store: ReadStore, table: OverlapTable, params: AlgoParams,
                strict: bool = True, mesh=None, cov_out: str | None = None,
                on_cov_events=None,
                timers_out: dict | None = None,
                grouped=None) -> "ComputeResult":
    """JAX engine: device batches in, flat ComputeResult out (no per-read
    Python loops anywhere).

    ``on_cov_events``: in ``cov_out="host"`` mode the event-backed
    coverage (everything ``.coverage.txt`` needs) is fully determined
    before any device work — when given, this callback receives a
    coverage-only ComputeResult right after event prep so the caller can
    overlap coverage emission with the device stage.

    ``timers_out``: optional dict that receives this call's internal
    stage seconds (events/sort/bucket_prep/fetch/integrate) — the
    structured form of the RAFT_TIMERS stderr line, used by the chunk
    tracer (RAFT_CHUNK_TRACE)."""
    from raft_tpu.result import ComputeResult

    import time as _time
    _timers: dict = {}
    _t0 = _time.perf_counter()

    def _mark(name):
        nonlocal _t0
        t = _time.perf_counter()
        _timers[name] = _timers.get(name, 0.0) + (t - _t0)
        _t0 = t

    n = store.n_reads
    lens = store.lens.astype(np.int32)
    reso = params.reso

    # Fast path: the native counting-sort pass delivers events already
    # read-grouped and window-binned (one C++ scan over the PAF columns),
    # replacing events() + argsort + searchsorted + binning. A caller
    # that already grouped (--auto-e estimates from the same triple)
    # passes it in to avoid repeating the pass.
    if grouped is None:
        eg = getattr(table, "events_grouped", None)
        if eg is not None:
            grouped = eg(n, lens, reso, strict=strict)
    if grouped is not None:
        g_off, g_w0, g_w1 = grouped
        ev_read = ev_lo = ev_hi = None
        _mark("events")
    else:
        g_off = g_w0 = g_w1 = None
        ev_read, ev_lo, ev_hi = table.events(n, strict=strict)
        if strict:
            _validate_events(lens, ev_read, ev_lo, ev_hi, params.reso)
        _mark("events")
        # sort events read-major once; bucketing and the event-backed
        # coverage emission both consume the sorted layout
        order = np.argsort(ev_read, kind="stable")
        ev_read = ev_read[order]
        ev_lo = ev_lo[order]
        ev_hi = ev_hi[order]
        _mark("sort")

    nw_all = (-(-lens.astype(np.int64) // reso))
    cov_off = _cumsum0(nw_all)
    mode = cov_out or default_cov_out()
    # device_step_impl treats anything but diff8/cov as "host"
    ev_backed = mode not in ("diff8", "cov")
    if ev_backed:
        # Event-backed coverage: the emitter renders .coverage.txt
        # straight from the window-binned events (the coverage matrix
        # never leaves the device). All of it is known NOW.
        if grouped is not None:
            ev_off_g, w0s, w1s = g_off, g_w0, g_w1
            nwr = np.repeat(nw_all, np.diff(ev_off_g))
        else:
            w0s = (ev_lo.astype(np.int64) // reso).astype(np.int32)
            w1s = np.where(ev_hi < 0, -1,
                           ev_hi.astype(np.int64) // reso).astype(np.int32)
            ev_off_g = np.searchsorted(ev_read, np.arange(n + 1)).astype(
                np.int64)
            nwr = nw_all[ev_read]
        # closed-form Σcov with the renderer's exact clamp semantics
        valid = (w1s >= w0s) & (w0s >= 0) & (w0s < nwr)
        total_cov = int(np.where(
            valid,
            np.minimum(w1s.astype(np.int64), nwr - 1) - w0s + 1,
            0).sum())
        cov_flat = None
        if on_cov_events is not None:
            z32 = np.empty(0, np.int32)
            z64 = np.empty(0, np.int64)
            on_cov_events(ComputeResult(
                n_reads=n, cov_flat=None, cov_off=cov_off,
                rep_s=z32, rep_e=z32,
                rep_off=np.zeros(n + 1, np.int64),
                frag_read=z32, frag_char_start=z64, frag_char_len=z64,
                frag_whole=np.empty(0, bool),
                total_coverage=total_cov, total_windows=int(nw_all.sum()),
                cov_ev_w0=w0s, cov_ev_w1=w1s, cov_ev_off=ev_off_g))
    else:
        w0s = w1s = ev_off_g = None
        cov_flat = np.empty(int(cov_off[-1]), dtype=np.int32)

    step = device_step
    n_shards = 1
    stage = jnp.asarray
    if mesh is not None:
        from raft_tpu.parallel.mesh import (shard_bucket, sharded_device_step,
                                            stage_sharded)
        step = sharded_device_step(mesh)
        n_shards = mesh.devices.size
        stage = functools.partial(stage_sharded, mesh)

    import concurrent.futures as cf

    # Streaming prep: each bucket is staged (async H2D) the moment it is
    # built, so transfer bytes flow while the next bucket's numpy routing
    # runs; unseen shapes compile on a small pool (RAFT_COMPILE_WORKERS).
    workers = max(1, int(os.environ.get("RAFT_COMPILE_WORKERS", "2")))
    compiles: dict = {}
    prebinned = (g_off, g_w0, g_w1) if grouped is not None else None

    fetch_workers = max(1, int(os.environ.get("RAFT_FETCH_WORKERS", "4")))
    io_pool = cf.ThreadPoolExecutor(max_workers=fetch_workers)
    roundtrips: list = []

    def _roundtrip(bk, cfg, args, key):
        compiles[key].result()  # jit cache shared → dispatch is cheap
        out = step(*args, cfg=cfg)
        out = jax.device_get(out)
        out = {**unpack_out(np.asarray(out.pop("packed")), cfg), **out}
        if "diff8" in out:
            cov = np.cumsum(out.pop("diff8"), axis=1, dtype=np.int32)
            bad = np.nonzero(~out["ok8"])[0]
            if len(bad):
                # rare: a window gained/lost >127 intervals, so the
                # int8 diff wrapped for these rows — rebuild exactly
                # on host from the bucket's own events (no second
                # device round trip, cost bounded per bad row)
                _host_cov_rows(bk, n_shards, bad, cov)
            out["cov"] = cov
        return bk, out

    try:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            for bk in bucketing.iter_buckets(lens, ev_read, ev_lo, ev_hi,
                                             params.reso, presorted=True,
                                             prebinned=prebinned):
                if n_shards > 1:
                    bk = shard_bucket(bk, n_shards)
                # cfg describes PER-SHARD shapes under shard_map
                cfg = derive_cfg(bk.B // n_shards, bk.W, bk.E // n_shards,
                                 params, cov_out=cov_out)
                args = (stage(bk.lens), stage(bk.ev_off),
                        stage(pack_events(bk.ev_w0, bk.ev_w1, cfg)))
                key = (cfg,) + tuple((a.shape, a.dtype.name) for a in args)
                if key not in compiles:
                    compiles[key] = pool.submit(
                        lambda c=cfg, a=args: step.lower(*a, cfg=c).compile())
                # the full device roundtrip (await compile → dispatch →
                # device_get → host post-process) is submitted PER BUCKET
                # the moment it is staged, so exec+D2H overlap the
                # remaining bucket routing and concurrent roundtrips
                # overlap each other's D2H copies and host post-processing
                roundtrips.append(io_pool.submit(_roundtrip, bk, cfg,
                                                 args, key))
            _mark("bucket_prep")

        outs = [f.result() for f in roundtrips]
    finally:
        io_pool.shutdown(wait=False, cancel_futures=True)
    _mark("fetch")

    # global offsets in read-id order
    rep_n_all = np.zeros(n, dtype=np.int64)
    frag_n_all = np.zeros(n, dtype=np.int64)
    total_rep_len = 0
    for bk, out in outs:
        nu = bk.n_used
        rep_n_all[bk.read_ids] = out["rep_n"][:nu]
        frag_n_all[bk.read_ids] = out["n_frag"][:nu]
        total_rep_len += int(out["rep_len_sum"][:nu].astype(np.int64).sum())
    rep_off = _cumsum0(rep_n_all)
    frag_off = _cumsum0(frag_n_all)

    rep_s = np.empty(int(rep_off[-1]), dtype=np.int32)
    rep_e = np.empty(int(rep_off[-1]), dtype=np.int32)
    n_frags = int(frag_off[-1])
    frag_read = np.empty(n_frags, dtype=np.int32)
    frag_cs = np.empty(n_frags, dtype=np.int64)
    frag_cl = np.empty(n_frags, dtype=np.int64)
    frag_wh = np.empty(n_frags, dtype=bool)

    for bk, out in outs:
        nu = bk.n_used
        rid = bk.read_ids
        rows = np.arange(nu, dtype=np.int64)
        if not ev_backed:
            W = out["cov"].shape[1]
            s_idx, d_idx = _slab_copy_idx(nw_all[rid], rows * W,
                                          cov_off[rid])
            cov_flat[d_idx] = out["cov"].ravel()[s_idx]

        K = out["rep_s"].shape[1]
        s_idx, d_idx = _slab_copy_idx(rep_n_all[rid], rows * K, rep_off[rid])
        rep_s[d_idx] = out["rep_s"].ravel()[s_idx]
        rep_e[d_idx] = out["rep_e"].ravel()[s_idx]

        F = out["char_start"].shape[1]
        cnt = frag_n_all[rid]
        s_idx, d_idx = _slab_copy_idx(cnt, rows * F, frag_off[rid])
        frag_cs[d_idx] = out["char_start"].ravel()[s_idx]
        frag_cl[d_idx] = out["char_len"].ravel()[s_idx]
        frag_read[d_idx] = np.repeat(rid, cnt)
        frag_wh[d_idx] = np.repeat(out["whole"][:nu], cnt)

    _mark("integrate")
    if timers_out is not None:
        timers_out.update(_timers)
    if os.environ.get("RAFT_TIMERS"):
        import sys as _sys
        print("compute_jax timers: " + ", ".join(
            f"{k}={v:.3f}s" for k, v in _timers.items()), file=_sys.stderr)
    return ComputeResult(
        n_reads=n,
        cov_flat=cov_flat, cov_off=cov_off,
        rep_s=rep_s, rep_e=rep_e, rep_off=rep_off,
        frag_read=frag_read, frag_char_start=frag_cs,
        frag_char_len=frag_cl, frag_whole=frag_wh,
        total_coverage=(total_cov if ev_backed
                        else int(cov_flat.sum(dtype=np.int64))),
        total_windows=int(nw_all.sum()),
        total_repeat_length=total_rep_len,
        total_read_length=int(lens.astype(np.int64).sum()),
        cov_ev_w0=w0s, cov_ev_w1=w1s, cov_ev_off=ev_off_g,
    )


def _bucket_global_rows(bk, n_shards: int) -> np.ndarray:
    """Event → global bucket row. Sharded buckets store shard-local row
    ids per event slab; map them back (pad sentinel → bk.B)."""
    rows = np.asarray(bk.ev_row, dtype=np.int64)
    if n_shards > 1:
        B_local = bk.B // n_shards
        E_s = bk.E // n_shards
        slab = np.arange(len(rows), dtype=np.int64) // E_s
        rows = np.where(rows >= B_local, bk.B, slab * B_local + rows)
    return rows


def _host_cov_rows(bk, n_shards: int, bad: np.ndarray,
                   cov: np.ndarray) -> None:
    """Recompute int32 coverage for rows ``bad`` of a bucket from its own
    events (the same diff+cumsum the device runs, repeat.hpp:62-77
    semantics) and write them into ``cov`` in place.
    """
    W = cov.shape[1]
    rows = _bucket_global_rows(bk, n_shards)
    w0 = np.asarray(bk.ev_w0, dtype=np.int64)
    w1 = np.asarray(bk.ev_w1, dtype=np.int64)
    sel = (np.isin(rows, bad) & (w1 >= w0)
           & (w0 >= 0) & (w0 <= W) & (w1 + 1 <= W))
    remap = np.full(int(bk.B) + 1, -1, dtype=np.int64)
    remap[bad] = np.arange(len(bad))
    r = remap[rows[sel]]
    d = np.zeros((len(bad), W + 1), dtype=np.int32)
    np.add.at(d, (r, w0[sel]), 1)
    np.add.at(d, (r, w1[sel] + 1), -1)
    cov[bad] = np.cumsum(d[:, :W], axis=1)


def _validate_events(lens, ev_read, ev_lo, ev_hi, reso):
    ok = len(ev_read) == 0 or (
        (ev_lo >= 0).all()
        and (ev_hi < lens.astype(np.int64)[ev_read]).all())
    if not ok:
        raise ValueError(
            "overlap interval exceeds read bounds (reference RAFT has an "
            "unchecked buffer overrun here, repeat.hpp:69-73); "
            "fix the PAF or run with --no-strict")
