"""Unit tests: device kernels vs the exact-semantics oracle on randomized
and adversarial inputs (fuzz harness for each stage in isolation)."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from raft_tpu import bucketing
from raft_tpu.engine_jax import (chop_markers, derive_cfg, event_pack_mode,
                                 pack_events, pileup_diff_scatter,
                                 repeat_scan, rows_from_offsets,
                                 unpack_events)
from raft_tpu.ops import oracle
from raft_tpu.params import AlgoParams


def rand_case(rng, n_reads=16, max_len=8000, reso=50, max_ev_per_read=30):
    lens = rng.integers(1, max_len, n_reads).astype(np.int32)
    ev_read, ev_lo, ev_hi = [], [], []
    for r in range(n_reads):
        for _ in range(rng.integers(0, max_ev_per_read)):
            a = int(rng.integers(0, lens[r]))
            b = int(rng.integers(a, lens[r]))  # end exclusive <= len
            ev_read.append(r)
            ev_lo.append(a)
            ev_hi.append(b)  # may equal a → zero-length match, hi = a-1
    ev_read = np.asarray(ev_read, dtype=np.int32)
    ev_lo = np.asarray(ev_lo, dtype=np.int32)
    ev_hi = np.asarray(ev_hi, dtype=np.int32) - 1  # inclusive
    return lens, ev_read, ev_lo, ev_hi


def _dense_case(rng, B=256, W=128, E=4096, reso=50):
    """Dense multi-tile batch laid out directly (no bucketing): B reads of
    W full windows, E events with sorted rows spread over every row."""
    lens = np.full(B, W * reso, dtype=np.int32)
    ev_read = np.sort(rng.integers(0, B, E)).astype(np.int32)
    w0 = rng.integers(0, W, E)
    w1 = np.minimum(w0 + rng.integers(0, W - 1, E), W - 1)
    ev_lo = (w0 * reso + rng.integers(0, reso, E)).astype(np.int32)
    ev_hi = (w1 * reso + rng.integers(0, reso, E)).astype(np.int32)
    return lens, ev_read, ev_lo, ev_hi


def _bucketed_case(rng, n_reads, max_len, reso=50):
    """Variable-length reads with up to 40 events each, read-major."""
    lens = rng.integers(1, max_len, n_reads).astype(np.int32)
    ev_read, ev_lo, ev_hi = [], [], []
    for r in range(n_reads):
        for _ in range(int(rng.integers(0, 40))):
            a = int(rng.integers(0, lens[r]))
            b = int(rng.integers(a, lens[r] + 1))
            ev_read.append(r)
            ev_lo.append(a)
            ev_hi.append(b - 1)
    ev_read = np.asarray(ev_read, dtype=np.int32)
    order = np.argsort(ev_read, kind="stable")
    return (lens, ev_read[order], np.asarray(ev_lo, dtype=np.int32)[order],
            np.asarray(ev_hi, dtype=np.int32)[order])


_PILEUP_LAYOUTS = (
    # random small reads through make_buckets (several W tiers)
    [("rand", seed) for seed in range(5)]
    # dense multi-tile batches: B=256, W=128, with 4096 and 1024 events
    + [(f"dense{e}", 900 + seed) for e in (4096, 1024) for seed in range(3)]
    # make_buckets layouts: 16 reads (one sparse tier) and 130 reads of up
    # to 20 kb (tiers merged upward, uneven per-row slabs)
    + [(f"buckets{n}", seed) for n in (16, 130) for seed in range(3)]
    # 300 reads: B lands on a 1.5*2^k ladder size (384)
    + [("buckets300", 300 + seed) for seed in range(2)])


@pytest.mark.parametrize("layout,seed", _PILEUP_LAYOUTS)
def test_pileup_matches_oracle(layout, seed):
    """The device pileup (scatter-add diff + row cumsum) equals the
    scalar oracle's per-read coverage on every layout."""
    rng = np.random.default_rng(seed)
    reso = 50
    params = AlgoParams(est_cov=10, reso=reso)
    if layout == "rand":
        lens, ev_read, ev_lo, ev_hi = rand_case(rng)
    elif layout.startswith("dense"):
        lens, ev_read, ev_lo, ev_hi = _dense_case(
            rng, E=int(layout[len("dense"):]), reso=reso)
    else:
        n_reads = int(layout[len("buckets"):])
        lens, ev_read, ev_lo, ev_hi = _bucketed_case(
            rng, n_reads, 8000 if n_reads == 16 else 20000, reso)

    if layout.startswith("dense"):
        # one batch exactly as laid out: rows = reads, E = all events
        bk = bucketing.Bucket(
            read_ids=np.arange(len(lens)), B=len(lens), W=128,
            E=len(ev_read), lens=lens, ev_row=ev_read,
            ev_w0=ev_lo // reso, ev_w1=ev_hi // reso, n_used=len(lens))
        buckets = [bk]
    else:
        buckets = bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, reso)
    got = {}
    for bk in buckets:
        cfg = derive_cfg(bk.B, bk.W, bk.E, params)
        cov, diff = pileup_diff_scatter(
            jnp.asarray(bk.ev_row), jnp.asarray(bk.ev_w0),
            jnp.asarray(bk.ev_w1), cfg)
        cov = np.asarray(cov)
        np.testing.assert_array_equal(np.cumsum(np.asarray(diff), axis=1),
                                      cov)
        for r_local, rid in enumerate(bk.read_ids):
            nw = oracle.n_windows(int(lens[rid]), reso)
            got[rid] = cov[r_local, :nw]
    for r in range(len(lens)):
        m = ev_read == r
        want = oracle.coverage_one_read(int(lens[r]), reso, ev_lo[m],
                                        ev_hi[m])
        np.testing.assert_array_equal(got[r], want, err_msg=f"read {r}")


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("rl,flank", [(500, 100), (50, 0), (200, 5000)])
def test_repeat_scan_matches_oracle(seed, rl, flank):
    rng = np.random.default_rng(100 + seed)
    reso = 50
    params = AlgoParams(est_cov=4, cov_mul=1.5, repeat_length=rl,
                        interval_length=max(rl, 1), read_length=2 * max(rl, 1),
                        flanking_length=flank, reso=reso)
    n, W = 12, 128
    lens = rng.integers(1, W * reso, n).astype(np.int32)
    B = 16
    cov_host = np.zeros((B, W), dtype=np.int32)
    for r in range(n):
        nw = oracle.n_windows(int(lens[r]), reso)
        # blocks of high coverage to create runs, incl. at read ends
        cov_host[r, :nw] = rng.integers(0, 10, nw)
    lens_b = np.zeros(B, dtype=np.int32)
    lens_b[:n] = lens
    cfg = derive_cfg(B, W, 64, params)
    rep_s, rep_e, rep_n, rls = repeat_scan(
        jnp.asarray(cov_host), jnp.asarray(lens_b), cfg)
    rep_s, rep_e, rep_n, rls = map(np.asarray, (rep_s, rep_e, rep_n, rls))
    for r in range(n):
        nw = oracle.n_windows(int(lens[r]), reso)
        want = oracle.repeats_one_read(
            cov_host[r, :nw], int(lens[r]), reso, params.high_cov, rl, flank)
        k = int(rep_n[r])
        assert k <= cfg.K
        got = list(zip(rep_s[r, :k].tolist(), rep_e[r, :k].tolist()))
        assert got == want.intervals, f"read {r}"
        assert int(rls[r]) == want.repeat_length_sum


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("il,l,ov", [(1000, 2000, 200), (1000, 3000, 0),
                                     (500, 4000, 100)])
def test_chop_matches_oracle(seed, il, l, ov):
    rng = np.random.default_rng(200 + seed)
    params = AlgoParams(est_cov=10, interval_length=il, repeat_length=il,
                        read_length=l, overlap_length=ov)
    B = 16
    n = 13
    maxlen = 12000
    lens = np.zeros(B, dtype=np.int32)
    lens[:n] = rng.integers(0, maxlen, n)
    W = -(-maxlen // params.reso)
    cfg = derive_cfg(B, 1 << int(np.ceil(np.log2(W))), 64, params)
    # random repeat slots per read (sorted, possibly overlapping)
    rep_s = np.full((B, cfg.K), 1, dtype=np.int32)
    rep_e = np.zeros((B, cfg.K), dtype=np.int32)
    reps_host = [[] for _ in range(B)]
    for r in range(n):
        kk = int(rng.integers(0, min(cfg.K, 4)))
        ivs = []
        for _ in range(kk):
            s = int(rng.integers(0, max(lens[r], 1)))
            e = int(rng.integers(s, max(lens[r], 1)))
            ivs.append((s, e))
        ivs.sort()
        for j, (s, e) in enumerate(ivs):
            rep_s[r, j] = s
            rep_e[r, j] = e
        reps_host[r] = ivs
    out = chop_markers(jnp.asarray(lens), jnp.asarray(rep_s),
                       jnp.asarray(rep_e), cfg)
    out = {k: np.asarray(v) for k, v in out.items()}
    for r in range(n):
        L = int(lens[r])
        stars = oracle.markers_one_read(L, il)
        finals = oracle.surviving_markers(stars, reps_host[r])
        want = oracle.chop_one_read(L, finals, l, il, ov)
        nf = int(out["n_frag"][r])
        assert nf == len(want), f"read {r}: {nf} != {len(want)}"
        if out["whole"][r]:
            assert len(want) == 1 and want[0].whole
        else:
            for f in range(nf):
                wf = want[f]
                assert not wf.whole
                assert int(out["char_start"][r, f]) == wf.char_start
                assert int(out["char_len"][r, f]) == wf.char_len


@pytest.mark.parametrize("reso,rl,il,l", [
    (50, 10000, 10000, 20000),   # defaults
    (50, 50, 50, 100),           # min_run = 1: densest possible runs
    (1, 1, 1, 2),                # pathological tiny params
    (50, 200, 500, 4000),        # small repeats, many markers
    (100, 150, 1000, 1500),      # rl not a multiple of reso
])
@pytest.mark.parametrize("seed", range(3))
def test_closed_form_slot_bounds(reso, rl, il, l, seed):
    """The device slot counts K (repeat intervals), M (markers) and F
    (fragments) are closed-form bounds derived from W and the params —
    there is deliberately NO spill path (CLAUDE.md invariant). Verify
    with adversarial inputs that the oracle's true per-read counts can
    never exceed them: alternating minimal-run coverage maximizes repeat
    intervals, and a zero-repeat max-length read maximizes markers and
    fragments."""
    rng = np.random.default_rng(300 + seed)
    params = AlgoParams(est_cov=4, cov_mul=1.0, reso=reso, repeat_length=rl,
                        interval_length=il, read_length=l,
                        flanking_length=0, overlap_length=0)
    for W in (8, 64, 256):
        cfg = derive_cfg(8, W, 64, params)
        L = W * reso  # maximal read length for this bucket
        # (a) repeat-interval count: adversarial alternating pattern of
        # minimal qualifying runs separated by single low windows
        min_run = max(1, -(-rl // reso))
        cov = np.zeros(W, dtype=np.int32)
        j = 0
        while j + min_run <= W:
            cov[j:j + min_run] = params.high_cov
            j += min_run + 1
        want = oracle.repeats_one_read(cov, L, reso, params.high_cov, rl, 0)
        assert len(want.intervals) <= cfg.K
        # (b) randomized coverage also respects K
        covr = rng.integers(0, 2 * max(params.high_cov, 1), W).astype(
            np.int32)
        wr = oracle.repeats_one_read(covr, L, reso, params.high_cov, rl, 0)
        assert len(wr.intervals) <= cfg.K
        # (c) markers and fragments at max length with no repeats
        stars = oracle.markers_one_read(L, il)
        assert len(stars) <= cfg.M
        frags = oracle.chop_one_read(L, stars, l, il, 0)
        assert len(frags) <= cfg.F
        # (d) markers/fragments at a non-multiple length (extra end marker)
        L2 = max(1, L - reso // 2 - 1)
        stars2 = oracle.markers_one_read(L2, il)
        assert len(stars2) <= cfg.M
        assert len(oracle.chop_one_read(L2, stars2, l, il, 0)) <= cfg.F


@pytest.mark.parametrize("W,E,want_mode", [
    (64, 64, 16), (128, 64, 16),        # 2k+1 <= 16 bits
    (256, 64, 24), (2048, 128, 24),     # three-byte mode
    (2048, 66, 32),                     # E % 4 != 0 → no 24-bit groups
    (4096, 64, 32), (32768, 64, 32),    # one uint32 per event
    (1 << 16, 64, 0), (1 << 20, 64, 0),  # ultralong → int32 pairs
])
@pytest.mark.parametrize("seed", range(3))
def test_event_pack_roundtrip(W, E, want_mode, seed):
    """The H2D event wire format must round-trip exactly: valid events
    decode to their (w0, w1); invalid/padding events (w1 < w0, the
    bucketing pad sentinel w1 = -1) decode to span 0, i.e. w1 = w0 - 1,
    which the pileup validity test drops."""
    rng = np.random.default_rng(400 + seed)
    assert event_pack_mode(W, E) == want_mode
    cfg = derive_cfg(8, W, E, AlgoParams(est_cov=5))
    assert cfg.ev_pack == want_mode
    w0 = rng.integers(0, W, E).astype(np.int64)
    w1 = np.where(rng.random(E) < 0.25, -1,           # pad sentinel
                  rng.integers(0, W, E)).astype(np.int64)
    pk = pack_events(w0, w1, cfg)
    # wire width: 2/3/4 bytes per event (8 for the pairs fallback)
    assert pk.nbytes == E * {16: 2, 24: 3, 32: 4, 0: 8}[want_mode]
    g0, g1 = (np.asarray(a) for a in unpack_events(jnp.asarray(pk), cfg))
    valid = w1 >= w0
    np.testing.assert_array_equal(g0[valid], w0[valid])
    np.testing.assert_array_equal(g1[valid], w1[valid])
    assert (g1[~valid] < g0[~valid]).all()


@pytest.mark.parametrize("seed", range(4))
def test_rows_from_offsets_matches_ev_row(seed):
    """Device-side row reconstruction from the [B+1] offset table must
    reproduce ev_row exactly — including empty rows (tied offsets), empty
    leading rows, and the padded tail (sentinel B)."""
    rng = np.random.default_rng(100 + seed)
    n_reads = int(rng.integers(1, 40))
    lens = rng.integers(1, 4000, n_reads).astype(np.int32)
    ev_read, ev_lo, ev_hi = [], [], []
    for r in range(n_reads):
        if rng.random() < 0.4:
            continue  # empty row
        for _ in range(rng.integers(1, 8)):
            a = int(rng.integers(0, lens[r]))
            ev_read.append(r); ev_lo.append(a); ev_hi.append(a)
    ev_read = np.asarray(ev_read, dtype=np.int32)
    ev_lo = np.asarray(ev_lo, dtype=np.int32)
    ev_hi = np.asarray(ev_hi, dtype=np.int32)
    for bk in bucketing.make_buckets(lens, ev_read, ev_lo, ev_hi, 50):
        cfg = derive_cfg(bk.B, bk.W, bk.E, AlgoParams(est_cov=5))
        got = np.asarray(rows_from_offsets(jnp.asarray(bk.ev_off), cfg))
        np.testing.assert_array_equal(got, bk.ev_row.astype(np.int32))
