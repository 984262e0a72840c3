"""Engine-level tests: ComputeResult equivalence between engines, and the
int8 diff-transfer overflow fallback."""

from __future__ import annotations

import os

import numpy as np
import pytest

from raft_tpu.engine_jax import compute_jax
from raft_tpu.io.fasta import ReadStore
from raft_tpu.io.paf import OverlapTable
from raft_tpu.params import AlgoParams
from raft_tpu.pipeline import compute_oracle
from raft_tpu.result import from_per_read_lists


def _mk_store(lens):
    blob = b"A" * int(np.sum(lens))
    off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    return ReadStore(
        names=[f"r{i}" for i in range(len(lens))],
        seq_blob=blob, seq_off=off,
        lens=np.asarray(lens, dtype=np.int32), real_reads=True)


def _mk_table(rows):
    a_id, a_s, a_e, b_id, b_s, b_e = map(
        lambda x: np.asarray(x, dtype=np.int32), zip(*rows))
    return OverlapTable(a_id=a_id, b_id=b_id, a_start=a_s, a_end=a_e,
                       b_start=b_s, b_end=b_e, symmetric=True,
                       n_names=int(a_id.max()) + 1)


def _assert_equal(res_a, res_b):
    np.testing.assert_array_equal(res_a.ensure_cov(), res_b.ensure_cov())
    np.testing.assert_array_equal(res_a.cov_off, res_b.cov_off)
    np.testing.assert_array_equal(res_a.rep_s, res_b.rep_s)
    np.testing.assert_array_equal(res_a.rep_e, res_b.rep_e)
    np.testing.assert_array_equal(res_a.frag_read, res_b.frag_read)
    np.testing.assert_array_equal(res_a.frag_char_start,
                                  res_b.frag_char_start)
    np.testing.assert_array_equal(res_a.frag_char_len, res_b.frag_char_len)
    assert res_a.total_coverage == res_b.total_coverage
    assert res_a.total_repeat_length == res_b.total_repeat_length


def test_int8_overflow_fallback():
    """>127 intervals starting on the same window forces the int32 refetch
    path; results must stay exact."""
    lens = [5000, 3000]
    rows = [(0, 100, 4000, 1, 0, 3900)] * 200 + [(1, 10, 2900, 0, 5, 2895)]
    store = _mk_store(lens)
    table = _mk_table(rows)
    params = AlgoParams(est_cov=10, repeat_length=1000, interval_length=1000,
                        read_length=2000)
    res = compute_jax(store, table, params, cov_out="diff8")
    # oracle comparison
    cov, reps, frags, st = compute_oracle(store, table, params)
    want = from_per_read_lists(2, cov, reps, frags, st)
    _assert_equal(res, want)
    # sanity: the engineered pileup really exceeded int8
    assert res.ensure_cov().max() >= 200


def test_engines_equal_random():
    rng = np.random.default_rng(5)
    lens = rng.integers(100, 20000, 50)
    rows = []
    for _ in range(400):
        a = int(rng.integers(0, 50))
        b = int(rng.integers(0, 50))
        qs = int(rng.integers(0, lens[a]))
        qe = int(rng.integers(qs + 1, lens[a] + 1))
        ts = int(rng.integers(0, lens[b]))
        te = int(rng.integers(ts + 1, lens[b] + 1))
        rows.append((a, qs, qe, b, ts, te))
    store = _mk_store(lens)
    table = _mk_table(rows)
    table.symmetric = False
    params = AlgoParams(est_cov=3, cov_mul=1.2, repeat_length=500,
                        interval_length=500, read_length=1500,
                        flanking_length=120, overlap_length=60)
    res = compute_jax(store, table, params)
    cov, reps, frags, st = compute_oracle(store, table, params)
    want = from_per_read_lists(store.n_reads, cov, reps, frags, st)
    _assert_equal(res, want)


def test_cov_out_modes_equal():
    """The three coverage return modes (host recompute, int8 diff, full
    int32 matrix) must produce identical ComputeResults."""
    rng = np.random.default_rng(17)
    lens = rng.integers(100, 30000, 64)
    rows = []
    for _ in range(600):
        a = int(rng.integers(0, 64))
        b = int(rng.integers(0, 64))
        qs = int(rng.integers(0, lens[a]))
        qe = int(rng.integers(qs + 1, lens[a] + 1))
        ts = int(rng.integers(0, lens[b]))
        te = int(rng.integers(ts + 1, lens[b] + 1))
        rows.append((a, qs, qe, b, ts, te))
    store = _mk_store(lens)
    table = _mk_table(rows)
    table.symmetric = False
    params = AlgoParams(est_cov=4, cov_mul=1.2, repeat_length=800,
                        interval_length=800, read_length=2000,
                        flanking_length=100, overlap_length=50)
    res_host = compute_jax(store, table, params, cov_out="host")
    res_diff8 = compute_jax(store, table, params, cov_out="diff8")
    res_cov = compute_jax(store, table, params, cov_out="cov")
    _assert_equal(res_host, res_diff8)
    _assert_equal(res_host, res_cov)


def test_bucket_area_cap():
    """Large-W tiers take proportionally fewer rows per bucket so device
    arrays stay bounded (~max_cells cells) for ultralong reads."""
    from raft_tpu import bucketing
    rng = np.random.default_rng(9)
    lens = np.full(600, 2_500_000, dtype=np.int64)  # W tier 65536 @ reso 50
    ev = np.empty(0, dtype=np.int32)
    buckets = bucketing.make_buckets(lens.astype(np.int32), ev, ev, ev, 50)
    assert all(b.W == 65536 for b in buckets)
    assert all(b.B * b.W <= (1 << 23) for b in buckets)  # default max_cells
    assert sum(b.n_used for b in buckets) == 600
    # short reads keep wide batches
    lens2 = np.full(600, 20_000, dtype=np.int32)
    b2 = bucketing.make_buckets(lens2, ev, ev, ev, 50)
    assert sum(b.n_used for b in b2) == 600
    assert max(b.B for b in b2) >= 600


def test_ultralong_reads_end_to_end():
    """Megabase reads (ultralong ONT scale) through the device engine:
    results must match the oracle exactly with the area-capped tiles."""
    rng = np.random.default_rng(11)
    lens = [2_500_000, 2_100_000, 20_000, 500]
    rows = []
    for _ in range(300):
        a = int(rng.integers(0, 4))
        b = int(rng.integers(0, 4))
        qs = int(rng.integers(0, lens[a]))
        qe = int(rng.integers(qs + 1, lens[a] + 1))
        ts = int(rng.integers(0, lens[b]))
        te = int(rng.integers(ts + 1, lens[b] + 1))
        rows.append((a, qs, qe, b, ts, te))
    # a qualifying repeat run deep inside the first ultralong read
    rows += [(0, 1_000_000, 1_040_000, 1, 0, 40_000)] * 40
    store = _mk_store(lens)
    table = _mk_table(rows)
    table.symmetric = False
    params = AlgoParams(est_cov=5, cov_mul=1.2, repeat_length=10000,
                        interval_length=10000, read_length=20000,
                        overlap_length=500, flanking_length=1000)
    res = compute_jax(store, table, params)
    cov, reps, frags, st = compute_oracle(store, table, params)
    want = from_per_read_lists(4, cov, reps, frags, st)
    _assert_equal(res, want)
    assert res.total_read_length == sum(lens)


_CACHE_PROBE = """
import os, sys, jax, jax.numpy as jnp
from raft_tpu import engine_jax
jax.jit(lambda x: x * {k} + 1)(jnp.arange(7)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is where the cache lands (and
    no directory is set over it in code); unset, the cache lands in the
    one fixed directory inside the checkout."""
    import subprocess
    import sys
    import uuid
    from raft_tpu.engine_jax import DEFAULT_CACHE_DIR

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert DEFAULT_CACHE_DIR == os.path.join(root, ".jax_cache")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = root
    want = str(tmp_path / "cache") if env_set else DEFAULT_CACHE_DIR
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    before = set(os.listdir(want)) if os.path.isdir(want) else set()
    k = uuid.uuid4().int % 100003 + 2  # a fresh executable, a new entry
    res = subprocess.run([sys.executable, "-c", _CACHE_PROBE.format(k=k)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == want
    assert set(os.listdir(want)) - before, "no cache entry written"
