"""Multi-device tests on the 8-virtual-CPU-device mesh: the shard_map
pipeline must equal the single-device engine (and hence the reference)."""

from __future__ import annotations

import numpy as np
import pytest

import jax

import datagen
from raft_tpu.io.fasta import load_reads
from raft_tpu.io.paf import load_paf
from raft_tpu.engine_jax import compute_jax
from raft_tpu.params import AlgoParams
from raft_tpu.parallel.mesh import make_mesh


def _params():
    return AlgoParams(est_cov=10, cov_mul=1.3, repeat_length=2000,
                      interval_length=2000, read_length=4000,
                      flanking_length=300, overlap_length=200)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_matches_single(tmp_path):
    reads_path, paf_path = datagen.standard_case(
        seed=99, tmpdir=str(tmp_path), n_reads=60)
    store = load_reads(reads_path)
    table = load_paf(paf_path, store)
    params = _params().replace(real_reads=store.real_reads,
                               symmetric_overlaps=table.symmetric)

    r1 = compute_jax(store, table, params)
    mesh = make_mesh(8)
    r8 = compute_jax(store, table, params, mesh=mesh)

    assert r1.total_coverage == r8.total_coverage
    assert r1.total_windows == r8.total_windows
    assert r1.total_repeat_length == r8.total_repeat_length
    np.testing.assert_array_equal(r1.ensure_cov(), r8.ensure_cov())
    np.testing.assert_array_equal(r1.rep_s, r8.rep_s)
    np.testing.assert_array_equal(r1.rep_e, r8.rep_e)
    np.testing.assert_array_equal(r1.rep_off, r8.rep_off)
    np.testing.assert_array_equal(r1.frag_read, r8.frag_read)
    np.testing.assert_array_equal(r1.frag_char_start, r8.frag_char_start)
    np.testing.assert_array_equal(r1.frag_char_len, r8.frag_char_len)
    np.testing.assert_array_equal(r1.frag_whole, r8.frag_whole)


def test_sharded_matches_single_smaller_mesh(tmp_path):
    reads_path, paf_path = datagen.standard_case(
        seed=123, tmpdir=str(tmp_path), n_reads=10, symmetric=True)
    store = load_reads(reads_path)
    table = load_paf(paf_path, store)
    params = _params().replace(real_reads=store.real_reads,
                               symmetric_overlaps=table.symmetric)
    r1 = compute_jax(store, table, params)
    mesh = make_mesh(4)
    r4 = compute_jax(store, table, params, mesh=mesh)
    assert r1.total_repeat_length == r4.total_repeat_length
    np.testing.assert_array_equal(r1.ensure_cov(), r4.ensure_cov())
    np.testing.assert_array_equal(r1.frag_char_start, r4.frag_char_start)
    np.testing.assert_array_equal(r1.frag_char_len, r4.frag_char_len)


def test_sharded_int8_overflow_host_rebuild():
    """Rows whose diff exceeds int8 are rebuilt on host from shard-local
    event slabs: the global-row remap must be exact under shard_map."""
    from raft_tpu.io.paf import OverlapTable
    from raft_tpu.io.fasta import ReadStore

    lens = np.asarray([5000] * 16, dtype=np.int32)
    off = np.zeros(17, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    store = ReadStore(names=[f"r{i}" for i in range(16)],
                      seq_blob=b"A" * int(lens.sum()), seq_off=off,
                      lens=lens, real_reads=True)
    rows = []
    for r in (3, 9, 14):  # overflow rows spread across shards
        rows += [(r, 100, 4000, (r + 1) % 16, 0, 3900)] * 200
    rows += [(i, 10, 2000, (i + 2) % 16, 5, 1995) for i in range(16)]
    a_id, a_s, a_e, b_id, b_s, b_e = map(
        lambda x: np.asarray(x, dtype=np.int32), zip(*rows))
    table = OverlapTable(a_id=a_id, b_id=b_id, a_start=a_s, a_end=a_e,
                         b_start=b_s, b_end=b_e, symmetric=True,
                         n_names=16)
    params = _params()
    r1 = compute_jax(store, table, params, cov_out="diff8")
    r8 = compute_jax(store, table, params, mesh=make_mesh(8),
                     cov_out="diff8")
    rh = compute_jax(store, table, params, mesh=make_mesh(8),
                     cov_out="host")
    np.testing.assert_array_equal(r1.ensure_cov(), r8.ensure_cov())
    np.testing.assert_array_equal(r1.frag_char_start, r8.frag_char_start)
    np.testing.assert_array_equal(r1.ensure_cov(), rh.ensure_cov())
    assert r1.ensure_cov().max() >= 200


def test_sharded_ultralong_pairs_tier():
    """Megabase reads put the bucket past W=32768 where events ship as
    (w0, span) int32 PAIRS (engine_jax.event_pack_mode -> 0): that wire
    format must also be exact through the mesh (the 16/24-bit tiers ride
    the multichip dryrun; this is the remaining decode path)."""
    from raft_tpu.io.fasta import ReadStore
    from raft_tpu.io.paf import OverlapTable
    from raft_tpu.engine_jax import derive_cfg

    rng = np.random.default_rng(7)
    lens = np.asarray([2_500_000, 2_200_000, 2_000_000, 40_000,
                       30_000, 20_000, 10_000, 5_000], dtype=np.int32)
    off = np.zeros(9, dtype=np.int64)
    np.cumsum(lens.astype(np.int64), out=off[1:])
    store = ReadStore(names=[f"u{i}" for i in range(8)],
                      seq_blob=b"A" * int(lens.sum()), seq_off=off,
                      lens=lens, real_reads=True)
    rows = []
    for _ in range(400):
        a = int(rng.integers(0, 8))
        b = int(rng.integers(0, 8))
        qs = int(rng.integers(0, lens[a]))
        qe = int(rng.integers(qs + 1, lens[a] + 1))
        ts = int(rng.integers(0, lens[b]))
        te = int(rng.integers(ts + 1, lens[b] + 1))
        rows.append((a, qs, qe, b, ts, te))
    # qualifying repeat run deep inside an ultralong read
    rows += [(0, 1_500_000, 1_540_000, 1, 0, 40_000)] * 30
    a_id, a_s, a_e, b_id, b_s, b_e = map(
        lambda x: np.asarray(x, dtype=np.int32), zip(*rows))
    table = OverlapTable(a_id=a_id, b_id=b_id, a_start=a_s, a_end=a_e,
                         b_start=b_s, b_end=b_e, symmetric=False,
                         n_names=8)
    params = AlgoParams(est_cov=5, cov_mul=1.2, repeat_length=10000,
                        interval_length=10000, read_length=20000,
                        overlap_length=500, flanking_length=1000)
    # the ultralong tier really is the pairs wire format
    assert derive_cfg(8, 65536, 1024, params).ev_pack == 0

    r1 = compute_jax(store, table, params)
    r8 = compute_jax(store, table, params, mesh=make_mesh(8))
    assert r1.total_repeat_length == r8.total_repeat_length
    np.testing.assert_array_equal(r1.ensure_cov(), r8.ensure_cov())
    np.testing.assert_array_equal(r1.rep_s, r8.rep_s)
    np.testing.assert_array_equal(r1.rep_e, r8.rep_e)
    np.testing.assert_array_equal(r1.frag_char_start, r8.frag_char_start)
    np.testing.assert_array_equal(r1.frag_char_len, r8.frag_char_len)


def _graft_entry():
    import importlib
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    return importlib.import_module("__graft_entry__")


def test_dryrun_multichip_too_few_devices_raises():
    """The multi-device entry never switches platform behind the caller's
    back: asking for more devices than the backend has is an error."""
    with pytest.raises(RuntimeError, match="need 16 devices, have 8"):
        _graft_entry().dryrun_multichip(16)


def test_dryrun_multichip_runs_on_4():
    _graft_entry().dryrun_multichip(4)


def test_stage_sharded_places_each_shard():
    """Sharded staging puts shard i (a contiguous row range) on mesh
    device i, straight from the host array."""
    from raft_tpu.parallel.mesh import stage_sharded
    mesh = make_mesh(4)
    x = np.arange(4 * 6, dtype=np.int32)
    a = stage_sharded(mesh, x)
    np.testing.assert_array_equal(np.asarray(a), x)
    shards = sorted(a.addressable_shards, key=lambda s: s.index[0].start)
    assert [s.device for s in shards] == list(mesh.devices)
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(np.asarray(s.data), x[6 * i:6 * i + 6])
