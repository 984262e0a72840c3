"""Multi-device data parallelism over reads.

The problem's only parallel axis is reads (SURVEY.md §2 "Parallelism
strategies"): reads shard round-robin-free — as contiguous row ranges of
each dense bucket — across a 1-D device mesh. Overlap events are routed to
their owner read's shard ON THE HOST (each event touches exactly one
read's coverage), so the device step needs NO collectives: every shard
runs independently, and the global statistics (the reference's global
accumulators, ``repeat.hpp:93-97``) are summed on the host from the
per-read columns, as on one device.

Multi-host would extend this with ``jax.distributed`` + the same
contiguous-range ownership; per-host output shards concatenate in read-id
order so the global fragment numbering (a strict sequential counter,
``chop.hpp:195``) is preserved via an exclusive scan over per-read
fragment counts.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raft_tpu import bucketing
from raft_tpu.engine_jax import StaticCfg, device_step_impl


def make_mesh(n_devices: int | None = None, axis: str = "r",
              local: bool = False) -> Mesh:
    """1-D device mesh. ``local=True`` restricts to this process's devices
    — required in multi-process (jax.distributed) runs where each host
    computes only its own read range (global-mesh outputs would span
    non-addressable devices)."""
    devs = jax.local_devices() if local else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_bucket(bk: bucketing.Bucket, n_shards: int) -> bucketing.Bucket:
    """Re-lay a bucket for ``n_shards`` contiguous row ranges.

    Rows pad to a multiple of n_shards; each shard's events are made
    row-local and padded to a common per-shard slab so ``shard_map`` can
    split every array with ``P('r')``. Read order is unchanged, so global
    fragment numbering survives.
    """
    B_local = -(-bk.B // n_shards)
    B = B_local * n_shards
    lens = np.zeros(B, dtype=np.int32)
    lens[:bk.B] = bk.lens

    valid = bk.ev_row < bk.B
    ev_row = bk.ev_row[valid]
    ev_w0 = bk.ev_w0[valid]
    ev_w1 = bk.ev_w1[valid]
    # events are already laid out in row order by make_buckets
    cuts = np.searchsorted(ev_row, np.arange(0, B + B_local, B_local))
    per = np.diff(cuts)
    E_s = bucketing._next_size(max(int(per.max(initial=1)), 1), lo=64)

    dt = bk.ev_row.dtype
    r = np.full(n_shards * E_s, B_local, dtype=dt)
    w0 = np.zeros(n_shards * E_s, dtype=dt)
    w1 = np.full(n_shards * E_s, -1, dtype=dt)
    # per-shard slab-local offset tables ([B_local+1] each, concatenated)
    off = np.empty(n_shards * (B_local + 1), dtype=np.int32)
    for s in range(n_shards):
        a, b = cuts[s], cuts[s + 1]
        o = s * E_s
        r[o:o + (b - a)] = ev_row[a:b] - s * B_local
        w0[o:o + (b - a)] = ev_w0[a:b]
        w1[o:o + (b - a)] = ev_w1[a:b]
        off[s * (B_local + 1):(s + 1) * (B_local + 1)] = (
            np.searchsorted(ev_row[a:b],
                            np.arange(s * B_local, (s + 1) * B_local + 1))
            .astype(np.int32))

    return bucketing.Bucket(
        read_ids=bk.read_ids, B=B, W=bk.W, E=n_shards * E_s,
        lens=lens, ev_row=r, ev_w0=w0, ev_w1=w1, ev_off=off,
        n_used=bk.n_used)


def stage_sharded(mesh: Mesh, x: np.ndarray) -> jax.Array:
    """H2D-stage a host array split along its leading axis over the mesh:
    each device receives only its own shard, straight from the host (no
    staging of the whole bucket on the first device)."""
    return jax.device_put(x, NamedSharding(mesh, P(mesh.axis_names[0])))


def sharded_device_step(mesh: Mesh):
    """Wrap the device pipeline in shard_map over the read axis.

    cfg must describe PER-SHARD shapes (B_local, E_local); callers go
    through ``compute_jax(..., mesh=...)`` which prepares buckets with
    ``shard_bucket`` and divides cfg dims accordingly.
    """
    axis = mesh.axis_names[0]

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def step(lens, ev_off, ev_pk, *, cfg: StaticCfg):
        def local(l, eo, epk):
            return device_step_impl(l, eo, epk, cfg)

        specs_in = (P(axis), P(axis), P(axis))
        out_specs = {"packed": P(axis)}
        if cfg.cov_out in ("diff8", "cov"):
            out_specs[cfg.cov_out] = P(axis)
        return jax.shard_map(local, mesh=mesh, in_specs=specs_in,
                             out_specs=out_specs)(lens, ev_off, ev_pk)

    return step
