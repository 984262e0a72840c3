#!/usr/bin/env python
"""RAFT headline benchmark.

Runs the full end-to-end pipeline (parse → device compute → emit) on a
synthetic workload matching the surveyed baseline (BASELINE.md row 3
scaled up: N reads / ~23.6 kb mean / 30 PAF rows per read) on the
default JAX device, and compares reads/s against the reference binary
run live on the same machine (falling back to the surveyed 2,600 reads/s
single-thread figure if g++ is unavailable).

Noise control: the workdir is tmpfs when available, and reference/ours
timings are INTERLEAVED over several rounds (min of each) so machine
drift hits both sides equally. The JSON carries the full per-round time
arrays (ours/ref/ref-parallel), round count, the workdir kind, and the
device (JAX platform and kind, plus the card's name and power limit from
nvidia-smi when there is one).

Prints ONE JSON line:
  {"metric": "reads_per_s", "value": N, "unit": "reads/s", "vs_baseline": R}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BASELINE_READS_PER_S = 2600.0  # measured: reference, 1 thread, BASELINE.md
REF_DIR = "/root/reference"
WORK = os.environ.get(
    "RAFT_BENCH_DIR",
    "/dev/shm/raft_bench" if os.path.isdir("/dev/shm") else "/tmp/raft_bench")
N_READS = int(os.environ.get("RAFT_BENCH_READS", "32000"))
ROUNDS = int(os.environ.get("RAFT_BENCH_ROUNDS", "6"))
ARGS = ["-e", "20", "-m", "1.5", "-p", "10000", "-l", "20000",
        "-f", "1000", "-v", "500"]


def build_reference() -> str | None:
    from raft_tpu.tools.refbuild import build_reference as _build
    return _build(WORK)


def run_reference_once(ref_bin: str, reads: str, paf: str) -> float:
    t0 = time.perf_counter()
    res = subprocess.run(
        [ref_bin] + ARGS + ["-o", os.path.join(WORK, "refout"), reads, paf],
        capture_output=True, timeout=3600)
    dt = time.perf_counter() - t0
    return dt if res.returncode == 0 else float("nan")


def run_reference_parallel(ref_bin: str, reads: str, paf: str) -> float:
    """Thread-scaled reference baseline (BASELINE.md:17-21 'record both'):
    nproc reference processes on pre-sharded input, wall time for ALL.
    Sharding splits reads into nproc contiguous id ranges and gives each
    process only the PAF rows touching its range (the same per-host split
    run_distributed uses) — the honest way to parallelize a
    single-threaded tool."""
    n_proc = os.cpu_count() or 1
    if n_proc <= 1:
        return float("nan")
    import numpy as np
    shard_dir = os.path.join(WORK, "refpar")
    marker = os.path.join(shard_dir, f"ready{N_READS}_{n_proc}_v2")
    if not os.path.exists(marker):
        os.makedirs(shard_dir, exist_ok=True)
        from raft_tpu.io.fasta import load_reads
        from raft_tpu.io.paf import load_paf
        from raft_tpu.parallel.distributed import bin_ranges
        store = load_reads(reads)
        table = load_paf(paf, store)
        n = store.n_reads
        _, ranges = bin_ranges(n, n_proc)
        a = np.asarray(table.a_id, dtype=np.int64)
        b = np.asarray(table.b_id, dtype=np.int64)
        with open(paf, "rb") as f:
            lines = f.readlines()
        if len(lines) != table.n_rows:
            return float("nan")  # parser skipped rows; mapping unsafe
        for h, (lo, hi) in enumerate(ranges):
            # every row touching the shard's range, plus HALO reads (the
            # row's other endpoint) in the FASTA — the reference writes
            # out of bounds on names absent from its read store
            # (chop.hpp:162-168 overrun), so a faithful parallel run must
            # carry the partner reads and redo cross-shard rows. That
            # duplicated work is the honest cost of parallelizing the
            # unmodified single-threaded tool.
            mask = ((a >= lo) & (a < hi)) | ((b >= lo) & (b < hi))
            idx = np.nonzero(mask)[0]
            with open(os.path.join(shard_dir, f"ovl{h}.paf"), "wb") as f:
                f.writelines([lines[i] for i in idx])
            ids = np.unique(np.concatenate(
                [np.arange(lo, hi, dtype=np.int64), a[idx], b[idx]]))
            ids = ids[(ids >= 0) & (ids < n)]
            with open(os.path.join(shard_dir, f"reads{h}.fa"), "wb") as f:
                for i in ids:
                    s = store.seq(int(i))
                    s = s if isinstance(s, bytes) else bytes(s)
                    f.write(b">" + store.names[int(i)].encode() + b"\n"
                            + s + b"\n")
        del lines, store, table
        open(marker, "w").close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [ref_bin] + ARGS + ["-o", os.path.join(shard_dir, f"out{h}"),
                            os.path.join(shard_dir, f"reads{h}.fa"),
                            os.path.join(shard_dir, f"ovl{h}.paf")],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for h in range(n_proc)]
    ok = all(p.wait(timeout=3600) == 0 for p in procs)
    dt = time.perf_counter() - t0
    return dt if ok else float("nan")


_BEST = {"ours": float("inf"), "ref": float("inf"),
         "ref_par": float("nan"), "cpu_backend": float("nan"),
         # per-round wall arrays (drift forensics): warm-up excluded from
         # ours_rounds (it carries the compiles)
         "warmup_s": float("nan"), "ours_rounds": [], "ref_rounds": [],
         "ref_par_rounds": []}


def run_cpu_backend(reads: str, paf: str) -> float:
    """Device-vs-own-CPU ablation: the identical pipeline on the host CPU
    jax backend, in a subprocess held to the CPU (JAX_PLATFORMS=cpu) so
    it never opens the card beside the parent. Returns min wall seconds
    (NaN on failure)."""
    try:
        res = subprocess.run(
            [sys.executable, "-m", "raft_tpu.tools.bench_cpu",
             reads, paf, os.path.join(WORK, "ours_cpu"), "2"],
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
            capture_output=True, timeout=900, text=True)
        if res.returncode == 0:
            return float(res.stdout.strip().splitlines()[-1])
        print(f"bench: cpu ablation failed: {res.stderr[-500:]}",
              file=sys.stderr)
    except Exception as e:
        print(f"bench: cpu ablation failed: {e}", file=sys.stderr)
    return float("nan")


def _emit_json(ours_best: float, ref_reads_per_s: float,
               deadline: bool = False) -> None:
    reads_per_s = N_READS / ours_best if ours_best > 0 else 0.0
    out = {
        "metric": "reads_per_s",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        # headline ratio: vs the live 1-thread reference (the reference
        # IS single-threaded; see vs_parallel_ref for the thread-scaled
        # comparison BASELINE.md asks to record alongside it)
        "vs_baseline": round(reads_per_s / ref_reads_per_s, 3),
    }
    rp = _BEST["ref_par"]
    if rp == rp and rp > 0:  # not NaN
        out["parallel_ref_reads_per_s"] = round(N_READS / rp, 1)
        if N_READS / rp > ref_reads_per_s:
            out["vs_parallel_ref"] = round(reads_per_s / (N_READS / rp), 3)
        else:
            # sharding the unmodified reference LOST to one thread on
            # this run (halo duplication and/or machine noise) — the
            # meaningful scaled baseline is then the ideal bound below
            out["parallel_ref_slower_than_1t"] = True
    # the most conservative scaled baseline: PERFECT linear core scaling
    # of the single-thread figure (real sharding does worse — cross-shard
    # halo duplication) — report the ratio against it
    n_proc = os.cpu_count() or 1
    out["vs_ideal_scaled_ref"] = round(
        reads_per_s / (ref_reads_per_s * n_proc), 3)
    cpu_s = _BEST["cpu_backend"]
    if cpu_s == cpu_s and cpu_s > 0:  # not NaN
        out["cpu_backend_reads_per_s"] = round(N_READS / cpu_s, 1)
        if ours_best > 0:
            out["gpu_vs_cpu_backend"] = round(cpu_s / ours_best, 3)
    if deadline:
        out["deadline"] = True  # warm-up-only timing
    # drift forensics: full per-round arrays + environment, so the next
    # round can separate VM steal from regression without rerunning
    out["rounds"] = len(_BEST["ours_rounds"])
    out["ours_rounds_s"] = [round(t, 3) for t in _BEST["ours_rounds"]]
    out["ref_rounds_s"] = [round(t, 3) for t in _BEST["ref_rounds"]]
    if _BEST["ref_par_rounds"]:
        out["ref_par_rounds_s"] = [round(t, 3)
                                   for t in _BEST["ref_par_rounds"]]
    w = _BEST["warmup_s"]
    if w == w:
        out["warmup_s"] = round(w, 3)
    out["workdir"] = "tmpfs" if WORK.startswith("/dev/shm") else "disk"
    out["n_reads"] = N_READS
    out["device"] = _device_info()
    print(json.dumps(out), flush=True)


def _device_info() -> dict:
    """JAX's view of the device, plus the card's name and power limit
    (a card set below its maximum power runs slower under load)."""
    import jax
    d = jax.devices()[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        if res.returncode == 0:
            info["nvidia_smi"] = res.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def _alarm(signum, frame):
    """Hard deadline: report the best end-to-end timing observed so far —
    the warm-up run counts, pessimistically, as it includes the compiles
    — so the caller always gets its JSON line."""
    ours = _BEST["ours"]
    ref = _BEST["ref"]
    ref_rps = (N_READS / ref) if ref == ref and ref != float("inf") \
        else BASELINE_READS_PER_S
    print(f"bench: HARD DEADLINE hit; reporting best-so-far "
          f"(ours {ours:.1f}s)", file=sys.stderr)
    _emit_json(ours if ours != float("inf") else 0.0, ref_rps,
               deadline=True)
    os._exit(0)


def main() -> None:
    import signal
    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(int(os.environ.get("RAFT_BENCH_HARD_S", "1200")))
    os.makedirs(WORK, exist_ok=True)
    from raft_tpu.tools.benchgen import gen_dataset
    reads, paf = gen_dataset(os.path.join(WORK, f"data{N_READS}"),
                             n_reads=N_READS,
                             n_overlaps=N_READS * 30, est_cov=20)

    from raft_tpu.params import AlgoParams
    from raft_tpu.pipeline import run_pipeline

    params = AlgoParams(est_cov=20, outputfilename=os.path.join(WORK, "ours"))
    # warm-up: compiles every bucket shape (persistent-cached across
    # runs); timed so a hard deadline still has an honest (pessimistic)
    # end-to-end number
    t0 = time.perf_counter()
    st = run_pipeline(reads, paf, params, engine="jax", verbose=False)
    _BEST["ours"] = time.perf_counter() - t0
    _BEST["warmup_s"] = _BEST["ours"]

    ref_bin = build_reference()
    ref_best = float("inf")
    ours_best = float("inf")
    best_stages = dict(st.stage_seconds)
    budget = float(os.environ.get("RAFT_BENCH_BUDGET_S", "180"))
    t_rounds = time.perf_counter()
    for rnd in range(ROUNDS):
        if ref_bin:
            ref_dt = run_reference_once(ref_bin, reads, paf)
            if ref_dt == ref_dt:
                _BEST["ref_rounds"].append(ref_dt)
            ref_best = min(ref_best, ref_dt)
            _BEST["ref"] = ref_best
        t0 = time.perf_counter()
        st = run_pipeline(reads, paf, params, engine="jax", verbose=False)
        dt = time.perf_counter() - t0
        _BEST["ours_rounds"].append(dt)
        if dt < ours_best:
            ours_best = dt
            best_stages = dict(st.stage_seconds)
        _BEST["ours"] = min(_BEST["ours"], ours_best)
        # always complete at least one round; stop when over budget so the
        # caller gets its JSON line in bounded time
        if time.perf_counter() - t_rounds > budget:
            break

    # device-vs-own-CPU ablation (subprocess on the host CPU jax backend)
    if os.environ.get("RAFT_BENCH_CPU_ABLATION", "1") != "0":
        _BEST["cpu_backend"] = run_cpu_backend(reads, paf)

    # thread-scaled reference baseline (nproc processes, sharded input) —
    # the second baseline BASELINE.md demands; one interleaved run
    if ref_bin and os.environ.get("RAFT_BENCH_PARALLEL_REF", "1") != "0":
        try:
            # best-of-2: single runs swing with VM CPU steal
            r1 = run_reference_parallel(ref_bin, reads, paf)
            r2 = run_reference_parallel(ref_bin, reads, paf)
            _BEST["ref_par_rounds"] = [x for x in (r1, r2) if x == x]
            _BEST["ref_par"] = min(x for x in (r1, r2) if x == x) \
                if (r1 == r1 or r2 == r2) else float("nan")
        except Exception as e:
            print(f"bench: parallel-ref baseline failed: {e}",
                  file=sys.stderr)

    if ref_bin and ref_best == ref_best and ref_best != float("inf"):
        ref_reads_per_s = N_READS / ref_best
    else:
        ref_reads_per_s = BASELINE_READS_PER_S

    signal.alarm(0)  # single JSON line: never race the deadline handler
    # the warm-up timing counts as a (pessimistic) round
    ours_best = min(ours_best, _BEST["ours"])
    print("bench stages (best run): "
          + ", ".join(f"{k}={v:.3f}s" for k, v in best_stages.items()),
          file=sys.stderr)
    rp = _BEST["ref_par"]
    print(f"bench: ours {ours_best:.3f}s, reference(1t) {ref_best:.3f}s, "
          f"reference({os.cpu_count()}proc) {rp:.3f}s on "
          f"{N_READS} reads ({ref_reads_per_s:.0f} ref reads/s)",
          file=sys.stderr)
    _emit_json(ours_best, ref_reads_per_s)


if __name__ == "__main__":
    main()
