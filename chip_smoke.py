#!/usr/bin/env python3
"""Bring-up smoke run of the RAFT pipeline on an NVIDIA GPU.

    python chip_smoke.py                  # one card, the main path
    python chip_smoke.py --four-cards     # the multi-card paths only

One card (the default) runs, in order, and fails on the first error:

1. environment: the card's name and power limit (nvidia-smi), the JAX
   version and devices, the compile-cache directory in use, and whether
   the native I/O library built (its ``make`` error stops the run);
2. dataset: a simulated 100 Mbp genome at 30x
   (``raft_tpu.tools.simulate``, fixed seed): ~157 k reads of ~19 kb, an
   all-vs-all PAF of ~4.5 M rows, ~3 GB of FASTA — above the 2 GB
   auto-stream threshold, so the default invocation streams;
3. the plain reference: ``--engine oracle`` (scalar numpy on the CPU,
   whole-file, no device code);
4. GPU runs, each a fresh ``python -m raft_tpu.cli -e 30`` process:
   (a) the default invocation with an empty compile cache, (b) the same
   again with the cache warm, (c) ``--chunk-reads 0`` (whole-file). Each
   prints its wall time, ``--profile`` stage split and compile count, and
   all four outputs plus the stdout report lines are byte-compared with
   the oracle's;
5. the last line: ``{"ok": true, "device": {...}}`` as JAX reports it.

``--four-cards`` runs only the multi-card paths on the same dataset — the
CLI with ``--devices 4`` and ``run_distributed`` as four processes, one
card each — and byte-compares each with a one-card run and the oracle.

This process never imports JAX: every device user is a child process, and
only one runs at a time, so each child has the card to itself. Without a
GPU (or outside a checkout of this repository) it exits non-zero and
prints no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
OUTPUTS = (".reads.fasta", ".coverage.txt", ".long_repeats.txt",
           ".long_repeats.bed")
CLI_ARGS = ["-e", "30"]
SEED = 20
# stdout lines that legitimately differ between two runs of one input
VOLATILE = ("INFO, main(), program completed after",
            "INFO, main(), CMD:", "PROFILE, ")

_PROBE = r"""
import json, jax
import raft_tpu.engine_jax  # sets the compile cache as the program does
ds = jax.devices()
print(json.dumps({"platform": ds[0].platform, "kind": ds[0].device_kind,
                  "count": len(ds), "jax": jax.__version__,
                  "devices": str(ds),
                  "cache_dir": jax.config.jax_compilation_cache_dir}))
"""

_DIST_WORKER = r"""
import sys
from raft_tpu.params import AlgoParams
from raft_tpu.parallel.distributed import run_distributed
coord, n, pid, reads, paf, prefix = sys.argv[1:7]
run_distributed(reads, paf, AlgoParams(est_cov=30, outputfilename=prefix),
                coordinator=coord, num_processes=int(n),
                process_id=int(pid), local_device_ids=[int(pid)])
"""


class SmokeError(RuntimeError):
    pass


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def _run(cmd, timeout, env=None, stdout=None, stderr=None):
    """Run one child to its end (killed at its timeout)."""
    try:
        return subprocess.run(cmd, cwd=ROOT, env=env or _env(),
                              stdout=stdout, stderr=stderr,
                              timeout=timeout, text=True)
    except subprocess.TimeoutExpired as e:
        raise SmokeError(f"{cmd[:4]} timed out after {timeout} s") from e


def first_difference(path_a: str, path_b: str) -> int | None:
    """Offset of the first byte at which two files differ (a length
    difference counts at the shorter length), or None when equal."""
    off = 0
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        while True:
            a = fa.read(1 << 24)
            b = fb.read(1 << 24)
            if a != b:
                n = min(len(a), len(b))
                i = next((k for k in range(n) if a[k] != b[k]), n)
                return off + i
            if not a:
                return None
            off += len(a)


def compare_outputs(prefix_a: str, prefix_b: str) -> list[str]:
    """Byte-compare the four RAFT outputs of two runs; one message per
    differing (or missing) file, empty when all four are identical."""
    bad = []
    for ext in OUTPUTS:
        a, b = prefix_a + ext, prefix_b + ext
        if not (os.path.exists(a) and os.path.exists(b)):
            bad.append(f"{ext}: missing")
            continue
        d = first_difference(a, b)
        if d is not None:
            bad.append(f"{ext}: first difference at byte {d}")
    return bad


def report_lines(stdout: str) -> list[str]:
    """The run's stdout report without the lines that vary run to run
    (timer, echoed command line, profile)."""
    return [ln for ln in stdout.splitlines() if not ln.startswith(VOLATILE)]


def _cache_entries(cache_dir: str) -> int:
    try:
        return len(os.listdir(cache_dir))
    except OSError:
        return 0


def environment() -> dict:
    """Phase 1. Returns the device as JAX reports it."""
    if not os.path.isdir(os.path.join(ROOT, "raft_tpu")):
        raise SmokeError(f"no raft_tpu package beside {__file__}")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise SmokeError(f"nvidia-smi unavailable: {e}") from e
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeError(f"nvidia-smi found no GPU: {smi.stderr.strip()}")
    for ln in smi.stdout.strip().splitlines():
        print(f"card: {ln.strip()}", flush=True)

    res = _run([sys.executable, "-c", _PROBE], 300,
               stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if res.returncode != 0:
        raise SmokeError(f"JAX device probe failed: {res.stderr[-2000:]}")
    dev = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"jax {dev['jax']}: {dev['devices']}", flush=True)
    print(f"compile cache: {dev['cache_dir']}", flush=True)
    if dev["platform"] != "gpu":
        raise SmokeError(f"JAX default backend is {dev['platform']!r}, "
                         "not a GPU")

    mk = _run(["make", "-C", os.path.join(ROOT, "raft_tpu", "_native"),
               "-s"], 600, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if mk.returncode != 0:
        raise SmokeError(f"native I/O library did not build:\n{mk.stdout}")
    sys.path.insert(0, ROOT)
    from raft_tpu.io import native
    if native._get_lib() is None:
        raise SmokeError("native I/O library built but did not load")
    if "jax" in sys.modules:
        raise SmokeError("the parent imported JAX; it must stay off the card")
    print("native I/O library: loaded", flush=True)
    return dev


def dataset(genome_size: int) -> tuple[str, str]:
    """Phase 2: simulate the genome, reads and all-vs-all PAF."""
    os.makedirs(WORK, exist_ok=True)
    out = os.path.join(WORK, f"sim{genome_size}")
    reads, paf = out + ".reads.fasta", out + ".overlaps.paf"
    if genome_size != 100_000_000:
        print(f"dataset: genome cut to {genome_size} bp (read-length and "
              "coverage shape unchanged)", flush=True)
    t0 = time.perf_counter()
    res = _run([sys.executable, "-m", "raft_tpu.tools.simulate",
                "--genome-size", str(genome_size), "--coverage", "30",
                "--seed", str(SEED), "--out", out], 900,
               stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise SmokeError(f"simulate failed:\n{res.stdout[-2000:]}")
    print(f"dataset: {res.stdout.strip().splitlines()[-1]}", flush=True)
    print(f"dataset: {genome_size} bp at 30x, seed {SEED}, "
          f"{os.path.getsize(reads)} FASTA bytes, {os.path.getsize(paf)} "
          f"PAF bytes, generated in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return reads, paf


def cli_run(tag: str, reads: str, paf: str, extra: list[str],
            cache_dir: str, timeout: int = 600) -> dict:
    """One ``python -m raft_tpu.cli`` process; prints its wall, stage
    split and compile count. Returns its prefix, report and stats."""
    d = os.path.join(WORK, tag)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    prefix = os.path.join(d, "out")
    stats_path = os.path.join(d, "stats.json")
    env = _env()
    env["JAX_LOG_COMPILES"] = "1"
    before = _cache_entries(cache_dir)
    print(f"run {tag}: starting", flush=True)
    t0 = time.perf_counter()
    res = _run([sys.executable, "-m", "raft_tpu.cli"] + CLI_ARGS + extra
               + ["--profile", "--stats-json", stats_path, "-o", prefix,
                  reads, paf], timeout, env=env,
               stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise SmokeError(f"run {tag} failed (rc {res.returncode}):\n"
                         f"{res.stderr[-3000:]}")
    if "native I/O library unavailable" in res.stderr:
        raise SmokeError(f"run {tag} fell back to pure-Python I/O")
    with open(stats_path) as f:
        stats = json.load(f)
    finished = res.stderr.count("Finished XLA compilation")
    hits = res.stderr.count("Persistent compilation cache hit")
    print(f"run {tag}: {' '.join(extra) or '(default)'}: wall "
          f"{wall:.3f} s, {stats['n_reads']} reads, {stats['n_paf_rows']} "
          f"PAF rows, {stats['n_fragments']} fragments", flush=True)
    print(f"run {tag}: stages_s "
          + json.dumps({k: round(v, 4)
                        for k, v in stats["stage_seconds"].items()}),
          flush=True)
    print(f"run {tag}: compiles {finished - hits} (executables loaded "
          f"from cache {hits}; cache entries {before} -> "
          f"{_cache_entries(cache_dir)})", flush=True)
    return {"prefix": prefix, "report": report_lines(res.stdout),
            "stats": stats, "wall": wall}


def check_same(tag: str, run: dict, ref: dict, ref_name: str) -> None:
    bad = compare_outputs(run["prefix"], ref["prefix"])
    if run["report"] is not None and run["report"] != ref["report"]:
        bad.append("stdout report lines differ")
    if bad:
        raise SmokeError(f"run {tag} differs from {ref_name}: "
                         + "; ".join(bad))
    what = "four outputs" + (" and report lines"
                             if run["report"] is not None else "")
    print(f"run {tag}: {what} byte-identical to {ref_name}", flush=True)


def _drop(run: dict) -> None:
    shutil.rmtree(os.path.dirname(run["prefix"]), ignore_errors=True)


def one_card(reads: str, paf: str, cache_dir: str) -> None:
    oracle = cli_run("oracle", reads, paf, ["--engine", "oracle"],
                     cache_dir)
    s = oracle["stats"]
    print(f"dataset: {s['n_reads']} reads, mean length "
          f"{s['total_read_length'] / max(s['n_reads'], 1):.0f} bp, "
          f"{s['n_paf_rows']} PAF rows", flush=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        # the program's own fixed cache directory: empty it so (a) is cold
        shutil.rmtree(cache_dir, ignore_errors=True)
    for tag, extra in (("a_stream_cold", []), ("b_stream_warm", []),
                       ("c_whole_file", ["--chunk-reads", "0"])):
        run = cli_run(tag, reads, paf, extra, cache_dir)
        check_same(tag, run, oracle, "oracle")
        _drop(run)
    _drop(oracle)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def four_cards(reads: str, paf: str, cache_dir: str, n: int) -> None:
    oracle = cli_run("oracle", reads, paf, ["--engine", "oracle"],
                     cache_dir)
    one = cli_run("one_card", reads, paf, [], cache_dir)
    check_same("one_card", one, oracle, "oracle")
    mesh = cli_run(f"devices{n}", reads, paf, ["--devices", str(n)],
                   cache_dir)
    check_same(f"devices{n}", mesh, oracle, "oracle")
    check_same(f"devices{n}", mesh, one, "one-card run")
    _drop(mesh)

    d = os.path.join(WORK, f"distributed{n}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    prefix = os.path.join(d, "out")
    coord = f"localhost:{_free_port()}"
    logs = [open(os.path.join(d, f"worker{i}.log"), "w") for i in range(n)]
    t0 = time.perf_counter()
    print(f"run distributed{n}: starting {n} processes", flush=True)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_WORKER, coord, str(n), str(i), reads,
         paf, prefix], cwd=ROOT, env=_env(), stdout=logs[i],
        stderr=subprocess.STDOUT) for i in range(n)]
    rcs = None
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    except subprocess.TimeoutExpired:
        pass  # reported below with every worker's log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    if rcs is None or any(rcs):
        tails = []
        for i in range(n):
            with open(os.path.join(d, f"worker{i}.log")) as f:
                tails.append(f"--- worker {i}:\n{f.read()[-1500:]}")
        raise SmokeError(f"run_distributed x{n} failed (rcs {rcs}, "
                         f"{wall:.0f} s):\n" + "\n".join(tails))
    print(f"run distributed{n}: {n} processes, one card each: wall "
          f"{wall:.3f} s", flush=True)
    dist = {"prefix": prefix, "report": None}  # prints no report
    check_same(f"distributed{n}", dist, oracle, "oracle")
    check_same(f"distributed{n}", dist, one, "one-card run")
    for r in (dist, one, oracle):
        _drop(r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths (needs 4 cards)")
    ap.add_argument("--genome-size", type=int, default=100_000_000,
                    help="simulated genome size in bp (default 100 Mbp)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        dev = environment()
        want = 4 if args.four_cards else 1
        if dev["count"] < want:
            raise SmokeError(f"need {want} cards, JAX sees {dev['count']}")
        reads, paf = dataset(args.genome_size)
        if args.four_cards:
            four_cards(reads, paf, dev["cache_dir"], want)
        else:
            one_card(reads, paf, dev["cache_dir"])
    except (SmokeError, OSError, ValueError, KeyError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
