"""gz-input scale proof.

The reference's contract is gz-everywhere (``kseq.h`` over ``gzFile``,
``/root/reference/paf.hpp:7``) and real HiFi inputs ship gzipped, but
every prior 512k proof used plain inputs. This runner takes the
pre-generated plain 512k dataset and:

1. produces the compressed variants — plain-gz via the ``gzip`` CLI
   (the real-world artifact: one serial DEFLATE stream) and BGZF via
   our own block-parallel ``native.bgzf_compress_file`` (bgzip
   wire-compatible);
2. measures the decompression floors in isolation (``gzip -dc`` wall =
   the serial inflate floor; BGZF inflate wall via the native path);
3. runs the default auto-streaming CLI on plain, gz, and BGZF inputs —
   fresh process each, cold page cache optional, per-stage
   RAFT_CHUNK_TRACE attribution — and byte-compares all four outputs
   of every variant against the plain run;
4. prints ONE JSON with walls, stage splits, floors, and parity flags.

Usage::

    python -m raft_tpu.tools.bench_gz_scale \
        --reads /root/bigbench/scale524288.reads.fasta \
        --paf   /root/bigbench/scale524288.overlaps.paf \
        --dir /root/bigbench/gzscale [--cold] [--with-reference]

Runs are sequential: one device process at a time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

OUT_EXTS = [".reads.fasta", ".coverage.txt", ".long_repeats.txt",
            ".long_repeats.bed"]


def _drop_caches() -> bool:
    try:
        subprocess.run(["sync"], check=True)
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _run_ours(reads: str, paf: str, prefix: str, stats: str,
              trace: str) -> dict:
    env = dict(os.environ, RAFT_CHUNK_TRACE=trace)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "raft_tpu.cli", "-e", "20", "-m", "1.5",
         "-p", "10000", "-l", "20000", "-f", "1000", "-v", "500",
         "--stats-json", stats, "-o", prefix, reads, paf],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, timeout=7200,
        env=env, text=True)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"run failed rc={res.returncode}: "
                           f"{res.stderr[-2000:]}")
    out = {"wall_s": round(wall, 1)}
    try:
        st = json.load(open(stats))
        out["stage_seconds"] = {k: round(v, 2)
                                for k, v in st["stage_seconds"].items()}
        out["peak_rss_mb"] = round(st.get("peak_rss_mb", 0))
    except (OSError, ValueError, KeyError):
        pass
    return out


def _cmp(a_prefix: str, b_prefix: str) -> dict:
    out = {}
    for ext in OUT_EXTS:
        rc = subprocess.run(["cmp", "-s", a_prefix + ext, b_prefix + ext])
        out[ext] = rc.returncode == 0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", required=True)
    ap.add_argument("--paf", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--cold", action="store_true",
                    help="drop the page cache before every timed pass")
    ap.add_argument("--with-reference", action="store_true")
    ap.add_argument("--keep-outputs", action="store_true")
    a = ap.parse_args(argv)
    os.makedirs(a.dir, exist_ok=True)
    result: dict = {"cold_page_cache": bool(a.cold),
                    "fasta_bytes": os.path.getsize(a.reads),
                    "paf_bytes": os.path.getsize(a.paf)}

    # -- compressed variants (cached across invocations) ---------------
    gz_reads = os.path.join(a.dir, os.path.basename(a.reads) + ".gz")
    gz_paf = os.path.join(a.dir, os.path.basename(a.paf) + ".gz")
    bg_reads = os.path.join(a.dir,
                            os.path.basename(a.reads) + ".bgzf.gz")
    bg_paf = os.path.join(a.dir, os.path.basename(a.paf) + ".bgzf.gz")
    for src, dst in ((a.reads, gz_reads), (a.paf, gz_paf)):
        if not os.path.exists(dst):
            # write to a temp name + rename: a killed/failed gzip must
            # not leave a truncated artifact a later run silently reuses
            t0 = time.perf_counter()
            tmp = dst + ".tmp"
            with open(tmp, "wb") as f:
                subprocess.run(["gzip", "-c", "-5", src], stdout=f,
                               check=True)
            os.replace(tmp, dst)
            result[f"gzip_compress_s_{os.path.basename(src)}"] = round(
                time.perf_counter() - t0, 1)
    from raft_tpu.io import native
    for src, dst in ((a.reads, bg_reads), (a.paf, bg_paf)):
        if not os.path.exists(dst):
            t0 = time.perf_counter()
            tmp = dst + ".tmp"
            if not native.bgzf_compress_file(src, tmp):
                raise RuntimeError(f"bgzf compress failed for {src}")
            os.replace(tmp, dst)
            result[f"bgzf_compress_s_{os.path.basename(src)}"] = round(
                time.perf_counter() - t0, 1)
    result["gz_fasta_bytes"] = os.path.getsize(gz_reads)
    result["bgzf_fasta_bytes"] = os.path.getsize(bg_reads)

    # -- decompression floors, measured in isolation -------------------
    if a.cold and not _drop_caches():
        result["cold_page_cache"] = "requested_but_drop_failed"
    t0 = time.perf_counter()
    with open(os.devnull, "wb") as dn:
        subprocess.run(["gzip", "-dc", gz_reads], stdout=dn, check=True)
    result["floor_serial_inflate_s"] = round(time.perf_counter() - t0, 1)
    if a.cold and not _drop_caches():
        result["cold_page_cache"] = "requested_but_drop_failed"
    t0 = time.perf_counter()
    idx = native.index_reads(bg_reads)
    result["floor_bgzf_index_s"] = round(time.perf_counter() - t0, 1)
    result["bgzf_index_n"] = int(idx["n"]) if idx else None
    del idx

    # -- the three pipeline runs ---------------------------------------
    runs = [("plain", a.reads, a.paf),
            ("gz", gz_reads, gz_paf),
            ("bgzf", bg_reads, bg_paf)]
    for name, r, p in runs:
        if a.cold and not _drop_caches():
            result["cold_page_cache"] = "requested_but_drop_failed"
        print(f"== {name} run ==", file=sys.stderr)
        result[name] = _run_ours(
            r, p, os.path.join(a.dir, f"out_{name}"),
            os.path.join(a.dir, f"stats_{name}.json"),
            os.path.join(a.dir, f"trace_{name}.jsonl"))
        print(json.dumps(result[name]), file=sys.stderr)

    for name in ("gz", "bgzf"):
        result[f"{name}_equals_plain"] = _cmp(
            os.path.join(a.dir, "out_plain"),
            os.path.join(a.dir, f"out_{name}"))
        if not a.keep_outputs:
            for ext in OUT_EXTS:
                try:
                    os.remove(os.path.join(a.dir, f"out_{name}") + ext)
                except OSError:
                    pass

    if a.with_reference:
        from raft_tpu.tools.refbuild import build_reference
        ref_bin = build_reference(a.dir)
        if ref_bin:
            if a.cold and not _drop_caches():
                result["cold_page_cache"] = "requested_but_drop_failed"
            print("== reference gz run ==", file=sys.stderr)
            t0 = time.perf_counter()
            rp = os.path.join(a.dir, "out_refgz")
            res = subprocess.run(
                [ref_bin, "-e", "20", "-m", "1.5", "-p", "10000",
                 "-l", "20000", "-f", "1000", "-v", "500", "-o", rp,
                 gz_reads, gz_paf],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=7200)
            result["reference_gz"] = {
                "wall_s": round(time.perf_counter() - t0, 1),
                "rc": res.returncode}
            result["reference_gz_equals_plain"] = _cmp(
                os.path.join(a.dir, "out_plain"), rp)
            if not a.keep_outputs:
                for ext in OUT_EXTS:
                    try:
                        os.remove(rp + ext)
                    except OSError:
                        pass

    ok = all(all(result[k].values())
             for k in result if k.endswith("_equals_plain"))
    result["all_equal"] = ok
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
