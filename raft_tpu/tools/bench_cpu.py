"""CPU-backend ablation: the IDENTICAL pipeline on the host CPU jax
backend, so the device's gain over the same code on the host is
published beside the gain over the reference.

Run as a SUBPROCESS of bench.py with ``JAX_PLATFORMS=cpu`` in its
environment, so it never opens the card the parent holds. Prints ONE
line: min wall seconds over N runs (after one warm-up that absorbs
CPU-backend jit compiles).

Usage: python -m raft_tpu.tools.bench_cpu reads.fa ovl.paf outprefix [N]
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    import jax
    jax.config.update("jax_platforms", "cpu")  # also when run by hand
    import time
    from raft_tpu.params import AlgoParams
    from raft_tpu.pipeline import run_pipeline

    reads, paf, out = argv[0], argv[1], argv[2]
    rounds = int(argv[3]) if len(argv) > 3 else 2
    params = AlgoParams(est_cov=20, outputfilename=out)
    run_pipeline(reads, paf, params, engine="jax", verbose=False)  # warm-up
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        run_pipeline(reads, paf, params, engine="jax", verbose=False)
        best = min(best, time.perf_counter() - t0)
    print(f"{best:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
