"""raft_tpu — repeat-aware read fragmentation on an accelerator.

A from-scratch rebuild of the capabilities of at-cg/RAFT (reference at
``/root/reference``): columnar host I/O (C++), batched ``[B, W]`` device
tensors, JAX/XLA stages for coverage pileup, repeat scanning and
chopping, and ``shard_map`` data parallelism over reads.
"""

from raft_tpu.params import AlgoParams
from raft_tpu.pipeline import run_pipeline, RunStats

__version__ = "0.1.0"
__all__ = ["AlgoParams", "run_pipeline", "RunStats"]
