"""Test configuration.

Must run before any jax import: forces the CPU backend with 8 virtual
devices so multi-chip sharding tests run anywhere (SURVEY.md §4 rebuild
implication — the reference has no tests; this suite is the new pyramid).
"""

import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# pin the platform in jax's config as well, so the suite always runs on
# the 8-virtual-device CPU mesh whatever the installed plugins prefer
import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(__file__))

import pytest

REF_DIR = "/root/reference"
REF_BIN = "/tmp/raft_ref_build/raft"


@pytest.fixture(scope="session")
def ref_binary():
    """Compile the reference raft binary once (the parity oracle).

    Build recipe from the reference Makefile:3-6.
    """
    if not os.path.exists(REF_BIN):
        os.makedirs(os.path.dirname(REF_BIN), exist_ok=True)
        res = subprocess.run(
            ["g++", "-g", "-O3", "-std=c++14", "-I", REF_DIR,
             os.path.join(REF_DIR, "main.cpp"), "-lz", "-o", REF_BIN],
            capture_output=True, text=True)
        if res.returncode != 0:
            pytest.skip(f"cannot build reference binary: {res.stderr}")
    return REF_BIN


@pytest.fixture(scope="session")
def ref_split_naive():
    out = "/tmp/raft_ref_build/split_naive"
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        res = subprocess.run(
            ["g++", "-g", "-O3", "-std=c++14", "-I", REF_DIR,
             os.path.join(REF_DIR, "split_naive.cpp"), "-lz", "-o", out],
            capture_output=True, text=True)
        if res.returncode != 0:
            pytest.skip(f"cannot build split_naive: {res.stderr}")
    return out
