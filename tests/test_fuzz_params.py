"""Param-space differential fuzzing.

``test_fuzz_parity`` randomizes *inputs* under mostly-default params; round
3's ``-v > -p`` reference-crash find showed the parameter axis pays too.
Here the params are the fuzz target: every seed draws from the extreme
corners of the defined domain —

* ``-r`` ∈ {1, 3, 50, 997} (window resolution: per-bp to coarser-than-read)
* ``-m`` ∈ {0, 0.1, 1.5, 10} (high_cov = int(e*m): 0 → every window is a
  repeat; 10 → none is)
* ``-f`` ∈ {0, 1000}
* ``-l``/``-p`` ratios including equality (div == 1)
* ``-v`` including the ``-v == -p`` boundary (the last value before the
  reference's substr-underflow crash domain, PARITY.md divergence 7)

crossed with randomized inputs (simulated/symmetric/gz/multiline modes).
Byte parity vs the reference binary on all four outputs per seed.

Domain edges *excluded* because they are documented reference UB we
reject up front (``params.validate``, PARITY.md divergences):
``-l < -p`` (div == 0 → reference SIGFPE at chop.hpp:270) and
``-v > -p`` (size_t underflow → std::out_of_range at chop.hpp:318).

Marked slow; run explicitly with ``-m slow``.
"""

from __future__ import annotations

import random

import pytest

import datagen
from test_parity import assert_parity, run_ours, run_reference

N_SEEDS = 64


def draw_params(rng: random.Random) -> list[str]:
    reso = rng.choice([1, 3, 50, 997])
    m = rng.choice([0.0, 0.1, 1.5, 10.0])
    p = rng.choice([500, 1000, 2000, 5000])
    ratio = rng.choice([1, 1, 2, 3, 7])  # 1 twice: weight the div==1 edge
    l = p * ratio if rng.random() < 0.5 else p * ratio + rng.randint(0, p - 1)
    v = rng.choice([0, 3, p // 2, p])  # p: the boundary the reference survives
    return ["-e", str(rng.randint(1, 40)), "-m", str(m), "-r", str(reso),
            "-p", str(p), "-l", str(l), "-f", str(rng.choice([0, 1000])),
            "-v", str(v)]


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_fuzz_params(tmp_path, ref_binary, seed):
    rng = random.Random(seed * 104729 + 13)
    tmp = str(tmp_path)
    mode = dict(
        simulated=rng.random() < 0.4,
        symmetric=rng.random() < 0.3,
        gz=rng.random() < 0.2,
        fastq=rng.random() < 0.15,
        multiline=rng.random() < 0.25,
        n_reads=rng.randint(5, 40),
        len_lo=rng.randint(1, 2000),
        len_hi=rng.randint(3000, 60000),
        n_pairs=rng.randint(0, 250),
        with_repeats=rng.random() < 0.8,
    )
    if mode["fastq"]:
        mode["multiline"] = False
    reads, paf = datagen.standard_case(seed=seed + 1000, tmpdir=tmp, **mode)
    args = draw_params(rng)
    run_reference(ref_binary, args + ["-o", f"{tmp}/ref", reads, paf], tmp)
    engine = "jax" if seed % 2 == 0 else "oracle"
    run_ours(args + ["-o", f"{tmp}/ours", reads, paf], engine=engine,
             io="native" if seed % 3 else "python")
    assert_parity(tmp, f"{tmp}/ref", f"{tmp}/ours")
