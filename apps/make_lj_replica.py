#!/usr/bin/env python
"""Generate `lj-replica`: a soc-LiveJournal1-scale Chung-Lu stand-in.

Zero egress blocks the KONECT download of soc-LiveJournal1 (a named BASELINE
config, |V|=4,847,571 |E|=68,993,773 — `/root/reference/apps/scripts/
settings.py:52-86`), so this builds a synthetic-but-realistic replica at the
SAME scale (VERDICT r4 "What's missing" #4): a directed Chung-Lu graph whose
expected-degree sequence follows LiveJournal's published power law
(γ ≈ 2.65, max degree ~20k, mean degree ~14.2). Endpoints are drawn
independently ∝ the weight sequence via inverse-CDF sampling — the standard
Chung-Lu construction, preserving the heavy-tailed degree mix, hub
concentration, and scale that make LiveJournal a meaningful benchmark
target, while being exactly reproducible from a seed.

Writes `.graphs/lj-replica.el_container`, which the harness real tier
(`apps/run_tests.py --tier real`) and `apps/bench_lj.py` pick up by name.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

V = 4_847_571
E = 68_993_773
GAMMA = 2.65
MAX_DEG = 20_000
SEED = 71


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def weights() -> np.ndarray:
    """Power-law expected degrees: w_i ∝ (i + i0)^(-1/(γ-1)), scaled so the
    mean matches E/V and the max is ~MAX_DEG."""
    alpha = 1.0 / (GAMMA - 1.0)
    i = np.arange(V, dtype=np.float64)
    # i0 sets the max expected degree after scaling; solve by normalizing
    w = (i + 1.0) ** (-alpha)
    w *= E / w.sum()
    # clip the extreme head to the LiveJournal-like max degree, renormalize
    w = np.minimum(w, MAX_DEG)
    w *= E / w.sum()
    return w


def main():
    from vectorgraphlibrary.io.edges_container import EdgesContainer
    from vectorgraphlibrary.io import corpus
    out = os.path.join(corpus.graph_dir(), "lj-replica.el_container")
    if os.path.exists(out):
        log(f"already built: {out}")
        return 0
    t0 = time.time()
    w = weights()
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    rng = np.random.default_rng(SEED)
    log("sampling endpoints ...")
    src = np.searchsorted(cdf, rng.random(E)).astype(np.int32)
    dst = np.searchsorted(cdf, rng.random(E)).astype(np.int32)
    ec = EdgesContainer(src, dst, V)
    ec.save_to_binary_file(out)
    deg = np.bincount(src, minlength=V)
    log(f"done in {time.time()-t0:.0f}s: |V|={V:,} |E|={E:,} "
        f"max_outdeg={deg.max():,} mean={deg.mean():.1f} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
