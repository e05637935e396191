"""Offline storage-format / kernel-config autotuner.

Capability match for the reference's related_projects/deep_learning pipeline
(generate per-graph feature vectors over synthetic sweeps + KONECT graphs, train a
model choosing the best storage format — an offline autotuner, SURVEY.md §2.7).
Here: the same per-graph feature vector (degree-distribution moments, skew,
density), a dataset generator over synthetic sweeps, benchmark-driven label
collection, and a transparent nearest-neighbor chooser (no sklearn dependency) that
picks the graph format and tile parameters.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..config import GraphFormat, VGLConfig
from ..io.edges_container import EdgesContainer


def extract_features(ec: EdgesContainer) -> np.ndarray:
    """Per-graph feature vector (reference prepare_nn_input.h analog)."""
    v, e = ec.vertices_count, ec.edges_count
    outdeg = np.bincount(ec.src_ids, minlength=v).astype(np.float64)
    indeg = np.bincount(ec.dst_ids, minlength=v).astype(np.float64)
    srt = np.sort(outdeg)[::-1]
    top1 = srt[: max(v // 100, 1)].sum() / max(e, 1)     # hub edge share
    gini_proxy = (srt * np.arange(1, v + 1)).sum() / max(srt.sum() * v, 1)
    return np.array([
        np.log2(max(v, 2)),
        np.log2(max(e, 2)),
        e / max(v, 1),                                   # avg degree
        outdeg.std() / max(outdeg.mean(), 1e-9),         # degree CV (skew)
        indeg.std() / max(indeg.mean(), 1e-9),
        top1,
        gini_proxy,
        (outdeg == 0).mean(),
        (indeg == 0).mean(),
    ])


class FormatAutotuner:
    """k-NN over benchmarked (features -> best config) samples."""

    def __init__(self, samples=None):
        self.samples = samples or []     # list of (features list, config dict)

    def add_sample(self, ec: EdgesContainer, best: dict) -> None:
        self.samples.append((extract_features(ec).tolist(), best))

    def choose(self, ec: EdgesContainer, k: int = 3) -> dict:
        if not self.samples:
            return self._heuristic(ec)
        f = extract_features(ec)
        feats = np.array([s[0] for s in self.samples])
        scale = feats.std(axis=0) + 1e-9
        d = np.linalg.norm((feats - f) / scale, axis=1)
        votes = [self.samples[i][1] for i in np.argsort(d)[:k]]
        keys = {json.dumps(vv, sort_keys=True) for vv in votes}
        best = max(keys, key=lambda kk: sum(
            json.dumps(vv, sort_keys=True) == kk for vv in votes))
        return json.loads(best)

    @staticmethod
    def _heuristic(ec: EdgesContainer) -> dict:
        """Cold-start rule mirroring what the sweeps learn: power-law graphs want
        the tiled format with a low huge threshold; near-uniform degree
        graphs can use a higher threshold (fewer kernels)."""
        f = extract_features(ec)
        skew = f[3]
        return {
            "graph_format": GraphFormat.TILE_CSR.value,
            "huge_degree_threshold": 256 if skew > 1.5 else 1024,
            "huge_row_chunk": 512,
        }

    def apply(self, ec: EdgesContainer, cfg: VGLConfig) -> VGLConfig:
        best = self.choose(ec)
        return cfg.replace(
            graph_format=GraphFormat.parse(best["graph_format"]),
            huge_degree_threshold=best["huge_degree_threshold"],
            huge_row_chunk=best["huge_row_chunk"])

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump(self.samples, fp)

    @staticmethod
    def load(path: str) -> "FormatAutotuner":
        with open(path) as fp:
            return FormatAutotuner(json.load(fp))


BUNDLED_SAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "autotuner_samples.json")


def default_tuner() -> "FormatAutotuner":
    """Tuner over the bundled measured samples (falls back to the heuristic
    when the sweep file is absent)."""
    if os.path.exists(BUNDLED_SAMPLES):
        return FormatAutotuner.load(BUNDLED_SAMPLES)
    return FormatAutotuner()


def collect_samples(scales=(12, 14), edge_factors=(8, 32), seeds=(0,),
                    thresholds=(128, 256, 1024), pr_iters: int = 20,
                    out_path: Optional[str] = None,
                    verbose: bool = True) -> "FormatAutotuner":
    """Benchmark-driven label collection (the reference deep_learning
    pipeline's generate_learning_data + training step, measured rather than
    learned): for each corpus graph, time PageRank under candidate tile
    configs on the CURRENT backend and record the winner."""
    import time as _time
    import jax
    from ..io import generation
    from ..graph.device import import_graph
    from ..models import pr
    tuner = FormatAutotuner()
    for kind in ("rmat", "ru"):
        for s in scales:
            for ef in edge_factors:
                for seed in seeds:
                    ec = generation.generate(kind, s, ef, seed)
                    best, best_dt = None, float("inf")
                    for thr in thresholds:
                        cfg = VGLConfig(huge_degree_threshold=thr)
                        g = import_graph(ec, cfg)
                        run = lambda: pr.vgl_page_rank(
                            g, max_iterations=pr_iters,
                            use_convergence=False)[0].values
                        jax.block_until_ready(run())
                        t0 = _time.perf_counter()
                        jax.block_until_ready(run())
                        dt = _time.perf_counter() - t0
                        if dt < best_dt:
                            best_dt = dt
                            best = {"graph_format": GraphFormat.TILE_CSR.value,
                                    "huge_degree_threshold": thr,
                                    "huge_row_chunk": 512}
                        if verbose:
                            print(f"{kind}-{s}-{ef} thr={thr}: "
                                  f"{dt*1e3:.1f} ms", flush=True)
                    tuner.add_sample(ec, best)
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        tuner.save(out_path)
    return tuner


def generate_learning_data(scales=(12, 14), edge_factors=(8, 32),
                           seeds=(0,)) -> list:
    """Synthetic sweep (reference prepare_all_data.py:11-34 analog): feature
    vectors for RMAT + uniform graphs over scale x edge-factor grids."""
    from ..io import generation
    rows = []
    for kind in ("rmat", "ru"):
        for s in scales:
            for ef in edge_factors:
                for seed in seeds:
                    ec = generation.generate(kind, s, ef, seed, weighted=False)
                    rows.append({"kind": kind, "scale": s, "edge_factor": ef,
                                 "features": extract_features(ec).tolist()})
    return rows
