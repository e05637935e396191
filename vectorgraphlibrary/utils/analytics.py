"""Graph analytics (reference `vgl_runtime/graph_analytics/graph_analytics.h:3-16`):
degree-distribution histograms, memory-consumption estimates, component statistics,
degree-threshold analysis."""
from __future__ import annotations

import numpy as np

from ..io.edges_container import EdgesContainer


def analyse_degrees(ec: EdgesContainer) -> dict:
    v = ec.vertices_count
    outdeg = np.bincount(ec.src_ids, minlength=v)
    indeg = np.bincount(ec.dst_ids, minlength=v)
    log_bins = np.concatenate([[0], np.logspace(0, 24, 25, base=2)]).astype(
        np.int64)

    def hist(deg):
        h, _ = np.histogram(deg, bins=log_bins)
        return h

    stats = {
        "vertices": v,
        "edges": ec.edges_count,
        "avg_degree": ec.edges_count / max(v, 1),
        "max_out_degree": int(outdeg.max()) if v else 0,
        "max_in_degree": int(indeg.max()) if v else 0,
        "zero_out_degree": int((outdeg == 0).sum()),
        "zero_in_degree": int((indeg == 0).sum()),
        "out_degree_hist_pow2": hist(outdeg).tolist(),
        "in_degree_hist_pow2": hist(indeg).tolist(),
    }
    return stats


def estimate_memory_consumption(ec: EdgesContainer, cfg=None) -> dict:
    """Bytes estimates for each storage format (reference memory consumption
    analytics): COO, CSR (both directions), flagship tiles."""
    from ..config import DEFAULT_CONFIG
    cfg = cfg or DEFAULT_CONFIG
    v, e = ec.vertices_count, ec.edges_count
    coo = 2 * 4 * e + (4 * e if ec.weights is not None else 0)
    csr_dir = 8 * (v + 1) + 4 * e
    return {
        "coo_bytes": coo,
        "csr_both_directions_bytes": 2 * csr_dir,
        "tile_adj_bytes_approx": int(2 * 4 * e * 1.4),
    }


def component_statistics(labels: np.ndarray) -> dict:
    uniq, counts = np.unique(labels, return_counts=True)
    return {
        "components": int(len(uniq)),
        "largest": int(counts.max()),
        "singletons": int((counts == 1).sum()),
    }


def print_graph_info(ec: EdgesContainer) -> None:
    s = analyse_degrees(ec)
    print(f"|V| = {s['vertices']}, |E| = {s['edges']}, "
          f"avg degree = {s['avg_degree']:.2f}")
    print(f"max out/in degree: {s['max_out_degree']}/{s['max_in_degree']}")
    print(f"zero out/in degree: {s['zero_out_degree']}/{s['zero_in_degree']}")
