"""Transitive-closure / triangle-count benchmark app (reference apps/tc analog)."""
import sys

import numpy as np

from app_common import run_app
from vectorgraphlibrary.models import tc


def run_round(ec, graph, weights, source, cfg):
    if cfg.algorithm_variant == "bfs_based":
        sources = np.asarray([source])
        return tc.vgl_bfs_based_reachability(graph, sources)
    sources = np.asarray([source])
    return tc.reachability(ec, graph, sources)      # -purdoms default


def check_round(ec, graph, weights, source, result, cfg):
    want = tc.seq_reachability(ec, [source])
    errors = int((np.asarray(result) != want).sum())
    print(f"error count: {errors}")
    return errors


if __name__ == "__main__":
    sys.exit(run_app("tc", run_round, check_round))
