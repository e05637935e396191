"""Random-walk benchmark app (reference apps/rw analog)."""
import sys

import numpy as np

from app_common import run_app
from vectorgraphlibrary.models import rw


def run_round(ec, graph, weights, source, cfg):
    walkers = np.full(1024, source, np.int64)
    return rw.vgl_random_walk(graph, walkers, walk_length=10, seed=cfg.seed)


def check_round(ec, graph, weights, source, result, cfg):
    ok = rw.seq_random_walk_reachable(ec, source, walk_length=10)
    errors = int((~ok[result]).sum())
    print(f"error count: {errors}")
    return errors


if __name__ == "__main__":
    sys.exit(run_app("rw", run_round, check_round))
