"""CC benchmark app (reference apps/cc analog)."""
import sys

import numpy as np

from app_common import run_app
from vectorgraphlibrary.models import cc
from vectorgraphlibrary.utils import verify


def run_round(ec, graph, weights, source, cfg):
    if cfg.algorithm_variant == "bfs_based":
        return cc.vgl_bfs_based(graph).values
    labels, _ = cc.vgl_shiloach_vishkin(graph)   # -sv default
    return labels.values


def check_round(ec, graph, weights, source, result, cfg):
    got = np.asarray(result)[:graph.v]
    want = cc.seq_cc(ec)
    return verify.equal_components(got, want)


if __name__ == "__main__":
    sys.exit(run_app("cc", run_round, check_round, needs_source=False))
