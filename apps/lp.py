"""Label propagation benchmark app (reference apps/lp analog)."""
import sys

import numpy as np

from app_common import run_app
from vectorgraphlibrary.models import lp
from vectorgraphlibrary.utils import verify


def run_round(ec, graph, weights, source, cfg):
    labels, _ = lp.vgl_label_propagation(graph, max_iterations=10)
    return labels.values


def check_round(ec, graph, weights, source, result, cfg):
    got = np.asarray(result)[:graph.v]
    want = lp.seq_label_propagation(ec, max_iterations=10)
    return verify.verify_results(got, want)


if __name__ == "__main__":
    sys.exit(run_app("lp", run_round, check_round, needs_source=False))
