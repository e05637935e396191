"""SCC benchmark app (reference apps/scc analog)."""
import sys

import numpy as np

from app_common import run_app
from vectorgraphlibrary.models import scc
from vectorgraphlibrary.utils import verify


def run_round(ec, graph, weights, source, cfg):
    return scc.vgl_forward_backward(graph).values


def check_round(ec, graph, weights, source, result, cfg):
    got = np.asarray(result)[:graph.v]
    want = scc.seq_scc(ec)
    return verify.equal_components(got, want)


if __name__ == "__main__":
    sys.exit(run_app("scc", run_round, check_round, needs_source=False))
