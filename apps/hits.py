"""HITS benchmark app (reference apps/hits analog)."""
import sys

import numpy as np

from app_common import run_app
from vectorgraphlibrary.models import hits
from vectorgraphlibrary.utils import verify


def run_round(ec, graph, weights, source, cfg):
    auth, hub = hits.vgl_hits(graph, iterations=20)
    return (auth.values, hub.values)


def check_round(ec, graph, weights, source, result, cfg):
    auth, hub = result
    wa, wh = hits.seq_hits(ec, iterations=20)
    e1 = verify.verify_ranking_results(np.asarray(auth)[:graph.v], wa)
    e2 = verify.verify_ranking_results(np.asarray(hub)[:graph.v], wh)
    return e1 + e2


if __name__ == "__main__":
    sys.exit(run_app("hits", run_round, check_round, needs_source=False))
