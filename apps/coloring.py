"""Graph coloring benchmark app (reference apps/coloring analog)."""
import sys

import numpy as np

from app_common import run_app
from vectorgraphlibrary.models import coloring
from vectorgraphlibrary.utils import verify


def run_round(ec, graph, weights, source, cfg):
    # ec enables the r5 core-extraction pass (host first-fit on the dense
    # core, device JP on the shallow remainder — models/coloring.py)
    colors, _ = coloring.vgl_coloring(graph, ec=ec)
    return colors.values


def check_round(ec, graph, weights, source, result, cfg):
    return verify.verify_colors(ec, np.asarray(result)[:graph.v])


if __name__ == "__main__":
    sys.exit(run_app("coloring", run_round, check_round, needs_source=False))
