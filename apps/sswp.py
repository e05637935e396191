"""SSWP benchmark app (reference apps/sswp analog)."""
import sys

from app_common import run_app          # first: puts the repo on sys.path
import vectorgraphlibrary as vgl
from vectorgraphlibrary.models import sswp
from vectorgraphlibrary.utils import verify


def run_round(ec, graph, weights, source, cfg):
    caps, _ = sswp.vgl_widest_paths(graph, weights, source)
    return caps


def check_round(ec, graph, weights, source, result, cfg):
    got = vgl.as_original_numpy(result, graph)
    want = sswp.seq_widest_paths(ec, source)
    return verify.verify_results(got, want)


if __name__ == "__main__":
    sys.exit(run_app("sswp", run_round, check_round, need_weights=True))
