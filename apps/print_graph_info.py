"""Graph info utility (reference apps/utilites print_graph_info)."""
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from vectorgraphlibrary.runtime import cli, runtime
from vectorgraphlibrary.utils import analytics


def main():
    cfg = cli.parse_args(None, "print_graph_info")
    ec = runtime.load_edges(cfg)
    analytics.print_graph_info(ec)
    import json
    print(json.dumps(analytics.analyse_degrees(ec), indent=1))


if __name__ == "__main__":
    main()
