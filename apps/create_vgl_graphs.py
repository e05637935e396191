"""Graph preparation utility (reference apps/utilites/create_vgl_graphs.cpp:7-45):
generate or convert (KONECT text) graphs and save binary .el_container files, plus
optional preprocessed-graph save (.vgl analog)."""
import argparse
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from vectorgraphlibrary.io import generation
from vectorgraphlibrary.io.edges_container import EdgesContainer
from vectorgraphlibrary.io.konect import import_konect


def main():
    p = argparse.ArgumentParser()
    p.add_argument("-gen", choices=["rmat", "ru"], default=None)
    p.add_argument("-s", type=int, default=14)
    p.add_argument("-e", type=int, default=16)
    p.add_argument("-convert", default=None, help="KONECT text file to convert")
    p.add_argument("-undirected", action="store_true")
    p.add_argument("-file", required=True, help="output .el_container path")
    p.add_argument("-preprocess", default=None,
                   help="also build + save the preprocessed device graph (.npz)")
    a = p.parse_args()
    if a.convert:
        ec = import_konect(a.convert, directed=not a.undirected)
    else:
        ec = generation.generate(a.gen or "rmat", a.s, a.e)
    ec.save_to_binary_file(a.file)
    print(f"saved |V|={ec.vertices_count} |E|={ec.edges_count} -> {a.file}")
    if a.preprocess:
        from vectorgraphlibrary.graph.device import import_graph
        from vectorgraphlibrary.graph.persistence import \
            save_graph_to_binary_file
        g = import_graph(ec)
        save_graph_to_binary_file(g, a.preprocess)
        print(f"preprocessed graph -> {a.preprocess}")


if __name__ == "__main__":
    main()
