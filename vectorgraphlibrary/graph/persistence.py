"""Binary persistence for preprocessed graphs.

Capability match for the reference's per-format binary save/load
(`save_main_content_to_binary_file`, vect_csr_graph.h:90-92; extensions
.vgl/.vcsr/.el, framework_types.h:85-100): the expensive import pipeline —
degree sort, renumbering, tiling — runs once, then the whole device graph
round-trips through one .npz file.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import GraphFormat
from .device import (DeviceDirectedGraph, HugeTile, TileBucket, VGLGraph)


def _pack_directed(prefix: str, dg: DeviceDirectedGraph, out: dict) -> None:
    # per-array keys are optional: unweighted graphs ship no eidx tiles
    def put(key, arr):
        if arr is not None:
            out[key] = np.asarray(arr)
    put(f"{prefix}.row_ptr", dg.row_ptr)
    put(f"{prefix}.col_idx", dg.col_idx)
    put(f"{prefix}.degrees", dg.degrees)
    put(f"{prefix}.sorted_to_orig", dg.sorted_to_orig)
    put(f"{prefix}.orig_to_sorted", dg.orig_to_sorted)
    out[f"{prefix}.meta"] = np.asarray([dg.v, dg.v_pad, dg.e, dg.e_pad,
                                        len(dg.buckets),
                                        1 if dg.huge is not None else 0])
    for i, b in enumerate(dg.buckets):
        put(f"{prefix}.b{i}.adj", b.adj)
        put(f"{prefix}.b{i}.eidx", b.eidx)
        out[f"{prefix}.b{i}.meta"] = np.asarray(
            [b.width, b.row_start, b.rows, b.rows_pad])
    if dg.huge is not None:
        h = dg.huge
        put(f"{prefix}.huge.adj", h.adj)
        put(f"{prefix}.huge.eidx", h.eidx)
        out[f"{prefix}.huge.seg_ids"] = np.asarray(h.seg_ids)
        out[f"{prefix}.huge.meta"] = np.asarray(
            [h.chunk_w, h.n_rows, h.n_chunks, h.n_chunks_pad])


def _unpack_directed(prefix: str, z) -> DeviceDirectedGraph:
    v, v_pad, e, e_pad, nb, has_huge = z[f"{prefix}.meta"].tolist()

    def opt(key):
        return jnp.asarray(z[key]) if key in z else None
    buckets = []
    for i in range(nb):
        w, rs, r, rp = z[f"{prefix}.b{i}.meta"].tolist()
        buckets.append(TileBucket(
            adj=opt(f"{prefix}.b{i}.adj"), eidx=opt(f"{prefix}.b{i}.eidx"),
            width=w, row_start=rs, rows=r, rows_pad=rp))
    huge = None
    if has_huge:
        cw, nr, nc, ncp = z[f"{prefix}.huge.meta"].tolist()
        huge = HugeTile(adj=opt(f"{prefix}.huge.adj"),
                        eidx=opt(f"{prefix}.huge.eidx"),
                        seg_ids=jnp.asarray(z[f"{prefix}.huge.seg_ids"]),
                        chunk_w=cw, n_rows=nr, n_chunks=nc, n_chunks_pad=ncp)
    return DeviceDirectedGraph(
        row_ptr=opt(f"{prefix}.row_ptr"),
        col_idx=opt(f"{prefix}.col_idx"),
        degrees=opt(f"{prefix}.degrees"),
        sorted_to_orig=opt(f"{prefix}.sorted_to_orig"),
        orig_to_sorted=opt(f"{prefix}.orig_to_sorted"),
        buckets=tuple(buckets), huge=huge,
        v=v, v_pad=v_pad, e=e, e_pad=e_pad)


def save_graph_to_binary_file(graph: VGLGraph, path: str,
                              compressed: bool = True) -> None:
    out = {}
    _pack_directed("out", graph.outgoing, out)
    _pack_directed("in", graph.incoming, out)
    out["meta"] = np.asarray([graph.v, graph.v_pad, graph.e])
    out["format"] = np.asarray([graph.graph_format.value], dtype="U16")
    (np.savez_compressed if compressed else np.savez)(path, **out)


def load_graph_from_binary_file(path: str) -> VGLGraph:
    z = np.load(path)
    v, v_pad, e = z["meta"].tolist()
    return VGLGraph(
        outgoing=_unpack_directed("out", z),
        incoming=_unpack_directed("in", z),
        v=v, v_pad=v_pad, e=e,
        graph_format=GraphFormat.parse(str(z["format"][0])))


def save_sharded_graph(sg, path_prefix: str, compressed: bool = False) -> None:
    """Persist a ShardedTileGraph as one .npz per shard + a meta file
    (reference ShardedCSRGraph saves per-shard binaries,
    sharded_csr_graph/*.hpp). Uncompressed by default: large artifacts
    deflate slowly on the host."""
    import json
    for s in range(sg.n_shards):
        save_graph_to_binary_file(sg.shard(s), f"{path_prefix}.shard{s}.npz",
                                  compressed=compressed)
    with open(f"{path_prefix}.meta.json", "w") as f:
        json.dump({"n_shards": sg.n_shards, "v": sg.v, "v_pad": sg.v_pad,
                   "e": sg.e,
                   "edges_per_shard":
                       np.asarray(sg.edges_per_shard).tolist()}, f)


def load_sharded_graph(path_prefix: str):
    import json
    import jax
    from ..parallel.shard_build import ShardedTileGraph
    with open(f"{path_prefix}.meta.json") as f:
        meta = json.load(f)
    graphs = [load_graph_from_binary_file(f"{path_prefix}.shard{s}.npz")
              for s in range(meta["n_shards"])]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *graphs)
    return ShardedTileGraph(
        stacked=stacked,
        edges_per_shard=jnp.asarray(meta["edges_per_shard"],
                                    dtype=jnp.int32),
        n_shards=meta["n_shards"], v=meta["v"], v_pad=meta["v_pad"],
        e=meta["e"])
