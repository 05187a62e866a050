"""MapReduceMP demo on the PyTorch port: the paper's Sec. 9 algorithm on
a part mesh of 4 mappers (one partition each), with a quota-based shuffle
between shards and a global stop test.  The counterpart of
``examples/mapreduce_demo.py``.

On the card the mesh spreads the mappers over every visible card, at most
four (four lanes of one shard on one card); with ``--device cpu`` it is
four CPU shards, as the reference runs on four forced host devices.

    python examples/torch_mapreduce_demo.py                 # on the card(s)
    python examples/torch_mapreduce_demo.py --device cpu    # on the host
"""
import argparse
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import numpy as np

from repro_torch.core import (EngineConfig, build_catalog, build_partitions, generate_plan,
                              make_part_mesh, match_query, partition_graph, resolve_device)
from repro_torch.core.mapreduce_mp import MapReduceMPEngine
from repro_torch.data.generators import subgen_like_graph, subgen_queries


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="MapReduceMP on a part mesh")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default: every visible card, at most four; "
                         "raises with no card) or cpu (four CPU shards)")
    device = resolve_device(ap.parse_args(argv).device)

    graph = subgen_like_graph(n_nodes=1000, n_edges=3000, n_embed=30, seed=1)
    k = 4
    assign = partition_graph(graph, k, "ecosocial")
    pg = build_partitions(graph, assign, k)
    catalog = build_catalog(graph)
    mesh = make_part_mesh(k, [device] * k if device.type == "cpu" else None)
    print(f"graph {graph.n_nodes}/{graph.n_edges}; {k} partitions on "
          f"{len(mesh.shards)} devices ({', '.join(str(s.device) for s in mesh.shards)})")

    engine = MapReduceMPEngine(pg, EngineConfig(cap=32768), device=device, mesh=mesh)
    bad = 0
    for dq in subgen_queries(graph):
        q = dq.disjuncts[0]
        plan = generate_plan(q, graph, catalog)
        res = engine.run(plan)
        ref = match_query(graph, q, q_pad=8)
        ok = np.array_equal(np.unique(res.answers, axis=0), ref)
        bad += not ok
        print(f"{q.name}: {res.answers.shape[0]} answers in "
              f"{res.n_iterations} map/reduce iterations "
              f"(plan max path {plan.max_path_len()}) — "
              f"{'MATCH' if ok else 'MISMATCH'} vs oracle")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
