"""Quickstart on the PyTorch port: open a GraphSession on a partitioned
movie graph, serve expressive queries against it, check the whole-graph
oracle, and round the graph through disk (save -> open -> query, the
out-of-core path).  The counterpart of ``examples/quickstart.py``.

A ``GraphSession`` (``repro_torch/core/session.py``) is the serving API:
built once from (graph, scheme, k, engine), it stages partitions into a
device-resident ``PartitionStore`` and then answers repeated ``submit``
calls.  The first query pays *cold* partition loads (host->device
copies); repeats find them *warm* (device-resident).

    python examples/torch_quickstart.py                 # on the card
    python examples/torch_quickstart.py --device cpu    # on the host
"""
import argparse
import os
import sys
import tempfile
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

import numpy as np

from repro_torch.core import GraphSession, match_query, resolve_device
from repro_torch.core.query import Query, QueryEdge, QueryNode
from repro_torch.data.generators import imdb_like_graph


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="GraphSession quickstart on the port")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default; raises with no card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # 1. a movie graph (IMDB-like: unique people/movies, typed edges)
    graph = imdb_like_graph(n_movies=200, n_people=250, seed=42)
    print(f"graph: {graph.n_nodes} nodes, {graph.n_edges} edges")

    # 2. one session = one partitioned graph + a shared partition cache on
    #    the device, serving many queries (multilevel kway + sorted
    #    heavy-edge matching partitioner, METIS-style)
    session = GraphSession(graph, k=4, scheme="kway_shem", engine="opat", device=device)
    print(f"session: k={session.k} scheme={session.scheme} "
          f"cut = {session.pg.cut_edges} edges; device {session.device}")

    # 3. an expressive query: movies by person_7, their genre and production
    #    company, released after 1999 (comparison operator on a node value)
    query = Query(name="demo", nodes=[
        QueryNode("person_7"),                                  # 0
        QueryNode("?"),                                         # 1 movie (wildcard)
        QueryNode("?"),                                         # 2 company
        QueryNode("year", value_op=">", value=1999.0),          # 3
    ], edges=[
        QueryEdge(0, 1, "acted_in"),
        QueryEdge(1, 2, "produced_by"),
        QueryEdge(1, 3, "in_year"),
    ])

    # 4. serve it: the session plans the query (QP-Subdue cost-based) and
    #    runs OPAT with MAX-SN.  Every partition load is cold, and while
    #    each partition evaluates, the heuristic's runner-up is prefetched.
    res = session.submit(query)
    stats = res.stats[0]
    print(f"answers: {res.n_answers}; partition loads {stats.loads} "
          f"(L_ideal={stats.l_ideal}, ratio={stats.load_ratio:.2f}); "
          f"cold={res.load_stats.cold_loads} warm={res.load_stats.warm_loads}")

    # 5. verify against the independent whole-graph matcher
    ref = match_query(graph, query, q_pad=8)
    assert np.array_equal(res.answers, ref)
    print("oracle check: MATCH")

    # 6. serve it AGAIN: the store still holds every partition, so the
    #    repeat pays zero cold copies, warm loads only
    again = session.submit(query)
    assert np.array_equal(again.answers, ref)
    print(f"warm repeat: cold={again.load_stats.cold_loads} "
          f"warm={again.load_stats.warm_loads} "
          f"(latency {again.latency_s*1000:.0f} ms vs first "
          f"{res.latency_s*1000:.0f} ms)")
    assert again.load_stats.cold_loads == 0

    # 7. answer budget: the FIRST answer only; the engine stops loading
    #    partitions as soon as one unique answer exists
    top1 = session.submit(query, max_answers=1)
    print(f"top-1: {top1.n_answers} answer in {top1.stats[0].n_loads} loads "
          f"(full run took {stats.n_loads})")
    assert tuple(top1.answers[0]) in {tuple(r) for r in ref}

    # 8. a BATCH of concurrent queries: submit_many routes them through the
    #    shared-load QueryScheduler; every partition load advances all the
    #    queries waiting on it, and each query retires on its own budget
    batch = [Query(name=f"demo{i}", nodes=query.nodes, edges=query.edges)
             for i in range(4)]
    report = session.submit_many(batch, max_answers=2)
    print(f"batch: {len(report.results)} queries in {report.n_loads} workload "
          f"loads ({report.loads_per_query:.2f}/query, batch sizes "
          f"{report.batch_sizes})")
    assert all(r.n_answers == min(2, ref.shape[0]) for r in report.results)

    # 9. the session's per-partition workload profile (loads / completed /
    #    spawned / completion rate), which the workload-aware
    #    repartitioner reads (save_profile(path) writes it as JSON)
    prof = session.workload_profile()
    print(f"profile: {prof['queries_served']} queries, cache hit rate "
          f"{prof['cache']['hit_rate']:.0%}, per-partition loads "
          f"{[p['loads'] for p in prof['partitions']]}")

    # 10. out-of-core round trip: save the partitioned graph as a directory
    #     of per-partition shards (+ manifest), reopen it with a host cache
    #     too small to hold them all, and serve the same query off disk
    #     through the three-tier cache (disk -> pinned host LRU -> device
    #     LRU), at answers identical to the in-RAM session
    with tempfile.TemporaryDirectory(prefix="torch-quickstart-graph-") as gdir:
        manifest = session.save(gdir)
        shard_bytes = sum(p["nbytes"] for p in manifest["partitions"])
        disk_session = GraphSession.open(gdir, engine="opat", cache_parts=2,
                                         host_cache_parts=2, device=device)
        ooc = disk_session.submit(query)
        assert np.array_equal(ooc.answers, ref)
        st = disk_session.load_stats
        print(f"out of core: {shard_bytes} shard bytes behind a 2-partition "
              f"host cache -> same {ooc.n_answers} answers, "
              f"{st.disk_reads} disk reads "
              f"({st.read_ahead_hits} served by read-ahead)")
        assert st.disk_reads > 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
