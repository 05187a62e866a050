"""The plain reference against hand-counted answers, and against the
port's own oracle on random graphs (the test may read the port; the
reference never does)."""
import numpy as np
import pytest
import torch

from graphbench.check import Judge, bf16_round, control_matcher
from graphbench.datasets import GraphArrays, edge_spec, node_spec, pattern, query
from graphbench.reference.matcher import Matcher, union


def tiny_graph():
    """Two planted A-B-C-D instances (vertices 0-3 and 4-7), a third one
    missing its C (8, 9, 11), a stray A-B pair joined by the wrong label
    (12, 13), and two valued vertices."""
    labels = ["A", "B", "C", "D", "X", "year"]
    nl = [0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 4, 3, 0, 1, 5, 5]
    val = [np.nan] * 14 + [1999.0, 2000.0]
    e = [(0, 1, "ab"), (1, 2, "bc"), (1, 3, "bd"),
         (4, 5, "ab"), (5, 6, "bc"), (5, 7, "bd"),
         (8, 9, "ab"), (9, 10, "bc"), (9, 11, "bd"),
         (12, 13, "zz"), (0, 14, "in"), (4, 15, "in"), (8, 15, "in")]
    elabels = ["ab", "bc", "bd", "zz", "in"]
    return GraphArrays(
        node_label=np.array(nl, np.int32), node_value=np.array(val, np.float32),
        edge_src=np.array([a for a, _, _ in e], np.int32),
        edge_dst=np.array([b for _, b, _ in e], np.int32),
        edge_label=np.array([elabels.index(x) for _, _, x in e], np.int32),
        edge_directed=np.zeros(len(e), bool), node_labels=labels, edge_labels=elabels)


Q5 = pattern("Q5", [node_spec("A"), node_spec("B"), node_spec("C"), node_spec("D")],
             [edge_spec(0, 1, "ab"), edge_spec(1, 2, "bc"), edge_spec(1, 3, "bd")])


def test_planted_template_hand_counted():
    m = Matcher(tiny_graph())
    got = m.match_pattern(Q5)
    assert got.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    # A-B over any edge label: the three planted pairs and the stray one
    ab = pattern("ab", [node_spec("A"), node_spec("B")], [edge_spec(0, 1)])
    assert m.match_pattern(ab).tolist() == [[0, 1], [4, 5], [8, 9], [12, 13]]
    # a label the graph lacks matches nothing
    none = pattern("n", [node_spec("A"), node_spec("Q")], [edge_spec(0, 1)])
    assert m.match_pattern(none).shape == (0, 2)


def test_value_predicates_and_nan():
    m = Matcher(tiny_graph())
    # A -in- year != 2000: only vertex 0's year (1999); 4 and 8 have 2000
    q = pattern("y", [node_spec("A"), node_spec("year", "!=", 2000.0)],
                [edge_spec(0, 1, "in")])
    assert m.match_pattern(q).tolist() == [[0, 14]]
    # a wildcard with a value predicate: vertices without a value fail it
    q = pattern("w", [node_spec("A"), node_spec("?", "!=", 5.0)], [edge_spec(0, 1)])
    assert m.match_pattern(q).tolist() == [[0, 14], [4, 15], [8, 15]]
    q = pattern("ge", [node_spec("?", ">=", 2000.0)], [])
    assert m.match_pattern(q).tolist() == [[15]]


def test_automorphisms_injectivity_and_union():
    # a triangle of X's: a 3-cycle pattern binds each rotation and
    # reflection once (6 rows); a path of 3 X's never repeats a vertex
    g = GraphArrays(node_label=np.zeros(3, np.int32), node_value=np.full(3, np.nan, np.float32),
                    edge_src=np.array([0, 1, 2], np.int32), edge_dst=np.array([1, 2, 0], np.int32),
                    edge_label=np.zeros(3, np.int32), edge_directed=np.zeros(3, bool),
                    node_labels=["X"], edge_labels=["e"])
    m = Matcher(g)
    tri = pattern("t", [node_spec("X")] * 3,
                  [edge_spec(0, 1), edge_spec(1, 2), edge_spec(2, 0)])
    assert m.match_pattern(tri).shape == (6, 3)
    path = pattern("p", [node_spec("X")] * 3, [edge_spec(0, 1), edge_spec(1, 2)])
    rows = m.match_pattern(path)
    assert rows.shape == (6, 3) and all(len(set(r)) == 3 for r in rows.tolist())
    one = pattern("o", [node_spec("X")] * 2, [edge_spec(0, 1)])
    parts = m.match(query("or", one, tri))
    assert [p.shape for p in parts] == [(6, 3), (6, 3)]
    assert union(parts).shape == (12, 3)


def test_directed_edges():
    g = GraphArrays(node_label=np.zeros(2, np.int32), node_value=np.full(2, np.nan, np.float32),
                    edge_src=np.array([0], np.int32), edge_dst=np.array([1], np.int32),
                    edge_label=np.zeros(1, np.int32), edge_directed=np.ones(1, bool),
                    node_labels=["X"], edge_labels=["e"])
    m = Matcher(g)
    for d, want in ((0, [[0, 1], [1, 0]]), (1, [[0, 1]]), (2, [[1, 0]])):
        q = pattern("d", [node_spec("X")] * 2, [edge_spec(0, 1, "e", d)])
        assert m.match_pattern(q).tolist() == want


def test_judge_budgets():
    j = Judge(Matcher(tiny_graph()))
    q = query("Q5", Q5)
    pad = lambda rows: np.array([r + [-1] * (8 - len(r)) for r in rows], np.int32)
    assert j.ok(q, None, pad([[0, 1, 2, 3], [4, 5, 6, 7]]))
    assert not j.ok(q, None, pad([[0, 1, 2, 3]]))                   # one missing
    assert j.ok(q, 1, pad([[4, 5, 6, 7]]))                          # a budgeted subset
    assert not j.ok(q, 1, pad([[0, 1, 2, 3], [4, 5, 6, 7]]))        # over the budget
    assert not j.ok(q, 2, pad([[0, 1, 2, 3], [0, 1, 2, 7]]))        # a row not an answer
    assert not j.ok(q, None, pad([[0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]))
    bad = pad([[0, 1, 2, 3], [4, 5, 6, 7]])
    bad[0, 6] = 3                                                   # junk past the pattern
    assert not j.ok(q, None, bad)


def test_bf16_round():
    years = np.arange(1980, 2016, dtype=np.float32)
    got = bf16_round(years)
    # bfloat16 keeps 8 significant bits: steps of 8 between 1024 and 2048
    assert set(got.tolist()) <= set(range(1976, 2024, 8))
    assert (got == 2000).sum() == 9            # 1996 to 2004, ties to even
    x = np.random.default_rng(0).standard_normal(10000).astype(np.float32) * 1e3
    assert (bf16_round(x) == torch.from_numpy(x).to(torch.bfloat16).float().numpy()).all()
    assert np.isnan(bf16_round(np.array([np.nan], np.float32)))[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_against_port_oracle(seed):
    """Random small graphs, labels, values, directions and queries: the
    reference equals ``repro_torch.core.oracle`` on every one."""
    from repro_torch.core import oracle
    from repro_torch.core.query import DisjunctiveQuery
    from graphbench.serve import port_graph
    rng = np.random.default_rng(seed)
    n, e = 60, 160
    g = GraphArrays(node_label=rng.integers(0, 3, n).astype(np.int32),
                    node_value=np.where(rng.random(n) < 0.5, rng.integers(0, 4, n),
                                        np.nan).astype(np.float32),
                    edge_src=rng.integers(0, n, e).astype(np.int32),
                    edge_dst=((rng.integers(1, n, e) + np.arange(e)) % n).astype(np.int32),
                    edge_label=rng.integers(0, 2, e).astype(np.int32),
                    edge_directed=rng.random(e) < 0.4,
                    node_labels=["a", "b", "c"], edge_labels=["x", "y"])
    g.edge_dst = np.where(g.edge_dst == g.edge_src, (g.edge_src + 1) % n, g.edge_dst).astype(np.int32)
    m, graph = Matcher(g), port_graph(g)
    ops = ["", "=", "!=", "<", ">="]
    for _ in range(12):
        Q = int(rng.integers(2, 5))
        nodes = [node_spec(str(rng.choice(["a", "b", "c", "?", "zz"])), str(rng.choice(ops)),
                         float(rng.integers(0, 4))) for _ in range(Q)]
        edges = [edge_spec(int(rng.integers(0, i)), i, str(rng.choice(["x", "y", "?"])),
                           int(rng.integers(0, 3))) for i in range(1, Q)]
        if Q > 2 and rng.random() < 0.5:
            edges.append(edge_spec(0, Q - 1, "?", 0))      # a cycle
        q = query("r", pattern("r", nodes, edges))
        want = oracle.match_disjunctive(graph, DisjunctiveQuery.from_json_dict(q))
        got = union(m.match(q))
        assert got.tolist() == want.tolist(), q


def test_controls_change_answers():
    g = tiny_graph()
    j = Judge(control_matcher(g, {"kind": "values_bf16"}, 0))
    q = query("y", pattern("y", [node_spec("A"), node_spec("year", "!=", 2000.0)],
                           [edge_spec(0, 1, "in")]))
    assert j.reference(q)[1].shape[0] == 0          # 1999 rounds to 2000
    cut = Judge(control_matcher(g, {"kind": "drop_cut_edges", "k": 4}, 3))
    assert cut.reference(query("Q5", Q5))[1].shape[0] < 2
