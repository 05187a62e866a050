"""The vectorised generators against the port's own generators'
statistics, at sizes a CPU test holds, and the traffic's fixed work."""
import numpy as np
import pytest

from graphbench import datasets, traffic
from graphbench.reference.matcher import Matcher, union


def label_counts(names, ids):
    return {n: int(c) for n, c in zip(names, np.bincount(ids, minlength=len(names)))}


def port_counts(vocab, ids):
    return {vocab.str_of(i): int(c) for i, c in enumerate(np.bincount(ids, minlength=len(vocab)))}


def test_subgen_statistics(small_config):
    from repro_torch.data.generators import subgen_like_graph
    cfg = small_config("subgen-400k-k4")
    g = datasets.generator("subgen").make(cfg, 7)
    port = subgen_like_graph(cfg["n_nodes"], cfg["n_edges"], cfg["n_vlabels"],
                             cfg["n_elabels"], cfg["n_embed"], seed=7)
    assert (g.n_nodes, g.n_edges) == (port.n_nodes, port.n_edges)
    mine = label_counts(g.node_labels, g.node_label)
    theirs = port_counts(port.node_vocab, port.node_label)
    for lab in ("tmpl_A", "tmpl_B", "tmpl_C", "tmpl_D"):
        assert mine[lab] == theirs[lab] == cfg["n_embed"]
    bg = [mine.get(f"v{i}", 0) for i in range(cfg["n_vlabels"])]
    mean = cfg["n_nodes"] / cfg["n_vlabels"]
    assert min(bg) > 0.5 * mean and max(bg) < 1.5 * mean
    for lab in ("e_ab", "e_bc", "e_bd"):
        assert label_counts(g.edge_labels, g.edge_label)[lab] == cfg["n_embed"]
    assert not (g.edge_src == g.edge_dst).any()
    # mean and spread of degree as the port's (uniform ends)
    d, pd = g.degree(), port.degree_view()
    assert abs(d.mean() - pd.mean()) < 1e-9
    assert abs(d.std() - pd.std()) < 0.15 * pd.std()
    # every planted instance is an answer to Q5 and Q4, nothing else
    m = Matcher(g)
    rng = np.random.default_rng(0)
    gen = datasets.generator("subgen")
    for t, want in (("Q4", cfg["n_embed"]), ("Q5", cfg["n_embed"]), ("Q6", 0)):
        assert union(m.match(gen.make_query(g, cfg, t, rng))).shape[0] == want


def test_imdb_statistics(small_config):
    from repro_torch.data.generators import imdb_like_graph
    cfg = small_config("imdb-74k-k4")
    scale = 5
    for key in ("n_movies", "n_people", "n_companies"):
        cfg[key] *= scale
    g = datasets.generator("imdb").make(cfg, 11)
    port = imdb_like_graph(cfg["n_movies"], cfg["n_people"], cfg["n_companies"],
                           cfg["n_genres"], cfg["year_lo"], cfg["year_hi"],
                           cfg["n_communities"], cfg["locality"], seed=11)
    assert g.n_nodes == port.n_nodes
    assert abs(g.n_edges - port.n_edges) < 0.05 * port.n_edges
    mine = label_counts(g.edge_labels, g.edge_label)
    theirs = port_counts(port.edge_vocab, port.edge_label)
    for lab in ("in_year", "produced_by"):
        assert mine[lab] == theirs[lab] == cfg["n_movies"]
    for lab in ("genre_is", "acted_in", "wrote"):
        assert abs(mine[lab] - theirs[lab]) < 0.1 * theirs[lab], lab
    # the hub: the ELL width is a genre's degree, about 51 x scale
    w, pw = g.degree().max(), port.degree_view().max()
    assert abs(w - pw) < 0.12 * pw
    assert 40 * scale < w < 65 * scale
    names = g.node_labels
    year = [i for i, s in enumerate(names) if s == "year"][0]
    vals = g.node_value[g.node_label == year]
    assert vals.min() == cfg["year_lo"] and vals.max() == cfg["year_hi"]
    assert np.isnan(g.node_value[g.node_label != year]).all()


@pytest.mark.parametrize("name", ["subgen", "imdb"])
def test_seed_renumbers_the_same_shape(small_config, name):
    cfg = small_config({"subgen": "subgen-400k-k4", "imdb": "imdb-74k-k4"}[name])
    gen = datasets.generator(name)
    a, b = gen.make(cfg, 1), gen.make(cfg, 2**33 + 5)
    # every vertex's degree but a year's (each movie's year is drawn per run)
    deg = [sorted(x.degree()[np.array(x.node_labels)[x.node_label] != "year"].tolist())
           for x in (a, b)]
    assert deg[0] == deg[1] and a.degree().max() == b.degree().max()
    assert not np.array_equal(a.edge_src, b.edge_src)
    c = gen.make(cfg, 1)
    assert np.array_equal(a.edge_src, c.edge_src) and np.array_equal(a.node_label, c.node_label)


def test_poisson_work_is_fixed_by_count(small_config):
    cfg = small_config("imdb-74k-k4")
    mix = {"arrivals": "poisson", "rate_qps": 16.0, "budget_share": 0.25,
           "budget": 5, "replay_speed": 1.0}
    gen = datasets.generator("imdb")
    g = gen.make(cfg, 3)
    runs = [traffic.poisson_requests(mix, cfg, gen, g, s, 10.0) for s in (3, 4)]
    for reqs in runs:
        assert len(reqs) == 160
        arr = [r["arrival_s"] for r in reqs]
        assert arr[0] == 0.0 and arr == sorted(arr) and arr[-1] < 10.0
        assert sum(r["max_answers"] is not None for r in reqs) == round(0.25 * len(reqs))
    names = [sorted(r["query"]["name"] for r in reqs) for reqs in runs]
    assert names[0] == names[1]
    # the same gaps in another order (the last one runs to the window's end)
    gaps = [sorted(np.diff([r["arrival_s"] for r in reqs] + [10.0]).round(9).tolist())
            for reqs in runs]
    assert gaps[0] == gaps[1]
    assert [r["query"] for r in runs[0]] != [r["query"] for r in runs[1]]
