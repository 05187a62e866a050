"""An IMDB-like typed movie graph, the stand-in for the paper's IMDB
graph (Das et al. 2019, Sec. 7): genre, year, company, person and movie
vertices; every movie has a year, one to three distinct genres, a
producing company and one to five cast members (the first a writer one
time in five), and a third as many extra writer edges.  Cast and
companies come from the movie's community with probability
``locality``.  People, movies, companies and genres carry unique labels;
years carry the label ``year`` and their value as float32.

The draws follow ``repro_torch.data.generators.imdb_like_graph``,
vectorised and split into the fixed shape and the run's draws
(``graphbench.datasets``): the run's seed renumbers the vertices and
draws each movie's year (year vertices have far fewer edges than the
genre hubs, so the ELL width does not move).  Queries: ``imdb_queries``
(Q1 a person's movies of one genre with their company, Q2 the same with a
``year != 2000`` predicate, Q3 the OR of a writer's and an actor's
produced movies), with the people and genres drawn per request.
"""
from __future__ import annotations

import numpy as np

from . import GraphArrays, edge_spec, node_spec, pattern, query

EDGE_LABELS = ("in_year", "genre_is", "produced_by", "acted_in", "wrote")
IN_YEAR, GENRE_IS, PRODUCED_BY, ACTED_IN, WROTE = range(5)
TEMPLATES = ("Q1", "Q2", "Q3")


def _pool_pick(rng, c, count, C, n_all, local):
    """The community pick of ``repro_torch``'s generator: ``c + C * j``
    for a uniform j below ``count[c]`` where ``local`` (and the pool is
    not empty), else uniform over all ``n_all``."""
    cnt = count[c]
    local = local & (cnt > 0)
    inpool = c + C * np.floor(rng.random(c.shape[0]) * np.maximum(cnt, 1)).astype(np.int64)
    return np.where(local, inpool, rng.integers(0, n_all, c.shape[0]))


def _pool_sizes(n: int, C: int) -> np.ndarray:
    return np.array([len(range(c, n, C)) for c in range(C)], dtype=np.int64)


def make(cfg: dict, seed: int) -> GraphArrays:
    N = int(cfg["n_movies"])
    NP = int(cfg["n_people"])
    NC = int(cfg["n_companies"])
    G = int(cfg["n_genres"])
    y_lo, y_hi = int(cfg["year_lo"]), int(cfg["year_hi"])
    Y = y_hi - y_lo + 1
    C = max(1, int(cfg["n_communities"]))
    loc = float(cfg["locality"])
    # vertex ids: genres, years, companies, people, movies
    o_year, o_comp = G, G + Y
    o_people = o_comp + NC
    o_movie = o_people + NP
    total = o_movie + N

    shape = np.random.default_rng(int(cfg["structure_seed"]))
    comm = shape.integers(0, C, N)
    n_gen = shape.integers(1, 4, N)
    genre_order = np.argsort(shape.random((N, G)), axis=1)[:, :3]
    g_movie = np.repeat(np.arange(N), n_gen)
    g_genre = genre_order[np.arange(3)[None, :] < n_gen[:, None]]
    comp = _pool_pick(shape, comm, _pool_sizes(NC, C), C, NC,
                      shape.random(N) < loc)
    n_cast = shape.integers(1, 6, N)
    c_movie = np.repeat(np.arange(N), n_cast)
    c_pos = np.arange(c_movie.shape[0]) - np.repeat(np.cumsum(n_cast) - n_cast, n_cast)
    people_pool = _pool_sizes(NP, C)
    c_person = _pool_pick(shape, comm[c_movie], people_pool, C, NP,
                          shape.random(c_movie.shape[0]) < loc)
    c_role = np.where((c_pos > 0) | (shape.random(c_movie.shape[0]) < 0.8),
                      ACTED_IN, WROTE)
    n_w = N // 3
    w_comm = shape.integers(0, C, n_w)
    w_person = _pool_pick(shape, w_comm, people_pool, C, NP, np.ones(n_w, dtype=bool))
    w_movie = shape.integers(0, N, n_w)

    run = np.random.default_rng(seed)
    year = run.integers(y_lo, y_hi + 1, N)
    src = np.concatenate([np.arange(N) + o_movie, g_movie + o_movie,
                          np.arange(N) + o_movie, c_person + o_people,
                          w_person + o_people])
    dst = np.concatenate([year - y_lo + o_year, g_genre, comp + o_comp,
                          c_movie + o_movie, w_movie + o_movie])
    lab = np.concatenate([np.full(N, IN_YEAR), np.full(g_movie.shape[0], GENRE_IS),
                          np.full(N, PRODUCED_BY), c_role, np.full(n_w, WROTE)])
    # labels: genre_i, year, company_i, person_i, movie_i (ids in that order)
    node_label = np.concatenate([np.arange(G), np.full(Y, G),
                                 G + 1 + np.arange(NC + NP + N)])
    value = np.full(total, np.nan, dtype=np.float32)
    value[o_year:o_year + Y] = np.arange(y_lo, y_hi + 1, dtype=np.float32)
    g = GraphArrays(
        node_label=node_label.astype(np.int32), node_value=value,
        edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        edge_label=lab.astype(np.int32),
        edge_directed=np.zeros(src.shape[0], dtype=bool),
        node_labels=([f"genre_{i}" for i in range(G)] + ["year"]
                     + [f"company_{i}" for i in range(NC)]
                     + [f"person_{i}" for i in range(NP)]
                     + [f"movie_{i}" for i in range(N)]),
        edge_labels=list(EDGE_LABELS))
    return g.renumbered(run.permutation(total))


def make_query(g: GraphArrays, cfg: dict, template: str,
               rng: np.random.Generator) -> dict:
    """Q1, Q2 or Q3 about people and genres drawn from ``rng``."""
    NP, G = int(cfg["n_people"]), int(cfg["n_genres"])
    person = f"person_{int(rng.integers(0, NP))}"
    genre = f"genre_{int(rng.integers(0, G))}"
    any_ = node_spec()
    if template == "Q1":
        return query("Q1", pattern("Q1", [node_spec(person), any_, node_spec(genre), any_], [
            edge_spec(0, 1, "acted_in"), edge_spec(1, 2, "genre_is"),
            edge_spec(1, 3, "produced_by")]))
    if template == "Q2":
        year = node_spec("year", "!=", 2000.0)
        return query("Q2", pattern("Q2", [node_spec(person), any_, node_spec(genre), year], [
            edge_spec(0, 1, "acted_in"), edge_spec(1, 2, "genre_is"),
            edge_spec(1, 3, "in_year")]))
    if template == "Q3":
        person2 = f"person_{int(rng.integers(0, NP))}"
        return query("Q3", pattern("Q3a", [node_spec(person), any_, any_], [
            edge_spec(0, 1, "wrote"), edge_spec(1, 2, "produced_by")]),
            pattern("Q3b", [node_spec(person2), any_, any_], [
                edge_spec(0, 1, "acted_in"), edge_spec(1, 2, "produced_by")]))
    raise ValueError(f"imdb has no template {template!r}")
