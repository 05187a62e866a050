from .generators import (imdb_like_graph, imdb_queries, subgen_like_graph,
                         subgen_queries)

__all__ = ["imdb_like_graph", "imdb_queries", "subgen_like_graph",
           "subgen_queries"]
