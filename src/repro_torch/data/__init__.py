from .generators import (imdb_like_graph, imdb_queries, subgen_like_graph,
                         subgen_queries)
from .tokens import TokenPipeline, frontend_batch

__all__ = ["imdb_like_graph", "imdb_queries", "subgen_like_graph",
           "subgen_queries", "TokenPipeline", "frontend_batch"]
