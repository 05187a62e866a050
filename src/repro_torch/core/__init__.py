"""Partitioned graph query processing on PyTorch (Das et al., 2019).

Public API of this slice:

  Graph / GraphBuilder / PartitionedGraph / build_partitions
  partition_graph / SCHEMES            — multilevel partitioner
  build_catalog / generate_plan        — cost-based planning
  Query / DisjunctiveQuery / make_*    — query construction
  EngineConfig / make_partition_evaluator — the evaluator (core/engine.py)
  OPATEngine                           — One Partition At a Time serving
  TraditionalMPEngine                  — p partitions per iteration (Sec. 8)
  MapReduceMPEngine                    — map/shuffle/reduce (Sec. 9) on a
                                         part mesh
  PartMesh / make_part_mesh            — the mesh's shards: devices and
                                         the mapper ids each holds
  QueryScheduler / ScheduleReport      — shared-load multi-query serving
  PartitionStore / LoadStats           — device residency: LRU cache,
                                         pins, side-stream prefetch; with
                                         a DiskCatalog backing a three-tier
                                         disk->host->device cache
                                         (storage/, GraphSession.save/.open)
  GraphSession / QueryResult           — serving session (OPAT,
                                         TraditionalMP, MapReduceMP;
                                         submit_many, workload profile,
                                         out of core, repartition)
  repartition / RepartitionConfig      — workload-aware repartitioning: a
                                         saved profile reweights the graph
                                         and the partitioner re-runs as
                                         scheme "waw" (core/repartition.py)
  oracle.match_query                   — whole-graph ground truth
"""
from .catalog import Catalog, build_catalog
from .engine import (EngineConfig, EvalResult, make_batched_evaluator,
                     make_partition_evaluator, resolve_device)
from .graph import (Graph, GraphBuilder, LabelVocab, PartitionArrays,
                    PartitionedGraph, WILDCARD, build_partitions)
from .heuristics import (ALL_HEURISTICS, MAX_SN, MAX_YIELD, MAX_YIELD_SHARED,
                         MIN_SN, RANDOM_SN, SHARED_HEURISTICS, rank_partitions,
                         rank_partitions_shared)
from .mapreduce_mp import MapReduceMPEngine, MapReduceMPResult
from .mesh import PartMesh, PartShard, default_part_mesh, make_part_mesh
from .metrics import RunStats, l_ideal_for_plan, validate_run_residency
from .opat import OPATEngine, OPATResult, absorb_eval_outputs
from .oracle import match_disjunctive, match_query
from .partition import SCHEMES, PartitionScheme, partition_graph, partition_quality
from .plan import Plan, PlanArrays, PlanStep, generate_plan
from .query import (DisjunctiveQuery, Query, QueryEdge, QueryNode,
                    make_path_query, make_star_query)
from .repartition import (WAW_SCHEME, RepartitionConfig, answer_span_matrix,
                          load_profile, repartition, repartition_assignment,
                          reweight_edges)
from .runner import QueryRunner, RunReport, RunRequest, truncate_answers
from .scheduler import QueryScheduler, ScheduleReport, batch_bucket
from .session import GraphSession, QueryResult
from .state import BindingBatch, QueryState
from .store import LoadStats, PartitionStore, StoreEntry
from .traditional_mp import TraditionalMPEngine, TraditionalMPResult

__all__ = [
    "Catalog", "build_catalog", "EngineConfig", "EvalResult",
    "make_batched_evaluator", "make_partition_evaluator", "resolve_device",
    "Graph", "GraphBuilder", "LabelVocab", "PartitionArrays",
    "PartitionedGraph", "WILDCARD", "build_partitions",
    "ALL_HEURISTICS", "MAX_SN", "MAX_YIELD", "MAX_YIELD_SHARED", "MIN_SN",
    "RANDOM_SN", "SHARED_HEURISTICS", "rank_partitions",
    "rank_partitions_shared", "RunStats", "l_ideal_for_plan",
    "validate_run_residency",
    "OPATEngine", "OPATResult", "absorb_eval_outputs",
    "match_disjunctive", "match_query",
    "SCHEMES", "PartitionScheme", "partition_graph", "partition_quality",
    "Plan", "PlanArrays", "PlanStep", "generate_plan",
    "DisjunctiveQuery", "Query", "QueryEdge", "QueryNode",
    "make_path_query", "make_star_query",
    "WAW_SCHEME", "RepartitionConfig", "answer_span_matrix", "load_profile",
    "repartition", "repartition_assignment", "reweight_edges",
    "QueryRunner", "RunReport", "RunRequest", "truncate_answers",
    "QueryScheduler", "ScheduleReport", "batch_bucket",
    "TraditionalMPEngine", "TraditionalMPResult",
    "MapReduceMPEngine", "MapReduceMPResult",
    "PartMesh", "PartShard", "default_part_mesh", "make_part_mesh",
    "GraphSession", "QueryResult", "BindingBatch", "QueryState",
    "LoadStats", "PartitionStore", "StoreEntry",
]
