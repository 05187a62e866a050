"""Serving: the language models' prefill and single-token decode against
caches (decode.py), and the SLO serving front end over one
``GraphSession``: cost-predicted admission (cost.py) and deadline-aware
serving with degrade / defer / shed (frontend.py).  cost.py and
frontend.py are copies of the JAX package's modules, logic unchanged."""
from .cost import CostEstimate, CostModel, required_partition_mask, \
    work_units
from .decode import (init_caches, abstract_caches, prefill, decode_step)
from .frontend import (FrontendReport, Request, RequestOutcome, SLOClass,
                       ServingFrontend, default_slo_classes, parse_slo_spec,
                       requests_from_workload)

__all__ = [
    "init_caches", "abstract_caches", "prefill", "decode_step",
    "CostEstimate", "CostModel", "required_partition_mask", "work_units",
    "FrontendReport", "Request", "RequestOutcome", "SLOClass",
    "ServingFrontend", "default_slo_classes", "parse_slo_spec",
    "requests_from_workload",
]
