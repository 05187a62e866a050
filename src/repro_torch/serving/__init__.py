"""The SLO serving front end over one ``GraphSession``: cost-predicted
admission (cost.py) and deadline-aware serving with degrade / defer /
shed (frontend.py).  Copies of the JAX package's modules, logic
unchanged."""
from .cost import CostEstimate, CostModel, required_partition_mask, \
    work_units
from .frontend import (FrontendReport, Request, RequestOutcome, SLOClass,
                       ServingFrontend, default_slo_classes, parse_slo_spec,
                       requests_from_workload)

__all__ = [
    "CostEstimate", "CostModel", "required_partition_mask", "work_units",
    "FrontendReport", "Request", "RequestOutcome", "SLOClass",
    "ServingFrontend", "default_slo_classes", "parse_slo_spec",
    "requests_from_workload",
]
