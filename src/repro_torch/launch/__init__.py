"""Entry points: ``python -m repro_torch.launch.serve`` (serve.py), the
in-RAM query-serving CLI; ``python -m repro_torch.launch.train``
(train.py), LM training over the ranks of a mesh; the dry run
(dryrun.py).  ``mesh`` and ``sharding`` are the language models' device
mesh and the sharding rule resolver (not ``core/mesh.py``, the graph
engines' part mesh)."""
from .mesh import make_production_mesh, make_test_mesh, dp_axes, init_world
from .sharding import (ShardingRules, param_shardings, opt_shardings,
                       batch_shardings, cache_shardings, act_constraint,
                       logit_constraint)

__all__ = ["make_production_mesh", "make_test_mesh", "dp_axes", "init_world",
           "ShardingRules", "param_shardings", "opt_shardings",
           "batch_shardings", "cache_shardings", "act_constraint",
           "logit_constraint"]
