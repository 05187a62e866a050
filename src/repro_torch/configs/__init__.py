from .registry import (ARCHS, SHAPES, ShapeSpec, get_config, reduced,
                        input_specs, shape_applicable, applicable_cells)

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config", "reduced",
           "input_specs", "shape_applicable", "applicable_cells"]
