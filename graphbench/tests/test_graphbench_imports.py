"""No file of the benchmark imports JAX, the JAX package, its CPU
benchmark or the card smoke script; the reference imports nothing of
the program.  Names are compared whole, up to the first dot, because
the port's name ``repro_torch`` begins with the JAX package's."""
import ast

from graphbench import bench


def imports_of(path):
    """The top-level names a Python file imports (absolute imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.update(bench.top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(bench.top_level(node.module))
    return out


def test_top_level_names():
    assert bench.loaded_forbidden(["repro_torch", "repro_torch.core.graph", "numpy"]) == []
    assert bench.loaded_forbidden(["repro.core", "jaxlib.xla", "flax"]) == ["flax", "jaxlib", "repro"]
    assert bench.loaded_forbidden(["benchmarks.common", "chip_smoke", "reproduce"]) == \
        ["benchmarks", "chip_smoke"]


def test_sources_import_nothing_forbidden():
    files = sorted(bench.HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not (imports_of(f) & bench.FORBIDDEN), f


def test_reference_reads_nothing_of_the_program():
    for f in sorted((bench.HERE / "reference").rglob("*.py")):
        assert "repro_torch" not in imports_of(f), f
        assert "repro_torch" not in f.read_text().replace("``repro_torch.core.oracle``", ""), f
