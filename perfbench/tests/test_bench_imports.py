"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``strutopy_tpu_torch`` begins with
``strutopy_tpu``), and the reference imports nothing of the program."""

import ast

from perfbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "strutopy_tpu", "bench", "bench_torch", "benchmarks"}


def _top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in spec.HERE.rglob("*.py"):
        if "tests" in path.relative_to(spec.HERE).parts:
            continue
        assert not (_top_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert "strutopy_tpu_torch" not in _top_imports(path), path
        assert not (_top_imports(path) & FORBIDDEN), path


def test_run_refuses_a_result_after_loading_jax(monkeypatch):
    import sys
    import types

    from perfbench import run

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.loaded_forbidden() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "strutopy_tpu_torch_x", types.ModuleType("x"))
    assert "strutopy_tpu" not in run.loaded_forbidden()
