"""Nothing the benchmark runs loads JAX, Flax or the JAX package
``repro`` (by whole top-level name: ``repro_torch`` is another), or
reads ``benchmarks/``; the reference loads nothing of the program."""

import ast
import re

from bench_dcnn.tests.tiny import BENCH, result, run_cli, tiny_checkout

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    files = _sources()
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN, (f, mod)


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root == "bench_dcnn" and ".models" not in mod \
                or root in ("torch", "math", "contextlib", "itertools",
                            "__future__"), (f, mod)


def test_no_source_reads_the_jax_benchmarks():
    for f in _sources():
        assert not re.search(r"[\"'/]benchmarks[/\"']", f.read_text()), f


def test_a_run_leaves_no_jax_module_loaded(tmp_path):
    root = tiny_checkout(tmp_path / "co")
    probe = ("import atexit, sys\n"
             "atexit.register(lambda: print('LOADED', sorted(k for k in "
             "sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', "
             "'repro')), file=sys.stderr))")
    proc = run_cli(root, "dcgan.gen-b1024", patch=probe)
    result(proc)
    assert "LOADED []" in proc.stderr
