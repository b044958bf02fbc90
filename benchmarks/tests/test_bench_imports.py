"""The import guard: nothing the harness or the reference loads is JAX or
the JAX package (top-level names compared whole, since the program's name
begins with the JAX package's), and the reference loads nothing of the
program."""

import ast
import json
import subprocess
import sys

from conftest import BENCH
from harness.runner import FORBIDDEN, forbidden_modules

PROGRAM = "hsip_tpu_torch"


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_names_compare_whole():
    assert forbidden_modules(["hsip_tpu_torch", "hsip_tpu_torch.track",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["hsip_tpu.io", "jax.numpy", "flax"]) == \
        ["flax", "hsip_tpu", "jax"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not (_top_level_imports(path) & set(FORBIDDEN)), path


def test_reference_and_generator_sources_import_nothing_of_the_program():
    for sub in ("reference", "gen"):
        for path in (BENCH / sub).rglob("*.py"):
            assert PROGRAM not in _top_level_imports(path), path


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, timeout=600, cwd=BENCH.parent,
    ).stdout.strip().splitlines()[-1]
    return set(json.loads(out))


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(
        "import sys, json; sys.path[:0] = ['benchmarks']\n"
        "import reference, gen, harness.check\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert PROGRAM not in loaded
    assert not loaded & set(FORBIDDEN)


def test_a_whole_rehearsal_loads_neither_jax_nor_the_jax_package(tmp_path):
    loaded = _loaded_after(
        "import sys, json; sys.path[:0] = ['benchmarks']\n"
        "import run\n"
        f"rc = run.main(['--workload', 'nova.library', '--seed', '17',"
        f" '--seconds', '0.2', '--trace', '1', '--rehearse'])\n"
        "assert rc == 0, rc\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert PROGRAM in loaded
    assert not loaded & set(FORBIDDEN)
