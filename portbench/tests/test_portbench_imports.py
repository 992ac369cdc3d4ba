"""The benchmark's import rules, and what a run does without a card or
without the program.

The run loads nothing of the JAX package or JAX; the plain references
nothing of the program either; an architecture's file imports the program
only inside `build_engine` and its faults, so the reference side of a run
and the yardstick load without it.

Names are compared whole at the top level (the part before the first dot):
the program's package, s2m2_torch, begins with the letters of s2m2_tpu."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


def _run_py(code, cwd=ROOT, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(["s2m2_torch.ops", "jaxtyping", "flaxen.x", "numpy"]) == []
    assert harness.forbidden_modules(["s2m2_tpu.models.s2m2", "jax", "jaxlib.xla", "flax"]) == \
        ["flax", "jax", "jaxlib", "s2m2_tpu"]


def test_what_a_run_loads_holds_no_forbidden_module(tmp_path):
    """The harness, the cell's architecture and the program's engine on the
    CPU, the reference, every metric reader and the readings tool, loaded
    in a fresh process."""
    from portbench.tests.conftest import write_root
    root = write_root(tmp_path, {"conf_median": 1.0})
    code = f"""
import json, sys
from pathlib import Path
from portbench import faults, harness, readings
from portbench.reference import model
cell = harness.load_cell("tiny.stream", True, Path({str(root)!r}))
harness.build_engine(cell, "cpu")
harness.reference_model(cell, 1, "cpu")
for m in {sorted(p.stem for p in (PORTBENCH / "metrics").glob("*.py"))!r}:
    harness.reader(Path({str(ROOT)!r}), m)
print(json.dumps(sorted(sys.modules)))
"""
    res = _run_py(code)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert "s2m2_torch.runtime.engine" in loaded
    assert harness.forbidden_modules(loaded) == []


def _imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imported_top_names(path) & {"s2m2_torch", "s2m2_tpu", "jax", "jaxlib", "flax"}


def _program_imports(path):
    """(the names of the top-level functions and classes holding an import
    of the program, their FAULTS' function names); None stands for the
    module's own top level."""
    tree = ast.parse(path.read_text())
    owners, faults = set(), set()
    for top in tree.body:
        owner = getattr(top, "name", None)
        for node in ast.walk(top):
            if isinstance(node, (ast.Import, ast.ImportFrom)) and \
                    _imported_top_names_of(node) & {"s2m2_torch"}:
                owners.add(owner)
        if isinstance(top, ast.Assign) and any(getattr(t, "id", None) == "FAULTS"
                                               for t in top.targets):
            faults = {v.id for v in top.value.values}
    return owners, faults


def _imported_top_names_of(node):
    if isinstance(node, ast.Import):
        return {a.name.split(".")[0] for a in node.names}
    return {node.module.split(".")[0]} if node.level == 0 else set()


@pytest.mark.parametrize("path", sorted((PORTBENCH / "archs").glob("*.py")),
                         ids=lambda p: p.name)
def test_an_architecture_imports_the_program_only_to_run_or_break_it(path):
    assert not _imported_top_names(path) & {"s2m2_tpu", "jax", "jaxlib", "flax"}
    owners, faults = _program_imports(path)
    assert owners <= {"build_engine", *faults}, owners


def test_reference_loads_without_the_program():
    """The references, and every architecture's file, with the yardstick."""
    code = ("import sys; from pathlib import Path; import portbench.reference.model; "
            "from portbench import harness, yardstick; "
            f"[harness.architecture(Path({str(ROOT)!r}), p.stem) "
            f"for p in Path({str(PORTBENCH / 'archs')!r}).glob('*.py')]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = _run_py(code)
    assert res.returncode == 0, res.stderr
    assert "s2m2_torch" not in res.stdout and "s2m2_tpu" not in res.stdout


def _run_cli(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "S_fp32.stream_1216",
                           "--seed", "2147483711", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_fails_and_prints_no_result():
    res = _run_cli(ROOT)
    assert res.returncode == 3, res.stderr
    assert "CUDA card" in res.stderr
    assert res.stdout.strip() == ""


def test_run_without_the_program_fails_and_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's paths."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run_cli(tmp_path)
    assert res.returncode != 0
    assert "s2m2_torch" in res.stderr
    assert res.stdout.strip() == ""
