"""Nothing under ``ptmt_bench/`` imports JAX or the JAX package, compared
by whole top-level names (the port's name, ``repro_torch``, begins with
the JAX package's); the reference imports nothing of the program; the
run refuses to report from a process that loaded them."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from ptmt_bench.registry import CHECKOUT, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in ROOT.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "numpy", "torch"}


def test_whole_names_are_compared():
    from ptmt_bench import run

    assert "repro_torch" not in run.FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN


def test_run_refuses_a_process_with_jax_loaded():
    code = (f"import sys; sys.path[:0] = [{str(CHECKOUT)!r}]\n"
            "import types; sys.modules['repro'] = types.ModuleType('repro')\n"
            "from ptmt_bench import run\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(CHECKOUT))
    assert out.stdout.strip() == "['repro']"


def test_run_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and ptmt_bench: no result."""
    import shutil

    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT, tmp_path / "ptmt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "ptmt_bench/run.py", "--workload",
         "ptmt-mining.mine_1m", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_bytecode_is_cached_inside_the_checkout(tmp_path):
    """With bytecode writing turned off by the environment, a run still
    keeps the bytecode of what it imports under the checkout's build
    directory, so that a second run does not compile it again."""
    import os

    (tmp_path / "probe_module.py").write_text("X = 1\n")
    code = (f"import sys; sys.path[:0] = [{str(CHECKOUT)!r}, "
            f"{str(tmp_path)!r}]\n"
            "from ptmt_bench import run\n"
            "run.cache_bytecode()\n"
            "import probe_module, importlib.util\n"
            "print(importlib.util.cache_from_source(probe_module.__file__))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(CHECKOUT),
                         env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
    assert out.returncode == 0, out.stderr
    pyc = out.stdout.strip()
    assert pyc.startswith(str(CHECKOUT / "build" / "ptmt_bench_cache"))
    assert os.path.isfile(pyc)
    os.remove(pyc)
